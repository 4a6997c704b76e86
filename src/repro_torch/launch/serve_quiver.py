"""End-to-end serving script (the paper's deployment scenario) — the port
of ``examples/serve_quiver.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve_quiver \\
        [--requests 150] [--nodes 8000] [--batch-seeds 8] [--adaptive] \\
        [--multi-model] [--device cuda|cpu]

Serves a GraphSAGE model over a skewed synthetic graph through the whole
pipeline: per-executor PSGS calibration, two operating points as
cost-model routing policies (``latency_preferred`` and
``throughput_preferred``), dynamic PSGS-budget batching, per-batch
futures with admission control; prints a report a policy. ``--adaptive``
hooks the online adaptation loop into the engine (a fresh stack a
policy, so one policy's migrations cannot reach the next).
``--multi-model`` co-serves a second, wider GraphSAGE through a
``ModelRegistry`` over the same store: the report gives both models'
PSGS cut-points and routing on one interleaved stream. Runs on the card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import DynamicBatcher
from repro_torch.launch.serve import (build_executors, build_stack,
                                      make_model_infer_fn)
from repro_torch.serving import (AdaptiveConfig, AdaptiveController,
                                 CalibrationResult, CostModelRouter,
                                 ModelRegistry, ServingEngine,
                                 build_model_entry, calibrate_executors)

FANOUTS = (6, 4)


def _stack(args):
    return build_stack(nodes=args.nodes, avg_degree=10.0, d_feat=64,
                       fanouts=FANOUTS, hot_frac=0.3, device=args.device)


def run_multi_model(args) -> dict:
    """Two GraphSAGE variants (base and wide) co-served by one engine over
    one shared store; requests interleave round-robin and each model
    routes by its own calibrated curves."""
    graph, feats, psgs, fap, store, gen, infer_fn = _stack(args)
    registry = ModelRegistry()
    widths = {"base": (64, 64), "wide": (256, 256)}
    for i, (name, hidden) in enumerate(widths.items()):
        entry = build_model_entry(
            name, graph=graph, store=store, fanouts=FANOUTS,
            infer_fn=make_model_infer_fn(64, hidden, FANOUTS, seed=i,
                                         device=store.device),
            psgs_table=psgs, capacity=2, max_batch=32, rng_seed=i)
        registry.add(entry)
    engine = ServingEngine(registry, max_inflight=64)
    gen.rng = np.random.default_rng(5)
    reqs = list(gen.stream(args.requests, seeds_per_request=args.batch_seeds,
                           models=list(widths)))
    engine.warmup([reqs[0]])
    batcher = DynamicBatcher(deadline_s=0.02, psgs_table=psgs, max_batch=16)
    m = engine.serve_stream(reqs, batcher, gap_s=0.002)
    # crossover() is inf when one executor wins everywhere; JSON has no inf
    cuts = {name: registry.get(name).router.crossover("host", "device")
            for name in registry}
    report = {"cutpoints": {n: c if np.isfinite(c) else None
                            for n, c in cuts.items()},
              **m.summary()}
    engine.close()
    return report


def run_policies(args) -> dict:
    """Each routing policy over calibrated host and device executors."""
    def fresh_stack():
        graph, feats, psgs, fap, store, gen, infer_fn = _stack(args)
        executors = build_executors(graph, store, FANOUTS, infer_fn, psgs,
                                    num_workers=2, max_batch=32)
        # calibrate every executor (paper Fig. 6)
        order = np.argsort(psgs)
        batches = [order[int(q * len(order)):][:args.batch_seeds]
                   .astype(np.int64) for q in np.linspace(0.05, 0.95, 6)]
        curves = calibrate_executors(executors, batches, psgs, repeats=2)
        return graph, psgs, store, gen, executors, curves

    graph, psgs, store, gen, executors, curves = fresh_stack()
    print(f"[stack] {graph.num_nodes} nodes, tiers "
          f"{store.plan.tier_counts()}", flush=True)

    report = {}
    for policy in ("latency_preferred", "throughput_preferred"):
        if args.adaptive and report:
            # live migration mutates the store: rebuild a policy so one
            # policy's adaptation cannot reach the next one's run
            for ex in executors.values():
                ex.close()
            graph, psgs, store, gen, executors, curves = fresh_stack()
        calib = CalibrationResult(host=curves["host"],
                                  device=curves["device"])
        thr = calib.threshold(policy)  # PSGS budget for the batcher
        router = CostModelRouter.from_curves(psgs, curves, policy,
                                             executors=executors)
        controller = None
        if args.adaptive:
            controller = AdaptiveController(
                graph, FANOUTS, store, router, psgs_table=psgs,
                config=AdaptiveConfig(interval_batches=16))
        engine = ServingEngine(executors, router, max_inflight=64,
                               hooks=[controller] if controller else [])
        gen.rng = np.random.default_rng(5)
        reqs = list(gen.stream(args.requests,
                               seeds_per_request=args.batch_seeds))
        engine.warmup([reqs[0]])
        batcher = DynamicBatcher(deadline_s=0.02,
                                 psgs_budget=thr if np.isfinite(thr)
                                 else None,
                                 psgs_table=psgs, max_batch=16)
        m = engine.serve_stream(reqs, batcher, gap_s=0.002)
        report[policy] = {"threshold": thr if np.isfinite(thr) else None,
                          **m.summary()}
        if controller is not None:
            report[policy]["adaptation"] = controller.report()
    for ex in executors.values():
        ex.close()
    return report


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="repro_torch.launch.serve_quiver")
    p.add_argument("--requests", type=int, default=150)
    p.add_argument("--nodes", type=int, default=8000)
    p.add_argument("--batch-seeds", type=int, default=8)
    p.add_argument("--adaptive", action="store_true",
                   help="hook the online workload-adaptation loop into the "
                        "engine (live FAP re-placement + drift refit)")
    p.add_argument("--multi-model", action="store_true",
                   help="co-serve a second (wider) GraphSAGE through a "
                        "ModelRegistry over the same shared feature store")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    report = run_multi_model(args) if args.multi_model else run_policies(args)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
