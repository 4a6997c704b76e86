"""Quiver serving launcher on PyTorch: the single-model, single-host path.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 200

Builds the stack — synthetic skewed graph → PSGS/FAP → placement → tiered
store → GraphSAGE ``sage-base`` (hidden 128-128) → host and device
executors → per-executor latency calibration → cost-model router →
serving engine — then serves ``--requests`` requests of ``--batch`` seeds
each and prints a JSON report. Runs on ``--device cuda`` (default; raises
without a card) or ``--device cpu``.

Flags of the reference launcher whose parts are not ported yet
(``--sharded``, ``--models``, ``--adaptive``, ``--prefetch``,
``--gpu-cache``, ``--gateway`` and their companions) are rejected like
any unknown flag.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (DynamicBatcher, TieredFeatureStore,
                              TopologySpec, WorkloadGenerator, compute_fap,
                              compute_psgs, quiver_placement)
from repro_torch.graph import power_law_graph
from repro_torch.models.gnn_basic import SAGE, sage_init
from repro_torch.serving import (CostModelRouter, DeviceExecutor,
                                 HostExecutor, MicroBatcher, ServingEngine,
                                 StaticScheduler, calibrate_executors)

# hidden widths of the served GraphSAGE (the reference launcher's
# sage-base preset)
HIDDEN = (128, 128)


def make_infer_fn(model: SAGE, fanouts: Sequence[int]):
    """``infer_fn(hop_feats, hop_ids[, deep_agg])`` over ``model``: masks
    come from the hop ids (``-1`` = absent), ``deep_agg`` is the innermost
    hop pre-reduced by ``TieredFeatureStore.lookup_aggregate``."""
    fanouts = tuple(fanouts)

    @torch.inference_mode()
    def infer_fn(hop_feats, hop_ids, deep_agg=None):
        masks = [(h >= 0).float()[:, None] for h in hop_ids]
        return model(hop_feats, fanouts, hop_masks=masks, deep_agg=deep_agg)

    return infer_fn


def build_stack(*, nodes: int, avg_degree: float, d_feat: int,
                fanouts: tuple[int, ...], hot_frac: float, seed: int = 0,
                spill_path: Optional[str] = None,
                device: str | torch.device = "cuda"):
    """Graph, features, PSGS, FAP, store, workload generator and
    ``infer_fn`` — drawn from ``seed`` exactly as the reference launcher
    draws them (the model weights come from a ``torch.Generator`` seeded
    with ``seed``)."""
    dev = resolve_device(device)
    graph = power_law_graph(nodes, avg_degree, seed=seed)
    rng = np.random.default_rng(seed + 1)
    feats = rng.normal(size=(nodes, d_feat)).astype(np.float32)

    psgs = compute_psgs(graph, fanouts, device=dev)
    gen = WorkloadGenerator(nodes, graph.out_degree, seed=seed + 2)
    fap = compute_fap(graph, fanouts, seed_prob=gen.p, device=dev)
    topo = TopologySpec(num_pods=1, devices_per_pod=1,
                        rows_per_device=max(nodes // 4, 64),
                        rows_host=max(nodes // 2, 64),
                        hot_replicate_fraction=hot_frac)
    plan = quiver_placement(fap, topo)
    store = TieredFeatureStore.build(feats, plan, spill_path=spill_path,
                                     device=dev)
    model = sage_init(torch.Generator().manual_seed(seed),
                      [d_feat, *HIDDEN], device=dev)
    infer_fn = make_infer_fn(model, fanouts)
    return graph, feats, psgs, fap, store, gen, infer_fn


def build_executors(graph, store, fanouts, infer_fn, psgs, *,
                    num_workers: int, max_batch: int, fused: bool = True,
                    fuse_aggregate: bool = False) -> dict:
    """Host + device executors over the shared store."""
    return {
        "host": HostExecutor(graph, store, fanouts, infer_fn,
                             capacity=num_workers, psgs_table=psgs,
                             fused=fused, fuse_aggregate=fuse_aggregate),
        "device": DeviceExecutor(graph.device_arrays(store.device), store,
                                 fanouts, infer_fn, max_batch=max_batch,
                                 capacity=num_workers, psgs_table=psgs,
                                 fused=fused, fuse_aggregate=fuse_aggregate),
    }


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The launcher's flags; an unknown flag exits with an error."""
    p = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--nodes", type=int, default=20000)
    p.add_argument("--avg-degree", type=float, default=12.0)
    p.add_argument("--d-feat", type=int, default=128)
    p.add_argument("--fanouts", default="10,5")
    p.add_argument("--requests", type=int, default=300)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--policy", default="latency_preferred",
                   choices=["cpu_preferred", "gpu_preferred",
                            "latency_preferred", "throughput_preferred",
                            "host_only", "device_only"])
    p.add_argument("--hot-frac", type=float, default=0.25)
    p.add_argument("--max-inflight", type=int, default=64,
                   help="admission window: outstanding batches")
    p.add_argument("--admission", default="wait", choices=["wait", "shed"],
                   help="behavior when the admission window is full")
    p.add_argument("--fused", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="fused feature collection (cross-hop dedup + one "
                        "tiered_gather launch); --no-fused keeps per-hop "
                        "store lookups")
    p.add_argument("--fuse-aggregate", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="fold the innermost-hop aggregation into the "
                        "gather (gather_aggregate kernel)")
    p.add_argument("--micro-batch", type=int, default=0,
                   help="coalesce requests into super-batches of up to this "
                        "many seeds before admission (0 = off)")
    p.add_argument("--micro-deadline-ms", type=float, default=4.0,
                   help="max milliseconds a request may wait in the "
                        "micro-batching stage")
    p.add_argument("--spill-path", default=None,
                   help="write DISK-tier rows to an np.memmap spill file at "
                        "this path; omit to keep them in host memory")
    return p.parse_args(argv)


def serve(args: argparse.Namespace) -> dict:
    """Build, calibrate and serve per ``args``; returns the metrics
    summary (``ServeMetrics.summary()``)."""
    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    graph, feats, psgs, fap, store, gen, infer_fn = build_stack(
        nodes=args.nodes, avg_degree=args.avg_degree, d_feat=args.d_feat,
        fanouts=fanouts, hot_frac=args.hot_frac, spill_path=args.spill_path,
        device=args.device)
    print(f"[serve] graph: {graph.num_nodes} nodes / {graph.num_edges} edges;"
          f" tiers: {store.plan.tier_counts()}; device: {store.device}")
    executors = build_executors(graph, store, fanouts, infer_fn, psgs,
                                num_workers=args.workers,
                                max_batch=args.batch, fused=args.fused,
                                fuse_aggregate=args.fuse_aggregate)
    if args.policy in ("host_only", "device_only"):
        router = StaticScheduler("host" if args.policy == "host_only"
                                 else "device")
    else:
        # calibration (paper Fig. 6): measure every executor across the
        # PSGS range, fit avg+tail curves
        order = np.argsort(psgs)
        batches = [order[int(q * graph.num_nodes):][:args.batch]
                   .astype(np.int64) for q in np.linspace(0.05, 0.95, 8)]
        curves = calibrate_executors(executors, batches, psgs, repeats=2)
        router = CostModelRouter.from_curves(psgs, curves, args.policy,
                                             executors=executors)
        mid = float(np.median(psgs)) * args.batch
        ests = {n: round(router.estimate(n, mid) * 1e3, 2)
                for n in router.names}
        print(f"[serve] calibrated est @median-batch (ms): {ests}")
    engine = ServingEngine(executors, router, max_inflight=args.max_inflight,
                           admission=args.admission)
    try:
        reqs = list(gen.stream(args.requests, seeds_per_request=args.batch))
        engine.warmup([reqs[0]])
        if args.micro_batch > 0:
            micro = MicroBatcher(deadline_s=args.micro_deadline_ms * 1e-3,
                                 max_seeds=args.micro_batch, psgs_table=psgs)
            metrics = engine.serve_stream(
                reqs, DynamicBatcher(deadline_s=0.0, max_batch=1),
                micro=micro)
            print(f"[serve] micro-batching: {micro.emitted} super-batches, "
                  f"{micro.coalesced} coalesced")
        else:
            metrics = engine.run([[r] for r in reqs])
    finally:
        engine.close()
    return metrics.summary()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    summary = serve(parse_args(argv))
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
