"""Quickstart: the whole Quiver stack on a small synthetic graph — the port
of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

Builds a skewed graph, computes the workload metrics (PSGS and FAP),
places the features across the tiered store, routes by the PSGS hybrid
scheduler and serves 30 GNN requests end to end through the host and
device executors, then prints the run's summary. The reference builds its
engine through the pre-executor-graph ``ServingEngine(graph, store, ...)``
form (a deprecation shim the port leaves out); this takes the same two
executors from the serving launcher's ``build_executors``. Runs on the
card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (TieredFeatureStore, TopologySpec,
                              WorkloadGenerator, compute_fap, compute_psgs,
                              quiver_placement)
from repro_torch.graph import power_law_graph
from repro_torch.launch.serve import build_executors, make_model_infer_fn
from repro_torch.serving import HybridScheduler, ServingEngine


def run(device: str | torch.device = "cuda") -> dict:
    """The quickstart on ``device``; prints each step and returns the
    serving summary."""
    dev = resolve_device(device)
    # 1. graph + features (stand-in for ogbn-products/Reddit)
    graph = power_law_graph(3000, 8.0, seed=0)
    feats = np.random.default_rng(1).normal(
        size=(graph.num_nodes, 64)).astype(np.float32)
    fanouts = (6, 4)
    print(f"graph: {graph.num_nodes} nodes / {graph.num_edges} edges, "
          f"max out-degree {graph.out_degree.max()}")

    # 2. workload metrics (paper §4.1 / §5.1)
    psgs = compute_psgs(graph, fanouts, device=dev)
    gen = WorkloadGenerator(graph.num_nodes, graph.out_degree, seed=2)
    fap = compute_fap(graph, fanouts, seed_prob=gen.p, device=dev)
    print(f"PSGS: min={psgs.min():.1f} median={np.median(psgs):.1f} "
          f"max={psgs.max():.1f}")

    # 3. workload-aware placement + tiered feature store (§5.2/§5.3)
    topo = TopologySpec(num_pods=1, devices_per_pod=1,
                        rows_per_device=800, rows_host=1400,
                        hot_replicate_fraction=0.3)
    plan = quiver_placement(fap, topo)
    store = TieredFeatureStore.build(feats, plan, device=dev)
    print("placement tiers:", plan.tier_counts())

    # 4. model + serving engine with the PSGS hybrid scheduler (§4.2)
    infer_fn = make_model_infer_fn(64, (64, 64), fanouts, seed=0,
                                   device=dev)
    executors = build_executors(graph, store, fanouts, infer_fn, psgs,
                                num_workers=2, max_batch=32)
    sched = HybridScheduler(psgs, threshold=float(np.median(psgs)) * 64)
    engine = ServingEngine(executors, sched)

    # 5. serve!
    batches = [[r] for r in gen.stream(30, seeds_per_request=8)]
    engine.warmup(batches[0])
    summary = engine.run(batches).summary()
    engine.close()
    for k, v in summary.items():
        print(f"  {k}: {v}")
    return summary


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(prog="repro_torch.launch.quickstart")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    summary = run(args.device)
    print(json.dumps({k: summary[k] for k in (
        "requests", "throughput_rps", "p50_ms", "p99_ms", "routed")}))
    return summary


if __name__ == "__main__":
    main()
