"""Workload drift: online adaptation on against the frozen placement.

Serves two phases over identical stacks. Phase 1 draws seeds from the
distribution the placement was computed for; phase 2 moves 90% of the
seed mass onto a subgraph that the initial FAP ranked cold (on the
HOST/DISK tiers). With adaptation off the stale placement keeps paying
the slow tiers; with the :class:`~repro_torch.serving.AdaptiveController`
hooked into the engine, the frequency sketch sees the drift, FAP is
recomputed with the observed seed distribution and the hot rows migrate
into the device tiers while serving continues. Reported: the share of the
workload's feature accesses that land on the slow tiers: before the
drift (phase 1's seeds on the plan as built, in the results only), and
after it, frozen and adaptive (emitted), with p99, migrated rows and
refits.

    PYTHONPATH=src python -m repro_torch.bench.run --only workload_drift

``dry_run=True`` takes the reference's CI sizes.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench.common import build_serving_stack, emit, make_executors
from repro_torch.core import Request
from repro_torch.graph.sampler import host_sample_dense
from repro_torch.serving import (AdaptiveConfig, AdaptiveController,
                                 CostModelRouter, ServingEngine,
                                 calibrate_executors, pad_to_bucket)


def _requests(seed_arrays, start_id: int = 0):
    return [[Request(start_id + i, s, time.perf_counter())]
            for i, s in enumerate(seed_arrays)]


def host_access_rate(graph, store, seed_batches, fanouts, *,
                     seed: int = 0) -> float:
    """Share of sampled feature accesses (seeds and every hop's
    neighbours) that land on the slow HOST/DISK tiers under the store's
    current plan."""
    rng = np.random.default_rng(seed)
    hbm = slow = 0
    for seeds in seed_batches:
        hops = host_sample_dense(rng, graph,
                                 pad_to_bucket(seeds.astype(np.int32)),
                                 fanouts)
        ids = np.concatenate([np.asarray(h).ravel() for h in hops])
        h = store.tier_histogram(ids)
        hbm += h["hot"] + h["warm"]
        slow += h["host"] + h["disk"]
    return slow / max(hbm + slow, 1)


def run(*, dry_run: bool = False,
        device: str | torch.device = "cuda") -> dict:
    """Emit each mode's slow-tier access rate after the drift and the
    adaptation's gain in percentage points; returns the modes' results
    and ``before_drift``."""
    nodes = 600 if dry_run else 4000
    per = 8
    n1, n2 = (10, 20) if dry_run else (40, 120)
    fanouts = (4, 3) if dry_run else (6, 4)

    results = {}
    seed_rng = np.random.default_rng(11)
    # one stack build defines the workload + hotspot; each system then gets
    # its own fresh store/plan so migration in one cannot leak into the other
    base = build_serving_stack(nodes=nodes, fanouts=fanouts, seed=0,
                               distribution="degree", device=device)
    graph = base["graph"]

    # phase-1 seeds follow the calibrated-for distribution; phase-2 seeds
    # concentrate on nodes the initial plan put on the slow tiers
    cold = np.flatnonzero(base["store"].plan.tier >= 2)  # HOST + DISK
    if cold.size == 0:
        raise RuntimeError("placement has no cold tier; enlarge the graph")
    hotspot = cold[seed_rng.permutation(cold.size)[:max(cold.size // 4, 8)]]
    p2 = np.full(nodes, 0.1 / nodes)
    p2[hotspot] += 0.9 / hotspot.size
    p2 /= p2.sum()

    phase1 = [seed_rng.choice(nodes, size=per, p=base["gen"].p)
              for _ in range(n1)]
    phase2 = [seed_rng.choice(nodes, size=per, p=p2) for _ in range(n2)]
    probe = [seed_rng.choice(nodes, size=per, p=p2) for _ in range(16)]
    # the placement as built on the workload it was built for
    results["before_drift"] = {"host_access_rate": host_access_rate(
        graph, base["store"], phase1, fanouts)}

    for mode in ("static", "adaptive"):
        stack = build_serving_stack(nodes=nodes, fanouts=fanouts, seed=0,
                                    distribution="degree", device=device)
        executors = make_executors(stack, num_workers=2, max_batch=32)
        order = np.argsort(stack["psgs"])
        cal_batches = [order[int(q * nodes):][:per].astype(np.int64)
                       for q in np.linspace(0.05, 0.95, 4 if dry_run else 8)]
        curves = calibrate_executors(executors, cal_batches, stack["psgs"],
                                     repeats=1 if dry_run else 2)
        router = CostModelRouter.from_curves(stack["psgs"], curves,
                                             "latency_preferred",
                                             executors=executors)
        hooks = []
        controller = None
        if mode == "adaptive":
            controller = AdaptiveController(
                graph, fanouts, stack["store"], router,
                psgs_table=stack["psgs"],
                config=AdaptiveConfig(interval_batches=4 if dry_run else 8,
                                      rows_per_step=64 if dry_run else 256,
                                      decay=0.8))
            hooks.append(controller)
        engine = ServingEngine(executors, router, max_inflight=16,
                               hooks=hooks)
        engine.warmup(np.arange(per))

        engine.run(_requests(phase1))
        m2 = engine.run(_requests(phase2, start_id=n1))
        rate = host_access_rate(graph, stack["store"], probe, fanouts)
        results[mode] = {
            "p99_ms": m2.percentile(0.99) * 1e3,
            "host_access_rate": rate,
            "migrated_rows": stack["store"].migrated_rows,
            "refits": controller.report()["refits"] if controller else 0,
        }
        emit(f"workload_drift/{mode}_host_rate", rate * 100,
             f"p99={results[mode]['p99_ms']:.1f}ms;"
             f"migrated={results[mode]['migrated_rows']}")
        engine.close()

    win = (results["static"]["host_access_rate"]
           - results["adaptive"]["host_access_rate"])
    emit("workload_drift/adaptation_win_pp", win * 100,
         "host-tier access-rate reduction (percentage points)")
    return results
