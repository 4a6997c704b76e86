"""Fused feature collection: per-hop lookups against one ``lookup_hops``.

The per-hop path collects a sample's features with one ``store.lookup(h)``
a hop: two device-tier gathers and a host fetch for each. The fused path
(``TieredFeatureStore.lookup_hops``) deduplicates the ids of every hop
once and issues one address-sorted ``tiered_gather`` launch for the
device tiers plus at most one host fetch. On the serve_throughput
workload this reports:

  1. dispatches per sample, per-hop against fused (fewer, asserted);
  2. store-level collection time of both paths (synchronized);
  3. serving rps and p99 with the executors on the per-hop path, on the
     fused path, and fused behind ``MicroBatcher`` (``serve_stream(
     micro=)``: the PSGS-aware stage that hands the gather larger
     batches).

    PYTHONPATH=src python -m repro_torch.bench.run --only fused_gather

``dry_run=True`` takes the reference's CI sizes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.common import (build_serving_stack, emit, make_engine,
                                      timeit, write_bench_json)
from repro_torch.core import DynamicBatcher
from repro_torch.graph.sampler import host_sample_dense
from repro_torch.serving import HybridScheduler, MicroBatcher, pad_to_bucket


def sample_hops(stack, seeds: np.ndarray, seed: int = 0) -> list:
    """One request's dense hops from a host sampler seeded with ``seed``,
    as ``int32`` tensors on the store's device."""
    rng = np.random.default_rng(seed)
    hops = host_sample_dense(rng, stack["graph"],
                             pad_to_bucket(seeds.astype(np.int32)),
                             stack["fanouts"])
    dev = stack["store"].device
    return [torch.as_tensor(np.asarray(h), dtype=torch.int32, device=dev)
            for h in hops]


def run(*, dry_run: bool = False,
        device: str | torch.device = "cuda") -> dict:
    """Emit dispatches a sample, collection µs and each mode's serving
    rps; returns the results written to ``BENCH_fused_gather.json``."""
    nodes = 800 if dry_run else 5000
    n_req, per = (10, 8) if dry_run else (60, 8)
    stack = build_serving_stack(nodes=nodes, device=device)
    store, psgs, gen = stack["store"], stack["psgs"], stack["gen"]
    dev = store.device
    results: dict = {}

    # -- 1) dispatch counts per sample ---------------------------------------
    hops = sample_hops(stack, gen.make_request(per).seeds)
    store.reset_stats()
    [store.lookup(h) for h in hops]
    d_old = store.reset_stats()
    store.lookup_hops(hops)
    d_new = store.reset_stats()
    old_n = d_old["device_gathers"] + d_old["host_fetches"]
    new_n = d_new["device_gathers"] + d_new["host_fetches"]
    assert new_n < old_n, (new_n, old_n)
    results["dispatches"] = {"per_hop": old_n, "fused": new_n}
    emit("fused_gather/dispatches_per_sample", float(new_n),
         f"per_hop={old_n};reduction={old_n / max(new_n, 1):.1f}x")

    # -- 2) store-level feature-collection latency ---------------------------
    store.reset_stats()
    t_old = timeit(lambda: [store.lookup(h) for h in hops], device=dev)
    t_new = timeit(lambda: store.lookup_hops(hops), device=dev)
    results["collect_us"] = {"per_hop": t_old * 1e6, "fused": t_new * 1e6}
    emit("fused_gather/collect_per_hop_us", t_old * 1e6)
    emit("fused_gather/collect_fused_us", t_new * 1e6,
         f"speedup={t_old / max(t_new, 1e-12):.2f}x")
    store.reset_stats()

    # -- 3) end-to-end serving: per-hop vs fused vs fused+micro --------------
    thr = float(np.median(psgs)) * per * 2
    for mode in ("per_hop", "fused", "fused_micro"):
        engine = make_engine(stack, HybridScheduler(psgs, thr),
                             num_workers=2, max_batch=32,
                             fused=mode != "per_hop")
        gen.rng = np.random.default_rng(7)  # same workload for all modes
        reqs = list(gen.stream(n_req, seeds_per_request=per))
        engine.warmup([reqs[0]])
        store.reset_stats()
        if mode == "fused_micro":
            micro = MicroBatcher(deadline_s=0.004, max_seeds=4 * per,
                                 psgs_table=psgs)
            m = engine.serve_stream(reqs, DynamicBatcher(deadline_s=0.0,
                                                         max_batch=1),
                                    micro=micro)
            extra = f";super_batches={micro.emitted}"
        else:
            m = engine.run([[r] for r in reqs])
            extra = ""
        stats = store.reset_stats()
        s = m.summary()
        results[mode] = {"rps": s["throughput_rps"], "p99_ms": s["p99_ms"],
                         "dispatches": stats["device_gathers"]
                         + stats["host_fetches"]}
        emit(f"fused_gather/{mode}_rps", s["throughput_rps"],
             f"p99={s['p99_ms']:.1f}ms;"
             f"dispatches={results[mode]['dispatches']}" + extra)
        engine.close()

    win = results["fused"]["rps"] / max(results["per_hop"]["rps"], 1e-9)
    emit("fused_gather/serve_speedup_x", win,
         "fused vs per-hop end-to-end throughput")
    results["serve_speedup_x"] = win
    write_bench_json("fused_gather", results)
    return results
