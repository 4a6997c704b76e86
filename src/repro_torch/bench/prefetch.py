"""Cold-tier prefetch: host fetches on the critical path with and without
the device-side stage.

HOST and DISK rows cost a host fetch on the request's critical path; the
prefetcher (:class:`~repro_torch.core.Prefetcher`) stages the predicted
cold rows in device memory off that path, so lookups read them with a
device gather and fetch from the host only on a miss. On a zipf-skewed
workload over a store whose DISK tier is a spill file (``np.memmap``)
this reports:

  1. the DISK tier's exactness: lookups on the spill-backed store equal
     an all-HOT store's bit for bit, unstaged, staged and fused
     (asserted);
  2. host fetches and DISK misses a request, prefetch off and on (on <
     off, asserted);
  3. serving rps and p99 of both modes, and the stage's hit/miss split.

    PYTHONPATH=src python -m repro_torch.bench.run --only prefetch

``dry_run=True`` takes the reference's CI sizes.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from repro_torch.bench.common import (build_serving_stack, emit,
                                      latency_percentiles, make_engine,
                                      same_bits, write_bench_json)
from repro_torch.core import (Prefetcher, TieredFeatureStore, TopologySpec,
                              quiver_placement)
from repro_torch.core.placement import TIER_HOST
from repro_torch.serving import HybridScheduler


def all_hot_reference(stack) -> TieredFeatureStore:
    """The stack's features with every row replicated in HBM (no cold
    tiers), on the stack's device."""
    nodes = stack["graph"].num_nodes
    topo = TopologySpec(num_pods=1, devices_per_pod=1, rows_per_device=nodes,
                        rows_host=64, hot_replicate_fraction=1.0)
    return TieredFeatureStore.build(stack["feats"],
                                    quiver_placement(stack["fap"], topo),
                                    device=stack["store"].device)


def _disk_bit_identity(stack, store) -> None:
    """Spill-backed lookups must equal the all-HOT store's bit for bit,
    staged or not (DISK rows are real feature rows, not zeros)."""
    ref = all_hot_reference(stack)
    rng = np.random.default_rng(11)
    ids = rng.integers(-1, stack["graph"].num_nodes, 512).astype(np.int32)
    want = ref.lookup(ids)
    assert same_bits(want, store.lookup(ids)), "spill-backed lookup diverged"
    pf = Prefetcher(store, budget=stack["graph"].num_nodes)
    try:
        pf.refresh(scores=stack["fap"])
        got_staged = store.lookup(ids)
        [got_fused] = store.lookup_hops([ids])
    finally:
        store.publish_stage(None, None)
        pf.close()
    assert same_bits(want, got_staged), "staged lookup diverged"
    assert same_bits(want, got_fused), "fused diverged"
    emit("prefetch/disk_bit_identical", 1.0,
         "spill-backed == all-HOT reference, staged and unstaged")


def run(*, dry_run: bool = False,
        device: str | torch.device = "cuda") -> dict:
    """Emit the DISK identity, host fetches a request with the stage off
    and on, and their reduction; returns the modes' results (also in
    ``BENCH_prefetch.json``)."""
    nodes = 900 if dry_run else 6000
    n_req, per = (12, 8) if dry_run else (60, 8)
    spill = tempfile.NamedTemporaryFile(suffix=".spill", delete=False)
    spill.close()
    try:
        # small HBM tiers (rows_frac) so the skewed stream actually exercises
        # the cold path: the off-mode baseline pays real host fetches
        stack = build_serving_stack(nodes=nodes, distribution="zipf",
                                    rows_frac=0.1, spill_path=spill.name,
                                    device=device)
        store, psgs, gen, fap = (stack["store"], stack["psgs"], stack["gen"],
                                 stack["fap"])
        results: dict = {}

        # -- 1) DISK tier is real: bit-identity vs all-HOT reference ---------
        _disk_bit_identity(stack, store)

        # -- 2/3) serve the same skewed stream, prefetch off vs on -----------
        n_cold = int((store.tier_np >= TIER_HOST).sum())
        thr = float(np.median(psgs)) * per * 2
        for mode in ("off", "on"):
            engine = make_engine(stack, HybridScheduler(psgs, thr),
                                 num_workers=2, max_batch=32)
            pf = None
            if mode == "on":
                # stage the offline-FAP prediction (covers multi-hop
                # frontiers); budget sized to the cold working set
                pf = Prefetcher(store, budget=n_cold)
                staged = pf.refresh(scores=fap)
                emit("prefetch/staged_rows", float(staged),
                     f"cold_rows={n_cold}")
            gen.rng = np.random.default_rng(7)  # same workload both modes
            reqs = list(gen.stream(n_req, seeds_per_request=per))
            engine.warmup([reqs[0]])
            store.reset_stats()
            m = engine.run([[r] for r in reqs])
            stats = store.reset_stats()
            s = m.summary()
            results[mode] = {
                "rps": s["throughput_rps"], "p99_ms": s["p99_ms"],
                "host_cb_per_req": stats["host_fetches"] / n_req,
                "disk_miss_per_req": stats["disk_misses"] / n_req,
                "prefetch_hits": stats["prefetch_hits"],
                "prefetch_misses": stats["prefetch_misses"],
                **latency_percentiles(m),
            }
            emit(f"prefetch/{mode}_host_cb_per_req",
                 results[mode]["host_cb_per_req"],
                 f"p99={s['p99_ms']:.1f}ms;rps={s['throughput_rps']:.1f};"
                 f"disk_miss_per_req={results[mode]['disk_miss_per_req']:.2f}")
            engine.close()
            store.publish_stage(None, None)
            if pf is not None:
                pf.close()

        off, on = results["off"], results["on"]
        emit("prefetch/host_cb_reduction_x",
             off["host_cb_per_req"] / max(on["host_cb_per_req"], 1e-9),
             f"hits={on['prefetch_hits']};misses={on['prefetch_misses']}")
        # the acceptance signal: staging strictly removes critical-path
        # host fetches on the skewed workload
        assert on["host_cb_per_req"] < off["host_cb_per_req"], results
        write_bench_json("prefetch", {"dry_run": dry_run, "modes": results})
        return results
    finally:
        os.unlink(spill.name)
