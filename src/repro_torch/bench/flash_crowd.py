"""Flash crowd: the device cache against adaptive placement alone, between
two control steps.

The adaptive controller reacts only at control steps (every
``interval_batches`` batches): a flash crowd that lands between two steps
pays the slow tiers on every request until the next step migrates its
rows. The request-granularity :class:`~repro_torch.core.GPUFeatureCache`
closes that gap: the first miss admits a row into device memory and each
later access hits there, so host fetches fall within the same interval.

Both modes serve identical seeded streams over identical fresh stacks
with an :class:`~repro_torch.serving.AdaptiveController` hooked into the
engine; ``cache`` also attaches a device cache sharing the controller's
frequency sketch. Phase 1 warms the system on the placement's own
distribution (crossing one control step); then all seed mass jumps onto
cold nodes the sketch has never seen (:func:`flash_hotspot`), sized to
land between two control steps (asserted: the step counter does not move
inside the window). Host fetches a request are read over the second half
of the flash window, with latency percentiles and the cache's counters.
Asserted in the run: the cache strictly reduces host fetches in that
window, and cached lookups equal uncached ones and an all-HOT store's,
bit for bit.

    PYTHONPATH=src python -m repro_torch.bench.run --only flash_crowd

``dry_run=True`` takes the reference's CI sizes.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from repro_torch.bench.common import (build_serving_stack, emit,
                                      latency_percentiles, make_executors,
                                      same_bits, write_bench_json)
from repro_torch.bench.prefetch import all_hot_reference
from repro_torch.core import GPUFeatureCache
from repro_torch.core.placement import TIER_HOST
from repro_torch.serving import (AdaptiveConfig, AdaptiveController,
                                 HybridScheduler, ServingEngine)


def _assert_bit_identical(stack, store) -> None:
    """Cached lookups must equal uncached lookups and the all-HOT store
    bit for bit, after migrations ran and the cache filled."""
    ref = all_hot_reference(stack)
    rng = np.random.default_rng(13)
    hops = [rng.integers(-1, stack["graph"].num_nodes, n).astype(np.int32)
            for n in (64, 256)]
    cached = store.lookup_hops(hops)
    cached_flat = store.lookup(hops[1])
    cache = store.cache
    store.attach_cache(None)  # detach: uncached tier path
    try:
        plain = store.lookup_hops(hops)
        plain_flat = store.lookup(hops[1])
    finally:
        store.attach_cache(cache)
    want = ref.lookup_hops(hops)
    for c, p, w in zip(cached, plain, want):
        assert same_bits(c, p), "cached lookup_hops != uncached"
        assert same_bits(c, w), "cached lookup_hops != all-HOT ref"
    assert same_bits(cached_flat, plain_flat), "cached lookup diverged"
    emit("flash_crowd/bit_identical", 1.0,
         "cached == uncached == all-HOT reference")


def flash_hotspot(store, fap, *, size: int) -> np.ndarray:
    """The ``size`` cold-tier nodes the offline FAP ranked lowest: phase-1
    traffic never touches them, so migration leaves them cold for the
    flash phase (``gateway_soak`` builds its slow-tier overload on them
    too)."""
    tier = np.asarray(store.tier_np)
    cold = np.flatnonzero(tier >= TIER_HOST)
    if cold.size == 0:
        raise RuntimeError("placement has no cold tier; enlarge the graph")
    return cold[np.argsort(np.asarray(fap)[cold])][:size]


def run(*, dry_run: bool = False,
        device: str | torch.device = "cuda") -> dict:
    """Emit host fetches a request in the flash window for adaptive-only
    and with the cache, and the reduction; returns the modes' results
    (also in ``BENCH_flash_crowd.json``)."""
    nodes = 600 if dry_run else 4000
    per = 8
    fanouts = (4, 3) if dry_run else (6, 4)
    interval = 10 if dry_run else 24
    n_warm, n_flash = (interval, (interval - 2) // 2)
    hotspot_size = 4 if dry_run else 8
    spill = tempfile.NamedTemporaryFile(suffix=".spill", delete=False)
    spill.close()
    results: dict = {}
    try:
        for mode in ("adaptive", "cache"):
            # fresh stack per mode (same seed -> identical plan/workload);
            # small HBM tiers so the flash crowd really lands on cold tiers
            stack = build_serving_stack(nodes=nodes, fanouts=fanouts, seed=0,
                                        distribution="zipf", rows_frac=0.1,
                                        spill_path=spill.name, device=device)
            store, psgs, gen = stack["store"], stack["psgs"], stack["gen"]
            executors = make_executors(stack, num_workers=2, max_batch=32)
            router = HybridScheduler(psgs, float(np.median(psgs)) * per * 2)
            # router=None: the HybridScheduler has no cost curves to refit;
            # the controller still does sketch/migration/cold-path tuning
            controller = AdaptiveController(
                stack["graph"], fanouts, store, None, psgs_table=psgs,
                config=AdaptiveConfig(interval_batches=interval,
                                      rows_per_step=64, decay=0.8))
            if mode == "cache":
                store.attach_cache(GPUFeatureCache.for_store(
                    store, nodes // 4, sketch=controller.sketch))
            engine = ServingEngine(executors, router, max_inflight=16,
                                   hooks=[controller])
            engine.warmup(np.arange(per))

            # phase 1: calibrated-for stream, exactly one control step
            gen.rng = np.random.default_rng(7)
            warm = list(gen.stream(n_warm, seeds_per_request=per))
            engine.run([[r] for r in warm])

            # flash phase: all seed mass jumps onto never-seen cold nodes;
            # two half-windows of n_flash requests each, 2*n_flash <
            # interval, so no control step can react anywhere inside it —
            # the second (steady-state) half is the measured window
            hotspot = flash_hotspot(store, stack["fap"], size=hotspot_size)
            p2 = np.zeros(nodes)
            p2[hotspot] = 1.0 / hotspot.size
            gen.set_seed_prob(p2)
            gen.rng = np.random.default_rng(9)
            steps_before = controller.report()["steps"]
            onset = list(gen.stream(n_flash, seeds_per_request=per))
            engine.run([[r] for r in onset])
            flash = list(gen.stream(n_flash, seeds_per_request=per))
            store.reset_stats()
            m = engine.run([[r] for r in flash])
            stats = store.snapshot_stats()
            steps = controller.report()["steps"]
            assert steps == steps_before, \
                "control step fired inside the flash window"

            results[mode] = {
                "host_cb_per_req": stats["host_fetches"] / n_flash,
                "cache_hits": stats["cache_hits"],
                "cache_misses": stats["cache_misses"],
                "cache_evictions": stats["cache_evictions"],
                "control_steps": steps,
                **latency_percentiles(m),
            }
            emit(f"flash_crowd/{mode}_host_cb_per_req",
                 results[mode]["host_cb_per_req"],
                 f"p99={results[mode]['p99_ms']:.1f}ms;"
                 f"cache_hits={stats['cache_hits']};steps={steps}")
            if mode == "cache":
                _assert_bit_identical(stack, store)
            engine.close()

        off, on = results["adaptive"], results["cache"]
        emit("flash_crowd/host_cb_reduction_x",
             off["host_cb_per_req"] / max(on["host_cb_per_req"], 1e-9),
             f"window={n_flash}req steady-state between control steps")
        # the acceptance signal: within one control interval the cache
        # strictly reduces critical-path host fetches vs adaptive-only
        assert on["host_cb_per_req"] < off["host_cb_per_req"], results
        write_bench_json("flash_crowd", {"dry_run": dry_run,
                                         "modes": results})
        return results
    finally:
        os.unlink(spill.name)
