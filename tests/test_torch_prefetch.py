"""Port prefetch stage and ``Prefetcher`` against the JAX package's: lookups
with no stage, a partial stage and a full stage equal the reference's bit
for bit (``lookup``, ``lookup_hops``, ``lookup_aggregate``) with equal
prefetch and host-fetch counters; ``include_host=False`` ignores both the
cache and the stage; the prefetcher predicts and stages the same rows;
``read_cold_rows`` reads the same rows and counts the same spill reads;
the async worker re-raises its error; the engine-hook mode refreshes on
its cadence; a refresh racing migration and lookups stays exact."""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GPUFeatureCache as JaxCache
from repro.core import Prefetcher as JaxPrefetcher
from repro.core import TieredFeatureStore as JaxStore
from repro.core import TopologySpec as JaxTopo
from repro.core import compute_fap as jax_fap
from repro.core import quiver_placement as jax_placement
from repro.graph import power_law_graph as jax_power_law
from repro.serving import FrequencySketch as JaxSketch
from repro_torch.core import (GPUFeatureCache, Prefetcher, Request,
                              TieredFeatureStore, TopologySpec,
                              migration_pairs, quiver_placement)
from repro_torch.core.placement import TIER_DISK, TIER_HOST
from repro_torch.graph import power_law_graph
from repro_torch.launch.serve import make_model_infer_fn
from repro_torch.serving import (FrequencySketch, HostExecutor,
                                 ServingEngine, StaticScheduler)
from repro_torch.testing import FakeClock

N, D, FAN = 900, 12, (4, 3)
TOPO = dict(num_pods=1, devices_per_pod=1, rows_per_device=220,
            rows_host=330, hot_replicate_fraction=0.3)


@pytest.fixture(scope="module")
def stack():
    gj = jax_power_law(N, 6.0, seed=0)
    feats = np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)
    return feats, jax_fap(gj, FAN)


def _stores(stack, spill=None):
    feats, fap = stack
    port = TieredFeatureStore.build(
        feats, quiver_placement(fap, TopologySpec(**TOPO)),
        spill_path=None if spill is None else str(spill / "t.spill"),
        device="cpu")
    ref = JaxStore.build(feats, jax_placement(fap, JaxTopo(**TOPO)),
                         spill_path=None if spill is None
                         else str(spill / "j.spill"))
    return port, ref


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _outputs(store, hops, include_host, jax_side):
    cvt = (lambda h: jnp.asarray(h)) if jax_side else (lambda h: h)
    out = [store.lookup(cvt(hops[1]), include_host=include_host)]
    out += store.lookup_hops([cvt(h) for h in hops],
                             include_host=include_host)
    feats, agg = store.lookup_aggregate([cvt(h) for h in hops],
                                        include_host=include_host)
    return [_np(x) for x in out + list(feats) + [agg]]


def _stage(store, ids, rows, jax_side):
    slot = np.full(N, -1, np.int32)
    slot[ids] = np.arange(ids.size, dtype=np.int32)
    store.publish_stage(slot, jnp.asarray(rows) if jax_side
                        else torch.from_numpy(rows))


@pytest.mark.parametrize("staged", ["none", "partial", "full"])
@pytest.mark.parametrize("include_host", [True, False])
def test_staged_lookups_match_reference(stack, staged, include_host):
    """Staged, partly staged and unstaged lookups: equal to the reference
    and to the unstaged port store, bit for bit, with equal counters. With
    ``include_host=False`` a cache is attached too, and neither it nor the
    stage is touched."""
    feats, _ = stack
    port, ref = _stores(stack)
    plain, _ = _stores(stack)
    cold = np.flatnonzero(port.tier_np >= TIER_HOST)
    ids = {"none": cold[:0], "partial": cold[::2], "full": cold}[staged]
    if ids.size:
        _stage(port, ids, feats[ids], False)
        _stage(ref, ids, feats[ids], True)
    if not include_host:
        port.attach_cache(GPUFeatureCache.for_store(port, 64))
        ref.attach_cache(JaxCache.for_store(ref, 64))
    rng = np.random.default_rng(3)
    for _ in range(2):
        hops = [rng.integers(-1, N, s).astype(np.int32) for s in (8, 32, 96)]
        a = _outputs(port, hops, include_host, False)
        b = _outputs(ref, hops, include_host, True)
        c = _outputs(plain, hops, include_host, False)
        for x, y, z in zip(a, b, c):
            assert x.tobytes() == y.tobytes() == z.tobytes()
    st = port.snapshot_stats()
    assert st == ref.snapshot_stats()
    assert port.staged_rows() == ref.staged_rows() == ids.size
    if not include_host:
        assert st["prefetch_hits"] == st["prefetch_misses"] == 0
        assert st["cache_hits"] == st["cache_misses"] == 0
        assert st["host_fetches"] == 0
    elif staged == "full":
        assert st["prefetch_misses"] == 0 and st["host_fetches"] == 0
    elif staged == "partial":
        assert st["prefetch_hits"] > 0 and st["prefetch_misses"] > 0
    else:
        assert st["prefetch_hits"] == st["prefetch_misses"] == 0


def test_stage_and_cache_together_match_reference(stack, tmp_path):
    """Cache in front, stage behind it, spill file behind both: equal rows
    and counters, and the cache admits the staged rows it misses."""
    feats, _ = stack
    port, ref = _stores(stack, spill=tmp_path)
    cold = np.flatnonzero(port.tier_np >= TIER_HOST)[::3]
    _stage(port, cold, feats[cold], False)
    _stage(ref, cold, feats[cold], True)
    port.attach_cache(GPUFeatureCache.for_store(port, 32))
    ref.attach_cache(JaxCache.for_store(ref, 32))
    rng = np.random.default_rng(5)
    for _ in range(3):
        hops = [rng.integers(-1, N, s).astype(np.int32) for s in (8, 32, 96)]
        for x, y in zip(_outputs(port, hops, True, False),
                        _outputs(ref, hops, True, True)):
            assert x.tobytes() == y.tobytes()
    assert port.snapshot_stats() == ref.snapshot_stats()
    assert port.cache.report() == ref.cache.report()
    assert np.array_equal(port._disk_miss_counts, ref._disk_miss_counts)


@pytest.mark.parametrize("budget", [7, 64, 2000])
def test_prefetcher_stages_what_the_reference_stages(stack, tmp_path,
                                                     budget):
    feats, fap = stack
    port, ref = _stores(stack, spill=tmp_path)
    sk, jsk = FrequencySketch(N), JaxSketch(N)
    seeds = np.random.default_rng(2).integers(0, N, 400)
    sk.observe(seeds)
    jsk.observe(seeds)
    a, b = Prefetcher(port, sk, budget=budget), JaxPrefetcher(ref, jsk,
                                                              budget=budget)
    assert np.array_equal(a.predict(), b.predict())
    assert np.array_equal(a.predict(fap), b.predict(fap))
    assert a.refresh(scores=fap) == b.refresh(scores=fap)
    assert a.refresh() == b.refresh()
    sa, sb = port._stage, ref._stage
    assert np.array_equal(sa[0], sb[0])
    assert _np(sa[1]).tobytes() == _np(sb[1]).tobytes()
    assert a.report() == b.report()
    assert port.snapshot_stats() == ref.snapshot_stats()
    assert a.refresh(scores=np.zeros(N)) == 0 and port.staged_rows() == 0
    for pf in (a, b):
        pf.close()


def test_read_cold_rows_matches_reference(stack, tmp_path):
    """Rows from every tier (a promoted row is read back from the device
    tier that now holds it) and the spill-read count."""
    feats, _ = stack
    port, ref = _stores(stack, spill=tmp_path)
    ids = np.random.default_rng(4).integers(0, N, 200)
    a, b = port.read_cold_rows(ids), ref.read_cold_rows(ids)
    assert a.tobytes() == b.tobytes() and np.array_equal(a, feats[ids])
    assert port.snapshot_stats() == ref.snapshot_stats()
    assert port.stats["spill_reads"] == int(
        (port.tier_np[ids] == TIER_DISK).sum())


def test_predict_cold_only_budget_and_zero_scores(stack):
    port, _ = _stores(stack)
    pf = Prefetcher(port, budget=5)
    ids = pf.predict(scores=np.ones(N))
    assert ids.size == 5 and (port.tier_np[ids] >= TIER_HOST).all()
    assert pf.predict(scores=np.zeros(N)).size == 0
    with pytest.raises(ValueError, match="scores or a sketch"):
        pf.predict()
    with pytest.raises(ValueError, match="budget"):
        Prefetcher(port, budget=0)
    pf.close()


def test_refresh_async_reraises_worker_error(stack):
    port, _ = _stores(stack)
    pf = Prefetcher(port, budget=8)

    def boom(_ids):
        raise RuntimeError("spill read failed")

    port.read_cold_rows = boom
    fut = pf.refresh_async(scores=np.ones(N))
    with pytest.raises(RuntimeError):
        fut.result(timeout=30)
    deadline = time.time() + 30
    while pf._error is None and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="spill read failed"):
        pf.refresh_async(scores=np.ones(N))
    assert pf.refresh_async(scores=np.zeros(N)).result(timeout=30) == 0
    pf.close()


def test_refresh_cadence_by_batches_and_clock(stack):
    port, _ = _stores(stack)
    clk = FakeClock()
    pf = Prefetcher(port, FrequencySketch(N), budget=16, refresh_every=3,
                    refresh_every_s=1.0, clock=clk)
    seeds = np.flatnonzero(port.tier_np >= TIER_HOST)[:8]
    for _ in range(2):
        pf.on_admit("host", seeds)
        pf.on_batch_complete("host", seeds, 0.001)
    assert pf.report()["refreshes"] == 0
    clk.advance(1.5)               # the wall-clock cadence fires first
    pf.on_batch_complete("host", seeds, 0.001)
    pf.close()
    assert pf.report()["refreshes"] == 1
    assert pf.report()["batches_seen"] == 3
    assert pf.sketch.counts[seeds].max() == pytest.approx(2 * 0.9)
    assert port.staged_rows() == 0           # close clears the stage


def test_prefetcher_standalone_engine_hook(stack):
    """As an engine hook the prefetcher feeds its own sketch and refreshes
    every ``refresh_every`` completed batches."""
    feats, fap = stack
    g = power_law_graph(N, 6.0, seed=0)
    port, _ = _stores(stack)
    infer = make_model_infer_fn(D, (16, 16), FAN, device="cpu")
    host = HostExecutor(g, port, FAN, infer)
    pf = Prefetcher(port, FrequencySketch(N), budget=64, refresh_every=3)
    engine = ServingEngine({"host": host}, StaticScheduler("host"),
                           hooks=[pf])
    cold = np.argsort(fap)[:8]
    m = engine.run([[Request(i, cold.copy(), time.perf_counter())]
                    for i in range(9)])
    engine.close()
    pf.close()
    assert m.requests == 9
    rep = pf.report()
    assert rep["batches_seen"] == 9 and rep["refreshes"] >= 1
    assert pf.sketch.total_observed == 9 * 8


def test_prefetch_refresh_racing_migration_and_lookups(stack, tmp_path):
    """One thread runs fused lookups, one re-publishes the stage with
    random scores, while the main thread migrates rows and promotes
    misses: every observed row stays exact."""
    feats, fap = stack
    port, _ = _stores(stack, spill=tmp_path)
    topo = port.plan.topology
    rng = np.random.default_rng(7)
    hops = [rng.integers(0, N, 16).astype(np.int32),
            rng.integers(0, N, 48).astype(np.int32)]
    expected = [feats[h] for h in hops]
    stop = threading.Event()
    errors: list[str] = []
    pf = Prefetcher(port, budget=N)

    def reader():
        while not stop.is_set():
            got = port.lookup_hops(hops)
            if not all(np.array_equal(o.numpy(), e)
                       for o, e in zip(got, expected)):
                errors.append("torn staged lookup during migration")
                return

    def refresher():
        rrng = np.random.default_rng(13)
        while not stop.is_set():
            scores = rrng.random(N)
            scores[scores < 0.5] = 0.0
            try:
                pf.refresh(scores=scores)
            except BaseException as exc:  # surface, don't hang the test
                errors.append(f"refresh raised: {exc!r}")
                return

    threads = [threading.Thread(target=reader),
               threading.Thread(target=refresher)]
    for t in threads:
        t.start()
    try:
        drifted = fap.copy()
        drifted[np.argsort(fap)[:80]] += fap.max() * 3
        tgt = quiver_placement(drifted, topo)
        for _ in range(10):
            pairs = migration_pairs(port.plan.tier, tgt.tier, drifted,
                                    budget=20)
            if pairs:
                port.swap_assignments(pairs)
            port.promote_misses(budget=4)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    pf.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for e, o in zip(expected, port.lookup_hops(hops)):
        assert np.array_equal(o.numpy(), e)
