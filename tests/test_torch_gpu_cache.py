"""Port ``GPUFeatureCache`` against the JAX package's: the same
``query`` / ``replace`` / ``invalidate`` / ``resize`` sequence gives equal
slot tables, counters and rows, bit for bit; cached store lookups equal the
reference's and the port's uncached lookups bit for bit, with equal
dispatch and cache counters (including the all-hit path that skips the
tier gather); migration invalidates exactly the swapped ids; and cached
lookups racing migration and stage churn stay exact."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GPUFeatureCache as JaxCache
from repro.core import TieredFeatureStore as JaxStore
from repro.core import TopologySpec as JaxTopo
from repro.core import compute_fap as jax_fap
from repro.core import quiver_placement as jax_placement
from repro.graph import power_law_graph as jax_power_law
from repro.serving import FrequencySketch as JaxSketch
from repro_torch.core import (GPUFeatureCache, Prefetcher, TieredFeatureStore,
                              TopologySpec, migration_pairs, quiver_placement)
from repro_torch.core.placement import TIER_HOST
from repro_torch.serving import FrequencySketch

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


def _same_state(a: GPUFeatureCache, b: JaxCache):
    assert np.array_equal(a._slot_of, b._slot_of)
    assert np.array_equal(a._node_of, b._node_of)
    assert np.array_equal(a._ref, b._ref)
    assert a._hand == b._hand and a._free == b._free
    assert a.capacity == b.capacity and a.stats == b.stats
    assert _np(a._rows).tobytes() == _np(b._rows).tobytes()
    assert a.report() == b.report()


@pytest.mark.parametrize("with_sketch", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_cache_sequence_matches_reference(with_sketch, seed):
    """A random sequence of the four operations, the same on both caches:
    every return value and the whole state after each op are equal."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(300, 8)).astype(np.float32)
    sk, jsk = (FrequencySketch(300), JaxSketch(300)) if with_sketch else (
        None, None)
    a = GPUFeatureCache(300, 24, 8, device="cpu", sketch=sk)
    b = JaxCache(300, 24, 8, sketch=jsk)
    for _ in range(40):
        op = rng.choice(["query", "query", "replace", "invalidate",
                         "resize", "observe"])
        if op == "observe" and with_sketch:
            seeds = rng.integers(0, 300, 16)
            sk.observe(seeds)
            jsk.observe(seeds)
        elif op in ("query", "replace"):
            ids = rng.integers(-1, 300, 20)
            va, ia, ma = a.query(ids)
            vb, ib, mb = b.query(jnp.asarray(ids))
            assert _np(va).tobytes() == _np(vb).tobytes()
            assert np.array_equal(ia, ib) and np.array_equal(ma, mb)
            if op == "replace":
                assert (a.replace(ma, torch.from_numpy(feats[ma]))
                        == b.replace(mb, jnp.asarray(feats[mb])))
        elif op == "invalidate":
            ids = rng.integers(-1, 300, 10)
            assert a.invalidate(ids) == b.invalidate(ids)
        elif op == "resize":
            cap = int(rng.integers(4, 40))
            assert a.resize(cap) == b.resize(cap)
        _same_state(a, b)
    # every resident row is the feature row of the node it holds
    live = np.flatnonzero(a._node_of >= 0)
    assert np.array_equal(a._rows[live].numpy(), feats[a._node_of[live]])


def test_cache_rejects_bad_capacity():
    with pytest.raises(ValueError):
        GPUFeatureCache(10, 0, 4, device="cpu")


@pytest.mark.parametrize("with_sketch", [False, True])
def test_replace_larger_than_capacity_keeps_final_owners(with_sketch,
                                                         monkeypatch):
    """One admission batch four times the capacity evicts its own earlier
    admissions: every slot must hold its final owner's row (the reference's
    in-order scatter). ``index_copy`` leaves the order of duplicate writes
    open, so each slot must be written once."""
    index_copy = torch.Tensor.index_copy

    def unique_index_copy(self, dim, index, source):
        assert index.unique().numel() == index.numel(), "duplicate slots"
        return index_copy(self, dim, index, source)

    monkeypatch.setattr(torch.Tensor, "index_copy", unique_index_copy)
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(5000, 64)).astype(np.float32)
    ids = rng.choice(5000, 1024, replace=False)
    sk, jsk = (FrequencySketch(5000), JaxSketch(5000)) if with_sketch else (
        None, None)
    a = GPUFeatureCache(5000, 256, 64, device="cpu", sketch=sk)
    b = JaxCache(5000, 256, 64, sketch=jsk)
    assert (a.replace(ids, torch.from_numpy(feats[ids]))
            == b.replace(ids, jnp.asarray(feats[ids])))
    _same_state(a, b)
    live = np.flatnonzero(a._node_of >= 0)
    assert live.size == 256
    assert np.array_equal(a._rows[live].numpy(), feats[a._node_of[live]])


def test_replace_builds_a_new_buffer():
    """Copy-on-write: a query's captured buffer never changes under a later
    replace or resize."""
    cache = GPUFeatureCache(50, 4, 3, device="cpu")
    cache.replace(np.arange(4), torch.ones(4, 3))
    before = cache._rows
    snap = before.clone()
    cache.replace(np.arange(10, 14), torch.full((4, 3), 7.0))
    assert cache._rows is not before and torch.equal(before, snap)
    cache.resize(8)
    assert torch.equal(before, snap)


def _calls(seed):
    rng = np.random.default_rng(seed)
    hops = [rng.integers(-1, N, s).astype(np.int32) for s in (8, 32, 96)]
    return [("lookup", hops[1], {}),
            ("lookup", hops[0], {"dedup": False}),
            ("lookup_hops", hops, {}),
            ("lookup_aggregate", hops, {}),
            ("lookup_hops", hops, {"include_host": False}),
            ("lookup_aggregate", hops, {"include_host": False})]


def _call(store, name, arg, kw, jax_side):
    if jax_side:
        arg = ([jnp.asarray(h) for h in arg] if isinstance(arg, list)
               else jnp.asarray(arg))
    out = getattr(store, name)(arg, **kw)
    if name == "lookup_aggregate":
        return [_np(x) for x in out[0]] + [_np(out[1])]
    return [_np(x) for x in out] if isinstance(out, list) else [_np(out)]


@pytest.mark.parametrize("capacity", [16, 512])
@pytest.mark.parametrize("with_sketch", [False, True])
def test_cached_lookups_match_reference_and_uncached(stack, capacity,
                                                     with_sketch):
    """Cached == reference cached == port uncached, bit for bit; dispatch
    counters and cache reports equal the reference's."""
    port, ref = _stores(stack)
    plain, _ = _stores(stack)
    sk, jsk = (FrequencySketch(N), JaxSketch(N)) if with_sketch else (
        None, None)
    port.attach_cache(GPUFeatureCache.for_store(port, capacity, sketch=sk))
    ref.attach_cache(JaxCache.for_store(ref, capacity, sketch=jsk))
    for rnd in range(3):
        for name, arg, kw in _calls(rnd % 2):   # rounds repeat: hits
            if with_sketch:
                seeds = np.asarray(arg[0] if isinstance(arg, list) else arg)
                sk.observe(seeds)
                jsk.observe(seeds)
            a = _call(port, name, arg, kw, False)
            b = _call(ref, name, arg, kw, True)
            c = _call(plain, name, arg, kw, False)
            for x, y, z in zip(a, b, c):
                assert x.tobytes() == y.tobytes() == z.tobytes()
    assert port.snapshot_stats() == ref.snapshot_stats()
    assert port.cache.report() == ref.cache.report()
    st = port.snapshot_stats()
    assert st["cache_hits"] > 0 and st["cache_misses"] > 0
    assert (st["cache_evictions"] > 0) == (capacity == 16)


def test_all_cold_hits_skip_the_tier_gather(stack):
    """Every valid id a cold cache hit: no device gather and no host fetch
    for the fused call (counted where the gather is issued)."""
    port, ref = _stores(stack)
    port.attach_cache(GPUFeatureCache.for_store(port, 512))
    ref.attach_cache(JaxCache.for_store(ref, 512))
    cold = np.flatnonzero(port.plan.tier >= TIER_HOST)[:40].astype(np.int32)
    hops = [cold[:8], np.r_[cold[8:], -1].astype(np.int32)]
    for s, j in ((port, False), (ref, True)):
        _call(s, "lookup_hops", hops, {}, j)
        s.reset_stats()
        _call(s, "lookup_hops", hops, {}, j)
        _call(s, "lookup_aggregate", [cold[:8], cold[8:40]], {}, j)
    a, b = port.snapshot_stats(), ref.snapshot_stats()
    assert a == b
    assert a["device_gathers"] == 1 and a["host_fetches"] == 0
    assert a["cache_hits"] == 80 and a["cache_misses"] == 0


def test_swap_invalidates_migrated_ids(stack):
    feats, _ = stack
    port, _ = _stores(stack)
    cache = GPUFeatureCache.for_store(port, 64)
    port.attach_cache(cache)
    cold = np.flatnonzero(port.tier_np >= TIER_HOST)
    hot = np.flatnonzero(port.tier_np < TIER_HOST)
    port.lookup(cold[:8].astype(np.int32))
    assert cache.resident_rows() == 8
    port.swap_assignments(list(zip(hot[:4].tolist(), cold[:4].tolist())))
    assert cache.stats["invalidated"] >= 4 and cache.resident_rows() <= 4
    assert np.array_equal(port.lookup(np.arange(N)).numpy(), feats)


def test_cached_lookups_racing_migration_and_stage_churn(stack, tmp_path):
    """One thread runs fused and fuse-aggregate lookups through a small
    cache, one re-publishes the stage, while the main thread migrates and
    promotes rows: every observed row stays exact."""
    feats, fap = stack
    port, _ = _stores(stack, spill=tmp_path)
    port.attach_cache(GPUFeatureCache.for_store(port, 64))
    topo = port.plan.topology
    rng = np.random.default_rng(7)
    hops = [rng.integers(0, N, 8).astype(np.int32),
            rng.integers(0, N, 32).astype(np.int32)]
    expected = [feats[h] for h in hops]
    expected_agg = _stores(stack)[0].lookup_aggregate(hops)[1].numpy()
    stop = threading.Event()
    errors: list[str] = []
    pf = Prefetcher(port, budget=N)

    def reader():
        while not stop.is_set():
            got = port.lookup_hops(hops)
            feats_a, agg = port.lookup_aggregate(hops)
            if not all(np.array_equal(o.numpy(), e)
                       for o, e in zip(got, expected)):
                errors.append("torn cached lookup during migration")
                return
            if not (np.array_equal(feats_a[0].numpy(), expected[0])
                    and np.array_equal(agg.numpy(), expected_agg)):
                errors.append("torn cached aggregate during migration")
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
    assert port.migrated_rows > 0
    for e, o in zip(expected, port.lookup_hops(hops)):
        assert np.array_equal(o.numpy(), e)


def test_concurrent_admissions_keep_the_tables_consistent():
    """More threads than cores query and admit at once, with a short switch
    interval: the slot and node tables stay inverse, every resident row is
    its node's row, and no hit or miss is lost from the counters."""
    import sys
    rng = np.random.default_rng(9)
    feats = rng.normal(size=(2000, 8)).astype(np.float32)
    cache = GPUFeatureCache(2000, 128, 8, device="cpu",
                            sketch=FrequencySketch(2000))
    workers, rounds, width = 12, 40, 24
    errors: list = []

    def worker(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(rounds):
                ids = r.integers(0, 2000, width)
                cache.sketch.observe(ids)
                values, miss_index, miss_ids = cache.query(ids)
                hit = np.setdiff1d(np.arange(width), miss_index)
                if not np.array_equal(values[hit].numpy(), feats[ids[hit]]):
                    errors.append("a hit returned another node's row")
                cache.replace(miss_ids, torch.from_numpy(feats[miss_ids]))
        except Exception as exc:  # surfaced below
            errors.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    live = np.flatnonzero(cache._node_of >= 0)
    assert np.array_equal(cache._slot_of[cache._node_of[live]], live)
    assert (cache._slot_of >= 0).sum() == live.size
    assert np.array_equal(cache._rows[live].numpy(),
                          feats[cache._node_of[live]])
    st = cache.stats
    assert st["hits"] + st["misses"] == workers * rounds * width
