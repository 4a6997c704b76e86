"""Port online migration against the JAX package's: ``migration_pairs`` is
bitwise equal to the reference's; ``swap_assignments`` leaves the same tier
tables, plan, tier contents and counters, with the host mirrors published
beside the device tables; lookups under swaps equal the reference's bit
for bit; ``promote_misses`` moves the same rows; fused and fuse-aggregate
lookups racing migration stay exact."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TieredFeatureStore as JaxStore
from repro.core import TopologySpec as JaxTopo
from repro.core import compute_fap as jax_fap
from repro.core import migration_pairs as jax_migration_pairs
from repro.core import quiver_placement as jax_placement
from repro.graph import power_law_graph as jax_power_law
from repro_torch.core import (TieredFeatureStore, TopologySpec,
                              migration_pairs, quiver_placement)
from repro_torch.core.placement import TIER_DISK, TIER_HOST, TIER_HOT

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


def _drifted(fap, seed):
    rng = np.random.default_rng(seed)
    drifted = fap.copy()
    drifted[rng.choice(N, 120, replace=False)] += fap.max() * 3
    return drifted


def _same_store(port, ref):
    assert np.array_equal(port.tier_np, np.asarray(ref.tier_t))
    assert np.array_equal(port.slot_np, np.asarray(ref.slot_t))
    assert np.array_equal(port.tier_t.numpy(), port.tier_np)
    assert np.array_equal(port.slot_t.numpy(), port.slot_np)
    assert np.array_equal(port.owner_t.numpy(), np.asarray(ref.owner_t))
    for name in ("tier", "slot", "pod_owner", "device_owner"):
        assert np.array_equal(getattr(port.plan, name),
                              getattr(ref.plan, name))
    assert port.hot.numpy().tobytes() == np.asarray(ref.hot).tobytes()
    assert port.warm.numpy().tobytes() == np.asarray(ref.warm).tobytes()
    assert port.host.tobytes() == np.asarray(ref.host).tobytes()
    assert np.asarray(port.disk).tobytes() == np.asarray(ref.disk).tobytes()
    assert port.disk.overlay_rows == ref.disk.overlay_rows
    assert port.migrated_rows == ref.migrated_rows
    assert port.promoted_rows == ref.promoted_rows


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("budget", [1, 7, 64, 1000])
def test_migration_pairs_bitwise(stack, seed, budget):
    _, fap = stack
    plan = quiver_placement(fap, TopologySpec(**TOPO))
    drifted = _drifted(fap, seed)
    target = quiver_placement(drifted, TopologySpec(**TOPO))
    a = migration_pairs(plan.tier, target.tier, drifted, budget=budget)
    b = jax_migration_pairs(plan.tier, target.tier, drifted, budget=budget)
    assert a == b and len(a) <= budget
    flat = [n for ab in a for n in ab]
    assert len(set(flat)) == len(flat)


def test_swaps_match_reference_step_by_step(stack, tmp_path):
    """Converge on a drifted target in bounded steps on both stores: the
    same pairs, the same published state after every step, the same
    lookups (DISK demotions land in the spill overlay and compact)."""
    feats, fap = stack
    port, ref = _stores(stack, spill=tmp_path)
    drifted = _drifted(fap, 5)
    target = quiver_placement(drifted, TopologySpec(**TOPO))
    rng = np.random.default_rng(11)
    for _ in range(6):
        a = migration_pairs(port.plan.tier, target.tier, drifted, budget=40)
        b = jax_migration_pairs(ref.plan.tier, target.tier, drifted,
                                budget=40)
        assert a == b
        if not a:
            break
        assert port.swap_assignments(a) == ref.swap_assignments(b)
        _same_store(port, ref)
        hops = [rng.integers(-1, N, s).astype(np.int32) for s in (8, 32)]
        x = port.lookup_hops(hops)
        y = ref.lookup_hops([jnp.asarray(h) for h in hops])
        for u, v in zip(x, y):
            assert u.numpy().tobytes() == np.asarray(v).tobytes()
        fa, agg = port.lookup_aggregate(hops)
        fb, aggb = ref.lookup_aggregate([jnp.asarray(h) for h in hops])
        assert agg.numpy().tobytes() == np.asarray(aggb).tobytes()
    assert port.migrated_rows > 0
    assert port.snapshot_stats() == ref.snapshot_stats()
    assert np.array_equal(port.lookup(np.arange(N)).numpy(), feats)


def test_swap_publishes_new_tensors(stack):
    """Copy-on-write: a snapshot taken before a swap keeps its tables."""
    port, _ = _stores(stack)
    snap = port._snapshot()
    copies = [t.clone() for t in snap[:2] + snap[4:6]]
    mirrors = [snap[6].copy(), snap[7].copy()]
    hot = np.flatnonzero(port.tier_np == TIER_HOT)
    cold = np.flatnonzero(port.tier_np >= TIER_HOST)
    port.swap_assignments(list(zip(hot[:5].tolist(), cold[:5].tolist())))
    for t, c in zip(snap[:2] + snap[4:6], copies):
        assert torch.equal(t, c)
    assert np.array_equal(snap[6], mirrors[0])
    assert np.array_equal(snap[7], mirrors[1])
    assert port.hot is not snap[0] and port.tier_np is not snap[6]


def test_swap_rejects_overlapping_pairs(stack):
    port, _ = _stores(stack)
    assert port.swap_assignments([]) == 0
    with pytest.raises(ValueError, match="disjoint"):
        port.swap_assignments([(1, 2), (2, 3)])
    assert port.migrated_rows == 0


def test_promote_misses_matches_reference(stack, tmp_path):
    feats, _ = stack
    port, ref = _stores(stack, spill=tmp_path)
    assert port.promote_misses(budget=8) == 0
    disk = np.flatnonzero(port.tier_np == TIER_DISK)
    rng = np.random.default_rng(2)
    for _ in range(3):
        ids = rng.choice(disk, 24).astype(np.int32)
        port.lookup(ids)
        ref.lookup(jnp.asarray(ids))
    assert np.array_equal(port._disk_miss_counts, ref._disk_miss_counts)
    a = port.promote_misses(budget=6, min_misses=2)
    b = ref.promote_misses(budget=6, min_misses=2)
    assert a == b > 0
    _same_store(port, ref)
    assert np.array_equal(port._disk_miss_counts, ref._disk_miss_counts)
    assert port.promoted_rows == a
    assert np.array_equal(port.lookup(np.arange(N)).numpy(), feats)


@pytest.mark.parametrize("path", ["lookup_hops", "lookup_aggregate"])
def test_lookups_exact_under_concurrent_migration(stack, path):
    """A reader doing fused (or fuse-aggregate) lookups while the main
    thread migrates rows only ever sees its pristine bits: one snapshot
    per sample."""
    feats, fap = stack
    port, _ = _stores(stack)
    pristine, _ = _stores(stack)
    rng = np.random.default_rng(7)
    hops = [rng.integers(0, N, 16).astype(np.int32),
            rng.integers(0, N, 48).astype(np.int32)]

    def run(store):
        out = getattr(store, path)(hops)
        if path == "lookup_aggregate":
            out = list(out[0]) + [out[1]]
        return [o.numpy().tobytes() for o in out]

    expected = run(pristine)
    stop = threading.Event()
    errors: list[str] = []

    def reader():
        while not stop.is_set():
            if run(port) != expected:
                errors.append("torn lookup during migration")
                return

    t = threading.Thread(target=reader)
    t.start()
    try:
        drifted = fap.copy()
        drifted[np.argsort(fap)[:80]] += fap.max() * 3
        tgt = quiver_placement(drifted, port.plan.topology)
        for _ in range(10):
            pairs = migration_pairs(port.plan.tier, tgt.tier, drifted,
                                    budget=20)
            if not pairs:
                break
            port.swap_assignments(pairs)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert not errors and port.migrated_rows > 0
    assert run(port) == expected
