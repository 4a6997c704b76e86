"""Port tiered store against the JAX store built from the same features and
plan: ``lookup``/``lookup_hops``/``lookup_aggregate`` rows bitwise equal at
every tier (``-1`` → zeros, all-cold batches, ``include_host=False``),
``lookup_aggregate`` bitwise equal to the Pallas path, the port's
fused == unfused guarantee, equal dispatch counters, and the spill tier."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DiskSpillTier as JaxSpill
from repro.core import TieredFeatureStore as JaxStore
from repro.core import TopologySpec as JaxTopo
from repro.core import compute_fap as jax_fap
from repro.core import quiver_placement as jax_placement
from repro.graph import power_law_graph as jax_power_law
from repro_torch.core import (STATS_SCHEMA, DiskSpillTier, TieredFeatureStore,
                              TopologySpec, quiver_placement)
from repro_torch.core.placement import TIER_HOST
from repro_torch.kernels.gather_aggregate import fan_sum

N, D, FAN = 900, 12, (4, 3)
TOPO = dict(num_pods=1, devices_per_pod=1, rows_per_device=220,
            rows_host=330, hot_replicate_fraction=0.3)


@pytest.fixture(scope="module")
def stack():
    gj = jax_power_law(N, 6.0, seed=0)
    feats = np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)
    fap = jax_fap(gj, FAN)
    return feats, fap


def _stores(stack, spill_dir=None):
    """The same features and the same FAP array → equal plans (placement is
    bitwise) → a port store and a JAX store with identical layouts."""
    feats, fap = stack
    spill = (None, None) if spill_dir is None else (
        str(spill_dir / "t.spill"), str(spill_dir / "j.spill"))
    port = TieredFeatureStore.build(
        feats, quiver_placement(fap, TopologySpec(**TOPO)),
        spill_path=spill[0], device="cpu")
    ref = JaxStore.build(feats, jax_placement(fap, JaxTopo(**TOPO)),
                         spill_path=spill[1])
    return port, ref


def _hops(batch, seed=0, pool=None):
    rng = np.random.default_rng(seed)
    draw = ((lambda s: rng.integers(-1, N, size=s)) if pool is None
            else (lambda s: rng.choice(pool, size=s)))
    return [draw(batch * k).astype(np.int32)
            for k in (1, FAN[0], FAN[0] * FAN[1])]


def _eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("include_host", [True, False])
@pytest.mark.parametrize("dedup", [True, False])
def test_lookup_bitwise(stack, include_host, dedup):
    port, ref = _stores(stack)
    ids = np.r_[np.arange(N), [-1, -1, 5, 5]].astype(np.int32)
    a = port.lookup(ids, include_host=include_host, dedup=dedup)
    b = ref.lookup(jnp.asarray(ids), include_host=include_host, dedup=dedup)
    assert _eq(a, b)
    assert not a[-4:-2].any()
    if include_host:  # every tier returns the node's own feature row
        feats, _ = stack
        assert np.array_equal(a[:N].numpy(), feats)


@pytest.mark.parametrize("sizes", [(16,), (16, 64), (16, 64, 192), (1, 1)])
@pytest.mark.parametrize("include_host", [True, False])
def test_lookup_hops_bitwise(stack, sizes, include_host):
    port, ref = _stores(stack)
    rng = np.random.default_rng(sum(sizes))
    hops = [rng.integers(-1, N, size=s).astype(np.int32) for s in sizes]
    a = port.lookup_hops(hops, include_host=include_host)
    b = ref.lookup_hops([jnp.asarray(h) for h in hops],
                        include_host=include_host)
    assert len(a) == len(b) == len(hops)
    for x, y in zip(a, b):
        assert _eq(x, y)
    per_hop = [port.lookup(h, include_host=include_host) for h in hops]
    for x, y in zip(per_hop, a):
        assert torch.equal(x, y)


def test_lookup_hops_rejects_empty(stack):
    port, _ = _stores(stack)
    with pytest.raises(ValueError):
        port.lookup_hops([np.zeros(0, np.int32)])


@pytest.mark.parametrize("cold_only", [False, True])
@pytest.mark.parametrize("include_host", [True, False])
def test_lookup_aggregate_bitwise(stack, cold_only, include_host):
    """Bitwise equal to the JAX store on its Pallas path (interpret mode),
    feats and aggregate, including an all-cold batch."""
    port, ref = _stores(stack)
    pool = (np.flatnonzero(port.plan.tier >= TIER_HOST) if cold_only
            else None)
    hops = _hops(16, seed=1, pool=pool)
    feats_a, agg_a = port.lookup_aggregate(hops, include_host=include_host)
    feats_b, agg_b = ref.lookup_aggregate([jnp.asarray(h) for h in hops],
                                          include_host=include_host,
                                          use_pallas=True)
    assert len(feats_a) == len(feats_b) == 2
    for x, y in zip(feats_a, feats_b):
        assert _eq(x, y)
    assert agg_a.shape == (16 * FAN[0], D) and _eq(agg_a, agg_b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_fused_equals_unfused(stack, seed):
    """The fused aggregate equals lookup_hops followed by the model's
    in-order fp32 fan sum, bit for bit; outer rows equal lookup_hops."""
    port, _ = _stores(stack)
    hops = _hops(8, seed=seed)
    rows = port.lookup_hops(hops)
    p, fan = hops[1].shape[0], FAN[1]
    m = torch.from_numpy((hops[2] >= 0).astype(np.float32)).reshape(p, fan, 1)
    expected = fan_sum(rows[2].reshape(p, fan, -1) * m)
    feats, agg = port.lookup_aggregate(hops)
    assert torch.equal(agg, expected)
    for x, y in zip(feats, rows[:2]):
        assert torch.equal(x, y)


def test_lookup_aggregate_rejects_bad_shapes(stack):
    port, _ = _stores(stack)
    with pytest.raises(ValueError):
        port.lookup_aggregate([np.arange(4, dtype=np.int32)])
    with pytest.raises(ValueError):
        port.lookup_aggregate([np.arange(4, dtype=np.int32),
                               np.arange(7, dtype=np.int32)])


def test_dispatch_counters_match(stack, tmp_path):
    """The same call sequence gives the same counters in both stores (the
    plan is shared, so tier membership is identical), with a spill file
    behind the DISK tier."""
    port, ref = _stores(stack, spill_dir=tmp_path)
    assert port.disk.path and ref.disk.path
    calls = [("lookup", _hops(8, seed=3)[1], {}),
             ("lookup", _hops(8, seed=4)[0], {"include_host": False}),
             ("lookup_hops", _hops(8, seed=5), {}),
             ("lookup_hops", _hops(8, seed=6), {"include_host": False}),
             ("lookup_aggregate", _hops(8, seed=7), {}),
             ("lookup_aggregate",
              _hops(4, seed=8, pool=np.flatnonzero(port.plan.tier < 2)), {})]
    for name, arg, kw in calls:
        getattr(port, name)(arg, **kw)
        jarg = ([jnp.asarray(h) for h in arg] if isinstance(arg, list)
                else jnp.asarray(arg))
        getattr(ref, name)(jarg, **kw)
    a, b = port.snapshot_stats(), ref.snapshot_stats()
    assert tuple(a) == STATS_SCHEMA
    assert a == b
    assert a["fused_aggregates"] == 2 and a["host_fetches"] >= 2
    assert port.reset_stats() == a and not any(port.stats.values())


def test_disk_spill_tier_matches(tmp_path):
    rows = np.random.default_rng(0).normal(size=(40, 6)).astype(np.float32)
    a = DiskSpillTier.build(rows, str(tmp_path / "a.spill"))
    b = JaxSpill.build(rows, str(tmp_path / "b.spill"))
    idx = np.array([3, 0, 39, 3])
    assert np.array_equal(a[idx], b[idx]) and np.array_equal(a[7], b[7])
    new = np.ones((2, 6), np.float32)
    for t in (a, b):
        t[[3, 10]] = new
    dup_a, dup_b = a.copy(), b.copy()
    assert dup_a.overlay_rows == dup_b.overlay_rows == 2
    assert np.array_equal(dup_a[idx], dup_b[idx])
    assert a.resident_nbytes == b.resident_nbytes
    ca, cb = a.compact(), b.compact()
    assert ca.overlay_rows == 0 and ca.path.endswith(".g1")
    assert np.array_equal(np.asarray(ca), np.asarray(cb))
