"""The port's distributed serve path against the JAX package, on the CPU.

``ShardedFeatureStore`` at world 1, 2 and 8 (every shard on ``"cpu"`` in
one process, and on a mesh of distinct CPU device names, which takes the
multi-device code path) under both exchange strategies, with HOST and
DISK tiers, a stage and per-shard spill files: bitwise equal to the JAX
single-host ``TieredFeatureStore``. At world 8 its counters and its stage
layout equal the JAX ``ShardedFeatureStore``'s, run once in a subprocess
with 8 host devices. The ``-0.0`` rule of the ``allgather`` strategy, the
validation errors and exactness while the source store migrates. Then
``ShardedExecutor``: ``max_batch`` rounding, ``supports``, the one-time
``fuse_aggregate`` warning, ``collect_mode``, the per-shard sampler's
structure, outputs against JAX ``sage_layered`` on the same hops, and a
three-executor engine in which every executor is routed to."""
import os
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TieredFeatureStore as JaxStore
from repro.core import TopologySpec as JaxTopo
from repro.core import compute_fap as jax_fap
from repro.core import quiver_placement as jax_placement
from repro.graph import power_law_graph as jax_power_law
from repro.models.gnn_basic import sage_init as jax_sage_init
from repro.models.gnn_basic import sage_layered as jax_sage_layered
from repro_torch.core import (SHARDED_STATS_SCHEMA, Prefetcher, Request,
                              ShardedFeatureStore, TieredFeatureStore,
                              TopologySpec, compute_fap, migration_pairs,
                              quiver_placement)
from repro_torch.core.placement import TIER_DISK, TIER_HOST, TIER_WARM
from repro_torch.graph import CSRGraph, power_law_graph
from repro_torch.graph.sampler import device_sample
from repro_torch.launch import serve as launcher
from repro_torch.launch.mesh import Mesh, make_host_mesh, mesh_world
from repro_torch.models.gnn_basic import sage_from_numpy
from repro_torch.serving import (CostModelRouter, DeviceExecutor,
                                 HostExecutor, LatencyCurve, ServingEngine,
                                 ShardedExecutor)
from repro_torch.serving.executors import _shard_seed
from tests.conftest import run_subprocess

N, D, FAN, HIDDEN = 1200, 16, (4, 3), (16, 8)
HOPS = (16, 64, 256)       # hop lengths: multiples of every world tested
# fp32 model outputs: matmuls and layer norms reduce in another order
TOL = dict(rtol=2e-5, atol=2e-5)


def _topo(world: int) -> dict:
    """An HBM budget of N/4 rows split over ``world`` shards, N/4 HOST
    rows, the rest on DISK."""
    return dict(num_pods=2 if world == 8 else 1,
                devices_per_pod=4 if world == 8 else world,
                rows_per_device=N // 4 // world, rows_host=N // 4,
                hot_replicate_fraction=0.25)


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _hops(seed: int = 3) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    hops = [rng.integers(0, N, size=s).astype(np.int32) for s in HOPS]
    hops[1][:8] = hops[0][:8]          # cross-hop duplicates
    hops[2][:32] = hops[1][:32]
    hops[0][3] = -1                    # padding
    hops[2][100:110] = -1
    return hops


@pytest.fixture(scope="module")
def base():
    gj = jax_power_law(N, 8.0, seed=0)
    fap = np.asarray(jax_fap(gj, FAN))
    feats = np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)
    return feats, fap


def _stores(base, world, feats=None, **kw):
    """(port tiered, JAX tiered, port plan) over the world's placement."""
    feats = base[0] if feats is None else feats
    plan = quiver_placement(base[1], TopologySpec(**_topo(world)))
    jplan = jax_placement(base[1], JaxTopo(**_topo(world)))
    np.testing.assert_array_equal(plan.tier, jplan.tier)
    np.testing.assert_array_equal(plan.slot, jplan.slot)
    port = TieredFeatureStore.build(feats, plan, device="cpu", **kw)
    return port, JaxStore.build(feats, jplan), plan


def _stage(store, seed=11, k=150):
    """A stage of ``k`` cold ids (the prefetcher's global layout)."""
    cold = np.flatnonzero(store.tier_np >= TIER_HOST)
    ids = np.random.default_rng(seed).choice(cold, size=k, replace=False)
    slot = np.full(N, -1, np.int32)
    slot[ids] = np.arange(k, dtype=np.int32)
    return ids, slot


MESHES = {1: [("cpu",)], 2: [("cpu",) * 2, ("cpu:0", "cpu:1")],
          8: [("cpu",) * 8, ("cpu:0", "cpu:1", "cpu:2") * 2
              + ("cpu:0", "cpu:1")]}


@pytest.mark.parametrize("world,layout", [(w, i) for w, ms in MESHES.items()
                                          for i in range(len(ms))])
@pytest.mark.parametrize("strategy", ["alltoall", "allgather"])
def test_lookups_bitwise_equal_jax_single_host(base, world, layout,
                                               strategy, tmp_path):
    feats = base[0]
    port, jstore, _ = _stores(base, world)
    mesh = Mesh(MESHES[world][layout])
    ss = ShardedFeatureStore.from_tiered(port, mesh, "x", strategy,
                                         spill_dir=str(tmp_path))
    hops = _hops()
    want = [_bits(jstore.lookup(jnp.asarray(h))) for h in hops]
    ids, slot = _stage(port)
    for staged in (False, True, False):
        ss.publish_stage(slot if staged else None,
                         torch.from_numpy(feats[ids]) if staged else None)
        assert ss.staged_rows() == (ids.size if staged else 0)
        fused = ss.lookup_hops([torch.from_numpy(h) for h in hops])
        per = [ss.lookup(h) for h in hops]
        for k in range(len(hops)):
            assert fused[k].device.type == ss.device.type
            np.testing.assert_array_equal(_bits(fused[k]), want[k])
            np.testing.assert_array_equal(_bits(per[k]), want[k])
    if world > 1:
        assert sorted(os.listdir(tmp_path)) == [
            f"shard{w:03d}.spill" for w in range(world)]


def test_prefetcher_feeds_the_sharded_stage(base, tmp_path):
    """The port's unmodified ``Prefetcher`` stages through the sharded
    store (its tier mirror, cold reader and device), and staged ids then
    cost no host fetch."""
    port, jstore, _ = _stores(base, 8)
    ss = ShardedFeatureStore.from_tiered(port, make_host_mesh(8,
                                                              device="cpu"),
                                         "x", spill_dir=str(tmp_path))
    pf = Prefetcher(ss, budget=N)
    try:
        assert pf.refresh(scores=np.maximum(base[1], 1e-12)) == int(
            (ss.tier_table_host >= TIER_HOST).sum())
        assert ss.snapshot_stats()["spill_reads"] == int(
            (ss.tier_table_host == TIER_DISK).sum())
        ss.reset_stats()
        hops = _hops(5)
        out = ss.lookup_hops(hops)
        st = ss.reset_stats()
        assert st["host_fetches"] == 0 and st["stage_misses"] == 0, st
        assert st["stage_hits"] > 0
        for h, o in zip(hops, out):
            np.testing.assert_array_equal(
                _bits(o), _bits(jstore.lookup(jnp.asarray(h))))
    finally:
        pf.close()
    assert ss.staged_rows() == 0


# ---------------------------------------------------------------------------
# world 8 against the JAX ShardedFeatureStore (one subprocess)
# ---------------------------------------------------------------------------
_JAX_WORLD8 = """
import sys, tempfile
import numpy as np, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core.feature_store import ShardedFeatureStore, TieredFeatureStore
from repro.core.placement import TopologySpec, quiver_placement
z = np.load(sys.argv[1])
topo = TopologySpec(**{k: z["topo_" + k].item() for k in (
    "num_pods", "devices_per_pod", "rows_per_device", "rows_host",
    "hot_replicate_fraction")})
mesh = make_mesh((8,), ("x",))
hops = [jnp.asarray(z[f"hop{k}"]) for k in range(3)]
feats = z["feats"]
store = TieredFeatureStore.build(feats, quiver_placement(z["fap"], topo))
res = {}

def stats(ss):
    st = ss.reset_stats()
    return np.asarray([st[k] for k in z["schema"]])

for strat in ("alltoall", "allgather"):
    ss = ShardedFeatureStore.from_tiered(store, mesh, "x", strat,
                                         spill_dir=tempfile.mkdtemp())
    for staged in (0, 1):
        if staged:
            ss.publish_stage(z["stage_slot"],
                             jnp.asarray(feats[z["stage_ids"]]))
            local, buf, cap = ss._stage
            res[f"{strat}_local"] = np.asarray(local)
            res[f"{strat}_buf"] = np.asarray(buf)
            res[f"{strat}_cap"] = np.asarray(cap)
        ss.reset_stats()
        out = ss.lookup_hops(hops)
        res[f"{strat}_{staged}_stats"] = stats(ss)
        for k in range(3):
            res[f"{strat}_{staged}_out{k}"] = np.asarray(out[k])
    ss.read_cold_rows(z["disk_ids"])
    res[f"{strat}_read_stats"] = stats(ss)
    negzero = TieredFeatureStore.build(z["negzero"], store.plan)
    ss = ShardedFeatureStore.from_tiered(negzero, mesh, "x", strat)
    for k, o in enumerate(ss.lookup_hops(hops)):
        res[f"negzero_{strat}_out{k}"] = np.asarray(o)
np.savez(sys.argv[2], **res)
print("WORLD8_OK")
"""


@pytest.fixture(scope="module")
def jax_world8(base, tmp_path_factory):
    """Every output, counter and stage layout of the JAX sharded store at
    world 8 on the inputs of this module, from one subprocess."""
    feats, fap = base
    port, _, _ = _stores(base, 8)
    ids, slot = _stage(port)
    d = tmp_path_factory.mktemp("world8")
    inp, out = d / "in.npz", d / "out.npz"
    hops = _hops()
    np.savez(inp, feats=feats, negzero=_negzero(port, feats), fap=fap,
             stage_ids=ids, stage_slot=slot,
             disk_ids=np.flatnonzero(port.tier_np == TIER_DISK)[:16],
             schema=np.asarray(SHARDED_STATS_SCHEMA),
             **{f"hop{k}": h for k, h in enumerate(hops)},
             **{f"topo_{k}": v for k, v in _topo(8).items()})
    r = run_subprocess(_JAX_WORLD8.replace(
        "sys.argv[1]", repr(str(inp))).replace("sys.argv[2]", repr(str(out))),
        devices=8)
    assert "WORLD8_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(out))


def _negzero(store, feats):
    """``feats`` with every WARM row made ``-0.0``."""
    out = feats.copy()
    out[store.tier_np == TIER_WARM] = -0.0
    return out


@pytest.mark.subprocess
@pytest.mark.parametrize("strategy", ["alltoall", "allgather"])
def test_world8_counters_layout_and_bits_equal_jax_sharded(
        base, jax_world8, strategy, tmp_path):
    feats = base[0]
    port, _, _ = _stores(base, 8)
    ss = ShardedFeatureStore.from_tiered(port, make_host_mesh(8,
                                                              device="cpu"),
                                         "x", strategy,
                                         spill_dir=str(tmp_path))
    ids, slot = _stage(port)
    ref = jax_world8
    for staged in (0, 1):
        if staged:
            ss.publish_stage(slot, torch.from_numpy(feats[ids]))
            local, bufs, cap = ss._snapshot_stage()
            np.testing.assert_array_equal(local, ref[f"{strategy}_local"])
            assert cap == int(ref[f"{strategy}_cap"])
            np.testing.assert_array_equal(_bits(bufs[0]),
                                          _bits(ref[f"{strategy}_buf"]))
        ss.reset_stats()
        out = ss.lookup_hops(_hops())
        st = ss.reset_stats()
        assert [st[k] for k in SHARDED_STATS_SCHEMA] == list(
            ref[f"{strategy}_{staged}_stats"]), st
        for k in range(3):
            np.testing.assert_array_equal(
                _bits(out[k]), _bits(ref[f"{strategy}_{staged}_out{k}"]))
    ss.read_cold_rows(np.flatnonzero(port.tier_np == TIER_DISK)[:16])
    st = ss.reset_stats()
    assert [st[k] for k in SHARDED_STATS_SCHEMA] == list(
        ref[f"{strategy}_read_stats"]), st
    assert st["spill_reads"] == 16


@pytest.mark.subprocess
@pytest.mark.parametrize("strategy", ["alltoall", "allgather"])
def test_world8_negative_zero_equals_jax_sharded(base, jax_world8, strategy):
    """WARM rows of -0.0 at world 8: the port's bits are the JAX sharded
    store's under both strategies (``alltoall`` keeps the sign, the
    reference's ``allgather`` returns +0.0 on remote reads)."""
    port, _, _ = _stores(base, 8)
    feats = _negzero(port, base[0])
    ss = ShardedFeatureStore.from_tiered(
        TieredFeatureStore.build(feats, port.plan, device="cpu"),
        make_host_mesh(8, device="cpu"), "x", strategy)
    out = ss.lookup_hops(_hops())
    signs = []
    for k in range(3):
        want = _bits(jax_world8[f"negzero_{strategy}_out{k}"])
        np.testing.assert_array_equal(_bits(out[k]), want)
        signs.append(want == np.int32(-2 ** 31))
    warm = (port.tier_np[np.maximum(np.concatenate(_hops()), 0)]
            == TIER_WARM)
    negative = np.concatenate(signs).all(1)
    if strategy == "alltoall":
        assert negative[warm].all()
    else:
        assert negative[warm].any() and not negative[warm].all()


# ---------------------------------------------------------------------------
# -0.0, validation, migration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", [1, 2, 8])
@pytest.mark.parametrize("strategy", ["alltoall", "allgather"])
def test_negative_zero_rule(base, world, strategy):
    """``alltoall`` and every local read copy bits; under ``allgather`` a
    WARM row read by a shard that does not own it is the owner's row
    plus zeros, so ``-0.0`` comes back ``+0.0`` (as the reference's
    ``psum_scatter`` returns it)."""
    port, _, _ = _stores(base, world)
    feats = _negzero(port, base[0])
    port = TieredFeatureStore.build(feats, port.plan, device="cpu")
    ss = ShardedFeatureStore.from_tiered(
        port, make_host_mesh(world, device="cpu"), "x", strategy)
    ids = np.concatenate(_hops())
    out = _bits(ss.lookup(ids))
    want = _bits(port.lookup(ids))
    warm = (ids >= 0) & (port.tier_np[np.maximum(ids, 0)] == TIER_WARM)
    requester = np.arange(ids.size) // (ids.size // world)
    owner = port.owner_t.numpy()[np.maximum(ids, 0)]
    remote = warm & (owner != requester)
    assert (want[warm] == np.int32(-2 ** 31)).all()   # all -0.0
    if strategy == "allgather":
        want[remote] = 0                               # +0.0
        assert remote.any() == (world > 1)
    np.testing.assert_array_equal(out, want)


def test_validation_errors(base):
    port, _, _ = _stores(base, 8)
    mesh = make_host_mesh(8, device="cpu")
    ss = ShardedFeatureStore.from_tiered(port, mesh, "x")
    for bad in (20, 0):
        with pytest.raises(ValueError, match="hop 1 length = .* multiple "
                                             "of the mesh world size"):
            ss.lookup_hops([np.zeros(32, np.int32), np.zeros(bad, np.int32)])
    with pytest.raises(ValueError, match="multiple of the mesh world size"):
        ss.lookup(np.zeros(13, np.int32))
    with pytest.raises(ValueError, match="at least one hop"):
        ss.lookup_hops([])
    with pytest.raises(ValueError, match="divisible by the mesh world size"):
        ShardedFeatureStore(mesh, "x", np.zeros((4, D), np.float32),
                            np.zeros((42, D), np.float32),
                            np.zeros(N, np.int32), np.zeros(N, np.int32),
                            np.zeros(N, np.int32))
    with pytest.raises(ValueError, match="unknown exchange strategy"):
        ShardedFeatureStore.from_tiered(port, mesh, "x", "ring")
    with pytest.raises(ValueError, match="placement is for 8 devices"):
        ShardedFeatureStore.from_tiered(port, make_host_mesh(
            4, device="cpu"), "x")


def test_mesh_layout():
    mesh = Mesh(("cpu:0", "cpu:1", "cpu:0"))
    assert mesh.world == mesh_world(mesh) == 3 and mesh.shape == {"x": 3}
    assert [(str(d), s) for d, s in mesh.groups()] == [
        ("cpu:0", (0, 2)), ("cpu:1", (1,))]
    assert make_host_mesh(device="cpu").devices == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        make_host_mesh(0, device="cpu")


@pytest.mark.parametrize("strategy", ["alltoall", "allgather"])
def test_exact_while_the_source_store_migrates(base, strategy, tmp_path):
    """A thread swaps placements on the source store while sharded
    lookups run: the sharded tables are build-time copies and the miss
    path reads one snapshot of the source, so every row stays exact."""
    feats = base[0]
    port, _, plan = _stores(base, 8)
    ss = ShardedFeatureStore.from_tiered(
        port, make_host_mesh(8, device="cpu"), "x", strategy,
        spill_dir=str(tmp_path))
    g = power_law_graph(N, 8.0, seed=0)
    topo = TopologySpec(**_topo(8))
    stop, swaps, errors = threading.Event(), [0], []

    def churn():
        rng = np.random.default_rng(9)
        try:
            while not stop.is_set():
                p0 = rng.dirichlet(np.ones(N))
                f2 = compute_fap(g, FAN, seed_prob=p0, device="cpu")
                target = quiver_placement(f2, topo)
                pairs = migration_pairs(port.plan.tier, target.tier, f2,
                                        budget=32)
                swaps[0] += port.swap_assignments(pairs) > 0
        except Exception as exc:   # surfaced below
            errors.append(exc)

    t = threading.Thread(target=churn)
    t.start()
    try:
        rng = np.random.default_rng(5)
        deadline = time.monotonic() + 20
        for i in range(40):
            hops = [rng.integers(-1, N, size=s).astype(np.int32)
                    for s in (32, 128)]
            hops[1][:16] = hops[0][:16]
            for h, o in zip(hops, ss.lookup_hops(hops)):
                expect = np.where((h >= 0)[:, None],
                                  feats[np.maximum(h, 0)], 0.0)
                np.testing.assert_array_equal(_bits(o), _bits(expect))
            if i >= 8 and (swaps[0] >= 3 or time.monotonic() > deadline):
                break
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    assert swaps[0] > 0 and port.migrated_rows > 0


# ---------------------------------------------------------------------------
# ShardedExecutor
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def serve_stack(base):
    feats, fap = base
    g = power_law_graph(N, 8.0, seed=0)
    port, _, plan = _stores(base, 4)
    ss = ShardedFeatureStore.from_tiered(port, make_host_mesh(
        4, device="cpu"), "x")
    tree = jax_sage_init(jax.random.key(0), [D, *HIDDEN])
    tree_np = jax.tree.map(np.asarray, tree)
    infer = launcher.make_infer_fn(sage_from_numpy(tree_np, device="cpu"),
                                   FAN)
    return g, port, ss, plan, tree, infer


def _executor(serve_stack, **kw):
    g, _, ss, _, _, infer = serve_stack
    return ShardedExecutor(ss.mesh, "x", g.device_arrays("cpu"), ss, FAN,
                           infer, **kw)


def test_max_batch_rounds_up_to_the_world(serve_stack):
    for asked, got in ((16, 16), (18, 20), (1, 4)):
        ex = _executor(serve_stack, max_batch=asked)
        assert ex.max_batch == got and ex.world == 4
        ex.close()


def test_supports_and_stores(serve_stack):
    _, port, ss, plan, _, _ = serve_stack
    ex = _executor(serve_stack, tier_table=plan.tier)
    hbm = np.flatnonzero(plan.tier <= 1)[:5]
    cold = np.flatnonzero(plan.tier >= TIER_HOST)[:1]
    assert ex.supports(np.append(hbm, -1))
    assert not ex.supports(np.append(hbm, cold))
    free = _executor(serve_stack)
    assert free.supports(cold)
    assert ex.stores() == [ss]
    for e in (ex, free):
        e.close()


def test_fuse_aggregate_downgrade_warns_once_and_collect_mode(serve_stack):
    g, port, ss, _, _, infer = serve_stack
    ShardedExecutor._warned_fuse_aggregate = False
    with pytest.warns(RuntimeWarning, match="fuse_aggregate=True has no"):
        ex = _executor(serve_stack, max_batch=8, fuse_aggregate=True)
    assert ex.collect_mode(ss) == "fused"
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ex2 = _executor(serve_stack, max_batch=8, fuse_aggregate=True)
    assert not [w for w in rec if "fuse_aggregate" in str(w.message)]
    per_hop = _executor(serve_stack, max_batch=8, fused=False)
    assert per_hop.collect_mode(ss) == "per_hop"
    host = HostExecutor(g, port, FAN, infer, fuse_aggregate=True)
    assert host.collect_mode(port) == "fuse_aggregate"
    assert host.collect_mode(ss) == "fused"
    # a downgraded executor serves whole rows: same output as fused
    seeds = np.arange(10, 18)
    torch.testing.assert_close(ex.run(seeds), ex2.run(seeds))
    assert per_hop.run(seeds).shape == (8, HIDDEN[-1])
    for e in (ex, ex2, per_hop, host):
        e.close()


def _degree_zero_graph():
    """12 nodes; nodes 3, 7 and 11 (the CSR's tail) have no neighbor."""
    rng = np.random.default_rng(2)
    deg = rng.integers(1, 9, size=12)
    deg[[3, 7, 11]] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, 12, size=int(deg.sum())).astype(np.int32)
    return CSRGraph(indptr, indices, 12)


@pytest.mark.parametrize("layout", [("cpu",) * 4, ("cpu:0", "cpu:1") * 2])
def test_sharded_sampling_structure(layout):
    """Each shard samples its own slice from its own generator: its hops
    are valid neighbors of its own frontier, ``-1`` propagates, degree-0
    nodes (the CSR's tail included) give ``-1`` rows, and shard ``w``'s
    hops equal ``device_sample`` on its slice with its folded seed."""
    g = _degree_zero_graph()
    mesh = Mesh(layout)
    feats = np.zeros((12, 4), np.float32)
    topo = TopologySpec(num_pods=1, devices_per_pod=4, rows_per_device=3,
                        rows_host=4, hot_replicate_fraction=0.25)
    store = TieredFeatureStore.build(
        feats, quiver_placement(np.linspace(1, 0.1, 12), topo), device="cpu")
    ss = ShardedFeatureStore.from_tiered(store, mesh, "x")
    ex = ShardedExecutor(mesh, "x", g.device_arrays("cpu"), ss, (5, 3),
                         lambda f, h: f[0], max_batch=12)
    seeds = np.array([0, 3, -1, 11, 5, 7, 1, 2, 9, -1, 11, 6], np.int32)
    hops = ex.sample(seeds, child=1234)
    m = 3
    for k, fan in enumerate((5, 3)):
        assert hops[k + 1].shape == (12 * np.prod((5, 3)[:k + 1]),)
        parent = hops[k].numpy().reshape(4, -1)
        child = hops[k + 1].numpy().reshape(4, -1, fan)
        for w in range(4):
            for v, row in zip(parent[w], child[w]):
                if v < 0 or g.indptr[v + 1] == g.indptr[v]:
                    assert (row == -1).all()
                    continue
                nbrs = set(g.indices[g.indptr[v]:g.indptr[v + 1]].tolist())
                assert set(row[row >= 0].tolist()) <= nbrs
                deg = g.indptr[v + 1] - g.indptr[v]
                assert (row >= 0).sum() == min(deg, fan)
    indptr, indices = g.device_arrays("cpu")
    for w in range(4):
        gen = torch.Generator().manual_seed(_shard_seed(1234, w))
        own = device_sample(gen, indptr, indices,
                            torch.from_numpy(seeds[w * m:(w + 1) * m]),
                            (5, 3))
        for k in range(3):
            assert torch.equal(hops[k].view(4, -1)[w], own[k])
    ex.close()


def test_outputs_match_jax_sage_layered(base, serve_stack):
    """The sharded executor's output equals JAX ``sage_layered`` on the
    hops it sampled and the features of those ids, within the serve
    path's fp32 tolerance; a batch above ``max_batch`` is chunked."""
    feats = base[0]
    _, _, _, _, tree, _ = serve_stack
    ex = _executor(serve_stack, max_batch=16, rng_seed=7)
    seen = []
    sample = ex.sample

    def recording(seeds_p, child):
        hops = sample(seeds_p, child)
        seen.append([h.numpy().copy() for h in hops])
        return hops

    ex.sample = recording
    seeds = np.random.default_rng(4).integers(0, N, size=37)
    out = ex.run(seeds).numpy()
    ex.close()
    assert out.shape == (37, HIDDEN[-1]) and len(seen) == 3
    ref = []
    for hops in seen:
        hop_feats = [jnp.asarray(np.where((h >= 0)[:, None],
                                          feats[np.maximum(h, 0)], 0.0))
                     for h in hops]
        masks = [jnp.asarray((h >= 0).astype(np.float32)[:, None])
                 for h in hops]
        ref.append(np.asarray(jax_sage_layered(tree, hop_feats, FAN,
                                               hop_masks=masks)))
    np.testing.assert_allclose(out, np.concatenate(ref)[:37], **TOL)


def test_three_executor_engine_on_cpu(base, serve_stack):
    """Host, device and sharded executors under one engine, each with a
    sweet spot on the PSGS axis: every executor is routed to, and the
    sharded one answers a batch above ``max_batch`` with finite rows."""
    g, port, ss, _, _, infer = serve_stack
    from repro_torch.core import compute_psgs
    psgs = compute_psgs(g, FAN, device="cpu")
    ex = {
        "host": HostExecutor(g, port, FAN, infer, psgs_table=psgs),
        "device": DeviceExecutor(g.device_arrays("cpu"), port, FAN, infer,
                                 max_batch=16, psgs_table=psgs),
        "sharded": _executor(serve_stack, max_batch=16, psgs_table=psgs),
    }
    order = np.argsort(psgs)
    s_lo, s_mid, s_hi = int(order[0]), int(order[N // 2]), int(order[-1])
    p_lo, p_mid, p_hi = (float(psgs[s]) for s in (s_lo, s_mid, s_hi))
    assert p_lo < p_mid < p_hi
    qmax = p_hi + 1.0

    def vcurve(center):
        xs = np.array([0.0, center, qmax])
        ys = np.abs(xs - center) + 1e-6
        return LatencyCurve(psgs=xs, avg=ys, mx=ys)

    router = CostModelRouter(psgs, "latency_preferred")
    router.register("host", vcurve(p_lo), kind="host", executor=ex["host"])
    router.register("device", vcurve(p_mid), executor=ex["device"])
    router.register("sharded", vcurve(p_hi), executor=ex["sharded"])
    engine = ServingEngine(ex, router, max_inflight=8)
    try:
        reqs = [Request(i, np.array([s]), time.perf_counter())
                for i, s in enumerate([s_lo, s_mid, s_hi] * 4)]
        m = engine.run([[r] for r in reqs])
        assert m.requests == 12
        assert all(m.routed.get(k, 0) == 4
                   for k in ("host", "device", "sharded")), m.routed
        out = ex["sharded"].run(np.arange(24))
        assert out.shape == (24, HIDDEN[-1]) and torch.isfinite(out).all()
        summary = m.summary()["store"]
        assert set(summary["ShardedFeatureStore"]) == set(
            SHARDED_STATS_SCHEMA) | {"collect_mode"}
        assert summary["ShardedFeatureStore"]["exchanges"] > 0
    finally:
        engine.close()
