"""The paper's placement baselines and Monte Carlo oracles in the port
against the JAX package, on graphs built from a numpy seed and handed to
both packages' ``CSRGraph``: ``monte_carlo_psgs``, ``batch_psgs`` and
``monte_carlo_fap`` bit for bit; ``hash``/``degree``/``freq``/``p3``
plans field by field, bitwise with dtypes, over several topologies; the
metrics against their oracles; and the tiered store built on each non-P3
baseline plan read back bitwise against the JAX store (and, for ``hash``
with host rows, against the features: there the reference's store
collides)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import TieredFeatureStore as JaxStore
from repro.core import TopologySpec as JaxTopo
from repro.core import batch_psgs as jax_batch_psgs
from repro.core import degree_placement as jax_degree
from repro.core import freq_placement as jax_freq
from repro.core import hash_placement as jax_hash
from repro.core import monte_carlo_fap as jax_mc_fap
from repro.core import monte_carlo_psgs as jax_mc_psgs
from repro.core import p3_placement as jax_p3
from repro.graph import CSRGraph as JaxCSR
from repro_torch.core import (TieredFeatureStore, TopologySpec, batch_psgs,
                              compute_fap, compute_psgs, degree_placement,
                              freq_placement, hash_placement, monte_carlo_fap,
                              monte_carlo_psgs, p3_placement)
from repro_torch.core.placement import TIER_HOST
from repro_torch.graph import power_law_graph

CPU = "cpu"
PLAN_FIELDS = ("tier", "pod_owner", "device_owner", "slot")
PLAN_SCALARS = ("n_hot", "warm_rows_per_device", "host_rows_per_pod",
                "dim_sharded", "name")
# (pods, devices, rows_per_device, rows_host): rows_host=0, 1×1, 1×4, 2×4
TOPOLOGIES = [(1, 4, 40, 0), (1, 1, 60, 100), (1, 4, 30, 80),
              (2, 4, 20, 60)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its shapes are tiny, and the
    suite's parallel workers would otherwise oversubscribe the cores (each
    of torch's small ops spinning up a thread team)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def graphs():
    """One seeded numpy graph in both packages' ``CSRGraph`` (low average
    degree: real degree variance, as the reference's metric tests use)."""
    g = power_law_graph(300, 2.5, seed=7)
    return g, JaxCSR(indptr=g.indptr.copy(), indices=g.indices.copy(),
                     num_nodes=g.num_nodes)


def _spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    return np.corrcoef(ra, rb)[0, 1]


def _assert_plans_equal(a, b):
    for f in PLAN_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in PLAN_SCALARS:
        assert getattr(a, f) == getattr(b, f), f
        assert type(getattr(a, f)) is type(getattr(b, f)), f
    assert dataclasses.asdict(a.topology) == dataclasses.asdict(b.topology)
    assert a.tier_counts() == b.tier_counts()


@pytest.mark.parametrize("node,fanouts,seed", [
    (0, (3, 2), 0), (11, (3, 2), 11), (42, (5,), 3), (137, (2, 2, 2), 5),
    (255, (4, 3), 255)])
def test_monte_carlo_psgs_bitwise(graphs, node, fanouts, seed):
    g, gj = graphs
    a = monte_carlo_psgs(g, node, fanouts, trials=300, seed=seed)
    b = jax_mc_psgs(gj, node, fanouts, trials=300, seed=seed)
    assert type(a) is type(b) and a == b


def test_batch_psgs_bitwise(graphs):
    g, _ = graphs
    q = compute_psgs(g, (4, 3), device=CPU)
    for seeds in (np.array([3, 5, 8, -1]), np.array([-1, -1]),
                  np.arange(-1, 299, 7)):
        a, b = batch_psgs(q, seeds), jax_batch_psgs(q, seeds)
        assert type(a) is float and a == b
    assert batch_psgs(q, np.array([3, 5, 8, -1])) == pytest.approx(
        float(q[[3, 5, 8]].sum()))


@pytest.mark.parametrize("skewed", [False, True])
def test_monte_carlo_fap_bitwise(graphs, skewed):
    g, gj = graphs
    prob = (np.random.default_rng(2).random(300) ** 3 if skewed else None)
    a = monte_carlo_fap(g, (4, 3), requests=1500, seed=1, seed_prob=prob)
    b = jax_mc_fap(gj, (4, 3), requests=1500, seed=1, seed_prob=prob)
    assert a.dtype == b.dtype == np.float64 and np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["hash", "degree", "freq", "p3"])
@pytest.mark.parametrize("pods,devs,rows,host", TOPOLOGIES)
def test_baseline_placements_bitwise(graphs, kind, pods, devs, rows, host):
    g, gj = graphs
    kw = dict(num_pods=pods, devices_per_pod=devs, rows_per_device=rows,
              rows_host=host, hot_replicate_fraction=0.3)
    topo, jtopo = TopologySpec(**kw), JaxTopo(**kw)
    n = g.num_nodes
    counts = monte_carlo_fap(g, (4, 3), requests=400, seed=9)
    port, ref = {
        "hash": lambda: (hash_placement(n, topo), jax_hash(n, jtopo)),
        "degree": lambda: (degree_placement(g.out_degree, topo),
                           jax_degree(gj.out_degree, jtopo)),
        "freq": lambda: (freq_placement(counts, topo),
                         jax_freq(counts, jtopo)),
        "p3": lambda: (p3_placement(n, topo), jax_p3(n, jtopo)),
    }[kind]()
    _assert_plans_equal(port, ref)
    port.validate()


def test_baselines_interface():
    """Mirror of the reference's ``test_baselines_interface``."""
    n = 500
    topo = TopologySpec(num_pods=2, devices_per_pod=4, rows_per_device=32,
                        rows_host=64)
    deg = np.random.default_rng(0).integers(0, 50, n)
    for plan in (hash_placement(n, topo), degree_placement(deg, topo),
                 freq_placement(deg.astype(float), topo),
                 p3_placement(n, topo)):
        assert plan.tier.shape == (n,)
        assert plan.name in ("hash", "degree", "freq", "p3")
    assert p3_placement(n, topo).dim_sharded


def test_hash_placement_is_workload_agnostic():
    """Mirror of the reference's ``test_hash_placement_is_workload_agnostic``."""
    n = 300
    topo = TopologySpec(num_pods=1, devices_per_pod=4, rows_per_device=1000,
                        rows_host=0)
    p1 = hash_placement(n, topo)
    p2 = hash_placement(n, topo)
    assert np.array_equal(p1.device_owner, p2.device_owner)


def test_psgs_branching_matches_monte_carlo(graphs):
    """The reference's oracle check (``tests/test_metrics.py``) on the
    port: branching PSGS within rel 0.08 of the sampler's mean."""
    g, _ = graphs
    fan = (3, 2)
    q = compute_psgs(g, fan, mode="branching", device=CPU)
    for node in [0, 11, 42, 137, 255]:
        mc = monte_carlo_psgs(g, node, fan, trials=600, seed=node)
        assert q[node] == pytest.approx(mc, rel=0.08), node


def test_fap_identifies_hot_set(graphs):
    """The reference's oracle check on the port: the top tenth by FAP
    overlaps the sampler's most-accessed tenth by more than 0.6, and the
    rank correlation is above 0.4."""
    g, _ = graphs
    fan = (4, 3)
    p = compute_fap(g, fan, device=CPU)
    mc = monte_carlo_fap(g, fan, requests=8000, seed=1)
    k = g.num_nodes // 10
    top_p = set(np.argsort(-p)[:k].tolist())
    top_mc = set(np.argsort(-mc)[:k].tolist())
    overlap = len(top_p & top_mc) / k
    assert overlap > 0.6, overlap
    assert _spearman(p, mc) > 0.4


N_STORE, D_STORE = 600, 8
# placement_compare's topology at a small size (2 servers of 4 cards),
# and one card with DISK rows left over
STORE_TOPOS = {
    "2x4": dict(num_pods=2, devices_per_pod=4, rows_per_device=N_STORE // 16,
                rows_host=N_STORE // 3, hot_replicate_fraction=0.3),
    "1x1-disk": dict(num_pods=1, devices_per_pod=1, rows_per_device=120,
                     rows_host=150, hot_replicate_fraction=0.25),
}


def _store_pair(kind, topo_kw):
    g = power_law_graph(N_STORE, 6.0, seed=3)
    gj = JaxCSR(indptr=g.indptr.copy(), indices=g.indices.copy(),
                num_nodes=g.num_nodes)
    feats = np.random.default_rng(4).normal(
        size=(N_STORE, D_STORE)).astype(np.float32)
    topo, jtopo = TopologySpec(**topo_kw), JaxTopo(**topo_kw)
    counts = monte_carlo_fap(g, (4, 3), requests=300, seed=9)
    plan, jplan = {
        "hash": (hash_placement(N_STORE, topo), jax_hash(N_STORE, jtopo)),
        "degree": (degree_placement(g.out_degree, topo),
                   jax_degree(gj.out_degree, jtopo)),
        "freq": (freq_placement(counts, topo), jax_freq(counts, jtopo)),
    }[kind]
    return (TieredFeatureStore.build(feats, plan, device=CPU),
            JaxStore.build(feats, jplan), feats)


def _ids():
    rng = np.random.default_rng(5)
    return np.concatenate([rng.integers(-1, N_STORE, 200),
                           np.arange(N_STORE)]).astype(np.int32)


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("topo", sorted(STORE_TOPOS))
@pytest.mark.parametrize("kind", ["hash", "degree", "freq"])
def test_baseline_store_lookup_bitwise(kind, topo):
    port, ref, feats = _store_pair(kind, STORE_TOPOS[topo])
    ids = _ids()
    for include_host in (False, True):
        if kind == "hash" and include_host:
            continue  # the reference collides there: next test
        a = port.lookup(ids, include_host=include_host).numpy()
        b = np.asarray(ref.lookup(ids, include_host=include_host))
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
        hops = port.lookup_hops([ids], include_host=include_host)[0]
        assert np.array_equal(_bits(hops.numpy()), _bits(b))
    cold = port.plan.tier[np.maximum(ids, 0)] >= TIER_HOST
    dev = port.lookup(ids, include_host=False).numpy()
    assert not dev[cold | (ids < 0)].any()
    assert np.array_equal(dev[~cold & (ids >= 0)],
                          feats[ids[~cold & (ids >= 0)]])


@pytest.mark.parametrize("topo", sorted(STORE_TOPOS))
def test_hash_store_host_rows_are_the_features_where_the_reference_collides(
        topo):
    """``hash_placement`` numbers HOST slots per card while the store lays
    a server's HOST rows out by slot, so in the reference store the cards
    of a server overwrite each other's rows (``ROADMAP.md`` C).
    The port's store gives each row its own place: every id reads its own
    features, HOST rows included, while the plan stays the reference's."""
    port, ref, feats = _store_pair("hash", STORE_TOPOS[topo])
    ids = _ids()
    want = np.where((ids >= 0)[:, None], feats[np.maximum(ids, 0)],
                    np.float32(0))
    got = port.lookup(ids).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(port.lookup_hops([ids])[0].numpy()),
                          _bits(want))
    ref_rows = np.asarray(ref.lookup(ids))
    if STORE_TOPOS[topo]["devices_per_pod"] > 1:
        assert not np.array_equal(_bits(ref_rows), _bits(want))


def test_hash_store_smallest_split():
    """The smallest input that splits the two stores: 6 nodes on one
    server of 2 cards holding one row each. Nodes 2 and 3 are both HOST
    slot 0 (of cards 0 and 1), nodes 4 and 5 both slot 1: the reference
    store reads node 3's row for node 2 and node 5's for node 4."""
    topo = dict(num_pods=1, devices_per_pod=2, rows_per_device=1,
                rows_host=8)
    feats = np.arange(12, dtype=np.float32).reshape(6, 2)
    port = TieredFeatureStore.build(feats, hash_placement(6, TopologySpec(
        **topo)), device=CPU)
    ref = JaxStore.build(feats, jax_hash(6, JaxTopo(**topo)))
    ids = np.arange(6, dtype=np.int32)
    assert np.array_equal(port.lookup(ids).numpy(), feats)
    assert np.array_equal(np.asarray(ref.lookup(ids)),
                          feats[[0, 1, 3, 3, 5, 5]])
