"""Port graph layer, metrics and placement against the JAX reference: the
numpy parts (CSR, generator, host samplers, placement) and
``fixed_size_unique`` are bitwise equal, segment ops and PSGS/FAP agree
within fp32 tolerance, and the torch device sampler passes the structural
checks (its RNG cannot reproduce ``jax.random``'s bits)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compute_fap as jax_fap
from repro.core import compute_psgs as jax_psgs
from repro.core import TopologySpec as JaxTopo
from repro.core import quiver_placement as jax_placement
from repro.graph import fixed_size_unique as jax_unique
from repro.graph import host_sample as jax_host_sample
from repro.graph import host_sample_dense as jax_host_sample_dense
from repro.graph import power_law_graph as jax_power_law
from repro.graph import segment as jseg
from repro_torch.core import TopologySpec, compute_fap, compute_psgs
from repro_torch.core import quiver_placement
from repro_torch.graph import (CSRGraph, device_sample, fixed_size_unique,
                               host_sample, host_sample_dense,
                               power_law_graph)
from repro_torch.graph import segment as tseg

CPU = "cpu"
FAN = (4, 3)
# PSGS/FAP are K fp32 SpMV passes: the sums may run in another order
METRIC_RTOL = 1e-5


@pytest.fixture(scope="module")
def graphs():
    return power_law_graph(900, 6.0, seed=0), jax_power_law(900, 6.0, seed=0)


def test_power_law_graph_bitwise(graphs):
    g, gj = graphs
    g.validate()
    assert g.num_nodes == gj.num_nodes
    assert np.array_equal(g.indptr, gj.indptr)
    assert np.array_equal(g.indices, gj.indices)
    indptr, indices = g.device_arrays(CPU)
    assert indptr.dtype == indices.dtype == torch.int32
    assert np.array_equal(indices.numpy(), gj.indices)


def test_csr_from_edge_index_matches():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    from repro.graph import CSRGraph as JaxCSR
    a = CSRGraph.from_edge_index(src, dst, 50)
    b = JaxCSR.from_edge_index(src, dst, 50)
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.to_coo()[0], b.to_coo()[0])


@pytest.mark.parametrize("seed", [0, 7])
def test_host_samplers_bitwise(graphs, seed):
    g, gj = graphs
    seeds = np.random.default_rng(seed).integers(-1, 900, 24)
    for port, ref in ((host_sample_dense, jax_host_sample_dense),
                      (host_sample, jax_host_sample)):
        a = port(np.random.default_rng(seed), g, seeds, FAN)
        b = ref(np.random.default_rng(seed), gj, seeds, FAN)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("m,capacity,lo", [(64, 64, -1), (50, 80, -1),
                                           (40, 40, 0), (16, 16, -1)])
def test_fixed_size_unique_bitwise(m, capacity, lo):
    """Layout included: ascending uniques, -1 pads at the END, and the
    inverse of a -1 input pointing at capacity-1."""
    rng = np.random.default_rng(m + capacity)
    ids = rng.integers(lo, 30, size=m).astype(np.int32)
    if m == 16:
        ids[:] = -1  # all padding
    uniq, inv = fixed_size_unique(torch.from_numpy(ids), capacity)
    uj, ij = jax_unique(jnp.asarray(ids), capacity)
    assert uniq.dtype == torch.int32 and inv.dtype == torch.int32
    assert np.array_equal(uniq.numpy(), np.asarray(uj))
    assert np.array_equal(inv.numpy(), np.asarray(ij))
    u = uniq.numpy()
    n_u = int((u >= 0).sum())
    assert (u[n_u:] == -1).all() and (np.diff(u[:n_u]) > 0).all()
    assert (inv.numpy()[ids < 0] == capacity - 1).all()


def test_device_sample_structure(graphs):
    """Shape (|frontier|·fan,), the -1 layout, take-all for deg <= fan, and
    every draw from the node's own neighbor list."""
    g, _ = graphs
    indptr, indices = g.device_arrays(CPU)
    seeds = torch.from_numpy(np.r_[np.arange(40), [-1] * 8, [899]]
                             .astype(np.int32))
    gen = torch.Generator().manual_seed(3)
    hops = device_sample(gen, indptr, indices, seeds, FAN)
    assert [h.shape[0] for h in hops] == [49, 49 * 4, 49 * 12]
    for k, fan in enumerate(FAN):
        parents = hops[k].numpy()
        kids = hops[k + 1].numpy().reshape(-1, fan)
        assert hops[k + 1].dtype == torch.int32
        for v, row in zip(parents, kids):
            if v < 0:
                assert (row == -1).all()
                continue
            nbrs = g.indices[g.indptr[v]:g.indptr[v + 1]]
            deg = nbrs.shape[0]
            if deg <= fan:
                assert np.array_equal(row[:deg], nbrs)
                assert (row[deg:] == -1).all()
            else:
                assert (row >= 0).all() and np.isin(row, nbrs).all()


def test_device_sample_degree_zero_tail():
    """A degree-0 node at the end of the CSR starts at E; its (masked) read
    must stay in bounds and give -1."""
    g = CSRGraph.from_edge_index(np.array([0, 0, 1]), np.array([1, 2, 0]), 4)
    indptr, indices = g.device_arrays(CPU)
    hops = device_sample(torch.Generator().manual_seed(0), indptr, indices,
                         torch.tensor([3, 2, 0], dtype=torch.int32), (3,))
    assert hops[1].tolist() == [-1, -1, -1, -1, -1, -1, 1, 2, -1]


@pytest.mark.parametrize("mode", ["branching", "paper"])
def test_compute_psgs_matches(graphs, mode):
    g, gj = graphs
    a = compute_psgs(g, FAN, mode=mode, device=CPU)
    b = jax_psgs(gj, FAN, mode=mode)
    assert a.dtype == np.float32 and a.shape == (900,)
    np.testing.assert_allclose(a, b, rtol=METRIC_RTOL)
    with pytest.raises(ValueError):
        compute_psgs(g, FAN, mode="nope", device=CPU)


@pytest.mark.parametrize("truncated,skewed", [(False, False), (True, True)])
def test_compute_fap_matches(graphs, truncated, skewed):
    g, gj = graphs
    prob = (np.random.default_rng(2).random(900) ** 3 if skewed else None)
    a = compute_fap(g, FAN, seed_prob=prob, truncated=truncated, device=CPU)
    b = jax_fap(gj, FAN, seed_prob=prob, truncated=truncated)
    np.testing.assert_allclose(a, b, rtol=METRIC_RTOL)


@pytest.mark.parametrize("pods,devs,hot_frac,dcn", [
    (1, 1, 0.3, True), (1, 8, 0.25, True), (2, 4, 0.5, True),
    (2, 4, 0.0, False)])
def test_quiver_placement_bitwise(graphs, pods, devs, hot_frac, dcn):
    _, gj = graphs
    fap = jax_fap(gj, FAN)
    kw = dict(num_pods=pods, devices_per_pod=devs, rows_per_device=60,
              rows_host=200, hot_replicate_fraction=hot_frac,
              has_fast_interpod=dcn)
    a = quiver_placement(fap, TopologySpec(**kw))
    b = jax_placement(fap, JaxTopo(**kw))
    for f in ("tier", "pod_owner", "device_owner", "slot"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.n_hot, a.warm_rows_per_device, a.host_rows_per_pod) == (
        b.n_hot, b.warm_rows_per_device, b.host_rows_per_pod)
    assert a.tier_counts() == b.tier_counts()


def test_segment_ops_match():
    rng = np.random.default_rng(5)
    n, segs = 200, 17
    data = rng.normal(size=(n, 6)).astype(np.float32)
    ids = rng.integers(-1, segs + 2, n).astype(np.int32)  # incl. dropped ids
    scores = rng.normal(size=n).astype(np.float32)
    pairs = [
        (tseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), segs),
         jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), segs)),
        (tseg.segment_mean(torch.from_numpy(data), torch.from_numpy(ids),
                           segs),
         jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids), segs)),
        (tseg.segment_max(torch.from_numpy(data), torch.from_numpy(ids),
                          segs),
         jseg.segment_max(jnp.asarray(data), jnp.asarray(ids), segs)),
    ]
    ok = ids.clip(0, segs - 1)  # softmax/spmm take in-range segment ids
    pairs.append((tseg.segment_softmax(torch.from_numpy(scores),
                                       torch.from_numpy(ok), segs),
                  jseg.segment_softmax(jnp.asarray(scores), jnp.asarray(ok),
                                       segs)))
    src = rng.integers(-1, n, 300).astype(np.int32)
    dst = rng.integers(-1, segs, 300).astype(np.int32)
    w = rng.random(300).astype(np.float32)
    pairs.append((tseg.scatter_spmm(torch.from_numpy(data),
                                    torch.from_numpy(src),
                                    torch.from_numpy(dst), segs,
                                    torch.from_numpy(w)),
                  jseg.scatter_spmm(jnp.asarray(data), jnp.asarray(src),
                                    jnp.asarray(dst), segs, jnp.asarray(w))))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("shape", [(), (5,), (2, 3)])
def test_segment_sum_ordered_is_the_sequential_sum(shape):
    """``segment_sum_ordered`` adds each segment's terms from zero in their
    order, bit for bit (a Python loop in fp32 is the witness), equals
    ``segment_sum`` on the CPU bit for bit (``index_add_`` is sequential
    there), drops out-of-range ids and leaves empty segments 0; against
    the reference's ``segment_sum`` within 1e-5."""
    rng = np.random.default_rng(9)
    n, segs = 400, 23
    data = (rng.normal(size=(n,) + shape) * 10.0 ** rng.integers(
        -3, 4, size=(n,) + shape)).astype(np.float32)
    ids = rng.integers(-2, segs + 2, n).astype(np.int32)
    ids[ids == 7] = 8  # an empty segment
    got = tseg.segment_sum_ordered(torch.from_numpy(data),
                                   torch.from_numpy(ids), segs).numpy()
    want = np.zeros((segs,) + shape, np.float32)
    for i in range(n):
        if 0 <= ids[i] < segs:
            want[ids[i]] = want[ids[i]] + data[i]
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert not got[7].any()
    plain = tseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids),
                             segs).numpy()
    assert np.array_equal(got.view(np.int32), plain.view(np.int32))
    ref = np.asarray(jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                                      segs))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
