"""The port's graph layer against the reference on the CPU: the numpy
generators (``uniform_graph``, ``grid_mesh_graph``, ``radius_graph``,
``molecule_batch``, ``preset_graph``) and ``CSRGraph.reverse`` bit for
bit (they are the reference's numpy draws); ``SampledHops`` /
``sample_khop`` over the port's torch-RNG ``device_sample``, held to the
same structural checks as ``device_sample``; ``realized_size``."""
import numpy as np
import pytest
import torch

from repro.graph import generators as ref_gen
from repro.graph import sampler as ref_sampler
from repro.graph.csr import CSRGraph as RefCSR
from repro_torch.graph import (CSRGraph, SampledHops, generators,
                               host_sample, realized_size, sample_khop)


def _same_graph(got, want):
    assert got.num_nodes == want.num_nodes
    for name in ("indptr", "indices", "edge_weight"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("n,deg,seed", [(500, 6.0, 0), (64, 2.5, 3)])
def test_uniform_graph_bitwise(n, deg, seed):
    _same_graph(generators.uniform_graph(n, deg, seed=seed),
                ref_gen.uniform_graph(n, deg, seed=seed))


@pytest.mark.parametrize("nx,ny", [(5, 7), (1, 4), (12, 12)])
def test_grid_mesh_graph_bitwise(nx, ny):
    _same_graph(generators.grid_mesh_graph(nx, ny),
                ref_gen.grid_mesh_graph(nx, ny))


@pytest.mark.parametrize("max_neighbors", [None, 1, 3, 50])
def test_radius_graph_bitwise(max_neighbors):
    """Including the nearest-``max_neighbors`` cut (its per-source rank is
    vectorised in the port; the reference walks each run)."""
    pos = np.random.default_rng(2).normal(scale=1.2, size=(60, 3)).astype(
        np.float32)
    _same_graph(generators.radius_graph(pos, 2.0, max_neighbors),
                ref_gen.radius_graph(pos, 2.0, max_neighbors))


@pytest.mark.parametrize("batch,atoms,seed,cutoff", [(4, 12, 0, 2.0),
                                                     (3, 30, 5, 2.5)])
def test_molecule_batch_bitwise(batch, atoms, seed, cutoff):
    g, pos, mol = generators.molecule_batch(batch, atoms, seed=seed,
                                            cutoff=cutoff)
    rg, rpos, rmol = ref_gen.molecule_batch(batch, atoms, seed=seed,
                                            cutoff=cutoff)
    _same_graph(g, rg)
    for a, b in ((pos, rpos), (mol, rmol)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(generators.PRESETS))
def test_preset_graph_bitwise(name):
    g, feats = generators.preset_graph(name, seed=1, scale=0.02)
    rg, rfeats = ref_gen.preset_graph(name, seed=1, scale=0.02)
    _same_graph(g, rg)
    assert feats.dtype == rfeats.dtype and np.array_equal(feats, rfeats)
    assert generators.PRESETS == ref_gen._PRESETS


@pytest.mark.parametrize("weighted", [False, True])
def test_reverse_bitwise(weighted):
    g = generators.power_law_graph(300, 4.0, seed=1)
    src, dst = g.to_coo()
    w = (np.random.default_rng(0).random(src.shape[0]).astype(np.float32)
         if weighted else None)
    got = CSRGraph.from_edge_index(src, dst, 300, w).reverse()
    want = RefCSR.from_edge_index(src, dst, 300, w).reverse()
    _same_graph(got, want)
    got.validate()
    assert got.reverse().num_edges == g.num_edges


def test_sample_khop_structure():
    """The ``device_sample`` layout in a ``SampledHops``: sizes, ``-1``
    rows under ``-1`` parents, take-all for ``deg <= fan`` and every draw
    from the parent's own neighbours; ``all_nodes`` and ``padded_size``
    as the reference defines them."""
    g = generators.power_law_graph(400, 5.0, seed=2)
    fan = (4, 3)
    seeds = torch.tensor([0, 5, -1, 399, 17], dtype=torch.int32)
    s = sample_khop(torch.Generator().manual_seed(0), g.device_arrays("cpu"),
                    seeds, fan)
    assert isinstance(s, SampledHops) and s.fanouts == fan
    assert [h.shape[0] for h in s.hops] == [5, 20, 60]
    assert s.padded_size == 85 and torch.equal(
        s.all_nodes(), torch.cat([h.reshape(-1) for h in s.hops]))
    for k, f in enumerate(fan):
        for v, row in zip(s.hops[k].tolist(),
                          s.hops[k + 1].reshape(-1, f).numpy()):
            nbrs = g.indices[g.indptr[v]:g.indptr[v + 1]] if v >= 0 else []
            if v < 0:
                assert (row == -1).all()
            elif len(nbrs) <= f:
                assert np.array_equal(row[:len(nbrs)], nbrs)
                assert (row[len(nbrs):] == -1).all()
            else:
                assert np.isin(row, nbrs).all()


def test_realized_size_matches_reference():
    g = generators.power_law_graph(400, 5.0, seed=2)
    seeds = np.arange(0, 400, 7)
    hops = host_sample(np.random.default_rng(3), g, seeds, (5, 3))
    ref_hops = ref_sampler.host_sample(np.random.default_rng(3), g, seeds,
                                       (5, 3))
    assert realized_size(hops) == ref_sampler.realized_size(ref_hops) == \
        sum(h.size for h in hops)
