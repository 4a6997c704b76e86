"""Full-graph GAT and GraphSAGE (``models/gnn_basic.py``: ``gat_init``,
``gat_from_numpy``, ``gat_full_graph``, ``sage_full_graph``) against the
reference on the CPU, weights carried from the reference's ``gat_init`` /
``sage_init``, on a power-law graph from the reference's generator with
padded edges (``-1`` ends) mixed in.

Tolerance: fp32 outputs within 1e-5 (sums in another order: the port's
SAGE neighbour sum is ``segment_spmm``'s plain version, column by column
in edge order, and GAT's sums are ``index_add_``; the reference sums with
``jax.ops.segment_sum``). Outputs are LayerNorm-ed, so of order 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import power_law_graph as jax_power_law
from repro.graph.segment import scatter_spmm as jax_scatter_spmm
from repro.models import gnn_basic as ref_gnn
from repro_torch.graph.segment import scatter_spmm
from repro_torch.kernels.segment_spmm.ref import ell_pair, ell_table
from repro_torch.models import gnn_basic

N, D = 600, 16
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def graph():
    """(src, dst, x): the edges with 40 padded ones (20 with ``src = -1``,
    20 with ``dst = -1``) spread among them, and features."""
    g = jax_power_law(N, 5.0, seed=0)
    src, dst = (a.astype(np.int32) for a in g.to_coo())
    rng = np.random.default_rng(1)
    at = rng.choice(src.shape[0], 40, replace=False)
    src, dst = src.copy(), dst.copy()
    src[at[:20]] = -1
    dst[at[20:]] = -1
    x = rng.normal(size=(N, D)).astype(np.float32)
    return src, dst, x


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_gat_full_graph_matches_reference(graph):
    src, dst, x = graph
    params = ref_gnn.gat_init(jax.random.key(0), [D, 8, 8], heads=4)
    want = ref_gnn.gat_full_graph(params, jnp.asarray(x), jnp.asarray(src),
                                  jnp.asarray(dst), num_nodes=N)
    model = gnn_basic.gat_from_numpy(_np(params), device="cpu")
    got = gnn_basic.gat_full_graph(model, torch.from_numpy(x),
                                   torch.from_numpy(src),
                                   torch.from_numpy(dst), num_nodes=N)
    assert got.shape == (N, 32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert torch.equal(model(torch.from_numpy(x), torch.from_numpy(src),
                             torch.from_numpy(dst), num_nodes=N), got)


def test_sage_full_graph_matches_reference(graph):
    src, dst, x = graph
    params = ref_gnn.sage_init(jax.random.key(1), [D, 12, 12])
    want = ref_gnn.sage_full_graph(params, jnp.asarray(x), jnp.asarray(src),
                                   jnp.asarray(dst), num_nodes=N)
    model = gnn_basic.sage_from_numpy(_np(params), device="cpu")
    args = (torch.from_numpy(x), torch.from_numpy(src),
            torch.from_numpy(dst))
    got = gnn_basic.sage_full_graph(model, *args, num_nodes=N)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    ell = ell_table(args[2], args[1], N)
    assert torch.equal(gnn_basic.sage_full_graph(model, *args, num_nodes=N,
                                                 ell=ell), got)


def test_out_neighbour_table_is_the_transposed_half_of_the_pair(graph):
    """``ell_table(dst, src)`` equals ``ell_pair(src, dst)[1]`` (row ``s``:
    the targets of ``s``'s edges in edge order), and its width is the
    largest out-degree."""
    src, dst, _ = (torch.from_numpy(a) for a in graph)
    table = ell_table(dst, src, N)
    assert torch.equal(table, ell_pair(src, dst, N)[1])
    keep = (src >= 0) & (dst >= 0)
    assert table.shape == (N, int(torch.bincount(src[keep].long()).max()))


def test_sage_neighbour_sum_and_its_gradient_match_scatter_spmm(graph):
    """The layer's sum over out-neighbours through ``segment_spmm`` (and
    its gradient, on the transposed table built in the backward) against
    the port's ``scatter_spmm(h, dst, src, N)`` under autograd. The
    gradient sums a hub's ~1,300 in-edges (entries up to ~300), so it is
    held within 1e-5 of its largest magnitude: both fp32 sums sit ~4e-4
    from the fp64 one there."""
    src, dst, x = (torch.from_numpy(a) for a in graph)
    h = x.clone().requires_grad_()
    g = torch.randn(N, D, generator=torch.Generator().manual_seed(2))
    got = gnn_basic.segment_spmm_autograd(ell_table(dst, src, N), h)
    (gh,) = torch.autograd.grad(got, h, g)
    h2 = x.clone().requires_grad_()
    want = scatter_spmm(h2, dst, src, N)
    (wh,) = torch.autograd.grad(want, h2, g)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(gh, wh, rtol=0,
                               atol=1e-5 * float(wh.abs().max()))
    ref = jax_scatter_spmm(jnp.asarray(graph[2]), jnp.asarray(graph[1]),
                           jnp.asarray(graph[0]), N)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_gat_init_shapes_and_determinism():
    a = gnn_basic.gat_init(torch.Generator().manual_seed(0), [16, 8, 8],
                           heads=4, device="cpu")
    b = gnn_basic.gat_init(torch.Generator().manual_seed(0), [16, 8, 8],
                           heads=4, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in a.state_dict().items()}
    assert shapes["layers.0.proj.weight"] == (32, 16)
    assert shapes["layers.1.proj.weight"] == (32, 32)   # heads concatenate
    assert shapes["layers.0.attn_src"] == (4, 8)
    assert "layers.0.proj.bias" not in shapes
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
    att = a.layers[0].attn_src.detach()
    assert 0.02 < float(att.std()) < 0.3   # N(0, 0.1²)


def test_gat_from_numpy_defaults_to_the_card():
    params = _np(ref_gnn.gat_init(jax.random.key(0), [4, 2], heads=2))
    if torch.cuda.is_available():
        assert gnn_basic.gat_from_numpy(params).layers[0].proj.weight.is_cuda
    else:
        with pytest.raises(RuntimeError):
            gnn_basic.gat_from_numpy(params)


def test_padded_source_counts_toward_node_zero_like_the_reference():
    """The reference counts SAGE degrees as ``segment_sum(1, max(src, 0))``,
    so an edge with ``src = -1`` (no message) still adds 1 to node 0's
    degree and halves node 0's neighbour mean; the port follows it
    (ROADMAP C, inside the reference). One layer, ``self`` and ``neigh``
    the identity, so node 0's output is ``LN(x0 + mean)``."""
    src = np.array([0, -1, 1], np.int32)
    dst = np.array([1, 2, 2], np.int32)
    x = np.array([[1, 0, 0], [0, 3, 0], [0, 0, 1]], np.float32)
    params = ref_gnn.sage_init(jax.random.key(0), [3, 3])
    for part in ("self", "neigh"):
        params["layers"][0][part] = {"w": jnp.eye(3), "b": jnp.zeros(3)}
    want = np.asarray(ref_gnn.sage_full_graph(
        params, jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
        num_nodes=3))
    model = gnn_basic.sage_from_numpy(_np(params), device="cpu")
    got = gnn_basic.sage_full_graph(model, *(torch.from_numpy(a)
                                             for a in (x, src, dst)),
                                    num_nodes=3).detach()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # node 0: one real edge, to node 1, counted twice: LN(x0 + x1 / 2)
    ln = torch.nn.functional.layer_norm
    halved = ln(torch.tensor([1.0, 1.5, 0.0]), (3,), eps=1e-5)
    whole = ln(torch.tensor([1.0, 3.0, 0.0]), (3,), eps=1e-5)
    torch.testing.assert_close(got[0], halved)
    assert float((got[0] - whole).abs().max()) > 0.1
