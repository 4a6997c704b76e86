"""Port ``segment_spmm`` against the JAX reference: the plain PyTorch
version is bitwise equal to the Pallas kernel in interpret mode (fp32 and
bf16, weighted or not, over the sweep of ``tests/test_kernels.py``) and
close to the reference's jnp oracle, whose ``.sum(1)`` adds in another
order; empty grids give zeros; an id ≥ M reads row M-1 as the Pallas body
does. ``coo_to_ell`` lays rows out as the reference's loop does, and the
device ELL pair equals ``coo_to_ell(src, dst)`` / ``coo_to_ell(dst, src)``.
The autograd Function's gradient (the same SpMM over the transposed
table) agrees with autograd through ``scatter_spmm`` and passes
``gradcheck``. The dispatch takes the plain version only for CPU tensors;
the CUDA wrapper refuses anything else.

XLA compiles the Pallas body's ``acc + row * w`` to one fused
multiply-add (checked here: the weighted sweep cases match an FMA
accumulation bit for bit and a multiply-then-add one does not), so a
weighted step is an FMA in the port too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import power_law_graph, scatter_spmm as jax_scatter_spmm
from repro.kernels.segment_spmm.kernel import segment_spmm_pallas
from repro.kernels.segment_spmm.ref import coo_to_ell as jax_coo_to_ell
from repro.kernels.segment_spmm.ref import segment_spmm_ref
from repro_torch.graph.segment import scatter_spmm
from repro_torch.kernels import segment_spmm as sp_pkg
from repro_torch.kernels.segment_spmm import kernel as sp_kernel
from repro_torch.kernels.segment_spmm import ops as sp_ops
from repro_torch.kernels.segment_spmm import ref as sp_ref

# the tests/test_kernels.py sweep: (N, Dmax, M, d, weighted)
SWEEP = [(37, 9, 50, 128, True), (8, 1, 10, 256, False),
         (65, 16, 200, 32, True), (16, 5, 16, 8, False)]


def _inputs(n, dmax, m, d, weighted):
    rng = np.random.default_rng(n * dmax + d)
    ids = rng.integers(-1, m, size=(n, dmax)).astype(np.int32)
    ids[0] = -1                       # an all-padding row
    feat = rng.normal(size=(m, d)).astype(np.float32)
    w = rng.normal(size=(n, dmax)).astype(np.float32) if weighted else None
    return ids, feat, w


def _plain(ids, feat, w, dtype=torch.float32):
    return sp_ref.segment_spmm_plain(
        torch.from_numpy(ids), torch.from_numpy(feat).to(dtype),
        None if w is None else torch.from_numpy(w).to(dtype))


def _pallas(ids, feat, w, dtype=jnp.float32):
    return segment_spmm_pallas(
        jnp.asarray(ids), jnp.asarray(feat).astype(dtype),
        None if w is None else jnp.asarray(w).astype(dtype), interpret=True)


@pytest.mark.parametrize("n,dmax,m,d,weighted", SWEEP)
def test_plain_equals_pallas_fp32(n, dmax, m, d, weighted):
    ids, feat, w = _inputs(n, dmax, m, d, weighted)
    plain = _plain(ids, feat, w)
    assert plain.dtype == torch.float32 and plain.shape == (n, d)
    assert np.array_equal(plain.numpy(), np.asarray(_pallas(ids, feat, w)))
    assert not plain[0].any()         # all-padding row is an exact zero row


@pytest.mark.parametrize("n,dmax,m,d,weighted", SWEEP)
def test_plain_equals_pallas_bf16(n, dmax, m, d, weighted):
    """bf16 feat and weights, fp32 accumulation on both sides: each side
    widens bf16 exactly and rounds once at the end, so bitwise too."""
    ids, feat, w = _inputs(n, dmax, m, d, weighted)
    plain = _plain(ids, feat, w, torch.bfloat16)
    pallas = _pallas(ids, feat, w, jnp.bfloat16)
    assert plain.dtype == torch.bfloat16
    assert np.array_equal(plain.float().numpy(),
                          np.asarray(pallas.astype(jnp.float32)))


@pytest.mark.parametrize("n,dmax,m,d,weighted", SWEEP)
def test_plain_close_to_jnp_oracle(n, dmax, m, d, weighted):
    """The oracle sums with ``.sum(1)``, in another order: fp32 rounding
    of a ≤16-term sum of unit normals, so 2e-5 (``tests/test_kernels.py``'s
    fp32 tolerance)."""
    ids, feat, w = _inputs(n, dmax, m, d, weighted)
    oracle = segment_spmm_ref(jnp.asarray(ids), jnp.asarray(feat),
                              None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(_plain(ids, feat, w).numpy(),
                               np.asarray(oracle), rtol=2e-5, atol=2e-5)


def test_weighted_step_is_a_fused_multiply_add():
    """The weighted sweep case differs from a multiply-then-add
    accumulation and equals an FMA one, on the Pallas side as on the
    port's."""
    ids, feat, w = _inputs(37, 9, 50, 128, True)
    pallas = np.asarray(_pallas(ids, feat, w))
    f, i = torch.from_numpy(feat), torch.from_numpy(ids).long()
    mul_add = torch.zeros(37, 128)
    for j in range(9):
        valid = (i[:, j] >= 0)[:, None]
        step = mul_add + f[i[:, j].clamp_min(0)] * torch.from_numpy(w)[:, j,
                                                                      None]
        mul_add = torch.where(valid, step, mul_add)
    assert not np.array_equal(mul_add.numpy(), pallas)
    assert np.array_equal(_plain(ids, feat, w).numpy(), pallas)


def test_sum_is_in_column_order():
    """Row sum ((1e8 + 1) - 1e8) + 1 in column order is 1 in fp32 (the
    first 1 is absorbed), where the oracle's ``.sum(1)`` may add pairwise;
    the plain version equals a sequential Python loop."""
    feat = torch.tensor([[1e8], [1.0], [-1e8]])
    ids = torch.tensor([[0, 1, 2, 1]], dtype=torch.int32)
    seq = torch.zeros(1)
    for j in (0, 1, 2, 1):
        seq = seq + feat[j]
    out = sp_ref.segment_spmm_plain(ids, feat)
    assert torch.equal(out[0], seq) and float(out[0, 0]) == 1.0
    pallas = segment_spmm_pallas(jnp.asarray(ids.numpy()),
                                 jnp.asarray(feat.numpy()), interpret=True)
    assert np.array_equal(out.numpy(), np.asarray(pallas))


def test_padding_anywhere_in_a_row_and_id_past_the_table():
    """-1 in mid-row reads nothing; an id ≥ M reads row M-1, as the
    Pallas body's dynamic slice does."""
    feat = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[-1, 2, -1, 0], [7, -1, -1, -1], [-1, -1, -1, -1]],
                   np.int32)
    out = _plain(ids, feat, None)
    assert np.array_equal(out.numpy(), [[6, 8, 10], [9, 10, 11], [0, 0, 0]])
    assert np.array_equal(out.numpy(), np.asarray(_pallas(ids, feat, None)))


@pytest.mark.parametrize("n,dmax,d", [(0, 4, 8), (3, 0, 8), (3, 4, 0)])
@pytest.mark.parametrize("weighted", [False, True])
def test_empty_grid_gives_zeros(n, dmax, d, weighted):
    feat = torch.ones((5, d))
    ids = torch.zeros((n, dmax), dtype=torch.int32)
    w = torch.ones((n, dmax)) if weighted else None
    out = sp_ops.segment_spmm(ids, feat, w)
    pallas = segment_spmm_pallas(jnp.zeros((n, dmax), jnp.int32),
                                 jnp.ones((5, d)),
                                 jnp.ones((n, dmax)) if weighted else None)
    assert out.shape == (n, d) == tuple(pallas.shape) and not out.any()


@pytest.mark.parametrize("num_nodes,edges,dmax,seed", [
    (40, 200, None, 0), (40, 200, 3, 1), (7, 0, None, 2), (0, 0, None, 3),
    (300, 3000, None, 4), (300, 3000, 1, 5)])
def test_coo_to_ell_layout_equals_reference(num_nodes, edges, dmax, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, max(num_nodes, 1), edges).astype(np.int32)
    dst = rng.integers(0, max(num_nodes, 1), edges).astype(np.int32)
    ours = sp_ref.coo_to_ell(src, dst, num_nodes, dmax=dmax)
    want = jax_coo_to_ell(src, dst, num_nodes, dmax=dmax)
    assert ours.dtype == want.dtype == np.int32
    assert ours.shape == want.shape and np.array_equal(ours, want)


def test_coo_to_ell_raises_on_negative_dst_like_the_reference():
    with pytest.raises(ValueError):
        jax_coo_to_ell(np.array([0]), np.array([-1]), 3)
    with pytest.raises(ValueError):
        sp_ref.coo_to_ell(np.array([0]), np.array([-1]), 3)


@pytest.mark.parametrize("num_nodes,edges,seed", [(50, 400, 0), (9, 0, 1),
                                                  (500, 6000, 2)])
def test_device_ell_pair_equals_coo_to_ell(num_nodes, edges, seed):
    """Equal to ``coo_to_ell`` of the valid edges both ways; negative
    endpoints are dropped first, as ``scatter_spmm`` zeroes them."""
    rng = np.random.default_rng(seed)
    src = rng.integers(-1, num_nodes, edges).astype(np.int32)
    dst = rng.integers(-1, num_nodes, edges).astype(np.int32)
    ids, ids_t = sp_ref.ell_pair(torch.from_numpy(src), torch.from_numpy(dst),
                                 num_nodes)
    keep = (src >= 0) & (dst >= 0)
    assert ids.dtype == ids_t.dtype == torch.int32
    assert np.array_equal(ids.numpy(), jax_coo_to_ell(src[keep], dst[keep],
                                                      num_nodes))
    assert np.array_equal(ids_t.numpy(), jax_coo_to_ell(dst[keep], src[keep],
                                                        num_nodes))


def test_ell_pair_rejects_an_endpoint_past_the_nodes():
    with pytest.raises(ValueError, match="not below"):
        sp_ref.ell_pair(torch.tensor([0]), torch.tensor([5]), 3)


def test_transpose_ell_is_the_transposed_adjacency():
    ids, ids_t = _graph_tables(60, 4.0)
    built = sp_ref.transpose_ell(ids, 60)
    # same multiset per row as the edge-order table, rows sorted
    assert torch.equal(built.sort(1).values, ids_t.sort(1).values)


def _graph_tables(n, avg_degree, seed=5):
    g = power_law_graph(n, avg_degree, seed=seed)
    src, dst = g.to_coo()
    return sp_ref.ell_pair(torch.from_numpy(np.asarray(src, np.int32)),
                           torch.from_numpy(np.asarray(dst, np.int32)), n)


def test_equals_reference_scatter_spmm_on_a_graph():
    """The reference's own check (``test_segment_spmm_equals_coo_scatter``)
    on the port: the ELL SpMM of a power-law graph's table is its COO
    scatter, within fp32 order tolerance."""
    g = power_law_graph(80, 4.0, seed=5)
    src, dst = g.to_coo()
    feat = np.random.default_rng(0).normal(size=(80, 16)).astype(np.float32)
    ids, _ = sp_ref.ell_pair(torch.from_numpy(np.asarray(src, np.int32)),
                             torch.from_numpy(np.asarray(dst, np.int32)), 80)
    out = sp_ops.segment_spmm(ids, torch.from_numpy(feat))
    ref = jax_scatter_spmm(jnp.asarray(feat), jnp.asarray(src),
                           jnp.asarray(dst), 80)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("hand_in_transpose", [True, False])
def test_autograd_gradient_equals_scatter_spmm_autograd(hand_in_transpose):
    """Gradient of Σ (out · r) for a random r: the Function's (the same
    SpMM over the transposed table) against autograd through the port's
    ``scatter_spmm`` (index_add_), within fp32 order tolerance 1e-5."""
    n = 120
    g = power_law_graph(n, 6.0, seed=3)
    src_np, dst_np = (np.asarray(a, np.int32) for a in g.to_coo())
    src, dst = torch.from_numpy(src_np), torch.from_numpy(dst_np)
    ids, ids_t = sp_ref.ell_pair(src, dst, n)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(n, 24)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(n, 24)).astype(np.float32))
    a = x.clone().requires_grad_()
    out = sp_ops.segment_spmm_autograd(
        ids, a, ids_t=ids_t if hand_in_transpose else None)
    (out * r).sum().backward()
    b = x.clone().requires_grad_()
    (scatter_spmm(b, src, dst, n) * r).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               scatter_spmm(x, src, dst, n).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_gradcheck_fp64():
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(-1, 6, size=(5, 4)).astype(np.int32))
    feat = torch.from_numpy(rng.normal(size=(6, 3))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda f: sp_ops.segment_spmm_autograd(ids, f), (feat,))


def test_backward_skipped_when_feat_needs_no_gradient(monkeypatch):
    """A layer-1 input (no gradient) costs no backward call; a later
    layer's costs one."""
    calls = []
    real = sp_ops.segment_spmm

    def counting(*args):
        calls.append(args[1].shape)
        return real(*args)

    monkeypatch.setattr(sp_ops, "segment_spmm", counting)
    ids, ids_t = _graph_tables(30, 3.0)
    x = torch.randn(30, 4)
    w = torch.randn(4, 4, requires_grad=True)
    h = sp_ops.segment_spmm_autograd(ids, x, ids_t=ids_t) @ w
    out = sp_ops.segment_spmm_autograd(ids, h, ids_t=ids_t)
    out.sum().backward()
    assert len(calls) == 3            # 2 forward + 1 backward (layer 2)


def test_weighted_call_refuses_a_gradient():
    ids, _ = _graph_tables(20, 3.0)
    w = torch.ones(ids.shape)
    feat = torch.randn(20, 4)
    with pytest.raises(NotImplementedError):
        sp_ops.segment_spmm_autograd(ids, feat, w.requires_grad_())
    with pytest.raises(NotImplementedError):
        sp_ops.segment_spmm_autograd(ids, feat.requires_grad_(),
                                     torch.ones(ids.shape))
    out = sp_ops.segment_spmm_autograd(ids, feat.detach(), w.detach())
    assert torch.equal(out, sp_ref.segment_spmm_plain(ids, feat.detach(),
                                                      w.detach()))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """The dispatch's one seam: a rigged plain version is what CPU tensors
    get, and the kernel is never reached."""
    monkeypatch.setattr(sp_ref, "segment_spmm_plain",
                        lambda ids, feat, w=None: feat.new_full(
                            (ids.shape[0], feat.shape[1]), 7.0))

    def no_kernel(*a):
        raise AssertionError("kernel reached with CPU tensors")

    monkeypatch.setattr(sp_kernel, "segment_spmm_cuda", no_kernel)
    out = sp_ops.segment_spmm(torch.zeros((3, 2), dtype=torch.int32),
                              torch.ones((4, 5)))
    assert torch.equal(out, torch.full((3, 5), 7.0))


def test_cuda_wrapper_refuses_cpu_tensors():
    before = sp_pkg.LAUNCHES.value
    with pytest.raises(ValueError, match="CUDA"):
        sp_kernel.segment_spmm_cuda(torch.zeros((2, 2), dtype=torch.int32),
                                    torch.ones((3, 4)))
    assert sp_pkg.LAUNCHES.value == before
