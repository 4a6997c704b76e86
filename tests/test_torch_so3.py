"""The port's SO(3) machinery (``repro_torch.models.so3``) against the JAX
reference on the CPU.

The float64 monomial and basis tables are copies of the reference's
builders and must equal its arrays bit for bit. The per-edge rotation
blocks are an fp32 contraction of those tables, whose entries reach 700 at
l = 6, and use torch's cos/sin/atan2/arccos: they agree with the
reference's within ``BLOCK_TOL`` = 1e-5 at every l ≤ 6 (measured: 2.8e-6
at l = 6 over 4,096 random directions, where the reference's own l = 6
blocks are orthogonal only to 5.4e-6). The conventions are the
reference's own tests (``tests/test_models.py``) run on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import so3 as ref
from repro_torch.models import so3

BLOCK_TOL = 1e-5
L_MAX = 6


def _directions(n=4096, seed=0):
    """Unit vectors, plus the zero vector (a self-loop or a padded edge:
    atan2(0, 0) = 0, arccos(0)) and ±ẑ (arccos at its ends)."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n, 3))
    r /= np.linalg.norm(r, axis=-1, keepdims=True)
    r = r.astype(np.float32)
    r[:3] = 0.0
    r[3] = [0.0, 0.0, 1.0]
    r[4] = [0.0, 0.0, -1.0]
    return r


@pytest.mark.parametrize("l", range(L_MAX + 1))
def test_monomial_tables_equal_reference_bitwise(l):
    m, want = so3._wigner_d_monomials(l), ref._wigner_d_monomials(l)
    assert m.dtype == want.dtype == np.float64 and m.shape == want.shape
    assert np.array_equal(m.view(np.int64), want.view(np.int64))
    c, want_c = so3._complex_to_real_basis(l), ref._complex_to_real_basis(l)
    assert c.dtype == want_c.dtype and np.array_equal(c, want_c)
    for a, b in zip(so3._z_rot_indices(l), ref._z_rot_indices(l)):
        assert np.array_equal(a, b)
    assert so3.num_coeffs(l) == ref.num_coeffs(l)
    assert all(so3.lm_index(l, m_) == ref.lm_index(l, m_)
               for m_ in range(-l, l + 1))


def test_monomials_are_cast_once_per_device():
    """The float32 tables are built once per (l, device, dtype) and then
    shared."""
    a = so3._monomials(3, torch.device("cpu"), torch.float32)
    assert a is so3._monomials(3, torch.device("cpu"), torch.float32)
    assert a.dtype == torch.float32
    assert torch.equal(a, torch.from_numpy(
        ref._wigner_d_monomials(3).astype(np.float32)))


def test_wigner_orthogonal_and_l1():
    """``tests/test_models.py::test_wigner_orthogonal_and_l1`` on the port,
    and the port's D against the reference's."""
    lmax = 4
    a, b, g = 0.3, 1.1, -0.7
    D = so3.wigner_zyz(a, b, g, lmax, device="cpu").numpy()
    assert np.abs(D @ D.T - np.eye(so3.num_coeffs(lmax))).max() < 1e-5
    R = so3.rotation_matrix_zyz(a, b, g)
    assert np.array_equal(R, ref.rotation_matrix_zyz(a, b, g))
    P = np.zeros((3, 3))
    P[0, 1] = P[1, 2] = P[2, 0] = 1  # (y, z, x) real-SH ordering
    np.testing.assert_allclose(D[1:4, 1:4], P @ R @ P.T, atol=1e-5)
    np.testing.assert_allclose(D, np.asarray(ref.wigner_zyz(a, b, g, lmax)),
                               atol=BLOCK_TOL)


def test_edge_rotation_aligns_to_z():
    """``tests/test_models.py::test_edge_rotation_aligns_to_z`` on the
    port: ``D_align`` sends ``l1_embedding(r̂)`` to ẑ's, and D·Dinv = I."""
    rng = np.random.default_rng(0)
    r = rng.normal(size=(20, 3))
    r /= np.linalg.norm(r, axis=-1, keepdims=True)
    rt = torch.as_tensor(r, dtype=torch.float32)
    D, Dinv = so3.edge_rotation_blocks(rt, 3)
    out = torch.einsum("eij,ej->ei", D[1], so3.l1_embedding(rt)).numpy()
    np.testing.assert_allclose(out, np.tile([0, 1, 0], (20, 1)), atol=1e-5)
    for l in range(4):
        eye = torch.einsum("eij,ejk->eik", D[l], Dinv[l]).numpy()
        np.testing.assert_allclose(eye, np.tile(np.eye(2 * l + 1),
                                                (20, 1, 1)), atol=1e-5)
    want = ref.l1_embedding(jnp.asarray(r, jnp.float32))
    assert np.array_equal(so3.l1_embedding(rt).numpy(), np.asarray(want))


def test_edge_rotation_blocks_match_reference():
    """At l_max 6, every block within ``BLOCK_TOL`` of the reference's
    (the zero vector and ±ẑ included), each block orthogonal to 1e-5,
    and ``Dinv`` its transpose."""
    r = _directions()
    D, Dinv = so3.edge_rotation_blocks(torch.from_numpy(r), L_MAX)
    Dr, Dir = ref.edge_rotation_blocks(jnp.asarray(r), L_MAX)
    assert len(D) == len(Dinv) == L_MAX + 1
    for l in range(L_MAX + 1):
        got, want = D[l].numpy(), np.asarray(Dr[l])
        assert got.shape == want.shape == (len(r), 2 * l + 1, 2 * l + 1)
        np.testing.assert_allclose(got, want, rtol=0, atol=BLOCK_TOL,
                                   err_msg=f"l={l}")
        np.testing.assert_allclose(Dinv[l].numpy(), np.asarray(Dir[l]),
                                   rtol=0, atol=BLOCK_TOL)
        assert torch.equal(Dinv[l], D[l].transpose(-1, -2))
        orth = np.einsum("eij,ekj->eik", got, got) - np.eye(2 * l + 1)
        assert np.abs(orth).max() < 1e-5, l
    # the zero vector takes α = 0, β = π/2, as in the reference
    zero = so3.edge_rotation_blocks(torch.zeros(1, 3), L_MAX)[0]
    x_axis = so3.edge_rotation_blocks(torch.tensor([[1.0, 0.0, 0.0]]),
                                      L_MAX)[0]
    for a, b in zip(zero, x_axis):
        assert torch.equal(a, b)


def test_dense_rotations_match_blocks_and_reference():
    r = _directions(64, seed=1)
    rt = torch.from_numpy(r)
    D, Dinv = so3.edge_rotations(rt, 4)
    Dr, _ = ref.edge_rotations(jnp.asarray(r), 4)
    np.testing.assert_allclose(D.numpy(), np.asarray(Dr), rtol=0,
                               atol=BLOCK_TOL)
    blocks, _ = so3.edge_rotation_blocks(rt, 4)
    for l, blk in enumerate(blocks):
        sl = slice(l * l, (l + 1) ** 2)
        np.testing.assert_allclose(D[:, sl, sl].numpy(), blk.numpy(),
                                   rtol=0, atol=BLOCK_TOL)
    assert torch.equal(Dinv, D.transpose(-1, -2))


def test_z_and_y_rotations_match_reference():
    theta = np.random.default_rng(2).uniform(-4, 4, size=(7,)).astype(
        np.float32)
    for fn in ("z_rotation", "y_rotation"):
        got = getattr(so3, fn)(torch.from_numpy(theta), L_MAX).numpy()
        want = np.asarray(getattr(ref, fn)(jnp.asarray(theta), L_MAX))
        np.testing.assert_allclose(got, want, rtol=0, atol=BLOCK_TOL,
                                   err_msg=fn)


def test_rotations_follow_the_input_dtype():
    """Float64 directions give float64 blocks (the fp64 witness of the card
    checks), orthogonal to 1e-12."""
    r = torch.from_numpy(_directions(32).astype(np.float64))
    D, _ = so3.edge_rotation_blocks(r, L_MAX)
    for l, blk in enumerate(D):
        assert blk.dtype == torch.float64
        orth = blk @ blk.transpose(-1, -2) - torch.eye(2 * l + 1,
                                                      dtype=torch.float64)
        assert float(orth.abs().max()) < 1e-12


def test_wigner_zyz_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        so3.wigner_zyz(0.1, 0.2, 0.3, 2)
