"""SO(3) machinery for eSCN-style equivariant convolutions (EquiformerV2),
ported from ``src/repro/models/so3.py``.

Each edge's irrep features are rotated into a frame whose z-axis is the
edge direction; there the convolution block-diagonalizes over the
azimuthal order m, so an SO(2) linear layer replaces the full
Clebsch–Gordan contraction. The per-edge real-SH Wigner matrices come
from the ZYZ decomposition ``D(α, β, γ) = Z(α) · d(β) · Z(γ)``: ``Z`` is
the block cos/sin rotation about z, and ``d(β)``, the rotation about y, is
a sum of constant matrices times monomials,
``d^l(β) = Σ_b M_b · cos(β/2)^{2l-b} · sin(β/2)^b``.

The ``M_b`` tables are built in float64 with exact factorials by
:func:`_wigner_d_monomials`, a copy of the reference's builder (the same
arrays bit for bit). At run time they are cast to the edges' dtype
(float32 in the models) once per device.
The fp32 contraction cancels at high l (entries of ``M_b`` reach ~700 at
l = 6), so the blocks agree with the reference's within fp32 rounding of
that sum, not bit for bit.

Conventions (pinned by the tests): the l=1 block of D equals the 3×3
rotation matrix in the (y, z, x) real-SH ordering, and ``D_align(r̂)`` maps
the l=1 embedding of r̂ to that of ẑ. ``atan2(0, 0) = 0`` and z is clamped
to [-1, 1] before ``arccos``, as in the reference.
"""
from __future__ import annotations

from functools import lru_cache
from math import factorial

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.fake import faking


def num_coeffs(l_max: int) -> int:
    return (l_max + 1) ** 2


def lm_index(l: int, m: int) -> int:
    return l * l + l + m


@lru_cache(maxsize=None)
def _complex_to_real_basis(l: int) -> np.ndarray:
    """Unitary C with real coefficients c_R = C c_C (Condon–Shortley).

    Real basis ordering m = -l..l; m<0 ↔ sin(|m|φ), m>0 ↔ cos(mφ).
    """
    C = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    s2 = 1.0 / np.sqrt(2.0)
    for m in range(-l, l + 1):
        if m == 0:
            C[l, l] = 1.0
        elif m > 0:
            # Y_{l,m} = (1/√2)(Y^{-m} + (-1)^m Y^{m})
            C[m + l, -m + l] = s2
            C[m + l, m + l] = s2 * (-1.0) ** m
        else:  # m < 0
            a = -m
            # Y_{l,-a} = (i/√2)(Y^{-a} - (-1)^a Y^{a})
            C[m + l, -a + l] = 1j * s2
            C[m + l, a + l] = -1j * s2 * (-1.0) ** a
    return C


@lru_cache(maxsize=None)
def _wigner_d_monomials(l: int) -> np.ndarray:
    """M̃: (2l+1 monomials, 2l+1, 2l+1) real, real-SH basis, so that
    d_real(β) = Σ_b M̃[b] · cos(β/2)^{2l-b} · sin(β/2)^b."""
    dim = 2 * l + 1
    M = np.zeros((dim, dim, dim), dtype=np.float64)  # complex-basis (real)
    for mp in range(-l, l + 1):          # m' (row)
        for m in range(-l, l + 1):       # m (col)
            pref = np.sqrt(float(factorial(l + mp) * factorial(l - mp)
                                 * factorial(l + m) * factorial(l - m)))
            kmin = max(0, m - mp)
            kmax = min(l + m, l - mp)
            for k in range(kmin, kmax + 1):
                denom = (factorial(l + m - k) * factorial(k)
                         * factorial(l - mp - k) * factorial(mp - m + k))
                coeff = ((-1.0) ** (mp - m + k)) * pref / denom
                b = mp - m + 2 * k       # sin power; cos power = 2l - b
                M[b, mp + l, m + l] += coeff
    C = _complex_to_real_basis(l)
    Mr = np.einsum("ij,bjk,lk->bil", C, M, C.conj())
    if np.abs(Mr.imag).max() >= 1e-9:
        raise ArithmeticError(f"l={l}: imaginary part leaks into the real "
                              "basis")
    # Sign-fix the m<0 (sine) basis functions so the l=1 block of D equals
    # the 3×3 rotation matrix in (y,z,x) ordering (e3nn convention) —
    # conjugation by S = diag(-1 for m<0, +1 otherwise).
    sgn = np.where(np.arange(-l, l + 1) < 0, -1.0, 1.0)
    return np.ascontiguousarray(Mr.real * sgn[None, :, None]
                                * sgn[None, None, :])


@lru_cache(maxsize=None)
def _z_rot_indices(l_max: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Index arrays for building the block z-rotation over the full
    (l_max+1)² coefficient vector: returns (idx_m, idx_negm, m_of_row)."""
    S = num_coeffs(l_max)
    idx = np.arange(S)
    ls = np.floor(np.sqrt(idx)).astype(np.int64)
    ms = idx - ls * ls - ls
    neg = ls * ls + ls - ms
    return idx, neg, ms


def _monomials(l: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """:func:`_wigner_d_monomials` in ``dtype`` on ``device``, built once
    per (l, device, dtype) — or anew under a fake mode, whose tensors may
    not outlive it. Shared by every caller: read only."""
    if faking():
        return _new_monomials(l, device, dtype)
    return _cached_monomials(l, device, dtype)


def _new_monomials(l: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(_wigner_d_monomials(l), dtype=dtype,
                           device=device)


_cached_monomials = lru_cache(maxsize=None)(_new_monomials)


def _z_block_masks(l: int, device: torch.device, dtype: torch.dtype
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The orders ``m = -l..l``, the identity and the m ↔ -m swap (zero at
    m = 0) of one l block, in ``dtype`` on ``device``; cached as
    :func:`_monomials` is. Read only."""
    if faking():
        return _new_z_block_masks(l, device, dtype)
    return _cached_z_block_masks(l, device, dtype)


def _new_z_block_masks(l: int, device: torch.device, dtype: torch.dtype
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dim = 2 * l + 1
    idx = np.arange(dim)
    swap = np.zeros((dim, dim))
    swap[idx, dim - 1 - idx] = 1.0
    swap[l, l] = 0.0
    return (torch.arange(-l, l + 1, dtype=dtype, device=device),
            torch.eye(dim, dtype=dtype, device=device),
            torch.as_tensor(swap, dtype=dtype, device=device))


_cached_z_block_masks = lru_cache(maxsize=None)(_new_z_block_masks)


def _powers(c: torch.Tensor, s: torch.Tensor, l: int) -> torch.Tensor:
    """``(..., 2l+1)``: ``c^{2l-b} · s^b`` for b = 0..2l."""
    return torch.stack([c ** (2 * l - b) * s ** b for b in range(2 * l + 1)],
                       dim=-1)


def z_rotation(theta: torch.Tensor, l_max: int) -> torch.Tensor:
    """(..., S, S) real-SH rotation about z by theta (batched).

    Acts block-diagonally: rows with order m mix with -m via cos/sin(mθ).
    """
    idx, neg, ms = _z_rot_indices(l_max)
    S = num_coeffs(l_max)
    kw = dict(dtype=theta.dtype, device=theta.device)
    msj = torch.as_tensor(ms, **kw)
    cos = torch.cos(theta[..., None] * msj)
    sin = torch.sin(theta[..., None] * msj)
    eye_pos = torch.eye(S, **kw)
    swap = np.zeros((S, S))
    swap[idx, neg] = 1.0
    swap[idx[ms == 0], neg[ms == 0]] = 0.0
    # Row of signed order m: D[m,m] = cos(mθ), D[m,-m] = -sin(mθ) — the same
    # S-conjugated convention as the monomial tensors.
    return (cos[..., :, None] * eye_pos
            - sin[..., :, None] * torch.as_tensor(swap, **kw))


def y_rotation(beta: torch.Tensor, l_max: int) -> torch.Tensor:
    """(..., S, S) real-SH rotation about y by beta (batched), block-diag
    over l, evaluated from the monomial tensors."""
    S = num_coeffs(l_max)
    c = torch.cos(beta / 2.0)
    s = torch.sin(beta / 2.0)
    out = beta.new_zeros(beta.shape + (S, S))
    for l in range(l_max + 1):
        blk = torch.einsum("...b,bij->...ij", _powers(c, s, l),
                           _monomials(l, beta.device, beta.dtype))
        out[..., l * l:(l + 1) ** 2, l * l:(l + 1) ** 2] = blk
    return out


def _align_angles(rhat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """α = atan2(y, x) (0 for the zero vector) and β = arccos(clamp(z))."""
    x, y, z = rhat.unbind(-1)
    return torch.atan2(y, x), torch.arccos(torch.clamp(z, -1.0, 1.0))


def edge_rotations(rhat: torch.Tensor, l_max: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-edge Wigner matrices (D_align, D_inv) with D_align·emb(r̂)=emb(ẑ).

    rhat: (..., 3) unit vectors. R_align = Ry(-β)·Rz(-α) with α = atan2(y,x),
    β = arccos(z); D composes the same way in the real-SH rep.
    """
    alpha, beta = _align_angles(rhat)
    D = torch.einsum("...ij,...jk->...ik", y_rotation(-beta, l_max),
                     z_rotation(-alpha, l_max))
    return D, D.transpose(-1, -2)  # orthogonal


def edge_rotation_blocks(rhat: torch.Tensor, l_max: int
                         ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Per-l rotation blocks [(E, 2l+1, 2l+1)] — Σ(2l+1)² = 455 floats per
    edge at l_max = 6 instead of 49² for the dense matrix. ``D_inv`` blocks
    are transposed views of the ``D`` blocks."""
    alpha, beta = _align_angles(rhat)
    c = torch.cos(-beta / 2.0)
    s = torch.sin(-beta / 2.0)
    theta = -alpha
    Ds, Dinvs = [], []
    for l in range(l_max + 1):
        ms, eye, swap = _z_block_masks(l, rhat.device, rhat.dtype)
        cos = torch.cos(theta[..., None] * ms)
        sin = torch.sin(theta[..., None] * ms)
        Dz = cos[..., :, None] * eye - sin[..., :, None] * swap
        Dy = torch.einsum("...b,bij->...ij", _powers(c, s, l),
                          _monomials(l, rhat.device, rhat.dtype))
        D = torch.einsum("...ij,...jk->...ik", Dy, Dz)
        Ds.append(D)
        Dinvs.append(D.transpose(-1, -2))
    return Ds, Dinvs


def rotation_matrix_zyz(alpha: float, beta: float, gamma: float) -> np.ndarray:
    """3×3 R = Rz(α)Ry(β)Rz(γ) — test helper for convention checks."""
    ca, sa = np.cos(alpha), np.sin(alpha)
    cb, sb = np.cos(beta), np.sin(beta)
    cg, sg = np.cos(gamma), np.sin(gamma)
    Rz1 = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
    Ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    Rz2 = np.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]])
    return Rz1 @ Ry @ Rz2


def wigner_zyz(alpha, beta, gamma, l_max: int, *,
               device: str | torch.device = "cuda") -> torch.Tensor:
    """Full real-SH Wigner D(α,β,γ) = Z(α)·d(β)·Z(γ) (batched), float32
    on ``device``."""
    dev = resolve_device(device)
    a, b, g = (torch.as_tensor(v, dtype=torch.float32, device=dev)
               for v in (alpha, beta, gamma))
    return torch.einsum("...ij,...jk,...kl->...il", z_rotation(a, l_max),
                        y_rotation(b, l_max), z_rotation(g, l_max))


def l1_embedding(vec: torch.Tensor) -> torch.Tensor:
    """Real-SH l=1 embedding ordering (y, z, x) (e3nn convention)."""
    return torch.stack([vec[..., 1], vec[..., 2], vec[..., 0]], dim=-1)
