"""Plain PyTorch version of the flash-attention kernel.

Semantics are those of the Pallas body
(``src/repro/kernels/flash_attention/kernel.py::_flash_kernel``), not of
the reference's oracle ``attention_ref``:

  s    = (q·kᵀ in fp32) * scale,  scale = 1/sqrt(dh) as an fp32 factor
  mask = kv_pos < Skv, and kv_pos <= q_pos when causal (aligned top-left:
         query i sees keys 0..i whatever Skv is; ``attention_ref`` aligns
         bottom-right, ``tril(k=Skv-Sq)``, and differs when Sq != Skv)
  s    = -1e30 where masked (finite, so a row never holds NaN)
  online softmax over kv blocks of 128 in order: m_new = max(m, rowmax s),
  p = exp(s - m_new), corr = exp(m - m_new), l = l·corr + Σp,
  acc = acc·corr + p·v with p and v in fp32
  out  = acc / max(l, 1e-20), cast to q's dtype

GQA: query head ``h`` reads kv head ``h // (H/KV)``. The query heads of
one kv head are stacked as rows of one product, so K/V are never expanded.
Vectorized over (B·KV, group·Sq rows); the loop walks the kv blocks.

Empty inputs: the Pallas wrapper raises ``TypeError`` at Sq = 0 or
Skv = 0; this version returns zeros shaped like q (at Skv = 0 that is
``acc / max(l, 1e-20)`` with nothing accumulated).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
BLOCK_KV = 128  # the Pallas wrapper's default kv block
FP32_TOL = 2e-5  # rtol = atol of the reference's tests/test_kernels.py


def causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs a causal call scores: query ``i`` sees keys
    ``0..min(i, Skv-1)`` (aligned top-left, as the kernel masks)."""
    full = min(sq, skv)
    return full * (full + 1) // 2 + max(sq - skv, 0) * skv


def cost(b: int, sq: int, skv: int, h: int, kvh: int, dh: int, elem: int,
         *, causal: bool = True) -> dict:
    """The least work of one call: bytes = q and k/v read once and the
    output written once; operations = ``4·dh`` a scored (query, key) pair
    a head (q·kᵀ and p·v), over the causal pairs only when ``causal`` —
    the kernel's own work, not the plain version's full square."""
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    nbytes = (2 * b * sq * h * dh + 2 * b * skv * kvh * dh) * elem
    return {"flops": 4 * b * h * dh * pairs, "bytes": nbytes}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """q ``(B, Sq, H, dh)``; k/v ``(B, Skv, KV, dh)`` with ``H % KV == 0``.
    Returns ``(B, Sq, H, dh)`` in q's dtype.

    Raises:
        ValueError: shapes that do not pair up, or ``H % KV != 0``.
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"pair with k/v {tuple(k.shape)} (H % KV == 0)")
    if q.numel() == 0 or skv == 0:
        return torch.zeros_like(q)
    group = h // kvh
    scale = 1.0 / math.sqrt(dh)
    # (B, KV, group·Sq, dh): row r is query position r % Sq of head
    # kv·group + r // Sq
    qf = (q.float().reshape(b, sq, kvh, group, dh).permute(0, 2, 3, 1, 4)
          .reshape(b, kvh, group * sq, dh))
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    q_pos = torch.arange(sq, device=q.device).repeat(group)[:, None]
    m = torch.full((b, kvh, group * sq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    # causal: a block wholly past the last query is fully masked, and a
    # fully masked block after a valid one leaves the state unchanged
    end = min(skv, sq) if causal else skv
    for j0 in range(0, end, BLOCK_KV):
        j1 = min(j0 + BLOCK_KV, skv)
        s = (qf @ kf[:, :, j0:j1].transpose(-1, -2)) * scale
        if causal:
            kv_pos = torch.arange(j0, j1, device=q.device)[None, :]
            s = torch.where(kv_pos <= q_pos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ vf[:, :, j0:j1]
        m = m_new
    out = acc / l.clamp_min(1e-20)
    out = (out.reshape(b, kvh, group, sq, dh).permute(0, 3, 1, 2, 4)
           .reshape(b, sq, h, dh))
    return out.to(q.dtype)


def split_bf16x3(p: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel's split of fp32 ``p`` into three bf16 terms, so that
    p·v runs on bf16 tensor cores without rounding p (the products are
    exact in fp32; the tensor core's own sums are not fp32 rounding, which
    the kernel's card checks cover, not this function): ``hi = bf16(p)``,
    ``mid = bf16(p - hi)``, ``lo = bf16(p - hi - mid)``, each rounded to
    nearest even, each subtraction in fp32 (exact: the residual fits in
    fp32's significand). ``(hi + mid) + lo == p`` bit for bit for every
    ``p >= 2^-110`` (7.7037e-34: three 8-bit significands cover fp32's 24,
    and ``lo`` still reaches ``p``'s last bit, 2^-133, bf16's smallest
    subnormal); below, ``lo`` cannot hold the last bits and the error
    stays under 2^-134 (4.6e-41).
    """
    p = p.float()
    hi = p.to(torch.bfloat16)
    r = p - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at ``|x|``: ``2^(e-7)`` for ``|x|`` in
    ``[2^e, 2^(e+1))``."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)


def tolerance(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Elementwise allowance for two computations of this function that sum
    in different orders. fp32: ``FP32_TOL·(1 + |want|)``. bf16: one bf16
    ulp of the larger magnitude plus ``FP32_TOL`` — each side rounds its
    fp32 result once, and those fp32 results are within ``FP32_TOL``; an
    output that cancels to near zero can differ by more than its own ulp.
    """
    w = want.float()
    if want.dtype == torch.bfloat16:
        return bf16_ulp(torch.maximum(got.float().abs(), w.abs())) + FP32_TOL
    return FP32_TOL * (1.0 + w.abs())


def within_tolerance(got: torch.Tensor, want: torch.Tensor) -> bool:
    """``|got - want| <= tolerance(got, want)`` everywhere."""
    return bool(((got.float() - want.float()).abs()
                 <= tolerance(got, want)).all())
