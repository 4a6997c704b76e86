"""Attention pieces of the decoder LM: RoPE, GQA expansion and single-token
decode attention (``src/repro/models/attention.py``).

The prefill's causal attention is the ``flash_attention`` kernel
(:mod:`repro_torch.kernels.flash_attention`), called by the transformer
where the reference calls ``blockwise_attention``; the two compute the same
contraction (``tests/test_kernels.py::test_blockwise_attention_matches_
flash``). ``blockwise_attention`` itself, with its ``q_offset``, is not
ported: no caller in the reference passes an offset (ROADMAP A11).
"""
from __future__ import annotations

import math

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 1e6) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of ``positions · θ^(-i/half)``, ``i < head_dim/2``, in fp32;
    shaped ``positions.shape + (head_dim/2,)``."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x ``(..., S, H, dh)``; cos/sin ``(..., S, dh/2)`` broadcast over
    heads. Rotates the two halves (not interleaved pairs) in fp32 by type
    promotion and returns x's dtype."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


def _expand_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """``(B, S, KV, dh)`` → ``(B, S, KV·n_rep, dh)``, each kv head repeated
    for the ``n_rep`` query heads that read it."""
    if n_rep == 1:
        return k
    b, s, kh, dh = k.shape
    return (k[:, :, :, None, :].expand(b, s, kh, n_rep, dh)
            .reshape(b, s, kh * n_rep, dh))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Single-position decode. q ``(B, 1, H, dh)``; caches ``(B, S, KV,
    dh)``; ``cache_len`` valid positions (the new token's included).

    As the reference: q is cast to the cache's dtype, scores are summed in
    fp32 and divided by ``sqrt(dh)``, positions ≥ ``cache_len`` are masked
    with ``-inf``, the softmax is fp32, ``p`` is cast to v's dtype and
    ``p·v`` is summed in fp32, then cast to q's dtype. The reference's
    products take bf16 operands with fp32 accumulation; PyTorch has no
    such product, so the operands are upcast to fp32 first: bf16·bf16 is
    exact in fp32, so only the summation order differs.
    """
    h, dh = q.shape[2], q.shape[3]
    skv, kh = k_cache.shape[1], k_cache.shape[2]
    k = _expand_kv(k_cache, h // kh)
    v = _expand_kv(v_cache, h // kh)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(k.dtype).float(),
                     k.float()) / math.sqrt(dh)
    mask = torch.arange(skv, device=q.device) < cache_len
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
