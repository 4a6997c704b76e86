"""Attention pieces of the decoder LM (``src/repro/models/attention.py``):
RoPE, GQA expansion, single-token decode attention, the training path's
:func:`blockwise_attention` and the naive :func:`reference_attention`.

Serving's prefill attention is the ``flash_attention`` kernel
(:mod:`repro_torch.kernels.flash_attention`), called by the transformer
where the reference calls ``blockwise_attention``; the two compute the same
contraction (``tests/test_kernels.py::test_blockwise_attention_matches_
flash``). Training goes through :func:`blockwise_attention`, as the
reference trains: the kernel has no backward, and its fp32 ``p`` is not
the reference's bf16 one.

:func:`blockwise_attention` is the reference's arithmetic, block by block:
q chunks of ``q_chunk`` rows against kv chunks of ``kv_chunk`` keys, fp32
scores from the operands' dtype (bf16 products are exact in fp32; only the
summation order differs), ``-inf`` masks with the ``isfinite`` guards, an
online softmax, and ``p`` cast to v's dtype before ``p·v`` (bf16 when
training in bf16). It is an ``autograd.Function`` whose backward recomputes
each block from the saved q, k, v, the fp32 output and the row
log-sum-exp, so no block's scores or probabilities are kept (a full S² fp32
tensor a head is ~2.1 GB at qwen3-4b's 4,096 positions and 32 heads). A
block that the causal mask covers entirely leaves the running (o, m, l)
exactly as they were in the reference (``p`` is 0, the correction 1, or
0 on a row that has seen nothing), so both passes skip it: about half the
blocks at full causal length.
"""
from __future__ import annotations

import math

import numpy as np
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


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype: fp64 for fp64 inputs (an fp64 witness),
    else fp32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed in fp32 (fp64 for fp64 operands). On the card two
    bf16 operands go to a bf16 product with an fp32 result (the
    reference's ``preferred_element_type=f32``); otherwise the operands
    are upcast, which is exact for bf16, so the two differ only in
    summation order."""
    if (a.device.type == "cuda" and a.dtype == b.dtype == torch.bfloat16):
        return torch.bmm(a, b, out_dtype=torch.float32)
    acc = _acc(a.dtype)
    return torch.matmul(a.to(acc), b.to(acc))


def _chunks(sq: int, skv: int, q_chunk: int, kv_chunk: int
            ) -> tuple[int, int, int, int]:
    """The reference's chunking: chunk sizes cut to the lengths, and the
    numbers of chunks (the last ones padded)."""
    qc, kc = min(q_chunk, sq), min(kv_chunk, skv)
    return qc, kc, -(-sq // qc), -(-skv // kc)


def _skip(i: int, j: int, qc: int, kc: int, q_offset: int,
          causal: bool) -> bool:
    """Whether the causal mask covers block (i, j) entirely: its first key
    lies past its last (padded) query's position."""
    return causal and j * kc > (i + 1) * qc - 1 + q_offset


def _block_scores(q_i: torch.Tensor, k_j: torch.Tensor, i: int, j: int,
                  qc: int, kc: int, skv: int, q_offset: int, causal: bool,
                  scale: float) -> torch.Tensor:
    """fp32 scores ``(q·kᵀ)·scale`` of block (i, j), ``-inf`` on padded
    keys and, causally, where key > query + ``q_offset``."""
    s = _mm32(q_i, k_j.transpose(-1, -2)) * scale
    dev = s.device
    kv_pos = torch.arange(j * kc, (j + 1) * kc, device=dev)
    mask = (kv_pos < skv)[None, :]
    if causal:
        q_pos = torch.arange(i * qc, (i + 1) * qc, device=dev) + q_offset
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    return s.masked_fill(~mask, float("-inf"))


def _pad_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """``(B, S, H, dh)`` → ``(B·H, n, dh)`` contiguous, zero rows past S."""
    b, s, h, dh = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b * h, s, dh)
    if n > s:
        x = torch.cat([x, x.new_zeros((b * h, n - s, dh))], 1)
    return x.contiguous()


class BlockwiseAttention(torch.autograd.Function):
    """:func:`blockwise_attention` on expanded heads: q, k, v ``(B, S, H,
    dh)`` in one dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk, q_offset):
        b, sq, h, dh = q.shape
        skv = k.shape[1]
        qc, kc, nq, nkv = _chunks(sq, skv, q_chunk, kv_chunk)
        scale = float(np.float32(1.0 / np.sqrt(dh)))
        qp, kp, vp = (_pad_heads(q, nq * qc), _pad_heads(k, nkv * kc),
                      _pad_heads(v, nkv * kc))
        out = qp.new_empty(qp.shape, dtype=_acc(q.dtype))
        lse = qp.new_empty(qp.shape[:2], dtype=_acc(q.dtype))
        for i in range(nq):
            q_i = qp[:, i * qc:(i + 1) * qc]
            o = out.new_zeros((b * h, qc, dh))
            m = out.new_full((b * h, qc), float("-inf"))
            l = out.new_zeros((b * h, qc))
            for j in range(nkv):
                if _skip(i, j, qc, kc, q_offset, causal):
                    continue
                s = _block_scores(q_i, kp[:, j * kc:(j + 1) * kc], i, j, qc,
                                  kc, skv, q_offset, causal, scale)
                m_new = torch.maximum(m, s.amax(-1))
                m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
                p = torch.exp(s - m_safe[..., None])
                corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                             float("-inf")))
                l = l * corr + p.sum(-1)
                o = o * corr[..., None] + _mm32(
                    p.to(v.dtype), vp[:, j * kc:(j + 1) * kc])
                m = m_new
            out[:, i * qc:(i + 1) * qc] = o / torch.clamp_min(l, 1e-20)[
                ..., None]
            lse[:, i * qc:(i + 1) * qc] = m + torch.log(l)
        ctx.save_for_backward(qp, kp, vp, out, lse)
        ctx.args = (b, sq, skv, h, dh, qc, kc, nq, nkv, causal, q_offset,
                    scale)
        res = out[:, :sq].reshape(b, h, sq, dh).permute(0, 2, 1, 3)
        return res.to(q.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        qp, kp, vp, out, lse = ctx.saved_tensors
        (b, sq, skv, h, dh, qc, kc, nq, nkv, causal, q_offset,
         scale) = ctx.args
        do = _pad_heads(grad_out.to(qp.dtype), nq * qc)
        # D = rowsum(dO ⊙ O), O the fp32 output before its cast
        dsum = (do.to(out.dtype) * out).sum(-1)
        # a row that saw no key has lse -inf and zero gradient
        lse = torch.where(torch.isfinite(lse), lse, float("inf"))
        dq = torch.zeros_like(out)
        dk = kp.new_zeros(kp.shape, dtype=out.dtype)
        dv = torch.zeros_like(dk)
        for i in range(nq):
            rows = slice(i * qc, (i + 1) * qc)
            q_i, do_i = qp[:, rows], do[:, rows]
            for j in range(nkv):
                if _skip(i, j, qc, kc, q_offset, causal):
                    continue
                cols = slice(j * kc, (j + 1) * kc)
                k_j, v_j = kp[:, cols], vp[:, cols]
                s = _block_scores(q_i, k_j, i, j, qc, kc, skv, q_offset,
                                  causal, scale)
                p = torch.exp(s - lse[:, rows, None])
                dv[:, cols] += _mm32(p.to(vp.dtype).transpose(-1, -2), do_i)
                dp = _mm32(do_i, v_j.transpose(-1, -2))
                ds = p * (dp - dsum[:, rows, None]) * scale
                dq[:, rows] += torch.matmul(ds, k_j.to(ds.dtype))
                dk[:, cols] += torch.matmul(ds.transpose(-1, -2),
                                            q_i.to(ds.dtype))

        def unpad(g, n):
            return (g[:, :n].reshape(b, h, n, dh).permute(0, 2, 1, 3)
                    .to(qp.dtype))

        return (unpad(dq, sq), unpad(dk, skv), unpad(dv, skv), None, None,
                None, None)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_chunk: int = 512,
                        kv_chunk: int = 1024,
                        q_offset: int = 0) -> torch.Tensor:
    """q ``(B, Sq, H, dh)``; k, v ``(B, Skv, KV, dh)`` with ``H % KV ==
    0`` → ``(B, Sq, H, dh)`` in q's dtype. Online softmax over kv chunks
    (module docstring); the causal mask uses absolute positions: query
    ``i`` attends key ``j`` iff ``j <= i + q_offset``. A query that
    attends no key gets zeros. Differentiable in q, k and v."""
    h, kh = q.shape[2], k.shape[2]
    k = _expand_kv(k, h // kh)
    v = _expand_kv(v, h // kh)
    return BlockwiseAttention.apply(q, k, v, causal, q_chunk, kv_chunk,
                                    q_offset)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        q_offset: int = 0) -> torch.Tensor:
    """Naive O(S²) oracle for tests (the reference's): fp32 scores over
    ``sqrt(dh)``, the causal mask with ``q_offset``, softmax, ``p·v`` in
    fp32, cast to q's dtype."""
    h, kh = q.shape[2], k.shape[2]
    k = _expand_kv(k, h // kh)
    v = _expand_kv(v, h // kh)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float()) / math.sqrt(q.shape[-1])
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        mask = (torch.arange(skv, device=q.device)[None, :]
                <= (torch.arange(sq, device=q.device) + q_offset)[:, None])
        s = s.masked_fill(~mask[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


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
