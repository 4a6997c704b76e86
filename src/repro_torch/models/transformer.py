"""Decoder-only LM serving on PyTorch: GQA + RoPE (+ optional QKV bias /
qk-norm), SwiGLU FFN, RMSNorm — the dense branch of
``src/repro/models/transformer.py``, prefill then decode.

Covers the dense LM configurations of the reference:
  qwen1.5-4b / codeqwen1.5-7b  — QKV bias, MHA-style GQA (kv == heads)
  qwen3-4b                     — qk-norm, GQA kv=8, head_dim 128 (H·dh ≠ d)
The MoE FFN (``models/moe.py``; deepseek-moe-16b, phi3.5-moe-42b) is not
ported: a config with ``moe`` set raises (ROADMAP A11). Training
(``lm_forward``/``lm_loss``) waits for a backward of the attention kernel.

Layout is the reference's: weights are ``(d_in, d_out)`` and applied as
``x @ w``, cast to the activation dtype; the cache is ``(L, B, S, KV,
dh)`` in bf16. The prefill's causal attention is the ``flash_attention``
kernel, one launch per layer, where the reference calls
``blockwise_attention``. A layer is a Python loop over :class:`LMBlock`
modules, not a ``scan``. Serving runs under ``torch.no_grad``, and the
decode step writes the new position into the cache in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.attention import (apply_rope, decode_attention,
                                          rope_angles)
from repro_torch.models.common import RMSNorm, rms_norm

CACHE_DTYPE = torch.bfloat16  # the reference stores the KV cache in bf16


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig``. Its ``q_chunk``/``kv_chunk`` tile
    ``blockwise_attention``; the port's kernel has fixed tiles, so they are
    not carried. ``moe`` is kept so that an MoE config is refused."""
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    qkv_bias: bool = False
    qk_norm: bool = False
    moe: Optional[Any] = None
    rope_theta: float = 1e6
    dtype: str = "float32"           # activation/compute dtype

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _require_dense(cfg: LMConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            "the MoE FFN (models/moe.py) is not ported yet (ROADMAP A11); "
            "only dense LM configs run")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class LMBlock(nn.Module):
    """One decoder layer: ``ln1``, ``wq/wk/wv/wo`` (+ ``bq/bk/bv`` with QKV
    bias, ``q_norm/k_norm`` with qk-norm), ``ln2``, SwiGLU ``w1/w3/w2``."""

    def __init__(self, cfg: LMConfig, *, dtype: torch.dtype, device=None):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
        self.cfg = cfg
        self.ln1 = RMSNorm(d, dtype=dtype, device=device)
        self.wq = _param((d, h * dh), dtype, device)
        self.wk = _param((d, kv * dh), dtype, device)
        self.wv = _param((d, kv * dh), dtype, device)
        self.wo = _param((h * dh, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((h * dh,), dtype, device)
            self.bk = _param((kv * dh,), dtype, device)
            self.bv = _param((kv * dh,), dtype, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(dh, dtype=dtype, device=device)
            self.k_norm = RMSNorm(dh, dtype=dtype, device=device)
        self.ln2 = RMSNorm(d, dtype=dtype, device=device)
        self.w1 = _param((d, cfg.d_ff), dtype, device)
        self.w3 = _param((d, cfg.d_ff), dtype, device)
        self.w2 = _param((cfg.d_ff, d), dtype, device)

    def qkv(self, h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """h ``(B, S, d)`` → q ``(B, S, H, dh)``, k/v ``(B, S, KV, dh)``,
        normed and rotated as the reference's ``_attn``."""
        cfg = self.cfg
        b, s, _ = h.shape
        x = self.ln1(h)
        q = x @ self.wq.to(x.dtype)
        k = x @ self.wk.to(x.dtype)
        v = x @ self.wv.to(x.dtype)
        if cfg.qkv_bias:
            q = q + self.bq.to(q.dtype)
            k = k + self.bk.to(k.dtype)
            v = v + self.bv.to(v.dtype)
        q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = k.reshape(b, s, cfg.n_kv, cfg.head_dim)
        v = v.reshape(b, s, cfg.n_kv, cfg.head_dim)
        if cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def out(self, h: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """Residual add of the attention output ``o (B, S, H, dh)``."""
        b, s = o.shape[:2]
        return h + o.reshape(b, s, -1) @ self.wo.to(o.dtype)

    def ffn(self, h: torch.Tensor) -> torch.Tensor:
        """The reference's ``_ffn``, dense branch, with its residual add."""
        x = self.ln2(h)
        g = F.silu(x @ self.w1.to(x.dtype))
        u = x @ self.w3.to(x.dtype)
        return h + (g * u) @ self.w2.to(x.dtype)


class LM(nn.Module):
    """``embed (V, d)``, one :class:`LMBlock` per layer, ``final_ln`` and
    ``unembed (d, V)``. Parameters are allocated, not initialised: use
    :func:`lm_init` or :func:`lm_from_numpy`."""

    def __init__(self, cfg: LMConfig, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        _require_dense(cfg)
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.d_model), dtype, device)
        self.unembed = _param((cfg.d_model, cfg.vocab), dtype, device)
        self.final_ln = RMSNorm(cfg.d_model, dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            LMBlock(cfg, dtype=dtype, device=device)
            for _ in range(cfg.n_layers))


@torch.no_grad()
def lm_init(generator: torch.Generator, cfg: LMConfig,
            dtype: torch.dtype = torch.float32) -> LM:
    """An :class:`LM` on ``generator``'s device with the reference's
    distributions (``lm_init``, dense branch): ``embed ~ N(0, 0.02²)``,
    ``unembed``, ``wq/wk/wv/w1/w3 ~ N(0, 1/d)``, ``wo ~ N(0, 1/(H·dh))``,
    ``w2 ~ N(0, 1/d_ff)``, unit norm gains, zero biases. Each weight is
    drawn in ``dtype`` and then scaled, as the reference does."""
    model = LM(cfg, dtype=dtype, device=generator.device)
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim

    def normal(p: torch.Tensor, scale: float) -> None:
        p.normal_(generator=generator).mul_(scale)

    normal(model.embed, 0.02)
    normal(model.unembed, 1.0 / math.sqrt(d))
    scales = {"wq": 1.0 / math.sqrt(d), "wk": 1.0 / math.sqrt(d),
              "wv": 1.0 / math.sqrt(d), "wo": 1.0 / math.sqrt(h * dh),
              "w1": 1.0 / math.sqrt(d), "w3": 1.0 / math.sqrt(d),
              "w2": 1.0 / math.sqrt(cfg.d_ff)}
    for name, scale in scales.items():  # one weight kind at a time
        for blk in model.layers:
            normal(getattr(blk, name), scale)
    for name, p in model.named_parameters():
        if name.endswith(".weight"):    # RMSNorm gains
            p.fill_(1.0)
        elif name.split(".")[-1] in ("bq", "bk", "bv"):
            p.zero_()
    return model


@torch.no_grad()
def lm_from_numpy(params: dict, cfg: LMConfig, *,
                  dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cuda") -> LM:
    """The reference's ``lm_init`` dict (``embed``, ``unembed``,
    ``final_ln`` and ``layers`` of stacked ``(L, …)`` arrays, weights
    ``(d_in, d_out)``) → :class:`LM` in ``dtype`` on ``device`` (the card
    unless the caller asks for the CPU)."""
    model = LM(cfg, dtype=dtype, device=resolve_device(device))

    def put(p: torch.Tensor, arr) -> None:
        p.copy_(torch.tensor(np.asarray(arr, dtype=np.float32)))

    put(model.embed, params["embed"])
    put(model.unembed, params["unembed"])
    put(model.final_ln.weight, params["final_ln"])
    lay = params["layers"]
    for i, blk in enumerate(model.layers):
        for name in ("ln1", "ln2", "q_norm", "k_norm"):
            if hasattr(blk, name):
                put(getattr(blk, name).weight, lay[name][i])
        for name in ("wq", "wk", "wv", "wo", "w1", "w3", "w2", "bq", "bk",
                     "bv"):
            if hasattr(blk, name):
                put(getattr(blk, name), lay[name][i])
    return model


def _rope(positions: torch.Tensor, cfg: LMConfig):
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return cos[None], sin[None]


def _logits(model: LM, h_last: torch.Tensor) -> torch.Tensor:
    """Final norm of the last position and the unembedding, in the
    activation dtype, returned as fp32 (the reference norms every position
    and keeps the last; the norm is per position)."""
    x = rms_norm(h_last, model.final_ln.weight)
    return (x @ model.unembed.to(x.dtype)).float()


@torch.no_grad()
def lm_prefill(model: LM, tokens: torch.Tensor, cfg: LMConfig
               ) -> tuple[torch.Tensor, dict]:
    """Prefill: run the full prompt ``tokens (B, S)``; return the
    last-position logits ``(B, V)`` in fp32 and the KV cache
    ``{"k", "v"}``, each ``(L, B, S, KV, dh)`` in bf16 (k after qk-norm
    and RoPE). Each layer's attention is one ``flash_attention`` call."""
    _require_dense(cfg)
    b, s = tokens.shape
    h = model.embed[tokens].to(cfg.adtype)
    cos, sin = _rope(torch.arange(s, device=tokens.device), cfg)
    shape = (cfg.n_layers, b, s, cfg.n_kv, cfg.head_dim)
    cache = {"k": torch.empty(shape, dtype=CACHE_DTYPE, device=h.device),
             "v": torch.empty(shape, dtype=CACHE_DTYPE, device=h.device)}
    for i, blk in enumerate(model.layers):
        q, k, v = blk.qkv(h, cos, sin)
        h = blk.out(h, flash_ops.flash_attention(q, k, v, causal=True))
        h = blk.ffn(h)
        cache["k"][i] = k
        cache["v"][i] = v
    return _logits(model, h[:, -1]), cache


@torch.no_grad()
def lm_decode_step(model: LM, token: torch.Tensor, cache: dict,
                   cache_len: int, cfg: LMConfig
                   ) -> tuple[torch.Tensor, dict]:
    """One serving step: ``token (B, 1)`` + KV cache → ``(logits (B, V)
    fp32, cache)``. ``cache`` is ``{"k", "v"}`` of ``(L, B, S_max, KV,
    dh)``; ``cache_len`` is the new token's position + 1. The new k/v are
    written at ``cache_len - 1`` in place (cast to the cache's dtype) and
    the same dict is returned."""
    _require_dense(cfg)
    b = token.shape[0]
    h = model.embed[token].to(cfg.adtype)
    cos, sin = _rope(torch.tensor([cache_len - 1], device=token.device), cfg)
    for i, blk in enumerate(model.layers):
        q, k, v = blk.qkv(h, cos, sin)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, cache_len - 1] = k[:, 0]
        vc[:, cache_len - 1] = v[:, 0]
        h = blk.out(h, decode_attention(q, kc, vc, cache_len))
        h = blk.ffn(h)
    return _logits(model, h[:, 0]), cache


def init_decode_cache(cfg: LMConfig, batch: int, max_len: int,
                      dtype: torch.dtype = CACHE_DTYPE,
                      device: str | torch.device = "cuda") -> dict:
    """Zeroed ``{"k", "v"}``, each ``(L, batch, max_len, KV, dh)``, on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def lm_param_count(cfg: LMConfig) -> int:
    """The reference's formula: embeddings, final norm, and per layer the
    attention and FFN weights and two norm gains (qk-norm gains and QKV
    biases are not counted)."""
    _require_dense(cfg)
    d, h, kv, dh, L = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                       cfg.n_layers)
    attn = d * h * dh + 2 * d * kv * dh + h * dh * d
    ffn = 3 * d * cfg.d_ff
    return 2 * cfg.vocab * d + d + L * (attn + ffn + 2 * d)


def lm_active_param_count(cfg: LMConfig) -> int:
    """Parameters a token touches: all of them for a dense config."""
    return lm_param_count(cfg)
