"""Decoder-only LM on PyTorch: GQA + RoPE (+ optional QKV bias / qk-norm),
SwiGLU or MoE FFN, RMSNorm — ``src/repro/models/transformer.py``: serving
(prefill then decode) and training (``lm_forward``, ``lm_loss``).

Covers the LM configurations of the reference:
  qwen1.5-4b / codeqwen1.5-7b  — QKV bias, MHA-style GQA (kv == heads)
  qwen3-4b                     — qk-norm, GQA kv=8, head_dim 128 (H·dh ≠ d)
  deepseek-moe-16b             — MoE (64 experts top-6 + 2 shared)
  phi3.5-moe-42b               — MoE (16 experts top-2), GQA kv=8
With ``cfg.moe`` set, each layer's FFN is a :class:`~repro_torch.models.
moe.MoE` over the layer's ``B·S`` tokens, and each call's router stats
stay readable as that module's ``last_stats``. An :class:`LM` built on a
mesh (``lm_init(..., mesh=)``) splits each MoE layer's experts over it by
the reference's ``"expert"`` rule and keeps the rest, the KV cache
included, on the home device; ``lm_prefill`` and ``lm_decode_step`` are
the same functions either way.

Layout is the reference's: weights are ``(d_in, d_out)`` and applied as
``x @ w``, cast to the activation dtype; the cache is ``(L, B, S, KV,
dh)`` in bf16. The prefill's causal attention is the ``flash_attention``
kernel, one launch per layer, where the reference calls
``blockwise_attention``. A layer is a Python loop over :class:`LMBlock`
modules, not a ``scan``. Serving runs under ``torch.no_grad``, and the
decode step writes the new position into the cache in place.

Training is the reference's arithmetic with its memory discipline kept on
one card: :func:`lm_forward` runs each layer under ``torch.utils.
checkpoint`` (the reference's ``nothing_saveable`` remat: only each
layer's input is kept, and the layer is recomputed in the backward), its
attention is :func:`~repro_torch.models.attention.blockwise_attention`
(recomputing backward, not the serving kernel); :func:`lm_loss` takes the
logits in the activation dtype, then fp32, then log-sum-exp minus the
target logit, per position, in chunks of ``LOSS_CHUNK`` positions whose
logits are recomputed in the backward (:class:`ChunkedCrossEntropy`), so
the full ``(B·S, V)`` fp32 logits and their gradient (7.5 GB at qwen3-4b's
4,096 positions) are never resident at once. The embedding rows are
gathered from the fp32 table and then cast (the reference casts the table,
then gathers: the same values, and the gradient is summed in fp32). An
LM too large for one card trains over a ``("data", "model")`` mesh of
cards (``LM(mesh=, rules=)``): a dense one tensor-parallel with ZeRO-1
state (:mod:`repro_torch.models.tensor_parallel`), an MoE by the
reference's full FSDP (:mod:`repro_torch.models.fsdp`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.attention import (apply_rope, blockwise_attention,
                                          decode_attention, rope_angles)
from repro_torch.models.common import RMSNorm, rms_norm
from repro_torch.models.moe import (MoE, MoEConfig, gather_experts,
                                    init_moe_, load_moe_, moe_draws)
from repro_torch.models.tensor_parallel import TPShard, tp_plan
from repro_torch.sharding import Rules, block_slices, device_blocks

CACHE_DTYPE = torch.bfloat16  # the reference stores the KV cache in bf16
# blockwise_attention's chunks in training: the reference LMConfig's
# defaults (its smoke reduction uses 32 and 32: lm_common.SMOKE_CHUNKS)
Q_CHUNK, KV_CHUNK = 512, 1024
LOSS_CHUNK = 512   # positions a cross-entropy chunk (its logits recomputed)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig``. Its ``q_chunk``/``kv_chunk`` tile
    ``blockwise_attention``; serving's kernel has fixed tiles, so they are
    not carried, and training takes them as arguments (``Q_CHUNK``,
    ``KV_CHUNK`` by default)."""
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    qkv_bias: bool = False
    qk_norm: bool = False
    moe: Optional[MoEConfig] = None
    rope_theta: float = 1e6
    dtype: str = "float32"           # activation/compute dtype

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class LMBlock(nn.Module):
    """One decoder layer: ``ln1``, ``wq/wk/wv/wo`` (+ ``bq/bk/bv`` with QKV
    bias, ``q_norm/k_norm`` with qk-norm), ``ln2``, and SwiGLU ``w1/w3/w2``
    or, with ``cfg.moe``, a :class:`MoE` ``moe`` (its experts split over
    ``mesh`` by ``rules`` when given)."""

    def __init__(self, cfg: LMConfig, *, dtype: torch.dtype, device=None,
                 mesh=None, rules=None):
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
        if cfg.moe is None:
            self.w1 = _param((d, cfg.d_ff), dtype, device)
            self.w3 = _param((d, cfg.d_ff), dtype, device)
            self.w2 = _param((cfg.d_ff, d), dtype, device)
        else:
            self.moe = MoE(d, cfg.moe, dtype=dtype, device=device,
                           mesh=mesh, rules=rules)

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
        """The reference's ``_ffn`` with its residual add: the MoE over the
        ``(B·S, d)`` tokens (stats kept in ``moe.last_stats``), or the
        dense SwiGLU."""
        x = self.ln2(h)
        if self.cfg.moe is not None:
            b, s, d = x.shape
            return h + self.moe(x.reshape(b * s, d)).reshape(b, s, d)
        g = F.silu(x @ self.w1.to(x.dtype))
        u = x @ self.w3.to(x.dtype)
        return h + (g * u) @ self.w2.to(x.dtype)

    def train_forward(self, h: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, q_chunk: int, kv_chunk: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """One layer of :func:`lm_forward`: causal
        :func:`~repro_torch.models.attention.blockwise_attention`, then the
        FFN. Returns the new residual stream and the layer's aux loss
        (the MoE router's, else 0), fp32."""
        q, k, v = self.qkv(h, cos, sin)
        h = self.out(h, blockwise_attention(q, k, v, causal=True,
                                            q_chunk=q_chunk,
                                            kv_chunk=kv_chunk))
        h = self.ffn(h)
        aux = (self.moe.last_stats["aux_loss"] if self.cfg.moe is not None
               else torch.zeros((), dtype=torch.float32, device=h.device))
        return h, aux


def serve_rules(mesh, cfg: LMConfig):
    """The rules an LM's experts are split by on ``mesh``: the reference's
    ``lm_rules(mesh, "prefill_32k", cfg)``, whose ``"expert"`` is the
    mesh's ``"model"`` axis."""
    from repro_torch.configs.lm_common import lm_rules  # imports this module
    if "model" not in mesh.shape:
        raise ValueError(f"an LM's mesh is one axis named 'model', not "
                         f"{tuple(mesh.shape)}")
    return lm_rules(mesh, "prefill_32k", cfg)


class LM(nn.Module):
    """``embed (V, d)``, one :class:`LMBlock` per layer, ``final_ln`` and
    ``unembed (d, V)``. Parameters are allocated, not initialised: use
    :func:`lm_init` or :func:`lm_from_numpy`.

    With a ``mesh`` and no ``rules`` (one axis, ``"model"``;
    :func:`~repro_torch.launch.mesh.make_host_mesh`), each MoE layer's
    experts are split over it by :func:`serve_rules` and everything else
    lives on ``device``, the home device, which defaults to
    ``mesh.devices[0]``.

    With a ``mesh`` and ``rules`` (a train mesh, ``("data", "model")``;
    ``lm_common.train_rules``), shard ``i`` holds, on ``mesh.devices[i]``,
    its block of every weight under ``lm_param_specs(cfg, mesh, rules)``
    (:func:`param_blocks`) as ``shards[i]``, a :class:`~repro_torch.
    models.tensor_parallel.TPShard` whose parameters carry this class's
    names: a dense LM's ZeRO-1 blocks, tensor-parallel
    (:mod:`repro_torch.models.tensor_parallel`), or an MoE's full-FSDP
    blocks (:mod:`repro_torch.models.fsdp`), whose plan is that of the
    blocks gathered over ``"data"``; it then also keeps ``replicas``
    (each model coordinate's data replicas), ``expert_ranges`` (the
    experts each model coordinate runs) and ``moe_stats`` (each layer's
    router stats of the last forward). Such an LM trains
    (``lm_common.train_step``); it does not serve."""

    def __init__(self, cfg: LMConfig, *, dtype: torch.dtype = torch.float32,
                 device=None, mesh=None, rules=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.tensor_parallel = rules is not None
        if rules is not None:
            if mesh is None:
                raise ValueError("a tensor-parallel LM lives on a mesh")
            self.blocks = param_blocks(cfg, mesh, rules)
            self.shards = nn.ModuleList(
                TPShard({name: tuple(hi - lo for lo, hi in blocks[i])
                         for name, (_, blocks) in self.blocks.items()},
                        cfg.n_layers, dtype=dtype, device=dev)
                for i, dev in enumerate(mesh.devices))
            self.groups = mesh.axis_groups("model")
            gathered = self.blocks
            if cfg.moe is not None:     # the plan of the blocks gathered
                gathered = param_blocks(cfg, mesh, Rules(  # over "data"
                    {**rules.table, "fsdp": None}))
                self.replicas = mesh.axis_groups("data")
                self.expert_ranges = _expert_ranges(
                    [self.blocks["layers.0.moe.w1"][1][r[0]][0]
                     for r in self.replicas], cfg.moe.num_experts)
                self.moe_stats: dict[int, dict] = {}
            self.plan = tp_plan(cfg, {n: b for n, (_, b) in
                                      gathered.items()}, self.groups)
            return
        if mesh is not None:
            rules = serve_rules(mesh, cfg)
            if device is None:
                device = mesh.devices[0]
        self.embed = _param((cfg.vocab, cfg.d_model), dtype, device)
        self.unembed = _param((cfg.d_model, cfg.vocab), dtype, device)
        self.final_ln = RMSNorm(cfg.d_model, dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            LMBlock(cfg, dtype=dtype, device=device, mesh=mesh, rules=rules)
            for _ in range(cfg.n_layers))

    def group(self, g: int) -> list:
        """A tensor-parallel LM's data group ``g``: its model shards, in
        model order."""
        return [self.shards[i] for i in self.groups[g]]

    def full_like(self, name: str) -> torch.Tensor:
        """Where a whole parameter ``name`` is written: the parameter
        itself, or on a train mesh an uninitialised whole tensor on the
        home device (then :meth:`load_full`)."""
        if not self.tensor_parallel:
            return self.get_parameter(name)
        p = self.shards[0].get_parameter(name)
        return torch.empty(self.blocks[name][0], dtype=p.dtype,
                           device=p.device)

    @torch.no_grad()
    def load_full(self, name: str, full: torch.Tensor) -> None:
        """Write the whole parameter ``name``: each shard's block of it on a
        train mesh, else the parameter (nothing when ``full`` is it)."""
        if not self.tensor_parallel:
            p = self.get_parameter(name)
            if full is not p:
                p.copy_(full)
            return
        for sh, block in zip(self.shards, self.blocks[name][1]):
            sh.get_parameter(name).copy_(full[block_slices(block)])


def _expert_ranges(held: list, experts: int) -> list[tuple[int, int]]:
    """The experts each model coordinate runs, from the experts its
    shards ``held``: those, where they split ``[0, E)`` in order; else
    (``"expert"`` unbound, every coordinate holding them all) all on
    coordinate 0."""
    ends = [0] + [hi for _, hi in held]
    if [lo for lo, _ in held] == ends[:-1] and ends[-1] == experts:
        return list(held)
    return [(0, experts)] + [(experts, experts)] * (len(held) - 1)


def param_blocks(cfg: LMConfig, mesh, rules) -> dict[str, tuple]:
    """``{name: (shape, blocks)}`` for every parameter of an :class:`LM`
    without a mesh (its names, order and shapes, on the ``meta`` device:
    nothing is allocated): each shard's block of it under the reference's
    ``lm_param_specs(cfg, mesh, rules)``
    (:func:`~repro_torch.sharding.device_blocks`). Reads only
    ``mesh.shape``."""
    from repro_torch.configs.lm_common import (lm_param_spec_of,
                                               lm_param_specs)
    specs = lm_param_specs(cfg, mesh, rules)
    out = {}
    for name, p in LM(cfg, device="meta").named_parameters():
        shape = tuple(p.shape)
        out[name] = (shape, device_blocks(mesh, lm_param_spec_of(name, specs),
                                          shape))
    return out


def _home(device, mesh) -> torch.device:
    """``device``, which must be ``mesh``'s home device when a mesh is
    given."""
    device = torch.device(device)
    if mesh is not None and (device.type, device.index or 0) != (
            mesh.devices[0].type, mesh.devices[0].index or 0):
        raise ValueError(f"the home device {device} is not the mesh's "
                         f"first, {mesh.devices[0]}")
    return device


@torch.no_grad()
def lm_init(generator: torch.Generator, cfg: LMConfig,
            dtype: torch.dtype = torch.float32, *, mesh=None,
            rules=None) -> LM:
    """An :class:`LM` on ``generator``'s device with the reference's
    distributions (``lm_init``): ``embed ~ N(0, 0.02²)``, ``unembed``,
    ``wq/wk/wv/w1/w3 ~ N(0, 1/d)``, ``wo ~ N(0, 1/(H·dh))``, ``w2 ~ N(0,
    1/d_ff)``, unit norm gains, zero biases; with ``cfg.moe`` each layer
    draws its own experts (:func:`~repro_torch.models.moe.init_moe_`; the
    router in fp32). Each weight is drawn in its dtype and then scaled, as
    the reference does.

    With ``mesh`` (its home device the generator's), each MoE layer's
    experts are split over it as they are drawn, or with ``rules`` each
    weight is split into its shards' blocks (:class:`LM`; an MoE's in
    ``init_moe_``'s order, layer by layer): a whole weight exists only
    while it is handed out, one at a time, and the weights are bit for
    bit those of ``lm_init`` without a mesh on the same device
    (:func:`gathered_state_dict`)."""
    model = LM(cfg, dtype=dtype, device=_home(generator.device, mesh),
               mesh=mesh, rules=rules)
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim

    def normal(name: str, scale: float) -> None:
        p = model.full_like(name)
        p.normal_(generator=generator).mul_(scale)
        model.load_full(name, p)

    normal("embed", 0.02)
    normal("unembed", 1.0 / math.sqrt(d))
    scales = {"wq": 1.0 / math.sqrt(d), "wk": 1.0 / math.sqrt(d),
              "wv": 1.0 / math.sqrt(d), "wo": 1.0 / math.sqrt(h * dh)}
    if cfg.moe is None:
        scales.update(w1=1.0 / math.sqrt(d), w3=1.0 / math.sqrt(d),
                      w2=1.0 / math.sqrt(cfg.d_ff))
    for name, scale in scales.items():  # one weight kind at a time
        for i in range(cfg.n_layers):
            normal(f"layers.{i}.{name}", scale)
    if cfg.moe is not None and model.tensor_parallel:
        for i in range(cfg.n_layers):   # init_moe_'s draws, layer by layer
            for name, scale in moe_draws(d, cfg.moe):
                normal(f"layers.{i}.moe.{name}", scale)
    elif cfg.moe is not None:
        for blk in model.layers:
            init_moe_(blk.moe, generator)
    for name, p in model.named_parameters():
        if name.endswith(".weight"):    # RMSNorm gains
            p.fill_(1.0)
        elif name.split(".")[-1] in ("bq", "bk", "bv"):
            p.zero_()
    return model


@torch.no_grad()
def lm_from_numpy(params: dict, cfg: LMConfig, *,
                  dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cuda", mesh=None,
                  rules=None) -> LM:
    """The reference's ``lm_init`` dict (``embed``, ``unembed``,
    ``final_ln`` and ``layers`` of stacked ``(L, …)`` arrays, weights
    ``(d_in, d_out)``; with ``cfg.moe``, ``layers["moe"]``'s stacked expert
    arrays, ``shared`` included) → :class:`LM` in ``dtype`` (MoE routers in
    fp32) on ``device`` (the card unless the caller asks for the CPU);
    with ``mesh`` (whose home device is ``device``), its experts split
    over the mesh, or with ``rules`` every weight split into its shards'
    blocks."""
    model = LM(cfg, dtype=dtype, device=_home(resolve_device(device), mesh),
               mesh=mesh, rules=rules)

    def put(name: str, arr) -> None:
        model.load_full(name, torch.tensor(np.asarray(arr,
                                                      dtype=np.float32)))

    put("embed", params["embed"])
    put("unembed", params["unembed"])
    put("final_ln.weight", params["final_ln"])
    lay = params["layers"]
    names = [n for n in ("ln1", "ln2", "q_norm", "k_norm", "wq", "wk", "wv",
                         "wo", "w1", "w3", "w2", "bq", "bk", "bv") if n in lay]
    for i in range(cfg.n_layers):
        for name in names:
            norm = name in ("ln1", "ln2", "q_norm", "k_norm")
            put(f"layers.{i}.{name}" + (".weight" if norm else ""),
                lay[name][i])
        if cfg.moe is not None and model.tensor_parallel:
            for name, _ in moe_draws(cfg.d_model, cfg.moe):
                node = lay["moe"]
                for key in name.split("."):
                    node = node[key]
                put(f"layers.{i}.moe.{name}", node[i])
        elif cfg.moe is not None:
            layer_moe = {k: v[i] for k, v in lay["moe"].items()
                         if k != "shared"}
            if cfg.moe.n_shared:
                layer_moe["shared"] = {k: v[i] for k, v in
                                       lay["moe"]["shared"].items()}
            load_moe_(model.layers[i].moe, layer_moe)
    return model


def gathered_state_dict(model: LM, device: str | torch.device = "cpu"
                        ) -> dict[str, torch.Tensor]:
    """``model``'s weights on ``device`` under the keys of an :class:`LM`
    without a mesh: each MoE layer's experts gathered back into the
    reference's ``(E, d, ff)`` layout (:func:`~repro_torch.models.moe.
    gather_experts`), or on a train mesh each weight assembled from its
    shards' blocks. Load it into ``LM(cfg)`` to run the one-card model."""
    if model.tensor_parallel:
        out = {}
        for name, (shape, blocks) in model.blocks.items():
            parts = [sh.get_parameter(name) for sh in model.shards]
            full = torch.empty(shape, dtype=parts[0].dtype, device=device)
            for part, block in zip(parts, blocks):
                full[block_slices(block)].copy_(part.detach())
            out[name] = full
        return out
    out = {k: v.detach().to(device) for k, v in model.state_dict().items()
           if ".moe.shards." not in k}
    if model.mesh is not None:
        for i, blk in enumerate(model.layers):
            for name, w in gather_experts(blk.moe, device).items():
                out[f"layers.{i}.moe.{name}"] = w
    return out


def _rope(positions: torch.Tensor, cfg: LMConfig):
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return cos[None], sin[None]


def _logits(model: LM, h_last: torch.Tensor) -> torch.Tensor:
    """Final norm of the last position and the unembedding, in the
    activation dtype, returned as fp32 (the reference norms every position
    and keeps the last; the norm is per position)."""
    x = rms_norm(h_last, model.final_ln.weight)
    return (x @ model.unembed.to(x.dtype)).float()


def lm_forward(model: LM, tokens: torch.Tensor, cfg: LMConfig, *,
               q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens ``(B, S)`` → (the final-normed hidden state ``(B, S, d)`` in
    the activation dtype, the aux loss summed over layers, fp32). Each
    layer runs under ``torch.utils.checkpoint`` when a gradient is
    recorded: its input is kept and the layer recomputed in the backward,
    as the reference's ``nothing_saveable`` remat."""
    b, s = tokens.shape
    h = model.embed[tokens].to(cfg.adtype)
    cos, sin = _rope(torch.arange(s, device=tokens.device), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = torch.is_grad_enabled()
    for blk in model.layers:
        if remat:
            h, a = checkpoint(blk.train_forward, h, cos, sin, q_chunk,
                              kv_chunk, use_reentrant=False)
        else:
            h, a = blk.train_forward(h, cos, sin, q_chunk, kv_chunk)
        aux = aux + a
    return model.final_ln(h), aux


class ChunkedCrossEntropy(torch.autograd.Function):
    """Per-position ``logsumexp(l) - l[target]`` over ``l = (h @
    U).float()``, ``U`` cast to h's dtype (the reference's ``lm_loss``
    rows), ``chunk`` positions at a time. The forward keeps h, the
    targets and each row's log-sum-exp; the backward recomputes each
    chunk's logits, takes ``softmax - onehot`` scaled by the incoming
    gradient, casts it to h's dtype (the gradient of the fp32 cast), and
    forms that chunk's ``dh`` and its term of ``dU``, added into an fp32
    gradient of the fp32 ``U``."""

    @staticmethod
    def forward(ctx, h, unembed, targets, chunk):
        u = unembed.to(h.dtype)
        n = h.shape[0]
        nll = h.new_empty((n,), dtype=torch.float32)
        lse = torch.empty_like(nll)
        for r in range(0, n, chunk):
            logits = (h[r:r + chunk] @ u).float()
            lse[r:r + chunk] = torch.logsumexp(logits, -1)
            tgt = logits.gather(1, targets[r:r + chunk, None])[:, 0]
            nll[r:r + chunk] = lse[r:r + chunk] - tgt
        ctx.save_for_backward(h, unembed, targets, lse)
        ctx.chunk = chunk
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        h, unembed, targets, lse = ctx.saved_tensors
        u = unembed.to(h.dtype)
        dh = torch.empty_like(h)
        du = torch.zeros_like(unembed, dtype=torch.float32)
        for r in range(0, h.shape[0], ctx.chunk):
            rows = slice(r, r + ctx.chunk)
            g = grad_nll[rows, None]
            # softmax · g, in place on the recomputed fp32 logits
            dl = (h[rows] @ u).float().sub_(lse[rows, None]).exp_().mul_(g)
            dl.scatter_add_(1, targets[rows, None], -g)
            dl = dl.to(h.dtype)
            dh[rows] = dl @ u.t()
            du += (h[rows].t() @ dl).float()
        return dh, du.to(unembed.dtype), None, None


def lm_loss(model: LM, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: LMConfig, *, q_chunk: int = Q_CHUNK,
            kv_chunk: int = KV_CHUNK, chunk: int = LOSS_CHUNK
            ) -> torch.Tensor:
    """The reference's ``lm_loss``: mean over ``(B, S)`` of the cross
    entropy of ``h @ unembed`` (in the activation dtype, then fp32) at
    ``targets``, plus the aux loss; the cross entropy in chunks of
    ``chunk`` positions (:class:`ChunkedCrossEntropy`)."""
    h, aux = lm_forward(model, tokens, cfg, q_chunk=q_chunk,
                        kv_chunk=kv_chunk)
    d = h.shape[-1]
    nll = ChunkedCrossEntropy.apply(h.reshape(-1, d), model.unembed,
                                    targets.reshape(-1).long(), chunk)
    return nll.mean() + aux


@torch.no_grad()
def lm_prefill(model: LM, tokens: torch.Tensor, cfg: LMConfig
               ) -> tuple[torch.Tensor, dict]:
    """Prefill: run the full prompt ``tokens (B, S)``; return the
    last-position logits ``(B, V)`` in fp32 and the KV cache
    ``{"k", "v"}``, each ``(L, B, S, KV, dh)`` in bf16 (k after qk-norm
    and RoPE). Each layer's attention is one ``flash_attention`` call."""
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
    attention and FFN weights (with MoE: every expert, the router and the
    shared experts) and two norm gains (qk-norm gains and QKV biases are
    not counted)."""
    m = cfg.moe
    if m is None:
        ffn = 3 * cfg.d_model * cfg.d_ff
    else:
        ffn = _moe_ffn_params(cfg, m.num_experts)
    return _count(cfg, ffn)


def lm_active_param_count(cfg: LMConfig) -> int:
    """Parameters a token touches: all of them for a dense config; with
    MoE, its top-k experts, the whole router and the shared experts."""
    if cfg.moe is None:
        return lm_param_count(cfg)
    return _count(cfg, _moe_ffn_params(cfg, cfg.moe.top_k))


def _moe_ffn_params(cfg: LMConfig, experts: int) -> int:
    d, m = cfg.d_model, cfg.moe
    ffn = experts * 3 * d * m.d_ff + d * m.num_experts
    if m.n_shared:
        ffn += 3 * d * m.d_ff_shared
    return ffn


def _count(cfg: LMConfig, ffn: int) -> int:
    d, h, kv, dh, L = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                       cfg.n_layers)
    attn = d * h * dh + 2 * d * kv * dh + h * dh * d
    return 2 * cfg.vocab * d + d + L * (attn + ffn + 2 * d)
