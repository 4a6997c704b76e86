"""A dense LM trained over a ``("data", "model")`` mesh: the runtime of
the reference's ``train_4k`` cell for dense archs
(``src/repro/configs/lm_common.py:143-201``), where GSPMD lays the step
out by the ZeRO-1 rules (``"fsdp"`` → None, ``"tp"``/``"tp_kv"``/
``"vocab_tp"`` → ``"model"``). An MoE on a train mesh
(:mod:`repro_torch.models.fsdp`) gathers its blocks over ``"data"`` into
these ZeRO-1 blocks while a layer runs and reuses :func:`attention`,
:func:`vocab_embed` and :class:`VocabParallelCE` on them.

The port has no GSPMD, so the layout and the moves are explicit. Each
shard of the mesh holds its block of every weight (:class:`TPShard`,
blocks from :func:`repro_torch.sharding.device_blocks` of
``lm_param_specs`` under those rules): the same blocks on every data
replica. A data group (the model shards of one data coordinate) runs
the reference's ``_attn``, ``_ffn`` and ``lm_loss``
(``src/repro/models/transformer.py:96-181``) tensor-parallel:

* the residual stream lives on the group's home device (its model shard
  0) and is copied to each shard (:class:`FanOut`); each shard norms it
  with its own copy of the gain;
* attention is head-parallel: shard m holds the columns of ``wq``/``bq``
  of its query heads and the rows of ``wo`` that read them, and attends
  over its heads, each reading its KV head by its global index ``h //
  (H / KV)``. Where ``wk``/``wv`` are split head by head (``"tp_kv"``
  bound, KV a multiple of the axis) a shard holds the KV heads its query
  heads read; where they are split inside a head (qwen3-4b's smoke
  reduction: one KV head of 16 columns over 4 shards) the shards' k and v
  columns are gathered (:class:`AllGather`); where they are replicated,
  each shard computes every KV head and reads its own;
* the FFN is column-parallel in ``w1``/``w3`` and row-parallel in ``w2``;
* ``o @ wo`` and ``(g·u) @ w2`` are partial sums, summed in shard order on
  the home device (:class:`FanIn`), so a run repeats bit for bit;
* the embedding is vocab-parallel: each shard looks up the rows it holds
  and zeros elsewhere, and the shards' rows are summed; the cross entropy
  is vocab-parallel (:class:`VocabParallelCE`): each shard forms its
  ``(chunk, V/M)`` logits, the log-sum-exp is combined across shards and
  the target logit comes from its owning shard.

Every gradient that reaches one tensor from more than two places is
summed in an order fixed by this module, never by the arrival order of
autograd's device threads: a fan-out's gradients in its backward, in
shard order (two terms add the same either way). A
weight replicated over ``"model"`` (the norm gains, and ``wk``/``wv``
where they are replicated) gets on each shard the gradient of that
shard's use of it only: the train step
(:func:`repro_torch.configs.lm_common.train_step`) sums every block over
the shards that hold it, over ``"data"`` and ``"model"`` alike, in shard
order.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (apply_rope, blockwise_attention,
                                          rope_angles)
from repro_torch.models.common import RMSNorm


# ---------------------------------------------------------------------------
# moves between shards
# ---------------------------------------------------------------------------
class FanOut(torch.autograd.Function):
    """``x`` → one copy on each of ``devices`` (a view where a device is
    x's own); the backward sums the copies' gradients in their order on
    x's device."""

    @staticmethod
    def forward(ctx, devices, x):
        ctx.device = x.device
        return tuple(x.view_as(x) if torch.device(d) == x.device
                     else x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0].to(ctx.device)
        for g in grads[1:]:
            total = total + g.to(ctx.device)
        return None, total


class FanIn(torch.autograd.Function):
    """Partial sums, one on each shard's device → their sum on ``device``,
    added in shard order; the backward copies the gradient to each
    shard."""

    @staticmethod
    def forward(ctx, device, *parts):
        ctx.devices = tuple(p.device for p in parts)
        out = parts[0].to(device, copy=True)
        for p in parts[1:]:
            out.add_(p.to(device))
        return out

    @staticmethod
    def backward(ctx, grad):
        return (None, *(grad.to(d) for d in ctx.devices))


class AllGather(torch.autograd.Function):
    """Each shard's block → the blocks concatenated on dimension ``dim``,
    one copy on each shard's device; the backward sums the shards'
    gradients of the whole in shard order and hands each shard its block
    (the reduce-scatter). Over ``"model"`` it gathers k and v split inside
    a head (``dim`` -1); over ``"data"`` a weight's FSDP blocks
    (:mod:`repro_torch.models.fsdp`)."""

    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.devices = tuple(p.device for p in parts)
        ctx.widths = [p.shape[dim] for p in parts]
        ctx.dim = dim
        return tuple(torch.cat([p.to(d) for p in parts], dim)
                     for d in ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0].to(ctx.devices[0], copy=True)
        for g in grads[1:]:
            total.add_(g.to(ctx.devices[0]))
        return (None, *(part.to(d) for part, d in zip(
            total.split(ctx.widths, ctx.dim), ctx.devices)))


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """What one model shard computes (the same on every data replica).

    Attributes:
        heads: its query heads ``[lo, hi)``.
        kv: the KV heads its query heads read, ``[lo, hi)`` within the KV
            heads it holds (all of them where ``TPPlan.gather_kv``).
        vocab: its embedding rows and unembedding columns ``[lo, hi)``.
    """

    heads: tuple
    kv: tuple
    vocab: tuple


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """The model shards' :class:`ShardPlan`\\ s, in model order, and
    whether k and v are gathered (``wk`` split inside a head)."""

    shards: tuple
    gather_kv: bool


def _partition(what: str, ranges: list, dim: int) -> None:
    """Raise unless ``ranges`` split ``[0, dim)`` in order."""
    ends = [0] + [hi for _, hi in ranges]
    if [lo for lo, _ in ranges] != ends[:-1] or ends[-1] != dim:
        raise ValueError(f"{what} are not split over the model axis: "
                         f"{ranges} of {dim}")


def tp_plan(cfg, blocks: dict, groups: list) -> TPPlan:
    """The plan of an LM whose shards hold ``blocks`` (name → each shard's
    block) on a mesh whose ``"model"`` groups are ``groups``.

    Raises:
        ValueError: the weights are not replicated over ``"data"`` (the
            ZeRO-1 rules), or the model axis does not split the query
            heads, the FFN and the vocabulary, or splits a query head.
    """
    first = groups[0]
    for name, per_shard in blocks.items():
        if any(per_shard[i] != per_shard[first[m]]
               for g in groups for m, i in enumerate(g)):
            raise ValueError(f"{name} is not replicated over the data "
                             "axis: train weights take the ZeRO-1 rules")
    dh, grp = cfg.head_dim, cfg.n_heads // cfg.n_kv

    def last(name: str, dim: int = -1) -> list:
        return [blocks[name][i][dim] for i in first]

    ffn = []
    if cfg.moe is None:
        ffn = [("w1's columns", last("layers.0.w1"), cfg.d_ff)]
    elif cfg.moe.n_shared:
        ffn = [("the shared experts' w1 columns",
                last("layers.0.moe.shared.w1"), cfg.moe.d_ff_shared)]
    for what, ranges, dim in (
            ("wq's columns", last("layers.0.wq"), cfg.n_heads * dh),
            *ffn, ("the vocabulary", last("embed", 0), cfg.vocab)):
        _partition(what, ranges, dim)
    if last("embed", 0) != last("unembed"):
        raise ValueError("embed and unembed split the vocabulary apart")
    heads = []
    for lo, hi in last("layers.0.wq"):
        if lo % dh or hi % dh:
            raise ValueError(f"the model axis splits a query head: "
                             f"columns [{lo}, {hi}) of head width {dh}")
        heads.append((lo // dh, hi // dh))
    need = [(h0 // grp, (h1 - 1) // grp + 1) for h0, h1 in heads]
    local = [(lo // dh, hi // dh) if not (lo % dh or hi % dh) else None
             for lo, hi in last("layers.0.wk")]
    gather = any(held is None or not held[0] <= n0 <= n1 <= held[1]
                 for held, (n0, n1) in zip(local, need))
    if gather:
        local = [(0, cfg.n_kv)] * len(first)
    shards = []
    for (h0, h1), (n0, n1), (l0, _), vocab in zip(heads, need, local,
                                                   last("embed", 0)):
        ratio = (h1 - h0) // (n1 - n0)
        if any((h0 + j) // grp - n0 != j // max(ratio, 1)
               for j in range(h1 - h0)):
            raise ValueError(f"query heads [{h0}, {h1}) do not read KV "
                             f"heads [{n0}, {n1}) in groups of {grp}")
        shards.append(ShardPlan((h0, h1), (n0 - l0, n1 - l0), vocab))
    return TPPlan(tuple(shards), gather)


class TPBlock(nn.Module):
    """One layer's blocks on one shard: the parameters of
    :class:`~repro_torch.models.transformer.LMBlock` under its names, each
    shaped by the shard's block (norm gains as :class:`RMSNorm`; an MoE's
    ``moe.router``, ``moe.w1``… and ``moe.shared.w1``… in submodules of
    those names, the router in fp32 as the reference draws it)."""

    def __init__(self, shapes: dict, *, dtype: torch.dtype, device):
        super().__init__()
        for name, shape in shapes.items():
            *path, leaf = name.split(".")
            if leaf == "weight":
                *path, leaf = path
            owner = self
            for part in path:
                if part not in owner._modules:
                    owner.add_module(part, nn.Module())
                owner = owner._modules[part]
            if name.endswith(".weight"):
                owner.add_module(leaf, RMSNorm(shape[0], dtype=dtype,
                                               device=device))
            else:
                owner.register_parameter(leaf, nn.Parameter(torch.empty(
                    shape, device=device,
                    dtype=torch.float32 if leaf == "router" else dtype)))


class TPShard(nn.Module):
    """One shard's blocks of every weight of an LM, named as the
    parameters of an :class:`~repro_torch.models.transformer.LM` without
    a mesh: ``embed`` (its vocabulary rows), ``unembed``, ``final_ln``
    and ``layers``."""

    def __init__(self, shapes: dict, n_layers: int, *, dtype: torch.dtype,
                 device):
        super().__init__()
        self.device = torch.device(device)
        self.embed = nn.Parameter(torch.empty(shapes["embed"], dtype=dtype,
                                              device=device))
        self.unembed = nn.Parameter(torch.empty(
            shapes["unembed"], dtype=dtype, device=device))
        self.final_ln = RMSNorm(shapes["final_ln.weight"][0], dtype=dtype,
                                device=device)
        self.layers = nn.ModuleList(
            TPBlock({k[len(f"layers.{i}."):]: v for k, v in shapes.items()
                     if k.startswith(f"layers.{i}.")}, dtype=dtype,
                    device=device)
            for i in range(n_layers))


# ---------------------------------------------------------------------------
# the forward and the loss of one data group
# ---------------------------------------------------------------------------
def vocab_embed(shards: list, plan: TPPlan,
                tokens: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel lookup: each shard's rows for the tokens it holds,
    zeros elsewhere, summed in shard order on the home device (fp32)."""
    parts = []
    for sh, p in zip(shards, plan.shards):
        lo, hi = p.vocab
        local = tokens.to(sh.device) - lo
        held = (local >= 0) & (local < hi - lo)
        rows = sh.embed[local.clamp(0, hi - lo - 1)]
        parts.append(rows.masked_fill(~held[..., None], 0.0))
    return FanIn.apply(tokens.device, *parts)


def _layer(blocks: list, plan: TPPlan, ropes: list, cfg, q_chunk: int,
           kv_chunk: int, h: torch.Tensor) -> torch.Tensor:
    """One decoder layer of a data group, ``h`` on its home device."""
    return _dense_ffn(blocks, attention(blocks, plan, ropes, cfg, q_chunk,
                                        kv_chunk, h))


def attention(blocks: list, plan: TPPlan, ropes: list, cfg, q_chunk: int,
              kv_chunk: int, h: torch.Tensor) -> torch.Tensor:
    """A data group's attention with its residual add, ``h`` on its home
    device: each model shard's ``blocks`` (a :class:`TPBlock`, or any
    object with its attributes) norms ``h`` and attends over its heads,
    and the partial products with ``wo`` are summed in shard order."""
    b, s, _ = h.shape
    dh = cfg.head_dim
    devs = [blk.ln1.weight.device for blk in blocks]
    qkv = []
    for blk, x in zip(blocks, FanOut.apply(devs, h)):
        x = blk.ln1(x)
        xq, xk, xv = FanOut.apply((x.device,) * 3, x)
        q = xq @ blk.wq.to(x.dtype)
        k = xk @ blk.wk.to(x.dtype)
        v = xv @ blk.wv.to(x.dtype)
        if cfg.qkv_bias:
            q = q + blk.bq.to(q.dtype)
            k = k + blk.bk.to(k.dtype)
            v = v + blk.bv.to(v.dtype)
        qkv.append((q, k, v))
    ks, vs = [t[1] for t in qkv], [t[2] for t in qkv]
    if plan.gather_kv:
        ks, vs = AllGather.apply(-1, *ks), AllGather.apply(-1, *vs)
    parts = []
    for blk, p, (q, _, _), k, v, (cos, sin) in zip(blocks, plan.shards, qkv,
                                                   ks, vs, ropes):
        lo, hi = p.kv
        q = q.reshape(b, s, -1, dh)
        k = k.reshape(b, s, -1, dh)[:, :, lo:hi]
        v = v.reshape(b, s, -1, dh)[:, :, lo:hi]
        if cfg.qk_norm:
            q = blk.q_norm(q)
            k = blk.k_norm(k)
        o = blockwise_attention(apply_rope(q, cos, sin),
                                apply_rope(k, cos, sin), v, causal=True,
                                q_chunk=q_chunk, kv_chunk=kv_chunk)
        parts.append(o.reshape(b, s, -1) @ blk.wo.to(o.dtype))
    return h + FanIn.apply(h.device, *parts)


def _dense_ffn(blocks: list, h: torch.Tensor) -> torch.Tensor:
    """A data group's SwiGLU FFN with its residual add: column-parallel
    ``w1``/``w3``, row-parallel ``w2``, summed in shard order."""
    devs = [blk.ln2.weight.device for blk in blocks]
    parts = []
    for blk, x in zip(blocks, FanOut.apply(devs, h)):
        x = blk.ln2(x)
        g = F.silu(x @ blk.w1.to(x.dtype))
        u = x @ blk.w3.to(x.dtype)
        parts.append((g * u) @ blk.w2.to(x.dtype))
    return h + FanIn.apply(h.device, *parts)


class VocabParallelCE(torch.autograd.Function):
    """Per-position ``logsumexp(l) - l[target]`` of the logits ``l = (x @
    U).float()`` split over the shards by vocabulary: shard m holds ``x``
    (its copy, in the activation dtype) and its columns of ``U`` (fp32,
    cast to x's dtype), and covers vocabulary ``ranges[m]``. ``chunk``
    positions at a time, each shard forms its ``(chunk, V/M)`` logits; the
    shards' maxima and sums of exponentials combine, in shard order on the
    first shard's device, into the row's log-sum-exp, and the target logit
    comes from the shard that holds it. The backward recomputes each
    chunk's logits and forms ``softmax - onehot`` on each shard (as
    :class:`~repro_torch.models.transformer.ChunkedCrossEntropy` does
    whole), each shard's ``dx`` and its ``dU``."""

    @staticmethod
    def forward(ctx, chunk, targets, ranges, *tensors):
        m = len(ranges)
        xs, us = tensors[:m], tensors[m:]
        home = xs[0].device
        n = xs[0].shape[0]
        nll = torch.empty((n,), dtype=torch.float32, device=home)
        lse = torch.empty_like(nll)
        ucs = [u.to(x.dtype) for x, u in zip(xs, us)]
        tgts = [targets.to(x.device) for x in xs]
        for r in range(0, n, chunk):
            rows = slice(r, r + chunk)
            tops, sums, picked = [], [], None
            for x, uc, t, (lo, hi) in zip(xs, ucs, tgts, ranges):
                logits = (x[rows] @ uc).float()
                top = logits.amax(-1)
                sums.append(torch.exp(logits - top[:, None]).sum(-1)
                            .to(home))
                tops.append(top.to(home))
                local = t[rows] - lo
                held = (local >= 0) & (local < hi - lo)
                tl = logits.gather(1, local.clamp(0, hi - lo - 1)[:, None])
                tl = tl[:, 0].masked_fill(~held, 0.0).to(home)
                picked = tl if picked is None else picked + tl
            top = torch.stack(tops).amax(0)
            total = sums[0] * torch.exp(tops[0] - top)
            for t_m, s_m in zip(tops[1:], sums[1:]):
                total = total + s_m * torch.exp(t_m - top)
            lse[rows] = top + torch.log(total)
            nll[rows] = lse[rows] - picked
        ctx.save_for_backward(targets, lse, *xs, *us)
        ctx.chunk, ctx.ranges = chunk, ranges
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        targets, lse, *rest = ctx.saved_tensors
        m = len(ctx.ranges)
        xs, us = rest[:m], rest[m:]
        dxs, dus = [], []
        for x, u, (lo, hi) in zip(xs, us, ctx.ranges):
            dev = x.device
            uc = u.to(x.dtype)
            t, g_all, lse_m = (targets.to(dev), grad_nll.to(dev),
                               lse.to(dev))
            dx = torch.empty_like(x)
            du = torch.zeros_like(u, dtype=torch.float32)
            for r in range(0, x.shape[0], ctx.chunk):
                rows = slice(r, r + ctx.chunk)
                g = g_all[rows, None]
                # softmax · g, in place on the recomputed fp32 logits
                dl = (x[rows] @ uc).float().sub_(lse_m[rows, None]).exp_() \
                    .mul_(g)
                local = t[rows] - lo
                held = (local >= 0) & (local < hi - lo)
                dl.scatter_add_(1, local.clamp(0, hi - lo - 1)[:, None],
                                torch.where(held[:, None], -g, 0.0))
                dl = dl.to(x.dtype)
                dx[rows] = dl @ uc.t()
                du += (x[rows].t() @ dl).float()
            dxs.append(dx)
            dus.append(du.to(u.dtype))
        return (None, None, None, *dxs, *dus)


def group_loss(model, group: int, tokens: torch.Tensor,
               targets: torch.Tensor, cfg, *, count: int, q_chunk: int,
               kv_chunk: int, chunk: int) -> torch.Tensor:
    """Data group ``group``'s share of the reference's ``lm_loss``: the
    summed cross entropy of its rows ``tokens``/``targets`` ``(b, S)``
    (on its home device) over ``count``, the positions of the whole
    micro-batch, so that the groups' losses and gradients add up to the
    micro-batch's mean. Each layer runs under ``torch.utils.checkpoint``
    when a gradient is recorded, as :func:`~repro_torch.models.
    transformer.lm_forward`, but reentrant: the layer is recomputed and
    its backward run inside one node's backward. The non-reentrant form
    recomputes a layer when its first saved tensor is unpacked, and over
    several cards autograd's device threads unpack a layer's tensors at
    once, each starting its own recompute."""
    shards = model.group(group)
    plan = model.plan
    h = vocab_embed(shards, plan, tokens).to(cfg.adtype)
    ropes = group_ropes(shards, tokens.shape[1], cfg)
    remat = torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        fn = functools.partial(_layer, [sh.layers[i] for sh in shards],
                               plan, ropes, cfg, q_chunk, kv_chunk)
        h = checkpoint(fn, h, use_reentrant=True) if remat else fn(h)
    return head_loss(shards, plan, h, targets,
                     [sh.unembed for sh in shards], chunk) / count


def group_ropes(shards: list, s: int, cfg) -> list:
    """RoPE's ``(cos, sin)`` of positions ``[0, s)`` on each shard's
    device."""
    ropes = []
    for sh in shards:
        cos, sin = rope_angles(torch.arange(s, device=sh.device),
                               cfg.head_dim, cfg.rope_theta)
        ropes.append((cos[None], sin[None]))
    return ropes


def head_loss(shards: list, plan: TPPlan, h: torch.Tensor,
              targets: torch.Tensor, unembeds: list,
              chunk: int) -> torch.Tensor:
    """A data group's summed cross entropy of ``h`` at ``targets``: each
    shard's final norm of its copy of ``h``, then
    :class:`VocabParallelCE` over its ``unembeds`` block."""
    xs = [sh.final_ln(x).reshape(-1, h.shape[-1]) for sh, x in
          zip(shards, FanOut.apply([sh.device for sh in shards], h))]
    nll = VocabParallelCE.apply(chunk, targets.reshape(-1).long(),
                                tuple(p.vocab for p in plan.shards), *xs,
                                *unembeds)
    return nll.sum()
