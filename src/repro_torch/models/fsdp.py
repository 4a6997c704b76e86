"""An MoE LM trained over a ``("data", "model")`` mesh by the reference's
full FSDP: the runtime of the reference's ``train_4k`` cell for MoE archs
(``src/repro/configs/lm_common.py:143-201``), which keeps ``lm_rules``
whole for an MoE. Every weight and its AdamW state is split over the
data axis on its ``"fsdp"`` dimension; the experts are split over
``"model"`` by ``"expert"``; attention, the shared experts, the embedding
and the unembedding over ``"model"`` as in the dense case
(:mod:`repro_torch.models.tensor_parallel`); the router over data only.

Each shard holds its block of every weight (a
:class:`~repro_torch.models.tensor_parallel.TPShard`). A weight's blocks
are gathered over ``"data"`` only while the layer that reads them runs:

* every weight but the experts by :class:`~repro_torch.models.
  tensor_parallel.AllGather` over the data replicas of its model
  coordinate — each replica gets the whole ``"fsdp"`` dimension, the
  block the dense (ZeRO-1) layout holds, and its backward sums the
  replicas' gradients of the whole block in data order and hands each
  shard its slice (the reduce-scatter), so a shard's ``.grad`` never
  holds more than its block; the router is gathered for the groups' home
  shards only, where it runs;
* the experts of a model coordinate by :class:`ExpertGather`: each data
  replica gathers the experts it runs, ``split_range`` of the
  coordinate's, whole, so each expert is gathered once and its gradient
  needs no sum.

A layer is recomputed in the backward under reentrant
``torch.utils.checkpoint`` (as :func:`~repro_torch.models.
tensor_parallel.group_loss` explains), so the gathered copies are gathered
again inside the recompute and freed with it. The cross entropy runs the
same way; the embedding's gathered copies are freed after the lookup.

An MoE couples the data groups: the reference's ``moe_apply`` runs over
the whole micro-batch's ``b·S`` tokens (its capacity, its slots and its
aux loss are the micro-batch's), so :func:`fsdp_loss` runs each layer
over every group at once (:func:`layer`): each group's attention
tensor-parallel on its model shards, then the micro-batch's MoE
(:func:`~repro_torch.models.moe.moe_apply_groups`) and each group's
shared experts.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.moe import EXPERT_WEIGHTS, moe_apply_groups
from repro_torch.models.tensor_parallel import (AllGather, FanIn, FanOut,
                                                attention, group_ropes,
                                                head_loss, vocab_embed)


class ExpertGather(torch.autograd.Function):
    """The experts of one model coordinate, split over its data replicas
    on dimension ``dim`` (``parts``, in data order) → replica g's experts
    ``ranges[g]`` (within the coordinate's block) whole on its device:
    the rows of those experts from every replica, concatenated on
    ``dim``. The backward hands each replica its slice of every replica's
    gradient, in expert order: each expert is gathered once, so there is
    nothing to sum."""

    @staticmethod
    def forward(ctx, dim, ranges, *parts):
        ctx.dim, ctx.ranges = dim, ranges
        ctx.devices = tuple(p.device for p in parts)
        ctx.widths = [p.shape[dim] for p in parts]
        return tuple(torch.cat([p[lo:hi].to(dev) for p in parts], dim)
                     for (lo, hi), dev in zip(ranges, ctx.devices))

    @staticmethod
    def backward(ctx, *grads):
        out, start = [], 0
        for width, dev in zip(ctx.widths, ctx.devices):
            out.append(torch.cat([g.narrow(ctx.dim, start, width).to(dev)
                                  for g in grads]))
            start += width
        return (None, None, *out)


def split_range(n: int, parts: int) -> list[tuple[int, int]]:
    """``[0, n)`` in ``parts`` contiguous ranges in order, the first ``n %
    parts`` one longer (some empty when ``parts > n``)."""
    step, extra = divmod(n, parts)
    out, lo = [], 0
    for i in range(parts):
        hi = lo + step + (i < extra)
        out.append((lo, hi))
        lo = hi
    return out


def _split_dim(blocks: list) -> int | None:
    """The dimension along which the data replicas' ``blocks`` of a weight
    differ (its ``"fsdp"`` dimension), or None where they are the same
    block (replicated over data)."""
    dims = {k for b in blocks[1:]
            for k, (r, r0) in enumerate(zip(b, blocks[0])) if r != r0}
    if not dims:
        return None
    (dim,) = dims
    return dim


class _Gathered:
    """A shard's module seen with some weights replaced by their gathered
    copies: ``weights``' attributes first, the module's after."""

    def __init__(self, module, weights: dict):
        self._module, self._weights = module, weights

    def __getattr__(self, name):
        weights = self.__dict__["_weights"]
        if name in weights:
            return weights[name]
        return getattr(self.__dict__["_module"], name)


def gather(model, name: str, m: int) -> list[torch.Tensor]:
    """Weight ``name`` gathered over ``"data"`` for model coordinate
    ``m``: one tensor for each of its data replicas (``model.replicas[m]``,
    in data order), on the replica's device. A weight replicated over data
    is each replica's own parameter."""
    shards = model.replicas[m]
    parts = [model.shards[s].get_parameter(name) for s in shards]
    dim = _split_dim([model.blocks[name][1][s] for s in shards])
    return parts if dim is None else list(AllGather.apply(dim, *parts))


def expert_pieces(model, i: int) -> list[tuple]:
    """Layer ``i``'s experts as :func:`~repro_torch.models.moe.
    moe_apply_groups` takes them: for each model coordinate that runs
    experts (``model.expert_ranges``) and each of its data replicas, the
    replica's ``split_range`` of them gathered whole on its device
    (:class:`ExpertGather`; a replica's own rows where the experts are
    replicated over data), ``(lo, hi, w1, w3, w2)`` in expert order."""
    pieces = []
    for m, (lo, hi) in enumerate(model.expert_ranges):
        if hi == lo:
            continue
        shards = model.replicas[m]
        ranges = split_range(hi - lo, len(shards))
        ws = []
        for w in EXPERT_WEIGHTS:
            name = f"layers.{i}.moe.{w}"
            parts = [model.shards[s].get_parameter(name) for s in shards]
            dim = _split_dim([model.blocks[name][1][s] for s in shards])
            ws.append([p[a:b] for p, (a, b) in zip(parts, ranges)]
                      if dim is None else
                      ExpertGather.apply(dim, tuple(ranges), *parts))
        pieces += [(lo + a, lo + b, *w) for (a, b), *w in zip(ranges, *ws)
                   if b > a]
    return pieces


def layer(model, i: int, ropes: list, q_chunk: int, kv_chunk: int,
          *hs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Decoder layer ``i`` over every data group: ``hs[g]`` is group g's
    residual stream ``(b, S, d)`` on its home device. Returns the new
    streams and the layer's aux loss on the mesh's home device; keeps the
    router stats (``expert_load``, ``dropped``, ``capacity``) as
    ``model.moe_stats[i]``."""
    cfg = model.cfg
    prefix = f"layers.{i}."
    # every weight of the layer but the norm gains, the router and the
    # experts (gathered where they run)
    names = [n[len(prefix):] for n in model.blocks
             if n.startswith(prefix) and not n.endswith(".weight")
             and (".moe." not in n or ".moe.shared." in n)]
    weights: dict[int, dict] = {s: {} for s in range(model.mesh.world)}
    for name in names:
        for m, shards in enumerate(model.replicas):
            for s, w in zip(shards, gather(model, prefix + name, m)):
                weights[s][name] = w
    blocks = [_Gathered(sh.layers[i], weights[s])
              for s, sh in enumerate(model.shards)]
    hs = [attention([blocks[s] for s in grp], model.plan, ropes[g], cfg,
                    q_chunk, kv_chunk, h)
          for g, (grp, h) in enumerate(zip(model.groups, hs))]
    xs, shared = [], []
    for grp, h in zip(model.groups, hs):
        norms = [model.shards[s].layers[i].ln2 for s in grp]
        if not cfg.moe.n_shared:
            xs.append(norms[0](h))
            shared.append(None)
            continue
        devs = [n.weight.device for n in norms]
        xm = [n(x) for n, x in zip(norms, FanOut.apply(devs, h))]
        x, xm[0] = FanOut.apply((devs[0],) * 2, xm[0])
        xs.append(x)
        parts = []
        for s, x in zip(grp, xm):
            w = weights[s]
            g = F.silu(x @ w["moe.shared.w1"].to(x.dtype)) * (
                x @ w["moe.shared.w3"].to(x.dtype))
            parts.append(g @ w["moe.shared.w2"].to(x.dtype))
        shared.append(FanIn.apply(h.device, *parts))
    d = cfg.d_model
    routers = gather(model, prefix + "moe.router", 0)
    outs, stats = moe_apply_groups([x.reshape(-1, d) for x in xs], routers,
                                   expert_pieces(model, i), cfg.moe,
                                   model.mesh.devices[0])
    model.moe_stats[i] = {"expert_load": stats["expert_load"].detach(),
                          "dropped": stats["dropped"],
                          "capacity": stats["capacity"]}
    new = []
    for h, out, sh in zip(hs, outs, shared):
        out = out.reshape(h.shape)
        new.append(h + (out if sh is None else out + sh))
    return (*new, stats["aux_loss"])


def _head(model, targets: list, count: int, chunk: int,
          *hs: torch.Tensor) -> torch.Tensor:
    """Every group's vocab-parallel cross entropy of its rows over
    ``count``, summed in group order on the mesh's home device."""
    us: dict[int, torch.Tensor] = {}
    for m, shards in enumerate(model.replicas):
        us.update(zip(shards, gather(model, "unembed", m)))
    home = model.mesh.devices[0]
    total = None
    for grp, h, tgt in zip(model.groups, hs, targets):
        part = (head_loss([model.shards[s] for s in grp], model.plan, h, tgt,
                          [us[s] for s in grp], chunk) / count).to(home)
        total = part if total is None else total + part
    return total


def fsdp_loss(model, tokens: list, targets: list, *, count: int,
              q_chunk: int, kv_chunk: int, chunk: int) -> torch.Tensor:
    """The reference's ``lm_loss`` of one micro-batch split over the data
    groups (``tokens[g]``/``targets[g]``: group g's rows ``(b, S)`` on its
    home device) on the mesh's home device: the groups' cross entropy
    over ``count``, the micro-batch's positions, plus the layers' aux
    losses. Each layer and the cross entropy run under reentrant
    ``torch.utils.checkpoint`` when a gradient is recorded."""
    cfg = model.cfg
    embeds: dict[int, torch.Tensor] = {}
    for m, shards in enumerate(model.replicas):
        embeds.update(zip(shards, gather(model, "embed", m)))
    hs = [vocab_embed([_Gathered(model.shards[s], {"embed": embeds[s]})
                       for s in grp], model.plan, toks).to(cfg.adtype)
          for grp, toks in zip(model.groups, tokens)]
    del embeds
    ropes = [group_ropes([model.shards[s] for s in grp], tokens[0].shape[1],
                         cfg) for grp in model.groups]
    home = model.mesh.devices[0]
    aux = torch.zeros((), dtype=torch.float32, device=home)
    remat = torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        fn = functools.partial(layer, model, i, ropes, q_chunk, kv_chunk)
        *hs, a = checkpoint(fn, *hs, use_reentrant=True) if remat \
            else fn(*hs)
        aux = aux + a
    head = functools.partial(_head, model, targets, count, chunk)
    nll = checkpoint(head, *hs, use_reentrant=True) if remat else head(*hs)
    return nll + aux
