"""Shared cell builders for the five LM architectures, ported from
``src/repro/configs/lm_common.py``: the shapes, the sharding rules and
specs, the dry-run cell (:func:`build_lm_cell`), the smoke reduction
(:func:`lm_smoke`) and the ``train_4k`` cell's step (:func:`train_step`,
on one device or over a ``("data", "model")`` mesh by the reference's
rule, :func:`train_rules`: ZeRO-1 for a dense arch, full FSDP for an
MoE); and, the port's own, where a served LM lives on a mesh of cards
(:func:`serve_placement`) and where a trained one does
(:func:`train_placement`, :func:`fsdp_working_set`).

Shapes (per assignment):
  train_4k    — train_step,  seq 4096,   global_batch 256
  prefill_32k — serve prefill, seq 32768, global_batch 32
  decode_32k  — serve decode (1 new token, 32k KV cache), batch 128
  long_500k   — serve decode, 524288 KV cache, batch 1 (cache seq-sharded)

Sharding (read by the dry-run, :mod:`repro_torch.sharding`): params are
2-D sharded — FSDP over ("pod","data") × TP over "model" (vocab-parallel
embeddings/logits, head-parallel attention, expert-parallel MoE);
activations batch-sharded; the long_500k cell re-binds the cache sequence
dimension to the data axes since batch=1.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import resolve_device
from repro_torch.configs.base import Arch, CellSpec
from repro_torch.launch.mesh import ProductionMesh
from repro_torch.models.moe import EXPERT_WEIGHTS, expert_ranges
from repro_torch.models.fsdp import fsdp_loss, split_range
from repro_torch.models.tensor_parallel import group_loss
from repro_torch.models.transformer import (CACHE_DTYPE, KV_CHUNK, LM,
                                            LMConfig, LOSS_CHUNK, Q_CHUNK,
                                            init_decode_cache,
                                            lm_decode_step, lm_init, lm_loss,
                                            lm_prefill, param_blocks)
from repro_torch.sharding import Rules, block_slices, spec, tree_shardings
from repro_torch.training.loop import StageTimer
from repro_torch.training.optimizer import AdamW, AdamWState

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def smoke_config(cfg: LMConfig) -> LMConfig:
    """``lm_smoke``'s reduction: vocab 512, d 64, 2 layers, 4 heads, kv
    ``max(1, 4·kv/H)``, head_dim 16, fp32; d_ff 128, or with MoE d_ff 0 and
    at most 8 experts, top-k at most 2, expert d_ff 64 and, with shared
    experts, d_ff_shared 64."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, num_experts=min(moe.num_experts, 8),
                                  top_k=min(moe.top_k, 2), d_ff=64,
                                  d_ff_shared=64 if moe.n_shared else 0)
    return dataclasses.replace(
        cfg, vocab=512, d_model=64, n_layers=2, n_heads=4,
        n_kv=max(1, 4 * cfg.n_kv // cfg.n_heads), head_dim=16,
        d_ff=128 if moe is None else 0, moe=moe, dtype="float32")


# blockwise_attention's chunks at the smoke reduction (lm_smoke's q_chunk
# and kv_chunk; the port's LMConfig does not carry them)
SMOKE_CHUNKS = dict(q_chunk=32, kv_chunk=32)


def train_optimizer() -> AdamW:
    """The ``train_4k`` cell's optimizer: ``AdamW(lr=3e-4)`` (weight
    decay 0.1, warm-up 100, clipping at norm 1)."""
    return AdamW(lr=3e-4)


def train_step(model: LM, opt: AdamW, opt_state: AdamWState, batch: dict,
               cfg: LMConfig, *, micro: int = 1,
               chunks: Optional[dict] = None,
               timer: Optional[StageTimer] = None
               ) -> tuple[AdamWState, torch.Tensor]:
    """The ``train_4k`` cell's step on ``batch`` (``tokens``, ``targets``:
    ``(B, S)``), then one ``opt`` update of ``model`` in place.

    With ``micro == 1``: ``lm_loss`` and its gradient. With ``micro > 1``
    (``B % micro == 0``): the reference's micro path — ``lm_loss`` of
    each ``B/micro``-row micro-batch in order, their gradients summed from
    zero in each parameter's ``.grad`` (in place), divided by ``micro``,
    and the loss the mean of the micro losses. ``chunks``: the
    ``q_chunk``/``kv_chunk`` of ``lm_loss`` (its defaults when None).
    With ``timer``, the stages ``forward``, ``backward`` (summed over
    micro-batches) and ``optimizer`` are timed. The gradients are released
    after the update. Returns the new state and the loss.

    A ``model`` on a train mesh (:class:`LM` with ``rules``) takes the
    mesh's step, :func:`_mesh_step`, with its ``opt_state`` from
    ``opt.init(zero1_params(model))``."""
    if model.tensor_parallel:
        return _mesh_step(model, opt, opt_state, batch, cfg, micro=micro,
                          chunks=chunks, timer=timer)
    tokens, targets = batch["tokens"], batch["targets"]
    b = tokens.shape[0]
    if micro < 1 or b % micro:
        raise ValueError(f"batch {b} does not split into {micro} "
                         "micro-batches")
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None if micro == 1 else torch.zeros_like(p)
    mb = b // micro
    losses = []
    if timer:
        timer.start()
    for i in range(micro):
        rows = slice(i * mb, (i + 1) * mb)
        loss = lm_loss(model, tokens[rows], targets[rows], cfg,
                       **(chunks or {}))
        if timer:
            timer.lap("forward")
        loss.backward()
        if timer:
            timer.lap("backward")
        losses.append(loss.detach())
    grads = {k: p.grad for k, p in params.items()}
    if micro > 1:
        for g in grads.values():
            g.div_(micro)
    loss = losses[0] if micro == 1 else torch.stack(losses).mean()
    _, opt_state = opt.update(grads, opt_state, params)
    for p in params.values():
        p.grad = None
    if timer:
        timer.lap("optimizer")
    return opt_state, loss


# ---------------------------------------------------------------------------
# the train_4k step over a ("data", "model") mesh (dense archs by ZeRO-1,
# MoE archs by full FSDP)
# ---------------------------------------------------------------------------
def train_rules(mesh, cfg: LMConfig) -> Rules:
    """The rules the ``train_4k`` cell lays its weights out by
    (``src/repro/configs/lm_common.py:147-156``): for a dense arch the
    reference's ZeRO-1, ``lm_rules`` with ``"fsdp"`` rebound to None, so
    the weights split over ``"model"`` (``"tp"``, ``"tp_kv"``,
    ``"vocab_tp"``) and are replicated over the data axes
    (:mod:`repro_torch.models.tensor_parallel`); an MoE keeps full FSDP,
    ``lm_rules`` itself, so every weight is split over the data axes too
    and its experts over ``"model"`` (:mod:`repro_torch.models.fsdp`).
    The optimizer state always takes ``lm_rules(mesh, "train_4k",
    cfg)``."""
    rules = lm_rules(mesh, "train_4k", cfg)
    if cfg.moe is not None:
        return rules
    return Rules({**rules.table, "fsdp": None})


@dataclasses.dataclass(frozen=True)
class Zero1Layout:
    """Where each shard's state of an LM on a train mesh lies. Under an
    MoE's full FSDP the weight block is the state block: each shard
    updates its whole block, and a weight's distinct blocks are one a
    shard but where it is replicated over ``"model"`` (the router, the
    norm gains), so the update leaves nothing to gather
    (:attr:`gathers` is False).

    Attributes:
        shapes: each parameter's whole shape, by name.
        weight: each shard's block of each weight (the model's, under
            :func:`train_rules`).
        state: each shard's block of each weight's AdamW state (under
            ``lm_rules(mesh, "train_4k", cfg)``: FSDP over the data axes,
            TP over ``"model"``), inside its weight block.
        holders: for each weight and shard, the shards that hold the same
            weight block, in shard order (its data replicas, and every
            shard for a weight replicated over ``"model"``).
        owners: for each weight, the first shard of each distinct state
            block, in shard order.
    """

    shapes: dict
    weight: dict
    state: dict
    holders: dict
    owners: dict

    @property
    def gathers(self) -> bool:
        """Whether a shard's state block is smaller than its weight block
        somewhere (ZeRO-1), so the updated blocks are gathered."""
        return any(self.state[n] != self.weight[n] for n in self.shapes)

    def view(self, model: LM, shard: int, name: str,
             of: Optional[int] = None) -> torch.Tensor:
        """Shard ``shard``'s weight ``name`` at shard ``of``'s state block
        (its own by default): a view into the weight."""
        of = shard if of is None else of
        w = model.shards[shard].get_parameter(name)
        return w[block_slices(self.state[name][of],
                              self.weight[name][shard])]


def zero1_layout(model: LM) -> Zero1Layout:
    """The :class:`Zero1Layout` of a tensor-parallel ``model``."""
    mesh, cfg = model.mesh, model.cfg
    state = param_blocks(cfg, mesh, lm_rules(mesh, "train_4k", cfg))
    weight = {n: b for n, (_, b) in model.blocks.items()}
    holders, owners = {}, {}
    for name, blocks in weight.items():
        holders[name] = [tuple(j for j, b in enumerate(blocks) if b == mine)
                         for mine in blocks]
        seen = {}
        for i, b in enumerate(state[name][1]):
            seen.setdefault(b, i)
        owners[name] = tuple(seen.values())
    return Zero1Layout({n: s for n, (s, _) in model.blocks.items()}, weight,
                       {n: b for n, (_, b) in state.items()}, holders,
                       owners)


def zero1_params(model: LM, layout: Optional[Zero1Layout] = None) -> dict:
    """``{(shard, name): view}``: each shard's weights at its state blocks,
    the tensors that ``AdamW.init`` and ``AdamW.update`` take on a
    mesh."""
    layout = layout or zero1_layout(model)
    return {(i, name): layout.view(model, i, name)
            for i in range(model.mesh.world) for name in layout.shapes}


def gathered_opt_state(model: LM, state: AdamWState,
                       device: str | torch.device = "cpu", *,
                       keys: tuple = ("mu", "nu")) -> dict:
    """``{"mu": {name: whole}, "nu": {...}}`` (those of ``keys``): the
    AdamW state of a ``model`` on a train mesh assembled from its shards'
    blocks, under the names of an :class:`LM` without a mesh."""
    layout = zero1_layout(model)
    out = {}
    for key in keys:
        tree = getattr(state, key)
        out[key] = {}
        for name, shape in layout.shapes.items():
            full = torch.empty(shape, dtype=torch.float32, device=device)
            for i in layout.owners[name]:
                full[block_slices(layout.state[name][i])].copy_(
                    tree[(i, name)])
            out[key][name] = full
    return out


def _mesh_step(model: LM, opt: AdamW, opt_state: AdamWState, batch: dict,
               cfg: LMConfig, *, micro: int, chunks: Optional[dict],
               timer: Optional[StageTimer]
               ) -> tuple[AdamWState, torch.Tensor]:
    """:func:`train_step` on a ``model`` on a train mesh, in the
    reference's order:

    1. micro-batch i is rows ``[i·B/micro, (i+1)·B/micro)`` of the batch,
       split over ``"data"`` by the ``"batch"`` spec: data group g takes
       its ``B/micro/D`` rows. A dense arch runs each group's forward
       (:func:`~repro_torch.models.tensor_parallel.group_loss`, over the
       micro-batch's positions) and, the groups together, its backward;
       an MoE couples the groups, so its forward runs every group layer
       by layer (:func:`~repro_torch.models.fsdp.fsdp_loss`), then its
       backward; each shard's gradients add up in its ``.grad`` (a shard
       whose copy of a weight no group read, as the router off the
       groups' home shards, has none);
    2. ``data_sum``: each shard's block of each weight's state takes the
       sum of that block's gradient over every shard holding the weight
       block, in shard order, divided by ``micro`` (when above 1) — the
       reduce over ``"data"`` (ZeRO-1; under full FSDP the gather's
       backward has reduced it), and over ``"model"`` for a weight
       replicated there, each shard its own part;
    3. ``optimizer``: ``AdamW.update`` on those blocks (each shard its
       state block with its own mu and nu), the clipping norm over each
       distinct block once;
    4. ``gather`` (ZeRO-1 only): each shard copies the updated blocks of
       its weight's other parts from their owners, so every replica holds
       the same bits.

    The loss is the mean over micro-batches of the groups' losses summed
    in shard order (and the MoE's aux losses)."""
    mesh = model.mesh
    data = mesh.world // len(model.groups[0])
    tokens, targets = batch["tokens"], batch["targets"]
    b, s = tokens.shape
    if micro < 1 or b % micro:
        raise ValueError(f"batch {b} does not split into {micro} "
                         "micro-batches")
    mb = b // micro
    if mb % data:
        raise ValueError(f"a micro-batch of {mb} rows does not split over "
                         f"a data axis of {data}")
    rows = mb // data
    layout = zero1_layout(model)
    shard_params = [dict(sh.named_parameters()) for sh in model.shards]
    for params in shard_params:
        for p in params.values():
            p.grad = None if micro == 1 else torch.zeros_like(p)
    chunks = {"q_chunk": Q_CHUNK, "kv_chunk": KV_CHUNK, **(chunks or {})}
    home = mesh.devices[0]
    losses = []
    if timer:
        timer.start()
    for i in range(micro):
        toks, tgts = [], []
        for g, group in enumerate(model.groups):
            dev = mesh.devices[group[0]]
            lo = i * mb + g * rows
            toks.append(tokens[lo:lo + rows].to(dev))
            tgts.append(targets[lo:lo + rows].to(dev))
        if cfg.moe is not None:
            group_losses = [fsdp_loss(model, toks, tgts, count=mb * s,
                                      chunk=LOSS_CHUNK, **chunks)]
        else:
            group_losses = [group_loss(model, g, tok, tgt, cfg, count=mb * s,
                                       chunk=LOSS_CHUNK, **chunks)
                            for g, (tok, tgt) in enumerate(zip(toks, tgts))]
        if timer:
            timer.lap("forward")
        torch.autograd.backward(group_losses)
        if timer:
            timer.lap("backward")
        loss = group_losses[0].detach().to(home)
        for part in group_losses[1:]:
            loss = loss + part.detach().to(home)
        losses.append(loss)
    grads = {}
    for name in layout.shapes:
        for i in range(mesh.world):
            region = block_slices(layout.state[name][i],
                                  layout.weight[name][i])
            dev = mesh.devices[i]
            total = None
            for j in layout.holders[name][i]:
                held = shard_params[j][name].grad
                if held is None:
                    continue
                part = held[region].to(dev)
                total = part if total is None else total + part
            if total is None:
                total = torch.zeros_like(layout.view(model, i, name))
            grads[(i, name)] = total / micro if micro > 1 else total
        for j in range(mesh.world):
            shard_params[j][name].grad = None
    if timer:
        timer.lap("data_sum")
    params = zero1_params(model, layout)
    norm_keys = [(i, name) for name in layout.shapes
                 for i in layout.owners[name]]
    _, opt_state = opt.update(grads, opt_state, params, norm_keys=norm_keys)
    del grads
    if timer:
        timer.lap("optimizer")
    loss = losses[0] if micro == 1 else torch.stack(losses).mean()
    if not layout.gathers:
        return opt_state, loss
    with torch.no_grad():
        for name in layout.shapes:
            for i in range(mesh.world):
                mine = layout.state[name][i]
                for o in layout.owners[name]:
                    if o in layout.holders[name][i] \
                            and layout.state[name][o] != mine:
                        layout.view(model, i, name, of=o).copy_(
                            layout.view(model, o, name))
    if timer:
        timer.lap("gather")
    return opt_state, loss


# ---------------------------------------------------------------------------
# Sharding rules and specs (the dry-run's; the reference's functions)
# ---------------------------------------------------------------------------
def lm_rules(mesh, shape: str, cfg: Optional[LMConfig] = None) -> Rules:
    """The reference's ``lm_rules``: batch and FSDP over the data axes,
    TP/expert/vocab over "model"; where the KV heads do not divide the
    model axis, the serve cells' cache shards its sequence over it
    instead; at batch 1 the sequence also takes the data axes."""
    if mesh is None:
        return Rules({})
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    table = {
        "batch": dp, "fsdp": dp, "tp": "model", "tp_kv": "model",
        "expert": "model", "vocab_tp": "model", "seq": None,
    }
    kind = SHAPES[shape]["kind"]
    seq_axes: list = []
    if cfg is not None and kind in ("decode", "prefill") \
            and cfg.n_kv % mesh.shape["model"] != 0:
        table["tp_kv"] = None
        seq_axes.append("model")
    if SHAPES[shape]["batch"] == 1:
        table["batch"] = None
        seq_axes = list(dp) + seq_axes
    table["seq"] = tuple(seq_axes) if seq_axes else None
    return Rules(table)


def lm_param_specs(cfg: LMConfig, mesh, rules: Rules) -> dict:
    """The reference's ``lm_param_specs``: a spec tree shaped as the
    reference's ``lm_init`` dict (per-layer weights stacked ``(L, …)``),
    divisibility-aware."""
    d, h, kv, dh, L = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                       cfg.n_layers)
    s = partial(spec, mesh, rules)
    specs = {
        "embed": s((cfg.vocab, d), "vocab_tp", "fsdp"),
        "unembed": s((d, cfg.vocab), "fsdp", "vocab_tp"),
        "final_ln": (),
        "layers": {
            "ln1": (), "ln2": (),
            "wq": s((L, d, h * dh), None, "fsdp", "tp"),
            "wk": s((L, d, kv * dh), None, "fsdp", "tp_kv"),
            "wv": s((L, d, kv * dh), None, "fsdp", "tp_kv"),
            "wo": s((L, h * dh, d), None, "tp", "fsdp"),
        },
    }
    lay = specs["layers"]
    if cfg.qkv_bias:
        lay["bq"] = s((L, h * dh), None, "tp")
        lay["bk"] = s((L, kv * dh), None, "tp_kv")
        lay["bv"] = s((L, kv * dh), None, "tp_kv")
    if cfg.qk_norm:
        lay["q_norm"] = ()
        lay["k_norm"] = ()
    if cfg.moe is None:
        lay["w1"] = s((L, d, cfg.d_ff), None, "fsdp", "tp")
        lay["w3"] = s((L, d, cfg.d_ff), None, "fsdp", "tp")
        lay["w2"] = s((L, cfg.d_ff, d), None, "tp", "fsdp")
    else:
        m = cfg.moe
        moe = {
            "router": s((L, d, m.num_experts), None, "fsdp", None),
            "w1": s((L, m.num_experts, d, m.d_ff), None, "expert", "fsdp",
                    None),
            "w3": s((L, m.num_experts, d, m.d_ff), None, "expert", "fsdp",
                    None),
            "w2": s((L, m.num_experts, m.d_ff, d), None, "expert", None,
                    "fsdp"),
        }
        if m.n_shared:
            moe["shared"] = {
                "w1": s((L, d, m.d_ff_shared), None, "fsdp", "tp"),
                "w3": s((L, d, m.d_ff_shared), None, "fsdp", "tp"),
                "w2": s((L, m.d_ff_shared, d), None, "tp", "fsdp"),
            }
        lay["moe"] = moe
    return specs


@dataclasses.dataclass(frozen=True)
class ServePlacement:
    """Where a served LM lives on a one-axis ``"model"`` mesh of ``world``
    shards, shard ``i`` on card ``i % cards``.

    Attributes:
        rules: ``lm_rules(mesh, "prefill_32k", cfg)``.
        expert_ranges: each shard's experts ``[lo, hi)`` (empty without
            MoE).
        shard_cards: each shard's card.
        weight_bytes: each card's weights: card 0, the home card, holds
            every non-expert weight (embeddings, attention, norms, routers
            in fp32, shared experts) and its shards' experts; every other
            card its shards' experts.
        cache_bytes: the KV cache on the home card.
    """

    rules: Rules
    expert_ranges: tuple
    shard_cards: tuple
    weight_bytes: tuple
    cache_bytes: int

    @property
    def card_bytes(self) -> tuple:
        """Each card's weights, and the cache on the home card."""
        return (self.weight_bytes[0] + self.cache_bytes,
                *self.weight_bytes[1:])


def serve_placement(cfg: LMConfig, world: int, *, cards: Optional[int] = None,
                    cache_positions: int = 0, batch: int = 1
                    ) -> ServePlacement:
    """The placement of ``cfg`` served in bf16 weights on ``world``
    shards over ``min(cards, world)`` cards (``world`` by default: one a
    card), with a bf16 KV cache of ``batch`` sequences of
    ``cache_positions`` positions in all (the launcher's prefill cache and
    decode cache, which coexist while one is copied into the other).
    Counts the bytes of every parameter an :class:`LM` allocates (on the
    ``meta`` device: nothing is allocated) and splits the experts by the
    reference's ``"expert"`` rule (:func:`~repro_torch.models.moe.
    expert_ranges`: unsharded, all on the home card, when the experts do
    not divide ``world``)."""
    cards = world if cards is None else min(cards, world)
    mesh = ProductionMesh(("model",), (world,))
    rules = lm_rules(mesh, "prefill_32k", cfg)
    model = LM(cfg, dtype=torch.bfloat16, device="meta")
    expert = rest = 0
    for name, p in model.named_parameters():
        nbytes = p.numel() * p.element_size()
        if name.split(".")[-2:-1] == ["moe"] \
                and name.rsplit(".", 1)[-1] in EXPERT_WEIGHTS:
            expert += nbytes
        else:
            rest += nbytes
    ranges = (tuple(expert_ranges(mesh, rules, cfg.moe)) if cfg.moe
              else ((0, 0),) * world)
    per_expert = expert // cfg.moe.num_experts if cfg.moe else 0
    shard_cards = tuple(i % cards for i in range(world))
    weights = [0] * cards
    weights[0] = rest
    for (lo, hi), card in zip(ranges, shard_cards):
        weights[card] += (hi - lo) * per_expert
    cache = (2 * cfg.n_layers * batch * cache_positions * cfg.n_kv
             * cfg.head_dim * CACHE_DTYPE.itemsize)
    return ServePlacement(rules, ranges, shard_cards, tuple(weights), cache)


def lm_param_spec_of(name: str, specs: dict) -> tuple:
    """The spec of the port's parameter ``name`` (``LM.named_parameters``)
    from the reference-shaped tree ``specs``: a layer's tensor takes its
    stacked spec without the leading layer axis; a norm's ``.weight``
    its norm's spec."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts = parts[:-1]
    if parts[0] == "layers":
        node = specs["layers"]
        for p in parts[2:]:
            node = node[p]
        return node[1:]
    return specs[parts[0]]


@dataclasses.dataclass(frozen=True)
class TrainPlacement:
    """Where the ``train_4k`` cell's fp32 state lives on a ``("data",
    "model")`` mesh of ``world`` shards, shard ``i`` on card ``i %
    cards``.

    Attributes:
        weight_bytes: each shard's weights under :func:`train_rules`; its
            gradients take as many.
        state_bytes: each shard's AdamW mu and nu under ``lm_rules(mesh,
            "train_4k", cfg)``.
        shard_cards: each shard's card.
    """

    weight_bytes: tuple
    state_bytes: tuple
    shard_cards: tuple

    @property
    def shard_bytes(self) -> tuple:
        """Each shard's weights, gradients, mu and nu."""
        return tuple(2 * w + st for w, st in zip(self.weight_bytes,
                                                 self.state_bytes))

    @property
    def card_bytes(self) -> tuple:
        """Each card's shards' bytes."""
        out = [0] * (max(self.shard_cards) + 1)
        for card, b in zip(self.shard_cards, self.shard_bytes):
            out[card] += b
        return tuple(out)


def train_placement(cfg: LMConfig, mesh, *, cards: Optional[int] = None
                    ) -> TrainPlacement:
    """The :class:`TrainPlacement` of ``cfg``'s ``train_4k`` cell on
    ``mesh`` (its shape only: a :class:`~repro_torch.launch.mesh.
    ProductionMesh` will do) over ``min(cards, world)`` cards (one a shard
    by default). Counts the fp32 bytes of every parameter an :class:`LM`
    allocates (on the ``meta`` device: nothing is allocated; the QKV
    biases and qk-norm gains included, which ``lm_param_count`` leaves
    out) in each shard's block under the same weight and state specs the
    dry-run's cell takes (:func:`build_lm_cell`) and the runtime lays
    out (:func:`zero1_layout`)."""
    world = math.prod(int(v) for v in mesh.shape.values())
    cards = world if cards is None else min(cards, world)
    weight, state = [0] * world, [0] * world
    for per_shard, blocks in ((weight, param_blocks(cfg, mesh,
                                                    train_rules(mesh, cfg))),
                              (state, param_blocks(cfg, mesh, lm_rules(
                                  mesh, "train_4k", cfg)))):
        for _, shard_blocks in blocks.values():
            for i, block in enumerate(shard_blocks):
                per_shard[i] += 4 * math.prod(hi - lo for lo, hi in block)
    return TrainPlacement(tuple(weight), tuple(2 * b for b in state),
                          tuple(i % cards for i in range(world)))


def fsdp_working_set(cfg: LMConfig, mesh, *, cards: Optional[int] = None
                     ) -> tuple:
    """Each card's bytes of fp32 weights gathered over ``"data"`` and of
    their gradients at the widest point of the ``train_4k`` step on
    ``mesh`` (its shape only) over ``min(cards, world)`` cards, beside
    :func:`train_placement`'s state. Under an MoE's full FSDP
    (:mod:`repro_torch.models.fsdp`) every shard gathers, while a layer
    runs, the whole ``"fsdp"`` dimension of its model block of each of
    that layer's weights split over data (the router on the groups' home
    shards only; of the experts, the ones the shard runs), and its
    gradient comes back as large before it is reduced: the largest of
    the embedding, the unembedding and a layer, summed over a card's
    shards, which all run each layer together. Zero under ZeRO-1 (a
    dense arch's weights are replicated over data) and without a data
    axis. Activations and the activation-dtype casts of the weights are
    not counted."""
    world = math.prod(int(v) for v in mesh.shape.values())
    cards = world if cards is None else min(cards, world)
    rules = train_rules(mesh, cfg)
    held = param_blocks(cfg, mesh, rules)
    whole = param_blocks(cfg, mesh, Rules({**rules.table, "fsdp": None}))
    data, model = mesh.shape.get("data", 1), mesh.shape["model"]
    out = [0] * cards
    for shard in range(world):
        g, m = divmod(shard, model)
        units: dict[str, int] = {}
        for name, (_, blocks) in held.items():
            block = whole[name][1][shard]
            if blocks[shard] == block or (name.endswith(".moe.router")
                                          and m):
                continue
            n = math.prod(hi - lo for lo, hi in block)
            if name.split(".")[-2:-1] == ["moe"] \
                    and name.rsplit(".", 1)[-1] in EXPERT_WEIGHTS:
                lo, hi = block[0]
                a, b = split_range(hi - lo, data)[g]
                n = n // (hi - lo) * (b - a)
            unit = name.split(".")[1] if name.startswith("layers.") else name
            units[unit] = units.get(unit, 0) + 2 * 4 * n
        out[shard % cards] += max(units.values(), default=0)
    return tuple(out)


def _named_shardings(model: LM, mesh, specs: dict) -> Optional[dict]:
    if mesh is None:
        return None
    return tree_shardings(mesh, {n: lm_param_spec_of(n, specs)
                                 for n, _ in model.named_parameters()})


def train_micro(cfg: LMConfig, batch: int, mesh) -> int:
    """The reference cell's gradient-accumulation micro-batches
    (``lm_common.py:167-170``): 4 on a mesh when the batch splits in 4;
    then 8 for an MoE of ``d_model ≥ 4096`` when the batch splits in 8
    (with or without a mesh, as the reference's condition reads)."""
    micro = 4 if (mesh is not None and batch % 4 == 0) else 1
    if micro and cfg.moe is not None and cfg.d_model >= 4096 \
            and batch % 8 == 0:
        micro = 8
    return micro


def build_lm_cell(cfg: LMConfig, shape: str, mesh, *,
                  device: str | torch.device = "cuda") -> CellSpec:
    """The reference's ``build_lm_cell`` on fake tensors of ``device``.

    ``train_4k``: :func:`train_step` with :func:`train_micro`
    micro-batches on fp32 weights and AdamW state (dense archs replicate
    the weights over the data axes, ZeRO-1, while the state keeps FSDP;
    MoE archs keep FSDP). ``prefill_32k``: ``lm_prefill`` on bf16
    weights. ``decode_32k``/``long_500k``: one ``lm_decode_step`` on bf16
    weights at the last position of a full bf16 cache."""
    info = SHAPES[shape]
    rules = lm_rules(mesh, shape, cfg)
    pspecs = lm_param_specs(cfg, mesh, rules)
    B, S = info["batch"], info["seq"]
    dev = torch.device(device)
    mode = FakeTensorMode()
    meta = {"family": "lm", "cfg": cfg, "shape": shape, "info": info,
            "rules": rules}

    if info["kind"] == "train":
        opt = train_optimizer()
        micro = train_micro(cfg, B, mesh)
        # ZeRO-1 for a dense arch: weights replicated over dp
        wspecs = lm_param_specs(cfg, mesh, train_rules(mesh, cfg))
        with mode:
            model = LM(cfg, dtype=torch.float32, device=dev)
            params = dict(model.named_parameters())
            opt_state = opt.init(params)
            batch = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                           device=dev),
                     "targets": torch.empty((B, S), dtype=torch.int32,
                                            device=dev)}
        bspec = {"tokens": spec(mesh, rules, (B, S), "batch", None),
                 "targets": spec(mesh, rules, (B, S), "batch", None)}
        in_sh = None
        if mesh is not None:
            osh = _named_shardings(model, mesh, pspecs)
            in_sh = (_named_shardings(model, mesh, wspecs),
                     AdamWState(step=None, mu=osh, nu=osh),
                     tree_shardings(mesh, bspec))

        def step(model, opt_state, batch):
            return train_step(model, opt, opt_state, batch, cfg,
                              micro=micro)

        def make_args(seed: int, device):
            dev = resolve_device(device)
            gen = torch.Generator(device=dev).manual_seed(seed)
            model = lm_init(gen, cfg)
            tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                   device=dev, dtype=torch.int32)
            return (model, opt.init(dict(model.named_parameters())),
                    {"tokens": tokens, "targets": tokens.roll(-1, 1)})

        return CellSpec(step_fn=step, args=(model, opt_state, batch),
                        in_shardings=in_sh, donate_argnums=(0, 1),
                        kind="train", dtype=cfg.adtype, fake_mode=mode,
                        make_args=make_args,
                        notes=f"micro={micro}",
                        meta={**meta, "micro": micro,
                              "zero1": cfg.moe is None,
                              "batch_spec": bspec["tokens"]})

    cache_shape = (cfg.n_layers, B, S, cfg.n_kv, cfg.head_dim)
    cache_spec = spec(mesh, rules, cache_shape, None, "batch", "seq",
                      "tp_kv", None)
    meta.update(micro=1, zero1=False,
                batch_spec=spec(mesh, rules, (B, 1), "batch", None))
    with mode:
        model = LM(cfg, dtype=torch.bfloat16, device=dev)
    psh = _named_shardings(model, mesh, pspecs)
    if info["kind"] == "prefill":
        with mode:
            tokens = torch.empty((B, S), dtype=torch.int32, device=dev)

        def step(model, tokens):
            return lm_prefill(model, tokens, cfg)

        def make_args(seed: int, device):
            dev = resolve_device(device)
            gen = torch.Generator(device=dev).manual_seed(seed)
            return (lm_init(gen, cfg, dtype=torch.bfloat16),
                    torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                  device=dev, dtype=torch.int32))

        in_sh = (None if mesh is None else
                 (psh, tree_shardings(mesh, spec(mesh, rules, (B, S),
                                                 "batch", None))))
        out_sh = (None if mesh is None else
                  (tree_shardings(mesh, spec(mesh, rules, (B, cfg.vocab),
                                             "batch", "vocab_tp")),
                   tree_shardings(mesh, {"k": cache_spec, "v": cache_spec})))
        return CellSpec(step_fn=step, args=(model, tokens),
                        in_shardings=in_sh, out_shardings=out_sh,
                        kind="serve", dtype=cfg.adtype, fake_mode=mode,
                        make_args=make_args, meta=meta)

    # decode: one new token at the last position of a full cache
    with mode:
        cache = {"k": torch.empty(cache_shape, dtype=torch.bfloat16,
                                  device=dev),
                 "v": torch.empty(cache_shape, dtype=torch.bfloat16,
                                  device=dev)}
        token = torch.empty((B, 1), dtype=torch.int32, device=dev)

    def step(model, cache, token, cache_len):
        return lm_decode_step(model, token, cache, cache_len, cfg)

    def make_args(seed: int, device):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = lm_init(gen, cfg, dtype=torch.bfloat16)
        cache = init_decode_cache(cfg, B, S, torch.bfloat16, device=dev)
        token = torch.randint(0, cfg.vocab, (B, 1), generator=gen,
                              device=dev, dtype=torch.int32)
        return model, cache, token, S

    csh = (None if mesh is None else
           tree_shardings(mesh, {"k": cache_spec, "v": cache_spec}))
    in_sh = (None if mesh is None else
             (psh, csh, tree_shardings(mesh, spec(mesh, rules, (B, 1),
                                                  "batch", None)), None))
    out_sh = (None if mesh is None else
              (tree_shardings(mesh, spec(mesh, rules, (B, cfg.vocab),
                                         "batch", "vocab_tp")), csh))
    return CellSpec(step_fn=step, args=(model, cache, token, S),
                    in_shardings=in_sh, out_shardings=out_sh,
                    donate_argnums=(1,), kind="serve", dtype=cfg.adtype,
                    fake_mode=mode, make_args=make_args, meta=meta)


# ---------------------------------------------------------------------------
# Smoke runner shared by all LM archs (reduced dims, CPU-concrete)
# ---------------------------------------------------------------------------
def lm_smoke(cfg_full: LMConfig, *, model: Optional[LM] = None,
             tokens: Optional[torch.Tensor] = None) -> dict:
    """The reference's ``lm_smoke`` on the CPU at :func:`smoke_config`:
    the loss of ``(2, 64)`` tokens against themselves
    (:data:`SMOKE_CHUNKS`), one decode step on a zeroed ``(2, 32)`` fp32
    cache, and a 16-token prefill. ``model`` and ``tokens`` default to
    draws from seed 0 (pass the reference's, carried over, to compare).
    Returns the loss and shapes; asserts finite outputs."""
    cfg = smoke_config(cfg_full)
    gen = torch.Generator().manual_seed(0)
    if model is None:
        model = lm_init(gen, cfg)
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen)
    with torch.no_grad():
        loss = lm_loss(model, tokens, tokens, cfg, **SMOKE_CHUNKS)
    cache = init_decode_cache(cfg, 2, 32, torch.float32, device="cpu")
    logits, cache = lm_decode_step(model, tokens[:, :1], cache, 1, cfg)
    pl, pc = lm_prefill(model, tokens[:, :16], cfg)
    assert logits.shape == (2, cfg.vocab) and pl.shape == (2, cfg.vocab)
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(logits).all())
    return {"loss": float(loss), "logits_shape": tuple(logits.shape),
            "prefill_cache_k": tuple(pc["k"].shape)}


def make_lm_arch(name: str, cfg: LMConfig, family: str = "lm",
                 description: str = "") -> Arch:
    return Arch(
        name=name, family=family, description=description,
        shape_names=tuple(SHAPES),
        build_cell=lambda shape, mesh, **kw: build_lm_cell(cfg, shape, mesh,
                                                           **kw),
        smoke=lambda: lm_smoke(cfg))
