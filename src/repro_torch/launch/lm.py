"""LM launcher on PyTorch: serving (prefill, then greedy decode) by
default, or ``--shape train_4k`` training.

    PYTHONPATH=src python -m repro_torch.launch.lm [--arch qwen3-4b] \\
        [--batch 1 --prompt-len 32768 --new-tokens 16 --requests 1] \\
        [--seed 0] [--smoke] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.lm --shape train_4k \\
        [--arch qwen3-4b] [--steps 3 --batch 1 --micro M] [--seed 0] \\
        [--mesh-world W [--model M]] [--layers N] [--smoke] \\
        [--device cuda|cpu]

The port's counterpart of the serve cells that the reference lowers in
``launch/dryrun.py`` (``configs/lm_common.py``: ``prefill_32k`` and
``decode_32k``), run for real on one card. The model is ``--arch`` at its
published widths and full depth with bf16 serving weights, drawn by
``lm_init`` from ``--seed`` on the device (there is no checkpoint).
``--smoke`` serves the reference's smoke reduction
(``lm_common.smoke_config``) instead.

Each request: draw ``(batch, prompt-len)`` prompt tokens from the seed;
``lm_prefill`` (one ``flash_attention`` launch per layer); copy its cache
into a decode cache of ``prompt-len + new-tokens`` positions; take the
greedy argmax as the next token; run ``new-tokens`` ``lm_decode_step``\\ s,
each feeding the last argmax. Prints one JSON report: prefill ms, decode
ms per token, the generated ids, ``flash_attention`` launches and peak
device memory; for an MoE arch also the active parameters and, per
request, the prefill's router stats (:func:`moe_prefill_report`).

Defaults: ``prefill_32k``'s sequence with its batch cut 32 → 1 (32
sequences' bf16 cache alone is 154.6 GB), decoding on that ~32k cache,
``decode_32k``'s length with its batch cut 128 → 1. Runs on ``--device
cuda`` (default; raises without a card) or ``--device cpu`` — never the
full model on a CPU. ``--layers N`` cuts the depth to the first N layers
(default: the published depth).

``--mesh-world W`` (default 1) serves an MoE arch expert-parallel over a
one-axis ``"model"`` mesh of W shards (``launch/mesh.py``, one a card,
round-robin where W exceeds the cards; on the CPU every shard on the
CPU): each MoE layer's experts split by the reference's ``"expert"`` rule
(``models/moe.py``), everything else and the KV cache on card 0, the home
card. Before anything is drawn the launcher checks each card's bytes
(``lm_common.serve_placement``: weights, and on the home card the prefill
and decode caches) against one 80 GB card and exits with status 2 where
one is over, unless ``--smoke``: phi3.5-moe-42b has 83.75 GB of bf16
weights, so it needs ``--mesh-world 2`` or more, one shard a card (ROADMAP
A13); at ``--mesh-world 3`` its 16 experts do not divide the axis, which
the reference then leaves unsharded, all on the home card. A dense arch
has no experts to split, and exits 2 with ``--mesh-world`` above 1. The
report adds ``mesh_world`` and, for an MoE arch, ``expert_products``
(``torch.bmm`` expert products: three a layer for each expert-holding
shard) and ``cards``: each card's shards, expert ranges, planned bytes,
and on the card its allocated bytes after the draw and its peak.

``--shape train_4k`` runs ``--steps`` steps of the reference's
``train_4k`` cell (``configs/lm_common.py::train_step``: ``lm_loss`` under
autograd, micro-batch accumulation, ``AdamW(lr=3e-4)``) at sequence 4,096
(``--smoke``: 64, the smoke reduction's attention chunks 32) with fp32
weights and AdamW state and activations in the config's dtype (bf16 for
the published configs), drawn by ``lm_init`` from ``--seed``. Each step's
tokens and targets are drawn uniformly from the same generator. Cuts:
the batch 256 → ``--batch`` (default 1), split into ``--micro``
micro-batches (default ``--batch``: one sequence each). The report holds
the losses (step 0 about ln V + 0.5: unit-variance logits at init), step
ms and their stages (forward, backward, optimizer), each card's planned
and allocated bytes and peak.

With ``--mesh-world W`` (and ``--model M``, default W) the arch trains
over a ``("data", "model")`` mesh of ``(W / M, M)`` shards, one a card
(round-robin where W exceeds the cards; every shard on the CPU there),
by the reference's rule (``lm_common.train_rules``), and the batch splits
over ``"data"``. A dense arch takes ZeRO-1, which only rebinds
``"fsdp"``: the weights split over ``"model"`` — head-parallel attention,
column- and row-parallel FFN, vocab-parallel embedding and cross entropy
(``models/tensor_parallel.py``) — and are replicated over ``"data"``,
while AdamW's mu and nu keep FSDP over ``"data"`` and TP over
``"model"``. An MoE arch keeps the reference's full FSDP
(``models/fsdp.py``): every weight and its mu and nu split over
``"data"`` too, the experts over ``"model"`` by ``"expert"``; each layer
gathers its weights over ``"data"`` while it runs (again in its
recompute) and reduces their gradients back to each shard's block, and
the MoE routes each data group's tokens on its home card under one plan
for the whole micro-batch. ``--batch`` then defaults to the smallest
batch whose micro-batches split over ``"data"``, and ``--micro`` to the
reference's ``train_micro`` (4 when the batch splits in 4); a
micro-batch that does not split over ``"data"`` exits with status 2. The
stages add ``data_sum`` (each shard's state block's gradient summed over
the shards holding its weight block) and, under ZeRO-1, ``gather`` (the
updated blocks copied to every replica), and the report each shard's
planned and held bytes of weights and of mu and nu; for an MoE arch each
card's planned working set and, for each step, the router stats of its
last micro-batch (capacity, kept loads and drops by layer).

Before anything is drawn, unless ``--smoke``, the launcher checks each
card's fp32 weights, gradients, mu and nu (``lm_common.train_placement``)
and, for an MoE, the weights gathered over ``"data"`` while a layer runs
and their gradients (``lm_common.fsdp_working_set``) against one 80 GB
card, and exits with status 2 where one is over, naming the smallest
``--model`` that fits, or else the smallest ``--mesh-world`` that fits
one shard a card: codeqwen1.5-7b holds 131.0 GB at world 1, and 32.76 /
49.14 / 81.90 GB a card on four cards at ``--model`` 4 / 2 / 1, so it
trains on four cards at ``--model`` 4 or 2 (ROADMAP A10b);
deepseek-moe-16b holds 270.1 GB at world 1 and 67.56 / 67.53 + 1.25 /
67.52 + 1.68 GB a card on four cards at ``--model`` 4 / 2 / 1, so it
trains on four cards at any; phi3.5-moe-42b holds 670.0 GB, 167.5 GB a
card on four, and needs ``--mesh-world 16`` (41.9 GB a card).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import LM_ARCHS, lm_common
from repro_torch.configs.lm_common import SHAPES, smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import ProductionMesh, make_host_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.models.transformer import (LM, LMConfig, init_decode_cache,
                                            lm_active_param_count,
                                            lm_decode_step, lm_init,
                                            lm_param_count, lm_prefill)
from repro_torch.training import StageTimer

WEIGHT_DTYPE = torch.bfloat16  # serving weights, as the reference's cells
CARD_BYTES = 80e9              # one H100's device memory
SMOKE_TRAIN_SEQ = 64           # --smoke training: two 32-position chunks


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The launcher's flags; an unknown flag or arch, or a model that does
    not fit (module docstring), exits with an error."""
    p = argparse.ArgumentParser(prog="repro_torch.launch.lm")
    p.add_argument("--arch", default="qwen3-4b")
    p.add_argument("--shape", default="prefill_32k",
                   choices=["prefill_32k", "train_4k"],
                   help="prefill_32k: serve (prefill, then decode); "
                        "train_4k: train")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch", type=int, default=None,
                   help="sequences a request or a step (default 1; on a "
                        "train mesh the smallest whose micro-batches "
                        "split over the data axis)")
    p.add_argument("--steps", type=int, default=3,
                   help="train_4k: optimizer steps")
    p.add_argument("--micro", type=int, default=None,
                   help="train_4k: micro-batches a step (default --batch; "
                        "on a mesh the reference's train_micro)")
    p.add_argument("--prompt-len", type=int, default=32768)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--requests", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth to the first N layers")
    p.add_argument("--mesh-world", type=int, default=1,
                   help="serve: shards of an MoE's experts; train_4k: "
                        "shards of the (data, model) mesh (one a card)")
    p.add_argument("--model", type=int, default=None,
                   help="train_4k: the mesh's model axis (default "
                        "--mesh-world: tensor-parallel only)")
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)
    if args.arch not in LM_ARCHS:
        p.exit(2, f"repro_torch.launch.lm: unknown --arch {args.arch}\n")
    cfg = config_of(args)
    if args.layers is not None and not 1 <= args.layers <= _depth(args):
        p.exit(2, f"repro_torch.launch.lm: --layers {args.layers} outside "
                  f"1..{_depth(args)}\n")
    if args.shape == "train_4k":
        refusal = train_refusal(args, cfg)
        if refusal:
            p.exit(2, f"repro_torch.launch.lm: {refusal}\n")
        return args
    if args.model is not None:
        p.exit(2, "repro_torch.launch.lm: --model shapes a train_4k mesh\n")
    if args.batch is None:
        args.batch = 1
    if args.mesh_world < 1:
        p.exit(2, f"repro_torch.launch.lm: --mesh-world {args.mesh_world} "
                  "below 1\n")
    if args.mesh_world > 1 and cfg.moe is None:
        p.exit(2, f"repro_torch.launch.lm: --mesh-world splits an MoE's "
                  f"experts; --arch {args.arch} has none\n")
    if not args.smoke:
        refusal = placement_refusal(args, cfg)
        if refusal:
            p.exit(2, f"repro_torch.launch.lm: {refusal}\n")
    return args


def train_mesh_shape(world: int, model: int) -> ProductionMesh:
    """The ``("data", "model")`` shape of a train mesh of ``world`` shards
    with a model axis of ``model`` (``(1, 1)`` at world 1: one card, no
    mesh)."""
    return ProductionMesh(("data", "model"), (world // model, model))


def train_card_bytes(cfg: LMConfig, world: int, model: int,
                     cards: Optional[int]) -> tuple[tuple, tuple]:
    """Each card's fp32 train state (``lm_common.train_placement``) and
    gathered working set (``lm_common.fsdp_working_set``) for ``world``
    shards at ``--model model`` over ``cards`` cards (one a shard by
    default)."""
    mesh = train_mesh_shape(world, model)
    return (lm_common.train_placement(cfg, mesh, cards=cards).card_bytes,
            lm_common.fsdp_working_set(cfg, mesh, cards=cards))


def _fits(cfg: LMConfig, world: int, model: int,
          cards: Optional[int]) -> bool:
    state, work = train_card_bytes(cfg, world, model, cards)
    return max(a + b for a, b in zip(state, work)) <= CARD_BYTES


def train_refusal(args: argparse.Namespace, cfg: LMConfig
                  ) -> Optional[str]:
    """Settle ``--model``, ``--batch`` and ``--micro`` of a ``train_4k``
    run (module docstring) in ``args``; returns why it cannot run, or
    None. The memory check (skipped with ``--smoke``) is per card:
    ``lm_common.train_placement``'s fp32 weights, gradients, mu and nu on
    each card of ``--mesh-world`` shards (one a card, or round-robin over
    this host's cards) and an MoE's gathered working set
    (``lm_common.fsdp_working_set``), against one 80 GB card."""
    world = args.mesh_world
    model = world if args.model is None else args.model
    if world < 1 or model < 1 or world % model:
        return (f"--model {model} does not divide --mesh-world {world} "
                "shards")
    args.model = model
    mesh = train_mesh_shape(world, model)
    data = world // model
    if args.batch is None:
        args.batch = next(b for b in range(data, 1 << 20, data)
                          if world == 1 or (b // lm_common.train_micro(
                              cfg, b, mesh)) % data == 0)
    if args.micro is None:
        args.micro = (args.batch if world == 1
                      else lm_common.train_micro(cfg, args.batch, mesh))
    if args.micro < 1 or args.batch % args.micro:
        return (f"--batch {args.batch} does not split into --micro "
                f"{args.micro} micro-batches")
    if (args.batch // args.micro) % data:
        return (f"a micro-batch of {args.batch // args.micro} sequences "
                f"does not split over the data axis of {data}")
    if args.smoke:
        return None
    cards = _cards(args)
    place = lm_common.train_placement(cfg, mesh, cards=cards)
    work = lm_common.fsdp_working_set(cfg, mesh, cards=cards)
    over = [c for c, (b, w) in enumerate(zip(place.card_bytes, work))
            if b + w > CARD_BYTES]
    if not over:
        return None
    fits_world = next((w for w in (2, 4, 8, 16, 32, 64)
                       if _fits(cfg, w, w, None)), None)
    if world == 1:
        n = place.weight_bytes[0] // 4
        rule = ("the reference's full FSDP: its experts split over the "
                "model axis, every weight and its state over the data axis"
                if cfg.moe is not None else
                "its weights split over a mesh of cards by the reference's "
                "rule, tensor-parallel over the model axis with ZeRO-1 "
                "state (ROADMAP A10b)")
        return (f"--arch {args.arch} has {n:,} parameters, "
                f"{place.card_bytes[0] / 1e9:.1f} GB of fp32 train state "
                "(weights, gradients, mu, nu) against one "
                f"{CARD_BYTES / 1e9:.0f} GB card: training it needs "
                f"{rule}; the smallest that fits, one shard a card, is "
                f"--mesh-world {fits_world}")
    c = over[0]
    shards = [i for i, card in enumerate(place.shard_cards) if card == c]
    weights = sum(2 * place.weight_bytes[i] for i in shards)
    state = sum(place.state_bytes[i] for i in shards)
    fits = next((m for m in range(1, world + 1)
                 if world % m == 0 and _fits(cfg, world, m, cards)), None)
    smallest = (f"the smallest --model that fits is {fits}" if fits
                else f"no --model fits --mesh-world {world} over "
                     f"{cards or world} card(s); the smallest --mesh-world "
                     f"that fits, one shard a card, is {fits_world}")
    gathered = (f", {work[c] / 1e9:.2f} GB gathered over the data axis "
                "while a layer runs" if work[c] else "")
    return (f"--arch {args.arch} at --mesh-world {world} --model {model} "
            f"over {cards or world} card(s): card {c} would hold "
            f"{(place.card_bytes[c] + work[c]) / 1e9:.2f} GB of fp32 train "
            f"state ({weights / 1e9:.2f} GB of weights and gradients, "
            f"{state / 1e9:.2f} GB of mu and nu{gathered}) against "
            f"{CARD_BYTES / 1e9:.0f} GB; {smallest}")


def config_of(args: argparse.Namespace) -> LMConfig:
    """``--arch``'s config, reduced by ``--smoke`` and cut to ``--layers``
    when given."""
    cfg = LM_ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def _depth(args: argparse.Namespace) -> int:
    """The uncut depth of ``--arch`` (of its smoke reduction with
    ``--smoke``)."""
    cfg = LM_ARCHS[args.arch]
    return (smoke_config(cfg) if args.smoke else cfg).n_layers


def _cards(args: argparse.Namespace) -> Optional[int]:
    """The cards a mesh of ``args`` spreads over: this host's, on a
    card; else None (one a shard)."""
    if args.device == "cuda" and torch.cuda.is_available():
        return torch.cuda.device_count()
    return None


def placement(args: argparse.Namespace, cfg: LMConfig,
              world: Optional[int] = None, cards: Optional[int] = None
              ) -> lm_common.ServePlacement:
    """``lm_common.serve_placement`` of a request of ``args``: bf16
    weights on ``world`` (``--mesh-world``) shards; the prefill cache of
    ``--prompt-len`` and the decode cache of ``--prompt-len +
    --new-tokens`` positions."""
    return lm_common.serve_placement(
        cfg, world or args.mesh_world, cards=cards, batch=args.batch,
        cache_positions=2 * args.prompt_len + args.new_tokens)


def placement_refusal(args: argparse.Namespace, cfg: LMConfig
                      ) -> Optional[str]:
    """Why ``args`` does not fit, one card at a time, or None."""
    world, cards = args.mesh_world, _cards(args)
    place = placement(args, cfg, cards=cards)
    over = [c for c, b in enumerate(place.card_bytes) if b > CARD_BYTES]
    if not over:
        return None
    n = lm_param_count(cfg)
    weights = n * WEIGHT_DTYPE.itemsize
    fits = next((w for w in range(2, 65) if cfg.moe and max(
        placement(args, cfg, world=w).card_bytes) <= CARD_BYTES), None)
    smallest = (f"the smallest that fits, one shard a card, is "
                f"--mesh-world {fits}" if fits else "no --mesh-world fits")
    if world == 1 and weights > CARD_BYTES:
        return (f"--arch {args.arch} has {n:,} parameters, "
                f"{weights / 1e9:.2f} GB of bf16 weights against one "
                f"{CARD_BYTES / 1e9:.0f} GB card: serving it needs its "
                "experts sharded over a mesh of cards (ROADMAP A13, "
                f"expert-parallel serving; {smallest})")
    c = over[0]
    why = (f"--arch {args.arch} at --mesh-world {world} over "
           f"{cards or world} card(s): card {c} would hold "
           f"{place.card_bytes[c] / 1e9:.2f} GB ("
           f"{place.weight_bytes[c] / 1e9:.2f} GB of bf16 weights"
           + (f", {place.cache_bytes / 1e9:.2f} GB of KV cache" if c == 0
              else "") + f") against {CARD_BYTES / 1e9:.0f} GB")
    if cfg.moe and world > 1 and cfg.moe.num_experts % world:
        why += (f"; its {cfg.moe.num_experts} experts do not divide "
                f"{world} shards, so the expert axis is unsharded, as in "
                "the reference, and the home card holds them all")
    return f"{why}; {smallest}"


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def moe_prefill_report(model: LM, tokens: int) -> dict:
    """The router stats each MoE layer kept from a prefill of ``tokens``
    tokens: ``capacity``, ``assignments`` (``T·k`` a layer),
    ``dropped_by_layer`` and their sum ``dropped`` with its share of
    ``T·k·L``, ``max_load_share_by_layer`` (the largest expert load over
    ``capacity``) and ``expert_load_by_layer``."""
    return moe_router_report([blk.moe.last_stats for blk in model.layers],
                             tokens, model.cfg.moe.top_k)


def moe_router_report(stats: list[dict], tokens: int, top_k: int) -> dict:
    """:func:`moe_prefill_report` of each layer's router ``stats`` over
    ``tokens`` tokens (a prefill, or a training micro-batch)."""
    load = torch.stack([s["expert_load"] for s in stats]).cpu()
    dropped = torch.stack([s["dropped"] for s in stats]).cpu()
    cap = stats[0]["capacity"]
    assignments = tokens * top_k
    return {"capacity": cap, "assignments": assignments,
            "dropped": int(dropped.sum()),
            "dropped_share": float(dropped.sum()) / (assignments
                                                     * len(stats)),
            "dropped_by_layer": dropped.tolist(),
            "max_load_share_by_layer": (load.max(1).values / cap).tolist(),
            "expert_load_by_layer": load.long().tolist()}


def _card_report(model: LM, args: argparse.Namespace) -> list[dict]:
    """Each card of ``model``'s mesh (the home card alone without one):
    its shards, their expert ranges, its planned bytes
    (:func:`placement`) and, on a card, its allocated bytes now."""
    cfg = model.cfg
    mesh = model.mesh
    devices = mesh.devices if mesh is not None else (
        next(model.parameters()).device,)
    groups: dict[str, list[int]] = {}
    for i, dev in enumerate(devices):
        groups.setdefault(str(dev), []).append(i)
    place = placement(args, cfg, cards=len(groups))
    out = []
    for c, (name, shards) in enumerate(groups.items()):
        dev = torch.device(name)
        out.append({
            "device": name, "shards": shards,
            "experts": [list(place.expert_ranges[i]) for i in shards],
            "planned_bytes": place.card_bytes[c],
            "bytes": (torch.cuda.memory_allocated(dev)
                      if dev.type == "cuda" else None)})
    return out


def serve(args: argparse.Namespace) -> dict:
    """Serve ``args.requests`` requests; returns the report."""
    dev = resolve_device(args.device)
    cfg = config_of(args)
    mesh = (make_host_mesh(args.mesh_world, device=dev, axis_name="model")
            if args.mesh_world > 1 else None)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = lm_init(gen, cfg, dtype=WEIGHT_DTYPE, mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    cards = _card_report(model, args) if cfg.moe is not None else None
    card_devs = [torch.device(c["device"]) for c in cards or ()]
    for d in card_devs if dev.type == "cuda" else ():
        torch.cuda.reset_peak_memory_stats(d)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = fa.LAUNCHES.value
    products0 = moe_mod.PRODUCTS.value
    total = args.prompt_len + args.new_tokens
    requests = []
    finite = True
    for _ in range(args.requests):
        tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                               generator=gen, device=dev)
        t0 = _sync(dev)
        logits, cache = lm_prefill(model, tokens, cfg)
        t1 = _sync(dev)
        moe = (moe_prefill_report(model, args.batch * args.prompt_len)
               if cfg.moe is not None else None)
        dcache = init_decode_cache(cfg, args.batch, total, device=dev)
        for key in ("k", "v"):
            dcache[key][:, :, :args.prompt_len] = cache[key]
        del cache
        finite &= bool(torch.isfinite(logits).all())
        token = logits.argmax(-1)
        ids = [token]
        t2 = _sync(dev)
        for step in range(args.new_tokens):
            logits, dcache = lm_decode_step(model, token[:, None], dcache,
                                            args.prompt_len + step + 1, cfg)
            finite &= bool(torch.isfinite(logits).all())
            token = logits.argmax(-1)
            ids.append(token)
        t3 = _sync(dev)
        del dcache
        requests.append({
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_token": ((t3 - t2) * 1e3 / args.new_tokens
                                    if args.new_tokens else None),
            "generated": torch.stack(ids, 1).tolist()})
        if moe is not None:
            requests[-1]["moe_prefill"] = moe
    report = {
        "arch": args.arch, "smoke": args.smoke, "device": str(dev),
        "layers": cfg.n_layers, "mesh_world": args.mesh_world,
        "params": n_params, "active_params": lm_active_param_count(cfg),
        "batch": args.batch,
        "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
        "requests": requests, "logits_finite": finite,
        "flash_launches": fa.LAUNCHES.value - launches0,
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None)}
    if cards is not None:
        for card, d in zip(cards, card_devs):
            card["peak_bytes"] = (torch.cuda.max_memory_allocated(d)
                                  if d.type == "cuda" else None)
        report["cards"] = cards
        report["expert_products"] = moe_mod.PRODUCTS.value - products0
    return report


def train_cell(args: argparse.Namespace
               ) -> tuple[LM, int, Callable, Callable]:
    """The ``train_4k`` cell that ``args`` name (module docstring):
    ``(model, seq, draw() -> batch, step(batch, timer) -> loss)``,
    ``step`` one ``configs/lm_common.py::train_step`` that keeps the
    optimizer state between calls."""
    return _train_cell(args)[:4]


def _train_cell(args: argparse.Namespace) -> tuple:
    """:func:`train_cell` and, last, a one-item list holding the
    optimizer state."""
    dev = resolve_device(args.device)
    cfg = config_of(args)
    seq = SHAPES["train_4k"]["seq"]
    chunks = None
    if args.smoke:
        seq, chunks = SMOKE_TRAIN_SEQ, lm_common.SMOKE_CHUNKS
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    mesh = rules = None
    if args.mesh_world > 1:
        mesh = make_host_mesh(args.mesh_world, model=args.model, device=dev)
        rules = lm_common.train_rules(mesh, cfg)
    model = lm_init(gen, cfg, mesh=mesh, rules=rules)    # fp32 weights
    opt = lm_common.train_optimizer()
    state = [opt.init(lm_common.zero1_params(model) if mesh is not None
                      else dict(model.named_parameters()))]

    def draw() -> dict[str, torch.Tensor]:
        toks = torch.randint(0, cfg.vocab, (2, args.batch, seq),
                             generator=gen, device=dev)
        return {"tokens": toks[0], "targets": toks[1]}

    def step(batch: dict[str, torch.Tensor],
             timer: StageTimer) -> torch.Tensor:
        state[0], loss = lm_common.train_step(
            model, opt, state[0], batch, cfg, micro=args.micro,
            chunks=chunks, timer=timer)
        return loss
    return model, seq, draw, step, state


def train_devices(model: LM) -> list[torch.device]:
    """The distinct devices ``model`` lives on, in shard order."""
    if model.mesh is None:
        return [next(model.parameters()).device]
    return [dev for dev, _ in model.mesh.groups()]


def _shard_bytes(model: LM, state) -> tuple[list, list]:
    """Each shard's bytes of weights and of AdamW mu and nu, as held."""
    if model.mesh is None:
        return ([sum(p.numel() * p.element_size()
                     for p in model.parameters())],
                [sum(t.numel() * t.element_size()
                     for tree in (state.mu, state.nu)
                     for t in tree.values())])
    weights = [sum(p.numel() * p.element_size() for p in sh.parameters())
               for sh in model.shards]
    held = [0] * model.mesh.world
    for tree in (state.mu, state.nu):
        for (i, _), t in tree.items():
            held[i] += t.numel() * t.element_size()
    return weights, held


def train(args: argparse.Namespace, *, keep: Optional[dict] = None
          ) -> dict:
    """``args.steps`` steps of :func:`train_cell`; returns the report. On
    a mesh the report adds each shard's planned and held bytes and each
    card's planned bytes (``lm_common.train_placement``; for an MoE also
    its planned ``working_bytes``, ``lm_common.fsdp_working_set``), bytes
    after the draw and peak; the stages add ``data_sum`` and, for a dense
    arch, ``gather``. For an MoE arch ``moe`` holds each step's router
    stats of its last micro-batch (:func:`moe_router_report`). ``keep``,
    when given, receives the model and the optimizer state after the last
    step (``"model"``, ``"opt_state"``)."""
    model, seq, draw, step, state = _train_cell(args)
    cfg = model.cfg
    devices = train_devices(model)
    planned, work = train_card_bytes(cfg, args.mesh_world, args.model,
                                     len(devices))
    place = lm_common.train_placement(
        cfg, train_mesh_shape(args.mesh_world, args.model),
        cards=len(devices))
    weights, held = _shard_bytes(model, state[0])
    shards = model.mesh.groups() if model.mesh is not None else [
        (devices[0], (0,))]
    cards = [{"device": str(dev), "shards": list(ids),
              "planned_bytes": planned[c],
              "bytes": (torch.cuda.memory_allocated(dev)
                        if dev.type == "cuda" else None)}
             for c, (dev, ids) in enumerate(shards)]
    if cfg.moe is not None:
        for card, w in zip(cards, work):
            card["working_bytes"] = w
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
    losses, stages, moe = [], [], []
    for _ in range(args.steps):
        batch = draw()
        timer = StageTimer(devices)
        losses.append(float(step(batch, timer)))
        stages.append(timer.ms)
        if cfg.moe is not None:
            stats = (model.moe_stats.values() if model.mesh is not None
                     else [blk.moe.last_stats for blk in model.layers])
            moe.append(moe_router_report(
                list(stats), args.batch // args.micro * seq, cfg.moe.top_k))
    for card, dev in zip(cards, devices):
        card["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None)
    if keep is not None:
        keep.update(model=model, opt_state=state[0])
    return {"arch": args.arch, "smoke": args.smoke, "shape": args.shape,
            "device": str(devices[0]), "params": lm_param_count(cfg),
            "param_elements": sum(p.numel() for p in LM(
                cfg, device="meta").parameters()),
            "layers": cfg.n_layers, "mesh_world": args.mesh_world,
            "model": args.model, "data": args.mesh_world // args.model,
            "batch": args.batch, "micro": args.micro, "seq": seq,
            "steps": args.steps, "dtype": cfg.dtype, "losses": losses,
            "step_ms": [sum(st.values()) for st in stages],
            "stage_ms": stages,
            "shard_bytes": {"planned_weights": list(place.weight_bytes),
                            "planned_state": list(place.state_bytes),
                            "weights": weights, "state": held},
            "cards": cards,
            "peak_bytes": (torch.cuda.max_memory_allocated(devices[0])
                           if devices[0].type == "cuda" else None),
            **({"moe": moe} if cfg.moe is not None else {})}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    report = train(args) if args.shape == "train_4k" else serve(args)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
