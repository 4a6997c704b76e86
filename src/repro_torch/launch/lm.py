"""LM launcher on PyTorch: serving (prefill, then greedy decode) by
default, or ``--shape train_4k`` training.

    PYTHONPATH=src python -m repro_torch.launch.lm [--arch qwen3-4b] \\
        [--batch 1 --prompt-len 32768 --new-tokens 16 --requests 1] \\
        [--seed 0] [--smoke] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.lm --shape train_4k \\
        [--arch qwen3-4b] [--steps 3 --batch 1 --micro M] [--seed 0] \\
        [--smoke] [--device cuda|cpu]

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
ms and their stages (forward, backward, optimizer) and peak device
memory. An arch whose fp32 train state (16 bytes a parameter: weights,
gradients, mu, nu) exceeds one card exits with status 2 unless
``--smoke`` (codeqwen1.5-7b 131.0 GB, deepseek-moe-16b 270.1 GB,
phi3.5-moe-42b 670.0 GB): dense training beyond one card needs the
sharded training of ROADMAP A10b; MoE training needs more than four cards
(ROADMAP A13's rest: the state sharded four ways is still 67.5 and 167.5
GB a card). Training takes no ``--mesh-world``.
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
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.models.transformer import (LM, LMConfig, init_decode_cache,
                                            lm_active_param_count,
                                            lm_decode_step, lm_init,
                                            lm_param_count, lm_prefill)
from repro_torch.training import StageTimer

WEIGHT_DTYPE = torch.bfloat16  # serving weights, as the reference's cells
TRAIN_STATE_BYTES = 16         # fp32 weights, gradients, mu and nu
CARD_BYTES = 80e9              # one H100's device memory
SMOKE_TRAIN_SEQ = 64           # --smoke training: two 32-position chunks
TRAIN_CARDS = 4                # the cards a four-card host offers


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
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--steps", type=int, default=3,
                   help="train_4k: optimizer steps")
    p.add_argument("--micro", type=int, default=None,
                   help="train_4k: micro-batches a step (default --batch)")
    p.add_argument("--prompt-len", type=int, default=32768)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--requests", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth to the first N layers")
    p.add_argument("--mesh-world", type=int, default=1,
                   help="serve: shards of an MoE's experts (one a card)")
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)
    if args.arch not in LM_ARCHS:
        p.exit(2, f"repro_torch.launch.lm: unknown --arch {args.arch}\n")
    cfg = config_of(args)
    if args.layers is not None and not 1 <= args.layers <= _depth(args):
        p.exit(2, f"repro_torch.launch.lm: --layers {args.layers} outside "
                  f"1..{_depth(args)}\n")
    n = lm_param_count(cfg)
    if args.shape == "train_4k":
        state = n * TRAIN_STATE_BYTES
        where = (f"more than {TRAIN_CARDS} cards: sharded over "
                 f"{TRAIN_CARDS} its state is still "
                 f"{state / TRAIN_CARDS / 1e9:.1f} GB a card (ROADMAP A13, "
                 "MoE train_4k)" if cfg.moe is not None
                 else "the sharded training of ROADMAP A10b")
        if args.mesh_world != 1:
            p.exit(2, "repro_torch.launch.lm: --mesh-world serves only; "
                      "training runs on one card\n")
        if not args.smoke and state > CARD_BYTES:
            p.exit(2, f"repro_torch.launch.lm: --arch {args.arch} has "
                      f"{n:,} parameters, {state / 1e9:.1f} GB of fp32 "
                      "train state (weights, gradients, mu, nu) against "
                      f"one {CARD_BYTES / 1e9:.0f} GB card: training it "
                      f"needs {where}\n")
        if args.micro is None:
            args.micro = args.batch
        if args.micro < 1 or args.batch % args.micro:
            p.exit(2, f"repro_torch.launch.lm: --batch {args.batch} does "
                      f"not split into --micro {args.micro} micro-batches\n")
        return args
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
    m = model.cfg.moe
    stats = [blk.moe.last_stats for blk in model.layers]
    load = torch.stack([s["expert_load"] for s in stats]).cpu()
    dropped = torch.stack([s["dropped"] for s in stats]).cpu()
    cap = stats[0]["capacity"]
    assignments = tokens * m.top_k
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
    dev = resolve_device(args.device)
    cfg = config_of(args)
    seq = SHAPES["train_4k"]["seq"]
    chunks = None
    if args.smoke:
        seq, chunks = SMOKE_TRAIN_SEQ, lm_common.SMOKE_CHUNKS
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = lm_init(gen, cfg)                        # fp32 weights
    opt = lm_common.train_optimizer()
    state = [opt.init(dict(model.named_parameters()))]

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
    return model, seq, draw, step


def train(args: argparse.Namespace) -> dict:
    """``args.steps`` steps of :func:`train_cell`; returns the report."""
    dev = resolve_device(args.device)
    model, seq, draw, step = train_cell(args)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, stages = [], []
    for _ in range(args.steps):
        batch = draw()
        timer = StageTimer(dev)
        losses.append(float(step(batch, timer)))
        stages.append(timer.ms)
    return {"arch": args.arch, "smoke": args.smoke, "shape": args.shape,
            "device": str(dev), "params": lm_param_count(model.cfg),
            "batch": args.batch, "micro": args.micro, "seq": seq,
            "steps": args.steps, "dtype": model.cfg.dtype, "losses": losses,
            "step_ms": [sum(st.values()) for st in stages],
            "stage_ms": stages,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    report = train(args) if args.shape == "train_4k" else serve(args)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
