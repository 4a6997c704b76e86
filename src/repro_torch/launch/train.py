"""GNN training launcher on PyTorch: full-graph training of a GNN
architecture on a synthetic graph.

    PYTHONPATH=src python -m repro_torch.launch.train [--arch gin-tu] \\
        [--steps 100] [--ckpt-dir DIR] [--nodes 4096 --edges 32768 \\
         --d-feat 64 --classes 16] [--device cuda|cpu]

The reference launcher's CLI (``src/repro/launch/train.py``): a synthetic
graph per step from ``make_concrete_batch(info, seed=step)`` (uniform
random edges, random positions and species, so step n always sees batch
n and a resumed run matches an uninterrupted one), the architecture's
model built by its config's ``_reduced_init`` where it has one and
``_init`` otherwise, as the reference does (so ``equiformer-v2`` trains at
its reduced widths here; ``gin-tu``, ``schnet`` and ``meshgraphnet`` at
their published ones), AdamW (lr ``--lr``, no weight decay) and the
checkpoint manager. GIN-TU's neighbor sums are the ``segment_spmm`` CUDA
kernel, forward and backward; the geometric models' message sums are
``segment_sum``. ``--nodes 2449408 --edges 61859840 --d-feat 100
--classes 47`` is the ``ogb_products`` shape.

Runs on ``--device cuda`` (default; raises without a card) or ``--device
cpu``. An architecture that is not a GNN (``qwen3-4b``, ``din``, ...)
exits 2, where the reference asserts; so does an unknown name.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import (equiformer_v2, get_arch, gin_tu,
                                 meshgraphnet, schnet)
from repro_torch.configs.gnn_common import make_concrete_batch
from repro_torch.models.common import count_params
from repro_torch.training import AdamW, CheckpointManager, run_training

# the config module of each GNN architecture (the reference's ``adapters``)
ADAPTERS = {"gin-tu": gin_tu, "schnet": schnet,
            "meshgraphnet": meshgraphnet, "equiformer-v2": equiformer_v2}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The launcher's flags; an unknown flag or architecture, or one that
    is not a GNN, exits with an error."""
    p = argparse.ArgumentParser(prog="repro_torch.launch.train")
    p.add_argument("--arch", default="gin-tu")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--nodes", type=int, default=4096)
    p.add_argument("--edges", type=int, default=32768)
    p.add_argument("--d-feat", type=int, default=64)
    p.add_argument("--classes", type=int, default=16)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    try:
        arch = get_arch(args.arch)
    except KeyError:
        p.exit(2, f"repro_torch.launch.train: unknown --arch {args.arch}\n")
    if arch.family != "gnn":
        p.exit(2, f"repro_torch.launch.train: --arch {args.arch} is not a "
                  f"GNN (family {arch.family}); the train launcher drives "
                  f"{', '.join(sorted(ADAPTERS))}\n")
    return args


def train(args: argparse.Namespace) -> dict:
    """Train per ``args``; returns a report with the per-step losses."""
    dev = resolve_device(args.device)
    info = dict(nodes=args.nodes, edges=args.edges, d_feat=args.d_feat,
                classes=args.classes, graphs=None)
    mod = ADAPTERS[args.arch]
    init = getattr(mod, "_reduced_init", None) or mod._init
    model = init(torch.Generator().manual_seed(0), args.d_feat, args.classes,
                 "custom", device=dev)
    n_params = count_params(model)
    print(f"[train] {args.arch}: {n_params:,} params")
    losses = []

    def batch_fn(step: int) -> dict:
        return make_concrete_batch(info, seed=step, device=dev)

    def loss_fn(m, batch):
        loss = mod._loss(m, batch, info, "custom")
        losses.append(loss.detach())
        return loss

    ckpt = (CheckpointManager(args.ckpt_dir, async_write=True)
            if args.ckpt_dir else None)
    t0 = time.perf_counter()
    state = run_training(loss_fn=loss_fn, model=model,
                         opt=AdamW(lr=args.lr, weight_decay=0.0),
                         batch_fn=batch_fn, steps=args.steps, ckpt=ckpt,
                         ckpt_every=args.ckpt_every)
    report = {"arch": args.arch, "params": n_params, "device": str(dev),
              "step": state.step, "losses": [float(x) for x in losses],
              "wall_s": time.perf_counter() - t0}
    print(f"[train] done at step {state.step}")
    return report


def main(argv: Optional[Sequence[str]] = None) -> dict:
    report = train(parse_args(argv))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
