"""GNN training launcher on PyTorch: GIN-TU full-graph node classification.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 100 \\
        [--ckpt-dir DIR] [--nodes 4096 --edges 32768 --d-feat 64 \\
         --classes 16] [--device cuda|cpu]

The reference launcher's CLI (``src/repro/launch/train.py``): a synthetic
graph per step from ``make_concrete_batch(info, seed=step)`` (uniform
random edges, so step n always sees batch n and a resumed run matches an
uninterrupted one), the ``gin-tu`` model at its published widths (5
layers, 64 hidden), AdamW (lr ``--lr``, no weight decay) and the
checkpoint manager. Every layer's neighbor sum is the ``segment_spmm``
CUDA kernel, forward and backward. ``--nodes 2449408 --edges 61859840
--d-feat 100 --classes 47`` is the ``ogb_products`` shape.

Runs on ``--device cuda`` (default; raises without a card) or
``--device cpu``. Only ``--arch gin-tu`` is ported; the other GNN
architectures exit with an error naming the roadmap item.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import gin_tu
from repro_torch.configs.gnn_common import make_concrete_batch
from repro_torch.training import AdamW, CheckpointManager, run_training

# architectures of the reference launcher whose models are not ported yet
NOT_PORTED = ("schnet", "meshgraphnet", "equiformer-v2")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The launcher's flags; an unknown flag exits with an error."""
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
    if args.arch in NOT_PORTED:
        p.exit(2, f"repro_torch.launch.train: --arch {args.arch} is not "
                  "ported yet (ROADMAP A11); only gin-tu runs\n")
    if args.arch != "gin-tu":
        p.exit(2, f"repro_torch.launch.train: unknown --arch {args.arch}\n")
    return args


def train(args: argparse.Namespace) -> dict:
    """Train per ``args``; returns a report with the per-step losses."""
    dev = resolve_device(args.device)
    info = dict(nodes=args.nodes, edges=args.edges, d_feat=args.d_feat,
                classes=args.classes, graphs=None)
    model = gin_tu._init(torch.Generator().manual_seed(0), args.d_feat,
                         args.classes, "custom", device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] {args.arch}: {n_params:,} params")
    losses = []

    def batch_fn(step: int) -> dict:
        return make_concrete_batch(info, seed=step, device=dev)

    def loss_fn(m, batch):
        loss = gin_tu._loss(m, batch, info, "custom")
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
