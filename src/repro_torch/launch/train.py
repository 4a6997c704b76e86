"""GNN training launcher on PyTorch: full-graph training of a GNN
architecture on a synthetic graph.

    PYTHONPATH=src python -m repro_torch.launch.train [--arch gin-tu] \\
        [--steps 100] [--ckpt-dir DIR] [--nodes 4096 --edges 32768 \\
         --d-feat 64 --classes 16] [--mesh-world W [--cap-pp C]] \\
        [--device cuda|cpu]

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

``--mesh-world W`` trains through the halo-sharded step
(``gnn_common.build_halo_cell``; ``gin-tu`` and ``equiformer-v2``, the
architectures with a sharded loss): W logical shards on the mesh of
``launch/mesh.py``, round-robin over the cards (W shards share one card
where there is one), each step's batch partitioned by destination owner,
parameters replicated. ``--cap-pp`` defaults to the reference's
``max(16, int(edges / W · 0.4 / W))``. The report adds the world,
``cap_pp``, the first batch's ``remote_fraction`` and the exchange
counters (``halo``).

Runs on ``--device cuda`` (default; raises without a card) or ``--device
cpu``. An architecture that is not a GNN exits 2, where the reference
asserts; so does an unknown name. The LMs train through
``repro_torch.launch.lm --shape train_4k`` and DIN through
``repro_torch.launch.recsys_din --train-steps N``.
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
from repro_torch.configs.gnn_common import (build_halo_cell,
                                            make_concrete_batch, use_halo)
from repro_torch.core.halo import remote_fraction
from repro_torch.launch.mesh import make_host_mesh
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
    p.add_argument("--mesh-world", type=int, default=None,
                   help="train through the halo-sharded step on this many "
                        "logical shards, round-robin over the cards")
    p.add_argument("--cap-pp", type=int, default=None,
                   help="per-peer request capacity of the halo exchange "
                        "(default: the reference's formula)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    try:
        arch = get_arch(args.arch)
    except KeyError:
        p.exit(2, f"repro_torch.launch.train: unknown --arch {args.arch}\n")
    if arch.family != "gnn":
        p.exit(2, f"repro_torch.launch.train: --arch {args.arch} is not a "
                  f"GNN (family {arch.family}); the train launcher drives "
                  f"{', '.join(sorted(ADAPTERS))} (LMs train through "
                  "repro_torch.launch.lm --shape train_4k, DIN through "
                  "repro_torch.launch.recsys_din --train-steps N)\n")
    if args.cap_pp is not None and args.mesh_world is None:
        p.exit(2, "repro_torch.launch.train: --cap-pp needs --mesh-world\n")
    if args.mesh_world is not None:
        info = dict(nodes=args.nodes, edges=args.edges)
        if arch.adapter.loss_sharded is None:
            p.exit(2, f"repro_torch.launch.train: --arch {args.arch} has no "
                      "halo-sharded loss; --mesh-world trains gin-tu and "
                      "equiformer-v2\n")
        if args.mesh_world < 1 or not use_halo(arch.adapter, "custom", info,
                                               args.mesh_world):
            p.exit(2, f"repro_torch.launch.train: --mesh-world "
                      f"{args.mesh_world} must be at least 1 and divide "
                      f"--nodes {args.nodes} and --edges {args.edges}\n")
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
    sharded = {}
    if args.mesh_world is None:
        def batch_fn(step: int) -> dict:
            return make_concrete_batch(info, seed=step, device=dev)

        def model_loss(m, batch):
            return mod._loss(m, batch, info, "custom")
    else:
        cell = build_halo_cell(get_arch(args.arch).adapter, info, "custom",
                               make_host_mesh(args.mesh_world, device=dev),
                               cap_pp=args.cap_pp)
        sharded = {"mesh_world": args.mesh_world,
                   "cards": len(cell.ctx.groups), "cap_pp": cell.ctx.cap_pp,
                   "halo": cell.ctx.stats}
        print(f"[train] halo-sharded: {args.mesh_world} shards on "
              f"{len(cell.ctx.groups)} card(s), cap_pp {cell.ctx.cap_pp}")

        def batch_fn(step: int) -> list[dict]:
            batch = make_concrete_batch(info, seed=step, device="cpu")
            if "remote_fraction" not in sharded:
                sharded["remote_fraction"] = remote_fraction(
                    batch["src"].numpy(), batch["dst"].numpy(),
                    info["nodes"], args.mesh_world)
            return cell.shard(batch)

        model_loss = cell.loss

    def loss_fn(m, batch):
        loss = model_loss(m, batch)
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
              "wall_s": time.perf_counter() - t0, **sharded}
    print(f"[train] done at step {state.step}")
    return report


def main(argv: Optional[Sequence[str]] = None) -> dict:
    report = train(parse_args(argv))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
