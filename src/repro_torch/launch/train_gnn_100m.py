"""End-to-end MeshGraphNet training with the whole training substrate
(the loop, AdamW with warm-up, the async checkpoint manager) — the port
of ``examples/train_gnn_100m.py``.

    PYTHONPATH=src python -m repro_torch.launch.train_gnn_100m \\
        [--steps 300] [--params-scale small|full] [--nodes 2048] \\
        [--ckpt-dir DIR] [--device cuda|cpu]

``--params-scale small`` (default) builds 128 hidden × 8 blocks, 985,091
parameters; ``full`` builds 512 hidden × 20 blocks, 37,609,475 parameters
(the reference's file calls them "4M" and "≈100M"; these are the counts
the code gives). The graph is ``power_law_graph(nodes, 8.0, seed=0)``;
step s draws node features, positions and a regression target from
``np.random.default_rng(s)`` (so a resumed run matches an uninterrupted
one); edge features are Δpos ⊕ ‖Δpos‖. The report's ``step_ms`` times
each step but the last from its batch draw to the next one's (on the
card, after a synchronize). AdamW at lr 1e-3 with a 20-step
warm-up and no weight decay; checkpoints every 100 steps, keeping 2,
written asynchronously (to a fresh temporary directory unless
``--ckpt-dir`` is given).
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graph import power_law_graph
from repro_torch.models.common import count_params
from repro_torch.models.meshgraphnet import mgn_forward, mgn_init
from repro_torch.training import AdamW, CheckpointManager, run_training

# (hidden width, processor blocks) of each --params-scale
SCALES = {"small": (128, 8), "full": (512, 20)}
D_FEAT = 64


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="repro_torch.launch.train_gnn_100m")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--params-scale", choices=tuple(SCALES), default="small")
    p.add_argument("--nodes", type=int, default=2048)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def train(args: argparse.Namespace) -> dict:
    """Train per ``args``; returns a report with the per-step losses."""
    dev = resolve_device(args.device)
    d_hidden, n_layers = SCALES[args.params_scale]
    model = mgn_init(torch.Generator().manual_seed(0), d_node_in=D_FEAT,
                     d_edge_in=4, d_hidden=d_hidden, n_layers=n_layers,
                     d_out=3, device=dev)
    n_params = count_params(model)
    print(f"[train] MeshGraphNet {n_params:,} params "
          f"({d_hidden}h x {n_layers}L)")

    graph = power_law_graph(args.nodes, 8.0, seed=0)
    src, dst = (torch.as_tensor(a, device=dev).long()
                for a in graph.to_coo())
    n = graph.num_nodes
    starts = []  # each step's start, after the previous step's device work

    def batch_fn(step: int) -> dict:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        starts.append(time.perf_counter())
        rng = np.random.default_rng(step)   # deterministic → restart-safe
        pos = rng.normal(size=(n, 3)).astype(np.float32)
        x = rng.normal(size=(n, D_FEAT)).astype(np.float32)
        target = np.tanh(x[:, :3] * 0.5) + 0.1 * pos
        return {k: torch.from_numpy(v).to(dev) for k, v in
                (("x", x), ("pos", pos), ("y", target.astype(np.float32)))}

    losses = []

    def loss_fn(m, batch):
        s, d = src.clamp_min(0), dst.clamp_min(0)
        rel = batch["pos"][d] - batch["pos"][s]
        dist = torch.sqrt((rel ** 2).sum(-1, keepdim=True) + 1e-12)
        ef = torch.cat([rel, dist], dim=-1)
        out = mgn_forward(m, batch["x"], ef, src, dst, num_nodes=n)
        loss = torch.mean((out - batch["y"]) ** 2)
        losses.append(loss.detach())
        return loss

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="mgn_ckpt_")
    t0 = time.perf_counter()
    state = run_training(
        loss_fn=loss_fn, model=model,
        opt=AdamW(lr=1e-3, weight_decay=0.0, warmup_steps=20),
        batch_fn=batch_fn, steps=args.steps,
        ckpt=CheckpointManager(ckpt_dir, keep=2, async_write=True),
        ckpt_every=100, log_every=20)
    print(f"[train] finished step {state.step}; checkpoints in {ckpt_dir}")
    return {"params": n_params, "scale": args.params_scale,
            "nodes": n, "edges": graph.num_edges, "device": str(dev),
            "step": state.step, "losses": [float(x) for x in losses],
            "wall_s": time.perf_counter() - t0, "ckpt_dir": ckpt_dir,
            # each step but the last (which ends in the final checkpoint)
            "step_ms": [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    report = train(parse_args(argv))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
