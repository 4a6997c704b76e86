"""Shapes, the unified batch, the losses and the per-architecture adapter
shared by the GNN architectures — ``src/repro/configs/gnn_common.py``
without its JAX-only cell, mesh and sharding machinery
(``build_gnn_cell``, ``gnn_rules``, ``gnn_smoke``, ``CellSpec``; dry-run
only, ROADMAP A12).

Shapes:
  full_graph_sm — full-batch train, N=2,708 / E=10,556 / d=1,433 (Cora)
  minibatch_lg  — sampled train on a Reddit-scale graph (1,024 seeds,
                  fan-out 15-10, d=300)
  ogb_products  — full-batch train, N=2,449,029 / E=61,859,140 / d=100
  molecule      — batched small graphs, 128 molecules × 30 atoms / 64 edges

The unified batch is ``{node_feat, positions, species, src, dst,
labels(, mol_id)}``; every architecture consumes the subset it needs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import Arch

SHAPES = {
    # padded from N=2,708 / E=10,556 to multiples of 32
    "full_graph_sm": dict(nodes=2720, edges=10560, d_feat=1433, classes=7,
                          graphs=None),
    "minibatch_lg": dict(nodes=1024 + 15360 + 153600,
                         edges=1024 * 15 + 15360 * 10, d_feat=300,
                         classes=41, graphs=None, seeds=1024),
    # padded from N=2,449,029 / E=61,859,140 to multiples of 512
    "ogb_products": dict(nodes=2449408, edges=61859840, d_feat=100,
                         classes=47, graphs=None),
    "molecule": dict(nodes=128 * 30, edges=128 * 64, d_feat=16, classes=None,
                     graphs=128),
}

REDUCED = {
    "full_graph_sm": dict(nodes=128, edges=512, d_feat=24, classes=7,
                          graphs=None),
    "minibatch_lg": dict(nodes=16 + 64 + 192, edges=16 * 4 + 64 * 3,
                         d_feat=16, classes=8, graphs=None, seeds=16),
    "ogb_products": dict(nodes=256, edges=1024, d_feat=12, classes=5,
                         graphs=None),
    "molecule": dict(nodes=8 * 6, edges=8 * 14, d_feat=8, classes=None,
                     graphs=8),
}


def make_concrete_batch(info: dict, *, seed: int = 0,
                        device: str | torch.device = "cuda"
                        ) -> dict[str, torch.Tensor]:
    """A synthetic batch of ``info``'s shape, drawn on the host from
    ``np.random.default_rng(seed)`` in the reference's order (node_feat,
    positions, species, src, dst, then labels), so one seed gives the same
    graph, features and labels as the reference's ``make_concrete_batch``.
    Edges are uniform random. Float arrays are float32, integer arrays
    int32; then the batch is copied to ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n, e = info["nodes"], info["edges"]
    batch = {
        "node_feat": rng.normal(size=(n, info["d_feat"])).astype(np.float32),
        "positions": rng.normal(size=(n, 3)).astype(np.float32),
        "species": rng.integers(0, 8, n).astype(np.int32),
        "src": rng.integers(0, n, e).astype(np.int32),
        "dst": rng.integers(0, n, e).astype(np.int32),
    }
    if info["graphs"] is not None:
        per = n // info["graphs"]
        batch["mol_id"] = np.repeat(np.arange(info["graphs"]),
                                    per).astype(np.int32)
        batch["labels"] = rng.normal(size=(info["graphs"],)).astype(
            np.float32)
    else:
        n_lab = info.get("seeds", n)
        batch["labels"] = rng.integers(0, info["classes"], n_lab).astype(
            np.int32)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def classification_loss(logits: torch.Tensor, labels: torch.Tensor
                        ) -> torch.Tensor:
    """Mean softmax cross-entropy over the first ``len(labels)`` rows."""
    logits = logits[:labels.shape[0]].float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (lse - tgt).mean()


def regression_loss(pred: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Mean squared error of ``pred[..., 0]``."""
    return F.mse_loss(pred[..., 0].float(), labels)


@dataclasses.dataclass(frozen=True)
class GNNAdapter:
    """Per-arch bridge: build the model for ``(d_feat, n_out)`` and compute
    the per-shape loss from the unified batch.

    ``init(generator, d_feat, n_out, shape, *, device)`` returns the
    model; ``loss(model, batch, info, shape)`` a scalar. The reference's
    ``loss_sharded`` (the halo-exchange path) is not ported (ROADMAP
    A10b)."""

    name: str
    init: Callable
    loss: Callable
    description: str = ""


def make_gnn_arch(adapter: GNNAdapter) -> Arch:
    return Arch(name=adapter.name, family="gnn",
                description=adapter.description, adapter=adapter)
