"""Shapes, the unified batch, the losses, the per-architecture adapter and
the halo-sharded training cell shared by the GNN architectures —
``src/repro/configs/gnn_common.py`` without its dry-run cell, mesh rules
and smoke (``build_gnn_cell``'s unsharded half, ``gnn_rules``,
``gnn_smoke``, ``CellSpec``; ROADMAP A12). Its ``use_halo`` branch is
:func:`build_halo_cell`.

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
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import Arch
from repro_torch.core.halo import HaloCtx, partition_edges_by_dst
from repro_torch.launch.mesh import Mesh

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
    model; ``loss(model, batch, info, shape)`` a scalar. The optional
    locality-sharded path ``loss_sharded(model, sharded_batch, info,
    shape, ctx)`` (dst-aligned edges, halo exchanges through the
    :class:`~repro_torch.core.halo.HaloCtx` ``ctx``; see
    :func:`build_halo_cell`) returns the loss of every shard together,
    on the mesh's first device; it serves the shapes in
    ``sharded_shapes``."""

    name: str
    init: Callable
    loss: Callable
    description: str = ""
    loss_sharded: Optional[Callable] = None
    sharded_shapes: tuple = ("ogb_products",)


def use_halo(adapter: GNNAdapter, shape: str, info: dict,
             world: int) -> bool:
    """The reference's condition for the halo-sharded step: the adapter
    has a sharded loss, the shape is one it serves (or the launcher's
    ``"custom"`` graph), and nodes and edges split evenly over
    ``world``."""
    return (adapter.loss_sharded is not None
            and (shape in adapter.sharded_shapes or shape == "custom")
            and info["nodes"] % world == 0 and info["edges"] % world == 0)


def halo_cap_pp(info: dict, world: int) -> int:
    """The reference's per-peer request capacity: a 0.4 margin over the
    remote fraction of a locality partition (~0.25–0.3) of a shard's
    ``edges / world`` edges, at least 16."""
    e_local = info["edges"] // world
    return max(16, int(e_local * 0.4 / world))


def shard_batch(batch: dict, ctx: HaloCtx) -> list[dict]:
    """A unified batch laid out on ``ctx``'s mesh: the edges partitioned
    by destination owner (:func:`partition_edges_by_dst`, on the host),
    then one dict a group of ``ctx.groups`` on its device: the node
    arrays' rows of its shards and their edge slices, in shard order."""
    n = batch["node_feat"].shape[0]
    src, dst = partition_edges_by_dst(batch["src"].cpu().numpy(),
                                      batch["dst"].cpu().numpy(), n,
                                      ctx.world)
    edges = {"src": torch.from_numpy(src).view(ctx.world, -1),
             "dst": torch.from_numpy(dst).view(ctx.world, -1)}
    nodes = {k: v for k, v in batch.items() if k not in edges}
    out = []
    for dev, shards in ctx.groups:
        if list(shards) == list(range(ctx.world)):
            part = {k: v.to(dev) for k, v in nodes.items()}
        else:
            part = {k: torch.cat([v[s * ctx.rows:(s + 1) * ctx.rows]
                                  for s in shards]).to(dev)
                    for k, v in nodes.items()}
        for k, v in edges.items():
            part[k] = v[list(shards)].reshape(-1).to(dev)
        out.append(part)
    return out


def sharded_classification_loss(ctx: HaloCtx,
                                 logits: list[torch.Tensor],
                                 labels: list[torch.Tensor]) -> torch.Tensor:
    """The reference's sharded node classification loss: each shard's
    summed softmax cross entropy over its labelled rows (``labels ≥
    0``), and their count, reduced by ``ctx.mean``. One tensor a group
    in each list."""
    totals, counts = [], []
    for (_, shards), lg, lab in zip(ctx.groups, logits, labels):
        lg = lg.float()
        lse = torch.logsumexp(lg, dim=-1)
        tgt = lg.gather(-1, lab.long().clamp_min(0)[:, None])[:, 0]
        ok = (lab >= 0).float()
        totals.append(((lse - tgt) * ok).view(len(shards), -1).sum(1))
        counts.append(ok.view(len(shards), -1).sum(1))
    return ctx.mean(totals, counts)


@dataclasses.dataclass
class HaloCell:
    """The halo-sharded training cell: ``loss(model, sharded_batch)``
    for ``make_train_step``/``run_training`` (parameters replicated: on
    the mesh's first device, copied to the other cards by the loss), and
    ``shard(batch)`` laying a unified batch out on the mesh."""

    ctx: HaloCtx
    loss: Callable
    shard: Callable


def build_halo_cell(adapter: GNNAdapter, info: dict, shape: str,
                    mesh: Mesh, *, cap_pp: Optional[int] = None
                    ) -> HaloCell:
    """The reference's ``build_gnn_cell`` ``use_halo`` branch: ``rows =
    nodes / world`` a shard, ``cap_pp`` by :func:`halo_cap_pp` unless
    given, a :class:`HaloCtx` over ``mesh``, and the adapter's sharded
    loss.

    Raises:
        ValueError: :func:`use_halo` does not hold.
    """
    world = mesh.world
    if not use_halo(adapter, shape, info, world):
        raise ValueError(
            f"{adapter.name} at {shape} ({info['nodes']} nodes, "
            f"{info['edges']} edges) has no halo-sharded step over "
            f"{world} shards: it needs a sharded loss, a shape in "
            f"{adapter.sharded_shapes} or 'custom', and nodes and edges "
            "divisible by the world")
    ctx = HaloCtx(mesh, info["nodes"] // world,
                  halo_cap_pp(info, world) if cap_pp is None else cap_pp)

    def loss(model, batch):
        return adapter.loss_sharded(model, batch, info, shape, ctx)

    return HaloCell(ctx, loss, lambda batch: shard_batch(batch, ctx))


def make_gnn_arch(adapter: GNNAdapter) -> Arch:
    return Arch(name=adapter.name, family="gnn",
                description=adapter.description, adapter=adapter)
