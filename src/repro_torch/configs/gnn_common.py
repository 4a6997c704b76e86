"""Shapes, the unified batch, the losses, the per-architecture adapter, the
halo-sharded training cell, and the dry-run's cell, rules and smoke shared
by the GNN architectures — ``src/repro/configs/gnn_common.py``. The
reference's ``use_halo`` branch runs as :func:`build_halo_cell`; the
dry-run's cell (:func:`build_gnn_cell`) counts the unsharded step and
names the halo exchange in its notes for the collective model.

Shapes:
  full_graph_sm — full-batch train, N=2,708 / E=10,556 / d=1,433 (Cora)
  minibatch_lg  — sampled train on a Reddit-scale graph (1,024 seeds,
                  fan-out 15-10, d=300)
  ogb_products  — full-batch train, N=2,449,029 / E=61,859,140 / d=100
  molecule      — batched small graphs, 128 molecules × 30 atoms / 64 edges

The unified batch is ``{node_feat, positions, species, src, dst,
labels(, mol_id)}``; every architecture consumes the subset it needs.
Sharding (read by the dry-run): nodes and edges row-sharded over the
whole mesh; GNN parameters are small and stay replicated.
"""
from __future__ import annotations

import dataclasses
import zlib
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import resolve_device
from repro_torch.configs.base import Arch, CellSpec, fake_to
from repro_torch.core.halo import HaloCtx, partition_edges_by_dst
from repro_torch.kernels.segment_spmm.ref import ell_pair
from repro_torch.launch.mesh import Mesh, mesh_world
from repro_torch.sharding import Rules, spec, tree_shardings
from repro_torch.training.loop import make_train_step
from repro_torch.training.optimizer import AdamW, AdamWState

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
    # the dry-run's collective model: (layers, width of the rows a layer
    # exchanges)
    exchange: tuple = (0, 0)
    # the dry-run's ELL inputs: {shape: (in-degree width, out-degree
    # width)} of the seed-0 batch, for a loss that sums through
    # ``segment_spmm`` (its tables are data-dependent, so a fake batch
    # carries them as inputs ``ell_ids``/``ell_ids_t``); None otherwise
    ell_widths: Optional[dict] = None


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


# ---------------------------------------------------------------------------
# The dry-run's cell, rules and smoke
# ---------------------------------------------------------------------------
def gnn_rules(mesh) -> Rules:
    """GNNs have no tensor-parallel dimension (params are small and
    replicated), so node/edge rows shard over the ENTIRE mesh;
    divisibility-aware fallback keeps small shapes replicated."""
    if mesh is None:
        return Rules({})
    all_axes = tuple(mesh.shape.keys())
    return Rules({"nodes": all_axes, "edges": all_axes, "graphs": all_axes})


def _batch_abstract(info: dict, device: torch.device,
                    ell: Optional[tuple] = None) -> dict:
    """The unified batch of ``info``'s shape as empty tensors on
    ``device`` (fake under an active ``FakeTensorMode``); with ``ell``
    ``(width, width_t)``, the ELL pair ``ell_ids``/``ell_ids_t``."""
    n, e = info["nodes"], info["edges"]

    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    batch = {
        "node_feat": t((n, info["d_feat"]), torch.float32),
        "positions": t((n, 3), torch.float32),
        "species": t((n,), torch.int32),
        "src": t((e,), torch.int32),
        "dst": t((e,), torch.int32),
    }
    if info["graphs"] is not None:
        batch["mol_id"] = t((n,), torch.int32)
        batch["labels"] = t((info["graphs"],), torch.float32)
    else:
        batch["labels"] = t((info.get("seeds", n),), torch.int32)
    if ell is not None:
        batch["ell_ids"] = t((n, ell[0]), torch.int32)
        batch["ell_ids_t"] = t((n, ell[1]), torch.int32)
    return batch


def _batch_specs(mesh, rules: Rules, info: dict, ell: bool = False) -> dict:
    n, e = info["nodes"], info["edges"]
    s = partial(spec, mesh, rules)
    out = {
        "node_feat": s((n, info["d_feat"]), "nodes", None),
        "positions": s((n, 3), "nodes", None),
        "species": s((n,), "nodes"),
        "src": s((e,), "edges"),
        "dst": s((e,), "edges"),
    }
    if info["graphs"] is not None:
        out["mol_id"] = s((n,), "nodes")
        out["labels"] = s((info["graphs"],), "graphs")
    else:
        out["labels"] = s((info.get("seeds", n),), "nodes")
    if ell:
        out["ell_ids"] = s((n, 1), "nodes", None)
        out["ell_ids_t"] = s((n, 1), "nodes", None)
    return out


def train_optimizer() -> AdamW:
    """The GNN cells' optimizer: ``AdamW(lr=1e-3, weight_decay=0.0)``."""
    return AdamW(lr=1e-3, weight_decay=0.0)


def with_ell(batch: dict, num_nodes: int) -> dict:
    """``batch`` with its ELL pair (``ell_pair`` of its edges, on their
    device) as ``ell_ids``/``ell_ids_t``."""
    ids, ids_t = ell_pair(batch["src"], batch["dst"], num_nodes)
    return {**batch, "ell_ids": ids, "ell_ids_t": ids_t}


def build_gnn_cell(adapter: GNNAdapter, shape: str, mesh, *,
                   device: str | torch.device = "cuda") -> CellSpec:
    """The reference's ``build_gnn_cell`` on fake tensors of ``device``:
    one training step (the adapter's loss, its gradient, an AdamW update
    in place) on the unified batch. Where the reference takes its
    halo-sharded branch (:func:`use_halo` over the mesh's world), the
    notes say ``halo-sharded`` and the collective model counts the halo
    exchange; the step counted is the unsharded one either way (the same
    arithmetic: the counts do not depend on the mesh)."""
    info = SHAPES[shape]
    rules = gnn_rules(mesh)
    n_out = info["classes"] if info["classes"] is not None else 1
    opt = train_optimizer()
    ell = (adapter.ell_widths or {}).get(shape)
    dev = torch.device(device)
    mode = FakeTensorMode()
    with mode:
        model = fake_to(adapter.init(torch.Generator().manual_seed(0),
                                     info["d_feat"], n_out, shape,
                                     device="cpu"), dev)
        opt_state = opt.init(dict(model.named_parameters()))
        batch = _batch_abstract(info, dev, ell)
    world = mesh_world(mesh) if mesh is not None else 1
    halo = mesh is not None and use_halo(adapter, shape, info, world)
    in_sh = out_sh = None
    if mesh is not None:
        rep = {n: () for n, _ in model.named_parameters()}
        psh = tree_shardings(mesh, rep)
        in_sh = (psh, AdamWState(step=None, mu=psh, nu=psh),
                 tree_shardings(mesh, _batch_specs(mesh, rules, info,
                                                   ell is not None)))
        out_sh = (psh, AdamWState(step=None, mu=psh, nu=psh),
                  tree_shardings(mesh, ()))
    step = make_train_step(
        lambda m, b: adapter.loss(m, b, info, shape), opt)

    def make_args(seed: int, device):
        dev = resolve_device(device)
        model = adapter.init(torch.Generator().manual_seed(seed),
                             info["d_feat"], n_out, shape, device=dev)
        batch = make_concrete_batch(info, seed=seed, device=dev)
        if ell is not None:
            batch = with_ell(batch, info["nodes"])
        return model, opt.init(dict(model.named_parameters())), batch

    notes = ["halo-sharded"] if halo else []
    if ell is not None:
        notes.append(f"ELL widths {ell[0]}/{ell[1]} (in/out degree "
                     "maximum of the seed-0 batch)")
    return CellSpec(
        step_fn=step, args=(model, opt_state, batch), in_shardings=in_sh,
        out_shardings=out_sh, donate_argnums=(0, 1), kind="train",
        notes="; ".join(notes), dtype=torch.float32, fake_mode=mode,
        make_args=make_args,
        meta={"family": "gnn", "arch": adapter.name, "shape": shape,
              "info": info, "rules": rules, "halo": halo,
              "exchange": adapter.exchange,
              "batch_spec": spec(mesh, rules, (info["nodes"],), "nodes"),
              "cap_pp": halo_cap_pp(info, world) if halo else 0})


def smoke_seed(shape: str) -> int:
    """The smoke batch's seed for ``shape``: the reference takes ``hash(
    shape) % 2**16``, which Python salts per process; the port takes the
    CRC-32 of the name, the same in every process."""
    return zlib.crc32(shape.encode()) % 2 ** 16


def gnn_smoke(adapter: GNNAdapter, reduced_init: Callable, *,
              models: Optional[dict] = None,
              seeds: Optional[dict] = None) -> dict:
    """The reference's ``gnn_smoke`` on the CPU: one reduced training step
    a shape of :data:`REDUCED` (the model from ``reduced_init`` on seed 1
    unless ``models[shape]`` is given; the batch from
    ``make_concrete_batch`` at ``seeds[shape]``, else
    :func:`smoke_seed`); asserts a finite loss and returns each shape's
    loss before the update."""
    out = {}
    opt = train_optimizer()
    for shape, info in REDUCED.items():
        n_out = info["classes"] if info["classes"] is not None else 1
        model = (models or {}).get(shape)
        if model is None:
            model = reduced_init(torch.Generator().manual_seed(1),
                                 info["d_feat"], n_out, shape, device="cpu")
        seed = (seeds or {}).get(shape, smoke_seed(shape))
        batch = make_concrete_batch(info, seed=seed, device="cpu")
        step = make_train_step(
            lambda m, b: adapter.loss(m, b, info, shape), opt)
        _, _, loss = step(model, opt.init(dict(model.named_parameters())),
                          batch)
        assert bool(torch.isfinite(loss)), (adapter.name, shape)
        out[shape] = float(loss)
    return out


def make_gnn_arch(adapter: GNNAdapter,
                  reduced_init: Optional[Callable] = None) -> Arch:
    return Arch(
        name=adapter.name, family="gnn", description=adapter.description,
        adapter=adapter, shape_names=tuple(SHAPES),
        build_cell=lambda shape, mesh, **kw: build_gnn_cell(adapter, shape,
                                                            mesh, **kw),
        smoke=lambda: gnn_smoke(adapter, reduced_init or adapter.init))
