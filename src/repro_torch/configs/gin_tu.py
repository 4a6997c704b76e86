"""gin-tu [gnn] n_layers=5 d_hidden=64 aggregator=sum eps=learnable
[arXiv:1810.00826] — the published widths of ``src/repro/configs/gin_tu.py``,
with its halo-sharded loss (:func:`_loss_sharded`).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import register
from repro_torch.configs.gnn_common import (GNNAdapter, classification_loss,
                                            make_gnn_arch, regression_loss,
                                            sharded_classification_loss)
from repro_torch.core.halo import HaloCtx, HaloPlan
from repro_torch.kernels.segment_spmm.ops import segment_spmm_autograd
from repro_torch.models.gnn_basic import (GIN, gin_full_graph,
                                          gin_graph_readout, gin_init)

N_LAYERS, D_HIDDEN = 5, 64

# the dry-run cell's ELL widths (in-degree, out-degree maximum) of each
# shape's seed-0 batch (``gnn_common.make_concrete_batch``)
ELL_WIDTHS = {"full_graph_sm": (12, 14), "minibatch_lg": (8, 8),
              "ogb_products": (53, 53), "molecule": (9, 9)}


def _init(generator: torch.Generator, d_feat: int, n_out: int, shape: str,
          *, device: str | torch.device = "cuda") -> GIN:
    return gin_init(generator, d_feat, D_HIDDEN, N_LAYERS, n_out,
                    device=device)


def _loss(model: GIN, batch: dict, info: dict, shape: str) -> torch.Tensor:
    """Regression on per-graph readouts when ``info`` has graphs, else
    node classification over the full graph. A batch that carries its ELL
    pair (``ell_ids``, ``ell_ids_t``: the dry-run's cell) sums through
    it; else the pair is built from the edges."""
    ell = ((batch["ell_ids"], batch["ell_ids_t"]) if "ell_ids" in batch
           else None)
    if info["graphs"] is not None:
        pred = gin_graph_readout(model, batch["node_feat"], batch["src"],
                                 batch["dst"], batch["mol_id"],
                                 num_nodes=info["nodes"],
                                 num_graphs=info["graphs"], ell=ell)
        return regression_loss(pred, batch["labels"])
    logits = gin_full_graph(model, batch["node_feat"], batch["src"],
                            batch["dst"], num_nodes=info["nodes"], ell=ell)
    return classification_loss(logits, batch["labels"])


def halo_tables(batch: list[dict], ctx: HaloCtx
                ) -> tuple[HaloPlan, list[tuple[torch.Tensor, torch.Tensor]]]:
    """The exchange plan of a sharded batch's valid edges' sources and each
    group's local ELL pair into its answer buffer (``HaloCtx.ell``)."""
    ids, rows = [], []
    for gi, b in enumerate(batch):
        valid = (b["src"] >= 0) & (b["dst"] >= 0)
        ids.append(torch.where(valid, b["src"], -1))
        rows.append(torch.where(valid, ctx.local_rows(gi, b["dst"]), -1))
    plan = ctx.plan(ids)
    return plan, [ctx.ell(plan, gi, r) for gi, r in enumerate(rows)]


def _loss_sharded(model: GIN, batch: list[dict], info: dict, shape: str,
                  ctx: HaloCtx) -> torch.Tensor:
    """Node classification with dst-aligned edges on ``ctx``'s mesh
    (``batch``: one dict a group, ``gnn_common.shard_batch``): every
    scatter is local, and each layer's only communication is the halo
    exchange of the remote source rows — O(remote rows · d), not O(N ·
    d).

    The reference's arithmetic: a layer gathers its source rows (zero for
    an invalid or dropped edge), sums them into the local destinations
    ``clip(dst − offset, 0, rows−1)``, then ``(1+ε)·h + agg → mlp1 → relu
    → mlp2 → ln → relu``; after the readout, each shard's masked cross
    entropy, reduced by ``ctx.mean``. The local sum is the
    ``segment_spmm`` kernel over an ELL table whose ids index the
    exchange's buffer of unique rows (``HaloCtx.ell``), one launch a
    group a layer, and its gradient the kernel over the transposed table
    (none for layer 1, whose input needs no gradient). The table lists a
    destination's edges in edge order and the kernel adds them in that
    order, the reference's ``segment_sum`` order on the CPU."""
    plan, tables = halo_tables(batch, ctx)
    models = ctx.replicas(model)
    hs = [b["node_feat"] for b in batch]
    for i in range(len(model.layers)):
        bufs = ctx.exchange(plan, hs)
        hs = [m.layers[i](h, segment_spmm_autograd(t[0], buf, ids_t=t[1]))
              for m, h, buf, t in zip(models, hs, bufs, tables)]
    logits = [m.readout(h) for m, h in zip(models, hs)]
    return sharded_classification_loss(ctx, logits,
                                       [b["labels"] for b in batch])


ARCH = register(make_gnn_arch(GNNAdapter(
    name="gin-tu", init=_init, loss=_loss,
    description="GIN-ε, 5 layers, 64 hidden, sum aggregation.",
    loss_sharded=_loss_sharded, exchange=(N_LAYERS, D_HIDDEN),
    ell_widths=ELL_WIDTHS)))
