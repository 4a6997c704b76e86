"""equiformer-v2 [gnn] n_layers=12 d_hidden=128 l_max=6 m_max=2 n_heads=8
equivariance=SO(2)-eSCN [arXiv:2306.12059] — the published widths of
``src/repro/configs/equiformer_v2.py``.

The big shapes process the edges in chunks (``EDGE_CHUNKS``) to bound the
``(E, (l_max+1)², C)`` message tensors. ``_reduced_init`` (2 layers, 16
channels, l_max 2) is what the reference's training launcher builds;
``_init`` keeps the published widths. :func:`_loss_sharded` is the
halo-sharded loss.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import register
from repro_torch.configs.gnn_common import (GNNAdapter, classification_loss,
                                            make_gnn_arch, regression_loss,
                                            sharded_classification_loss)
from repro_torch.core.halo import HaloCtx
from repro_torch.models.equiformer_v2 import (EquiformerV2,
                                              equiformer_forward,
                                              equiformer_forward_local,
                                              equiformer_init)

N_LAYERS, CHANNELS, L_MAX, M_MAX, N_HEADS = 12, 128, 6, 2, 8

EDGE_CHUNKS = {"full_graph_sm": 1, "minibatch_lg": 8, "ogb_products": 64,
               "molecule": 1}


def _init(generator: torch.Generator, d_feat: int, n_out: int, shape: str,
          *, device: str | torch.device = "cuda") -> EquiformerV2:
    return equiformer_init(generator, n_layers=N_LAYERS, channels=CHANNELS,
                           l_max=L_MAX, m_max=M_MAX, n_heads=N_HEADS,
                           n_rbf=32, d_feat_in=d_feat, d_out=n_out,
                           device=device)


def _reduced_init(generator: torch.Generator, d_feat: int, n_out: int,
                  shape: str, *, device: str | torch.device = "cuda"
                  ) -> EquiformerV2:
    return equiformer_init(generator, n_layers=2, channels=16, l_max=2,
                           m_max=1, n_heads=4, n_rbf=8, d_feat_in=d_feat,
                           d_out=n_out, device=device)


def _loss(model: EquiformerV2, batch: dict, info: dict, shape: str
          ) -> torch.Tensor:
    """Regression on per-molecule sums when ``info`` has graphs, else node
    classification; ``shape`` picks the edge chunks (1 if unlisted)."""
    kw = dict(num_nodes=info["nodes"], node_feat=batch["node_feat"],
              edge_chunks=EDGE_CHUNKS.get(shape, 1))
    if info["graphs"] is not None:
        pred = equiformer_forward(model, batch["species"],
                                  batch["positions"], batch["src"],
                                  batch["dst"], mol_id=batch["mol_id"],
                                  num_graphs=info["graphs"], **kw)
        return regression_loss(pred, batch["labels"])
    logits = equiformer_forward(model, batch["species"], batch["positions"],
                                batch["src"], batch["dst"], **kw)
    return classification_loss(logits, batch["labels"])


def _loss_sharded(model: EquiformerV2, batch: list[dict], info: dict,
                  shape: str, ctx: HaloCtx) -> torch.Tensor:
    """Node classification with dst-aligned edges on ``ctx``'s mesh
    (``batch``: one dict a group, ``gnn_common.shard_batch``): the
    positions all-gathered (N × 3 is tiny), then
    :func:`equiformer_forward_local` and each shard's masked cross
    entropy, reduced by ``ctx.mean``."""
    pos = [ctx.all_gather([b["positions"] for b in batch], dev)
           for dev, _ in ctx.groups]
    logits = equiformer_forward_local(
        ctx.replicas(model), [b["species"] for b in batch], pos,
        [b["node_feat"] for b in batch], [b["src"] for b in batch],
        [b["dst"] for b in batch], ctx=ctx,
        edge_chunks=EDGE_CHUNKS.get(shape, 1))
    return sharded_classification_loss(ctx, logits,
                                       [b["labels"] for b in batch])


ARCH = register(make_gnn_arch(GNNAdapter(
    name="equiformer-v2", init=_init, loss=_loss,
    description="eSCN SO(2)-convolution equivariant graph attention.",
    loss_sharded=_loss_sharded,
    exchange=(N_LAYERS, (L_MAX + 1) ** 2 * CHANNELS)),
    reduced_init=_reduced_init))
