"""gin-tu [gnn] n_layers=5 d_hidden=64 aggregator=sum eps=learnable
[arXiv:1810.00826] — the published widths of ``src/repro/configs/gin_tu.py``.

Not ported: ``_loss_sharded`` (the halo-exchange path; ROADMAP A10b).
"""
from __future__ import annotations

import torch

from repro_torch.configs.gnn_common import (classification_loss,
                                            regression_loss)
from repro_torch.models.gnn_basic import (GIN, gin_full_graph,
                                          gin_graph_readout, gin_init)

N_LAYERS, D_HIDDEN = 5, 64


def _init(generator: torch.Generator, d_feat: int, n_out: int, shape: str,
          *, device: str | torch.device = "cuda") -> GIN:
    return gin_init(generator, d_feat, D_HIDDEN, N_LAYERS, n_out,
                    device=device)


def _loss(model: GIN, batch: dict, info: dict, shape: str) -> torch.Tensor:
    """Regression on per-graph readouts when ``info`` has graphs, else
    node classification over the full graph."""
    if info["graphs"] is not None:
        pred = gin_graph_readout(model, batch["node_feat"], batch["src"],
                                 batch["dst"], batch["mol_id"],
                                 num_nodes=info["nodes"],
                                 num_graphs=info["graphs"])
        return regression_loss(pred, batch["labels"])
    logits = gin_full_graph(model, batch["node_feat"], batch["src"],
                            batch["dst"], num_nodes=info["nodes"])
    return classification_loss(logits, batch["labels"])
