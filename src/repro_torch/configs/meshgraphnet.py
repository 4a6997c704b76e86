"""meshgraphnet [gnn] n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2
[arXiv:2010.03409] — the published widths of
``src/repro/configs/meshgraphnet.py``. Edge features are built from
relative positions (Δpos ⊕ ‖Δpos‖), the standard MGN encoding."""
from __future__ import annotations

import torch

from repro_torch.configs.base import register
from repro_torch.configs.gnn_common import (GNNAdapter, classification_loss,
                                            make_gnn_arch, regression_loss)
from repro_torch.graph.segment import segment_sum
from repro_torch.models.meshgraphnet import (MeshGraphNet, mgn_forward,
                                             mgn_init)

N_LAYERS, D_HIDDEN, MLP_LAYERS = 15, 128, 2


def _init(generator: torch.Generator, d_feat: int, n_out: int, shape: str,
          *, device: str | torch.device = "cuda") -> MeshGraphNet:
    return mgn_init(generator, d_node_in=d_feat, d_edge_in=4,
                    d_hidden=D_HIDDEN, n_layers=N_LAYERS, d_out=n_out,
                    mlp_layers=MLP_LAYERS, device=device)


def _edge_feat(batch: dict) -> torch.Tensor:
    """``(E, 4)``: ``pos[dst] - pos[src]`` and its length."""
    s = batch["src"].long().clamp_min(0)
    d = batch["dst"].long().clamp_min(0)
    rel = batch["positions"][d] - batch["positions"][s]
    dist = torch.sqrt((rel ** 2).sum(-1, keepdim=True) + 1e-12)
    return torch.cat([rel, dist], dim=-1)


def _loss(model: MeshGraphNet, batch: dict, info: dict, shape: str
          ) -> torch.Tensor:
    """Regression on per-molecule sums of the node outputs when ``info``
    has graphs, else node classification."""
    out = mgn_forward(model, batch["node_feat"], _edge_feat(batch),
                      batch["src"], batch["dst"], num_nodes=info["nodes"])
    if info["graphs"] is not None:
        pooled = segment_sum(out, batch["mol_id"].long().clamp_min(0),
                             info["graphs"])
        return regression_loss(pooled, batch["labels"])
    return classification_loss(out, batch["labels"])


ARCH = register(make_gnn_arch(GNNAdapter(
    name="meshgraphnet", init=_init, loss=_loss,
    description="Encode-process-decode mesh GNN, 15 blocks, 128 hidden.")))
