"""schnet [gnn] n_interactions=3 d_hidden=64 rbf=300 cutoff=10
[arXiv:1706.08566] — the published widths of
``src/repro/configs/schnet.py``. Non-geometric shapes feed node features
through a learned projection added to the species embedding (positions
come with every batch)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import register
from repro_torch.configs.gnn_common import (GNNAdapter, classification_loss,
                                            make_gnn_arch, regression_loss)
from repro_torch.models.schnet import SchNet, schnet_forward, schnet_init

D_HIDDEN, N_INTER, N_RBF, CUTOFF = 64, 3, 300, 10.0


def _init(generator: torch.Generator, d_feat: int, n_out: int, shape: str,
          *, device: str | torch.device = "cuda") -> SchNet:
    return schnet_init(generator, d_hidden=D_HIDDEN,
                       n_interactions=N_INTER, n_rbf=N_RBF, cutoff=CUTOFF,
                       d_out=n_out, d_feat_in=d_feat, device=device)


def _loss(model: SchNet, batch: dict, info: dict, shape: str
          ) -> torch.Tensor:
    """Regression on per-molecule sums when ``info`` has graphs, else node
    classification."""
    common = dict(num_nodes=info["nodes"], node_feat=batch["node_feat"])
    if info["graphs"] is not None:
        pred = schnet_forward(model, batch["species"], batch["positions"],
                              batch["src"], batch["dst"],
                              mol_id=batch["mol_id"],
                              num_graphs=info["graphs"], **common)
        return regression_loss(pred, batch["labels"])
    logits = schnet_forward(model, batch["species"], batch["positions"],
                            batch["src"], batch["dst"], **common)
    return classification_loss(logits, batch["labels"])


ARCH = register(make_gnn_arch(GNNAdapter(
    name="schnet", init=_init, loss=_loss,
    description="SchNet continuous-filter convolutions, 300 RBF.",
    exchange=(N_INTER, D_HIDDEN))))
