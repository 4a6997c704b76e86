"""SchNet (3 interactions, 64 hidden, 300 RBF, cutoff 10 Å), ported from
``src/repro/models/schnet.py``.

Continuous-filter convolution: per edge, a filter ``W(r_ij)`` generated
from a radial-basis expansion of the distance modulates the source
features; messages are summed per destination with ``segment_sum``
(``index_add_``: atomics on the card, so a segment's terms add in a
run-dependent order there). Each interaction block is recomputed in the
backward (``torch.utils.checkpoint``), as the reference remats its scan.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.graph.segment import segment_sum
from repro_torch.models.common import dense_from_numpy, dense_init, linspace

LOG2 = math.log(2.0)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """``softplus(x) - log 2``. ``F.softplus`` returns x itself above 20,
    where ``jax.nn.softplus`` adds ``log1p(exp(-x))`` < 2.1e-9, below half
    an ulp of x there: the two round alike."""
    return F.softplus(x) - LOG2


class Interaction(nn.Module):
    """One continuous-filter interaction block."""

    def __init__(self, in_proj: nn.Linear, filter1: nn.Linear,
                 filter2: nn.Linear, out_proj: nn.Linear):
        super().__init__()
        self.in_proj = in_proj
        self.filter1 = filter1
        self.filter2 = filter2
        self.out_proj = out_proj

    def forward(self, h: torch.Tensor, rbf: torch.Tensor, env: torch.Tensor,
                s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        w = shifted_softplus(self.filter1(rbf))
        w = self.filter2(w) * env[:, None]                 # (E, d)
        msg = self.in_proj(h)[s] * w
        agg = segment_sum(msg, d, h.shape[0])
        return h + shifted_softplus(self.out_proj(agg))


class SchNet(nn.Module):
    """Species embedding (plus ``feat_proj`` of node features when built
    with ``d_feat_in``), the interactions and the two-layer output head."""

    def __init__(self, embed: torch.Tensor,
                 interactions: Sequence[Interaction], out1: nn.Linear,
                 out2: nn.Linear,
                 feat_proj: Optional[nn.Linear] = None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.interactions = nn.ModuleList(interactions)
        self.out1 = out1
        self.out2 = out2
        self.feat_proj = feat_proj

    @property
    def n_rbf(self) -> int:
        return self.interactions[0].filter1.in_features


def schnet_init(generator: torch.Generator, *, d_hidden: int = 64,
                n_interactions: int = 3, n_rbf: int = 300,
                cutoff: float = 10.0, d_out: int = 1, n_species: int = 32,
                d_feat_in: int = 0,
                device: str | torch.device = "cuda") -> SchNet:
    """The reference's ``schnet_init`` widths and distributions (embedding
    ``N(0, 0.01)``, dense layers as ``dense_init``; ``in_proj`` without a
    bias), drawn on the CPU from ``generator`` in the order embed, out1,
    out2, feat_proj, then each interaction's in_proj, filter1, filter2,
    out_proj; then moved to ``device``. ``cutoff`` is a forward argument,
    as in the reference."""
    dev = resolve_device(device)
    embed = torch.randn((n_species, d_hidden), generator=generator) * 0.1
    out1 = dense_init(generator, d_hidden, d_hidden // 2)
    out2 = dense_init(generator, d_hidden // 2, d_out)
    feat_proj = (dense_init(generator, d_feat_in, d_hidden)
                 if d_feat_in else None)
    inter = [Interaction(dense_init(generator, d_hidden, d_hidden,
                                    bias=False),
                         dense_init(generator, n_rbf, d_hidden),
                         dense_init(generator, d_hidden, d_hidden),
                         dense_init(generator, d_hidden, d_hidden))
             for _ in range(n_interactions)]
    return SchNet(embed, inter, out1, out2, feat_proj).to(dev)


def schnet_from_numpy(params: dict, device: str | torch.device = "cuda"
                      ) -> SchNet:
    """Carry the reference's ``schnet_init`` tree (numpy arrays; the
    ``interactions`` arrays stacked on a leading axis) into a
    :class:`SchNet` on ``device``."""
    stacked = params["interactions"]
    n = len(stacked["filter1"]["w"])
    inter = [Interaction(*(dense_from_numpy({k: v[i] for k, v in
                                             stacked[name].items()})
                           for name in ("in_proj", "filter1", "filter2",
                                        "out_proj")))
             for i in range(n)]
    feat_proj = (dense_from_numpy(params["feat_proj"])
                 if "feat_proj" in params else None)
    model = SchNet(torch.tensor(np.asarray(params["embed"], np.float32)),
                   inter, dense_from_numpy(params["out1"]),
                   dense_from_numpy(params["out2"]), feat_proj)
    return model.to(resolve_device(device))


def _rbf(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    mu = linspace(0.0, cutoff, n_rbf, device=dist.device)
    return torch.exp(-(10.0 / cutoff) * (dist[:, None] - mu[None, :]) ** 2)


def schnet_forward(model: SchNet, species: torch.Tensor,
                   positions: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, *, num_nodes: int,
                   mol_id: Optional[torch.Tensor] = None,
                   num_graphs: Optional[int] = None,
                   node_feat: Optional[torch.Tensor] = None,
                   cutoff: float = 10.0) -> torch.Tensor:
    """species: (N,) int; positions: (N, 3); edges src → dst (E,), -1
    padded. Returns per-graph outputs ``(num_graphs, d_out)`` if ``mol_id``
    is given, else per-node outputs ``(N, d_out)``."""
    valid = (src >= 0) & (dst >= 0)
    s = src.long().clamp_min(0)
    d = dst.long().clamp_min(0)
    rij = positions[d] - positions[s]
    dist = torch.sqrt((rij ** 2).sum(-1) + 1e-12)
    rbf = _rbf(dist, model.n_rbf, cutoff)
    # cosine cutoff envelope
    env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cutoff, max=1.0))
                 + 1.0)
    env = torch.where(valid, env, 0.0)

    h = model.embed[species.long().clamp(0, model.embed.shape[0] - 1)]
    if node_feat is not None and model.feat_proj is not None:
        h = h + model.feat_proj(node_feat)
    if h.shape[0] != num_nodes:
        raise ValueError(f"{h.shape[0]} node rows, num_nodes={num_nodes}")
    for block in model.interactions:
        h = checkpoint(block, h, rbf, env, s, d, use_reentrant=False)
    out = model.out2(shifted_softplus(model.out1(h)))
    if mol_id is not None:
        if num_graphs is None:
            raise ValueError("mol_id needs num_graphs")
        return segment_sum(out, mol_id.long().clamp_min(0), num_graphs)
    return out
