"""GraphSAGE (mean aggregator), the served model, in its layered form.

``hop_feats[k]`` has shape ``(B·∏_{h≤k} f_h, d)``; layer ℓ is applied at
every remaining hop level, and each level reduces ``(n, f, d) → (n, d)``.
Every neighbor reduction is :func:`~repro_torch.kernels.gather_aggregate.
fan_sum` — fp32, one child at a time, in order — the same order as the
``gather_aggregate`` kernel, so the fused path (``deep_agg`` from
``TieredFeatureStore.lookup_aggregate``) and the unfused one give the same
bits on the CPU and on the card.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels.gather_aggregate.ref import fan_sum
from repro_torch.models.common import (dense_from_numpy, dense_init,
                                       layer_norm_from_numpy, layer_norm_init)


class SAGELayer(nn.Module):
    """``relu(LN(self(h) + neigh(agg)))``; the last layer skips the relu."""

    def __init__(self, self_lin: nn.Linear, neigh_lin: nn.Linear,
                 ln: nn.LayerNorm):
        super().__init__()
        self.self_lin = self_lin
        self.neigh_lin = neigh_lin
        self.ln = ln

    def forward(self, h_self: torch.Tensor, h_agg: torch.Tensor, *,
                final: bool) -> torch.Tensor:
        out = self.ln(self.self_lin(h_self) + self.neigh_lin(h_agg))
        return out if final else torch.relu(out)


class SAGE(nn.Module):
    """Layered GraphSAGE; ``forward`` is :func:`sage_layered`."""

    def __init__(self, layers: Sequence[SAGELayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, hop_feats, fanouts, hop_masks=None, deep_agg=None):
        return sage_layered(self, hop_feats, fanouts, hop_masks, deep_agg)


def sage_init(generator: torch.Generator, dims: Sequence[int], *,
              device: str | torch.device = "cuda") -> SAGE:
    """``dims = [d_in, h1, ..., h_L]``; layer i maps dims[i] → dims[i+1].
    Weights are drawn on the CPU from ``generator`` (see ``dense_init``),
    then moved to ``device``."""
    layers = [SAGELayer(dense_init(generator, a, b),
                        dense_init(generator, a, b), layer_norm_init(b))
              for a, b in zip(dims[:-1], dims[1:])]
    return SAGE(layers).to(resolve_device(device)).eval()


def sage_from_numpy(params_np: dict, device: str | torch.device = "cuda"
                    ) -> SAGE:
    """Carry the reference's ``sage_init`` tree, as numpy arrays
    (``{"layers": [{"self": {w, b}, "neigh": {w, b}, "ln": {g, b}}]}``),
    into a :class:`SAGE` on ``device``."""
    layers = [SAGELayer(dense_from_numpy(p["self"]),
                        dense_from_numpy(p["neigh"]),
                        layer_norm_from_numpy(p["ln"]))
              for p in params_np["layers"]]
    return SAGE(layers).to(resolve_device(device)).eval()


def sage_layered(model: SAGE, hop_feats: Sequence[torch.Tensor],
                 fanouts: Sequence[int],
                 hop_masks: Sequence[torch.Tensor] | None = None,
                 deep_agg: torch.Tensor | None = None) -> torch.Tensor:
    """Serving GraphSAGE over a layered sample.

    Args:
        model: the :class:`SAGE` weights (``len(model.layers) ==
            len(fanouts)``).
        hop_feats: per-hop feature matrices; one entry fewer when
            ``deep_agg`` is given (the deepest hop was never materialized).
        fanouts: per-layer fan-outs.
        hop_masks: optional ``(M_k, 1)`` 0/1 masks of valid ids for every
            hop, the deepest included; a masked mean divides by the valid
            count (at least 1), else the mean divides by ``fan``.
        deep_agg: the deepest hop already reduced to per-parent sums by
            ``TieredFeatureStore.lookup_aggregate``.

    Returns:
        ``(B, d_out)`` seed embeddings.
    """
    L = len(model.layers)
    if L != len(fanouts):
        raise ValueError(f"{L} layers but fanouts {tuple(fanouts)}")
    h = list(hop_feats)
    masks = (list(hop_masks) if hop_masks is not None
             else [None] * (len(h) + (deep_agg is not None)))
    for layer in range(L):
        new_h = []
        for lvl in range(L - layer):
            fan = fanouts[lvl]
            parents = h[lvl].shape[0]
            m = masks[lvl + 1]
            if m is not None:
                m = m.reshape(parents, fan, 1)
            if deep_agg is not None and layer == 0 and lvl == L - 1:
                total = deep_agg
                m = m.to(total.dtype) if m is not None else None
            else:
                child = h[lvl + 1].reshape(parents, fan, -1)
                m = m.to(child.dtype) if m is not None else None
                total = fan_sum(child * m if m is not None else child)
            agg = (total / m.sum(1).clamp_min(1.0) if m is not None
                   else total / fan)
            new_h.append(model.layers[layer](h[lvl], agg,
                                             final=layer == L - 1))
        h = new_h
    return h[0]
