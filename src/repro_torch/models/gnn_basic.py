"""GraphSAGE (mean aggregator), the served model, in its layered and
full-graph forms; GAT (4 heads, the paper's second model), full-graph; and
GIN (``gin-tu``: sum aggregation, learnable ε), trained full-graph.

SAGE: ``hop_feats[k]`` has shape ``(B·∏_{h≤k} f_h, d)``; layer ℓ is applied
at every remaining hop level, and each level reduces ``(n, f, d) → (n, d)``.
Every neighbor reduction is :func:`~repro_torch.kernels.gather_aggregate.
fan_sum` — fp32, one child at a time, in order — the same order as the
``gather_aggregate`` kernel, so the fused path (``deep_agg`` from
``TieredFeatureStore.lookup_aggregate``) and the unfused one give the same
bits on the CPU and on the card.

SAGE full-graph: each layer's mean over a node's OUT-neighbours (the
reference's ``scatter_spmm(h, dst, src, N)``) is the ``segment_spmm``
kernel over the ELL table of out-neighbours (row ``s`` lists the targets
of ``s``'s edges in edge order), divided by ``max(deg, 1)``. That table's
width is the largest out-degree: 5,003 on the serve launcher's
``power_law_graph(20000, 12)``, a 400 MB int32 table, where the
in-neighbour orientation would be 105,387 wide (8.4 GB). Its gradient,
needed only in training, is the kernel over the transposed table, built on
first use.

GAT keeps the reference's torch-op form: per-edge scores, an edge softmax
(:func:`~repro_torch.graph.segment.segment_softmax`, ``-inf`` on padded
edges) and a :func:`~repro_torch.graph.segment.segment_sum` of the
messages (``index_add_``, atomics on the card).

GIN: every layer's neighbor sum is the ``segment_spmm`` kernel over the
ELL table of the edge list (built once per call on the edges' device), and
its gradient the same kernel over the transposed table. The reference sums
with ``scatter_spmm`` (a ``segment_sum``), so the two agree within fp32
tolerance, not bitwise.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.graph.segment import segment_softmax, segment_sum
from repro_torch.kernels.gather_aggregate.ref import fan_sum
from repro_torch.kernels.segment_spmm.ops import segment_spmm_autograd
from repro_torch.kernels.segment_spmm.ref import ell_pair, ell_table
from repro_torch.models.common import (dense_from_numpy, dense_init,
                                       layer_norm_from_numpy, layer_norm_init,
                                       to_device)


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


def sage_full_graph(model: SAGE, x: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor, *, num_nodes: int,
                    ell: torch.Tensor | None = None) -> torch.Tensor:
    """Full-graph GraphSAGE: each layer's neighbour mean is the sum over a
    node's out-neighbours (one ``segment_spmm`` launch a layer on a CUDA
    tensor) divided by ``max(deg, 1)``, ``deg`` counted as the reference
    does (``segment_sum`` of ones over ``max(src, 0)``). ``ell``: the
    out-neighbour table ``ell_table(dst, src, num_nodes)`` when the caller
    built it already. Returns ``(N, d_out)``."""
    if ell is None:
        ell = ell_table(dst, src, num_nodes)
    ones = torch.ones(src.shape, dtype=x.dtype, device=x.device)
    deg = segment_sum(ones, src.clamp_min(0), num_nodes)
    h = x
    L = len(model.layers)
    for i, layer in enumerate(model.layers):
        agg = segment_spmm_autograd(ell, h)
        agg = agg / deg.clamp_min(1.0)[:, None]
        h = layer(h, agg, final=i == L - 1)
    return h


# ---------------------------------------------------------------------------
# GAT (4 heads, the paper's second model)
# ---------------------------------------------------------------------------
class GATLayer(nn.Module):
    """``proj`` (no bias) to ``heads·d_out``, per-head attention vectors
    ``attn_src``/``attn_dst`` ``(heads, d_out)`` and the LayerNorm ``ln``
    over the concatenated heads."""

    def __init__(self, proj: nn.Linear, attn_src: torch.Tensor,
                 attn_dst: torch.Tensor, ln: nn.LayerNorm):
        super().__init__()
        self.proj = proj
        self.attn_src = nn.Parameter(attn_src)
        self.attn_dst = nn.Parameter(attn_dst)
        self.ln = ln


class GAT(nn.Module):
    """GAT layers; ``heads`` heads concatenate between layers."""

    def __init__(self, layers: Sequence[GATLayer], heads: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.heads = heads

    def forward(self, x, src, dst, *, num_nodes):
        return gat_full_graph(self, x, src, dst, num_nodes=num_nodes)


def gat_init(generator: torch.Generator, dims: Sequence[int], *,
             heads: int = 4, device: str | torch.device = "cuda") -> GAT:
    """``dims = [d_in, h1, ..., h_L]``: layer i projects ``dims[i]``
    (``dims[i]·heads`` after the first layer) to ``heads·dims[i+1]``
    (weights ``N(0, 1/d_in)``), attention vectors ``N(0, 0.1²)``; drawn on
    the CPU from ``generator`` layer by layer (proj, attn_src, attn_dst),
    then moved to ``device``."""
    layers = []
    for i in range(len(dims) - 1):
        d_out = dims[i + 1]
        d_in = dims[i] if i == 0 else dims[i] * heads
        proj = dense_init(generator, d_in, heads * d_out, bias=False)
        a_src = torch.randn((heads, d_out), generator=generator) * 0.1
        a_dst = torch.randn((heads, d_out), generator=generator) * 0.1
        layers.append(GATLayer(proj, a_src, a_dst,
                               layer_norm_init(heads * d_out)))
    return GAT(layers, heads).to(resolve_device(device))


def gat_from_numpy(params_np: dict, device: str | torch.device = "cuda"
                   ) -> GAT:
    """Carry the reference's ``gat_init`` tree, as numpy arrays
    (``{"layers": [{"proj": {w}, "attn_src", "attn_dst", "ln": {g, b}}],
    "heads"}``), into a :class:`GAT` on ``device``."""
    layers = [GATLayer(dense_from_numpy(p["proj"]),
                       torch.tensor(np.asarray(p["attn_src"], np.float32)),
                       torch.tensor(np.asarray(p["attn_dst"], np.float32)),
                       layer_norm_from_numpy(p["ln"]))
              for p in params_np["layers"]]
    return GAT(layers, int(params_np["heads"])).to(resolve_device(device))


def gat_full_graph(model: GAT, x: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, *, num_nodes: int) -> torch.Tensor:
    """Full-graph GAT, the reference's arithmetic: per edge ``e = leaky_
    relu(z[src]·a_src + z[dst]·a_dst, 0.2)`` per head, ``-inf`` where
    ``src < 0``; softmax over each target's edges; messages ``z[src]·α``
    (zero on padded edges) summed into their targets; LayerNorm, and ELU
    between layers. Returns ``(N, heads·d_out)``."""
    heads = model.heads
    s = src.long().clamp_min(0)
    d = dst.long().clamp_min(0)
    valid = src >= 0
    h = x
    L = len(model.layers)
    for i, layer in enumerate(model.layers):
        d_out = layer.attn_src.shape[1]
        z = layer.proj(h).reshape(num_nodes, heads, d_out)
        zs = z[s]
        e = ((zs * layer.attn_src).sum(-1)
             + (z[d] * layer.attn_dst).sum(-1))              # (E, heads)
        e = F.leaky_relu(e, 0.2)
        e = torch.where(valid[:, None], e, float("-inf"))
        alpha = segment_softmax(e, d, num_nodes)              # (E, heads)
        msg = zs * alpha[..., None]                           # (E, heads, d)
        msg = torch.where(valid[:, None, None], msg, 0.0)
        agg = segment_sum(msg.reshape(msg.shape[0], -1), d, num_nodes)
        h = layer.ln(agg)
        if i < L - 1:
            h = F.elu(h)
    return h


# ---------------------------------------------------------------------------
# GIN (gin-tu — 5 layers, 64 hidden, sum aggregation, learnable ε)
# ---------------------------------------------------------------------------
class GINLayer(nn.Module):
    """``relu(LN(mlp2(relu(mlp1((1+ε)·h + agg)))))``, ε a learnable
    scalar (GIN-ε)."""

    def __init__(self, mlp1: nn.Linear, mlp2: nn.Linear, ln: nn.LayerNorm,
                 eps: float = 0.0):
        super().__init__()
        self.mlp1 = mlp1
        self.mlp2 = mlp2
        self.eps = nn.Parameter(torch.tensor(float(eps)))
        self.ln = ln

    def forward(self, h: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
        z = (1.0 + self.eps) * h + agg
        z = torch.relu(self.mlp1(z))
        return torch.relu(self.ln(self.mlp2(z)))


class GIN(nn.Module):
    """GIN layers and the dense ``readout`` head."""

    def __init__(self, layers: Sequence[GINLayer], readout: nn.Linear):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.readout = readout


def gin_init(generator: torch.Generator, d_in: int, d_hidden: int,
             n_layers: int, d_out: int, *,
             device: str | torch.device = "cuda") -> GIN:
    """GIN with ε = 0; weights drawn on the CPU from ``generator`` (layer
    by layer: mlp1, mlp2; then the readout), then moved to ``device``."""
    layers = []
    dims_in = d_in
    for _ in range(n_layers):
        layers.append(GINLayer(dense_init(generator, dims_in, d_hidden),
                               dense_init(generator, d_hidden, d_hidden),
                               layer_norm_init(d_hidden)))
        dims_in = d_hidden
    return to_device(GIN(layers, dense_init(generator, d_hidden, d_out)),
                     resolve_device(device))


def gin_from_numpy(params_np: dict, device: str | torch.device = "cuda"
                   ) -> GIN:
    """Carry the reference's ``gin_init`` tree, as numpy arrays
    (``{"layers": [{"mlp1": {w, b}, "mlp2": {w, b}, "eps": (), "ln": {g,
    b}}], "readout": {w, b}}``), into a :class:`GIN` on ``device``."""
    layers = [GINLayer(dense_from_numpy(p["mlp1"]),
                       dense_from_numpy(p["mlp2"]),
                       layer_norm_from_numpy(p["ln"]), float(p["eps"]))
              for p in params_np["layers"]]
    return GIN(layers, dense_from_numpy(params_np["readout"])).to(
        resolve_device(device))


def _gin_layers(model: GIN, x: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, num_nodes: int, ell) -> list[torch.Tensor]:
    """Each layer's node embeddings. The ELL pair is built once and serves
    all layers: one ``segment_spmm`` launch per layer forward, one per
    layer backward (none for layer 1, whose input needs no gradient)."""
    ids, ids_t = ell if ell is not None else ell_pair(src, dst, num_nodes)
    hs = [x]
    for layer in model.layers:
        hs.append(layer(hs[-1], segment_spmm_autograd(ids, hs[-1],
                                                      ids_t=ids_t)))
    return hs[1:]


def gin_full_graph(model: GIN, x: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, *, num_nodes: int,
                   ell: tuple[torch.Tensor, torch.Tensor] | None = None
                   ) -> torch.Tensor:
    """Node classification logits ``(N, d_out)``: each layer sums the
    in-neighbours (edges ``src → dst``; negative ids are no edge).

    ``ell``: the ``(ids, ids_t)`` pair of ``ell_pair(src, dst, num_nodes)``
    when the caller built it already (``bench/profile_train.py`` times the
    build apart); else it is built here."""
    return model.readout(_gin_layers(model, x, src, dst, num_nodes, ell)[-1])


def gin_graph_readout(model: GIN, x: torch.Tensor, src: torch.Tensor,
                      dst: torch.Tensor, graph_id: torch.Tensor, *,
                      num_nodes: int, num_graphs: int,
                      ell: tuple[torch.Tensor, torch.Tensor] | None = None
                      ) -> torch.Tensor:
    """Graph regression/classification: the sum over layers of each
    layer's per-graph ``segment_sum`` of node embeddings, then the
    readout. ``(num_graphs, d_out)``. ``ell`` as in
    :func:`gin_full_graph`."""
    pooled = sum(segment_sum(h, graph_id, num_graphs)
                 for h in _gin_layers(model, x, src, dst, num_nodes, ell))
    return model.readout(pooled)
