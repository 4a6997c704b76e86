"""MeshGraphNet (15 blocks, 128 hidden, sum aggregation, 2-layer MLPs),
ported from ``src/repro/models/meshgraphnet.py``.

Encode–process–decode over a simulation mesh: a per-edge MLP on
``(edge latent, h_src, h_dst)``, a sum per destination (``segment_sum``;
atomics on the card), a per-node MLP; residual updates of both the node
and the edge latents (arXiv:2010.03409). Each processor block is
recomputed in the backward (``torch.utils.checkpoint``), as the reference
remats its scan.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.graph.segment import segment_sum
from repro_torch.models.common import (MLP, layer_norm_from_numpy,
                                       layer_norm_init, mlp_from_numpy,
                                       mlp_init, to_device)


class MLPBlock(nn.Module):
    """``LayerNorm(mlp(x))`` with ReLU between the MLP's layers."""

    def __init__(self, mlp: MLP, ln: nn.LayerNorm):
        super().__init__()
        self.mlp = mlp
        self.ln = ln

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(self.mlp(x))


def _mlp_block(generator: torch.Generator, d_in: int, d_hidden: int,
               d_out: int, mlp_layers: int = 2) -> MLPBlock:
    dims = [d_in] + [d_hidden] * (mlp_layers - 1) + [d_out]
    return MLPBlock(mlp_init(generator, dims, act=torch.relu),
                    layer_norm_init(d_out))


def _block_from_numpy(p: dict) -> MLPBlock:
    return MLPBlock(mlp_from_numpy(p["mlp"], act=torch.relu),
                    layer_norm_from_numpy(p["ln"]))


class ProcessorBlock(nn.Module):
    """One message-passing step: edge update, sum, node update."""

    def __init__(self, edge: MLPBlock, node: MLPBlock):
        super().__init__()
        self.edge = edge
        self.node = node

    def forward(self, h: torch.Tensor, e: torch.Tensor, s: torch.Tensor,
                d: torch.Tensor, valid: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        e = e + self.edge(torch.cat([e, h[s], h[d]], dim=-1)) * valid
        agg = segment_sum(e * valid, d, h.shape[0])
        h = h + self.node(torch.cat([h, agg], dim=-1))
        return h, e


class MeshGraphNet(nn.Module):
    """Node and edge encoders, the processor blocks and the decoder."""

    def __init__(self, node_enc: MLPBlock, edge_enc: MLPBlock,
                 blocks: Sequence[ProcessorBlock], decoder: MLP):
        super().__init__()
        self.node_enc = node_enc
        self.edge_enc = edge_enc
        self.blocks = nn.ModuleList(blocks)
        self.decoder = decoder


def mgn_init(generator: torch.Generator, *, d_node_in: int, d_edge_in: int,
             d_hidden: int = 128, n_layers: int = 15, d_out: int = 3,
             mlp_layers: int = 2,
             device: str | torch.device = "cuda") -> MeshGraphNet:
    """The reference's ``mgn_init`` widths (dense layers as
    ``dense_init``, LayerNorms at unit gain), drawn on the CPU from
    ``generator`` in the order node_enc, edge_enc, the blocks (edge then
    node MLP), the decoder; then moved to ``device``."""
    dev = resolve_device(device)
    node_enc = _mlp_block(generator, d_node_in, d_hidden, d_hidden,
                          mlp_layers)
    edge_enc = _mlp_block(generator, d_edge_in, d_hidden, d_hidden,
                          mlp_layers)
    blocks = [ProcessorBlock(
        _mlp_block(generator, 3 * d_hidden, d_hidden, d_hidden, mlp_layers),
        _mlp_block(generator, 2 * d_hidden, d_hidden, d_hidden, mlp_layers))
        for _ in range(n_layers)]
    decoder = mlp_init(generator, [d_hidden, d_hidden, d_out],
                       act=torch.relu)
    return to_device(MeshGraphNet(node_enc, edge_enc, blocks, decoder), dev)


def mgn_from_numpy(params: dict, device: str | torch.device = "cuda"
                   ) -> MeshGraphNet:
    """Carry the reference's ``mgn_init`` tree (numpy arrays; ``blocks``
    stacked on a leading axis) into a :class:`MeshGraphNet` on
    ``device``."""
    stacked = params["blocks"]
    n = len(stacked["edge"]["ln"]["g"])

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [layer(v, i) for v in tree]
        return tree[i]

    blocks = [ProcessorBlock(_block_from_numpy(layer(stacked["edge"], i)),
                             _block_from_numpy(layer(stacked["node"], i)))
              for i in range(n)]
    model = MeshGraphNet(_block_from_numpy(params["node_enc"]),
                         _block_from_numpy(params["edge_enc"]), blocks,
                         mlp_from_numpy(params["decoder"], act=torch.relu))
    return model.to(resolve_device(device))


def mgn_forward(model: MeshGraphNet, node_feat: torch.Tensor,
                edge_feat: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, *, num_nodes: int) -> torch.Tensor:
    """Per-node outputs ``(N, d_out)``; edges ``src → dst``, -1 padded
    (a padded edge's latent stays its encoding and sends nothing)."""
    valid = ((src >= 0) & (dst >= 0)).to(node_feat.dtype)[:, None]
    s, d = src.long().clamp_min(0), dst.long().clamp_min(0)
    h = model.node_enc(node_feat)
    if h.shape[0] != num_nodes:
        raise ValueError(f"{h.shape[0]} node rows, num_nodes={num_nodes}")
    e = model.edge_enc(edge_feat)
    for block in model.blocks:
        h, e = checkpoint(block, h, e, s, d, valid, use_reentrant=False)
    return model.decoder(h)
