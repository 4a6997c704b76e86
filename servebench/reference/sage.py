"""Plain PyTorch reference of one served request: the layered sample's
rules, the collected features and GraphSAGE (mean aggregator).

It works from the graph, feature table and weights the benchmark drew,
and imports nothing of the program. Sampling is random, so the reference
cannot redraw the program's sample: it judges the sampled ids by the
sampler's rules (:func:`invalid_hops`) and then follows them, collecting
each row from the feature table and running the model's equations in
float32 with TF32 off.

Model (one layer ℓ at every remaining hop level, the last without relu):

    agg  = Σ_{valid children} x_child / max(#valid children, 1)
    h'   = LayerNorm(x_self · W_self + b_self + agg · W_neigh + b_neigh)

:func:`embed` with ``tf32=True`` is the control: the same equations with
every matrix product's operands rounded to TF32 (10 mantissa bits), the
precision an H100 tensor core takes float32 in when TF32 is allowed;
:func:`fan_sums` with ``bf16=True`` is the control of the innermost sums.
"""
from __future__ import annotations

from typing import Sequence

import torch

LN_EPS = 1e-5


def no_tf32() -> None:
    """Float32 matrix products in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (round half away from zero on the 13 low
    mantissa bits), as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Graph:
    """The CSR on one device, with the sorted edge keys ``src·N + dst``
    that membership tests search."""

    def __init__(self, indptr, indices, num_nodes: int,
                 device: torch.device):
        self.n = int(num_nodes)
        self.indptr = torch.as_tensor(indptr, device=device).long()
        self.indices = torch.as_tensor(indices, device=device).long()
        deg = self.indptr[1:] - self.indptr[:-1]
        src = torch.repeat_interleave(
            torch.arange(self.n, device=device), deg,
            output_size=int(self.indices.shape[0]))
        self.keys = torch.sort(src * self.n + self.indices).values
        del src

    def is_edge(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        if self.keys.numel() == 0:
            return torch.zeros_like(src, dtype=torch.bool)
        q = src * self.n + dst
        pos = torch.searchsorted(self.keys, q).clamp_max(
            self.keys.numel() - 1)
        return self.keys[pos] == q


def invalid_hops(graph: Graph, hops: Sequence[torch.Tensor],
                 seeds: torch.Tensor, fanouts: Sequence[int]) -> int:
    """Slots of a layered sample that break the sampler's rules:

    * hop 0 is the request's seeds, then ``-1`` padding;
    * a child row of an absent (``-1``) or neighbourless parent is all
      ``-1``;
    * a parent with ``deg <= fan`` lists its neighbours in edge order,
      each once, then ``-1``;
    * a parent with ``deg > fan`` fills every slot with one of its
      neighbours.
    """
    dev = graph.indptr.device
    h0 = hops[0].to(dev).long()
    want = torch.full_like(h0, -1)
    want[:seeds.shape[0]] = seeds.to(dev).long()
    bad = int((h0 != want).sum())
    for k, fan in enumerate(fanouts):
        parents = hops[k].to(dev).long()
        child = hops[k + 1].to(dev).long().view(-1, fan)
        if child.shape[0] != parents.shape[0]:
            return bad + int(child.numel())
        valid = parents >= 0
        p = parents.clamp_min(0)
        start = graph.indptr[p]
        deg = torch.where(valid, graph.indptr[p + 1] - start, 0)
        j = torch.arange(fan, device=dev)[None, :]
        pos = (start[:, None] + j).clamp_max(
            max(int(graph.indices.shape[0]) - 1, 0))
        listed = torch.where(j < deg[:, None], graph.indices[pos], -1)
        take_all = (deg <= fan)[:, None]
        member = graph.is_edge(p[:, None].expand_as(child),
                               child.clamp_min(0)) & (child >= 0)
        ok = torch.where(take_all, child == listed, member)
        bad += int((~ok).sum())
    return bad


def rows(feats: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Feature rows of ``ids``, zeros where ``-1``."""
    ids = ids.to(feats.device).long()
    out = feats[ids.clamp_min(0)]
    return torch.where((ids >= 0)[:, None], out, 0.0)


def fan_sums(feats: torch.Tensor, parents_ids: torch.Tensor,
             child_ids: torch.Tensor, fan: int, *,
             bf16: bool = False) -> torch.Tensor:
    """Per-parent sums of the valid children's rows, ``(P, d)``; with
    ``bf16`` (the control) the rows and the sum are bfloat16."""
    child = rows(feats, child_ids).view(parents_ids.shape[0], fan, -1)
    if bf16:
        return child.to(torch.bfloat16).sum(1).float()
    return child.sum(1)


def _linear(x, w, b, tf32: bool):
    if tf32:
        x, w = round_tf32(x), round_tf32(w)
    return x @ w + b


def embed(weights: dict, feats: torch.Tensor,
          hops: Sequence[torch.Tensor], fanouts: Sequence[int], *,
          tf32: bool = False) -> torch.Tensor:
    """GraphSAGE over one layered sample; returns the seed rows
    ``(len(hops[0]), d_out)``. ``weights`` holds ``{"layers": [{"self":
    {w, b}, "neigh": {w, b}, "ln": {g, b}}]}`` as tensors on ``feats``'
    device, ``w`` as ``(d_in, d_out)``."""
    dev = feats.device
    ids = [h.to(dev).long() for h in hops]
    h = [rows(feats, i) for i in ids]
    masks = [(i >= 0).to(torch.float32)[:, None] for i in ids]
    layers = weights["layers"]
    L = len(layers)
    for li, p in enumerate(layers):
        nxt = []
        for lvl in range(L - li):
            fan = fanouts[lvl]
            parents = h[lvl].shape[0]
            m = masks[lvl + 1].view(parents, fan, 1)
            child = h[lvl + 1].view(parents, fan, -1)
            agg = (child * m).sum(1) / m.sum(1).clamp_min(1.0)
            z = (_linear(h[lvl], p["self"]["w"], p["self"]["b"], tf32)
                 + _linear(agg, p["neigh"]["w"], p["neigh"]["b"], tf32))
            mu = z.mean(-1, keepdim=True)
            var = ((z - mu) ** 2).mean(-1, keepdim=True)
            z = (z - mu) / torch.sqrt(var + LN_EPS) * p["ln"]["g"] \
                + p["ln"]["b"]
            nxt.append(z if li == L - 1 else torch.relu(z))
        h = nxt
    return h[0]


def weights_on(weights_np: dict, device: torch.device) -> dict:
    """The numpy weight tree as float32 tensors on ``device``."""
    t = (lambda a: torch.as_tensor(a, dtype=torch.float32, device=device))
    return {"layers": [{k: {kk: t(vv) for kk, vv in v.items()}
                        for k, v in layer.items()}
                       for layer in weights_np["layers"]]}
