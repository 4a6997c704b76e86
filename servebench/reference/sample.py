"""Plain PyTorch reference of what every served request shares, whatever
the model: the layered sample's rules and the collected feature rows.

It works from the graph and feature table the benchmark drew, and
imports nothing of the program. Sampling is random, so the reference
cannot redraw the program's sample: it judges the sampled ids by the
sampler's rules (:func:`invalid_hops`) and then follows them, collecting
each row from the feature table (:func:`rows`); an architecture's
reference (``servebench/reference/<arch>.py``) runs its equations over
those rows in float32 with TF32 off (:func:`no_tf32`).

:func:`round_tf32` rounds an operand to TF32 (10 mantissa bits), the
precision an H100 tensor core takes float32 in when TF32 is allowed: an
architecture's control rounds every matrix product's operands with it.
:func:`fan_sums` with ``bf16=True`` is the control of the innermost sums.
"""
from __future__ import annotations

from typing import Sequence

import torch


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
