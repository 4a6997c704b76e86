"""Segment (scatter-reduce) primitives — the message-passing substrate,
on ``index_add_`` / ``scatter_reduce``.

On a CUDA tensor ``index_add_`` accumulates with atomics, so the order of
a segment's terms changes from run to run: results agree with the
reference within fp32 tolerance, not bitwise. Where the bits must not
depend on the device or the run (PSGS and FAP, from which placement is
built), :func:`segment_sum_ordered` adds each segment's terms in the
order they come, on the card as on the CPU.
"""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_{i: ids[i]=s} data[i]``; ids outside
    ``[0, num_segments)`` are dropped, as ``jax.ops.segment_sum`` does:
    they add into one extra row that is cut off (no mask, so no host
    synchronization and no copy of ``data``)."""
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return out.index_add_(0, ids, data)[:num_segments]


def segment_sum_ordered(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """:func:`segment_sum` with each segment summed from zero in the
    order of its terms, ``((0 + d_i) + d_j) + ...`` for ``i < j < ...``:
    the order of ``index_add_`` on the CPU, so the card gives the CPU's
    bits and the same bits on every run.

    The terms are grouped by a stable sort of the ids and summed by
    ``torch.segment_reduce`` over a 2-D view: on the card its kernel for
    data of more than one dimension gives each (segment, column) one
    thread that adds the segment's rows in sequence (the 1-D path is a
    tree reduction). ``tests/test_torch_card.py::
    test_psgs_fap_and_placement_are_bitwise_on_card`` pins the bits."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    data, ids = data[keep], ids[keep]
    order = torch.sort(ids, stable=True).indices
    lengths = torch.bincount(ids, minlength=num_segments)
    out = torch.segment_reduce(data[order].reshape(order.shape[0], -1),
                               "sum", lengths=lengths, unsafe=True)
    return out.reshape((num_segments,) + tuple(data.shape[1:]))


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, *, eps: float = 1e-9) -> torch.Tensor:
    tot = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones(data.shape[:1]), segment_ids,
                      num_segments)
    return tot / (cnt.reshape((-1,) + (1,) * (tot.dim() - 1)) + eps)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max; an empty segment yields ``-inf`` (as in JAX)."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    data, ids = data[keep], ids[keep]
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, index, data, reduce="amax",
                              include_self=True)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Per-segment softmax over edge scores (GAT edge-softmax)."""
    seg_max = segment_max(scores, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ids = segment_ids.long()
    ex = torch.exp(scores - seg_max[ids])
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / (denom[ids] + 1e-9)


def scatter_spmm(src_feat: torch.Tensor, src_idx: torch.Tensor,
                 dst_idx: torch.Tensor, num_dst: int,
                 edge_weight: torch.Tensor | None = None) -> torch.Tensor:
    """out[d] = Σ_{e: dst[e]=d} w[e] · src_feat[src[e]] — the SpMM primitive.

    Invalid edges are marked with negative indices and contribute zero.
    """
    msg = src_feat[src_idx.long().clamp_min(0)]
    valid = ((src_idx >= 0) & (dst_idx >= 0)).to(msg.dtype)
    if edge_weight is not None:
        valid = valid * edge_weight.to(msg.dtype)
    msg = msg * valid[:, None]
    return segment_sum(msg, dst_idx.clamp_min(0), num_dst)
