"""Neighbor samplers: the padded fixed-shape device sampler (the "GPU
path") and the exact dynamic-shape host sampler (the "CPU path"), plus the
fixed-size dedup the feature store runs before every gather.

The device sampler draws from a ``torch.Generator``, which cannot
reproduce ``jax.random``'s bits; it keeps the reference's layout and
take-all rule exactly (see :func:`_sample_one_hop`). The host samplers are
the reference's numpy code: the same ``np.random.Generator`` gives the same
hops in both packages.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _sample_one_hop(generator: torch.Generator, indptr: torch.Tensor,
                    indices: torch.Tensor, frontier: torch.Tensor,
                    fanout: int) -> torch.Tensor:
    """Uniform neighbor sampling, fixed output shape ``(|frontier|·fanout,)``.

    Nodes with ``deg <= fanout`` return their full neighbor list (without
    replacement) followed by ``-1`` padding; for ``deg > fanout`` each slot
    draws ``floor(u·deg)`` with ``u`` uniform in [0, 1) (clamped to
    ``deg-1``), i.e. sampling with replacement. ``-1`` frontier entries
    yield ``-1`` rows.
    """
    f = frontier.long().clamp_min(0)
    start = indptr[f].long()
    deg = indptr[f + 1].long() - start
    valid = frontier >= 0
    deg = torch.where(valid, deg, 0)
    hi = deg.clamp_min(1)[:, None]
    u = torch.rand((frontier.shape[0], fanout), generator=generator,
                   device=frontier.device)
    r = torch.minimum((u * hi).long(), hi - 1)
    take_all = deg[:, None] <= fanout
    arange = torch.arange(fanout, device=frontier.device)[None, :]
    offs = torch.where(take_all, arange, r)
    in_range = offs < deg[:, None]
    offs = torch.minimum(offs, (deg[:, None] - 1).clamp_min(0))
    num_edges = int(indices.shape[0])
    if num_edges == 0:
        return torch.full((frontier.shape[0] * fanout,), -1,
                          dtype=torch.int32, device=frontier.device)
    # a degree-0 node at the end of the CSR starts at E: clamp so the
    # (masked-out) read stays in bounds — torch indexing does not clamp
    pos = (start[:, None] + offs).clamp_max(num_edges - 1)
    nbr = indices[pos]
    nbr = torch.where(valid[:, None] & in_range, nbr, -1)
    return nbr.reshape(-1).to(torch.int32)


def device_sample(generator: torch.Generator, indptr: torch.Tensor,
                  indices: torch.Tensor, seeds: torch.Tensor,
                  fanouts: Sequence[int]) -> list[torch.Tensor]:
    """Padded k-hop sample on the tensors' device: ``hops[0]`` are the
    seeds, ``hops[k]`` has ``len(seeds)·∏_{h<=k} f_h`` entries, ``-1``
    padded; entry ``i*f_k + j`` is the j-th neighbor of ``hops[k-1][i]``."""
    hops = [seeds]
    frontier = seeds
    for fan in fanouts:
        frontier = _sample_one_hop(generator, indptr, indices, frontier,
                                   int(fan))
        hops.append(frontier)
    return hops


def host_sample(rng: np.random.Generator, graph, seeds: np.ndarray,
                fanouts: Sequence[int]) -> list[np.ndarray]:
    """Exact k-hop sampling; hop arrays have realized (dynamic) sizes."""
    hops = [np.asarray(seeds, dtype=np.int64)]
    frontier = hops[0]
    indptr, indices = graph.indptr, graph.indices
    for fan in fanouts:
        outs = []
        for v in frontier:
            if v < 0:
                continue
            s, e = indptr[v], indptr[v + 1]
            deg = e - s
            if deg == 0:
                continue
            if deg <= fan:
                outs.append(indices[s:e])
            else:
                outs.append(indices[s + rng.integers(0, deg, size=fan)])
        frontier = (np.concatenate(outs) if outs
                    else np.empty((0,), dtype=indices.dtype))
        hops.append(frontier.astype(np.int64))
    return hops


def host_sample_dense(rng: np.random.Generator, graph, seeds: np.ndarray,
                      fanouts: Sequence[int]) -> list[np.ndarray]:
    """Exact host sampling in the dense fan-out layout the device sampler
    emits (hop k has ``len(seeds)·∏f`` entries, ``-1`` padded), so one model
    path serves both executors. Every node with ``deg <= fan`` contributes
    all its neighbors exactly once."""
    hops = [np.asarray(seeds, dtype=np.int32)]
    indptr, indices = graph.indptr, graph.indices
    frontier = hops[0]
    for fan in fanouts:
        out = np.full((frontier.shape[0], fan), -1, dtype=np.int32)
        for i, v in enumerate(frontier):
            if v < 0:
                continue
            s, e = indptr[v], indptr[v + 1]
            deg = e - s
            if deg == 0:
                continue
            if deg <= fan:
                out[i, :deg] = indices[s:e]
            else:
                out[i] = indices[s + rng.integers(0, deg, size=fan)]
        frontier = out.reshape(-1)
        hops.append(frontier)
    return hops


def fixed_size_unique(ids: torch.Tensor, capacity: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted unique ids padded to ``capacity``, plus the inverse map.

    Layout (the reference's, which the store depends on): the uniques come
    first in ascending order, ``-1`` pads fill the END up to ``capacity``,
    and the inverse of a ``-1`` input points at ``capacity-1``.
    ``torch.unique`` puts ``-1`` first, so it is not used.

    Args:
        ids: ``(M,)`` int32 with ``-1`` padding.
        capacity: output length; uniques beyond it are dropped (callers
            size it to the padded worst case).

    Returns:
        ``(uniq (capacity,) int32, inv (M,) int32)``.
    """
    m = int(ids.shape[0])
    s, order = torch.sort(ids, stable=True)
    first = torch.ones(m, dtype=torch.bool, device=ids.device)
    first[1:] = s[1:] != s[:-1]
    first &= s >= 0
    pos = torch.cumsum(first, 0) - 1
    uniq = torch.full((capacity,), -1, dtype=ids.dtype, device=ids.device)
    keep = first & (pos < capacity)
    uniq[pos[keep]] = s[keep]
    inv_sorted = torch.where(s >= 0, pos, capacity - 1).to(torch.int32)
    inv = torch.empty(m, dtype=torch.int32, device=ids.device)
    inv[order] = inv_sorted
    return uniq, inv
