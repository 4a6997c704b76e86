"""Probabilistic Sampled Sub-graph Size (PSGS) — paper §4.1, computed on
the device with K sparse matrix–vector passes (``segment_sum_ordered``:
each node's terms in edge order, so the card gives the CPU's bits).

``mode="paper"`` is the published formula (expected fan-in of one
random-walk position per hop); ``mode="branching"`` (default) counts the
expected number of sampled slots the real sampler produces:

    s_{K+1} ≡ 0
    s_k[j]  = min(deg_j, l_k) · (1 + (1/deg_j) Σ_{m∈N(j)} s_{k+1}[m])
    Q[i]    = 1 + s_1[i]

The output is the O(|V|) lookup table the router consults in O(1) per
seed (paper §4.2.2), returned as numpy. :func:`monte_carlo_psgs` runs the
real sampler on the host (numpy, draw for draw the reference's oracle) and
is what ``mode="branching"`` converges to; :func:`batch_psgs` accumulates
the table over a request batch.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graph.segment import segment_sum_ordered


def _coo(graph, dev: torch.device):
    src, dst = graph.to_coo()
    deg = torch.as_tensor(graph.out_degree, device=dev).float()
    inv_deg = torch.where(deg > 0, 1.0 / deg.clamp_min(1.0), 0.0)
    return (torch.as_tensor(src, device=dev).long(),
            torch.as_tensor(dst, device=dev).long(), deg, inv_deg)


def compute_psgs(graph, fanouts: Sequence[int], *, mode: str = "branching",
                 device: str | torch.device = "cuda") -> np.ndarray:
    """PSGS lookup table Q_K, shape ``(num_nodes,)``, float32."""
    if mode not in ("branching", "paper"):
        raise ValueError(f"unknown PSGS mode {mode!r}")
    if not fanouts:
        return np.ones((graph.num_nodes,), dtype=np.float32)
    dev = resolve_device(device)
    n = graph.num_nodes
    src, dst, deg, inv_deg = _coo(graph, dev)

    def mean_over_neighbors(v):
        # (T v)[i] = (1/deg_i) Σ_{j ∈ N⁺(i)} v[j]
        return segment_sum_ordered(v[dst], src, n) * inv_deg

    fanouts = [float(f) for f in fanouts]
    if mode == "paper":
        u = deg.clamp_max(fanouts[-1])
        for l_k in reversed(fanouts[:-1]):
            u = deg.clamp_max(l_k) + mean_over_neighbors(u)
        q = 1.0 + u
    else:
        s = torch.zeros(n, device=dev)
        for l_k in reversed(fanouts):
            s = deg.clamp_max(l_k) * (1.0 + mean_over_neighbors(s))
        q = 1.0 + s
    return q.cpu().numpy()



def monte_carlo_psgs(graph, node: int, fanouts: Sequence[int], *,
                     trials: int = 200, seed: int = 0) -> float:
    """Brute-force PSGS by running the sampler ``trials`` times from
    ``node``: the expected number of sampled slots, multiplicity included
    (the oracle of ``mode="branching"``). Host numpy; the same graph and
    seed give the reference's float bit for bit."""
    rng = np.random.default_rng(seed)
    indptr, indices = graph.indptr, graph.indices
    total = 0
    for _ in range(trials):
        count = 1
        frontier = [node]
        for fan in fanouts:
            nxt = []
            for v in frontier:
                s, e = indptr[v], indptr[v + 1]
                deg = e - s
                if deg == 0:
                    continue
                if deg <= fan:
                    nxt.extend(indices[s:e].tolist())
                else:
                    nxt.extend(indices[s + rng.integers(0, deg, size=fan)]
                               .tolist())
            count += len(nxt)
            frontier = nxt
        total += count
    return total / trials


def batch_psgs(psgs_table: np.ndarray, seeds: np.ndarray) -> float:
    """Accumulated PSGS of a request batch (paper §4.2.2): O(1) per seed,
    ``-1`` padding ignored."""
    seeds = np.asarray(seeds)
    valid = seeds >= 0
    return float(psgs_table[seeds[valid]].sum())
