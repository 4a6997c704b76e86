"""Synthetic graph generators (numpy copy of the reference's
``graph/generators.py``; the launcher's graph is :func:`power_law_graph`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.graph.csr import CSRGraph


def power_law_graph(num_nodes: int, avg_degree: float, *, exponent: float = 1.6,
                    seed: int = 0, max_degree: Optional[int] = None) -> CSRGraph:
    """Directed graph with zipf-skewed out-degrees and zipf-ranked
    in-popularity: a few hub nodes receive a large share of edges — the
    skew regime Quiver targets (paper §2.2). Same draws, in the same order,
    as the reference, so one seed gives the same graph in both packages."""
    rng = np.random.default_rng(seed)
    num_edges = int(num_nodes * avg_degree)
    base = rng.zipf(2.0, size=num_nodes).astype(np.float64)
    cap = max_degree if max_degree is not None else max(num_nodes // 4, 8)
    base = np.minimum(base, cap)
    out_deg = np.maximum(
        np.round(base * (avg_degree / max(base.mean(), 1e-9))), 1
    ).astype(np.int64)
    out_deg = np.minimum(out_deg, cap)
    deficit = num_edges - int(out_deg.sum())
    if deficit > 0:
        bump = rng.integers(0, num_nodes, size=deficit)
        np.add.at(out_deg, bump, 1)
    src = np.repeat(np.arange(num_nodes), out_deg)
    ranks = rng.permutation(num_nodes)
    weights = 1.0 / np.power(np.arange(1, num_nodes + 1, dtype=np.float64),
                             exponent)
    weights /= weights.sum()
    dst_rank = rng.choice(num_nodes, size=src.shape[0], p=weights)
    dst = ranks[dst_rank]
    keep = src != dst  # drop self loops
    return CSRGraph.from_edge_index(src[keep], dst[keep], num_nodes)
