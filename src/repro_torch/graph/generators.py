"""Synthetic graph generators: a numpy copy of the reference's
``graph/generators.py``, draw for draw, so one seed gives the same graph
(and positions, features) bit for bit in both packages. The serve
launcher's graph is :func:`power_law_graph`; :func:`molecule_batch` and
:func:`radius_graph` build molecules, :func:`grid_mesh_graph` simulation
meshes, :func:`preset_graph` reduced stand-ins for public datasets.
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


def uniform_graph(num_nodes: int, avg_degree: float, *, seed: int = 0
                  ) -> CSRGraph:
    """``int(num_nodes·avg_degree)`` uniform random edges, self loops
    dropped."""
    rng = np.random.default_rng(seed)
    num_edges = int(num_nodes * avg_degree)
    src = rng.integers(0, num_nodes, size=num_edges)
    dst = rng.integers(0, num_nodes, size=num_edges)
    keep = src != dst
    return CSRGraph.from_edge_index(src[keep], dst[keep], num_nodes)


def grid_mesh_graph(nx: int, ny: int) -> CSRGraph:
    """Bidirectional 2-D grid mesh (MeshGraphNet-style simulation mesh)."""
    ids = np.arange(nx * ny).reshape(nx, ny)
    src, dst = [], []
    for (a, b) in ((ids[:-1, :], ids[1:, :]), (ids[:, :-1], ids[:, 1:])):
        src += [a.ravel(), b.ravel()]
        dst += [b.ravel(), a.ravel()]
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    return CSRGraph.from_edge_index(src, dst, nx * ny)


def radius_graph(positions: np.ndarray, cutoff: float,
                 max_neighbors: Optional[int] = None) -> CSRGraph:
    """Molecular radius graph over 3-D coordinates (SchNet / Equiformer):
    an edge ``i → j`` for every ``j ≠ i`` closer than ``cutoff``; with
    ``max_neighbors``, each source keeps its nearest ones (ties by
    target id)."""
    n = positions.shape[0]
    d2 = np.sum((positions[:, None, :] - positions[None, :, :]) ** 2, axis=-1)
    mask = (d2 < cutoff ** 2) & ~np.eye(n, dtype=bool)
    src, dst = np.nonzero(mask)
    if max_neighbors is not None and src.size:
        order = np.lexsort((d2[src, dst], src))
        src, dst = src[order], dst[order]
        # rank within each source's run: position minus the run's start
        _, start, counts = np.unique(src, return_index=True,
                                     return_counts=True)
        rank = np.arange(src.size) - np.repeat(start, counts)
        keep = rank < max_neighbors
        src, dst = src[keep], dst[keep]
    return CSRGraph.from_edge_index(src, dst, n)


def molecule_batch(batch: int, atoms_per_mol: int, *, seed: int = 0,
                   cutoff: float = 2.0
                   ) -> tuple[CSRGraph, np.ndarray, np.ndarray]:
    """Block-diagonal batch of random molecules (positions ``N(0, 1.2²)``
    in fp32, radius graph per molecule).

    Returns ``(graph over batch·atoms nodes, positions (N, 3), mol_id
    (N,))``."""
    rng = np.random.default_rng(seed)
    all_src, all_dst, all_pos = [], [], []
    for m in range(batch):
        pos = rng.normal(scale=1.2, size=(atoms_per_mol, 3)).astype(np.float32)
        g = radius_graph(pos, cutoff)
        s, d = g.to_coo()
        all_src.append(s + m * atoms_per_mol)
        all_dst.append(d + m * atoms_per_mol)
        all_pos.append(pos)
    n = batch * atoms_per_mol
    graph = CSRGraph.from_edge_index(np.concatenate(all_src),
                                     np.concatenate(all_dst), n)
    mol_id = np.repeat(np.arange(batch, dtype=np.int32), atoms_per_mol)
    return graph, np.concatenate(all_pos, axis=0), mol_id


# named reduced-scale stand-ins for public datasets:
# name: (nodes, avg_degree, exponent, feat_dim)
PRESETS = {
    "cora_like": (2708, 3.9, 1.3, 1433),
    "reddit_like": (8192, 48.0, 1.8, 300),
    "products_like": (16384, 25.0, 1.6, 100),
    "papers_like": (32768, 14.0, 1.7, 128),
}


def preset_graph(name: str, *, seed: int = 0,
                 scale: float = 1.0) -> tuple[CSRGraph, np.ndarray]:
    """A :data:`PRESETS` power-law graph at ``scale`` (at least 64 nodes)
    and its ``N(0, 1)`` fp32 features from ``seed + 1``."""
    nodes, deg, exp, feat = PRESETS[name]
    n = max(64, int(nodes * scale))
    g = power_law_graph(n, deg, exponent=exp, seed=seed)
    rng = np.random.default_rng(seed + 1)
    feats = rng.normal(size=(n, feat)).astype(np.float32)
    return g, feats
