"""CSR graph container used across the port (numpy copy of the reference's
``graph/csr.py``).

All device-side code works on two int32 tensors (indptr, indices); the
numpy arrays stay on the host for the exact host sampler and for the
metric precomputation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass
class CSRGraph:
    """Compressed-sparse-row adjacency. Out-edges of node i are
    ``indices[indptr[i]:indptr[i+1]]``."""

    indptr: np.ndarray  # (N+1,) int64/int32
    indices: np.ndarray  # (E,) int32
    num_nodes: int
    edge_weight: Optional[np.ndarray] = None  # (E,) float32, defaults uniform

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    @staticmethod
    def from_edge_index(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                        edge_weight: Optional[np.ndarray] = None) -> "CSRGraph":
        """Build CSR from a COO edge list (src -> dst)."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        order = np.argsort(src, kind="stable")
        src_s, dst_s = src[order], dst[order]
        counts = np.bincount(src_s, minlength=num_nodes)
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        ew = None
        if edge_weight is not None:
            ew = np.asarray(edge_weight, dtype=np.float32)[order]
        return CSRGraph(indptr=indptr, indices=dst_s.astype(np.int32),
                        num_nodes=int(num_nodes), edge_weight=ew)

    def to_coo(self) -> tuple[np.ndarray, np.ndarray]:
        src = np.repeat(np.arange(self.num_nodes, dtype=np.int32),
                        self.out_degree)
        return src, self.indices

    def reverse(self) -> "CSRGraph":
        """CSC view as a CSR over in-edges (for FAP / in-neighbor passes):
        the edges reversed, grouped by their old target in edge order, with
        their weights."""
        src, dst = self.to_coo()
        return CSRGraph.from_edge_index(dst, src, self.num_nodes,
                                        self.edge_weight)

    def device_arrays(self, device: str | torch.device = "cuda"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(indptr, indices)`` as int32 tensors on ``device``."""
        dev = resolve_device(device)
        return (torch.as_tensor(self.indptr, dtype=torch.int32, device=dev),
                torch.as_tensor(self.indices, dtype=torch.int32, device=dev))

    def validate(self) -> None:
        assert self.indptr.shape == (self.num_nodes + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == self.num_edges
        assert np.all(np.diff(self.indptr) >= 0)
        if self.num_edges:
            assert self.indices.min() >= 0
            assert self.indices.max() < self.num_nodes
