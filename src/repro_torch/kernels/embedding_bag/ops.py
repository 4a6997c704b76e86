"""Dispatch: the plain version for CPU tensors, the CUDA kernel otherwise.

There is no fallback: a tensor that is not on the CPU goes to the kernel
wrapper, which launches or raises."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.embedding_bag import kernel, ref


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, *,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag over ``-1``-padded bags; see
    :func:`ref.embedding_bag_ref`."""
    tensors = (table, ids) if weights is None else (table, ids, weights)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.embedding_bag_ref(table, ids, weights, mode=mode)
    return kernel.embedding_bag_cuda(table, ids, weights, mode=mode)
