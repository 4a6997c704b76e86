"""Dispatch: the plain version for CPU tensors, the CUDA kernel otherwise.

There is no fallback: a tensor that is not on the CPU goes to the kernel
wrapper, which launches or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.gather_aggregate import kernel, ref


def gather_aggregate(tier: torch.Tensor, slot: torch.Tensor,
                     hot: torch.Tensor, warm: torch.Tensor,
                     cold: torch.Tensor) -> torch.Tensor:
    """Fused tier gather + segment sum; see
    :func:`ref.gather_aggregate_ref`."""
    if all(t.device.type == "cpu" for t in (tier, slot, hot, warm, cold)):
        return ref.gather_aggregate_ref(tier, slot, hot, warm, cold)
    return kernel.gather_aggregate_cuda(tier, slot, hot, warm, cold)
