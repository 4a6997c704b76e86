"""Dispatch: the plain version for CPU tensors, the CUDA kernel otherwise.

There is no fallback: a tensor that is not on the CPU goes to the kernel
wrapper, which launches or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.tiered_gather import kernel, ref


def tiered_gather(tier: torch.Tensor, slot: torch.Tensor, hot: torch.Tensor,
                  warm: torch.Tensor) -> torch.Tensor:
    """Two-source tiered gather; see :func:`ref.tiered_gather_ref`."""
    if all(t.device.type == "cpu" for t in (tier, slot, hot, warm)):
        return ref.tiered_gather_ref(tier, slot, hot, warm)
    return kernel.tiered_gather_cuda(tier, slot, hot, warm)
