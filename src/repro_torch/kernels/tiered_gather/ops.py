"""Dispatch: the plain version for CPU tensors, the CUDA kernel otherwise.

There is no fallback: a tensor that is not on the CPU goes to the kernel
wrapper, which launches or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import fake
from repro_torch.kernels.tiered_gather import kernel, ref


def tiered_gather(tier: torch.Tensor, slot: torch.Tensor, hot: torch.Tensor,
                  warm: torch.Tensor) -> torch.Tensor:
    """Two-source tiered gather; see :func:`ref.tiered_gather_ref`. Fake
    tensors take the dry-run's branch (:mod:`repro_torch.kernels.fake`)."""
    if fake.is_fake(tier, slot, hot, warm):
        m, d = tier.shape[0], hot.shape[1]
        return fake.fake_call("tiered_gather",
                              ref.cost(m, d, hot.element_size()), hot,
                              (m, d), hot.dtype)
    if all(t.device.type == "cpu" for t in (tier, slot, hot, warm)):
        return ref.tiered_gather_ref(tier, slot, hot, warm)
    return kernel.tiered_gather_cuda(tier, slot, hot, warm)
