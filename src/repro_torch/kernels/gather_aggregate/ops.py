"""Dispatch: the plain version for CPU tensors, the CUDA kernel otherwise.

There is no fallback: a tensor that is not on the CPU goes to the kernel
wrapper, which launches or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import fake
from repro_torch.kernels.gather_aggregate import kernel, ref


def gather_aggregate(tier: torch.Tensor, slot: torch.Tensor,
                     hot: torch.Tensor, warm: torch.Tensor,
                     cold: torch.Tensor) -> torch.Tensor:
    """Fused tier gather + segment sum; see
    :func:`ref.gather_aggregate_ref`. Fake tensors take the dry-run's
    branch (:mod:`repro_torch.kernels.fake`)."""
    if fake.is_fake(tier, slot, hot, warm, cold):
        s, fan = tier.shape
        d = hot.shape[1]
        return fake.fake_call("gather_aggregate",
                              ref.cost(s, fan, d, hot.element_size()), hot,
                              (s, d), hot.dtype)
    if all(t.device.type == "cpu" for t in (tier, slot, hot, warm, cold)):
        return ref.gather_aggregate_ref(tier, slot, hot, warm, cold)
    return kernel.gather_aggregate_cuda(tier, slot, hot, warm, cold)
