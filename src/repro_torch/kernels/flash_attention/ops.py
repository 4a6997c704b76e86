"""Dispatch: the plain version for CPU tensors, the CUDA kernel otherwise.

There is no fallback: a tensor that is not on the CPU goes to the kernel
wrapper, which launches or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fake
from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Causal or full GQA attention; see :func:`ref.flash_attention_plain`.
    Fake tensors take the dry-run's branch
    (:mod:`repro_torch.kernels.fake`)."""
    if fake.is_fake(q, k, v):
        b, sq, h, dh = q.shape
        cost = ref.cost(b, sq, k.shape[1], h, k.shape[2], dh,
                        q.element_size(), causal=causal)
        return fake.fake_call("flash_attention", cost, q, q.shape, q.dtype)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.flash_attention_plain(q, k, v, causal=causal)
    return kernel.flash_attention_cuda(q, k, v, causal=causal)
