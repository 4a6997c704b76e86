"""Dispatch: the plain version for CPU tensors, the CUDA kernel otherwise.

There is no fallback: a tensor that is not on the CPU goes to the kernel
wrapper, which launches or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Causal or full GQA attention; see :func:`ref.flash_attention_plain`."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.flash_attention_plain(q, k, v, causal=causal)
    return kernel.flash_attention_cuda(q, k, v, causal=causal)
