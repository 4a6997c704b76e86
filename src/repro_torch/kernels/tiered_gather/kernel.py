"""CUDA wrapper for the two-source tiered gather (``csrc/tiered_gather.cu``).

Replaces ``src/repro/kernels/tiered_gather/kernel.py::tiered_gather_pallas``.
The kernel is a pure copy bounded by HBM bytes (``2·M·d·elem + 8·M``); one
warp per output row reads only from the table its tier selects. See the
source for the design note.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (DTYPE_SUFFIX, LaunchCounter,
                                       check_addresses, check_tables, load)

LAUNCHES = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SYMBOLS = {f"tiered_gather_{s}": [_P, _P, _P, _I, _P, _I, _P, _I, _I, _P]
            for s in ("f32", "bf16")}


def tiered_gather_cuda(tier: torch.Tensor, slot: torch.Tensor,
                       hot: torch.Tensor, warm: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream.

    Args:
        tier: ``(M,)`` int32 (0 = hot, 1 = warm, anything else → zeros).
        slot: ``(M,)`` int32 row index into the selected table.
        hot: ``(H, d)`` float32 or bfloat16 on a CUDA device.
        warm: ``(W, d)``, same dtype and device.

    Returns:
        ``(M, d)`` in ``hot.dtype``. ``M == 0`` or ``d == 0`` returns
        without launching (a grid of 0 blocks is a launch error).

    Raises:
        ValueError / TypeError: on inputs the kernel does not take.
        RuntimeError: when the launch reports a CUDA error.
    """
    device = hot.device
    if device.type != "cuda":
        raise ValueError("tiered_gather_cuda needs CUDA tensors, got "
                         f"{device}")
    check_addresses("tiered_gather", device, tier, slot)
    if tier.dim() != 1:
        raise ValueError("tiered_gather: tier/slot must be 1-D")
    check_tables("tiered_gather", device, hot, warm)
    m, d = int(tier.shape[0]), int(hot.shape[1])
    out = torch.empty((m, d), dtype=hot.dtype, device=device)
    if m == 0 or d == 0:
        return out.zero_()
    sym = f"tiered_gather_{DTYPE_SUFFIX[hot.dtype]}"
    fn = load("tiered_gather", _SYMBOLS)[sym]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(tier.data_ptr(), slot.data_ptr(), hot.data_ptr(),
                 hot.shape[0], warm.data_ptr(), warm.shape[0], out.data_ptr(),
                 m, d, stream)
    if err:
        raise RuntimeError(f"tiered_gather launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out
