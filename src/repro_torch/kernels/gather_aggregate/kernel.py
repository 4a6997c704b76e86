"""CUDA wrapper for the fused gather + segment sum
(``csrc/gather_aggregate.cu``).

Replaces ``src/repro/kernels/gather_aggregate/kernel.py::
gather_aggregate_pallas``. Bounded by HBM bytes
(``8·S·fan + valid_children·d·elem + S·d·elem``); one thread per column
accumulates its segment's children in order in an fp32 register, so the
dense child tensor is never written. See the source for the design note.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (DTYPE_SUFFIX, LaunchCounter,
                                       check_addresses, check_tables, load)

LAUNCHES = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SYMBOLS = {f"gather_aggregate_{s}":
            [_P, _P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _P]
            for s in ("f32", "bf16")}


def gather_aggregate_cuda(tier: torch.Tensor, slot: torch.Tensor,
                          hot: torch.Tensor, warm: torch.Tensor,
                          cold: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream.

    Args:
        tier: ``(S, fan)`` int32 (0 = hot, 1 = warm, 2 = cold, anything
            else contributes 0).
        slot: ``(S, fan)`` int32 row index into the selected table.
        hot, warm, cold: ``(·, d)`` float32 or bfloat16 row tables on one
            CUDA device.

    Returns:
        ``(S, d)`` per-segment sums in ``hot.dtype``, accumulated in fp32
        sequentially over the fan axis. ``S``, ``fan`` or ``d`` of 0
        returns zeros without launching.

    Raises:
        ValueError / TypeError: on inputs the kernel does not take.
        RuntimeError: when the launch reports a CUDA error.
    """
    device = hot.device
    if device.type != "cuda":
        raise ValueError("gather_aggregate_cuda needs CUDA tensors, got "
                         f"{device}")
    check_addresses("gather_aggregate", device, tier, slot)
    if tier.dim() != 2:
        raise ValueError("gather_aggregate: tier/slot must be (S, fan)")
    check_tables("gather_aggregate", device, hot, warm, cold)
    s, fan = (int(x) for x in tier.shape)
    d = int(hot.shape[1])
    out = torch.empty((s, d), dtype=hot.dtype, device=device)
    if s == 0 or fan == 0 or d == 0:
        return out.zero_()
    sym = f"gather_aggregate_{DTYPE_SUFFIX[hot.dtype]}"
    fn = load("gather_aggregate", _SYMBOLS)[sym]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(tier.data_ptr(), slot.data_ptr(), hot.data_ptr(),
                 hot.shape[0], warm.data_ptr(), warm.shape[0],
                 cold.data_ptr(), cold.shape[0], out.data_ptr(), s, fan, d,
                 stream)
    if err:
        raise RuntimeError(
            f"gather_aggregate launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out
