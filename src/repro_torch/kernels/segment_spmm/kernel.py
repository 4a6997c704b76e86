"""CUDA wrapper for the ELL segment-SpMM (``csrc/segment_spmm.cu``).

Replaces ``src/repro/kernels/segment_spmm/kernel.py::segment_spmm_pallas``.
Bounded by HBM bytes (``N·Dmax·4 [+ N·Dmax·elem] + rows_read·d·elem +
N·d·elem``; each row is in practice gathered once per edge); one warp per
output row, lanes along ``d``, walks the row's ids in order with fp32
register accumulators. See the source for the design note.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import (DTYPE_SUFFIX, LaunchCounter,
                                       check_tables, load)

LAUNCHES = LaunchCounter()

_P, _I, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SYMBOLS = {f"segment_spmm_{s}": [_P, _P, _P, _I, _P, _I, _I, _I, _C, _P]
            for s in ("f32", "bf16")}


def segment_spmm_cuda(ids: torch.Tensor, feat: torch.Tensor,
                      weights: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Launch the kernel on the current stream.

    Args:
        ids: ``(N, Dmax)`` int32 row ids into ``feat``; any negative id is
            padding and may stand anywhere in a row; an id ≥ M reads row
            M-1.
        feat: ``(M, d)`` float32 or bfloat16 rows on a CUDA device,
            ``M ≥ 1``.
        weights: ``(N, Dmax)`` per-entry weights in ``feat.dtype``, or
            None.

    Returns:
        ``(N, d)`` in ``feat.dtype``, accumulated in fp32 sequentially
        over the row's ids. ``N``, ``Dmax`` or ``d`` of 0 returns zeros
        without launching.

    Raises:
        ValueError / TypeError: on inputs the kernel does not take.
        RuntimeError: when the launch reports a CUDA error.
    """
    device = feat.device
    if device.type != "cuda":
        raise ValueError(f"segment_spmm_cuda needs CUDA tensors, got {device}")
    check_tables("segment_spmm", device, feat)
    if ids.dtype != torch.int32 or ids.dim() != 2 \
            or not ids.is_contiguous() or ids.device != device:
        raise ValueError("segment_spmm: ids must be a contiguous (N, Dmax) "
                         f"int32 tensor on {device}")
    if weights is not None and (
            weights.dtype != feat.dtype or weights.shape != ids.shape
            or not weights.is_contiguous() or weights.device != device):
        raise ValueError("segment_spmm: weights must be contiguous, shaped "
                         f"like ids, in feat's dtype, on {device}")
    n, dmax = (int(x) for x in ids.shape)
    d = int(feat.shape[1])
    out = torch.empty((n, d), dtype=feat.dtype, device=device)
    if n == 0 or dmax == 0 or d == 0:
        return out.zero_()
    fn = load("segment_spmm", _SYMBOLS)[
        f"segment_spmm_{DTYPE_SUFFIX[feat.dtype]}"]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ids.data_ptr(),
                 weights.data_ptr() if weights is not None else None,
                 feat.data_ptr(), feat.shape[0], out.data_ptr(), n, dmax, d,
                 int(weights is not None), stream)
    if err:
        raise RuntimeError(f"segment_spmm launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out
