"""CUDA wrapper for EmbeddingBag (``csrc/embedding_bag.cu``).

Replaces ``src/repro/kernels/embedding_bag/kernel.py::
embedding_bag_pallas``. Bounded by HBM bytes
(``B·bag·(4 [+ elem]) + valid·d·elem + B·d·elem``); one thread per
(bag row, column) walks its bag in order with an fp32 register
accumulator and a valid count. See the source for the design note.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import (DTYPE_SUFFIX, LaunchCounter,
                                       check_tables, load)
from repro_torch.kernels.embedding_bag.ref import MODES

LAUNCHES = LaunchCounter()

_P, _I, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SYMBOLS = {f"embedding_bag_{s}": [_P, _P, _P, _I, _P, _I, _I, _I, _C, _C, _P]
            for s in ("f32", "bf16")}


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                       weights: Optional[torch.Tensor] = None, *,
                       mode: str = "sum") -> torch.Tensor:
    """Launch the kernel on the current stream.

    Args:
        table: ``(V, d)`` float32 or bfloat16 rows on a CUDA device,
            ``V ≥ 1``.
        ids: ``(B, bag)`` int32 row ids, ``-1`` (any negative) = padding;
            an id ≥ V reads row V-1.
        weights: ``(B, bag)`` per-entry weights in ``table.dtype``, or
            None.
        mode: ``"sum"``, or ``"mean"`` (÷ the valid count, at least 1).

    Returns:
        ``(B, d)`` in ``table.dtype``, accumulated in fp32 sequentially
        over the bag. ``B``, ``bag`` or ``d`` of 0 returns zeros without
        launching.

    Raises:
        ValueError / TypeError: on inputs the kernel does not take.
        RuntimeError: when the launch reports a CUDA error.
    """
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"embedding_bag_cuda needs CUDA tensors, got {device}")
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode must be one of {MODES}, "
                         f"got {mode!r}")
    check_tables("embedding_bag", device, table)
    if ids.dtype != torch.int32 or ids.dim() != 2 \
            or not ids.is_contiguous() or ids.device != device:
        raise ValueError("embedding_bag: ids must be a contiguous (B, bag) "
                         f"int32 tensor on {device}")
    if weights is not None and (
            weights.dtype != table.dtype or weights.shape != ids.shape
            or not weights.is_contiguous() or weights.device != device):
        raise ValueError("embedding_bag: weights must be contiguous, shaped "
                         f"like ids, in the table's dtype, on {device}")
    bsz, bag = (int(x) for x in ids.shape)
    d = int(table.shape[1])
    out = torch.empty((bsz, d), dtype=table.dtype, device=device)
    if bsz == 0 or bag == 0 or d == 0:
        return out.zero_()
    fn = load("embedding_bag", _SYMBOLS)[
        f"embedding_bag_{DTYPE_SUFFIX[table.dtype]}"]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ids.data_ptr(),
                 weights.data_ptr() if weights is not None else None,
                 table.data_ptr(), table.shape[0], out.data_ptr(), bsz, bag,
                 d, int(weights is not None), int(mode == "mean"), stream)
    if err:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out
