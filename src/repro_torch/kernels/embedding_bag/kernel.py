"""CUDA wrapper for EmbeddingBag (``csrc/embedding_bag.cu``).

Replaces ``src/repro/kernels/embedding_bag/kernel.py::
embedding_bag_pallas``. Bounded by HBM bytes
(``B·bag·(4 [+ elem]) + valid·d·elem + B·d·elem``). One block owns a
bag: its threads compact the bag's valid ids in list order, copy all of
those rows (up to a ring of them) into shared memory with ``cp.async`` at
once, wait once, and one thread per column folds them in order into an
fp32 register with the valid count. :func:`copy_plan` sizes the ring and
picks the copy width. See the source for the design note.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import (DTYPE_SUFFIX, CopyPlan,
                                       LaunchCounter, blocks_per_sm, call,
                                       check_tables, chunk_bytes, load)
from repro_torch.kernels.embedding_bag.ref import MODES

LAUNCHES = LaunchCounter()

# the kernel's constants (csrc/embedding_bag.cu: kThreads, kTileCols)
THREADS = 128
TILE_COLS = 128
RING_BUDGET = 65536    # ring bytes a block may take: ≥ 3 blocks an SM
MAX_GRID = 2**31 - 1

_P, _I, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SYMBOLS = {f"embedding_bag_{s}": [_P, _P, _P, _I, _P, _I, _I, _I, _C, _C,
                                   _C, _C, _C, _C, _P]
            for s in ("f32", "bf16")}


def copy_plan(d: int, elem: int, base_ptr: int, bag: int) -> CopyPlan:
    """The kernel's shared-memory plan for ``(V, d)`` rows of ``elem``-byte
    values at address ``base_ptr`` and bags of ``bag`` ids.

    A block's ring holds ``ring_rows`` slots of one ``min(d, 128)``-column
    tile row each (rounded up to 16 bytes), with an fp32 weight and an id
    beside each: the whole bag rounded up to a window of ``THREADS`` ids
    where that fits in ~64 KB (DIN's 100 ids of 144 bytes: one pass,
    ~19 KB, 11 blocks an SM), else as many windows as fit (at least one),
    so a longer bag takes several passes."""
    slot = -(-min(d, TILE_COLS) * elem // 16) * 16
    whole = -(-max(bag, 1) // THREADS) * THREADS
    fit = max(THREADS, RING_BUDGET // (slot + 8) // THREADS * THREADS)
    ring = min(whole, fit)
    smem = -(-(ring * (slot + 8) + 4 * (THREADS // 32)) // 16) * 16
    return CopyPlan(chunk_bytes(d * elem, base_ptr), ring, smem, 1,
                    blocks_per_sm(smem, THREADS))


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
    plan = copy_plan(d, table.element_size(), table.data_ptr(), bag)
    err = call(device, fn, ids.data_ptr(),
               weights.data_ptr() if weights is not None else None,
               table.data_ptr(), table.shape[0], out.data_ptr(), bsz, bag, d,
               int(weights is not None), int(mode == "mean"),
               plan.chunk_bytes, plan.ring_rows, plan.smem_bytes,
               min(bsz, MAX_GRID))
    if err:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out
