"""CUDA wrapper for the ELL segment-SpMM (``csrc/segment_spmm.cu``).

Replaces ``src/repro/kernels/segment_spmm/kernel.py::segment_spmm_pallas``.
Bounded by HBM bytes (``N·Dmax·4 [+ N·Dmax·elem] + rows_read·d·elem +
N·d·elem``; each row is in practice gathered once per edge, so the
ceiling is HBM bandwidth on ``nnz·d·elem``). A persistent grid of
``WARPS``-warp blocks; each warp walks output rows grid-stride and keeps a
ring of neighbour rows in shared memory filled by asynchronous copies
(``cp.async.bulk`` a row, or per-lane ``cp.async``), 32 ids a window
compacted in list order, the ids themselves copied 8 windows ahead, the
ring running on across output rows; it folds the slots in order, lanes
along ``d``, into fp32 registers. :func:`copy_plan` sizes the ring and
picks the copy width, :func:`whole_lines` the whole-line case. See the
source for the design note.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import (DTYPE_SUFFIX, CopyPlan,
                                       LaunchCounter, blocks_per_sm, call,
                                       check_tables, chunk_bytes, load)

LAUNCHES = LaunchCounter()

# the kernel's constants (csrc/segment_spmm.cu: kWarps, kWindows, kGroups)
WARPS = 4
WINDOWS = 8            # windows of 32 ids copied ahead, per warp
GROUPS = 8             # records of windows in flight, per warp
TILE_COLS = 128        # the widest tile a unit covers (32 lanes x 4)
WARP_BUDGET = 7168     # ring bytes a warp aims for
RING_MIN, RING_MAX = 32, 256
MAX_GRID = 2**31 - 1

_P, _I, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SYMBOLS = {f"segment_spmm_{s}": [_P, _P, _P, _I, _P, _I, _I, _I, _C, _C,
                                  _C, _C, _C, _C, _C, _P]
            for s in ("f32", "bf16")}


def whole_lines(row_bytes: int, base_ptr: int, chunk: int) -> bool:
    """Whether every row is whole 128-byte L2 lines (with 16-byte copies).
    The kernel then copies rows lane by lane and lets the L2 fetch whole
    lines; other rows of whole 16-byte units go in one bulk copy each."""
    return chunk == 16 and row_bytes % 128 == 0 and base_ptr % 128 == 0


def lane_columns(d: int) -> int:
    """Columns a lane folds (``kVec``): the fewest of 1, 2 and 4 that let
    32 lanes cover ``min(d, 128)``; a unit is one ``32·kVec``-column tile
    of an output row."""
    return 1 if d <= 32 else 2 if d <= 64 else 4


def copy_plan(d: int, elem: int, base_ptr: int) -> CopyPlan:
    """The kernel's shared-memory plan for ``(M, d)`` rows of ``elem``-byte
    values at address ``base_ptr``.

    Each warp owns a ring of ``ring_rows`` slots, one ``min(d, 128)``-column
    tile row each (rounded up to 16 bytes), with an fp32 weight and an id
    beside each slot, ``GROUPS`` window records and ``WINDOWS`` x 32 ids
    copied ahead. The ring is sized to ~7 KB a warp, at least 32 slots (a
    window of 32 ids always fits an empty ring) and at most 256: small
    rings let 4-5 four-warp blocks share an SM, and on ogb_products the
    kernel's pace is set by how many warps issue and fold at once more
    than by the bytes each keeps in flight (a measured sweep: PERF.md)."""
    slot = -(-min(d, TILE_COLS) * elem // 16) * 16
    ring = max(RING_MIN, min(RING_MAX, WARP_BUDGET // (slot + 8)))
    warp_bytes = -(-(8 * GROUPS + ring * (slot + 8) + 4 * GROUPS
                     + 4 * 32 * WINDOWS) // 16) * 16
    smem = WARPS * warp_bytes
    return CopyPlan(chunk_bytes(d * elem, base_ptr), ring, smem, WARPS,
                    blocks_per_sm(smem, WARPS * 32))


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
    plan = copy_plan(d, feat.element_size(), feat.data_ptr())
    units = n * -(-d // (32 * lane_columns(d)))  # (output row, tile) pairs
    # the kernel caps its persistent grid at the blocks resident at once
    blocks = min(-(-units // WARPS), MAX_GRID)
    fn = load("segment_spmm", _SYMBOLS)[
        f"segment_spmm_{DTYPE_SUFFIX[feat.dtype]}"]
    err = call(device, fn, ids.data_ptr(),
               weights.data_ptr() if weights is not None else None,
               feat.data_ptr(), feat.shape[0], out.data_ptr(), n, dmax, d,
               int(weights is not None), plan.chunk_bytes,
               int(whole_lines(d * feat.element_size(), feat.data_ptr(),
                               plan.chunk_bytes)),
               lane_columns(d), plan.ring_rows, plan.smem_bytes, blocks)
    if err:
        raise RuntimeError(f"segment_spmm launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out
