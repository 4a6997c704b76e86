"""CUDA wrapper for the two-source tiered gather (``csrc/tiered_gather.cu``).

Replaces ``src/repro/kernels/tiered_gather/kernel.py::tiered_gather_pallas``.
The kernel is a pure copy bounded by HBM bytes (``2·M·d·elem + 8·M``), but
at the serve path's size by the round trips a row waits on. A group of
lanes owns a row: its lanes load the row's tier and slot together (one
shared load each), resolve the row's address and issue the row's vector
loads before any store; rows of another tier read nothing.
:func:`copy_plan` picks the vector width, the lanes a row and the grid.
See the source for the design note.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (DTYPE_SUFFIX, LanePlan, LaunchCounter,
                                       call, check_addresses, check_tables,
                                       lane_plan, load, sm_count)

LAUNCHES = LaunchCounter()

# the kernel's constants (csrc/tiered_gather.cu: kWarps, kMinBlocks)
WARPS = 4
MIN_BLOCKS = 6
DESIGN = ("a lane group a row; its tier and slot in one shared load each, "
          "the row's 16-byte vectors all loaded before any store")

_P, _I, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SYMBOLS = {f"tiered_gather_{s}":
            [_P, _P, _P, _I, _P, _I, _P, _I, _I, _C, _C, _C, _P]
            for s in ("f32", "bf16")}


def copy_plan(d: int, elem: int, addr: int, rows: int,
              sms: int) -> LanePlan:
    """The kernel's plan for ``rows`` rows of ``d`` values of ``elem``
    bytes; ``addr`` is both tables' and the output's addresses OR-ed
    together. See :func:`repro_torch.kernels.build.lane_plan`."""
    return lane_plan(d, elem, addr, rows, sms, WARPS, MIN_BLOCKS)


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
    m, d = tier.shape[0], hot.shape[1]
    out = torch.empty((m, d), dtype=hot.dtype, device=device)
    if m == 0 or d == 0:
        return out.zero_()
    hp, wp, op = hot.data_ptr(), warm.data_ptr(), out.data_ptr()
    plan = copy_plan(d, hot.element_size(), hp | wp | op, m,
                     sm_count(device))
    fn = load("tiered_gather", _SYMBOLS)[
        f"tiered_gather_{DTYPE_SUFFIX[hot.dtype]}"]
    err = call(device, fn, tier.data_ptr(), slot.data_ptr(), hp,
               hot.shape[0], wp, warm.shape[0], op, m, d, plan.vec_bytes,
               plan.lanes, plan.blocks)
    if err:
        raise RuntimeError(f"tiered_gather launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out
