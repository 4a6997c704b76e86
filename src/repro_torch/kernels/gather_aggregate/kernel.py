"""CUDA wrapper for the fused gather + segment sum
(``csrc/gather_aggregate.cu``).

Replaces ``src/repro/kernels/gather_aggregate/kernel.py::
gather_aggregate_pallas``. Bounded by HBM bytes
(``8·S·fan + valid_children·d·elem + S·d·elem``), but at the serve path's
size by the chain of round trips a segment waits on. A group of lanes owns
a segment: the warp loads a window of 32 children's tier and slot at once,
each lane resolves one to a row address, and the group takes them with
shuffles and issues every child's vector loads before it folds them in
list order into fp32 registers. :func:`copy_plan` picks the vector width,
the lanes a segment and the grid. See the source for the design note.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (DTYPE_SUFFIX, LanePlan, LaunchCounter,
                                       call, check_addresses, check_tables,
                                       lane_plan, load, sm_count)

LAUNCHES = LaunchCounter()

# the kernel's constants (csrc/gather_aggregate.cu: kWarps, kMinBlocks)
WARPS = 4
MIN_BLOCKS = 6
DESIGN = ("a lane group a segment; a window of 32 children's tier/slot in "
          "one load, addresses by shuffle, every child row loaded (16-byte "
          "vectors, 8 in flight) before the ordered fold")

_P, _I, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SYMBOLS = {f"gather_aggregate_{s}":
            [_P, _P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _C, _C, _C, _P]
            for s in ("f32", "bf16")}


def copy_plan(d: int, elem: int, addr: int, segments: int,
              sms: int) -> LanePlan:
    """The kernel's plan for ``segments`` sums of ``d`` values of ``elem``
    bytes; ``addr`` is the three tables' and the output's addresses OR-ed
    together. See :func:`repro_torch.kernels.build.lane_plan`."""
    return lane_plan(d, elem, addr, segments, sms, WARPS, MIN_BLOCKS)


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
    s, fan = tier.shape
    d = hot.shape[1]
    out = torch.empty((s, d), dtype=hot.dtype, device=device)
    if s == 0 or fan == 0 or d == 0:
        return out.zero_()
    hp, wp, cp, op = (hot.data_ptr(), warm.data_ptr(), cold.data_ptr(),
                      out.data_ptr())
    plan = copy_plan(d, hot.element_size(), hp | wp | cp | op, s,
                     sm_count(device))
    fn = load("gather_aggregate", _SYMBOLS)[
        f"gather_aggregate_{DTYPE_SUFFIX[hot.dtype]}"]
    err = call(device, fn, tier.data_ptr(), slot.data_ptr(), hp,
               hot.shape[0], wp, warm.shape[0], cp, cold.shape[0], op, s,
               fan, d, plan.vec_bytes, plan.lanes, plan.blocks)
    if err:
        raise RuntimeError(
            f"gather_aggregate launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out
