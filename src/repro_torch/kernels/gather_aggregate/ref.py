"""Plain PyTorch version of the fused gather → segment sum: what the CPU
runs, and what ``chip_smoke.py`` holds the CUDA kernel against bitwise.

The sum runs in fp32 over the fan axis one child at a time, in order —
the kernel's contract. ``x.sum(1)`` reduces in another order (it differs
in the last bits at larger fans), so it is not used here, and the model's
unfused aggregation uses :func:`fan_sum` so fused == unfused bitwise.
"""
from __future__ import annotations

from typing import Optional

import torch


def cost(s: int, fan: int, d: int, elem: int, *,
         read_rows: Optional[int] = None,
         valid: Optional[int] = None) -> dict:
    """The least work of one call on ``(s, fan)`` ids into ``(·, d)`` rows
    of ``elem`` bytes: the int32 tier and slot read once, each of
    ``read_rows`` distinct rows read once, the ``(s, d)`` output written
    once; operations = an add a valid child and column. Where the data is
    not known (a fake tensor), every child is valid and reads its own
    row."""
    valid = s * fan if valid is None else valid
    read_rows = valid if read_rows is None else read_rows
    return {"flops": valid * d,
            "bytes": 8 * s * fan + read_rows * d * elem + s * d * elem}


def fan_sum(x: torch.Tensor) -> torch.Tensor:
    """``(P, fan, d)`` → ``(P, d)``: fp32 sum over ``n = 0..fan-1`` in
    order, cast back to ``x.dtype``."""
    acc = x.new_zeros((x.shape[0],) + tuple(x.shape[2:]),
                      dtype=torch.float32)
    for n in range(x.shape[1]):
        acc = acc + x[:, n].float()
    return acc.to(x.dtype)


def gather_aggregate_ref(tier: torch.Tensor, slot: torch.Tensor,
                         hot: torch.Tensor, warm: torch.Tensor,
                         cold: torch.Tensor) -> torch.Tensor:
    """tier/slot: ``(S, fan)`` int32; hot/warm/cold: row tables sharing
    width d. Returns ``(S, d)`` per-segment sums; a tier outside
    {0, 1, 2} contributes zero."""
    if tier.shape[0] == 0 or tier.shape[1] == 0:
        return hot.new_zeros((tier.shape[0], hot.shape[1]))
    safe = slot.long().clamp_min(0)

    def rows(table):
        return table[safe.clamp_max(table.shape[0] - 1)].float()

    t = tier[..., None]
    picked = torch.where(t == 0, rows(hot), torch.where(
        t == 1, rows(warm), torch.where(t == 2, rows(cold), 0.0)))
    return fan_sum(picked).to(hot.dtype)
