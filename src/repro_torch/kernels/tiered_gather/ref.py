"""Plain PyTorch version of the tiered two-source gather: what the CPU
runs, and what ``chip_smoke.py`` holds the CUDA kernel against bitwise."""
from __future__ import annotations

from typing import Optional

import torch


def cost(m: int, d: int, elem: int, *,
         read_rows: Optional[int] = None) -> dict:
    """The least work of one call of ``m`` ids into ``(·, d)`` rows of
    ``elem`` bytes: the int32 tier and slot read once, each of
    ``read_rows`` distinct rows read once, the ``(m, d)`` output written
    once; no arithmetic. Where the data is not known (a fake tensor),
    each id reads its own row (``read_rows = m``)."""
    read_rows = m if read_rows is None else read_rows
    return {"flops": 0, "bytes": 8 * m + read_rows * d * elem + m * d * elem}


def tiered_gather_ref(tier: torch.Tensor, slot: torch.Tensor,
                      hot: torch.Tensor, warm: torch.Tensor) -> torch.Tensor:
    """``out[i] = hot[slot]`` if ``tier==0``, ``warm[slot]`` if ``tier==1``,
    else 0; the slot is clamped into each table, and rows pass through
    fp32 before the cast back to ``hot.dtype``."""
    safe = slot.long().clamp_min(0)
    hot_rows = hot[safe.clamp_max(hot.shape[0] - 1)].float()
    warm_rows = warm[safe.clamp_max(warm.shape[0] - 1)].float()
    out = torch.where((tier == 0)[:, None], hot_rows,
                      torch.where((tier == 1)[:, None], warm_rows, 0.0))
    return out.to(hot.dtype)
