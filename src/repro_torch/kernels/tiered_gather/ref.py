"""Plain PyTorch version of the tiered two-source gather: what the CPU
runs, and what ``chip_smoke.py`` holds the CUDA kernel against bitwise."""
from __future__ import annotations

import torch


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
