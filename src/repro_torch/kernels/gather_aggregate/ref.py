"""Plain PyTorch version of the fused gather → segment sum: what the CPU
runs, and what ``chip_smoke.py`` holds the CUDA kernel against bitwise.

The sum runs in fp32 over the fan axis one child at a time, in order —
the kernel's contract. ``x.sum(1)`` reduces in another order (it differs
in the last bits at larger fans), so it is not used here, and the model's
unfused aggregation uses :func:`fan_sum` so fused == unfused bitwise.
"""
from __future__ import annotations

import torch


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
