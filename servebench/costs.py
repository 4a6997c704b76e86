"""The yardstick's arithmetic: the card's published peaks, the least bytes
of the two serve kernels' calls, and the served model's FLOPs a seed.

The kernel costs are copies of the port's ``kernels/tiered_gather/ref.py::
cost`` and ``kernels/gather_aggregate/ref.py::cost``, kept here so that the
benchmark's bound does not move with the program.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

# NVIDIA H100 SXM data sheet, dense: HBM3 bandwidth and fp32 (non tensor
# core) rate, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def tiered_gather_cost(m: int, d: int, elem: int, *,
                       read_rows: Optional[int] = None) -> dict:
    """One call of ``m`` ids into ``(., d)`` rows of ``elem`` bytes: the
    int32 tier and slot read once, each of ``read_rows`` distinct rows
    read once, the ``(m, d)`` output written once; no arithmetic."""
    read_rows = m if read_rows is None else read_rows
    return {"flops": 0, "bytes": 8 * m + read_rows * d * elem + m * d * elem}


def gather_aggregate_cost(s: int, fan: int, d: int, elem: int, *,
                          read_rows: Optional[int] = None,
                          valid: Optional[int] = None) -> dict:
    """One call on ``(s, fan)`` ids into ``(., d)`` rows: the int32 tier
    and slot read once, each of ``read_rows`` distinct rows read once, the
    ``(s, d)`` output written once; an add a valid child and column."""
    valid = s * fan if valid is None else valid
    read_rows = valid if read_rows is None else read_rows
    return {"flops": valid * d,
            "bytes": 8 * s * fan + read_rows * d * elem + s * d * elem}


def _distinct(tier: torch.Tensor, slot: torch.Tensor,
              tiers: Sequence[int]) -> tuple[int, int]:
    """``(distinct (tier, slot) pairs, valid entries)`` over the entries
    whose tier is in ``tiers``."""
    t, s = tier.reshape(-1).long(), slot.reshape(-1).long()
    keep = torch.zeros_like(t, dtype=torch.bool)
    for x in tiers:
        keep |= t == x
    key = t[keep] * (1 << 32) + s[keep]
    return int(torch.unique(key).numel()), int(keep.sum())


def tiered_gather_bytes(tier, slot, hot, warm) -> int:
    """Least bytes of one ``tiered_gather(tier, slot, hot, warm)`` call:
    distinct HOT/WARM rows read once (other tiers write zeros)."""
    rows, _ = _distinct(tier, slot, (0, 1))
    return tiered_gather_cost(int(tier.shape[0]), int(hot.shape[1]),
                              hot.element_size(), read_rows=rows)["bytes"]


def gather_aggregate_bytes(tier, slot, hot, warm, cold) -> int:
    """Least bytes of one ``gather_aggregate(tier, slot, hot, warm, cold)``
    call: distinct rows of the three tables read once."""
    rows, valid = _distinct(tier, slot, (0, 1, 2))
    s, fan = int(tier.shape[0]), int(tier.shape[1])
    return gather_aggregate_cost(s, fan, int(hot.shape[1]),
                                 hot.element_size(), read_rows=rows,
                                 valid=valid)["bytes"]


def sage_flops_per_seed(dims: Sequence[int], fanouts: Sequence[int]) -> int:
    """Model FLOPs of one unpadded seed, from shapes alone: for layer ℓ
    and level k < L - ℓ, ``rows = Π_{i<k} f_i`` rows each take two GEMMs
    of ``d_ℓ × d_{ℓ+1}`` (2 FLOPs a multiply-add) and the fan sum of
    ``f_k`` children of width ``d_ℓ``."""
    L = len(fanouts)
    total = 0
    for layer in range(L):
        d_in, d_out = dims[layer], dims[layer + 1]
        rows = 1
        for k in range(L - layer):
            total += rows * (2 * 2 * d_in * d_out + fanouts[k] * d_in)
            rows *= fanouts[k]
    return total
