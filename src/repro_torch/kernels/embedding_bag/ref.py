"""Plain PyTorch version of EmbeddingBag: what the CPU runs, and what
``chip_smoke.py`` holds the CUDA kernel against bitwise.

Semantics are those of the Pallas body
(``src/repro/kernels/embedding_bag/kernel.py::_bag_kernel``):

  out[b] = Σ_j valid_bj · w_bj · table[min(ids[b,j], V-1)]
  valid_bj = ids[b,j] ≥ 0, w_bj = weights[b,j] cast to fp32 (1 without
  weights); mode ``mean`` divides by max(Σ_j valid_bj, 1) — the valid
  count, not Σ w.

The sum is taken in fp32 one ``j`` at a time, in bag order (the kernel's
contract, as ``gather_aggregate.fan_sum``), then cast to the table's
dtype. A weighted step is one fused multiply-add, ``acc ← fma(row, w,
acc)`` rounded once: that is what XLA compiles the Pallas body's
``acc + row * w`` to, and what the CUDA kernel issues. An id ≥ V reads
row V-1, as the Pallas body's dynamic slice does.
"""
from __future__ import annotations

from typing import Optional

import torch

MODES = ("sum", "mean")


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a·b + c`` for fp32 tensors, rounded once to fp32 (an IEEE fused
    multiply-add). The product is exact in fp64; TwoSum gives the fp64
    sum's rounding error, and an inexact sum is rounded to odd, so the
    final rounding to fp32 is not a double rounding."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def cost(bsz: int, bag: int, d: int, elem: int, *, weighted: bool,
         n_valid: Optional[int] = None) -> dict:
    """The least work of one call on ``(bsz, bag)`` ids into ``(·, d)``
    rows of ``elem`` bytes: bytes = each valid slot's row read once, the
    int32 ids (and the weights, in the table's dtype) read once, the
    ``(bsz, d)`` output written once; operations = an add a valid slot and
    column (a multiply-add when weighted). Where the data is not known (a
    fake tensor), every slot counts as valid."""
    n_valid = bsz * bag if n_valid is None else n_valid
    nbytes = (n_valid * d * elem + bsz * bag * (4 + (elem if weighted else 0))
              + bsz * d * elem)
    return {"flops": n_valid * d * (2 if weighted else 1), "bytes": nbytes}


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: Optional[torch.Tensor] = None, *,
                      mode: str = "sum") -> torch.Tensor:
    """table ``(V, d)``; ids ``(B, bag)`` with ``-1`` padding; weights
    ``(B, bag)`` or None. Returns ``(B, d)`` in ``table.dtype``."""
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode must be one of {MODES}, "
                         f"got {mode!r}")
    bsz, bag = ids.shape
    d = table.shape[1]
    if bsz == 0 or bag == 0 or d == 0:
        return table.new_zeros((bsz, d))
    valid = ids >= 0
    rows = table[ids.long().clamp(0, table.shape[0] - 1)].float()
    w = valid.float()
    if weights is not None:
        w = w * weights.float()
    acc = torch.zeros((bsz, d), dtype=torch.float32, device=table.device)
    for j in range(bag):
        wj = w[:, j, None].expand_as(acc)
        # unweighted, w is 0 or 1 and fma(row, w, acc) is acc + row·w
        acc = (fma_f32(rows[:, j], wj, acc) if weights is not None
               else acc + rows[:, j] * wj)
    if mode == "mean":
        acc = acc / valid.sum(1, keepdim=True).float().clamp_min(1.0)
    return acc.to(table.dtype)
