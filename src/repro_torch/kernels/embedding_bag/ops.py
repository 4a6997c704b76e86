"""Dispatch — the plain version for CPU tensors, the CUDA kernel otherwise
— and the autograd Function around it.

There is no fallback: a tensor that is not on the CPU goes to the kernel
wrapper, which launches or raises.

The backward has no kernel (the reference's Pallas kernel has none
either): it is the same torch ops on both devices. For ``out[b] = Σ_j
c_bj · table[id_bj]`` over the valid slots, with ``c_bj = w_bj`` (1
without weights) and, in mean mode, divided by the bag's valid count
``n_b``:

* ``d table[id_bj] += c_bj · g[b]`` — ``index_add_`` over the flattened
  slots, so a row that several slots read (a hot item, or one id twice in
  a bag) gets each slot's term. On the card the adds are atomics, in a
  run-dependent order: bits can differ from the CPU where ids repeat.
* ``d w_bj = ⟨g[b], table[id_bj]⟩`` (``/ n_b`` in mean mode) on valid
  slots, 0 on padded ones.

An id ≥ V reads row V-1 in the forward, so its gradient goes to row V-1.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import fake
from repro_torch.kernels.embedding_bag import kernel, ref


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, *,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag over ``-1``-padded bags; see
    :func:`ref.embedding_bag_ref`. Fake tensors take the dry-run's branch
    (:mod:`repro_torch.kernels.fake`)."""
    tensors = (table, ids) if weights is None else (table, ids, weights)
    if fake.is_fake(*tensors):
        if mode not in ref.MODES:
            raise ValueError(f"embedding_bag: mode must be one of "
                             f"{ref.MODES}, got {mode!r}")
        bsz, bag = ids.shape
        d = table.shape[1]
        cost = ref.cost(bsz, bag, d, table.element_size(),
                        weighted=weights is not None)
        return fake.fake_call("embedding_bag", cost, table, (bsz, d),
                              table.dtype)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.embedding_bag_ref(table, ids, weights, mode=mode)
    return kernel.embedding_bag_cuda(table, ids, weights, mode=mode)


class EmbeddingBag(torch.autograd.Function):
    """:func:`embedding_bag` with gradients for ``table`` and
    ``weights`` (module docstring)."""

    @staticmethod
    def forward(ctx, table, ids, weights, mode):
        ctx.save_for_backward(table, ids, weights)
        ctx.mode = mode
        return embedding_bag(table, ids, weights, mode=mode)

    @staticmethod
    def backward(ctx, grad_out):
        table, ids, weights = ctx.saved_tensors
        need_table, _, need_w, _ = ctx.needs_input_grad
        bsz, bag = ids.shape
        valid = ids >= 0
        rows = ids.long().clamp(0, table.shape[0] - 1)
        g = grad_out.to(table.dtype)
        if ctx.mode == "mean":
            count = valid.sum(1, keepdim=True).clamp_min(1).to(table.dtype)
            g = g / count
        g_table = g_w = None
        if need_table:
            coef = valid.to(table.dtype)
            if weights is not None:
                coef = coef * weights.to(table.dtype)
            terms = g[:, None, :] * coef[..., None]          # (B, bag, d)
            g_table = torch.zeros_like(table).index_add_(
                0, rows.reshape(-1), terms.reshape(bsz * bag, -1))
        if need_w:
            dots = (table[rows] * g[:, None, :]).sum(-1)     # (B, bag)
            g_w = torch.where(valid, dots, 0.0).to(weights.dtype)
        return g_table, None, g_w, None


def embedding_bag_autograd(table: torch.Tensor, ids: torch.Tensor,
                           weights: Optional[torch.Tensor] = None, *,
                           mode: str = "sum") -> torch.Tensor:
    """Differentiable :func:`embedding_bag` (gradients for ``table`` and
    ``weights``); the forward is the same dispatch, so a CUDA tensor
    launches the kernel once and a CPU one runs the plain version."""
    return EmbeddingBag.apply(table, ids, weights, mode)
