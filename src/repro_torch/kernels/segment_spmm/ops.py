"""Dispatch — the plain version for CPU tensors, the CUDA kernel otherwise
— and the autograd Function around it.

There is no fallback: a tensor that is not on the CPU goes to the kernel
wrapper, which launches or raises.

The gradient of ``out = A·feat`` (``A`` the ELL adjacency) is
``grad_feat = Aᵀ·grad_out``: the same SpMM over the transposed table, so
the backward is one more launch of the same kernel — deterministic and
scatter-free, where ``index_add_`` would accumulate with atomics.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import fake
from repro_torch.kernels.segment_spmm import kernel, ref


def segment_spmm(ids: torch.Tensor, feat: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ELL SpMM over ``-1``-padded ids; see
    :func:`ref.segment_spmm_plain`. Fake tensors take the dry-run's
    branch (:mod:`repro_torch.kernels.fake`)."""
    tensors = (ids, feat) if weights is None else (ids, feat, weights)
    if fake.is_fake(*tensors):
        n, dmax = ids.shape
        m, d = feat.shape
        cost = ref.cost(n, dmax, d, feat.element_size(),
                        rows_read=min(m, n * dmax),
                        weighted=weights is not None)
        return fake.fake_call("segment_spmm", cost, feat, (n, d),
                              feat.dtype)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.segment_spmm_plain(ids, feat, weights)
    return kernel.segment_spmm_cuda(ids, feat, weights)


class SegmentSpmm(torch.autograd.Function):
    """``segment_spmm`` with a backward for ``feat`` (unweighted only)."""

    @staticmethod
    def forward(ctx, ids, feat, weights, ids_t):
        ctx.save_for_backward(ids, ids_t)
        ctx.num_rows = feat.shape[0]
        return segment_spmm(ids, feat, weights)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[1]:
            return None, None, None, None
        ids, ids_t = ctx.saved_tensors
        if ids_t is None:
            ids_t = ref.transpose_ell(ids, ctx.num_rows)
        return None, segment_spmm(ids_t, grad_out.contiguous()), None, None


def segment_spmm_autograd(ids: torch.Tensor, feat: torch.Tensor,
                          weights: Optional[torch.Tensor] = None, *,
                          ids_t: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Differentiable :func:`segment_spmm` (gradient for ``feat``).

    Args:
        ids: ``(N, Dmax)`` ELL table indexing ``feat``'s rows.
        feat: ``(M, d)``; when it needs no gradient (a model's input
            features), the backward launches nothing.
        weights: ``(N, Dmax)`` or None; allowed only where no gradient
            flows through the call.
        ids_t: the transposed table (row ``j`` lists the rows of ``ids``
            that hold ``j``), e.g. the second table of ``ref.ell_pair``; if
            None the backward builds it from ``ids`` on their device.

    Raises:
        NotImplementedError: a gradient would flow with weights given (the
            backward takes no weights).
    """
    if weights is not None and torch.is_grad_enabled() and (
            weights.requires_grad or feat.requires_grad):
        raise NotImplementedError(
            "segment_spmm_autograd: the backward is unweighted; no gradient "
            "may flow through a weighted call (GIN is unweighted)")
    return SegmentSpmm.apply(ids, feat, weights, ids_t)
