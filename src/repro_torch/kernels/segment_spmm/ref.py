"""Plain PyTorch version of the ELL segment-SpMM, the COO → ELL packing and
the device builder of the forward/transposed ELL pair.

Semantics are those of the Pallas body
(``src/repro/kernels/segment_spmm/kernel.py::_spmm_kernel``):

  out[i] = Σ_n valid_in · w_in · feat[min(ids[i,n], M-1)]
  valid_in = ids[i,n] ≥ 0, w_in = weights[i,n] cast to fp32 (1 without
  weights).

The sum is taken in fp32 one ELL column ``n`` at a time, in column order
(the Pallas body's ``fori_loop``), then cast to ``feat``'s dtype — not the
reference oracle's ``.sum(1)``. A weighted step is one fused multiply-add,
``acc ← fma(row, w, acc)`` rounded once: XLA compiles the Pallas body's
``acc + row * w`` to that (as for ``embedding_bag``), and the CUDA kernel
issues it. A padded id reads no row: its Pallas term ``row·0`` is ±0 and
leaves an fp32 sum unchanged, so skipping it gives the same bits. An id ≥ M
reads row M-1, as the Pallas body's dynamic slice does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.embedding_bag.ref import fma_f32


def segment_spmm_plain(ids: torch.Tensor, feat: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """ids ``(N, Dmax)`` with ``-1`` padding; feat ``(M, d)``; weights
    ``(N, Dmax)`` or None. Returns ``(N, d)`` in ``feat.dtype``.

    The accumulator is fp32 (fp64 for a float64 ``feat``, which only
    ``torch.autograd.gradcheck`` hands in; the kernel takes fp32 and bf16).
    Never materializes the ``(N, Dmax, d)`` gather: one column of rows at
    a time. Column ``j`` visits only the rows with a valid id at or past
    ``j`` (the rows sorted by their last valid column, so a prefix of
    them), which costs about one row a valid id on a skewed table (the
    serve graph's out-neighbour table is 5,003 wide for 12 ids a row); a
    row's terms are the same and come in the same order, so the bits do
    not change."""
    n, dmax = ids.shape
    m, d = feat.shape
    if n == 0 or dmax == 0 or d == 0:
        return feat.new_zeros((n, d))
    acc_dtype = torch.float64 if feat.dtype == torch.float64 else torch.float32
    valid = ids >= 0
    cols = torch.arange(dmax, device=ids.device)
    last = torch.where(valid, cols, -1).amax(1)
    order = torch.argsort(last, descending=True, stable=True)
    # rows still active at column j: those whose last valid column ≥ j
    active = torch.bincount(last[last >= 0], minlength=dmax).flip(0)
    active = active.cumsum(0).flip(0).tolist()
    ids_s = ids[order]
    w_s = weights[order] if weights is not None else None
    acc = torch.zeros((n, d), dtype=acc_dtype, device=feat.device)
    for j in range(dmax):
        k = active[j]
        if k == 0:
            break
        col = ids_s[:k, j]
        part = acc[:k]
        row = feat[col.long().clamp(0, m - 1)].to(acc_dtype)
        if w_s is None:
            step = part + row
        else:
            w = w_s[:k, j, None].to(acc_dtype).expand_as(row)
            step = (fma_f32(row, w, part) if acc_dtype == torch.float32
                    else part + row * w)
        acc[:k] = torch.where((col >= 0)[:, None], step, part)
    out = torch.empty_like(acc)
    out[order] = acc
    return out.to(feat.dtype)


def cost(n: int, dmax: int, d: int, elem: int, *,
         nnz: Optional[int] = None, rows_read: Optional[int] = None,
         weighted: bool = False) -> dict:
    """The least work of one call on an ``(n, dmax)`` table into ``(·,
    d)`` rows of ``elem`` bytes: bytes = the int32 ids (and fp32 weights)
    read once, each of ``rows_read`` distinct rows read once, the
    ``(n, d)`` output written once; operations = one add a valid id and
    column (a multiply-add when weighted). Where the data is not known (a
    fake tensor), every slot counts as valid (``nnz = n·dmax``) and each
    row is read once (``rows_read = nnz``; the caller caps it at the
    table's rows)."""
    nnz = n * dmax if nnz is None else nnz
    rows_read = nnz if rows_read is None else rows_read
    nbytes = (n * dmax * (8 if weighted else 4) + rows_read * d * elem
              + n * d * elem)
    return {"flops": nnz * d * (2 if weighted else 1), "bytes": nbytes}


def coo_to_ell(src: np.ndarray, dst: np.ndarray, num_nodes: int,
               *, dmax: Optional[int] = None) -> np.ndarray:
    """Pack a COO edge list into the ``(N, Dmax)`` int32 ELL table: row
    ``i`` holds the ``src`` of the edges with ``dst = i`` in edge order,
    then ``-1``. ``dmax`` defaults to the largest in-degree; a smaller one
    keeps each row's first edges in edge order. The reference's Python loop
    (``src/repro/kernels/segment_spmm/ref.py::coo_to_ell``) vectorized with
    a stable sort, layout bit for bit. Like it, a negative ``dst`` raises
    (``np.bincount``)."""
    src, dst = np.asarray(src), np.asarray(dst)
    deg = np.bincount(dst, minlength=num_nodes)
    if dmax is None:
        dmax = int(deg.max()) if deg.size else 1
    ell = np.full((num_nodes, dmax), -1, dtype=np.int32)
    order = np.argsort(dst, kind="stable")
    d_sorted = dst[order]
    pos = np.arange(dst.size) - (np.cumsum(deg) - deg)[d_sorted]
    keep = pos < dmax
    ell[d_sorted[keep], pos[keep]] = src[order][keep]
    return ell


def _ell(src: torch.Tensor, dst: torch.Tensor, num_rows: int
         ) -> torch.Tensor:
    """``coo_to_ell(src, dst, num_rows)`` for valid int64 edges, on their
    device: ``dmax`` is the largest degree, so no edge is truncated."""
    deg = torch.bincount(dst, minlength=num_rows)
    if deg.numel() > num_rows:
        raise ValueError(f"edge endpoint {int(dst.max())} is not below the "
                         f"{num_rows} rows")
    dmax = int(deg.max()) if num_rows else 1
    ell = torch.full((num_rows, dmax), -1, dtype=torch.int32,
                     device=dst.device)
    if dst.numel():
        order = torch.sort(dst, stable=True).indices
        d_sorted = dst[order]
        start = torch.cumsum(deg, 0) - deg
        pos = torch.arange(dst.numel(), device=dst.device) - start[d_sorted]
        ell[d_sorted, pos] = src[order].to(torch.int32)
    return ell


def ell_table(src: torch.Tensor, dst: torch.Tensor, num_rows: int
              ) -> torch.Tensor:
    """One ELL table on the edges' device: row ``d`` lists ``src[e]`` of
    the edges ``e`` with ``dst[e] = d``, in edge order, ``-1`` padded to
    the largest such degree; edges with a negative end are dropped, as
    ``scatter_spmm`` zeroes them. The first table of :func:`ell_pair`
    without the second."""
    keep = (src >= 0) & (dst >= 0)
    return _ell(src[keep].long(), dst[keep].long(), num_rows)


def ell_pair(src: torch.Tensor, dst: torch.Tensor, num_nodes: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward and transposed ELL tables of an edge list, built on the
    edges' device with a stable sort (no host round trip of the edges).

    Edges with a negative ``src`` or ``dst`` are dropped first, as
    ``scatter_spmm`` zeroes them (the reference's ``coo_to_ell`` would
    raise on a negative ``dst`` instead).

    Returns:
        ``(ids, ids_t)``: ``ids[d]`` = the in-neighbours of ``d`` in edge
        order, equal to ``coo_to_ell(src, dst, N)``; ``ids_t[s]`` = the
        out-neighbours of ``s``, equal to ``coo_to_ell(dst, src, N)`` —
        the table of the SpMM's gradient. Both int32 with ``-1`` padding.
    """
    return ell_table(src, dst, num_nodes), ell_table(dst, src, num_nodes)


def transpose_ell(ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The transposed table of an ELL table whose ids index ``num_rows``
    rows: row ``j`` lists the rows ``i`` with ``j`` in ``ids[i]``, in
    row-major order of ``ids``."""
    rows, cols = (ids >= 0).nonzero(as_tuple=True)
    return _ell(rows, ids[rows, cols].long(), num_rows)
