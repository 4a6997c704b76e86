"""CUDA wrapper for flash attention (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/kernel.py::
flash_attention_pallas``. Bounded by operations (a causal prefill does
``4·B·H·dh·Sq(Sq+1)/2`` flops on inputs read once). bf16, what the LM
serves (:data:`DESIGNS`): ``wgmma`` fed by a TMA ring, one CTA per (b, h,
128-query tile), p·v on the tensor cores as three bf16 terms of the fp32
p (``ref.split_bf16x3``). fp32, for checks: CUDA cores. See the source for
the design note.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import DTYPE_SUFFIX, LaunchCounter, call, load

LAUNCHES = LaunchCounter()
HEAD_DIMS = (16, 32, 64, 96, 128)  # the head widths the kernel is built for
MAX_GRID_YZ = 65535             # grid.y and grid.z limits
BF16_BLOCK_M = 128              # queries per CTA of the bf16 kernel
DESIGNS = {torch.bfloat16: "wgmma+tma", torch.float32: "cuda-cores"}
# codes the C launcher returns beside cudaError_t's
_LAUNCHER_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled",
                    -2: "cuTensorMapEncodeTiled refused the tensor map"}

_P, _I, _F, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
_SYMBOLS = {f"flash_attention_{s}": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _F, _C, _P]
            for s in ("f32", "bf16")}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Launch the kernel on the current stream.

    Args:
        q: ``(B, Sq, H, dh)`` float32 or bfloat16, contiguous, on a CUDA
            device; ``dh`` one of :data:`HEAD_DIMS`.
        k, v: ``(B, Skv, KV, dh)`` in q's dtype, contiguous, with
            ``H % KV == 0``.
        causal: mask ``kv_pos > q_pos`` (aligned top-left, as the Pallas
            body does).

    Returns:
        ``(B, Sq, H, dh)`` in q's dtype. An empty q returns an empty
        output and ``Skv = 0`` returns zeros, both without launching.

    Raises:
        ValueError / TypeError: on inputs the kernel does not take.
        RuntimeError: when the launch reports a CUDA error.
    """
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{device}")
    if q.dtype not in DTYPE_SUFFIX:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != device or t.dtype != q.dtype or t.dim() != 4 \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be a contiguous, "
                             f"16-byte aligned 4-D {q.dtype} tensor on "
                             f"{device}")
    b, sq, h, dh = (int(x) for x in q.shape)
    skv, kvh = int(k.shape[1]), int(k.shape[2])
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh \
            or kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"pair with k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} (H % KV == 0)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    # fp32 grid: (q tiles, H, B); bf16: (H, q tiles, B)
    if h > MAX_GRID_YZ or b > MAX_GRID_YZ \
            or -(-sq // BF16_BLOCK_M) > MAX_GRID_YZ or max(sq, skv) >= 2**31:
        raise ValueError(f"flash_attention: B {b}, H {h} and Sq / "
                         f"{BF16_BLOCK_M} must be at most {MAX_GRID_YZ}, "
                         f"Sq and Skv below 2^31")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if skv == 0:
        return out.zero_()
    fn = load("flash_attention", _SYMBOLS)[
        f"flash_attention_{DTYPE_SUFFIX[q.dtype]}"]
    err = call(device, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), b, sq, skv, h, kvh, dh, 1.0 / math.sqrt(dh),
               int(causal))
    if err:
        why = _LAUNCHER_ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"flash_attention launch failed: {why}")
    LAUNCHES.add()
    return out

