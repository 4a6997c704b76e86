"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one self-contained ``csrc/<name>.cu`` with a plain C
interface. It is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``build/kernels/`` at the repository root, named by a hash of its
source and flags (an edited source builds anew, an unchanged one is
reused), and loaded with ``ctypes``. Nothing is built when a module is
imported: the first launch builds, or :func:`build_all` builds every
kernel at once, one ``nvcc`` process per source, all started together.

Every exported C function launches on the stream it is given and returns
``cudaGetLastError()``; the Python wrappers raise when that is non-zero.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("tiered_gather", "gather_aggregate")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Kernel launches since the last :meth:`reset` — a plain int, bumped
    under a lock because executor lanes launch from several threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path(name: str) -> Path:
    """Where ``name``'s shared library lives once built."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Sequence[str] = KERNELS) -> dict[str, Path]:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes at once. Returns name → library path.

    Raises:
        RuntimeError: a compile failed (its compiler output is included).
    """
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def build_all() -> dict[str, Path]:
    """Build every kernel of the port (see :data:`KERNELS`)."""
    return build(KERNELS)


def load(name: str, symbols: dict[str, list]) -> dict[str, ctypes._CFuncPtr]:
    """Build (if needed) and load ``name``'s library; return its exported
    functions with ``argtypes`` set from ``symbols`` and an ``int`` result.
    Pointers and the stream must be declared ``c_void_p`` — without
    ``argtypes`` ctypes passes Python ints as 32-bit and cuts them."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for sym, argtypes in symbols.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return {sym: getattr(lib, sym) for sym in symbols}


def check_tables(kernel: str, device: torch.device, *tables: torch.Tensor
                 ) -> None:
    """Row tables must be 2-D, contiguous, on ``device``, share one dtype
    the kernel is built for (fp32 or bf16) and one width, and hold at least
    one row (a slot is clamped into ``[0, rows-1]``)."""
    first = tables[0]
    if first.dtype not in DTYPE_SUFFIX:
        raise TypeError(f"{kernel}: tables must be float32 or bfloat16, "
                        f"got {first.dtype}")
    for t in tables:
        if t.device != device or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{kernel}: tables must be contiguous 2-D "
                             f"tensors on {device}")
        if t.dtype != first.dtype or t.shape[1] != first.shape[1]:
            raise ValueError(f"{kernel}: tables must share dtype and width")
        if t.shape[0] < 1:
            raise ValueError(f"{kernel}: every table needs at least one row")


def check_addresses(kernel: str, device: torch.device, tier: torch.Tensor,
                    slot: torch.Tensor) -> None:
    """``tier``/``slot`` must be int32, contiguous, on ``device`` and of one
    shape."""
    for t in (tier, slot):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f"{kernel}: tier/slot must be contiguous int32 "
                             f"tensors on {device}")
    if tier.shape != slot.shape:
        raise ValueError(f"{kernel}: tier {tuple(tier.shape)} and slot "
                         f"{tuple(slot.shape)} differ")
