"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one self-contained ``csrc/<name>.cu`` with a plain C
interface. It is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``build/kernels/`` at the repository root, named by a hash of its
source and flags (an edited source builds anew, an unchanged one is
reused), and loaded with ``ctypes``. Nothing is built when a module is
imported: the first launch builds, or :func:`build_all` builds every
kernel at once, one ``nvcc`` process per source, all started together.

The compiler's output (with ``-Xptxas -v``: each kernel's registers,
shared memory and spills) is kept beside the library as ``<lib>.log``.

Every exported C function launches on the stream it is given and returns
``cudaGetLastError()``; the Python wrappers raise when that is non-zero.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("tiered_gather", "gather_aggregate", "embedding_bag",
           "segment_spmm", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Hopper (H100) limits the copy plans are sized against
SMEM_PER_SM = 233472       # 228 KB of shared memory an SM
SMEM_PER_BLOCK = 232448    # 227 KB a block may ask for (dynamic)
SMEM_RESERVED = 1024       # CUDA's own share of each resident block
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32
COPY_WIDTHS = (16, 8, 4)   # the sizes cp.async copies, in bytes

_lock = threading.Lock()
_libs: dict[str, dict[str, ctypes._CFuncPtr]] = {}
_sms: dict[int, int] = {}


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


def launch_counters() -> dict[str, LaunchCounter]:
    """The five kernels' launch counters by kernel name."""
    from repro_torch.kernels import (embedding_bag, flash_attention,
                                     gather_aggregate, segment_spmm,
                                     tiered_gather)
    return {m.__name__.rsplit(".", 1)[-1]: m.LAUNCHES
            for m in (tiered_gather, gather_aggregate, embedding_bag,
                      segment_spmm, flash_attention)}


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
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler's output for ``name``'s library (built if needed)."""
    return build([name])[name].with_suffix(".log").read_text()


def ptxas_resources(log: str) -> dict[str, dict[str, int]]:
    """Per compiled kernel (mangled name) in a ``-Xptxas -v`` log: its
    ``registers``, ``stack`` frame, ``spill_stores`` and ``spill_loads``
    bytes."""
    out: dict[str, dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[fn].update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def build_all() -> dict[str, Path]:
    """Build every kernel of the port (see :data:`KERNELS`)."""
    return build(KERNELS)


def load(name: str, symbols: dict[str, list]) -> dict[str, ctypes._CFuncPtr]:
    """Build (if needed) and load ``name``'s library; return its exported
    functions with ``argtypes`` set from ``symbols`` and an ``int`` result
    (bound once: every later call returns the same dict).
    Pointers and the stream must be declared ``c_void_p`` — without
    ``argtypes`` ctypes passes Python ints as 32-bit and cuts them."""
    with _lock:
        fns = _libs.get(name)
        if fns is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            fns = {}
            for sym, argtypes in symbols.items():
                fn = fns[sym] = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = fns
    return fns


def call(device: torch.device, fn: ctypes._CFuncPtr, *args) -> int:
    """``fn(*args, stream)`` with ``device`` current and PyTorch's current
    stream on it last; the device is switched only when another one is
    current (the usual case costs one query)."""
    idx = device.index
    if torch.cuda.current_device() == idx:
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def int_bits(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bits as integers of its width (float32 as int32, bf16 as
    int16): equal bits, not equal values (-0.0 is not +0.0)."""
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device`` (asked once per device)."""
    n = _sms.get(device.index)
    if n is None:
        n = _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


class CopyPlan(NamedTuple):
    """How a gather kernel stages table rows in shared memory.

    ``chunk_bytes``: the ``cp.async`` copy width (16, 8 or 4), or 0 when
    the row's bytes or the table's address is not a multiple of 4 and the
    kernel stages rows through registers. ``ring_rows``: slots of the
    ring (per warp or per block, as the kernel says). ``smem_bytes``: the
    block's dynamic shared memory. ``rows_per_block``: lists a block works
    on at once. ``blocks_per_sm``: blocks that fit an SM at that size."""
    chunk_bytes: int
    ring_rows: int
    smem_bytes: int
    rows_per_block: int
    blocks_per_sm: int


def chunk_bytes(row_bytes: int, base_ptr: int) -> int:
    """The widest ``cp.async`` size (16, 8 or 4 bytes) that divides both a
    row's bytes and the table's address, so every row (and every 128-column
    tile of it) starts on a chunk; 0 when none does (register staging)."""
    for width in COPY_WIDTHS:
        if row_bytes % width == 0 and base_ptr % width == 0:
            return width
    return 0


class LanePlan(NamedTuple):
    """How a latency-bound gather kernel spreads rows over a warp's lanes.

    ``vec_bytes``: the width of each load and store (16, 8 or 4 bytes, or
    one element). ``row_vectors``: vectors a row. ``lanes``: lanes a row,
    the fewest (a power of two, at most 32) that cover it in one vector
    each. ``rows_per_warp``: ``32 // lanes`` rows (or segments) a warp
    takes at once. ``passes``: vectors a lane takes of each row.
    ``blocks``: the grid, every warp of it resident at once."""
    vec_bytes: int
    row_vectors: int
    lanes: int
    rows_per_warp: int
    passes: int
    blocks: int


def lane_plan(d: int, elem: int, addr: int, rows: int, sms: int,
              warps: int, min_blocks: int) -> LanePlan:
    """The plan for ``rows`` output rows (or segments) of ``d`` values of
    ``elem`` bytes, where ``addr`` is every table's and the output's
    address OR-ed together (a power of two divides each exactly when it
    divides the OR). A warp takes ``rows_per_warp`` rows at once; blocks
    of ``warps`` warps, at most ``min_blocks`` an SM on ``sms`` SMs (what
    the kernel's ``__launch_bounds__`` keeps resident); more rows go
    grid-stride."""
    vec, nvec, lanes, per_warp, passes = _lane_widths(d, elem, addr % 16)
    units = -(-rows // per_warp)
    blocks = max(1, min(-(-units // warps), sms * min_blocks))
    return LanePlan(vec, nvec, lanes, per_warp, passes, blocks)


@functools.lru_cache(maxsize=1024)
def _lane_widths(d: int, elem: int, align: int) -> tuple[int, ...]:
    """:func:`lane_plan`'s widths, which depend on the address only modulo
    16 (asked once per shape: it runs on every kernel call)."""
    vec = chunk_bytes(d * elem, align) or elem
    nvec = d * elem // vec
    lanes = min(32, 1 << (nvec - 1).bit_length())
    return vec, nvec, lanes, 32 // lanes, -(-nvec // lanes)


def blocks_per_sm(smem_bytes: int, threads: int) -> int:
    """Blocks of ``threads`` threads and ``smem_bytes`` of dynamic shared
    memory that fit one SM at once by those two limits (0 if one does not
    fit); registers may allow fewer, which the kernels ask CUDA about."""
    if smem_bytes > SMEM_PER_BLOCK:
        return 0
    return min(SMEM_PER_SM // (smem_bytes + SMEM_RESERVED),
               THREADS_PER_SM // threads, BLOCKS_PER_SM)


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
