"""The kernels' branch for fake tensors.

The dry-run (:mod:`repro_torch.launch.dryrun`) runs a cell on
``torch._subclasses.fake_tensor.FakeTensor``s: shapes and dtypes, no
data. A kernel wrapper handed one takes this branch before its device
test: it returns an empty output of the kernel's shape and dtype, and adds
the kernel's own operations and bytes (``ref.cost`` beside each plain
version, the formulas ``chip_smoke.py``'s bound column uses) to every
:class:`KernelCounter` opened with :func:`counting`. The plain version
never runs on fake tensors: it would count its own loops (the causal
flash plain version walks the whole ``S²`` square, twice the kernel's
work), and its data-dependent steps (``nonzero``, ``.item()``) raise there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor

# the counters open in this process: a backward runs on the autograd
# engine's own thread on the card, so a call records into them from any
# thread (a context variable would not reach that thread)
_OPEN: list = []
_LOCK = threading.Lock()


@dataclasses.dataclass
class KernelCounter:
    """Operations, bytes and calls of the kernels' fake branches, by
    kernel name."""

    flops: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)
    calls: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, cost: dict) -> None:
        self.flops[name] = self.flops.get(name, 0) + cost["flops"]
        self.bytes[name] = self.bytes.get(name, 0) + cost["bytes"]
        self.calls[name] = self.calls.get(name, 0) + 1

    @property
    def total_flops(self) -> int:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())


@contextlib.contextmanager
def counting(counter: KernelCounter):
    """Open ``counter`` for the kernels' fake branches inside the block,
    for calls from every thread (counters nest; each open one receives
    every call)."""
    with _LOCK:
        _OPEN.append(counter)
    try:
        yield counter
    finally:
        with _LOCK:
            _OPEN.remove(counter)


def faking() -> bool:
    """Whether a ``FakeTensorMode`` is active: tensors made now are fake
    and must not be cached past the mode."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def is_fake(*tensors) -> bool:
    """Whether any of ``tensors`` (None allowed) is a fake tensor."""
    return any(isinstance(t, FakeTensor) for t in tensors)


def record(name: str, cost: dict) -> None:
    """Add one call of kernel ``name`` with ``cost`` (``{"flops",
    "bytes"}``) to every open counter."""
    with _LOCK:
        for counter in _OPEN:
            counter.add(name, cost)


def fake_call(name: str, cost: dict, like: torch.Tensor, shape,
              dtype: torch.dtype) -> torch.Tensor:
    """The fake branch: record ``cost`` and return an empty ``shape`` of
    ``dtype`` on ``like``'s device (a fake tensor of ``like``'s mode)."""
    record(name, cost)
    return like.new_empty(tuple(shape), dtype=dtype)
