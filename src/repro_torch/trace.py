"""The port's tracer: spans and counters recorded where the serving path
does its work, kept in memory until :func:`take` (README: "Tracing the
serving path").

A :class:`Span` holds its name, the thread's id, its start and end from
``time.perf_counter_ns()`` (the clock a ``torch.profiler`` trace is tied
to by a marker kernel, so one offset maps spans onto the device's
timeline) and its attributes; opened with ``cpu=True`` it also holds the
thread's CPU time over it (``cpu_ns``), so that time off the CPU (the
interpreter lock, a sleep, a blocking call) can be read. While enabled,
each garbage collection is a ``gc`` span.

Each thread appends to its own buffer and ``take()`` merges them: no lock
shared between threads on the hot path. Off, the default, :func:`span`
returns one shared null context and reads no clock; call sites test
:data:`on` before computing what only a counter or attribute needs. No
span synchronizes the device: around a launch, it times the launch.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
from typing import NamedTuple, Optional

on = False

_local = threading.local()
_lock = threading.RLock()       # the list of buffers; a gc span may nest
_buffers: list = []
_batch_ids = itertools.count()


class Span(NamedTuple):
    name: str
    tid: int
    t0: int                     # perf_counter_ns
    t1: int
    attrs: dict


class _Buffer:
    __slots__ = ("thread", "tid", "spans", "counts", "open")

    def __init__(self):
        self.thread = threading.current_thread()
        self.tid = threading.get_ident()
        self.spans: list = []
        self.counts: list = []  # (name, n)
        self.open: list = []    # attributes of the open spans, innermost last


def _buf() -> _Buffer:
    try:
        return _local.buf
    except AttributeError:
        b = _local.buf = _Buffer()
        with _lock:
            _buffers.append(b)
        return b


_NULL = contextlib.nullcontext()


class _Open:
    __slots__ = ("name", "attrs", "cpu", "buf", "t0", "c0")

    def __init__(self, name: str, attrs: dict, cpu: bool):
        self.name, self.attrs, self.cpu = name, attrs, cpu

    def __enter__(self):
        self.buf = _buf()
        self.buf.open.append(self.attrs)
        if self.cpu:
            self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self.attrs

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.cpu:
            self.attrs["cpu_ns"] = time.thread_time_ns() - self.c0
        self.buf.open.pop()
        self.buf.spans.append(Span(self.name, self.buf.tid, self.t0, t1,
                                   self.attrs))
        return False


def span(name: str, *, cpu: bool = False, **attrs):
    """A context manager recording ``name`` over its body (with the
    thread's CPU time if ``cpu``); the shared null context while off."""
    if not on:
        return _NULL
    return _Open(name, attrs, cpu)


def record(name: str, t0_ns: int, **attrs) -> None:
    """A span that began at ``t0_ns`` (read elsewhere, maybe on another
    thread) and ends now, on this thread."""
    if on:
        b = _buf()
        b.spans.append(Span(name, b.tid, t0_ns, time.perf_counter_ns(),
                            attrs))


def note(**attrs) -> None:
    """Add attributes to this thread's innermost open span, if any."""
    if on:
        b = _buf()
        if b.open:
            b.open[-1].update(attrs)


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name``: an int, or a 0-d tensor read by
    :func:`take` (a count of device data, with no synchronize here)."""
    if on:
        _buf().counts.append((name, n))


def new_batch() -> int:
    """A fresh batch id, which :func:`batch` returns on this thread until
    the next one: the engine draws it as it routes a batch, the executor
    reads it as it hands the batch to a lane."""
    _local.batch = b = next(_batch_ids)
    return b


def batch() -> Optional[int]:
    """This thread's latest :func:`new_batch` id."""
    return getattr(_local, "batch", None)


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _local.gc_t0 = time.perf_counter_ns()
    elif getattr(_local, "gc_t0", None) is not None:
        record("gc", _local.gc_t0, generation=info["generation"])
        _local.gc_t0 = None


def enable() -> None:
    """Start recording (and timing garbage collections)."""
    global on
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    on = True


def disable() -> None:
    """Stop recording; what was recorded waits for :func:`take`."""
    global on
    on = False
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def take() -> dict:
    """``{"spans": [Span] by start, "counts": {name: total}}`` recorded
    since the last call, from every thread; clears them."""
    spans, counts = [], {}
    with _lock:
        for b in list(_buffers):
            # copy then cut the copied head: an append in between survives
            s, c = b.spans[:], b.counts[:]
            del b.spans[:len(s)], b.counts[:len(c)]
            spans += s
            for name, n in c:
                counts[name] = counts.get(name, 0) + int(n)
            if not b.thread.is_alive():
                _buffers.remove(b)
    spans.sort(key=lambda sp: sp.t0)
    return {"spans": spans, "counts": counts}
