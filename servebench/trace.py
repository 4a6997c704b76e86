"""What a ``--trace 1`` run records, and its reduction.

* :class:`Spans`: host-clock spans of named calls into the program,
  patched on their owners while the context is open (every thread's calls
  count). A copy of ``chip_smoke.py``'s ``HostTimer`` that also keeps each
  call's start and end, so idle gaps on the device can be named by what
  the host was in.
* :class:`Launches`: the arguments of the first launches of a kernel
  wrapper, as the feature store calls it, for the roofline bound.
* :func:`device_trace`: ``torch.profiler`` over the window (CUDA activity
  only), reduced to the union of kernel and copy intervals, the top
  device operations and the idle gaps by host span.
"""
from __future__ import annotations

import gc
import json
import os
import tempfile
import threading
import time
from typing import Optional

import torch


class Spans:
    """Host-clock spans of ``(owner, attribute, name)`` targets."""

    def __init__(self, targets):
        self.targets = list(targets)
        self.spans: list = []          # (name, start, end), perf_counter
        self._lock = threading.Lock()
        self._saved: list = []

    def _timed(self, name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                t1 = time.perf_counter()
                with self._lock:
                    self.spans.append((name, t0, t1))
        return call

    def __enter__(self):
        for owner, attr, name in self.targets:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    def durations_ms(self, name: str, lo: float, hi: float) -> list:
        """Durations of ``name``'s spans that started in ``[lo, hi]``."""
        with self._lock:
            return [(e - s) * 1e3 for n, s, e in self.spans
                    if n == name and lo <= s <= hi]


class Launches:
    """Keeps the arguments of the first ``limit`` calls of a kernel
    wrapper (the tensors themselves, no copy)."""

    def __init__(self, owner, attr: str, limit: int = 400):
        self.owner, self.attr, self.limit = owner, attr, limit
        self.args: list = []
        self._lock = threading.Lock()
        self._fn = None

    def __enter__(self):
        self._fn = fn = getattr(self.owner, self.attr)

        def call(*a):
            with self._lock:
                if len(self.args) < self.limit:
                    self.args.append(a)
            return fn(*a)

        setattr(self.owner, self.attr, call)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self._fn)


class DeviceTrace:
    """``torch.profiler`` with CUDA activity over the window. A
    ``torch.cuda._sleep`` launched on an idle device at the window's start
    ties the trace's clock to the host's."""

    MARK = "spin_kernel"

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.mark_host: Optional[float] = None

    def start(self) -> None:
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.mark_host = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self) -> list:
        """Stop and return the device events ``(cat, name, ts_us,
        dur_us)``."""
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        out = [(e.get("cat", ""), e.get("name", ""), float(e["ts"]),
                float(e.get("dur", 0.0))) for e in events
               if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset")]
        del events
        gc.collect()
        return out


def union(intervals: list) -> list:
    """Merged ``[(start, end)]`` of possibly overlapping intervals."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce_trace(events: list, mark_host: float, t0_host: float,
                 t1_host: float, spans: Optional[Spans]) -> dict:
    """Busy and window seconds, the top device operations and the idle
    gaps by host span, over the window ``[t0_host, t1_host]``
    (perf_counter seconds)."""
    marks = [ts for cat, name, ts, _ in events
             if cat == "kernel" and DeviceTrace.MARK in name]
    if not marks:
        raise RuntimeError("the device trace holds no marker kernel")
    offset_us = min(marks) - mark_host * 1e6
    lo, hi = t0_host * 1e6 + offset_us, t1_host * 1e6 + offset_us
    kept = []
    for cat, name, ts, dur in events:
        s, e = max(ts, lo), min(ts + dur, hi)
        if e > s and DeviceTrace.MARK not in name:
            kept.append((cat, name, ts, dur, s, e))
    busy = union([(s, e) for *_, s, e in kept])
    busy_us = sum(e - s for s, e in busy)
    by_op: dict = {}
    for cat, name, _, _, s, e in kept:
        key = name if cat == "kernel" else cat
        by_op[key] = by_op.get(key, 0.0) + (e - s) * 1e-6
    gaps, prev = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    # sweep the gaps (in time order) against the spans' starts and ends
    by_gap: dict = {}
    bounds = [] if spans is None else sorted(
        [(s * 1e6 + offset_us, 1, n) for n, s, _ in spans.spans]
        + [(e * 1e6 + offset_us, -1, n) for n, _, e in spans.spans])
    active: dict = {}
    bi = 0
    for s, e in gaps:
        mid = 0.5 * (s + e)
        while bi < len(bounds) and bounds[bi][0] <= mid:
            _, step, name = bounds[bi]
            active[name] = active.get(name, 0) + step
            bi += 1
        names = sorted(n for n, c in active.items() if c > 0)
        key = "+".join(names) if names else "outside_spans"
        by_gap[key] = by_gap.get(key, 0.0) + (e - s) * 1e-6
    top = (lambda d: [[k, v] for k, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:10]])
    return {"busy_s": busy_us * 1e-6, "window_s": (hi - lo) * 1e-6,
            "kernels": [(name, ts, dur) for cat, name, ts, dur, _, _ in kept
                        if cat == "kernel"],
            "device_ops": top(by_op), "idle_gaps": top(by_gap)}
