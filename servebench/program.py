"""The program's own spans and counters (``repro_torch.trace``) in a run
of one cell, and the per-layer readings taken from them.

    python3 servebench/program.py --workload products-sage3.mixed \
        --seed 7 --seconds 51 --trace 1

runs the cell as ``servebench/run.py`` runs it, with the program's tracer
on over the measured window only (after calibration and warm-up), and
prints run.py's result line with two additions: the metrics of
``servebench/program_metrics.json`` that the cell reports, read by their
``servebench/metrics/<name>.py``, and ``program_idle_gaps``, the device's
idle time named by the program's spans (and ``end_to_end_traced``, the
window's end-to-end metric, which a traced line leaves out). ``--trace
0`` runs untraced (no profiler, no patched spans) with only the
program's tracer on: its end-to-end metrics beside ``run.py --trace 0``'s
on the same seed are the tracer's cost end to end.

The readers see ``ctx["program"]``, a :class:`Program`. run.py does not
call this module; its traced path and ``BENCHMARK.json`` take these
metrics over as they stand.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from servebench import loops, run, trace  # noqa: E402

NO_BATCH = "no_batch_in_flight"
IN_FLIGHT = ("lane_wait", "lane")


class Program:
    """The program's spans that started in the window ``[lo_s, hi_s]``
    (perf_counter seconds), its counters, and the device's idle seconds
    by program span (``gaps``; ``None`` without a device trace)."""

    def __init__(self, records: dict, lo_s: float, hi_s: float,
                 gaps=None):
        self.records, self.window = records, (lo_s, hi_s)
        lo, hi = lo_s * 1e9, hi_s * 1e9
        self.spans = [s for s in records["spans"] if lo <= s.t0 <= hi]
        self.counts = records["counts"]
        self.gaps = gaps

    def named(self, name: str, **attrs) -> list:
        return [s for s in self.spans if s.name == name
                and all(s.attrs.get(k) == v for k, v in attrs.items())]

    def span_ms(self, name: str, **attrs) -> list:
        return [(s.t1 - s.t0) * 1e-6 for s in self.named(name, **attrs)]

    def per_call_ms(self, calls: tuple, parts: tuple, **attrs) -> list:
        """For each span named in ``calls`` (with ``attrs``), the
        milliseconds that spans named in ``parts`` cover inside it on its
        thread (their union)."""
        by_tid: dict = {}
        for s in self.spans:
            if s.name in parts:
                by_tid.setdefault(s.tid, []).append(s)
        starts = {t: [s.t0 for s in v] for t, v in by_tid.items()}
        out = []
        for c in self.spans:
            if c.name not in calls or any(c.attrs.get(k) != v
                                          for k, v in attrs.items()):
                continue
            inner = by_tid.get(c.tid, [])
            i = bisect.bisect_left(starts.get(c.tid, []), c.t0)
            ivs = []
            while i < len(inner) and inner[i].t0 <= c.t1:
                ivs.append((inner[i].t0, min(inner[i].t1, c.t1)))
                i += 1
            out.append(sum(e - s for s, e in trace.union(ivs)) * 1e-6)
        return out


def device_gaps(events: list, mark_host: float, t0_host: float,
                t1_host: float) -> tuple:
    """``(offset_us, [(start, end)])``: the device trace's offset from
    perf_counter microseconds, and the idle intervals of the window in
    the trace's microseconds, as ``trace.reduce_trace`` finds them."""
    marks = [ts for cat, name, ts, _ in events
             if cat == "kernel" and trace.DeviceTrace.MARK in name]
    if not marks:
        raise RuntimeError("the device trace holds no marker kernel")
    offset_us = min(marks) - mark_host * 1e6
    lo, hi = t0_host * 1e6 + offset_us, t1_host * 1e6 + offset_us
    busy = trace.union([(max(ts, lo), min(ts + dur, hi))
                        for _, name, ts, dur in events
                        if min(ts + dur, hi) > max(ts, lo)
                        and trace.DeviceTrace.MARK not in name])
    gaps, prev = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    return offset_us, gaps


def gap_seconds(gaps: list, offset_us: float, spans: list) -> dict:
    """Idle seconds by the program's spans open at each gap's midpoint:
    the sorted innermost span of every thread (a waiting batch counts as
    ``lane_wait``), or ``no_batch_in_flight`` outside every ``lane_wait``
    and ``lane``."""
    spans = [s for s in spans if s.t1 > s.t0]
    bounds = sorted([(s.t0 * 1e-3 + offset_us, 1, i)
                     for i, s in enumerate(spans)]
                    + [(s.t1 * 1e-3 + offset_us, 0, i)
                       for i, s in enumerate(spans)])
    stacks: dict = {}           # tid -> open spans, innermost last
    waiting = in_flight = 0
    out: dict = {}
    bi = 0
    for s, e in gaps:
        mid = 0.5 * (s + e)
        while bi < len(bounds) and bounds[bi][0] <= mid:
            _, opens, i = bounds[bi]
            bi += 1
            sp = spans[i]
            step = 1 if opens else -1
            in_flight += step if sp.name in IN_FLIGHT else 0
            if sp.name == "lane_wait":
                waiting += step
            elif opens:
                stacks.setdefault(sp.tid, []).append(i)
            else:
                stacks[sp.tid].remove(i)
        if in_flight <= 0:
            key = NO_BATCH
        else:
            names = {spans[st[-1]].name for st in stacks.values() if st}
            if waiting > 0:
                names.add("lane_wait")
            key = "+".join(sorted(names))
        out[key] = out.get(key, 0.0) + (e - s) * 1e-6
    return out


def program_gaps(events: list, mark_host: float, t0_host: float,
                 t1_host: float, spans: list) -> dict:
    """The device trace's idle seconds in the window, by the program's
    spans (:func:`gap_seconds`)."""
    offset_us, gaps = device_gaps(events, mark_host, t0_host, t1_host)
    return gap_seconds(gaps, offset_us, spans)


def top(by_key: dict) -> list:
    """The ten largest ``[key, seconds]``, in the shape of
    ``reduce_trace``'s ``idle_gaps``."""
    return [[k, v] for k, v in
            sorted(by_key.items(), key=lambda kv: -kv[1])[:10]]


def metrics_of(name: str, bench_dir: Path = BENCH_DIR) -> list:
    """The entries of ``program_metrics.json`` that cell ``name``
    reports."""
    entries = run.load_json(bench_dir / "program_metrics.json")
    return [m for m in entries if name in m["workloads"]]


def traced_cell(bench: dict, name: str, seed: int, seconds: float,
                traced: bool, *, device: torch.device,
                bench_dir: Path = BENCH_DIR,
                t_start: float = T_START) -> tuple:
    """``run.run_cell`` with the program's tracer on over the window;
    returns ``(line, rows, Program)``, the line with this module's
    additions."""
    from repro_torch import trace as ptrace

    got: dict = {}
    drive, reduce_trace = run.drive, trace.reduce_trace

    def traced_drive(prep, traffic, seconds, seed):
        gap = time.perf_counter() - time.monotonic()
        ptrace.take()
        ptrace.enable()
        try:
            res = drive(prep, traffic, seconds, seed)
        finally:
            ptrace.disable()
            got["records"] = ptrace.take()
        got["window"] = (res.t0 + gap, res.t_end + gap)
        if traffic["loop"] == "open":
            lat = loops.latencies_ms(res)
            got["e2e"] = {"p50_ms": float(np.quantile(
                np.where(np.isfinite(lat), lat, 1e9), 0.5))}
        else:
            got["e2e"] = {"seeds_per_s": loops.seeds_completed(res)
                          / (res.t_end - res.t0)}
        return res

    def named_gaps(events, mark_host, t0, t1, spans):
        got["gaps"] = program_gaps(events, mark_host, t0, t1,
                                   got["records"]["spans"])
        return reduce_trace(events, mark_host, t0, t1, spans)

    run.drive, trace.reduce_trace = traced_drive, named_gaps
    try:
        line, rows = run.run_cell(bench, name, seed, seconds, traced,
                                  device=device, bench_dir=bench_dir,
                                  t_start=t_start)
    finally:
        run.drive, trace.reduce_trace = drive, reduce_trace
    prog = Program(got["records"], *got["window"], gaps=got.get("gaps"))
    ctx = {"program": prog}
    for m in metrics_of(name, bench_dir):
        value = run.reader(bench_dir, m["name"])(ctx)
        if value is not None:
            line["metrics"][m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
    checks = line.pop("checks")
    if traced:
        # the end-to-end metric of the window, which a traced line omits
        line["end_to_end_traced"] = got["e2e"]
    if prog.gaps is not None:
        line["program_idle_gaps"] = top(prog.gaps)
    line["checks"] = checks
    return line, rows, prog


def span_cost_ns(n: int = 200_000) -> dict:
    """Host nanoseconds a span costs, off and on (on: with and without
    the thread's CPU clock), the median of five rounds of ``n``."""
    from repro_torch import trace as ptrace

    def per_span(**kw) -> float:
        t = time.perf_counter_ns()
        for _ in range(n):
            with ptrace.span("x", **kw):
                pass
        return (time.perf_counter_ns() - t) / n

    out = {}
    for state, kws in (("off", ({},)), ("on", ({}, {"cpu": True}))):
        (ptrace.enable if state == "on" else ptrace.disable)()
        for kw in kws:
            key = state + ("_cpu" if kw else "")
            out[key] = statistics.median(per_span(**kw) for _ in range(5))
            ptrace.take()
    ptrace.disable()
    return out


def report(prog: Program) -> None:
    """What the line leaves out, on standard error: every idle-gap key,
    the garbage collections by generation, and each lane's median time in
    each stage by executor."""
    if prog.gaps is not None:
        print("program gaps (s): " + json.dumps(dict(
            sorted(prog.gaps.items(), key=lambda kv: -kv[1]))),
            file=sys.stderr)
    by_gen: dict = {}
    for s in prog.named("gc"):
        by_gen.setdefault(s.attrs["generation"], []).append(
            (s.t1 - s.t0) * 1e-6)
    print("gc (count, total ms, max ms) by generation: " + json.dumps(
        {g: [len(d), sum(d), max(d)] for g, d in sorted(by_gen.items())}),
        file=sys.stderr)
    stages = ("host_sample", "hops_to_device", "device_sample",
              "lookup_hops", "lookup_aggregate", "dedup", "ids_to_host",
              "resolve", "plan_to_device", "gather", "host_fetch", "model",
              "sync", "gc")
    lanes = {}
    for ex in sorted({s.attrs["executor"] for s in prog.named("lane")}):
        lanes[ex] = {"lane": statistics.median(
            prog.span_ms("lane", executor=ex))}
        for st in stages:
            d = prog.per_call_ms(("lane",), (st,), executor=ex)
            if any(d):
                lanes[ex][st] = statistics.median(d)
    print("lane median ms by stage: " + json.dumps(lanes), file=sys.stderr)



def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="servebench/program.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("servebench/program.py: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    line, _, prog = traced_cell(run.load_json(ROOT / "BENCHMARK.json"),
                                args.workload, args.seed, args.seconds,
                                bool(args.trace),
                                device=torch.device("cuda", 0))
    report(prog)
    print("span cost (ns): " + json.dumps(span_cost_ns()), file=sys.stderr)
    bad = run.forbidden_modules()
    if bad:
        print(f"servebench/program.py: the run loaded {bad}",
              file=sys.stderr)
        return 2
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
