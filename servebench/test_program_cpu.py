"""CPU tests of ``servebench/program.py``: the traced tiny cells report the
program's host-side metrics, the program's spans match the benchmark's
patched spans one for one, and the device's idle gaps are named by the
program's spans as worked out by hand.

    PYTHONPATH=src python -m pytest -q servebench/test_program_cpu.py
"""
from __future__ import annotations

import json

import pytest

from servebench import program, trace
from servebench.test_servebench_cpu import CPU, SEED, tiny  # noqa: F401
from repro_torch.trace import Span

CELL = {"products-sage3.mixed": "tiny.mixed",
        "reddit-sage2.bulk": "tiny.bulk",
        "products-sage3.bulk": "tiny.bulk"}
PATCHED = ("host_sample", "device_sample", "lookup_hops",
           "lookup_aggregate", "model", "route", "host_fetch")


@pytest.fixture
def tiny_program(tiny):  # noqa: F811
    """The tiny cells, each reporting the program metrics of the cells it
    stands for."""
    bench, bench_dir = tiny
    entries = json.loads((program.BENCH_DIR
                          / "program_metrics.json").read_text())
    for m in entries:
        m["workloads"] = sorted({CELL[w] for w in m["workloads"]})
    (bench_dir / "program_metrics.json").write_text(json.dumps(entries))
    return bench, bench_dir


def _traced(tiny_program, cell):
    bench, bench_dir = tiny_program
    return program.traced_cell(bench, cell, SEED, 1.0, True, device=CPU,
                               bench_dir=bench_dir)


@pytest.mark.parametrize("cell, want, may", [
    ("tiny.mixed", {"lane_offcpu_share", "route_error_pct",
                    "gather_valid_share"},
     {"lane_wait_ms.host", "lane_wait_ms.device", "gc_pause_max_ms"}),
    ("tiny.bulk", {"collect_host_ms", "collect_wait_ms"}, set())])
def test_traced_tiny_cells_report_the_program_metrics(tiny_program, cell,
                                                      want, may):
    line, _, prog = _traced(tiny_program, cell)
    assert line["correct"] is True, line["checks"]
    got = {m for m in line["metrics"]
           if m in {e["name"] for e in program.metrics_of(
               cell, tiny_program[1])}}
    assert want <= got <= want | may
    if cell == "tiny.mixed":
        assert got & {"lane_wait_ms.host", "lane_wait_ms.device"}
        assert 0 < line["metrics"]["gather_valid_share"]["value"] <= 100
    assert all(line["metrics"][m]["value"] >= 0 for m in got)
    # no device trace on the CPU: nothing names the idle gaps
    assert "program_idle_gaps" not in line and prog.gaps is None
    assert list(line)[-1] == "checks"
    assert line["end_to_end_traced"]


@pytest.mark.parametrize("cell", ["tiny.mixed", "tiny.bulk"])
def test_program_spans_match_the_patched_spans(tiny_program, cell,
                                               monkeypatch):
    opened = []
    enter = trace.Spans.__enter__

    def keep(self):
        opened.append(self)
        return enter(self)

    monkeypatch.setattr(trace.Spans, "__enter__", keep)
    _, _, prog = _traced(tiny_program, cell)
    (patched,) = opened
    counts = {}
    for s in prog.records["spans"]:
        counts[s.name] = counts.get(s.name, 0) + 1
    for name in PATCHED:
        assert counts.get(name, 0) == sum(
            n == name for n, _, _ in patched.spans), name
    assert counts.get("route", 0) > 0


def _span(name, tid, t0_s, t1_s, **attrs):
    return Span(name, tid, round(t0_s * 1e9), round(t1_s * 1e9), attrs)


def test_program_gaps_on_synthetic_events():
    """Marker at 1,000 µs on the device, stamped at 1.0 s on the host; a
    window of 1.0-1.1 s; busy 11-21, 41-61 and 64-70 ms past the marker
    (the last a copy)."""
    events = [("kernel", "spin_kernel", 1000.0, 1000.0),
              ("kernel", "k1", 11000.0, 10000.0),
              ("kernel", "k2", 41000.0, 20000.0),
              ("gpu_memcpy", "Memcpy HtoD", 64000.0, 6000.0)]
    spans = [_span("lane_wait", 1, 1.002, 1.004),
             _span("lane", 1, 1.004, 1.070),
             _span("host_sample", 1, 1.004, 1.010),
             _span("lookup_hops", 1, 1.025, 1.050),
             _span("resolve", 1, 1.028, 1.035),
             _span("host_fetch", 1, 1.029, 1.040),
             _span("admit", 2, 1.029, 1.031),
             _span("lane_wait", 3, 1.061, 1.066)]
    offset_us, gaps = program.device_gaps(events, 1.0, 1.0, 1.1)
    assert offset_us == pytest.approx(1000.0 - 1e6)
    by_key = program.gap_seconds(gaps, offset_us, spans)
    want = {"host_sample": 0.010,           # 1-11 ms
            "admit+host_fetch": 0.020,      # 21-41 ms
            "lane+lane_wait": 0.003,        # 61-64 ms
            "no_batch_in_flight": 0.031}    # 70-101 ms
    assert by_key == pytest.approx(want)
    assert sum(by_key.values()) == pytest.approx(0.1 - 0.036)
    assert program.program_gaps(events, 1.0, 1.0, 1.1, spans) == by_key
    assert program.top(by_key) == [[k, pytest.approx(v)] for k, v in
                                   sorted(want.items(), key=lambda kv: -kv[1])]
    # a call's host work: resolve and the fetch nested in it, counted once
    prog = program.Program({"spans": spans, "counts": {}}, 1.0, 1.1)
    assert prog.per_call_ms(("lookup_hops",), ("resolve", "host_fetch")) \
        == pytest.approx([12.0])
