"""The ports of the reference's serving examples (``launch/quickstart.py``
and ``launch/serve_quiver.py``) against the scripts themselves
(``examples/quickstart.py`` and ``examples/serve_quiver.py``), both on the
CPU from the same seeds: the outputs that read no clock are equal.

Those are the graph, the PSGS statistics and the placement's tier counts
the scripts print, every request of the generated stream (id, seeds,
model, class and deadline) with its outcome (completed or shed), and, in
the quickstart, whose hybrid scheduler routes by PSGS alone, the routing,
the executors' batch counts and the store's counters. Under
``serve_quiver`` routing follows calibrated timings and batching a
deadline, so those are left out. Nothing in ``examples/`` changes: each
script runs through ``runpy`` with its argv, and the streams are recorded
by wrapping ``WorkloadGenerator.stream`` in both packages."""
import ast
import json
import runpy
import sys
from pathlib import Path

import pytest
import torch

from repro.core.serving import WorkloadGenerator as RefGenerator
from repro_torch.core.serving import WorkloadGenerator as PortGenerator

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
QUIVER_ARGV = ["--requests", "12", "--nodes", "1500"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the graphs are small, and the suite's parallel
    workers would otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def streams(monkeypatch):
    """Every request each package's ``WorkloadGenerator.stream`` yields, by
    package; read after the run, so each carries its outcome."""
    seen = {"ref": [], "port": []}
    for key, cls in (("ref", RefGenerator), ("port", PortGenerator)):
        def stream(self, *a, _orig=cls.stream, _out=seen[key], **kw):
            for req in _orig(self, *a, **kw):
                _out.append(req)
                yield req
        monkeypatch.setattr(cls, "stream", stream)
    return seen


def _requests(reqs) -> list[tuple]:
    return [(r.req_id, r.seeds.tolist(), r.model, r.priority, r.deadline_s,
             r.outcome) for r in reqs]


def _script(monkeypatch, capsys, name: str, argv=()) -> str:
    """Run ``examples/<name>.py`` as ``__main__``; returns its stdout."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


def _printed(out: str) -> dict:
    """The ``key: value`` lines a script printed (the quickstart's
    summary, its ``placement tiers``), values parsed as literals where
    they are; ``graph`` and ``PSGS`` lines as printed."""
    lines = {}
    for line in out.splitlines():
        if line.startswith(("graph:", "PSGS:")):
            lines[line.split(":")[0]] = line
            continue
        key, sep, value = line.strip().partition(": ")
        if sep:
            try:
                lines[key] = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                lines[key] = value
    return lines


def _report(out: str) -> tuple[str, dict]:
    """``serve_quiver``'s ``[stack]`` line (``None`` under
    ``--multi-model``, which prints none) and its JSON report."""
    lines = out.splitlines()
    stack = next((l for l in lines if l.startswith("[stack]")), None)
    start = next(i for i, l in enumerate(lines) if l.startswith("{"))
    return stack, json.loads("\n".join(lines[start:]))


def _partition(summary: dict) -> dict:
    """The request counts of a serving summary: served, shed and by class
    and model."""
    return {"requests": summary["requests"], "shed": summary["shed"],
            "shed_deadline": summary["shed_deadline"],
            "classes": {c: {k: v[k] for k in ("requests", "shed_window",
                                               "shed_deadline")}
                        for c, v in summary["classes"].items()},
            "models": {m: {k: v[k] for k in ("requests", "shed",
                                             "shed_deadline")}
                       for m, v in summary["models"].items()}}


def test_quickstart_matches_the_reference_script(monkeypatch, capsys,
                                                 streams):
    from repro_torch.launch import quickstart
    want = _printed(_script(monkeypatch, capsys, "quickstart"))
    summary = quickstart.run("cpu")
    got = _printed(capsys.readouterr().out)
    for key in ("graph", "PSGS", "placement tiers"):
        assert got[key] == want[key], key
    assert _partition(summary) == _partition(want)
    for key in ("routed", "routed_host", "routed_device", "store"):
        assert summary[key] == want[key], key
    assert ({n: e["batches"] for n, e in summary["executors"].items()}
            == {n: e["batches"] for n, e in want["executors"].items()})
    assert len(streams["port"]) == 30
    assert _requests(streams["port"]) == _requests(streams["ref"])
    assert {r.outcome for r in streams["port"]} == {"completed"}


@pytest.mark.parametrize("flags", [[], ["--multi-model"]],
                         ids=["policies", "multi_model"])
def test_serve_quiver_matches_the_reference_script(monkeypatch, capsys,
                                                   streams, flags):
    """Both policies' runs (a stream each), or both models on one
    interleaved stream: the same tiers, the same requests and the same
    partition into completed and shed."""
    from repro_torch.launch import serve_quiver
    ref_stack, want = _report(_script(monkeypatch, capsys, "serve_quiver",
                                      QUIVER_ARGV + flags))
    serve_quiver.main(["--device", "cpu", *QUIVER_ARGV, *flags])
    port_stack, got = _report(capsys.readouterr().out)
    assert port_stack == ref_stack
    assert (ref_stack is None) == bool(flags)
    if flags:
        assert set(got["cutpoints"]) == set(want["cutpoints"]) == {"base",
                                                                   "wide"}
        assert _partition(got) == _partition(want)
    else:
        assert set(got) == set(want) == {"latency_preferred",
                                         "throughput_preferred"}
        for policy in want:
            assert _partition(got[policy]) == _partition(want[policy])
    assert len(streams["port"]) == 12 * (1 if flags else 2)
    assert _requests(streams["port"]) == _requests(streams["ref"])
