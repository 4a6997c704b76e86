"""The port's serving benchmarks (``repro_torch.bench``) against the
reference's (``benchmarks/``), both on the CPU at the reference's CI sizes
(``dry_run=True``): the same row names in the same order, and the rows
that read no clock equal — dispatch counts and modeled bytes, host-fetch,
hit and miss counts where the seeds fix them, the gateway's outcome
counts and its stream. Rows that read a clock are only checked to be
finite (or, for a PSGS cut-point, a number) and positive; no assertion
here compares two timings. The adaptive modules (``flash_crowd``,
``multi_model``, ``workload_drift``) are in
``test_torch_serving_adaptation.py`` and ``sharded_hierarchy`` in
``test_torch_sharded_hierarchy.py``, to keep each file short.

Nothing in ``benchmarks/`` changes: in both packages ``timeit`` is
replaced by one call of the timed function and a constant time, the
stacks and the gateway's stream are recorded by wrapping the names the
modules import, and ``gateway_soak``'s two interactive p99s (the only
timing the modules assert on) are stubbed to a FIFO-above-gateway pair
on the CPU: the card holds the measured ones (``chip_smoke.py`` phase
8b)."""
import importlib
import math

import pytest
import torch

import benchmarks.common as ref_common
from repro_torch.bench import common as port_common


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _one_call(fn, *args, repeats=5, warmup=2, device=None):
    fn(*args)
    return 1e-3


def _fields(derived: str) -> dict:
    return dict(kv.split("=", 1) for kv in derived.split(";") if "=" in kv)


def _run(monkeypatch, tmp_path, name: str, patch=None):
    """Run module ``name`` of both packages at ``dry_run=True``; returns
    ``(ref rows, port rows, ref result, port result)``, rows by name."""
    ref = importlib.import_module(f"benchmarks.{name}")
    port = importlib.import_module(f"repro_torch.bench.{name}")
    monkeypatch.setenv("BENCH_JSON_DIR", str(tmp_path))
    for mod in (ref, port):
        if hasattr(mod, "timeit"):
            monkeypatch.setattr(mod, "timeit", _one_call)
    if patch is not None:
        patch(monkeypatch, ref, port)
    ref_common.ROWS.clear()
    port_common.ROWS.clear()
    ref_out = ref.run(dry_run=True)
    port_out = port.run(dry_run=True, device="cpu")
    ref_rows, port_rows = list(ref_common.ROWS), list(port_common.ROWS)
    ref_names = [r[0] for r in ref_rows]
    if name == "gather_aggregate":   # the autotune needs the card
        assert ref_names[-1] == "gather_aggregate/autotune_block_rows"
        ref_names = ref_names[:-1]
        assert port_out["autotune"] == "needs cuda"
    assert [r[0] for r in port_rows] == ref_names
    for _, value, _ in port_rows:
        assert not math.isnan(value)
    return ({r[0]: r for r in ref_rows}, {r[0]: r for r in port_rows},
            ref_out, port_out)


def _same(ref, port, name, keys=None):
    """Row ``name`` equal in value and derived field (or only in the
    derived ``keys``)."""
    if keys is None:
        assert port[name][1:] == ref[name][1:], name
    else:
        a, b = _fields(port[name][2]), _fields(ref[name][2])
        assert [a[k] for k in keys] == [b[k] for k in keys], (name, keys)


def _timed(port, *names):
    for name in names:
        assert math.isfinite(port[name][1]) and port[name][1] > 0, name


def test_fused_gather_matches_reference(monkeypatch, tmp_path):
    ref, port, _, out = _run(monkeypatch, tmp_path, "fused_gather")
    _same(ref, port, "fused_gather/dispatches_per_sample")
    for mode in ("per_hop", "fused"):
        _same(ref, port, f"fused_gather/{mode}_rps", ["dispatches"])
    assert out["dispatches"]["fused"] < out["dispatches"]["per_hop"]
    _timed(port, "fused_gather/collect_per_hop_us",
           "fused_gather/collect_fused_us", "fused_gather/per_hop_rps",
           "fused_gather/fused_rps", "fused_gather/fused_micro_rps",
           "fused_gather/serve_speedup_x")
    assert int(_fields(port["fused_gather/fused_micro_rps"][2])
               ["super_batches"]) >= 1
    assert (tmp_path / "BENCH_fused_gather.json").exists()


def test_gather_aggregate_matches_reference(monkeypatch, tmp_path):
    ref, port, _, out = _run(monkeypatch, tmp_path, "gather_aggregate")
    for d in (16, 64, 256):
        _same(ref, port, f"gather_aggregate/d{d}_dispatches")
        _same(ref, port, f"gather_aggregate/d{d}_deep_bytes")
        _timed(port, f"gather_aggregate/d{d}_collect_infer_us")
    _same(ref, port, "gather_aggregate/executor_bit_identical")
    for mode in ("fused", "fuse_aggregate"):
        _same(ref, port, f"gather_aggregate/{mode}_rps", ["fused_aggregates"])
    _timed(port, "gather_aggregate/serve_speedup_x")
    assert [r["bit_identical"] for r in out["sweep"]] == [True] * 3


def test_prefetch_matches_reference(monkeypatch, tmp_path):
    ref, port, _, out = _run(monkeypatch, tmp_path, "prefetch")
    _same(ref, port, "prefetch/disk_bit_identical")
    _same(ref, port, "prefetch/staged_rows")
    for mode in ("off", "on"):
        assert port[f"prefetch/{mode}_host_cb_per_req"][1] == \
            ref[f"prefetch/{mode}_host_cb_per_req"][1]
        _same(ref, port, f"prefetch/{mode}_host_cb_per_req",
              ["disk_miss_per_req"])
    _same(ref, port, "prefetch/host_cb_reduction_x")
    assert out["on"]["host_cb_per_req"] < out["off"]["host_cb_per_req"]


def _gateway_patch(streams):
    """Record each package's overload streams; stub the interactive p99s
    (FIFO's first call, then the gateway's) on the CPU."""
    def patch(monkeypatch, ref, port):
        for key, mod in (("ref", ref), ("port", port)):
            build, calls = mod.build_stream, []

            def recorded(*a, _build=build, _key=key, **kw):
                reqs = _build(*a, **kw)
                streams[_key].append([(r.req_id, r.seeds.tolist(),
                                       r.priority, r.deadline_s)
                                      for r in reqs])
                return reqs

            def percentiles(reqs, _calls=calls):
                _calls.append(1)
                p99 = 2.0 if len(_calls) == 1 else 1.0   # fifo, gateway
                return {c: {"p50_ms": p99, "p99_ms": p99}
                        for c in ("interactive", "batch")}

            monkeypatch.setattr(mod, "build_stream", recorded)
            monkeypatch.setattr(mod, "class_percentiles", percentiles)
    return patch


def test_gateway_soak_matches_reference(monkeypatch, tmp_path):
    streams = {"ref": [], "port": []}
    ref, port, ref_out, out = _run(monkeypatch, tmp_path, "gateway_soak",
                                   patch=_gateway_patch(streams))
    assert len(streams["port"]) == 2
    assert streams["port"] == streams["ref"]     # ids, seeds, classes
    for mode in ("fifo", "gateway"):
        _same(ref, port, f"gateway_soak/{mode}_interactive_p99_ms",
              ["expired_dispatches", "shed_deadline"])
        for key in ("requests", "completed", "shed_window", "shed_deadline",
                    "expired_dispatches"):
            assert out[mode][key] == ref_out[mode][key], (mode, key)
    assert out["gateway"]["expired_dispatches"] == 0
    assert out["gateway"]["completed"] + out["gateway"]["shed_window"] \
        + out["gateway"]["shed_deadline"] == out["gateway"]["requests"]


def test_gateway_soak_row_schema_is_the_reference_s():
    from benchmarks import gateway_soak as ref
    from repro_torch.bench import gateway_soak as port
    assert port.ROW_SCHEMA == ref.ROW_SCHEMA
    row = port.build_row(**{k: 0 for k in port.ROW_SCHEMA})
    assert tuple(row) == port.ROW_SCHEMA
    with pytest.raises(ValueError, match="missing"):
        port.build_row(mode="fifo")
    with pytest.raises(ValueError, match="extra"):
        port.build_row(**{k: 0 for k in port.ROW_SCHEMA}, more=1)


def test_run_takes_the_serving_modules(monkeypatch, tmp_path):
    """The runner runs a serving module on the CPU at the reference's
    sizes, ``ok``, its BENCH file where ``BENCH_JSON_DIR`` points."""
    from repro_torch.bench import run as runner
    monkeypatch.setenv("BENCH_JSON_DIR", str(tmp_path))
    status = runner.run_modules(["prefetch"], device="cpu")
    assert status["prefetch"]["status"] == "ok"
    assert status["prefetch"]["on"]["prefetch_hits"] > 0
    assert (tmp_path / "BENCH_prefetch.json").exists()


def test_quickstart_runs_on_the_cpu_and_defaults_to_the_card(capsys):
    """``launch/quickstart.py`` (the port of ``examples/quickstart.py``)
    serves its 30 requests on the CPU when asked, and on the card by
    default (which raises where there is none)."""
    from repro_torch.launch import quickstart
    summary = quickstart.main(["--device", "cpu"])
    assert summary["requests"] == 30 and summary["shed"] == 0
    assert sum(summary["routed"].values()) == 30
    assert "placement tiers:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            quickstart.run()


@pytest.mark.parametrize("flags", [[], ["--adaptive"]])
def test_serve_quiver_runs_on_the_cpu(flags):
    """``launch/serve_quiver.py`` (the port of ``examples/serve_quiver.py``)
    reports both policies, and with ``--adaptive`` each policy's run on a
    fresh stack carries its control loop's report. Its outputs are held
    against the script's in ``test_torch_examples.py``."""
    from repro_torch.launch import serve_quiver
    argv = ["--device", "cpu", "--requests", "12", "--nodes", "1500"]
    assert serve_quiver.parse_args([]).device == "cuda"
    report = serve_quiver.main(argv + flags)
    assert set(report) == {"latency_preferred", "throughput_preferred"}
    assert all(r["requests"] == 12 for r in report.values())
    assert all(("adaptation" in r) == bool(flags) for r in report.values())
    if flags:
        assert all(r["adaptation"]["batches_seen"] > 0
                   for r in report.values())
