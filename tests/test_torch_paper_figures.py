"""The port's eight paper-figure modules (``repro_torch.bench``) against the
reference's (``benchmarks/``), both on the CPU at one small size: the
same row names in the same order, and the rows that do not depend on a
clock equal.

The reference is shrunk only by wrapping the names its module imports
from ``benchmarks.common`` (``build_serving_stack`` gets the small node
count); nothing in ``benchmarks/`` changes. In both packages ``timeit``
is replaced by one call of the timed function and a constant time: the
rows compared here do not read the clock, and a CPU's timings say
nothing of the card's. That also makes ``skew_robustness``' assertion
(the routed executor within 1.5× of the better one) hold trivially here:
on the card it runs against measured times (``chip_smoke.py``)."""
import importlib

import pytest
import torch

import benchmarks.common as ref_common
from repro_torch.bench import common as port_common
from repro_torch.bench.metric_cost import SIZES

NODES = 1200  # the serving stack's nodes in both packages
TIER_COST = {"hot": 1.0, "warm": 16.0, "host": 160.0, "disk": 1600.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its shapes are tiny, and the
    suite's parallel workers would otherwise oversubscribe the cores (each
    of torch's small ops spinning up a thread team)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _one_call(fn, *args, repeats=5, warmup=2, device=None):
    fn(*args)
    return 1e-3


def _fields(derived: str) -> dict:
    return dict(kv.split("=", 1) for kv in derived.split(";") if "=" in kv)


def _run(monkeypatch, name: str, **port_kw):
    """Run both modules of figure ``name``; returns their rows."""
    ref = importlib.import_module(f"benchmarks.{name}")
    port = importlib.import_module(f"repro_torch.bench.{name}")
    for mod in (ref, port):
        if hasattr(mod, "timeit"):
            monkeypatch.setattr(mod, "timeit", _one_call)
    if hasattr(ref, "build_serving_stack"):
        build = ref_common.build_serving_stack
        monkeypatch.setattr(ref, "build_serving_stack",
                            lambda **kw: build(**{**kw, "nodes": NODES}))
        port_kw.setdefault("nodes", NODES)
    ref_common.ROWS.clear()
    port_common.ROWS.clear()
    ref.run()
    summary = port.run(device="cpu", **port_kw)
    ref_rows, port_rows = list(ref_common.ROWS), list(port_common.ROWS)
    assert [r[0] for r in port_rows] == [r[0] for r in ref_rows]
    return {r[0]: r for r in ref_rows}, {r[0]: r for r in port_rows}, summary


def _tier_of_cost(value: float) -> str:
    """The cheapest reference tier whose cost reaches ``value`` (the
    reference's p95 of per-batch gating costs)."""
    return min((c, t) for t, c in TIER_COST.items() if c >= value)[1]


def check_motivation(ref, port, _):
    for name, (_, value, derived) in ref.items():
        assert port[name][1] == value and port[name][2] == derived, name


def check_metric_cost(ref, port, _):
    for name, row in ref.items():
        if "/psgs_us_n" in name:
            for key in ("edges", "table_MB"):
                assert _fields(port[name][2])[key] == _fields(row[2])[key]


def check_calibration(ref, port, _):
    for name, row in ref.items():
        if "_avg_ms_" in name:
            assert _fields(port[name][2])["psgs"] == _fields(row[2])["psgs"]
            assert _fields(port[name][2])["unit"] == "us"


def check_skew_robustness(ref, port, _):
    routes = [_fields(row[2])["routed"] for n, row in ref.items()
              if n.endswith("_psgs_us")]
    assert routes
    for name, row in ref.items():
        if name.endswith("_psgs_us"):
            assert _fields(port[name][2])["routed"] == _fields(row[2])["routed"]


def check_placement_compare(ref, port, summary):
    for name, row in ref.items():
        policy = name.split("/")[1].rsplit("_", 2)[0]
        if name.endswith("_mean_cost") and policy != "p3":
            a, b = _fields(port[name][2]), _fields(row[2])
            for key in ("hot%", "warm%", "disk%"):
                assert a[key] == b[key], (name, key)
        if name.endswith("_p95_tail_tier"):
            assert _fields(port[name][2])["tier"] == _tier_of_cost(row[1]), \
                name
    assert summary["validated"] == ["degree", "freq", "hash", "p3", "quiver"]
    assert sorted(summary["bitwise_ids"]) == ["degree", "freq", "hash",
                                              "quiver"]
    assert summary["fused_lookups"] == 4 * (1 + 1)  # one timed, one check


def check_feature_collection(ref, port, summary):
    name = "collection/dedup_bytes_saved_pct"
    assert port[name][1:] == ref[name][1:]
    name = "collection/tiered_modeled_GBps"
    for key in ("hot", "warm"):
        assert _fields(port[name][2])[key] == _fields(ref[name][2])[key]
    assert summary["bitwise_ids"] == {"quiver": 8192}


def check_serve_throughput(ref, port, _):
    for name, row in ref.items():
        a, b = _fields(port[name][2]), _fields(row[2])
        assert (a["host"], a["dev"]) == (b["host"], b["dev"]), name


def check_policy_cdf(ref, port, _):
    for name, row in ref.items():
        if name.endswith("_batch_p50_ms"):
            assert (_fields(port[name][2])["batches"]
                    == _fields(row[2])["batches"]), name
        if name.endswith("_work_cv"):
            assert port[name][1] == row[1], name


CASES = {
    "motivation": ({}, check_motivation),
    "metric_cost": ({"sizes": SIZES[:3]}, check_metric_cost),
    "calibration": ({}, check_calibration),
    "skew_robustness": ({}, check_skew_robustness),
    "placement_compare": ({}, check_placement_compare),
    "feature_collection": ({}, check_feature_collection),
    "serve_throughput": ({}, check_serve_throughput),
    "policy_cdf": ({}, check_policy_cdf),
}


@pytest.mark.parametrize("name", list(CASES))
def test_figure_matches_reference(monkeypatch, name):
    port_kw, check = CASES[name]
    ref, port, summary = _run(monkeypatch, name, **dict(port_kw))
    assert ref
    check(ref, port, summary)


def test_run_lists_the_reference_order():
    """The runner's modules are the reference runner's, in its order; its
    figures are this file's eight cases, ``scalability`` and ``roofline``
    read the dry-run's output, and the rest are its serving
    benchmarks."""
    from benchmarks.run import MODULES as REF_MODULES
    from repro_torch.bench.run import DRYRUN, FIGURES, MODULES, SERVING
    assert MODULES == REF_MODULES
    assert sorted(DRYRUN) == ["roofline", "scalability"]
    assert FIGURES == [m for m in REF_MODULES if m in CASES]
    assert sorted(FIGURES) == sorted(CASES)
    assert sorted(FIGURES + list(SERVING) + list(DRYRUN)) == sorted(MODULES)


def test_run_main_writes_json(tmp_path, capsys):
    """``python -m repro_torch.bench.run --device cpu --only motivation``
    prints the rows and writes the JSON with the module's status."""
    import json
    from repro_torch.bench import run as runner
    out = tmp_path / "BENCH_figures.json"
    runner.main(["--device", "cpu", "--only", "motivation", "--json-out",
                 str(out)])
    payload = json.loads(out.read_text())
    assert payload["modules"] == {"motivation": "ok"}
    assert [r["name"] for r in payload["rows"]][-1] == \
        "motivation/size_skew_50-35"
    with pytest.raises(SystemExit):
        runner.main(["--device", "cpu", "--only", "nope"])


def test_tier_bandwidths_on_the_cpu_are_marked():
    """On the CPU every tier is a host copy, marked so; the rates are
    positive and the DISK tier costs more than the HOST tier in the
    model (read, then sent)."""
    bw = port_common.tier_bandwidths("cpu")
    assert bw["card"] == "cpu"
    for k in ("hbm", "warm", "host", "host_pageable"):
        assert bw[k]["source"] == "cpu" and bw[k]["GBps"] > 0
    assert bw["disk"]["source"] == "measured" and bw["disk_warm"]["GBps"] > 0
    rate = port_common.tier_rates(bw)
    assert rate[3] < rate[2]
    assert "tier bandwidths (cpu; cpu):" in port_common.format_bandwidths(bw)


def test_sizes_name_each_modules_keywords():
    """Every size's arguments are keywords of its module's ``run``."""
    import inspect
    from repro_torch.bench.run import MODULES, SIZES
    for size, modules in SIZES.items():
        for name, kw in modules.items():
            assert name in MODULES, (size, name)
            run = importlib.import_module(f"repro_torch.bench.{name}").run
            assert set(kw) <= set(inspect.signature(run).parameters), \
                (size, name)


def test_serve_throughput_paced_serves_the_same_workload():
    """With a rate, Fig. 9 keeps the burst's rows and adds a paced run of
    the same seeded workload on the same engine: every request served,
    each routed as in the burst, the offered rate and the count named."""
    from repro_torch.bench import serve_throughput
    rows = {}
    for rate in (None, 400.0):
        port_common.ROWS.clear()
        serve_throughput.run(nodes=NODES, requests=24, rate=rate,
                             device="cpu")
        rows[rate] = {n: _fields(d) for n, _, d in port_common.ROWS}
    burst = list(rows[None])
    assert [n for n in rows[400.0] if n in burst] == burst
    for name in burst:
        paced = rows[400.0][name.replace("_rps", "_paced_p99_ms")]
        assert paced["offered"] == "400rps" and paced["n"] == "24", name
        assert ((paced["host"], paced["dev"]) == (rows[None][name]["host"],
                                                  rows[None][name]["dev"])
                == (rows[400.0][name]["host"], rows[400.0][name]["dev"]))
    assert len(rows[400.0]) == 2 * len(burst)


def test_skew_times_both_executors_in_alternation():
    """``interleaved_times`` warms each executor twice, then alternates one
    timed call of each for ``rounds`` rounds, and returns each median."""
    from repro_torch.bench.skew_robustness import interleaved_times
    calls = []
    t_host, t_dev = interleaved_times(lambda: calls.append("h"),
                                      lambda: calls.append("d"),
                                      rounds=4, device="cpu")
    assert "".join(calls) == "hhh" + "ddd" + "hd" * 3
    assert t_host >= 0 and t_dev >= 0


def test_skew_timing_trial_reports_the_worst_ratio(monkeypatch):
    """A steadiness trial reads ``skew_robustness``' rows, names the worst
    routed time over its limit (``1.5 · best + 1 ms``), counts a failed
    check as not held, and leaves the module as it found it."""
    from repro_torch.bench import skew_robustness as skew
    from repro_torch.bench import skew_timing
    rows = {"skew/a_b4": (1000.0, 3000.0, 1000.0),  # host routed: 0.4
            "skew/b_b4": (6000.0, 2000.0, 6000.0)}  # host routed: 1.5

    def fake_run(*, device, nodes):
        for pair, (host, dev, routed) in rows.items():
            skew.emit(pair + "_host_us", host)
            skew.emit(pair + "_device_us", dev)
            skew.emit(pair + "_psgs_us", routed)
            assert routed <= 1.5 * min(host, dev) + 1000.0
    monkeypatch.setattr(skew, "run", fake_run)
    saved = skew.interleaved_times, skew.emit
    out = skew_timing.trial("separate", "quiet", device="cpu", nodes=10)
    assert (skew.interleaved_times, skew.emit) == saved
    assert out["held"] is False and out["worst_over_limit"] == 1.5
    del rows["skew/b_b4"]
    out = skew_timing.trial("interleaved", "quiet", device="cpu", nodes=10)
    assert out["held"] is True and out["worst_over_limit"] == 0.4
