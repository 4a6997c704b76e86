"""The port's adaptive serving benchmarks (``flash_crowd``,
``multi_model``, ``workload_drift``) against the reference's, on the CPU
at ``dry_run=True``, as in ``test_torch_serving_benches.py`` (whose
helpers run both): the same rows in the same order, the rows that read
no clock equal, the timed ones finite and positive. Control steps fire on
completions, so what an adaptive run migrates is timed too."""
import math

from test_torch_serving_benches import (_fields, _one_thread,  # noqa: F401
                                        _run, _same, _timed)


def test_flash_crowd_matches_reference(monkeypatch, tmp_path):
    ref, port, _, out = _run(monkeypatch, tmp_path, "flash_crowd")
    for mode in ("adaptive", "cache"):
        name = f"flash_crowd/{mode}_host_cb_per_req"
        assert port[name][1] == ref[name][1], name
        _same(ref, port, name, ["cache_hits", "steps"])
    _same(ref, port, "flash_crowd/bit_identical")
    _same(ref, port, "flash_crowd/host_cb_reduction_x")
    assert out["cache"]["control_steps"] == out["adaptive"]["control_steps"]


def test_multi_model_matches_reference(monkeypatch, tmp_path):
    ref, port, _, out = _run(monkeypatch, tmp_path, "multi_model")
    _same(ref, port, "multi_model/store_shared_mb")
    for m in ("small", "wide"):
        assert port[f"multi_model/cutpoint_{m}"][1] > 0
    _timed(port, "multi_model/shared_rps", "multi_model/isolated_rps",
           "multi_model/throughput_ratio_x")
    assert set(out["shared"]["models"]) == {"small", "wide"}


def test_workload_drift_matches_reference(monkeypatch, tmp_path):
    ref, port, _, out = _run(monkeypatch, tmp_path, "workload_drift")
    name = "workload_drift/static_host_rate"
    assert port[name][1] == ref[name][1]
    _same(ref, port, name, ["migrated"])
    # the adaptive run's control steps fire on completions: timed
    for name in ("workload_drift/adaptive_host_rate",
                 "workload_drift/adaptation_win_pp"):
        assert math.isfinite(port[name][1])
    assert int(_fields(port["workload_drift/adaptive_host_rate"][2])
               ["migrated"]) > 0
    assert 0 < out["before_drift"]["host_access_rate"] < 1
