"""The port's serve launcher with the cold path, the control loop, the
gateway and multi-model serving, on the CPU at a small size: each flag
runs to the end and reports the reference's keys (the summary of the JAX
package's ``ServeMetrics`` and the reports of its controller, prefetcher,
cache and gateway); the cross-flag checks exit as the reference's do; the
distributed store's flags stay rejected."""
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import repro.launch.serve as jax_launcher
from repro.core import GPUFeatureCache as JaxCache
from repro.core import Prefetcher as JaxPrefetcher
from repro.serving import AdaptiveController as JaxController
from repro.serving import ClassStats as JaxClassStats
from repro.serving import GatewayConfig as JaxGatewayConfig
from repro.serving import ModelStats as JaxModelStats
from repro.serving import ServeMetrics as JaxServeMetrics
from repro.serving import ServingGateway as JaxGateway
from repro_torch.core import STATS_SCHEMA
from repro_torch.launch import serve as launcher
from repro_torch.serving import ModelEntry, build_model_entry

SMALL = ["--device", "cpu", "--nodes", "1000", "--requests", "12",
         "--batch", "8"]
COLD = ["--adaptive", "--adapt-interval", "3", "--prefetch", "--gpu-cache"]


def _reference_keys():
    engine = SimpleNamespace(clock=lambda: 0.0, saturation=0.0,
                             registry=None)
    return {
        "summary": set(JaxServeMetrics().summary()),
        "model": set(JaxModelStats().summary()),
        "class": set(JaxClassStats().summary()),
        "adaptation": set(JaxController(SimpleNamespace(num_nodes=4), (2,),
                                        None).report()),
        "prefetch": set(JaxPrefetcher(SimpleNamespace(), budget=4)
                        .report()),
        "gpu_cache": set(JaxCache(4, 2, 2).report()),
        "gateway": set(JaxGateway(engine, config=JaxGatewayConfig(),
                                  clock=engine.clock).report()),
    }


REF = _reference_keys()


@pytest.mark.parametrize("extra,sections", [
    (COLD + ["--spill-path", "{tmp}/s.spill"],
     {"adaptation", "prefetch", "gpu_cache"}),
    (COLD + ["--fuse-aggregate"], {"adaptation", "prefetch", "gpu_cache"}),
    (["--prefetch", "--gpu-cache", "--policy", "host_only"],
     {"prefetch", "gpu_cache"}),
    (["--gateway", "--priority", "mixed", "--deadline-ms", "20",
      "--telemetry", "--adaptive", "--adapt-interval", "3"],
     {"adaptation", "gateway"}),
    (["--micro-batch", "16", "--adaptive", "--adapt-micro",
      "--adapt-interval", "2"],
     {"adaptation"}),
    (["--models", "a=sage-base", "--models", "b=sage-wide"] + COLD,
     {"adaptation", "prefetch", "gpu_cache"}),
], ids=["cold-path", "cold-path-fuse-aggregate", "cold-path-static",
        "gateway", "micro-adapt", "models"])
def test_launcher_flags_end_with_reference_keys(extra, sections, tmp_path,
                                                capsys):
    argv = SMALL + [a.replace("{tmp}", str(tmp_path)) for a in extra]
    out = launcher.main(argv)
    summary_keys = set(out) - sections
    assert summary_keys == REF["summary"]
    for key in sections:
        assert set(out[key]) == REF[key], key
    store = out["store"]["TieredFeatureStore"]
    assert set(store) == set(STATS_SCHEMA) | {"collect_mode"}
    if "gateway" in sections:
        rep = out["gateway"]
        assert (rep["completed"] + rep["shed_window"]
                + rep["shed_deadline"] == 12)
        assert set(out["classes"]) == {"interactive", "batch"}
        for block in out["classes"].values():
            assert set(block) == REF["class"]
        assert "[serve] telemetry:" in capsys.readouterr().out
    else:
        assert out["requests"] == 12
    if "--models" in extra:
        assert set(out["models"]) == {"a", "b"}
        for block in out["models"].values():
            assert set(block) == REF["model"]
    if "adaptation" in sections:
        assert out["adaptation"]["steps"] >= 1
    if "prefetch" in sections:
        assert out["prefetch"]["refreshes"] >= 1
    if "--fuse-aggregate" in extra:
        assert store["fused_aggregates"] > 0
        assert store["collect_mode"] == "fuse_aggregate"


@pytest.mark.parametrize("argv", [
    ["--adapt-micro"],
    ["--adaptive", "--adapt-micro"],
    ["--priority", "mixed"],
    ["--deadline-ms", "5"],
    ["--telemetry"],
    ["--gateway", "--micro-batch", "4"],
], ids=lambda a: " ".join(a))
def test_cross_flag_checks_exit_as_the_reference(argv, monkeypatch):
    with pytest.raises(SystemExit) as ours:
        launcher.parse_args(argv)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(SystemExit) as theirs:
        jax_launcher.main()
    assert str(ours.value) == str(theirs.value) != ""


@pytest.mark.parametrize("argv,match", [
    (["--models", "a"], "name=preset"),
    (["--models", "=sage-base"], "name=preset"),
    (["--models", "a=sage-base", "--models", "a=sage-wide"], "duplicate"),
    (["--models", "a=sage-huge"], "unknown preset"),
    (["--models", "a=sage-base", "--policy", "host_only"],
     "cost-model policy"),
])
def test_models_flag_checks(argv, match):
    with pytest.raises(SystemExit, match=match):
        launcher.parse_args(argv)
    if "--policy" not in argv:
        with pytest.raises(SystemExit, match=match):
            jax_launcher.parse_model_specs(argv[1::2])


@pytest.mark.parametrize("flag", ["--sharded", "--sharded-spill-dir=d"])
def test_distributed_flags_stay_rejected(flag, capsys):
    with pytest.raises(SystemExit) as err:
        launcher.parse_args([flag])
    assert err.value.code != 0
    assert "unrecognized arguments" in capsys.readouterr().err


def test_presets_and_stream_kwargs_match_reference():
    assert launcher.MODEL_PRESETS == jax_launcher.MODEL_PRESETS
    assert launcher.HIDDEN == jax_launcher.MODEL_PRESETS["sage-base"]
    specs = ["x=sage-small", "y=sage-deep"]
    assert (launcher.parse_model_specs(specs)
            == jax_launcher.parse_model_specs(specs))
    for argv in ([], ["--gateway"], ["--gateway", "--priority", "mixed",
                                     "--deadline-ms", "7"],
                 ["--gateway", "--priority", "interactive"]):
        ours = launcher.parse_args(argv)
        theirs = SimpleNamespace(gateway="--gateway" in argv,
                                 priority=ours.priority,
                                 deadline_ms=ours.deadline_ms)
        assert (launcher.priority_stream_kwargs(ours)
                == jax_launcher.priority_stream_kwargs(theirs))


def test_build_model_entry_over_a_shared_store():
    stack = launcher.build_stack(nodes=800, avg_degree=6.0, d_feat=16,
                                 fanouts=(3, 2), hot_frac=0.25, device="cpu")
    graph, _, psgs, _, store, _, _ = stack
    entries = []
    for i, hidden in enumerate(((8, 8), (16, 16))):
        infer = launcher.make_model_infer_fn(16, hidden, (3, 2), seed=i,
                                             device="cpu")
        entries.append(build_model_entry(
            f"m{i}", graph=graph, store=store, fanouts=(3, 2),
            infer_fn=infer, psgs_table=psgs, max_batch=8, rng_seed=i,
            calibration_repeats=1))
    try:
        for e, width in zip(entries, (8, 16)):
            assert isinstance(e, ModelEntry)
            assert e.router.names == ["host", "device"]
            assert e.executors["host"].store is store
            out = e.executors["device"].run(np.arange(5))
            assert out.shape == (5, width)
    finally:
        for e in entries:
            for ex in e.executors.values():
                ex.close()
