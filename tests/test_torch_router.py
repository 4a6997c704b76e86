"""Port binary calibration routing against the JAX package's:
``CalibrationResult.threshold`` under every policy, ``HybridScheduler``
routes (and its ``from_calibration``), ``CostModelRouter.from_calibration``
routes, and ``calibrate`` on the same measurements."""
import time

import numpy as np
import pytest

from repro.serving import CalibrationResult as JaxCalibration
from repro.serving import CostModelRouter as JaxRouter
from repro.serving import HybridScheduler as JaxHybrid
from repro.serving import LatencyCurve as JaxCurve
from repro.serving import calibrate as jax_calibrate
from repro_torch.serving import (POLICIES, CalibrationResult,
                                 CostModelRouter, HybridScheduler,
                                 LatencyCurve, calibrate)


def _pair(seed, cls):
    """A host curve and a device curve that may or may not cross."""
    rng = np.random.default_rng(seed)
    ps = np.sort(rng.random(60) * 500)
    host = cls.fit(ps, 1e-4 * ps * (1 + rng.random(60)) + 1e-3, bins=8)
    dev = cls.fit(ps, 2e-5 * ps * (1 + rng.random(60)) + 4e-3 * (seed % 3),
                  bins=8)
    return host, dev


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_thresholds_and_routes_match_reference(seed):
    port = CalibrationResult(*_pair(seed, LatencyCurve))
    ref = JaxCalibration(*_pair(seed, JaxCurve))
    table = np.random.default_rng(seed).random(200).astype(np.float32) * 40
    batches = [np.random.default_rng(seed + i).integers(-1, 200, 16)
               for i in range(40)]
    for policy in POLICIES + ("strict", "loose"):
        assert port.threshold(policy) == ref.threshold(policy)
    for policy in POLICIES:
        hs = HybridScheduler.from_calibration(table, port, policy)
        hj = JaxHybrid.from_calibration(table, ref, policy)
        cs = CostModelRouter.from_calibration(table, port, policy)
        cj = JaxRouter.from_calibration(table, ref, policy)
        assert hs.threshold == hj.threshold
        for b in batches:
            assert hs.batch_cost(b) == hj.batch_cost(b)
            assert hs.route(b) == hj.route(b)
            assert cs.route(b) == cj.route(b)
        assert hs.routed == hj.routed and cs.routed == cj.routed
        assert cs.names == ["host", "device"]
    with pytest.raises(ValueError, match="unknown policy"):
        port.threshold("fastest")


def test_calibrate_matches_reference(monkeypatch):
    """The same measured times (a fake counter) give the same curves."""
    table = np.arange(64, dtype=np.float32)
    batches = [np.arange(i, i + 8) for i in range(0, 56, 8)]
    now = [0.0]

    def perf_counter():
        return now[0]

    def runner(scale):
        def run(seeds):
            now[0] += scale * (1.0 + float(np.asarray(seeds).sum()) / 100)
        return run

    monkeypatch.setattr(time, "perf_counter", perf_counter)
    a = calibrate(runner(1e-3), runner(5e-4), batches, table, repeats=2)
    now[0] = 0.0
    b = jax_calibrate(runner(1e-3), runner(5e-4), batches, table, repeats=2)
    for x, y in ((a.host, b.host), (a.device, b.device)):
        for f in ("psgs", "avg", "mx"):
            assert np.array_equal(getattr(x, f), getattr(y, f))
    assert a.threshold("latency_preferred") == b.threshold(
        "latency_preferred")
