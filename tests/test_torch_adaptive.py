"""Port ``serving/adaptive.py`` against the JAX package's.

The controller's steps are held against the reference's given the same
observations and the same FAP: both sides' ``compute_fap`` are replaced by
the reference's own (JAX) FAP of the same graph and seed distribution, so a
near-tie in the port's ``index_add_`` sums cannot flip a migration pair.
With that, every step gives the same migrated and promoted rows, the same
tuned cache rows, stage budget, refresh cadence, admission window,
micro-batch bounds and refit curves. Without injection (the port's own FAP
on the store's device), the control loop migrates and lookups stay exact.
"""
from types import SimpleNamespace

import numpy as np
import pytest

import repro.serving.adaptive as jax_adaptive
import repro_torch.serving.adaptive as adaptive
from repro.core import GPUFeatureCache as JaxCache
from repro.core import Prefetcher as JaxPrefetcher
from repro.core import TieredFeatureStore as JaxStore
from repro.core import TopologySpec as JaxTopo
from repro.core import compute_fap as jax_fap
from repro.core import compute_psgs as jax_psgs
from repro.core import quiver_placement as jax_placement
from repro.graph import power_law_graph as jax_power_law
from repro.serving import AdaptiveConfig as JaxConfig
from repro.serving import AdaptiveController as JaxController
from repro.serving import CostModelRouter as JaxRouter
from repro.serving import FrequencySketch as JaxSketch
from repro.serving import GatewayConfig as JaxGatewayConfig
from repro.serving import LatencyCurve as JaxCurve
from repro.serving import MicroBatcher as JaxMicro
from repro.serving import curve_drift as jax_curve_drift
from repro_torch.core import (GPUFeatureCache, Prefetcher, Request,
                              TieredFeatureStore, TopologySpec,
                              quiver_placement)
from repro_torch.core.placement import TIER_DISK
from repro_torch.graph import power_law_graph
from repro_torch.launch.serve import make_model_infer_fn
from repro_torch.serving import (AdaptiveConfig, AdaptiveController,
                                 CostModelRouter, FrequencySketch,
                                 GatewayConfig, HostExecutor, LatencyCurve,
                                 MicroBatcher, ServingEngine,
                                 StaticScheduler, curve_drift)

N, D, FAN = 900, 12, (4, 3)
TOPO = dict(num_pods=1, devices_per_pod=1, rows_per_device=220,
            rows_host=330, hot_replicate_fraction=0.3)


@pytest.fixture(scope="module")
def stack():
    gj = jax_power_law(N, 6.0, seed=0)
    g = power_law_graph(N, 6.0, seed=0)
    feats = np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)
    return g, gj, feats, jax_fap(gj, FAN), jax_psgs(gj, FAN)


def _stores(stack, spill=None):
    _, _, feats, fap, _ = stack
    port = TieredFeatureStore.build(
        feats, quiver_placement(fap, TopologySpec(**TOPO)),
        spill_path=None if spill is None else str(spill / "t.spill"),
        device="cpu")
    ref = JaxStore.build(feats, jax_placement(fap, JaxTopo(**TOPO)),
                         spill_path=None if spill is None
                         else str(spill / "j.spill"))
    return port, ref


@pytest.fixture
def same_fap(stack, monkeypatch):
    """Both controllers get the reference's FAP of the same graph and seed
    distribution; the port side records the device it asked for."""
    _, gj, _, _, _ = stack
    devices = []

    def ref_fap(graph, fanouts, *, seed_prob=None, truncated=False):
        return np.asarray(jax_fap(gj, fanouts, seed_prob=seed_prob,
                                  truncated=truncated))

    def port_fap(graph, fanouts, *, seed_prob=None, truncated=False,
                 device="cuda"):
        devices.append(device)
        return ref_fap(graph, fanouts, seed_prob=seed_prob,
                       truncated=truncated)

    monkeypatch.setattr(adaptive, "compute_fap", port_fap)
    monkeypatch.setattr(jax_adaptive, "compute_fap", ref_fap)
    return devices


def test_frequency_sketch_matches_reference():
    a, b = FrequencySketch(50, decay=0.7), JaxSketch(50, decay=0.7)
    assert np.array_equal(a.empirical_prob(), b.empirical_prob())
    rng = np.random.default_rng(0)
    for _ in range(5):
        seeds = rng.integers(-1, 50, 30)
        a.observe(seeds)
        b.observe(seeds)
        a.decay_step()
        b.decay_step()
    assert np.array_equal(a.counts, b.counts)
    assert a.total_observed == b.total_observed
    for w in (0.0, 0.2):
        assert np.array_equal(a.empirical_prob(prior_weight=w),
                              b.empirical_prob(prior_weight=w))
    with pytest.raises(ValueError):
        FrequencySketch(4, decay=0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_curve_drift_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ps, ls = rng.random(40) * 100, rng.random(40) * 1e-2
    ps2, ls2 = rng.random(40) * 120, rng.random(40) * 2e-2
    a = curve_drift(LatencyCurve.fit(ps, ls, bins=6),
                    LatencyCurve.fit(ps2, ls2, bins=6))
    b = jax_curve_drift(JaxCurve.fit(ps, ls, bins=6),
                        JaxCurve.fit(ps2, ls2, bins=6))
    assert a == b


class _Gateway:
    """Stand-in with the two things ``tune_admission`` reads."""

    def __init__(self, config, reports):
        self.config = config
        self._reports = iter(reports)

    def report(self):
        return next(self._reports)


def _curves(cls):
    flat = cls(psgs=np.array([0.0, 400.0]), avg=np.array([1e-3, 2e-3]),
               mx=np.array([2e-3, 3e-3]))
    slow = cls(psgs=np.array([0.0, 400.0]), avg=np.array([3e-3, 4e-3]),
               mx=np.array([4e-3, 5e-3]))
    return {"host": flat, "device": slow}


def _controller(side, stack, store, spill_cfg):
    g, gj, _, _, psgs = stack
    if side == "port":
        C, Cfg, R, Cur, Cache, Pf, Micro, GwCfg = (
            AdaptiveController, AdaptiveConfig, CostModelRouter,
            LatencyCurve, GPUFeatureCache, Prefetcher, MicroBatcher,
            GatewayConfig)
        graph = g
    else:
        C, Cfg, R, Cur, Cache, Pf, Micro, GwCfg = (
            JaxController, JaxConfig, JaxRouter, JaxCurve, JaxCache,
            JaxPrefetcher, JaxMicro, JaxGatewayConfig)
        graph = gj
    router = R.from_curves(psgs, _curves(Cur), "latency_preferred")
    cfg = Cfg(interval_batches=10**9, rows_per_step=48, min_refit_samples=8,
              curve_bins=4, promote_budget=6, **spill_cfg)
    pf = Pf(store, budget=40)
    ctl = C(graph, FAN, store, router, psgs_table=psgs, config=cfg,
            prefetcher=pf)
    store.attach_cache(Cache.for_store(store, 96, sketch=ctl.sketch))
    ctl.attach_micro(Micro(deadline_s=4e-3, max_seeds=64, psgs_table=psgs))
    ctl.attach_gateway(_Gateway(GwCfg(queue_limit=256), [
        {"shed_deadline": 0, "saturation": 0.2},
        {"shed_deadline": 3, "saturation": 0.9},
        {"shed_deadline": 3, "saturation": 0.7},
        {"shed_deadline": 9, "saturation": 0.95}]))
    return ctl, router, pf


def _wait(pf):
    if pf._inflight is not None:
        pf._inflight.result(timeout=60)


def test_controller_steps_match_reference(stack, same_fap, tmp_path):
    g, gj, feats, fap, psgs = stack
    port, ref = _stores(stack, spill=tmp_path)
    cfg = dict(cache_rows_bounds=(16, 512), stage_budget_bounds=(16, 256),
               prefetch_cadence_bounds=(1, 3))
    a, ra, pa = _controller("port", stack, port, cfg)
    b, rb, pb = _controller("jax", stack, ref, cfg)
    rng = np.random.default_rng(5)
    hotspot = np.argsort(fap)[:40]           # coldest nodes turn hot
    disk = np.flatnonzero(port.tier_np == TIER_DISK)
    for step in range(4):
        for i in range(12):
            seeds = np.r_[rng.choice(hotspot, 12), rng.integers(0, N, 4)]
            ids = np.r_[seeds, rng.choice(disk, 8)].astype(np.int32)
            lat = 1e-3 * (2.0 + step) + 1e-5 * i
            for ctl, store, jax_side in ((a, port, False), (b, ref, True)):
                ctl.on_admit("host", seeds)
                store.lookup_hops([ids] if not jax_side
                                  else [np.asarray(ids)])
                ctl.on_batch_complete("host", seeds, lat)
                ctl.on_batch_complete("device", seeds, lat * 0.5)
        ra_, rb_ = a.step(), b.step()
        _wait(pa)
        _wait(pb)
        assert ra_ == rb_, step
        assert np.array_equal(port.plan.tier, ref.plan.tier)
        assert np.array_equal(port.tier_np, np.asarray(ref.tier_t))
        assert port.cache.capacity == ref.cache.capacity
        assert port.cache.report() == ref.cache.report()
        assert pa.budget == pb.budget and a._cadence == b._cadence
        assert a.gateway.config.queue_limit == b.gateway.config.queue_limit
        assert (a.micro.max_seeds, a.micro.deadline_s) == (
            b.micro.max_seeds, b.micro.deadline_s)
        assert port.snapshot_stats() == ref.snapshot_stats()
    assert a.report() == b.report()
    assert a.stats["migrated_rows"] > 0 and a.stats["refits"] > 0
    assert a.stats["promoted_rows"] > 0 and a.stats["admission_tunings"] == 4
    for name in ("host", "device"):
        ca, cb = ra.curve(name), rb.curve(name)
        assert all(np.array_equal(getattr(ca, f), getattr(cb, f))
                   for f in ("psgs", "avg", "mx"))
    assert same_fap and all(d == port.device for d in same_fap)
    assert np.array_equal(port.lookup(np.arange(N)).numpy(), feats)
    pa.close()
    pb.close()


def test_target_plan_matches_reference(stack, same_fap):
    g, gj, _, _, _ = stack
    port, ref = _stores(stack)
    a = AdaptiveController(g, FAN, port)
    b = JaxController(gj, FAN, ref)
    seeds = np.random.default_rng(1).integers(0, N, 300)
    a.on_admit("host", seeds)
    b.on_admit("host", seeds)
    (pa, fa), (pb, fb) = a.target_plan(), b.target_plan()
    assert np.array_equal(fa, fb)
    for f in ("tier", "slot", "pod_owner", "device_owner"):
        assert np.array_equal(getattr(pa, f), getattr(pb, f))


def test_cold_path_sizing_bounded_under_pathological_sketch(stack):
    g = stack[0]
    port, _ = _stores(stack)
    cache = GPUFeatureCache.for_store(port, 32)
    port.attach_cache(cache)
    pf = Prefetcher(port, budget=24)
    cfg = AdaptiveConfig(cache_rows_bounds=(16, 128),
                         stage_budget_bounds=(16, 96),
                         prefetch_cadence_bounds=(1, 4))
    ctl = AdaptiveController(g, FAN, port, None, prefetcher=pf, config=cfg)
    ctl.sketch.counts[:] = 1e18
    for _ in range(12):
        r = ctl.tune_cold_path()
        assert 16 <= r["cache_rows"] <= 128
        assert 16 <= r["stage_budget"] <= 96
        assert 1 <= r["refresh_cadence"] <= 4
    assert cache.capacity == 128 and pf.budget == 96
    ctl.sketch.counts[:] = 0.0
    for _ in range(12):
        r = ctl.tune_cold_path()
    assert r["cold_ws"] == 0
    assert cache.capacity == 16 and pf.budget == 16
    assert ctl.stats["cold_tunings"] == 24
    assert ctl.tune_admission() is None
    pf.close()


def test_router_refit_flips_the_route():
    table = np.full(8, 10.0, np.float32)
    curves = {"host": LatencyCurve(np.array([0.0, 100.0]),
                                   np.array([1e-3, 1e-3]),
                                   np.array([1e-3, 1e-3])),
              "device": LatencyCurve(np.array([0.0, 100.0]),
                                     np.array([5e-3, 5e-3]),
                                     np.array([5e-3, 5e-3]))}
    router = CostModelRouter.from_curves(table, curves)
    seeds = np.array([0, 1])
    assert router.route(seeds) == "host"
    ctl = AdaptiveController(SimpleNamespace(num_nodes=8), (2,),
                             SimpleNamespace(plan=None), router,
                             psgs_table=table,
                             config=AdaptiveConfig(min_refit_samples=8,
                                                   curve_bins=4,
                                                   interval_batches=10**9))
    for i in range(16):
        ctl.on_batch_complete("host", np.array([i % 8]), 1e-2 + i * 1e-5)
        ctl.on_batch_complete("device", np.array([i % 8]), 5e-3)
    assert ctl.refit_curves() >= 1
    assert ctl.stats["last_drift"]["host"] > 0.25
    assert router.route(seeds) == "device"


def test_engine_hooks_drive_controller_on_the_store_device(stack):
    """The port's own FAP (on the store's device): engine hooks feed the
    sketch and run control steps while serving; the hot spot moves into
    the device tiers and every lookup stays exact."""
    g, _, feats, fap, psgs = stack
    port, _ = _stores(stack)
    infer = make_model_infer_fn(D, (16, 16), FAN, device="cpu")
    host = HostExecutor(g, port, FAN, infer, psgs_table=psgs)
    ctl = AdaptiveController(
        g, FAN, port, psgs_table=psgs,
        config=AdaptiveConfig(interval_batches=4, rows_per_step=400))
    engine = ServingEngine({"host": host}, StaticScheduler("host"),
                           hooks=[ctl])
    cold = np.argsort(fap)[:16]
    m = engine.run([[Request(i, cold.copy(), 0.0)] for i in range(12)])
    engine.close()
    assert m.requests == 12 and ctl.stats["steps"] >= 2
    assert port.migrated_rows > 0
    hist = port.tier_histogram(cold)
    assert hist["hot"] + hist["warm"] == 16
    assert np.array_equal(port.lookup(np.arange(N)).numpy(), feats)
