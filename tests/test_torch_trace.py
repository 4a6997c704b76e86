"""The port's tracer (``repro_torch.trace``): off it reads no clock; on,
spans nest per thread and merge across threads, counters sum, garbage
collections and a lane's CPU time are recorded; and over the serving
engine on the CPU every batch's route, lane wait and lane are joined by
its batch id, the store's stage spans nest inside its collection calls,
the router's prediction is the one it compared, and the served outputs
keep their bits."""
import gc
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core import (Request, TieredFeatureStore, TopologySpec,
                              quiver_placement)
from repro_torch.core.placement import TIER_HOST
from repro_torch.launch import serve as launcher
from repro_torch.serving import (CostModelRouter, DeviceExecutor,
                                 HostExecutor, LatencyCurve, ServingEngine)

STAGES = ("dedup", "ids_to_host", "resolve", "plan_to_device", "gather",
          "host_fetch")


@pytest.fixture
def tracer():
    trace.disable()
    trace.take()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.take()


def _inside(inner, outer) -> bool:
    return (inner.tid == outer.tid and outer.t0 <= inner.t0
            and inner.t1 <= outer.t1)


def test_off_reads_no_clock(monkeypatch):
    trace.disable()
    calls = []
    real = time.perf_counter_ns
    monkeypatch.setattr(time, "perf_counter_ns",
                        lambda: calls.append(1) or real())
    monkeypatch.setattr(time, "thread_time_ns",
                        lambda: calls.append(1) or real())
    ctx = trace.span("x", cpu=True, a=1)
    assert ctx is trace.span("y")
    with ctx as attrs:
        trace.note(b=2)
        trace.count("n", 3)
        trace.record("w", 0)
    assert attrs is None and calls == []
    assert trace.take() == {"spans": [], "counts": {}}


def test_spans_nest_per_thread_and_threads_merge(tracer):
    # the threads live at once, so that no two share an id
    together = threading.Barrier(3, timeout=30)

    def work(k):
        with trace.span("outer", k=k):
            with trace.span("inner"):
                trace.note(k=k)
            trace.count("items", k)
            if k < 4:
                together.wait()

    threads = [threading.Thread(target=work, args=(k,)) for k in (1, 2, 3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    work(4)
    got = trace.take()
    spans = got["spans"]
    assert [s.t0 for s in spans] == sorted(s.t0 for s in spans)
    outers = [s for s in spans if s.name == "outer"]
    inners = [s for s in spans if s.name == "inner"]
    assert len(outers) == len(inners) == 4
    assert len({s.tid for s in outers}) == 4
    for o in outers:
        (i,) = [i for i in inners if i.tid == o.tid]
        assert _inside(i, o) and i.attrs == {"k": o.attrs["k"]}
    assert got["counts"] == {"items": 1 + 2 + 3 + 4}


def test_take_clears(tracer):
    with trace.span("a"):
        trace.count("c", 1)
    assert len(trace.take()["spans"]) == 1
    assert trace.take() == {"spans": [], "counts": {}}


def test_gc_is_a_span(tracer):
    gc.collect()
    spans = [s for s in trace.take()["spans"] if s.name == "gc"]
    assert spans and spans[-1].attrs == {"generation": 2}
    assert all(s.t1 >= s.t0 for s in spans)
    trace.disable()
    gc.collect()
    assert not [s for s in trace.take()["spans"] if s.name == "gc"]


def test_cpu_time_is_at_most_wall_time(tracer):
    with trace.span("lane", cpu=True):
        sum(i * i for i in range(200_000))
        time.sleep(0.05)
    (s,) = [s for s in trace.take()["spans"] if s.name == "lane"]
    assert 0 < s.attrs["cpu_ns"] <= s.t1 - s.t0
    # the sleep is off the CPU
    assert s.t1 - s.t0 - s.attrs["cpu_ns"] >= 40_000_000


N, D, FAN = 900, 12, (4, 3)


@pytest.fixture(scope="module")
def stack():
    graph, _, psgs, _, store, _, infer = launcher.build_stack(
        nodes=N, avg_degree=6.0, d_feat=D, fanouts=FAN, hot_frac=0.3,
        device="cpu")
    return graph, psgs, store, infer


def _executors(stack, capacity):
    graph, psgs, store, infer = stack
    return {"host": HostExecutor(graph, store, FAN, infer, capacity=capacity,
                                 psgs_table=psgs, rng_seed=3),
            "device": DeviceExecutor(graph.device_arrays("cpu"), store, FAN,
                                     infer, max_batch=16, capacity=capacity,
                                     psgs_table=psgs, rng_seed=4,
                                     fuse_aggregate=True)}


def _serve(stack, curves, reqs, *, capacity, max_inflight):
    """Each request a batch; returns (outputs, router)."""
    executors = _executors(stack, capacity)
    router = CostModelRouter.from_curves(stack[1], curves,
                                         executors=executors)
    engine = ServingEngine(executors, router, max_inflight=max_inflight)
    try:
        engine.begin_run()
        futs = [engine.submit_batch([r]) for r in reqs]
        outs = [f.result(timeout=120) for f in futs]
        engine.drain()
    finally:
        engine.close()
    return outs, router


@pytest.fixture(scope="module")
def curves(stack):
    """Curves that cross at the requests' median cost, so that both
    executors serve, routed alike in every engine."""
    m = float(np.median([stack[1][r.seeds].sum() for r in _requests()]))
    x = np.array([0.0, 2 * m])
    return {"host": LatencyCurve(x, x / m, x / m),
            "device": LatencyCurve(x, np.ones(2), np.ones(2))}


def _requests(n=24):
    rng = np.random.default_rng(7)
    return [Request(i, rng.integers(0, N, int(rng.integers(1, 24))), 0.0)
            for i in range(n)]


def test_engine_spans_join_each_batch(stack, curves, tracer):
    reqs = _requests()
    _, router = _serve(stack, curves, reqs, capacity=2, max_inflight=4)
    spans = trace.take()["spans"]
    by = {}
    for s in spans:
        if s.name in ("route", "lane_wait", "lane"):
            by.setdefault(s.attrs["batch"], {}).setdefault(
                s.name, []).append(s)
    assert len(by) == len(reqs)
    first = min(by)
    for b, got in by.items():
        assert {k: len(v) for k, v in got.items()} == {
            "route": 1, "lane_wait": 1, "lane": 1}
        (route,), (wait,), (lane,) = (got["route"], got["lane_wait"],
                                      got["lane"])
        name = route.attrs["executor"]
        assert wait.attrs["executor"] == lane.attrs["executor"] == name
        assert route.t1 <= wait.t0 <= wait.t1 <= lane.t0
        assert wait.tid == lane.tid != route.tid
        assert 0 < lane.attrs["cpu_ns"]
        # batch ids are drawn in submission order
        seeds = reqs[b - first].seeds
        assert route.attrs["predicted_s"] == router.estimate(
            name, router.batch_cost(seeds))
    lookups = [s for s in spans
               if s.name in ("lookup_hops", "lookup_aggregate")]
    assert {s.name for s in lookups} == {"lookup_hops", "lookup_aggregate"}
    lanes = [s for s in spans if s.name == "lane"]
    assert all(any(_inside(s, ln) for ln in lanes) for s in lookups)
    stages = [s for s in spans if s.name in STAGES]
    # the segment plan is built on the device: no plan crosses to it
    assert {"dedup", "ids_to_host", "resolve",
            "gather"} <= {s.name for s in stages}
    assert "plan_to_device" not in {s.name for s in stages}
    assert all(any(_inside(s, lk) for lk in lookups) for s in stages)
    for name in ("host_sample", "hops_to_device", "device_sample", "model"):
        assert all(any(_inside(s, ln) for ln in lanes)
                   for s in spans if s.name == name)
    assert {"admit", "route"} <= {s.name for s in spans}


def test_served_outputs_keep_their_bits_with_the_tracer_on(stack, curves):
    reqs = _requests()
    trace.disable()
    off, _ = _serve(stack, curves, reqs, capacity=1, max_inflight=1)
    trace.enable()
    try:
        on, _ = _serve(stack, curves, reqs, capacity=1, max_inflight=1)
        assert trace.take()["spans"]
    finally:
        trace.disable()
        trace.take()
    assert all(torch.equal(a, b) for a, b in zip(off, on))


@pytest.mark.parametrize("aggregate", [False, True])
def test_gather_counters(stack, tracer, aggregate):
    store = stack[2]
    rng = np.random.default_rng(1)
    hops = [rng.integers(-1, N, 8).astype(np.int32)]
    for f in FAN:
        hops.append(rng.integers(-1, N, hops[-1].shape[0] * f)
                    .astype(np.int32))
    if aggregate:
        store.lookup_aggregate(hops)
    else:
        store.lookup_hops(hops)
    counts = trace.take()["counts"]
    total = sum(h.shape[0] for h in hops)
    ids = np.concatenate(hops)
    if aggregate:
        # one singleton segment a unique id, one fan-wide segment a parent
        p, fan = hops[-2].shape[0], FAN[-1]
        assert counts["gather_rows"] == (total + p) * fan
        valid = (np.unique(ids[ids >= 0]).size
                 + int((hops[-1] >= 0).sum()))
    else:
        assert counts["gather_rows"] == total
        valid = np.unique(ids[ids >= 0]).size
    assert counts["gather_rows_valid"] == valid


def _layered(seed):
    rng = np.random.default_rng(seed)
    hops = [rng.integers(-1, N, 8).astype(np.int32)]
    for f in FAN:
        hops.append(rng.integers(-1, N, hops[-1].shape[0] * f)
                    .astype(np.int32))
    return hops


def _placed(rows_per_device, rows_host):
    feats = np.random.default_rng(2).normal(size=(N, D)).astype(np.float32)
    topo = TopologySpec(num_pods=1, devices_per_pod=1,
                        rows_per_device=rows_per_device, rows_host=rows_host,
                        hot_replicate_fraction=0.3)
    return TieredFeatureStore.build(
        feats, quiver_placement(np.random.default_rng(0).random(N), topo),
        device="cpu")


@pytest.mark.parametrize("aggregate", [False, True])
def test_every_row_on_the_device_reads_nothing_back(tracer, aggregate):
    store = _placed(N, 0)
    assert store.n_cold == 0
    hops = _layered(5)
    (store.lookup_aggregate if aggregate else store.lookup_hops)(hops)
    got = trace.take()
    names = {s.name for s in got["spans"]}
    assert {"dedup", "resolve", "gather"} <= names
    assert not {"ids_to_host", "plan_to_device", "host_fetch"} & names
    assert got["counts"]["cold_ids"] == 0


@pytest.mark.parametrize("aggregate", [False, True])
def test_cold_ids_counts_the_distinct_cold_ids(tracer, aggregate):
    store = _placed(220, N)       # every row off the device is HOST
    hops = _layered(6)
    ids = np.concatenate(hops)
    ids = np.unique(ids[ids >= 0])
    cold = int((store.tier_np[ids] == TIER_HOST).sum())
    assert 0 < cold < ids.size
    (store.lookup_aggregate if aggregate else store.lookup_hops)(hops)
    got = trace.take()
    assert got["counts"]["cold_ids"] == cold
    names = [s.name for s in got["spans"]]
    assert names.count("ids_to_host") == names.count("host_fetch") == 1
    assert "plan_to_device" not in names
