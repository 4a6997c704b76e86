"""Port ``ServingGateway`` and ``FakeClock`` against the JAX package's:
under a fake clock the same request stream over stub engines gives the same
verdicts, outcomes, dispatch order, report and telemetry; the admission
invariants hold as properties (hypothesis: outcome partition, window bound
with FIFO drain, aging bound); and over a real port engine on the CPU every
request ends in exactly one outcome."""
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import Request as JaxRequest
from repro.serving import GatewayConfig as JaxGatewayConfig
from repro.serving import ServingGateway as JaxGateway
from repro.testing import FakeClock as JaxClock
from repro_torch.core import (Request, TieredFeatureStore, TopologySpec,
                              quiver_placement)
from repro_torch.graph import power_law_graph
from repro_torch.launch.serve import make_model_infer_fn
from repro_torch.serving import (GATEWAY_SCHEMA, TELEMETRY_SAMPLE_SCHEMA,
                                 GatewayConfig, HostExecutor, ServingEngine,
                                 ServingGateway, StaticScheduler)
from repro_torch.testing import FakeClock

OUTCOMES = ("completed", "shed_window", "shed_deadline")


class _Router:
    def estimate_seconds(self, seeds):
        return 0.01 * len(seeds)


class InstantEngine:
    """Engine stand-in: dispatch completes inline on the submitting thread;
    ``max_inflight`` is flipped by the tests to build or drain a queue."""

    def __init__(self, clock, max_inflight=1, router=None):
        self.clock = clock
        self.max_inflight = max_inflight
        self.registry = SimpleNamespace(
            router_for=lambda name: router if router else object())
        self.dispatched: list = []
        self.inflight = 0
        self.saturation = 0.0

    def class_summaries(self):
        return {}

    def record_shed(self, batch, model=None, *, reason="window"):
        for r in batch:
            r.outcome = ("shed_window" if reason == "window"
                         else "shed_deadline")

    def submit_batch(self, batch):
        for r in batch:
            r.outcome = "completed"
        self.dispatched.extend(batch)
        fut = Future()
        fut.set_result(np.zeros((len(batch), 1), np.float32))
        return fut

    def drain(self):
        pass


def _run_stream(side, events, cfg_kw):
    """Drive one gateway through ``events``: ("submit", prio, deadline,
    n_seeds, dt) or ("open", n) / ("close",)."""
    Clock, Cfg, Gw, Req = ((FakeClock, GatewayConfig, ServingGateway,
                            Request) if side == "port" else
                           (JaxClock, JaxGatewayConfig, JaxGateway,
                            JaxRequest))
    clk = Clock()
    eng = InstantEngine(clk, max_inflight=0, router=_Router())
    gw = Gw(eng, config=Cfg(**cfg_kw), clock=clk)
    verdicts, reqs = [], []
    for i, ev in enumerate(events):
        if ev[0] == "submit":
            _, prio, dl, n, dt = ev
            clk.advance(dt)
            r = Req(i, np.arange(n, dtype=np.int64), 0.0, priority=prio,
                    deadline_s=dl)
            reqs.append(r)
            verdicts.append(gw.submit(r))
        elif ev[0] == "open":
            eng.max_inflight = ev[1]
            verdicts.append(gw.pump())
        else:
            eng.max_inflight = 0
    eng.max_inflight = len(reqs) + 1
    gw.pump()
    gw.drain()
    return (verdicts, [r.outcome for r in reqs],
            [r.req_id for r in eng.dispatched], gw.report(),
            gw.telemetry_samples(), [r.arrival for r in reqs])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gateway_matches_reference_under_fake_clock(seed):
    rng = np.random.default_rng(seed)
    events = []
    for _ in range(40):
        u = rng.random()
        if u < 0.8:
            events.append(("submit",
                           str(rng.choice(["interactive", "batch"])),
                           [None, 0.02, 0.2, 1.0][rng.integers(4)],
                           int(rng.integers(1, 12)),
                           float(rng.choice([0.0, 0.01, 0.1]))))
        elif u < 0.9:
            events.append(("open", int(rng.integers(1, 4))))
        else:
            events.append(("close",))
    cfg = dict(queue_limit=int(rng.integers(3, 10)), aging_bound_s=0.15,
               telemetry_min_interval_s=0.05)
    a = _run_stream("port", events, cfg)
    b = _run_stream("jax", events, cfg)
    assert a == b
    verdicts, outcomes, _, rep, samples, _ = a
    assert all(o in OUTCOMES for o in outcomes)
    assert (rep["completed"] + rep["shed_window"] + rep["shed_deadline"]
            == len(outcomes))
    assert tuple(k for k in rep if k in GATEWAY_SCHEMA) == GATEWAY_SCHEMA
    assert all(tuple(s) == TELEMETRY_SAMPLE_SCHEMA for s in samples)


def test_fake_clock_matches_reference():
    a, b = FakeClock(1.5), JaxClock(1.5)
    for dt in (0.0, 0.25, 3.0):
        assert a.advance(dt) == b.advance(dt)
    a.sleep(0.5)
    b.sleep(0.5)
    assert a() == b() and repr(a) == repr(b)
    with pytest.raises(ValueError):
        a.advance(-1.0)


def _gateway(clk, *, max_inflight, **cfg_kw):
    eng = InstantEngine(clk, max_inflight=max_inflight)
    return ServingGateway(eng, config=GatewayConfig(**cfg_kw),
                          clock=clk), eng


def _req(i, priority="batch", deadline_s=None):
    return Request(i, np.array([i % 8], np.int64), 0.0, priority=priority,
                   deadline_s=deadline_s)


ARRIVALS = st.lists(
    st.tuples(st.sampled_from(("interactive", "batch")),
              st.sampled_from((None, -0.01, 0.05, 0.5, 5.0)),
              st.floats(min_value=0.0, max_value=0.2)),
    min_size=1, max_size=30)


@settings(max_examples=40, deadline=None)
@given(arrivals=ARRIVALS, queue_limit=st.integers(1, 8))
def test_every_request_terminates_in_exactly_one_outcome(arrivals,
                                                         queue_limit):
    clk = FakeClock()
    gw, eng = _gateway(clk, max_inflight=0, queue_limit=queue_limit)
    reqs = []
    for i, (priority, dl, dt) in enumerate(arrivals):
        clk.advance(dt)
        r = _req(i, priority, dl)
        reqs.append(r)
        assert gw.submit(r) in ("queued", "shed_window", "shed_deadline")
        assert gw.queue_depth <= queue_limit
    eng.max_inflight = len(reqs) + 1
    gw.pump()
    gw.drain()
    assert gw.queue_depth == 0
    assert all(r.outcome in OUTCOMES for r in reqs)
    counts = {o: sum(r.outcome == o for r in reqs) for o in OUTCOMES}
    assert sum(counts.values()) == len(reqs)
    assert all(r.outcome != "shed_deadline" for r in reqs
               if r.deadline_s is None)
    rep = gw.report()
    assert rep["completed"] == counts["completed"] == len(eng.dispatched)
    assert rep["shed_window"] == counts["shed_window"]
    assert rep["shed_deadline"] == counts["shed_deadline"]
    assert rep["dispatched"] == rep["completed"]
    assert (rep["dispatched"] + rep["shed_window"]
            + rep["shed_deadline"] == len(reqs))
    assert rep["admitted"] >= rep["dispatched"]
    assert rep["max_queue_depth"] <= queue_limit


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 24), queue_limit=st.integers(1, 8))
def test_admission_window_bound_and_fifo_drain(n, queue_limit):
    clk = FakeClock()
    gw, eng = _gateway(clk, max_inflight=0, queue_limit=queue_limit)
    reqs = [_req(i) for i in range(n)]
    verdicts = [gw.submit(r) for r in reqs]
    kept = min(n, queue_limit)
    assert verdicts == ["queued"] * kept + ["shed_window"] * (n - kept)
    assert gw.queue_depth == kept
    assert gw.report()["max_queue_depth"] == kept <= queue_limit
    eng.max_inflight = n + 1
    gw.pump()
    gw.drain()
    assert [r.req_id for r in eng.dispatched] == [r.req_id
                                                  for r in reqs[:kept]]
    assert all(r.outcome == "completed" for r in reqs[:kept])
    assert all(r.outcome == "shed_window" for r in reqs[kept:])


@settings(max_examples=40, deadline=None)
@given(classes=st.lists(st.booleans(), min_size=2, max_size=20).filter(
    lambda c: any(c) and not all(c)))
def test_aged_interactive_is_never_passed_over_for_batch(classes):
    clk = FakeClock()
    gw, eng = _gateway(clk, max_inflight=0, aging_bound_s=0.25,
                       queue_limit=64)
    reqs = [_req(i, "interactive" if inter else "batch")
            for i, inter in enumerate(classes)]
    for r in reqs:
        assert gw.submit(r) == "queued"
    clk.advance(0.3)
    eng.max_inflight = len(reqs) + 1
    gw.pump()
    gw.drain()
    order = [r.priority for r in eng.dispatched]
    n_inter = sum(classes)
    assert order == ["interactive"] * n_inter + \
        ["batch"] * (len(reqs) - n_inter)
    assert gw.report()["aged_dispatches"] == n_inter


def test_gateway_over_a_port_engine_on_cpu():
    """A real engine behind the gateway: every request ends in exactly one
    outcome, per-class metrics and telemetry stream out."""
    n, d, fan = 600, 8, (3, 2)
    g = power_law_graph(n, 5.0, seed=0)
    feats = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    topo = TopologySpec(num_pods=1, devices_per_pod=1, rows_per_device=150,
                        rows_host=300, hot_replicate_fraction=0.3)
    store = TieredFeatureStore.build(
        feats, quiver_placement(np.random.default_rng(2).random(n), topo),
        device="cpu")
    infer = make_model_infer_fn(d, (8, 8), fan, device="cpu")
    engine = ServingEngine({"host": HostExecutor(g, store, fan, infer,
                                                 capacity=2)},
                           StaticScheduler("host"), max_inflight=2)
    gw = ServingGateway(engine, config=GatewayConfig(queue_limit=6))
    rng = np.random.default_rng(3)
    reqs = [Request(i, rng.integers(0, n, 4), 0.0,
                    priority=("interactive", "batch")[i % 2],
                    deadline_s=(1e-6, None)[i % 2]) for i in range(16)]
    metrics = gw.serve(reqs)
    engine.close()
    rep = gw.report()
    assert all(r.outcome in OUTCOMES for r in reqs)
    assert (rep["completed"] + rep["shed_window"] + rep["shed_deadline"]
            == len(reqs))
    assert rep["completed"] == metrics.requests > 0
    assert rep["shed_deadline"] > 0       # 1 µs deadlines cannot be met
    samples = list(gw.telemetry_stream(stop=lambda: True))
    assert samples and all(tuple(s) == TELEMETRY_SAMPLE_SCHEMA
                           for s in samples)
    assert set(metrics.summary()["classes"]) == {"interactive", "batch"}
