"""Gateway soak: SLO-aware admission against FIFO under overload.

A flash crowd of heavy batch requests (seeds on the coldest DISK rows,
:func:`~repro_torch.bench.flash_crowd.flash_hotspot`) lands ahead of a
burst of light interactive requests with deadlines, plus a few "doomed"
requests whose deadline passed at arrival. Both modes serve the identical
seeded stream over identical fresh stacks:

  fifo      requests go to ``ServingEngine.submit_batch`` in arrival
            order (admission "wait"): interactive traffic queues behind
            every heavy request, and doomed requests take executors.
  gateway   :class:`~repro_torch.serving.ServingGateway` orders admission
            by deadline slack (from the calibrated router's curves) with
            aging, sheds hopeless requests at admission and re-checks
            staleness at dequeue.

Asserted in the run (gateway mode): no expired request dispatched, queue
depth within the admission window, telemetry timestamps monotone, every
request in exactly one terminal outcome, and interactive p99 strictly
below FIFO's on the same stream.

    PYTHONPATH=src python -m repro_torch.bench.run --only gateway_soak

``dry_run=True`` takes the reference's CI sizes.
"""
from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.bench.common import (build_serving_stack, emit,
                                      make_executors, write_bench_json)
from repro_torch.bench.flash_crowd import flash_hotspot
from repro_torch.serving import (CostModelRouter, GatewayConfig,
                                 ServingEngine, ServingGateway,
                                 calibrate_executors)

#: The result row's schema: one row a mode in ``BENCH_gateway_soak.json``.
ROW_SCHEMA = ("mode", "requests", "completed", "shed_window",
              "shed_deadline", "expired_dispatches", "max_queue_depth",
              "interactive_p50_ms", "interactive_p99_ms",
              "batch_p50_ms", "batch_p99_ms", "wall_s")


def build_row(**fields) -> dict:
    """One mode's result row in ``ROW_SCHEMA`` order.

    Raises:
        ValueError: on a missing or extra field, so the BENCH format cannot
            drift silently.
    """
    missing = set(ROW_SCHEMA) - set(fields)
    extra = set(fields) - set(ROW_SCHEMA)
    if missing or extra:
        raise ValueError(f"row drifted from ROW_SCHEMA: "
                         f"missing={sorted(missing)} extra={sorted(extra)}")
    return {k: fields[k] for k in ROW_SCHEMA}


def class_percentiles(reqs) -> dict:
    """p50 and p99 (ms) of each class's completed requests, from the
    requests themselves (FIFO mode has no gateway telemetry)."""
    out = {}
    for cls in ("interactive", "batch"):
        lat = [r.latency for r in reqs
               if r.priority == cls and r.outcome == "completed"]
        arr = np.asarray(lat if lat else [0.0], dtype=np.float64)
        out[cls] = {"p50_ms": float(np.quantile(arr, 0.5) * 1e3),
                    "p99_ms": float(np.quantile(arr, 0.99) * 1e3)}
    return out


def expired_dispatches(reqs) -> int:
    """Requests handed to an executor after their deadline had passed (the
    gateway's dequeue-time check keeps this at zero; FIFO spends executor
    slots on them)."""
    n = 0
    for r in reqs:
        t = getattr(r, "dispatched", None)
        if (r.deadline_s is not None and t is not None
                and t > r.arrival + r.deadline_s):
            n += 1
    return n


def build_stream(stack, *, n_heavy: int, n_light: int, n_doomed: int,
                 heavy_per: int, light_per: int, deadline_s: float) -> list:
    """The mixed overload stream: heavy deadline-free batch requests on the
    coldest DISK rows first, then light interactive requests with a
    deadline, then doomed interactive requests already expired at arrival
    (``deadline_s=-1``); fixed by the stack's seed."""
    gen, nodes = stack["gen"], stack["graph"].num_nodes
    hotspot = flash_hotspot(stack["store"], stack["fap"],
                            size=max(4, n_heavy // 2))
    p = np.zeros(nodes)
    p[hotspot] = 1.0 / hotspot.size
    gen.set_seed_prob(p)
    heavy = [gen.make_request(heavy_per, priority="batch")
             for _ in range(n_heavy)]
    gen.set_seed_prob(None)
    light = [gen.make_request(light_per, priority="interactive",
                              deadline_s=deadline_s)
             for _ in range(n_light)]
    doomed = [gen.make_request(light_per, priority="interactive",
                               deadline_s=-1.0) for _ in range(n_doomed)]
    return heavy + light + doomed


def _make_engine(stack, *, max_inflight: int) -> ServingEngine:
    """Calibrated host+device engine over the stack: a real
    ``CostModelRouter``, so the gateway's slack estimate reads the
    executors' latency curves."""
    executors = make_executors(stack, num_workers=2, max_batch=64)
    psgs = stack["psgs"]
    order = np.argsort(psgs)
    batches = [order[int(q * order.size):][:16].astype(np.int64)
               for q in np.linspace(0.1, 0.9, 4)]
    curves = calibrate_executors(executors, batches, psgs, repeats=1)
    router = CostModelRouter.from_curves(psgs, curves, "latency_preferred",
                                         executors=executors)
    return ServingEngine(executors, router, max_inflight=max_inflight,
                         admission="wait")


def _run_fifo(engine, reqs) -> None:
    """FIFO baseline: ``submit_batch`` in arrival order under
    wait-admission; a request's dispatch stamp is taken when admission
    lets it into the executor window."""
    t0 = engine.clock()
    for r in reqs:
        r.arrival = t0                      # burst: all arrived at once
    m = engine.begin_run()
    for r in reqs:
        engine.submit_batch([r])
        r.dispatched = engine.clock()
    engine.drain()
    engine.end_run(m)


def run(*, dry_run: bool = False,
        device: str | torch.device = "cuda") -> dict:
    """Serve the overload stream FIFO and through the gateway; emit each
    mode's interactive p99 and the gateway's gain; returns the two rows
    (also in ``BENCH_gateway_soak.json``)."""
    n_heavy, n_light, n_doomed = (8, 8, 2) if dry_run else (32, 32, 4)
    heavy_per, light_per = (16, 4) if dry_run else (32, 4)
    nodes = 600 if dry_run else 4000
    fanouts = (4, 3) if dry_run else (6, 4)
    deadline_s, queue_limit, max_inflight = 30.0, 256, 2
    spill = tempfile.NamedTemporaryFile(suffix=".spill", delete=False)
    spill.close()
    rows: dict = {}
    try:
        for mode in ("fifo", "gateway"):
            # fresh stack per mode (same seed -> identical plan + stream);
            # tiny HBM tiers so heavy requests really pay the DISK price
            stack = build_serving_stack(nodes=nodes, fanouts=fanouts, seed=0,
                                        distribution="zipf", rows_frac=0.1,
                                        spill_path=spill.name, device=device)
            engine = _make_engine(stack, max_inflight=max_inflight)
            engine.warmup(np.arange(light_per))
            reqs = build_stream(stack, n_heavy=n_heavy, n_light=n_light,
                                n_doomed=n_doomed, heavy_per=heavy_per,
                                light_per=light_per, deadline_s=deadline_s)
            t0 = time.perf_counter()
            if mode == "fifo":
                _run_fifo(engine, reqs)
                shed_window = shed_deadline = 0
                max_depth = 0
            else:
                gw = ServingGateway(engine, config=GatewayConfig(
                    queue_limit=queue_limit))
                gw.serve(reqs)
                rep = gw.report()
                shed_window = rep["shed_window"]
                shed_deadline = rep["shed_deadline"]
                max_depth = rep["max_queue_depth"]
                # the gateway's invariants, asserted on the live run
                assert max_depth <= queue_limit, rep
                assert expired_dispatches(reqs) == 0, \
                    "gateway dispatched an expired request"
                for r in reqs[-n_doomed:]:
                    assert r.outcome == "shed_deadline", r
                    assert getattr(r, "dispatched", None) is None, r
                ts = [s["t"] for s in gw.telemetry_samples()]
                assert ts == sorted(ts), "telemetry timestamps not monotone"
                assert all(r.outcome in ("completed", "shed_window",
                                         "shed_deadline") for r in reqs)
            wall = time.perf_counter() - t0
            cp = class_percentiles(reqs)
            rows[mode] = build_row(
                mode=mode, requests=len(reqs),
                completed=sum(r.outcome == "completed" for r in reqs),
                shed_window=shed_window, shed_deadline=shed_deadline,
                expired_dispatches=expired_dispatches(reqs),
                max_queue_depth=max_depth,
                interactive_p50_ms=cp["interactive"]["p50_ms"],
                interactive_p99_ms=cp["interactive"]["p99_ms"],
                batch_p50_ms=cp["batch"]["p50_ms"],
                batch_p99_ms=cp["batch"]["p99_ms"], wall_s=wall)
            emit(f"gateway_soak/{mode}_interactive_p99_ms",
                 rows[mode]["interactive_p99_ms"],
                 f"batch_p99={rows[mode]['batch_p99_ms']:.1f}ms;"
                 f"expired_dispatches={rows[mode]['expired_dispatches']};"
                 f"shed_deadline={shed_deadline}")
            engine.close()

        fifo, gw_row = rows["fifo"], rows["gateway"]
        emit("gateway_soak/interactive_p99_speedup_x",
             fifo["interactive_p99_ms"] / max(gw_row["interactive_p99_ms"],
                                              1e-9),
             f"fifo={fifo['interactive_p99_ms']:.1f}ms "
             f"gateway={gw_row['interactive_p99_ms']:.1f}ms")
        # the acceptance signal: on the identical mixed stream the gateway
        # strictly improves interactive tail latency over FIFO
        assert gw_row["interactive_p99_ms"] < fifo["interactive_p99_ms"], \
            rows
        write_bench_json("gateway_soak", {"dry_run": dry_run, "modes": rows})
        return rows
    finally:
        os.unlink(spill.name)
