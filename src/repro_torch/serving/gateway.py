"""SLO-aware serving gateway: priority classes, deadline slack, telemetry
(port of the reference's ``serving/gateway.py``).

The engine's admission window treats every batch the same — FIFO order,
one wait/shed policy. At production scale that is not enough: interactive
requests must not starve behind batch traffic, and a request that cannot
meet its deadline should be shed *before* it burns an executor lane
(OMEGA makes the same case for latency-class isolation; the dataflow-
aware online-scheduling line shows the win comes from ordering the queue
by a cost model rather than arrival order). This module puts a gateway in
front of :class:`~repro_torch.serving.engine.ServingEngine`:

* requests carry a priority class (``interactive`` / ``batch``) and an
  optional **relative** deadline (``Request.deadline_s``);
* the admission queue is ordered by *deadline slack* — ``deadline − now −
  est`` with ``est`` from the router's calibrated ``LatencyCurve``s
  (``CostModelRouter.estimate_seconds``) — plus an aging term so batch
  traffic cannot starve; an interactive request that has waited past
  ``aging_bound_s`` preempts every batch request outright;
* hopeless requests are shed with a distinct ``shed_deadline`` outcome at
  **two** points: immediately at admission when slack is already
  negative, and again at dequeue so a request that went stale while
  queued never occupies an executor;
* live telemetry — queue depth, saturation (``inflight ÷ window``),
  per-class p50/p95/p99 — is buffered as time-series samples and exposed
  through :meth:`ServingGateway.telemetry_stream`, pollable while the
  engine serves.

Every request submitted through the gateway terminates in exactly one of
``{"completed", "shed_window", "shed_deadline"}`` (``Request.outcome``).

Concurrency notes. The gateway owns no threads: dispatch happens on the
submitting thread and on executor-pool threads via future done-callbacks.
The pump is re-entrancy-safe (``Future.add_done_callback`` runs inline
when the future is already done), and the gateway gates dispatch on its
*own* inflight gauge rather than the engine's: the engine notifies hooks
before decrementing its accounting, so gating on ``engine.inflight`` from
a completion callback would dead-stall a full window.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable, Iterator, Optional, Sequence

from repro_torch.serving.engine import ServeMetrics, ServingEngine
from repro_torch.serving.registry import DEFAULT_MODEL

# Keys of `ServingGateway.stats`.
GATEWAY_SCHEMA = ("admitted", "dispatched", "completed", "shed_window",
                  "shed_deadline", "aged_dispatches", "max_queue_depth",
                  "telemetry_samples")

# Keys of every telemetry sample yielded by `telemetry_stream` /
# `telemetry_samples`; the per-class blocks under "classes" carry exactly
# `repro_torch.serving.engine.CLASS_SAMPLE_SCHEMA`.
TELEMETRY_SAMPLE_SCHEMA = ("t", "queue_depth", "inflight", "saturation",
                           "classes")


@dataclasses.dataclass
class GatewayConfig:
    """Tuning knobs of the SLO gateway.

    Attributes:
        queue_limit: admission-queue bound; a submit past it sheds with
            outcome ``shed_window``. The adaptive controller nudges this
            live from observed saturation (``tune_admission``).
        aging_bound_s: wait after which a queued *interactive* request
            preempts every batch request outright (tier promotion) — the
            starvation bound the property tests pin.
        aging_gain: seconds of slack credit per second waited — ages
            *both* classes toward the front so batch traffic drains even
            under a steady interactive flow.
        batch_bias_s: slack handicap added to batch-class requests; ties
            between a fresh interactive and a fresh batch request break
            interactive-first by this margin.
        slack_cap_s: slack assigned to requests without a deadline (and
            cap for very loose deadlines) — keeps no-deadline batch
            traffic reachable by aging instead of infinitely deprioritized.
        default_deadline_s: deadline applied to requests that carry none
            (``None`` = no implied deadline).
        telemetry_capacity: ring-buffer size of the telemetry series.
        telemetry_min_interval_s: minimum spacing between automatic
            samples (0 = sample on every submit/completion).
    """

    queue_limit: int = 256
    aging_bound_s: float = 0.25
    aging_gain: float = 1.0
    batch_bias_s: float = 0.05
    slack_cap_s: float = 30.0
    default_deadline_s: Optional[float] = None
    telemetry_capacity: int = 1024
    telemetry_min_interval_s: float = 0.0


@dataclasses.dataclass(eq=False)
class _Queued:
    """One admitted request waiting for dispatch (identity-compared)."""
    seq: int
    request: object
    model: str
    priority: str
    enqueued: float            # gateway-clock admission time
    deadline: Optional[float]  # ABSOLUTE gateway-clock deadline (or None)
    est: float                 # curve-estimated service seconds


class ServingGateway:
    """Priority/deadline-aware admission in front of a serving engine.

    Ingest one request at a time via :meth:`submit` (or a whole stream via
    :meth:`serve`). The gateway queues admissible requests, orders the
    queue by deadline slack with aging, dispatches one-request batches to
    the engine whenever it holds a free window slot, and sheds hopeless
    requests — at admission and again at dequeue — without ever occupying
    an executor with them. Telemetry is sampled on every submit and
    completion and exposed as a pollable stream.

    Dequeue order is defined by a two-level key, smallest first::

        tier  = 0 if (interactive and waited >= aging_bound_s) else 1
        value = class_bias + min(slack, cap) − aging_gain · waited

    which yields the three properties the test suite pins: interactive
    requests past the aging bound are never passed over for batch work,
    batch work cannot starve (its key decreases linearly with wait), and
    with one class and no deadlines the order degenerates to FIFO.
    """

    def __init__(self, engine: ServingEngine, *,
                 config: Optional[GatewayConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        """Args:
            engine: the serving engine to front (its ``max_inflight`` is
                the dispatch window the gateway fills).
            config: gateway tuning knobs (default :class:`GatewayConfig`).
            clock: zero-arg seconds source; defaults to the engine's clock
                so deadlines and engine timestamps share one domain.
        """
        self.engine = engine
        self.config = config or GatewayConfig()
        self.clock = clock if clock is not None else engine.clock
        self._cv = threading.Condition()
        self._queue: list[_Queued] = []
        self._seq = 0
        self._gw_inflight = 0
        self._pump_active = False
        self._pump_again = False
        self._last_sample_t = float("-inf")
        self._telemetry: collections.deque = collections.deque(
            maxlen=int(self.config.telemetry_capacity))
        self.stats = {"admitted": 0, "dispatched": 0, "completed": 0,
                      "shed_window": 0, "shed_deadline": 0,
                      "aged_dispatches": 0, "max_queue_depth": 0,
                      "telemetry_samples": 0}

    # -- admission -----------------------------------------------------------
    def submit(self, request) -> str:
        """Admit one request: slack-check, enqueue (or shed), pump.

        Stamps ``request.arrival`` with the gateway clock and converts its
        relative ``deadline_s`` to an absolute deadline. Returns the
        admission verdict: ``"queued"``, ``"shed_window"`` (queue at
        ``queue_limit``) or ``"shed_deadline"`` (slack already negative —
        the deadline cannot be met even if dispatched right now).
        """
        cfg = self.config
        now = self.clock()
        request.arrival = now
        model = getattr(request, "model", DEFAULT_MODEL)
        est = self._estimate(request, model)
        dl_rel = getattr(request, "deadline_s", None)
        if dl_rel is None:
            dl_rel = cfg.default_deadline_s
        deadline = (now + float(dl_rel)) if dl_rel is not None else None
        if deadline is not None and deadline - now - est < 0.0:
            self.engine.record_shed([request], model, reason="deadline")
            with self._cv:
                self.stats["shed_deadline"] += 1
            self._maybe_sample()
            return "shed_deadline"
        shed_window = False
        with self._cv:
            if len(self._queue) >= cfg.queue_limit:
                shed_window = True
                self.stats["shed_window"] += 1
            else:
                self._seq += 1
                self._queue.append(_Queued(
                    seq=self._seq, request=request, model=model,
                    priority=getattr(request, "priority", "batch"),
                    enqueued=now, deadline=deadline, est=est))
                self.stats["admitted"] += 1
                depth = len(self._queue)
                if depth > self.stats["max_queue_depth"]:
                    self.stats["max_queue_depth"] = depth
        if shed_window:
            self.engine.record_shed([request], model, reason="window")
            self._maybe_sample()
            return "shed_window"
        self._maybe_sample()
        self.pump()
        return "queued"

    def serve(self, requests: Sequence, *, gap_s: float = 0.0) -> ServeMetrics:
        """Run a whole request stream through the gateway and return the
        engine's run metrics (per-class breakdown included). ``gap_s``
        spaces arrivals for client emulation."""
        metrics = self.engine.begin_run()
        try:
            for r in requests:
                if gap_s:
                    time.sleep(gap_s)
                self.submit(r)
            self.drain()
        finally:
            self.engine.end_run(metrics)
        return metrics

    def _estimate(self, request, model: str) -> float:
        """Curve-based service-time estimate of a request (0.0 when the
        model's router offers none — optimistic, never sheds blind)."""
        router = self.engine.registry.router_for(model)
        fn = getattr(router, "estimate_seconds", None)
        if fn is None:
            return 0.0
        return max(float(fn(request.seeds)), 0.0)

    # -- dispatch ------------------------------------------------------------
    def pump(self) -> int:
        """Dispatch as many queued requests as the window allows; returns
        the number dispatched. Re-entrancy-safe: a call arriving while a
        pump is active (e.g. a future completing inline) flags a re-sweep
        and returns immediately instead of recursing."""
        with self._cv:
            if self._pump_active:
                self._pump_again = True
                return 0
            self._pump_active = True
            self._pump_again = False
        total = 0
        while True:
            try:
                total += self._sweep()
            except BaseException:
                with self._cv:
                    self._pump_active = False
                raise
            with self._cv:
                if self._pump_again:
                    self._pump_again = False
                    continue
                self._pump_active = False
                return total

    def _sweep(self) -> int:
        """One dispatch sweep: shed stale requests, then pop-and-submit the
        best admissible request while window slots are free."""
        n = 0
        while True:
            item: Optional[_Queued] = None
            aged = False
            with self._cv:
                now = self.clock()
                stale = self._pop_stale_locked(now)
                if stale:
                    self.stats["shed_deadline"] += len(stale)
                if (self._queue
                        and self._gw_inflight < self.engine.max_inflight):
                    idx, aged = self._select_locked(now)
                    item = self._queue.pop(idx)
                    self._gw_inflight += 1  # reserve the slot pre-submit
                if not self._queue:
                    self._cv.notify_all()
            for s in stale:
                # dequeue-time re-check: went stale while queued — shed
                # without ever occupying an executor
                self.engine.record_shed([s.request], s.model,
                                        reason="deadline")
            if item is None:
                return n
            item.request.dispatched = self.clock()
            fut = self.engine.submit_batch([item.request])
            if fut is None:
                # engine window raced shut under foreign traffic; the
                # engine already counted the shed — release our slot
                with self._cv:
                    self._gw_inflight -= 1
                    self.stats["shed_window"] += 1
                continue
            with self._cv:
                self.stats["dispatched"] += 1
                if aged:
                    self.stats["aged_dispatches"] += 1
            n += 1
            fut.add_done_callback(self._on_dispatched_done)

    def _on_dispatched_done(self, fut: Future) -> None:
        """Completion callback of a gateway-dispatched batch: release the
        window slot, count, sample telemetry, re-pump. Runs *after* the
        engine's own accounting (callbacks fire in registration order)."""
        ok = fut.exception() is None
        with self._cv:
            self._gw_inflight -= 1
            if ok:
                self.stats["completed"] += 1
            self._cv.notify_all()
        self._maybe_sample()
        self.pump()

    def _select_locked(self, now: float) -> tuple[int, bool]:
        """Index of the next request to dispatch under the slack+aging
        order, and whether it won by aging-tier promotion. Called with the
        lock held; the queue must be non-empty."""
        best_key, best_i, best_aged = None, 0, False
        for i, item in enumerate(self._queue):
            key, aged = self._order_key(item, now)
            if best_key is None or key < best_key:
                best_key, best_i, best_aged = key, i, aged
        return best_i, best_aged

    def _pop_stale_locked(self, now: float) -> list[_Queued]:
        """Remove and return queued requests whose slack went negative
        while waiting. Called with the lock held."""
        stale = [it for it in self._queue
                 if it.deadline is not None
                 and it.deadline - now - it.est < 0.0]
        if stale:
            dead = {id(it) for it in stale}
            self._queue = [it for it in self._queue if id(it) not in dead]
        return stale

    def _order_key(self, item: _Queued, now: float) -> tuple[tuple, bool]:
        """Dequeue sort key of one queued request (see class docstring)."""
        cfg = self.config
        wait = now - item.enqueued
        interactive = item.priority == "interactive"
        aged = interactive and wait >= cfg.aging_bound_s
        slack = (item.deadline - now - item.est
                 if item.deadline is not None else cfg.slack_cap_s)
        slack = min(slack, cfg.slack_cap_s)
        bias = 0.0 if interactive else cfg.batch_bias_s
        tier = 0 if aged else 1
        return (tier, bias + slack - cfg.aging_gain * wait, item.seq), aged

    def drain(self) -> None:
        """Block until the queue is empty (everything dispatched or shed),
        then drain the engine — on return every submitted request carries
        a terminal ``outcome``."""
        self.pump()
        with self._cv:
            self._cv.wait_for(lambda: not self._queue)
        self.engine.drain()

    # -- telemetry -----------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        """Requests currently queued (admitted, not yet dispatched)."""
        with self._cv:
            return len(self._queue)

    def sample_telemetry(self) -> dict:
        """Record and return one telemetry sample (keys
        ``TELEMETRY_SAMPLE_SCHEMA``): queue depth, engine inflight and
        saturation, per-class latency percentiles. Timestamps across the
        buffered series are monotone non-decreasing."""
        classes = self.engine.class_summaries()
        inflight = self.engine.inflight
        saturation = self.engine.saturation
        with self._cv:
            sample = {"t": self.clock(), "queue_depth": len(self._queue),
                      "inflight": inflight, "saturation": saturation,
                      "classes": classes}
            self._telemetry.append(sample)
            self.stats["telemetry_samples"] += 1
            self._last_sample_t = sample["t"]
            self._cv.notify_all()
        return sample

    def _maybe_sample(self) -> None:
        """Auto-sample unless within ``telemetry_min_interval_s`` of the
        previous sample."""
        with self._cv:
            due = (self.clock() - self._last_sample_t
                   >= self.config.telemetry_min_interval_s)
        if due:
            self.sample_telemetry()

    def telemetry_samples(self) -> list[dict]:
        """Snapshot of the buffered telemetry series (oldest first)."""
        with self._cv:
            return list(self._telemetry)

    def telemetry_stream(self, *, stop: Optional[Callable[[], bool]] = None,
                         poll_s: float = 0.05) -> Iterator[dict]:
        """Stream telemetry samples as they are recorded — the pollable
        endpoint. Yields every new sample; between samples it waits up to
        ``poll_s`` on the gateway condition. Ends when ``stop()`` returns
        true with no samples pending; without ``stop`` the iterator is
        infinite (consume it from its own thread)."""
        seen = 0
        while True:
            with self._cv:
                total = self.stats["telemetry_samples"]
                if total > seen:
                    take = min(total - seen, len(self._telemetry))
                    fresh = list(self._telemetry)[-take:]
                    seen = total
                elif stop is not None and stop():
                    return
                else:
                    self._cv.wait(poll_s)
                    continue
            for sample in fresh:
                yield sample

    def report(self) -> dict:
        """Gateway counters plus the live queue depth and saturation."""
        with self._cv:
            out = dict(self.stats)
            out["queue_depth"] = len(self._queue)
        out["saturation"] = self.engine.saturation
        return out
