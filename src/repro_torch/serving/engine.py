"""Executor-graph serving engine (paper §4.3): numpy port of the
reference's ``serving/engine.py``.

The engine serves a :class:`~repro_torch.serving.registry.ModelRegistry`.
Each closed batch becomes a future on the chosen executor's worker lanes:

(1) *Multiplexing pipelines in a processor* — every executor runs
    ``capacity`` concurrent lanes.
(2) *Shared queue* — admission is one bounded window over all executors:
    when ``max_inflight`` batches are outstanding the engine blocks the
    producer (``admission="wait"``) or drops the batch (``"shed"``,
    counted in ``ServeMetrics.shed``).
(3) *Shared graph* — topology and feature stores are read-only singletons
    captured by the executors.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Iterable, Mapping, Optional, Sequence

import numpy as np

from repro_torch import trace
from repro_torch.serving.executors import Executor
from repro_torch.serving.registry import DEFAULT_MODEL, ModelEntry, ModelRegistry


def _batch_seeds(batch: Sequence) -> np.ndarray:
    return np.concatenate([r.seeds for r in batch])


def _batch_model(batch: Sequence) -> str:
    """Model tag of a closed batch; every request must agree (micro-batches
    and batches never mix models — mixing would make the per-model routing
    decision meaningless)."""
    model = getattr(batch[0], "model", DEFAULT_MODEL)
    for r in batch[1:]:
        other = getattr(r, "model", DEFAULT_MODEL)
        if other != model:
            raise ValueError(f"batch mixes models {model!r} and {other!r}; "
                             f"batchers must never coalesce across models")
    return model


def _clone_stage(stage):
    """Fresh same-config instance of a batching stage (``clone()``); multi-
    model streams need one stage per model so batches never mix models."""
    clone = getattr(stage, "clone", None)
    if clone is None:
        raise TypeError(
            f"{type(stage).__name__} has no clone(); multi-model streams "
            f"need one batching stage per model")
    return clone()


class MicroBatcher:
    """PSGS-aware micro-batching stage between the request batcher and the
    executor graph.

    The fused feature-collection path (``TieredFeatureStore.lookup_hops``)
    amortizes its one-dispatch-per-tier cost over the *unique* ids of a
    sample, so it pays off most when batches are large enough for hop
    frontiers to overlap. Under light load the ``DynamicBatcher`` closes
    small batches (its deadline is per-request); this stage coalesces those
    closed batches into gather-friendly super-batches under a second
    latency deadline.

    A super-batch closes when (a) its accumulated seed count reaches
    ``max_seeds``, (b) its accumulated PSGS reaches ``psgs_budget`` (the
    workload-aware bound — processing cost, not request count), or (c) the
    coalescing deadline since the first queued request has expired.
    Like ``DynamicBatcher``, the deadline is evaluated at ``add`` time —
    an expired super-batch is emitted when the NEXT batch arrives (or at
    the stream-end ``flush``), so on sparse streams the realized wait can
    reach the inter-arrival gap, not ``deadline_s``. Size ``deadline_s``
    against the expected arrival rate, or skip the stage for latency-
    critical sparse traffic.

    Super-batches never mix models: ``serve_stream`` keeps one clone per
    model, and ``add`` additionally emits the pending super-batch whenever
    an incoming batch carries a different model tag (defense in depth for
    callers driving one instance by hand). ``deadline_s``/``max_seeds`` may
    be re-assigned live (single reference writes) — the adaptive
    controller's micro-batch auto-tuning does exactly that.
    """

    def __init__(self, *, deadline_s: float = 0.004, max_seeds: int = 256,
                 psgs_budget: Optional[float] = None,
                 psgs_table: Optional[np.ndarray] = None,
                 clock: Callable[[], float] = time.monotonic):
        """Args:
            deadline_s: max time a closed batch may wait for company.
            max_seeds: seed-count bound of a super-batch.
            psgs_budget: accumulated-PSGS bound (needs ``psgs_table``);
                ``None`` disables the workload-aware close condition.
            psgs_table: ``(N,)`` per-seed PSGS table for the budget.
            clock: zero-arg seconds source for the coalescing deadline
                (injectable — tests pass a fake clock).
        """
        self.deadline_s = float(deadline_s)
        self.max_seeds = int(max_seeds)
        self.psgs_budget = psgs_budget
        self.psgs_table = psgs_table
        self.clock = clock
        self._pending: list = []
        self._opened: Optional[float] = None
        self._model: Optional[str] = None
        self._sources = 0
        self._n_seeds = 0
        self._acc_psgs = 0.0
        self.emitted = 0      # super-batches emitted
        self.coalesced = 0    # emitted super-batches built from >1 batch

    def clone(self) -> "MicroBatcher":
        """Fresh empty stage with the same bounds — ``serve_stream`` clones
        one per model so super-batches never coalesce across models.
        Built via ``type(self)`` so subclasses stay subclasses (override
        when a subclass adds constructor arguments)."""
        return type(self)(deadline_s=self.deadline_s,
                          max_seeds=self.max_seeds,
                          psgs_budget=self.psgs_budget,
                          psgs_table=self.psgs_table,
                          clock=self.clock)

    def add(self, batch: list) -> Optional[list]:
        """Queue one closed batch; return a super-batch if a bound was hit.

        Args:
            batch: a closed request batch (non-empty list of requests,
                all carrying the same ``model`` tag).

        Returns:
            The coalesced super-batch when seed-count / PSGS / deadline
            closed it — or the *previous* pending super-batch when
            ``batch`` carries a different model tag (the incoming batch is
            then queued fresh; super-batches never mix models). ``None``
            when the batch is held for coalescing.
        """
        model = _batch_model(batch)
        flushed = None
        if self._pending and model != self._model:
            flushed = self.flush()
        now = self.clock()
        if self._opened is None:
            self._opened = now
        self._model = model
        self._pending.extend(batch)
        self._sources += 1
        self._n_seeds += sum(int(r.seeds.size) for r in batch)
        if self.psgs_table is not None:
            for r in batch:
                self._acc_psgs += float(
                    self.psgs_table[r.seeds[r.seeds >= 0]].sum())
        if flushed is not None:
            # the model boundary already emitted a super-batch this call;
            # the fresh batch's own bounds are evaluated on the next add
            # (or the stream-end flush)
            return flushed
        full = self._n_seeds >= self.max_seeds
        over_budget = (self.psgs_budget is not None
                       and self._acc_psgs >= self.psgs_budget)
        expired = now - self._opened >= self.deadline_s
        if full or over_budget or expired:
            return self.flush()
        return None

    def flush(self) -> Optional[list]:
        """Emit whatever is queued (``None`` when empty)."""
        if not self._pending:
            return None
        out, self._pending = self._pending, []
        self.emitted += 1
        if self._sources > 1:
            self.coalesced += 1
        self._opened, self._sources, self._model = None, 0, None
        self._n_seeds, self._acc_psgs = 0, 0.0
        return out


@dataclasses.dataclass
class ModelStats:
    """Per-model slice of :class:`ServeMetrics`: requests, shed, latencies,
    routing tallies, and per-executor service times (lane queueing +
    processing, keyed by executor name)."""

    requests: int = 0
    shed: int = 0
    shed_deadline: int = 0
    latencies: list[float] = dataclasses.field(default_factory=list)
    routed: dict[str, int] = dataclasses.field(default_factory=dict)
    exec_latencies: dict[str, list[float]] = dataclasses.field(
        default_factory=dict)

    def percentile(self, q: float) -> float:
        """Latency quantile over this model's completed requests (0.0 when
        none completed)."""
        if not self.latencies:
            return 0.0
        return float(np.quantile(np.asarray(self.latencies), q))

    def summary(self) -> dict:
        """Per-model report block (requests/shed, p50/p99, routing)."""
        return {"requests": self.requests, "shed": self.shed,
                "shed_deadline": self.shed_deadline,
                "p50_ms": self.percentile(0.5) * 1e3,
                "p99_ms": self.percentile(0.99) * 1e3,
                "routed": dict(self.routed)}


# Pinned key set of every per-priority-class block — `ClassStats.summary()`
# and the `classes` entries of gateway telemetry samples both carry exactly
# these keys (cross-checked by quiverlint's schema pass against the marked
# table in docs/invariants.md and by tests/test_gateway.py).
CLASS_SAMPLE_SCHEMA = ("requests", "shed_window", "shed_deadline",
                       "p50_ms", "p95_ms", "p99_ms")


@dataclasses.dataclass
class ClassStats:
    """Per-priority-class slice of :class:`ServeMetrics` (SLO view): how
    many requests of this class completed, how many were shed at the
    admission window vs. for a hopeless deadline, and the class's latency
    distribution. Keys of :meth:`summary` are pinned by
    ``CLASS_SAMPLE_SCHEMA``."""

    requests: int = 0
    shed_window: int = 0
    shed_deadline: int = 0
    latencies: list[float] = dataclasses.field(default_factory=list)

    def percentile(self, q: float) -> float:
        """Latency quantile over this class's completed requests (0.0 when
        none completed)."""
        if not self.latencies:
            return 0.0
        return float(np.quantile(np.asarray(self.latencies), q))

    def summary(self) -> dict:
        """Per-class report block — keys exactly ``CLASS_SAMPLE_SCHEMA``."""
        return {"requests": self.requests,
                "shed_window": self.shed_window,
                "shed_deadline": self.shed_deadline,
                "p50_ms": self.percentile(0.5) * 1e3,
                "p95_ms": self.percentile(0.95) * 1e3,
                "p99_ms": self.percentile(0.99) * 1e3}


def _exec_key(model: str, name: str) -> str:
    """Executor key in the flat per-executor breakdown: bare name for the
    single-model default, ``model/name`` otherwise."""
    return name if model == DEFAULT_MODEL else f"{model}/{name}"


@dataclasses.dataclass
class ServeMetrics:
    latencies: list[float] = dataclasses.field(default_factory=list)
    started: float = 0.0
    finished: float = 0.0
    requests: int = 0
    shed: int = 0
    shed_deadline: int = 0
    routed: dict[str, int] = dataclasses.field(default_factory=dict)
    # per-model breakdowns (aggregate fields above are preserved: they sum
    # over models, and executor names repeated across models merge in
    # ``routed``); ``store_stats`` carries the shared stores' fused-gather
    # dispatch counters snapshotted at the end of the run; ``classes`` the
    # per-priority-class SLO breakdown (gateway traffic — plain runs land
    # everything in the default "batch" class)
    models: dict[str, ModelStats] = dataclasses.field(default_factory=dict)
    classes: dict[str, ClassStats] = dataclasses.field(default_factory=dict)
    store_stats: dict[str, dict] = dataclasses.field(default_factory=dict)

    def model(self, name: str) -> ModelStats:
        """This model's stats slice (created on first touch)."""
        return self.models.setdefault(name, ModelStats())

    def for_class(self, name: str) -> ClassStats:
        """This priority class's stats slice (created on first touch)."""
        return self.classes.setdefault(name, ClassStats())

    # backwards-compatible views of the two-executor counters
    @property
    def routed_host(self) -> int:
        return self.routed.get("host", 0)

    @property
    def routed_device(self) -> int:
        return self.routed.get("device", 0)

    @property
    def throughput(self) -> float:
        dur = max(self.finished - self.started, 1e-9)
        return self.requests / dur

    def percentile(self, q: float) -> float:
        # all-shed runs have no completed latencies; report 0.0 like
        # summary() does instead of crashing on an empty quantile
        if not self.latencies:
            return 0.0
        return float(np.quantile(np.asarray(self.latencies), q))

    def executor_percentiles(self) -> dict[str, dict]:
        """Per-executor service-time percentiles (lane queueing +
        processing, seconds → ms), keyed ``name`` for the default model and
        ``model/name`` otherwise."""
        out: dict[str, dict] = {}
        for model, ms in self.models.items():
            for name, lats in ms.exec_latencies.items():
                if not lats:
                    continue
                arr = np.asarray(lats)
                out[_exec_key(model, name)] = {
                    "batches": int(arr.size),
                    "p50_ms": float(np.quantile(arr, 0.5) * 1e3),
                    "p99_ms": float(np.quantile(arr, 0.99) * 1e3)}
        return out

    def summary(self) -> dict:
        # no completed requests (e.g. everything shed): report a zeroed
        # profile, NOT a perfect one — pct_in_400ms must not claim SLO wins
        served = bool(self.latencies)
        lat = np.asarray(self.latencies if served else [0.0])
        return {"requests": self.requests,
                "throughput_rps": self.throughput,
                "p50_ms": float(np.quantile(lat, 0.5) * 1e3),
                "p99_ms": float(np.quantile(lat, 0.99) * 1e3),
                "max_ms": float(lat.max() * 1e3),
                "pct_in_400ms": float((lat < 0.4).mean()) if served else 0.0,
                "shed": self.shed,
                "shed_deadline": self.shed_deadline,
                "routed": dict(self.routed),
                "routed_host": self.routed_host,
                "routed_device": self.routed_device,
                "models": {m: s.summary() for m, s in self.models.items()},
                "classes": {c: s.summary() for c, s in self.classes.items()},
                "executors": self.executor_percentiles(),
                "store": {k: dict(v) for k, v in self.store_stats.items()}}


class ServingEngine:
    """End-to-end GNN serving over a registry of models sharing the stores.

    Construction accepts either the single-model parts —
    ``ServingEngine(executors, router)`` where ``executors`` maps name →
    executor (or is an iterable of executors keyed by their ``name``) and
    ``router.route(seeds)`` returns a registered name — or a
    :class:`~repro_torch.serving.registry.ModelRegistry`
    (``ServingEngine(registry)``). The single-model form is exactly the
    1-entry-registry special case: requests default to
    ``model="default"``. Admission (``max_inflight``) is global across
    models — one capacity bound over the shared hardware — while routing
    and metrics are per model.
    """

    def __init__(self,
                 executors: (Mapping[str, Executor] | Iterable[Executor]
                             | ModelRegistry | None) = None,
                 router=None, *, registry: Optional[ModelRegistry] = None,
                 max_inflight: int = 64, admission: str = "wait",
                 hooks: Sequence = (),
                 clock: Callable[[], float] = time.monotonic):
        if isinstance(executors, ModelRegistry):
            if router is not None or registry is not None:
                raise ValueError("pass either a ModelRegistry or "
                                 "(executors, router), not both")
            registry = executors
        elif registry is None:
            if executors is None or router is None:
                raise ValueError("ServingEngine needs (executors, router) "
                                 "or a ModelRegistry")
            registry = ModelRegistry.single(executors, router)
        elif executors is not None or router is not None:
            raise ValueError("pass either registry= or (executors, router), "
                             "not both")
        if not len(registry):
            raise ValueError("at least one model is required")
        if admission not in ("wait", "shed"):
            raise ValueError(f"admission must be 'wait' or 'shed', "
                             f"got {admission!r}")
        self.registry = registry
        self.admission = admission
        # telemetry hooks (e.g. serving.adaptive.AdaptiveController): called
        # with every admitted batch and every completion — the feed for
        # online FAP re-placement and latency-curve refitting. Hooks may
        # accept (name, seeds[, model]) — the model tag is passed when the
        # hook's signature takes it.
        self.hooks = list(hooks)
        # injectable seconds source: every timestamp the engine takes
        # (arrival re-stamps, submit/complete times, run bounds) comes from
        # here, so deadline tests drive a fake clock instead of sleeping
        self.clock = clock
        self.max_inflight = int(max_inflight)
        self._window = threading.BoundedSemaphore(self.max_inflight)
        self._lock = threading.Lock()
        # drain() synchronizes on this counter, not on the futures:
        # done-callbacks run *after* future waiters wake, so waiting on the
        # futures could observe metrics/errors before _complete recorded them
        self._acct = threading.Condition()
        self._inflight_batches = 0
        self._error: Optional[BaseException] = None
        self._metrics = ServeMetrics()

    # -- registry ------------------------------------------------------------
    @property
    def executors(self) -> dict[str, Executor]:
        """The default model's executor registry (single-model view). Multi-
        model callers address executors through ``registry`` instead."""
        return self.registry.get(DEFAULT_MODEL).executors

    @property
    def router(self):
        """The default model's router (single-model view)."""
        return self.registry.get(DEFAULT_MODEL).router

    def register(self, executor: Executor,
                 model: str = DEFAULT_MODEL) -> "ServingEngine":
        """Add (or replace) an executor under its ``name`` in ``model``'s
        entry; returns the engine for chaining. The model's router must know
        the name before a batch can be routed there."""
        self.registry.get(model).executors[executor.name] = executor
        return self

    def add_hook(self, hook) -> "ServingEngine":
        """Attach a telemetry hook. Optional methods, all best-effort:
        ``on_admit(name, seeds[, model])`` after a batch is admitted and
        routed, ``on_batch_complete(name, seeds, latency_s[, model])``
        after it finishes — the trailing model tag is passed only when the
        hook's signature accepts it."""
        self.hooks.append(hook)
        return self

    def _notify(self, method: str, *args) -> None:
        for h in self.hooks:
            fn = getattr(h, method, None)
            if fn is None:
                continue
            try:
                _call_adaptive(fn, args)
            except BaseException as exc:  # surface hook bugs via drain()
                with self._lock:
                    if self._error is None:
                        self._error = exc

    # -- per-batch futures ---------------------------------------------------
    def submit_batch(self, batch: list) -> Optional[Future]:
        """Route one closed batch and submit it to its model's executor.

        The batch's ``model`` tag (uniform across its requests — mixing
        raises) selects the registry entry whose router and executors serve
        it; requests without a tag take the default model.

        Returns the future of the model output, or ``None`` when the
        admission window is full and the policy is ``"shed"`` (the batch is
        dropped and counted in ``ServeMetrics.shed``, aggregate and
        per-model).
        """
        if not batch:
            raise ValueError("submit_batch needs a non-empty batch")
        model = _batch_model(batch)
        entry = self.registry.get(model)
        with trace.span("admit"):
            admitted = self._window.acquire(
                blocking=self.admission == "wait")
        if not admitted:
            self.record_shed(batch, model)
            return None
        with self._lock:         # bind this run: stragglers from a failed
            metrics = self._metrics  # run must not pollute the next run
        with self._acct:
            self._inflight_batches += 1
        name = None
        try:
            # route only admitted batches, so router.routed matches executed
            # work and load-aware estimates see post-admission inflight
            seeds = _batch_seeds(batch)
            with trace.span("route"):
                name = entry.router.route(seeds)
                if trace.on:
                    trace.note(executor=name, batch=trace.new_batch())
            submitted_at = self.clock()
            fut = entry.executors[name].submit(seeds)
        except BaseException:
            if name is not None:
                # the router already counted this batch but the executor
                # never accepted it — roll the count back so router.routed
                # keeps matching work that actually executed
                routed = getattr(entry.router, "routed", None)
                if isinstance(routed, dict) and routed.get(name, 0) > 0:
                    routed[name] -= 1
            self._window.release()
            self._finish_one()
            raise
        self._notify("on_admit", name, seeds, model)
        fut.add_done_callback(
            lambda f: self._complete(f, batch, name, model, metrics, seeds,
                                     submitted_at))
        return fut

    def record_shed(self, batch: Sequence, model: Optional[str] = None, *,
                    reason: str = "window") -> None:
        """Count a rejected batch in the current run's metrics and stamp
        every request's ``outcome``.

        ``reason="window"`` is the admission-window drop (counted in
        ``shed``, outcome ``shed_window``); ``reason="deadline"`` is the
        SLO-aware gateway's hopeless-slack drop (counted in
        ``shed_deadline``, outcome ``shed_deadline`` — the request never
        occupied an executor). Both also land in the per-model and
        per-priority-class breakdowns.
        """
        if reason not in ("window", "deadline"):
            raise ValueError(f"reason must be 'window' or 'deadline', "
                             f"got {reason!r}")
        if model is None:
            model = _batch_model(batch)
        with self._lock:
            metrics = self._metrics
            ms = metrics.model(model)
            for r in batch:
                cs = metrics.for_class(getattr(r, "priority", "batch"))
                if reason == "deadline":
                    metrics.shed_deadline += 1
                    ms.shed_deadline += 1
                    cs.shed_deadline += 1
                    r.outcome = "shed_deadline"
                else:
                    metrics.shed += 1
                    ms.shed += 1
                    cs.shed_window += 1
                    r.outcome = "shed_window"

    def _complete(self, fut: Future, batch: list, name: str, model: str,
                  metrics: ServeMetrics, seeds: np.ndarray,
                  submitted_at: float) -> None:
        self._window.release()
        now = self.clock()
        with self._lock:
            if fut.exception() is not None:
                if self._error is None:
                    self._error = fut.exception()
            else:
                ms = metrics.model(model)
                for r in batch:
                    r.done = now
                    r.outcome = "completed"
                    metrics.latencies.append(r.latency)
                    ms.latencies.append(r.latency)
                    cs = metrics.for_class(getattr(r, "priority", "batch"))
                    cs.requests += 1
                    cs.latencies.append(r.latency)
                metrics.requests += len(batch)
                metrics.routed[name] = metrics.routed.get(name, 0) + 1
                ms.requests += len(batch)
                ms.routed[name] = ms.routed.get(name, 0) + 1
                ms.exec_latencies.setdefault(name, []).append(
                    now - submitted_at)
        if fut.exception() is None:
            # per-batch service time (lane queueing + processing): the live
            # counterpart of the offline calibration samples
            self._notify("on_batch_complete", name, seeds,
                         now - submitted_at, model)
        self._finish_one()

    def _finish_one(self) -> None:
        with self._acct:
            self._inflight_batches -= 1
            self._acct.notify_all()

    def drain(self) -> None:
        """Wait until every outstanding batch — including its metrics
        accounting — has finished; then re-raise the first executor failure
        (the old thread-pool loop swallowed them)."""
        with self._acct:
            self._acct.wait_for(lambda: self._inflight_batches == 0)
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    # -- live load view (the gateway's dispatch gate + telemetry feed) -------
    @property
    def inflight(self) -> int:
        """Batches admitted but not yet fully accounted (monotonic view of
        the admission window's occupancy)."""
        with self._acct:
            return self._inflight_batches

    @property
    def saturation(self) -> float:
        """``inflight ÷ max_inflight`` — 1.0 means the window is full and
        the next submit blocks or sheds."""
        return self.inflight / max(self.max_inflight, 1)

    def class_summaries(self) -> dict[str, dict]:
        """Live per-priority-class blocks of the current run (keys of each
        block are ``CLASS_SAMPLE_SCHEMA``) — safe to poll mid-run."""
        with self._lock:
            return {c: cs.summary() for c, cs in self._metrics.classes.items()}

    # -- serving loops (drop-in for the old pipeline API) --------------------
    def _reset(self) -> ServeMetrics:
        metrics = ServeMetrics()
        metrics.started = self.clock()
        with self._lock:
            self._metrics = metrics
        return metrics

    def begin_run(self) -> ServeMetrics:
        """Open a fresh measured run and return its metrics object — for
        callers (the gateway, by-hand tests) that drive ``submit_batch``
        directly instead of through :meth:`run`/:meth:`serve_stream`."""
        return self._reset()

    def end_run(self, metrics: ServeMetrics) -> ServeMetrics:
        """Close a run opened with :meth:`begin_run`: stamp the wall-clock
        end and snapshot the shared stores' dispatch counters."""
        metrics.finished = self.clock()
        metrics.store_stats = self._store_stats()
        return metrics

    def _store_stats(self) -> dict[str, dict]:
        """Snapshot of the shared stores' dispatch counters (deduplicated by
        identity — every model's executors read the same stores). Keys are
        ``<StoreClass>`` (``#i``-suffixed only if several distinct stores of
        one class are in play). Each snapshot additionally carries
        ``collect_mode``: the feature-collection path(s) the executors
        actually take for that store (``fuse_aggregate`` / ``fused`` /
        ``per_hop``, ``+``-joined when executors disagree) — so a
        silently-downgraded flag is visible in telemetry."""
        out: dict[str, dict] = {}
        keys: dict[int, str] = {}
        modes: dict[str, set] = {}
        for _model, _name, ex in self.registry.all_executors():
            get_stores = getattr(ex, "stores", None)
            stores = (get_stores() if get_stores else
                      [s for s in (getattr(ex, "store", None),
                                   getattr(ex, "sstore", None)) if s])
            for store in stores:
                stats = getattr(store, "stats", None)
                if stats is None:
                    continue
                key = keys.get(id(store))
                if key is None:
                    key = type(store).__name__
                    if key in out:
                        key = f"{key}#{sum(k.startswith(key) for k in out)}"
                    keys[id(store)] = key
                    out[key] = dict(stats)
                    modes[key] = set()
                mode = getattr(ex, "collect_mode", None)
                if mode is not None:
                    modes[key].add(mode(store))
        for key, ms in modes.items():
            out[key]["collect_mode"] = "+".join(sorted(ms)) if ms else "n/a"
        return out

    def serve_stream(self, requests: Sequence, batcher, *, gap_s: float = 0.0,
                     micro: Optional[MicroBatcher] = None) -> ServeMetrics:
        """Client-stream serving: requests arrive one by one (``gap_s``
        apart), the DynamicBatcher closes batches by deadline / PSGS budget /
        max size, and closed batches are admitted to the executor graph
        (paper §4.2.2).

        Batching state is per model: the passed ``batcher`` (and ``micro``)
        serve the first model seen on the stream, and every further model
        tag gets its own ``clone()`` — batches and super-batches never
        coalesce across models, and the stream-end drain flushes *every*
        model's batcher and micro-batcher (a tail batch below the PSGS
        budget is never dropped).

        Args:
            requests: request stream (anything yielding ``Request``-like
                objects with ``seeds``/``arrival``; an optional ``model``
                tag selects the registry entry, defaulting to the single
                model).
            batcher: batch closer (``DynamicBatcher`` protocol:
                ``add(request)`` / ``flush()``; must also offer ``clone()``
                when the stream carries several models).
            gap_s: inter-arrival gap, client emulation.
            micro: optional :class:`MicroBatcher` coalescing stage — closed
                batches are held (deadline evaluated on the next arrival;
                see the class docstring for sparse-stream caveats) and
                merged into gather-friendly super-batches before admission,
                so the fused feature path sees large unique-id sets.

        Returns:
            The run's :class:`ServeMetrics` (latencies include any
            micro-batching wait, since arrival is stamped at ingest).
        """
        metrics = self._reset()
        batchers: dict[str, Any] = {}
        micros: dict[str, MicroBatcher] = {}

        def stages(model: str):
            if model not in batchers:
                batchers[model] = (batcher if not batchers
                                   else _clone_stage(batcher))
                if micro is not None:
                    micros[model] = (micro if not micros
                                     else _clone_stage(micro))
            return batchers[model], micros.get(model)

        try:
            for r in requests:
                if gap_s:
                    time.sleep(gap_s)
                r.arrival = self.clock()
                b, m = stages(getattr(r, "model", DEFAULT_MODEL))
                out = b.add(r)
                if out and m is not None:
                    out = m.add(out)
                if out:
                    self.submit_batch(out)
            # stream-end drain: flush per model — the batcher tail passes
            # through that model's micro stage, then the micro stage itself
            # is flushed, so no tail super-batch below the PSGS budget is
            # ever dropped
            for model, b in batchers.items():
                m = micros.get(model)
                tail = b.flush()
                if tail and m is not None:
                    tail = m.add(tail)
                if tail:
                    self.submit_batch(tail)
                if m is not None:
                    tail = m.flush()
                    if tail:
                        self.submit_batch(tail)
            self.drain()
        finally:
            # stamp even when drain() re-raises an executor failure, so a
            # partially-failed run reports throughput over real wall time
            # instead of dividing by finished=0
            self.end_run(metrics)
        return metrics

    def run(self, batches: Sequence[list], *,
            pace_s: Optional[float] = None) -> ServeMetrics:
        """Process pre-formed batches (each single-model; the ``model`` tag
        of its requests selects the registry entry). ``pace_s`` spaces
        arrivals (client-stream emulation) and re-stamps request arrival at
        submit time so latency = queueing + processing."""
        metrics = self._reset()
        try:
            for b in batches:
                if pace_s:
                    time.sleep(pace_s)
                now = self.clock()
                for r in b:
                    r.arrival = now
                self.submit_batch(b)
            self.drain()
        finally:
            self.end_run(metrics)
        return metrics

    def warmup(self, batch, *, rounds: int = 2) -> None:
        """Compile/warm every registered executor of every model outside the
        measured window. Accepts a request batch or a raw seed array."""
        seeds = (np.asarray(batch) if isinstance(batch, np.ndarray)
                 else _batch_seeds(batch))
        for _model, _name, ex in self.registry.all_executors():
            for _ in range(rounds):
                ex.run(seeds)

    def close(self) -> None:
        """Shut down every executor's worker pool across all models
        (blocking; executors shared between entries close once)."""
        seen: set[int] = set()
        for _model, _name, ex in self.registry.all_executors():
            if id(ex) in seen:
                continue
            seen.add(id(ex))
            close = getattr(ex, "close", None)
            if close:
                close()


@functools.lru_cache(maxsize=256)
def _max_positional(fn) -> Optional[int]:
    """Positional arity of a hook callable (``None`` = unbounded/unknown).
    Cached — signature inspection is pure in the callable, and this runs on
    the per-batch hot path (twice per batch per hook); bound methods of one
    object hash/compare equal across ``getattr`` calls, so the cache hits."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return None
    if any(p.kind is inspect.Parameter.VAR_POSITIONAL for p in params):
        return None
    return sum(p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                          inspect.Parameter.POSITIONAL_OR_KEYWORD)
               for p in params)


def _call_adaptive(fn, args: tuple):
    """Call a hook with as many of ``args`` as its signature accepts —
    pre-multi-model hooks keep their ``(name, seeds[, latency])`` arity,
    model-aware hooks get the trailing model tag too."""
    n = _max_positional(fn)
    return fn(*(args if n is None else args[:n]))
