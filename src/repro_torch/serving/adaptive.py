"""Online workload adaptation: live FAP re-placement + router drift refit
(port of the reference's ``serving/adaptive.py``).

The paper computes its workload metrics offline: FAP ranks features once,
the placement plan and the per-executor latency curves are frozen at
startup. A drifting request mix (a hot subgraph emerging at serve time)
leaves the feature tiers and routing thresholds stale. This module closes
the loop, in the spirit of OMEGA's serve-time recomputation
(arXiv:2501.08547) and data-driven online GNN scheduling (arXiv:2411.16342):

  FrequencySketch       decayed seed-access counts, fed by the engine on
                        every admitted batch (``on_admit`` hook).
  AdaptiveController    periodically (every ``interval_batches`` completions)
                        (a) recomputes FAP with the *empirical* seed
                        distribution, (b) derives the target placement,
                        (c) migrates a bounded number of rows between the
                        HOT/WARM/HOST tiers of the live TieredFeatureStore
                        (swap-based — serving never pauses, lookups stay
                        bit-identical), (d) refits LatencyCurves from live
                        ``(psgs, latency)`` samples — *per model*, swapping
                        them into that model's CostModelRouter when the
                        measured drift exceeds a threshold — (e)
                        optionally nudges an attached MicroBatcher's
                        ``deadline_s``/``max_seeds`` toward the measured
                        knee of the live latency curve (micro-batch
                        auto-tuning, clamped to configured bounds), and (f)
                        promotes miss-hammered DISK rows and re-stages an
                        attached Prefetcher's device-side buffer with the
                        fresh FAP as the prediction score (cold-tier reads
                        leave the request critical path), and (g) sizes the
                        store's device cache capacity, the prefetch staging
                        budget and the refresh cadence from the measured
                        cold working set (``tune_cold_path`` — clamped to
                        bounds, so sizing stays bounded under any sketch).

Multi-model serving shares ONE sketch (FAP placement is store-wide — every
model reads the same feature rows) but keeps latency samples and curve
refits per ``(model, executor)``: two models over the same store have
different curves, so their refits must never blend.

Wire-up::

    controller = AdaptiveController(graph, fanouts, store, router,
                                    psgs_table=psgs)
    engine = ServingEngine(executors, router, hooks=[controller])

or, multi-model (``registry`` is a ModelRegistry)::

    controller = AdaptiveController(graph, fanouts, store,
                                    registry.routers(), psgs_table=psgs)
    engine = ServingEngine(registry, hooks=[controller])

FAP is recomputed on the store's device. On the card its segment sums are
``index_add_`` with atomics, so last bits may differ from run to run and
flip near-ties in the target plan: which rows move may vary, what a lookup
returns never does (rows travel with their nodes).

The controller runs its control step inline on the completion-callback
thread that crossed the period boundary: that one lane stalls for the
recompute (O(edges) FAP pass + a migration bounded by ``rows_per_step``),
while every other lane's callbacks — and every concurrent lookup — keep
serving from the previous placement snapshot (steps hold a dedicated lock;
telemetry takes a separate short-lived one).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.fap import compute_fap
from repro_torch.core.placement import (TIER_HOST, migration_pairs,
                                        quiver_placement)
from repro_torch.serving.registry import DEFAULT_MODEL, ModelRegistry
from repro_torch.serving.router import CostModelRouter, LatencyCurve


class FrequencySketch:
    """Exponentially-decayed seed-access frequency over the node set.

    ``observe`` is called from executor callback threads; ``decay`` once per
    control period, so the sketch tracks the *recent* request mix: with decay
    ``d`` per period, a seed last hot ``k`` periods ago retains weight d^k.
    One sketch serves every model of a registry — feature placement is
    store-wide, so accesses blend across models by design.
    """

    def __init__(self, num_nodes: int, *, decay: float = 0.9):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.num_nodes = int(num_nodes)
        self.decay = float(decay)
        self.counts = np.zeros(self.num_nodes, dtype=np.float64)
        self.total_observed = 0
        self._lock = threading.Lock()

    def observe(self, seeds: np.ndarray) -> None:
        """Count one batch's seed accesses (``-1`` padding ignored).
        Thread-safe; called from executor callback threads."""
        seeds = np.asarray(seeds)
        seeds = seeds[seeds >= 0]
        with self._lock:
            np.add.at(self.counts, seeds, 1.0)
            self.total_observed += int(seeds.size)

    def decay_step(self) -> None:
        """Multiply every count by ``decay`` (called once per control
        period, so old traffic fades geometrically)."""
        with self._lock:
            self.counts *= self.decay

    def empirical_prob(self, *, prior_weight: float = 0.2) -> np.ndarray:
        """Normalized access distribution, blended with a uniform prior so
        never-seen nodes keep non-zero FAP mass (cold-start safety)."""
        with self._lock:
            c = self.counts.copy()
        total = c.sum()
        uniform = np.full(self.num_nodes, 1.0 / self.num_nodes)
        if total <= 0.0:
            return uniform
        return (1.0 - prior_weight) * (c / total) + prior_weight * uniform


@dataclasses.dataclass
class AdaptiveConfig:
    interval_batches: int = 32     # control period, in completed batches
    rows_per_step: int = 64        # migration budget per control step
    decay: float = 0.9             # sketch decay per control period
    prior_weight: float = 0.2      # uniform blend in the empirical seed dist
    min_refit_samples: int = 24    # live samples before a curve refit
    curve_bins: int = 8
    curve_tail: float = 1.0        # tail statistic for the refit curves
    drift_threshold: float = 0.25  # mean relative avg-curve error to swap
    sample_window: int = 512       # live (psgs, latency) samples kept/executor
    fap_truncated: bool = False    # forwarded to compute_fap
    promote_budget: int = 16       # miss-driven DISK promotions per step
    # micro-batch auto-tuning (active only when a MicroBatcher is attached):
    # per control step, nudge deadline_s/max_seeds a `micro_step` fraction of
    # the way toward the knee of the live latency curve, clamped to bounds
    micro_step: float = 0.5
    micro_seeds_bounds: tuple[int, int] = (16, 4096)
    micro_deadline_bounds: tuple[float, float] = (5e-4, 5e-2)
    micro_deadline_frac: float = 0.5   # deadline target: frac of knee latency
    # cold-path auto-sizing (active when a GPUFeatureCache is attached to
    # the store and/or a Prefetcher to the controller): per control step,
    # nudge the cache capacity / staging budget a `cold_step` fraction
    # toward targets sized from the measured cold working set, and the
    # prefetch refresh cadence from the interval's prefetch miss ratio —
    # every target is clamped to its bounds, so a pathological sketch
    # (every node scoring hot) can never grow the sizes without bound
    cold_step: float = 0.5
    cache_rows_bounds: tuple[int, int] = (64, 8192)
    stage_budget_bounds: tuple[int, int] = (64, 8192)
    prefetch_cadence_bounds: tuple[int, int] = (1, 8)
    cache_headroom: float = 1.25   # cache target: headroom × cold working set
    cadence_miss_ratio: float = 0.25  # miss ratio above which cadence snaps
    #                                   back to refreshing every step
    # gateway admission tuning (active when a ServingGateway is attached):
    # per control step, nudge the gateway's queue_limit an `admission_step`
    # fraction toward a target set by the interval's deadline sheds (halve —
    # requests are going stale while queued, refuse them at admission
    # instead) or by slack saturation (relax toward the cap), clamped to
    # `queue_limit_bounds`
    admission_step: float = 0.5
    queue_limit_bounds: tuple[int, int] = (16, 4096)
    admission_sat_low: float = 0.5  # saturation below which the window relaxes


def curve_drift(old: LatencyCurve, new: LatencyCurve) -> float:
    """Mean relative disagreement of the two average-latency curves,
    evaluated on the new curve's calibrated support."""
    grid = np.asarray(new.psgs, dtype=np.float64)
    a = np.asarray(old.eval_avg(grid), dtype=np.float64)
    b = np.asarray(new.eval_avg(grid), dtype=np.float64)
    return float(np.mean(np.abs(b - a) / np.maximum(np.abs(a), 1e-12)))


def _normalize_routers(router) -> dict[str, CostModelRouter]:
    """Model → router mapping from any accepted ``router`` argument: a
    single router (default model), a mapping, a ModelRegistry, or None."""
    if router is None:
        return {}
    if isinstance(router, ModelRegistry):
        return router.routers()
    if isinstance(router, Mapping):
        return dict(router)
    return {DEFAULT_MODEL: router}


class AdaptiveController:
    """Telemetry-driven control loop over a live serving stack.

    Implements the engine hook protocol (``on_admit`` / ``on_batch_complete``
    — model-aware: the engine passes the batch's model tag) and owns the
    whole adaptation state: the shared frequency sketch, per-``(model,
    executor)`` latency samples, and the migration/refit counters in
    :attr:`stats`. ``router`` may be a single ``CostModelRouter`` (the
    single-model case), a model → router mapping, a ``ModelRegistry``
    (its routers are extracted), or ``None`` (placement-only adaptation).
    Attach a ``MicroBatcher`` (constructor ``micro=`` or
    :meth:`attach_micro`) to enable micro-batch auto-tuning.
    """

    def __init__(self, graph, fanouts: Sequence[int], store,
                 router=None, *, psgs_table: Optional[np.ndarray] = None,
                 config: Optional[AdaptiveConfig] = None, micro=None,
                 prefetcher=None):
        self.graph = graph
        self.fanouts = tuple(int(f) for f in fanouts)
        self.store = store
        self.routers = _normalize_routers(router)
        # single-model view kept for pre-multi-model callers/logs
        self.router = self.routers.get(DEFAULT_MODEL) or (
            next(iter(self.routers.values()), None))
        self.psgs_table = psgs_table
        self.config = config or AdaptiveConfig()
        self.micro = micro
        self.sketch = FrequencySketch(graph.num_nodes,
                                      decay=self.config.decay)
        # live (psgs, latency) samples keyed (model, executor name): refits
        # must never blend two models' curves even on shared executor names
        self.samples: dict[tuple[str, str], collections.deque] = {}
        self.stats = {"steps": 0, "migrated_rows": 0, "refits": 0,
                      "batches_seen": 0, "micro_tunings": 0,
                      "promoted_rows": 0, "prefetch_refreshes": 0,
                      "cold_tunings": 0, "admission_tunings": 0,
                      "last_drift": {}}
        # every attached prefetcher is refreshed/tuned per step; the first
        # one stays aliased as `.prefetcher` for pre-multi-store callers
        self.prefetchers: list = []
        self.prefetcher = None
        if prefetcher is not None:
            self.attach_prefetcher(prefetcher)
        self.gateway = None
        self._last_gateway_shed = 0
        self._since_step = 0
        # cold-path feedback state: last store-stats snapshot (interval
        # deltas), current prefetch refresh cadence (in control steps) and
        # steps elapsed since the last refresh
        self._last_store_stats: dict[str, int] = {}
        self._cadence = max(1, int(self.config.prefetch_cadence_bounds[0]))
        self._steps_since_refresh = 0
        self._psgs_seen = 0.0   # running Σ accumulated PSGS of sampled batches
        self._seeds_seen = 0    # running seed count — per-seed PSGS estimate
        # _lock guards telemetry (samples/stats/counters) and is only ever
        # held briefly; _step_lock serializes control steps. The heavy work
        # (FAP recompute, placement, migration) runs under _step_lock alone,
        # so completion callbacks on other lanes never block behind it.
        self._lock = threading.Lock()
        self._step_lock = threading.Lock()
        self.enabled = True

    def attach_micro(self, micro) -> "AdaptiveController":
        """Attach the live ``MicroBatcher`` whose ``deadline_s``/
        ``max_seeds`` the control step may nudge; returns the controller
        for chaining."""
        self.micro = micro
        return self

    def attach_prefetcher(self, prefetcher) -> "AdaptiveController":
        """Attach a :class:`~repro_torch.core.prefetch.Prefetcher` the control
        step re-stages each period (with the freshly recomputed FAP as the
        prediction score — it covers multi-hop frontier accesses, which the
        seed sketch alone cannot). May be called more than once: each
        prefetcher keeps its own store (e.g. one over the single-host
        tiered store, one driving the sharded store's per-shard stages)
        and all of them are refreshed and budget-tuned per control step
        from the one shared sketch. ``None`` detaches them all. Returns
        the controller for chaining."""
        if prefetcher is None:
            self.prefetchers = []
            self.prefetcher = None
            return self
        prefetcher.sketch = self.sketch
        self.prefetchers.append(prefetcher)
        self.prefetcher = self.prefetchers[0]
        return self

    def attach_gateway(self, gateway) -> "AdaptiveController":
        """Attach the :class:`~repro_torch.serving.gateway.ServingGateway` whose
        admission window (``config.queue_limit``) the control step may
        tighten from observed saturation and deadline sheds; returns the
        controller for chaining."""
        self.gateway = gateway
        return self

    # -- engine hook protocol ------------------------------------------------
    def on_admit(self, name: str, seeds: np.ndarray,
                 model: str = DEFAULT_MODEL) -> None:
        """Engine hook: feed the admitted batch's seeds into the frequency
        sketch (``-1`` padding is ignored by the sketch).

        Args:
            name: executor the batch was routed to (unused here).
            seeds: ``(B,)`` seed ids of the admitted batch.
            model: model tag of the batch (unused — the sketch is shared:
                placement is store-wide across models).
        """
        self.sketch.observe(seeds)

    def on_batch_complete(self, name: str, seeds: np.ndarray,
                          latency_s: float,
                          model: str = DEFAULT_MODEL) -> None:
        """Engine hook: record a live ``(psgs, latency)`` sample for the
        ``(model, executor)`` pair and run a control step when the period
        boundary is crossed (inline, on this callback thread).

        Args:
            name: executor that served the batch.
            seeds: ``(B,)`` seed ids of the batch.
            latency_s: per-batch service time (queueing + processing).
            model: model tag of the batch (defaults to the single model).
        """
        due = False
        with self._lock:
            if self.psgs_table is not None:
                seeds = np.asarray(seeds)
                valid = seeds[seeds >= 0]
                q = float(self.psgs_table[valid].sum())
                dq = self.samples.setdefault(
                    (model, name),
                    collections.deque(maxlen=self.config.sample_window))
                dq.append((q, float(latency_s)))
                self._psgs_seen += q
                self._seeds_seen += int(valid.size)
            self.stats["batches_seen"] += 1
            self._since_step += 1
            if (self.enabled
                    and self._since_step >= self.config.interval_batches):
                self._since_step = 0
                due = True
        if due:
            self.step()

    # -- control step --------------------------------------------------------
    def target_plan(self):
        """Placement the *current* empirical workload asks for.

        Returns:
            ``(plan, fap)`` — the target :class:`PlacementPlan` from FAP
            recomputed with the sketch's empirical seed distribution, and
            that FAP vector itself.
        """
        p0 = self.sketch.empirical_prob(prior_weight=self.config.prior_weight)
        fap = compute_fap(self.graph, self.fanouts, seed_prob=p0,
                          truncated=self.config.fap_truncated,
                          device=self.store.device)
        return quiver_placement(fap, self.store.plan.topology), fap

    def step(self) -> dict:
        """One control step: re-place (bounded) + refit curves + tune the
        micro-batcher. Thread-safe; concurrent steps serialize on their own
        lock — telemetry callbacks from other lanes are never blocked by
        the recompute.

        Returns:
            ``{"migrated_rows", "refits", "pending", "micro",
            "promoted_rows", "prefetched", "cold", "admission"}`` — rows
            moved this step, curves swapped, nodes still off their target
            tier (0 means the placement has converged for this workload),
            the micro-batcher bounds after tuning (``None`` when no
            micro-batcher is attached), miss-driven DISK rows promoted,
            whether a prefetch refresh was kicked off (subject to the
            tuned cadence), the :meth:`tune_cold_path` sizing result, and
            the :meth:`tune_admission` gateway-window result (``None``
            when no gateway is attached).
        """
        with self._step_lock:
            target, fap = self.target_plan()
            pairs = migration_pairs(self.store.plan.tier, target.tier, fap,
                                    budget=max(self.config.rows_per_step // 2,
                                               1))
            moved = self.store.swap_assignments(pairs)
            # miss-driven DISK promotion: rows the workload actually missed
            # jump the FAP queue (bounded, swap-based — serving never sees
            # a torn row)
            promote = getattr(self.store, "promote_misses", None)
            promoted = (promote(budget=self.config.promote_budget)
                        if promote is not None else 0)
            refits = self.refit_curves()
            micro = self.tune_micro()
            # close the prefetch feedback loop BEFORE the refresh so the
            # freshly sized staging budget shapes this step's stage
            cold = self.tune_cold_path()
            admission = self.tune_admission()
            prefetched = False
            if self.prefetchers:
                self._steps_since_refresh += 1
                if self._steps_since_refresh >= self._cadence:
                    self._steps_since_refresh = 0
                    # re-stage the cold tiers off the critical path, scored
                    # by the fresh FAP (covers multi-hop frontiers, not
                    # just seeds) — every attached stage, single-host and
                    # per-shard alike, restages from the same score vector
                    for pf in self.prefetchers:
                        pf.refresh_async(scores=fap)
                    prefetched = True
            self.sketch.decay_step()
            with self._lock:
                self.stats["steps"] += 1
                self.stats["migrated_rows"] += moved + promoted
                self.stats["promoted_rows"] += promoted
                self.stats["prefetch_refreshes"] += int(prefetched)
                self.stats["admission_tunings"] += int(admission is not None)
            return {"migrated_rows": moved, "refits": refits,
                    "micro": micro, "promoted_rows": promoted,
                    "prefetched": prefetched, "cold": cold,
                    "admission": admission,
                    "pending": int((target.tier != self.store.plan.tier)
                                   .sum())}

    # -- cold-path feedback loop ---------------------------------------------
    def tune_cold_path(self) -> Optional[dict]:
        """Size the device cache, the prefetch staging budget and the
        refresh cadence from the measured cold working set.

        Per control step: the cold working set is the number of cold-tier
        (HOST/DISK) nodes with non-zero decayed sketch weight — the nodes
        the *recent* request mix actually touched below HBM. The attached
        :class:`~repro_torch.core.gpu_cache.GPUFeatureCache` is resized a
        ``cold_step`` fraction toward ``cache_headroom ×`` that set
        (clamped to ``cache_rows_bounds``); the prefetcher's staging
        budget toward the set itself (``stage_budget_bounds``); and the
        refresh cadence from the interval's prefetch miss ratio
        (``prefetch_hits/misses`` deltas of the store's dispatch stats):
        misses above ``cadence_miss_ratio`` snap the cadence back to
        refreshing every step, a clean interval stretches it toward the
        upper bound. Every target is clamped, so sizes stay bounded under
        any sketch. Tiers come from the store's host mirror, so no table
        crosses from the device.

        Returns:
            ``{"cold_ws", "cache_rows"?, "stage_budget"?,
            "refresh_cadence"?}`` — or ``None`` when there is neither a
            cache nor a prefetcher to tune.
        """
        cache = getattr(self.store, "cache", None)
        pfs = self.prefetchers
        if cache is None and not pfs:
            return None
        cfg = self.config
        step = float(np.clip(cfg.cold_step, 0.0, 1.0))
        tier = self.store.tier_np
        cold_ws = int(((tier >= TIER_HOST)
                       & (self.sketch.counts > 0.0)).sum())
        snapshot = getattr(self.store, "snapshot_stats", None)
        snap = snapshot() if snapshot is not None else {}
        delta = {k: max(0, int(v) - self._last_store_stats.get(k, 0))
                 for k, v in snap.items()}
        self._last_store_stats = {k: int(v) for k, v in snap.items()}
        out: dict = {"cold_ws": cold_ws}
        if cache is not None:
            lo, hi = cfg.cache_rows_bounds
            target = int(np.clip(round(cfg.cache_headroom * cold_ws),
                                 lo, hi))
            cur = int(cache.capacity)
            new = int(np.clip(round(cur + step * (target - cur)), lo, hi))
            if new != cur:
                cache.resize(new)
            out["cache_rows"] = new
        if pfs:
            lo, hi = cfg.stage_budget_bounds
            target = int(np.clip(cold_ws, lo, hi))
            for pf in pfs:
                cur = int(pf.budget)
                new = int(np.clip(round(cur + step * (target - cur)),
                                  lo, hi))
                pf.budget = new
            # the reported budget is the primary (first-attached) stage's
            out["stage_budget"] = int(pfs[0].budget)
            c_lo, c_hi = cfg.prefetch_cadence_bounds
            hits = delta.get("prefetch_hits", 0)
            misses = delta.get("prefetch_misses", 0)
            if hits + misses > 0:
                ratio = misses / (hits + misses)
                target_c = (c_lo if ratio > cfg.cadence_miss_ratio
                            else min(c_hi, self._cadence + 1))
                self._cadence = int(np.clip(
                    round(self._cadence + step * (target_c - self._cadence)),
                    c_lo, c_hi))
            out["refresh_cadence"] = self._cadence
        with self._lock:
            self.stats["cold_tunings"] += 1
        return out

    def tune_admission(self) -> Optional[dict]:
        """Tighten or relax the attached gateway's admission window.

        Per control step: when the interval saw deadline sheds (requests
        going stale while queued, or hopeless at admission), the gateway's
        ``queue_limit`` is nudged an ``admission_step`` fraction toward
        half its current value — a shorter queue turns late dequeue-time
        sheds into cheap admission-time refusals. When the interval was
        shed-free and engine saturation is below ``admission_sat_low``,
        the window relaxes toward the upper bound. Clamped to
        ``queue_limit_bounds`` either way; the gateway reads
        ``config.queue_limit`` per submit, so the nudge takes effect
        immediately (plain attribute write, no torn state).

        Returns:
            ``{"queue_limit", "saturation", "deadline_sheds"}`` after the
            nudge, or ``None`` when no gateway is attached.
        """
        gw = self.gateway
        if gw is None:
            return None
        cfg = self.config
        step = float(np.clip(cfg.admission_step, 0.0, 1.0))
        lo, hi = cfg.queue_limit_bounds
        rep = gw.report()
        shed_dl = int(rep.get("shed_deadline", 0))
        dl_delta = max(0, shed_dl - self._last_gateway_shed)
        self._last_gateway_shed = shed_dl
        saturation = float(rep.get("saturation", 0.0))
        cur = int(gw.config.queue_limit)
        if dl_delta > 0:
            target = max(lo, cur // 2)
        elif saturation < cfg.admission_sat_low:
            target = hi
        else:
            target = cur
        new = int(np.clip(round(cur + step * (target - cur)), lo, hi))
        gw.config.queue_limit = new
        return {"queue_limit": new, "saturation": saturation,
                "deadline_sheds": dl_delta}

    def refit_curves(self) -> int:
        """Refit curves from live samples, per ``(model, executor)``; swap
        any whose drift against that model's router curve exceeds the
        threshold. Models without a registered router are skipped.

        Returns:
            Number of curves swapped into the routers (0 when routerless,
            under-sampled, or drift stayed below the threshold).
        """
        if not self.routers:
            return 0
        swapped = 0
        with self._lock:
            items = [(key, list(dq)) for key, dq in self.samples.items()]
        for (model, name), dq in items:
            router = self.routers.get(model)
            if router is None or len(dq) < self.config.min_refit_samples:
                continue
            ps, ls = zip(*dq)
            new = LatencyCurve.fit(ps, ls, bins=self.config.curve_bins,
                                   tail=self.config.curve_tail)
            try:
                old = router.curve(name)
            except KeyError:
                continue
            drift = curve_drift(old, new)
            key = name if model == DEFAULT_MODEL else f"{model}/{name}"
            with self._lock:
                # unlocked writes here race report()'s iteration over
                # last_drift (dict-changed-size-during-iteration)
                self.stats["last_drift"][key] = drift
            if drift > self.config.drift_threshold:
                router.update_curve(name, new)
                swapped += 1
        with self._lock:
            self.stats["refits"] += swapped
        return swapped

    # -- micro-batch auto-tuning ---------------------------------------------
    def micro_targets(self) -> Optional[dict]:
        """Measured-knee targets for the attached micro-batcher.

        Fits one latency curve over *all* live samples (every model and
        executor — the micro stage feeds them all), finds the PSGS with the
        best latency-per-unit-work (the knee: below it, fixed dispatch
        overhead dominates; past it, marginal cost is flat), and converts it
        to a seed count via the observed mean per-seed PSGS. The deadline
        target is ``micro_deadline_frac`` of the knee's own service latency
        — waiting longer than a fraction of the work itself cannot pay off.

        Returns:
            ``{"max_seeds", "deadline_s", "knee_psgs"}`` clamped to the
            configured bounds, or ``None`` when there are not yet
            ``min_refit_samples`` samples (or no per-seed PSGS estimate).
        """
        with self._lock:
            flat = [s for dq in self.samples.values() for s in dq]
            psgs_seen, seeds_seen = self._psgs_seen, self._seeds_seen
        if len(flat) < self.config.min_refit_samples or seeds_seen == 0:
            return None
        per_seed = psgs_seen / seeds_seen
        if per_seed <= 0.0:
            return None
        ps, ls = zip(*flat)
        curve = LatencyCurve.fit(ps, ls, bins=self.config.curve_bins,
                                 tail=self.config.curve_tail)
        lo, hi = float(curve.psgs[0]), float(curve.psgs[-1])
        grid = np.linspace(max(lo, 1e-9), max(hi, lo + 1e-9), 256)
        eff = np.asarray(curve.eval_avg(grid)) / grid   # s per unit PSGS
        knee_q = float(grid[int(np.argmin(eff))])
        s_lo, s_hi = self.config.micro_seeds_bounds
        d_lo, d_hi = self.config.micro_deadline_bounds
        return {
            "max_seeds": int(np.clip(round(knee_q / per_seed), s_lo, s_hi)),
            "deadline_s": float(np.clip(
                float(curve.eval_avg(knee_q))
                * self.config.micro_deadline_frac, d_lo, d_hi)),
            "knee_psgs": knee_q,
        }

    def tune_micro(self) -> Optional[dict]:
        """Nudge the attached micro-batcher's ``max_seeds``/``deadline_s`` a
        ``micro_step`` fraction of the way toward :meth:`micro_targets`
        (clamped to the configured bounds; plain attribute writes — the
        batcher reads them per ``add``, so no torn state is possible).

        Returns:
            The batcher's bounds after the nudge plus the knee estimate, or
            ``None`` when no micro-batcher is attached / targets are not
            yet measurable.
        """
        if self.micro is None:
            return None
        targets = self.micro_targets()
        if targets is None:
            return None
        step = float(np.clip(self.config.micro_step, 0.0, 1.0))
        s_lo, s_hi = self.config.micro_seeds_bounds
        d_lo, d_hi = self.config.micro_deadline_bounds
        cur_seeds, cur_dl = self.micro.max_seeds, self.micro.deadline_s
        new_seeds = int(np.clip(
            round(cur_seeds + step * (targets["max_seeds"] - cur_seeds)),
            s_lo, s_hi))
        new_dl = float(np.clip(
            cur_dl + step * (targets["deadline_s"] - cur_dl), d_lo, d_hi))
        self.micro.max_seeds = new_seeds
        self.micro.deadline_s = new_dl
        with self._lock:
            self.stats["micro_tunings"] += 1
        return {"max_seeds": new_seeds, "deadline_s": new_dl,
                "knee_psgs": targets["knee_psgs"]}

    def report(self) -> dict:
        """Adaptation counters for logging: steps, migrated rows, refits,
        micro tunings, batches seen, per-``(model/)executor`` last drift,
        and seeds observed."""
        with self._lock:
            stats = dict(self.stats)
            last_drift = dict(stats["last_drift"])
        return {**{k: v for k, v in stats.items() if k != "last_drift"},
                "last_drift": {k: round(v, 4)
                               for k, v in last_drift.items()},
                "seeds_observed": self.sketch.total_observed}
