"""Cost-model routing over executors (paper §4.2, generalized): numpy
port of the reference's ``serving/router.py``.

Offline, every executor is measured on batches of varying accumulated PSGS
and an *average* and a *maximum* latency curve are fit per executor
(:class:`LatencyCurve`). The four operating points of the paper's
Fig. 6(b) select which statistic each executor is judged by:

    1 cpu_preferred        : host.max  vs device.avg
    2 gpu_preferred        : host.avg  vs device.max
    3 latency_preferred    : host.max  vs device.max   (bound tail latency)
    4 throughput_preferred : host.avg  vs device.avg   (maximize throughput)

:class:`CostModelRouter` sends a batch to the executor whose
policy-selected curve is lowest at the batch's accumulated PSGS; with two
executors this is the paper's single-threshold rule, which
:class:`HybridScheduler` keeps as such (a PSGS threshold from a binary
:class:`CalibrationResult`). :class:`StaticScheduler` is the
always-one-executor baseline.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np

from repro_torch import trace
from repro_torch.serving.executors import Executor, _accumulated_psgs

POLICIES = ("cpu_preferred", "gpu_preferred", "latency_preferred",
            "throughput_preferred")


def _policy_stat(policy: str, kind: str) -> str:
    """Which curve ("avg" | "max") policy ``policy`` judges a ``kind``-kind
    executor by. Host-kind executors are the CPU sampler of Fig. 6(b); every
    other kind (device, sharded, ...) takes the device role."""
    if policy in ("latency_preferred", "strict"):
        return "max"
    if policy in ("throughput_preferred", "loose"):
        return "avg"
    if policy == "cpu_preferred":
        return "max" if kind == "host" else "avg"
    if policy == "gpu_preferred":
        return "avg" if kind == "host" else "max"
    raise ValueError(f"unknown policy {policy!r}")


@dataclasses.dataclass
class LatencyCurve:
    """Piecewise-linear latency-vs-PSGS curve (avg + tail) fit from samples.

    Queries above the calibrated PSGS range extrapolate linearly along the
    last (non-negative-slope) segment instead of ``np.interp``'s flat
    continuation — a flat tail silently underestimated the cost of batches
    far larger than anything calibrated, starving the cheap executor.
    :meth:`covers` flags out-of-range queries for callers that want to
    trigger recalibration instead.
    """

    psgs: np.ndarray      # (B,) bin centers, ascending
    avg: np.ndarray       # (B,) mean latency per bin (seconds)
    mx: np.ndarray        # (B,) tail (max or p99) latency per bin

    @staticmethod
    def fit(samples_psgs: Sequence[float], samples_lat: Sequence[float],
            *, bins: int = 12, tail: float = 1.0) -> "LatencyCurve":
        p = np.asarray(samples_psgs, dtype=np.float64)
        l = np.asarray(samples_lat, dtype=np.float64)
        if p.size == 0:
            raise ValueError("LatencyCurve.fit needs at least one sample")
        order = np.argsort(p)
        p, l = p[order], l[order]
        # Degenerate sample sets (fewer samples than bins, or repeated /
        # constant PSGS) produce duplicate quantile edges; without dedup all
        # but one duplicate bin came back empty and the curve collapsed to a
        # near-empty point set. Dedupe, and fall back to one all-inclusive
        # bin when every sample shares one PSGS value.
        bins = max(1, min(int(bins), p.size))
        edges = np.unique(np.quantile(p, np.linspace(0, 1, bins + 1)))
        if edges.size < 2:
            edges = np.array([edges[0], edges[0] + 1e-9])
        edges[-1] += 1e-9
        centers, avgs, maxs = [], [], []
        for i in range(edges.size - 1):
            m = (p >= edges[i]) & (p < edges[i + 1])
            if not m.any():
                continue
            centers.append(p[m].mean())
            avgs.append(l[m].mean())
            maxs.append(np.quantile(l[m], tail) if tail < 1.0 else l[m].max())
        return LatencyCurve(np.asarray(centers), np.asarray(avgs),
                            np.asarray(maxs))

    def covers(self, q: float | np.ndarray) -> bool | np.ndarray:
        """Whether ``q`` falls inside the calibrated PSGS range."""
        inside = (np.asarray(q) >= self.psgs[0]) & (np.asarray(q)
                                                    <= self.psgs[-1])
        return bool(inside) if np.ndim(q) == 0 else inside

    def _eval(self, q: float | np.ndarray, ys: np.ndarray) -> np.ndarray:
        out = np.interp(q, self.psgs, ys)
        if self.psgs.size >= 2:
            # latency is non-decreasing in work: clamp the extrapolation
            # slope at >= 0 so a noisy last bin can't make huge batches
            # look *cheaper* than the calibrated maximum
            dq = float(self.psgs[-1] - self.psgs[-2])
            slope = max(float(ys[-1] - ys[-2]) / max(dq, 1e-12), 0.0)
            out = np.where(np.asarray(q) > self.psgs[-1],
                           ys[-1] + slope * (np.asarray(q) - self.psgs[-1]),
                           out)
        return out

    def eval_avg(self, q: float | np.ndarray) -> np.ndarray:
        return self._eval(q, self.avg)

    def eval_max(self, q: float | np.ndarray) -> np.ndarray:
        return self._eval(q, self.mx)

    def eval(self, q: float | np.ndarray, stat: str) -> np.ndarray:
        return self.eval_max(q) if stat == "max" else self.eval_avg(q)


@dataclasses.dataclass
class CalibrationResult:
    """Binary host/device calibration (the paper's Fig. 6 setting)."""

    host: LatencyCurve
    device: LatencyCurve

    def _cross(self, f_host: Callable, f_dev: Callable) -> float:
        lo = min(self.host.psgs.min(), self.device.psgs.min())
        hi = max(self.host.psgs.max(), self.device.psgs.max())
        grid = np.linspace(lo, hi, 512)
        diff = f_host(grid) - f_dev(grid)
        sign = np.signbit(diff)
        flips = np.flatnonzero(sign[1:] != sign[:-1])
        if flips.size == 0:
            # no intersection: host always faster → +inf threshold (never use
            # device); device always faster → 0 (always device)
            return float("inf") if diff[-1] < 0 else 0.0
        i = flips[0]
        # linear interpolation of the crossing, clamped to the measured range
        x0, x1, d0, d1 = grid[i], grid[i + 1], diff[i], diff[i + 1]
        denom = d1 - d0
        if abs(denom) < 1e-15:
            return float(x0)
        return float(np.clip(x0 + (x1 - x0) * (0 - d0) / denom, lo, hi))

    def threshold(self, policy: str) -> float:
        h, d = self.host, self.device
        if policy == "cpu_preferred":
            return self._cross(h.eval_max, d.eval_avg)
        if policy == "gpu_preferred":
            return self._cross(h.eval_avg, d.eval_max)
        if policy in ("latency_preferred", "strict"):
            return self._cross(h.eval_max, d.eval_max)
        if policy in ("throughput_preferred", "loose"):
            return self._cross(h.eval_avg, d.eval_avg)
        raise ValueError(f"unknown policy {policy!r}")


def calibrate_executors(executors: Mapping[str, Callable] | Sequence[Executor],
                        batches: Sequence[np.ndarray],
                        psgs_table: np.ndarray, *, repeats: int = 3,
                        warmup: int = 1, tail: float = 1.0
                        ) -> dict[str, LatencyCurve]:
    """Measure every executor on the same batches and fit one
    :class:`LatencyCurve` each (N-way generalization of :func:`calibrate`).

    ``executors`` maps name → a synchronous runner — either a plain callable
    taking a seed array or an :class:`Executor` (its blocking ``run`` is
    used). Measurements follow the paper's protocol: steady-state repeats
    after warmup, no queueing.
    """
    if not isinstance(executors, Mapping):
        executors = {ex.name: ex for ex in executors}
    curves: dict[str, LatencyCurve] = {}
    for name, ex in executors.items():
        run = ex.run if hasattr(ex, "run") else ex
        ps, ls = [], []
        for b in batches:
            q = _accumulated_psgs(psgs_table, b)
            for _ in range(warmup):
                run(b)
            for _ in range(repeats):
                t0 = time.perf_counter()
                run(b)
                ls.append(time.perf_counter() - t0)
                ps.append(q)
        curves[name] = LatencyCurve.fit(ps, ls, tail=tail)
    return curves


def calibrate(host_run: Callable[[np.ndarray], None],
              device_run: Callable[[np.ndarray], None],
              batches: Sequence[np.ndarray], psgs_table: np.ndarray,
              *, repeats: int = 3, warmup: int = 1,
              tail: float = 1.0) -> CalibrationResult:
    """Binary special case kept for the paper's Fig. 6 experiments."""
    curves = calibrate_executors({"host": host_run, "device": device_run},
                                 batches, psgs_table, repeats=repeats,
                                 warmup=warmup, tail=tail)
    return CalibrationResult(host=curves["host"], device=curves["device"])


class CostModelRouter:
    """N-way routing over a registry of calibrated executors.

    ``route(seeds)`` evaluates every registered executor's policy-selected
    latency curve at the batch's accumulated PSGS and picks the minimum
    (ties break toward earlier registration). With ``load_aware=True`` the
    estimate is additionally scaled by ``1 + inflight/capacity`` for
    registered executor objects, shifting load off busy executors — off by
    default so the two-executor case stays bit-identical to the paper's
    threshold policies.
    """

    def __init__(self, psgs_table: np.ndarray,
                 policy: str = "latency_preferred", *,
                 load_aware: bool = False):
        self.psgs_table = psgs_table
        self.policy = policy
        self.load_aware = load_aware
        self._curves: dict[str, LatencyCurve] = {}
        self._kinds: dict[str, str] = {}
        self._executors: dict[str, Executor] = {}
        self.routed: dict[str, int] = {}

    # -- registry ------------------------------------------------------------
    def register(self, name: str, curve: LatencyCurve, *,
                 kind: Optional[str] = None,
                 executor: Optional[Executor] = None) -> "CostModelRouter":
        """Register an executor's calibrated latency curve.

        Args:
            name: executor name (must match the engine registry).
            curve: calibrated avg+tail :class:`LatencyCurve` over PSGS.
            kind: ``"host"`` | ``"device"`` policy role; defaults to the
                executor's ``kind`` attribute (``"device"`` if absent).
            executor: optional live executor — enables ``supports``-based
                eligibility and load-aware estimates.

        Returns:
            The router, for chaining.
        """
        if kind is None:
            kind = getattr(executor, "kind", "device")
        self._curves[name] = curve
        self._kinds[name] = kind
        if executor is not None:
            self._executors[name] = executor
        self.routed.setdefault(name, 0)
        return self

    @property
    def names(self) -> list[str]:
        """Registered executor names, in registration order."""
        return list(self._curves)

    def curve(self, name: str) -> LatencyCurve:
        """Current latency curve for ``name``.

        Raises:
            KeyError: if ``name`` was never registered.
        """
        return self._curves[name]

    def update_curve(self, name: str, curve: LatencyCurve) -> None:
        """Swap in a freshly fitted curve (online recalibration). The swap is
        a single reference assignment, so concurrent ``route()`` calls see
        either the old or the new curve — never a torn mix.

        Args:
            name: a registered executor name.
            curve: the replacement :class:`LatencyCurve`.

        Raises:
            KeyError: if ``name`` was never registered (guards against
                typo'd refits silently creating unroutable entries).
        """
        if name not in self._curves:
            raise KeyError(f"unknown executor {name!r}")
        self._curves[name] = curve

    @staticmethod
    def from_curves(psgs_table: np.ndarray,
                    curves: Mapping[str, LatencyCurve],
                    policy: str = "latency_preferred", *,
                    kinds: Optional[Mapping[str, str]] = None,
                    executors: Optional[Mapping[str, Executor]] = None,
                    load_aware: bool = False) -> "CostModelRouter":
        """Build a router from a name → curve mapping (the usual output of
        :func:`calibrate_executors`). ``kinds`` overrides the policy role
        per name; otherwise the executor's ``kind`` decides, falling back to
        ``"host"`` for the name ``"host"`` and ``"device"`` elsewhere."""
        r = CostModelRouter(psgs_table, policy, load_aware=load_aware)
        for name, curve in curves.items():
            executor = (executors or {}).get(name)
            if kinds and name in kinds:
                kind = kinds[name]
            elif executor is not None:
                kind = getattr(executor, "kind", "device")
            else:
                kind = "host" if name == "host" else "device"
            r.register(name, curve, kind=kind, executor=executor)
        return r

    @staticmethod
    def from_calibration(psgs_table: np.ndarray, calib: CalibrationResult,
                         policy: str = "latency_preferred"
                         ) -> "CostModelRouter":
        """The 2-executor special case: host+device curves from a binary
        calibration — routing equals the PSGS-threshold rule."""
        return CostModelRouter.from_curves(
            psgs_table, {"host": calib.host, "device": calib.device}, policy)

    # -- routing -------------------------------------------------------------
    def batch_cost(self, seeds: np.ndarray) -> float:
        """Accumulated PSGS of a batch (``-1`` padding ignored) — the
        x-coordinate every latency curve is evaluated at."""
        return _accumulated_psgs(self.psgs_table, seeds)

    def estimate(self, name: str, q: float) -> float:
        """Policy-selected latency estimate for one executor.

        Args:
            name: registered executor name.
            q: accumulated PSGS of the batch (see :meth:`batch_cost`).

        Returns:
            Estimated seconds from the avg or tail curve (whichever the
            policy judges this executor's kind by), scaled by
            ``1 + inflight/capacity`` when ``load_aware``.

        Raises:
            KeyError: if ``name`` was never registered.
        """
        stat = _policy_stat(self.policy, self._kinds[name])
        est = float(self._curves[name].eval(q, stat))
        if self.load_aware and name in self._executors:
            ex = self._executors[name]
            est *= 1.0 + ex.inflight / max(ex.capacity, 1)
        return est

    def estimate_seconds(self, seeds: np.ndarray) -> float:
        """Best-case service-time estimate of a batch: the minimum
        policy-selected estimate over its eligible executors — the number
        the SLO gateway subtracts from a request's deadline to order the
        admission queue by slack.

        Args:
            seeds: ``(B,)`` seed ids of the batch (``-1`` padding ignored).

        Returns:
            Estimated seconds on the cheapest eligible executor (including
            load-aware inflation when enabled), or ``0.0`` when no curve
            has been fit yet — an optimistic gateway never sheds on a
            missing estimate.
        """
        if not self._curves:
            return 0.0
        q = self.batch_cost(seeds)
        return min(self.estimate(name, q) for name in self._eligible(seeds))

    def crossover(self, a: str, b: str, *, lo: Optional[float] = None,
                  hi: Optional[float] = None, grid_points: int = 512
                  ) -> float:
        """PSGS cut-point between two registered executors under the current
        policy: below it ``a``'s policy-selected estimate is cheaper, above
        it ``b``'s is (the N-way analogue of the paper's binary threshold).
        Per-model routers fit different curves, so this is where multi-model
        routing divergence is visible as a number.

        Args:
            a: executor judged cheaper below the cut-point.
            b: executor judged cheaper above it.
            lo: grid lower bound (defaults to the curves' joint minimum).
            hi: grid upper bound (defaults to the curves' joint maximum).
            grid_points: resolution of the crossing search.

        Returns:
            The crossing PSGS, ``0.0`` when ``b`` is cheaper everywhere and
            ``inf`` when ``a`` is (mirroring
            ``CalibrationResult.threshold``). Load-aware scaling is ignored
            — the cut-point describes the calibrated curves, not the
            instantaneous queue state.

        Raises:
            KeyError: if either name was never registered.
        """
        ca, cb = self._curves[a], self._curves[b]
        stat_a = _policy_stat(self.policy, self._kinds[a])
        stat_b = _policy_stat(self.policy, self._kinds[b])
        lo = float(min(ca.psgs.min(), cb.psgs.min()) if lo is None else lo)
        hi = float(max(ca.psgs.max(), cb.psgs.max()) if hi is None else hi)
        grid = np.linspace(lo, hi, int(grid_points))
        diff = ca.eval(grid, stat_a) - cb.eval(grid, stat_b)
        sign = np.signbit(diff)
        flips = np.flatnonzero(sign[1:] != sign[:-1])
        if flips.size == 0:
            return float("inf") if diff[-1] < 0 else 0.0
        i = flips[0]
        x0, x1, d0, d1 = grid[i], grid[i + 1], diff[i], diff[i + 1]
        denom = d1 - d0
        if abs(denom) < 1e-15:
            return float(x0)
        return float(np.clip(x0 + (x1 - x0) * (0 - d0) / denom, lo, hi))

    def _eligible(self, seeds: np.ndarray) -> list[str]:
        names = [n for n in self._curves
                 if n not in self._executors
                 or getattr(self._executors[n], "supports",
                            lambda _s: True)(seeds)]
        # degrade rather than refuse: if nothing claims support, consider all
        return names or list(self._curves)

    def route(self, seeds: np.ndarray) -> str:
        """Pick the executor with the minimal policy-selected estimate.

        Args:
            seeds: ``(B,)`` seed ids of the batch (``-1`` padding ignored).

        Returns:
            The chosen executor's name; the choice is tallied in
            :attr:`routed`. Ineligible executors (``supports`` returned
            ``False``) are skipped unless that would leave none.

        Raises:
            RuntimeError: if no executor was ever registered.
        """
        if not self._curves:
            raise RuntimeError("no executors registered")
        q = self.batch_cost(seeds)
        best, best_e = None, float("inf")
        for name in self._eligible(seeds):
            e = self.estimate(name, q)
            if e < best_e:
                best, best_e = name, e
        self.routed[best] += 1
        if trace.on:
            trace.note(predicted_s=best_e)
        return best


class HybridScheduler:
    """Binary PSGS-threshold routing — the paper's scheduler, kept as the
    2-executor special case of :class:`CostModelRouter`."""

    def __init__(self, psgs_table: np.ndarray, threshold: float,
                 policy: str = "latency_preferred"):
        self.psgs_table = psgs_table
        self.threshold = float(threshold)
        self.policy = policy
        self.routed = {"host": 0, "device": 0}

    @staticmethod
    def from_calibration(psgs_table: np.ndarray, calib: CalibrationResult,
                         policy: str = "latency_preferred") -> "HybridScheduler":
        return HybridScheduler(psgs_table, calib.threshold(policy), policy)

    def batch_cost(self, seeds: np.ndarray) -> float:
        return _accumulated_psgs(self.psgs_table, seeds)

    def route(self, seeds: np.ndarray) -> str:
        dest = "host" if self.batch_cost(seeds) < self.threshold else "device"
        self.routed[dest] += 1
        return dest


class StaticScheduler:
    """Baselines: always route to one named executor ("CPU sampling" /
    "GPU"; any registered executor name works)."""

    def __init__(self, dest: str):
        self.dest = dest
        self.routed: dict[str, int] = {dest: 0}

    def route(self, seeds: np.ndarray) -> str:
        self.routed[self.dest] += 1
        return self.dest
