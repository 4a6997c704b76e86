"""Sketch-driven asynchronous prefetcher for the cold feature tiers (port of
the reference's ``core/prefetch.py``).

The paper's feature-aggregation argument is that host–device data movement
must stay off the request's critical path. :class:`Prefetcher` predicts the
next window's cold-tier (HOST/DISK) hits from a decayed seed-frequency
sketch (or any score vector, e.g. the adaptive controller's freshly
recomputed FAP), reads those rows on a background thread (host RAM and the
spill file, never the request path), uploads them and publishes them as
the store's device stage.

Double buffering: the published stage keeps serving lookups while the next
one is built; :meth:`TieredFeatureStore.publish_stage` swaps it in
atomically. Staged rows are copies of the feature values, so prefetching
never changes a lookup result, it only removes host round trips.

On the card the upload rides a side CUDA stream from pinned memory into a
buffer allocated on the stream the lookups use (the current stream of the
refreshing thread, the default stream, as on every executor lane): the
side stream first waits for that stream (the block may have been freed by
work still queued there), the buffer is marked as used by the side stream,
and the refresh thread waits for the copy to complete before publishing.
So no lookup sees a partly copied stage, and the allocator hands the
previous stage's memory out again only in the lookups' own stream order.

Wire-up, standalone (engine hooks feed the sketch; an async refresh every
``refresh_every`` completed batches)::

    pf = Prefetcher(store, sketch, budget=1024, refresh_every=32)
    engine = ServingEngine(executors, router, hooks=[pf])

or driven by the adaptive control loop (shared sketch, refresh every
control step at a tuned cadence)::

    controller = AdaptiveController(..., prefetcher=pf)
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.placement import TIER_HOST


class Prefetcher:
    """Double-buffered cold-row prefetcher over a
    :class:`~repro_torch.core.feature_store.TieredFeatureStore`.

    Attributes:
        store: the store whose stage this prefetcher owns (duck-typed:
            ``tier_np``, ``device``, ``read_cold_rows``, ``publish_stage``).
        sketch: optional seed-frequency sketch (``observe`` + ``counts``)
            used for prediction when no score vector is given; fed by
            :meth:`on_admit` when the prefetcher is an engine hook.
        budget: max rows staged per refresh (the stage's size); read at
            :meth:`predict` time, so the controller may re-assign it live.
        refresh_every: when set, :meth:`on_batch_complete` triggers an async
            refresh every that many completed batches (standalone mode).
        refresh_every_s: wall-clock twin of ``refresh_every`` (whichever
            fires first).
        clock: zero-arg seconds source for the time-based cadence.
    """

    def __init__(self, store, sketch=None, *, budget: int = 1024,
                 refresh_every: Optional[int] = None,
                 refresh_every_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if budget <= 0:
            raise ValueError(f"budget must be positive, got {budget}")
        self.store = store
        self.sketch = sketch
        self.budget = int(budget)
        self.refresh_every = refresh_every
        self.refresh_every_s = refresh_every_s
        self.clock = clock
        self.stats = {"refreshes": 0, "staged_rows": 0, "skipped": 0,
                      "batches_seen": 0}
        self._last_refresh_t = clock()
        self._lock = threading.Lock()
        self._refresh_lock = threading.Lock()
        self._inflight: Optional[Future] = None
        self._error: Optional[BaseException] = None
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="prefetch")
        self._copy_stream = None   # side CUDA stream, made at first upload

    # -- engine hook protocol --------------------------------------------------
    def on_admit(self, name: str, seeds: np.ndarray, model: str = "") -> None:
        """Engine hook: feed the admitted batch's seeds into the sketch
        (no-op without one)."""
        if self.sketch is not None:
            self.sketch.observe(seeds)

    def on_batch_complete(self, name: str, seeds: np.ndarray,
                          latency_s: float, model: str = "") -> None:
        """Engine hook: count completions and, in standalone mode, kick an
        async refresh each period, then decay the (owned) sketch so
        predictions track the recent mix."""
        with self._lock:
            self.stats["batches_seen"] += 1
            due = (self.refresh_every is not None
                   and self.stats["batches_seen"] % self.refresh_every == 0)
            if not due and self.refresh_every_s is not None:
                now = self.clock()
                due = now - self._last_refresh_t >= self.refresh_every_s
            if due:
                self._last_refresh_t = self.clock()
        if due:
            self.refresh_async()
            decay = getattr(self.sketch, "decay_step", None)
            if decay is not None:
                decay()

    # -- prediction + staging --------------------------------------------------
    def predict(self, scores: Optional[np.ndarray] = None) -> np.ndarray:
        """Node ids to stage: the top-``budget`` cold-tier nodes by score
        (``scores`` defaults to the sketch's decayed counts). Zero-score
        nodes are never staged. Tiers come from the store's host mirror.

        Raises:
            ValueError: with neither ``scores`` nor a sketch.
        """
        if scores is None:
            if self.sketch is None:
                raise ValueError("predict() needs scores or a sketch")
            scores = self.sketch.counts
        scores = np.asarray(scores, dtype=np.float64)
        tier = self.store.tier_np
        cold = np.flatnonzero((tier >= TIER_HOST) & (scores > 0.0))
        if not cold.size:
            return cold
        order = np.argsort(-scores[cold], kind="stable")
        return cold[order[:self.budget]]

    def _upload(self, rows: np.ndarray) -> torch.Tensor:
        """The staged rows on the store's device, their copy completed (see
        the module docstring for the stream discipline on the card)."""
        host = torch.from_numpy(rows)
        dev = self.store.device
        if dev.type != "cuda":
            return host.to(dev)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=dev)
        side = self._copy_stream
        consumer = torch.cuda.current_stream(dev)
        buf = torch.empty(host.shape, dtype=host.dtype, device=dev)
        pinned = host.pin_memory()
        side.wait_stream(consumer)
        with torch.cuda.stream(side):
            buf.copy_(pinned, non_blocking=True)
        buf.record_stream(side)
        side.synchronize()
        return buf

    def refresh(self, scores: Optional[np.ndarray] = None) -> int:
        """Synchronously rebuild and publish the stage: predict, read the
        rows on the host, upload, publish; the previous stage serves until
        the swap. With nothing to stage the stage is cleared.

        Args:
            scores: optional per-node hotness (defaults to sketch counts).

        Returns:
            Rows staged.
        """
        with self._refresh_lock:
            ids = self.predict(scores)
            if ids.size == 0:
                self.store.publish_stage(None, None)
                staged = 0
            else:
                rows = self._upload(self.store.read_cold_rows(ids))
                stage_slot = np.full(self.store.tier_np.shape[0], -1,
                                     np.int32)
                stage_slot[ids] = np.arange(ids.size, dtype=np.int32)
                self.store.publish_stage(stage_slot, rows)
                staged = int(ids.size)
            with self._lock:
                self.stats["refreshes"] += 1
                self.stats["staged_rows"] = staged
            return staged

    def refresh_async(self, scores: Optional[np.ndarray] = None
                      ) -> Optional[Future]:
        """Submit a refresh to the background worker; returns its future,
        or ``None`` when one is already in flight (dropped, not queued).
        A worker error is kept and re-raised by the next
        :meth:`refresh_async` or :meth:`close`."""
        with self._lock:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            if self._inflight is not None and not self._inflight.done():
                self.stats["skipped"] += 1
                return None
            fut = self._pool.submit(self.refresh, scores)
            self._inflight = fut
        fut.add_done_callback(self._done)
        return fut

    def _done(self, fut: Future) -> None:
        exc = fut.exception()
        if exc is not None:
            with self._lock:
                if self._error is None:
                    self._error = exc

    def report(self) -> dict:
        """Prefetch counters: refreshes, rows staged by the last refresh,
        skipped overlapping refreshes, batches seen."""
        with self._lock:
            return dict(self.stats)

    def close(self) -> None:
        """Drain the background worker and clear the published stage;
        re-raises the last background refresh failure, if any."""
        self._pool.shutdown(wait=True)
        self.store.publish_stage(None, None)
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err
