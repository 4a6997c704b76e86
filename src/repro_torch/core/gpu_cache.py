"""Request-granularity device cache in front of the tiered store's cold
path (port of the reference's ``core/gpu_cache.py``).

FAP placement adapts only once a control step: a flash-crowd node stays in
a cold tier, paying a host fetch per access, for a whole adaptive interval.
This cache closes that gap with the ``GPUCachedFeature`` pattern: a
fixed-capacity device row buffer probed *before* the tier path, so a cold
row comes from host or disk at most once per residency.

  query(ids)    -> (values, miss_index, miss_ids): a full-width
                ``index_select`` of the cached rows and a ``where`` mask,
                plus the positions and ids the tier path must resolve.
  replace(ids, rows)  admits the missed rows on return; eviction is CLOCK
                (second chance) weighted by the shared
                :class:`~repro_torch.serving.adaptive.FrequencySketch`: a
                resident hotter than the candidate is never evicted for
                it, and when every resident is hotter the admission is
                rejected (one cold sweep cannot flush the crowd).

Consistency: cached rows are copies of the feature values and migration
moves rows with their nodes, so a stale entry never changes a lookup; the
store still invalidates migrated ids (capacity hygiene).

The row buffer is replaced, never written in place: ``replace`` builds a
new tensor with an out-of-place ``index_copy`` and publishes it under the
lock. A ``query`` that captured the previous buffer with its slots then
issues its gather; on the card a later write into a slot that query read
would run first on the same stream and hand it another node's row, which
the new tensor rules out. All host-side tables change under one lock.
"""
from __future__ import annotations

import threading

import numpy as np
import torch


def _new_cache_stats() -> dict[str, int]:
    return {"hits": 0, "misses": 0, "evictions": 0, "admitted": 0,
            "rejected": 0, "invalidated": 0, "resizes": 0}


class GPUFeatureCache:
    """Fixed-capacity device feature-row cache with sketch-weighted CLOCK
    eviction.

    Sits in front of the store's lookups (attach with
    :meth:`TieredFeatureStore.attach_cache`): the store queries it for cold
    (HOST/DISK) ids only, serves hits from the device buffer and admits
    the missed rows on return. Thread-safe; the
    :class:`~repro_torch.serving.adaptive.AdaptiveController` may
    :meth:`resize` it live.

    Attributes:
        capacity: current row capacity (changed only by :meth:`resize`).
        sketch: optional shared frequency sketch (duck-typed: ``counts``)
            weighting eviction and resize retention.
        stats: hits/misses/evictions/admitted/rejected/invalidated/resizes;
            the store mirrors the first three into its dispatch stats.
    """

    def __init__(self, num_nodes: int, capacity: int, feat_dim: int, *,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda", sketch=None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.num_nodes = int(num_nodes)
        self.capacity = int(capacity)
        self.feat_dim = int(feat_dim)
        self.sketch = sketch
        self.stats = _new_cache_stats()
        self._lock = threading.Lock()
        self._rows = torch.zeros((self.capacity, self.feat_dim), dtype=dtype,
                                 device=device)
        self._slot_of = np.full(self.num_nodes, -1, np.int32)
        self._node_of = np.full(self.capacity, -1, np.int64)
        self._ref = np.zeros(self.capacity, bool)   # second-chance bits
        self._hand = 0
        self._free = list(range(self.capacity - 1, -1, -1))

    @staticmethod
    def for_store(store, capacity: int, *, sketch=None) -> "GPUFeatureCache":
        """A cache shaped for ``store``: node count, feature width, dtype
        and device read off the store."""
        return GPUFeatureCache(int(store.plan.tier.shape[0]), capacity,
                               store.feat_dim, dtype=store.hot.dtype,
                               device=store.device, sketch=sketch)

    # -- read path -------------------------------------------------------------
    def query(self, ids) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
        """Probe the cache for one id vector.

        Args:
            ids: ``(M,)`` int node ids (numpy); ``-1`` entries are "not
                asked" and are neither hits nor misses.

        Returns:
            ``(values, miss_index, miss_ids)``: ``values`` ``(M, d)`` on
            the device, hit rows filled and every other row zero;
            ``miss_index`` the positions asked but not resident;
            ``miss_ids`` is ``ids[miss_index]``. Hit slots get their
            second-chance bit set.
        """
        ids_np = np.asarray(ids).reshape(-1)
        safe = np.maximum(ids_np, 0)
        with self._lock:
            slots = self._slot_of[safe].copy()
            rows = self._rows          # coherent with slots: replaced, never
            hit = (ids_np >= 0) & (slots >= 0)   # written, under this lock
            if hit.any():
                self._ref[slots[hit]] = True
            self.stats["hits"] += int(hit.sum())
            self.stats["misses"] += int(((ids_np >= 0) & ~hit).sum())
        sidx = torch.from_numpy(np.where(hit, slots, -1).astype(np.int32)
                                ).to(rows.device)
        gathered = rows.index_select(0, sidx.clamp_min(0))
        values = torch.where((sidx >= 0)[:, None], gathered, 0.0)
        miss_index = np.flatnonzero((ids_np >= 0) & ~hit)
        return values, miss_index, ids_np[miss_index]

    # -- admission / eviction --------------------------------------------------
    def _evict_slot(self, cand: int, counts) -> tuple[int, int]:
        """CLOCK scan for a slot to hand to ``cand``. Pass 1 honors
        second-chance bits and frequency protection; pass 2 drops the
        second chances but keeps protection. Returns ``(slot, evicted)``
        with ``slot == -1`` when every resident is hotter than the
        candidate (admission rejected)."""
        cand_w = np.inf if counts is None else float(counts[cand])
        for honor_ref in (True, False):
            for _ in range(self.capacity):
                s = self._hand
                self._hand = (self._hand + 1) % self.capacity
                if honor_ref and self._ref[s]:
                    self._ref[s] = False
                    continue
                resident = int(self._node_of[s])
                if (counts is not None and resident >= 0
                        and float(counts[resident]) > cand_w):
                    continue
                if resident >= 0:
                    self._slot_of[resident] = -1
                    self._node_of[s] = -1
                    self._ref[s] = False
                    return s, 1
                return s, 0
        return -1, 0

    def replace(self, ids, rows: torch.Tensor) -> int:
        """Admit missed rows.

        Args:
            ids: ``(K,)`` node ids to admit (duplicates collapsed; ``-1``
                and already-resident ids skipped, since a racing lane may
                have admitted first).
            rows: ``(K, d)`` rows aligned with ``ids`` (tensor on any
                device, or numpy); copied into a new cache buffer.

        Returns:
            Resident rows evicted to make room (admissions into free slots
            and rejected admissions evict nothing).
        """
        ids_np = np.asarray(ids).reshape(-1)
        if ids_np.size == 0:
            return 0
        uniq, first = np.unique(ids_np, return_index=True)
        valid = uniq >= 0
        evicted = 0
        slots_out: list[int] = []
        take_idx: list[int] = []
        with self._lock:
            counts = None if self.sketch is None else self.sketch.counts
            for u, src in zip(uniq[valid], first[valid]):
                u = int(u)
                if self._slot_of[u] >= 0:
                    continue
                if self._free:
                    s = self._free.pop()
                else:
                    s, ev = self._evict_slot(u, counts)
                    if s < 0:
                        self.stats["rejected"] += 1
                        continue
                    evicted += ev
                self._slot_of[u] = s
                self._node_of[s] = u
                self._ref[s] = False
                slots_out.append(s)
                take_idx.append(int(src))
            self.stats["evictions"] += evicted
            self.stats["admitted"] += len(slots_out)
            if slots_out:
                # a batch larger than the cache evicts its own earlier
                # admissions: each slot keeps the row of its last (final)
                # owner, written once (index_copy's duplicates are unordered)
                final = dict(zip(slots_out, take_idx))
                dev = self._rows.device
                vals = torch.as_tensor(rows).to(dev)[
                    torch.tensor(list(final.values()), device=dev)]
                self._rows = self._rows.index_copy(
                    0, torch.tensor(list(final), device=dev),
                    vals.to(self._rows.dtype))
        return evicted

    # -- maintenance -----------------------------------------------------------
    def invalidate(self, ids) -> int:
        """Drop the given ids (no-op for non-resident ids). The store calls
        this for exactly the migrated nodes: capacity hygiene, values never
        change on migration. Returns the rows dropped."""
        ids_np = np.unique(np.asarray(ids).reshape(-1))
        n = 0
        with self._lock:
            for u in ids_np:
                u = int(u)
                if u < 0 or self._slot_of[u] < 0:
                    continue
                s = int(self._slot_of[u])
                self._slot_of[u] = -1
                self._node_of[s] = -1
                self._ref[s] = False
                self._free.append(s)
                n += 1
            self.stats["invalidated"] += n
        return n

    def resize(self, capacity: int) -> int:
        """Rebuild the cache at a new capacity into a new buffer, keeping
        the hottest residents (by sketch weight; insertion order without a
        sketch). Returns the residents dropped by a shrink (counted as
        evictions)."""
        capacity = max(1, int(capacity))
        with self._lock:
            if capacity == self.capacity:
                return 0
            resident = np.flatnonzero(self._node_of >= 0)
            nodes = self._node_of[resident]
            if nodes.size > capacity:
                if self.sketch is not None:
                    order = np.argsort(-np.asarray(self.sketch.counts)[nodes],
                                       kind="stable")
                else:
                    order = np.arange(nodes.size)
                keep = np.sort(order[:capacity])
            else:
                keep = np.arange(nodes.size)
            dropped = int(nodes.size - keep.size)
            kept_slots = resident[keep]
            kept_nodes = nodes[keep]
            new_rows = self._rows.new_zeros((capacity, self.feat_dim))
            if keep.size:
                new_rows[:keep.size] = self._rows[
                    torch.from_numpy(kept_slots).to(self._rows.device)]
            self._slot_of[nodes] = -1
            self._slot_of[kept_nodes] = np.arange(keep.size, dtype=np.int32)
            node_of = np.full(capacity, -1, np.int64)
            node_of[:keep.size] = kept_nodes
            ref = np.zeros(capacity, bool)
            ref[:keep.size] = self._ref[kept_slots]
            self._rows, self._node_of, self._ref = new_rows, node_of, ref
            self._free = list(range(capacity - 1, keep.size - 1, -1))
            self._hand = 0
            self.capacity = capacity
            self.stats["evictions"] += dropped
            self.stats["resizes"] += 1
        return dropped

    # -- introspection ---------------------------------------------------------
    def resident_rows(self) -> int:
        """Rows currently cached."""
        with self._lock:
            return int((self._node_of >= 0).sum())

    def report(self) -> dict:
        """Counters and sizing for logs: stats, capacity, resident rows and
        the lifetime hit rate."""
        with self._lock:
            stats = dict(self.stats)
            resident = int((self._node_of >= 0).sum())
            capacity = self.capacity
        asked = stats["hits"] + stats["misses"]
        return {**stats, "capacity": capacity, "resident": resident,
                "hit_rate": stats["hits"] / asked if asked else 0.0}
