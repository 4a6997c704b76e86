"""Tiered feature store (paper §5.3) on one host and one device.

  HOT   rows live in device memory (replicated in a multi-device layout).
  WARM  rows live in device memory (partitioned in a multi-device layout).
  HOST  rows live in host RAM (numpy).
  DISK  rows live in an mmap-backed spill tier (:class:`DiskSpillTier`).

Every lookup reads one consistent snapshot of the tier tables. The device
tiers are gathered by the hand-written ``tiered_gather`` kernel
(:meth:`TieredFeatureStore.lookup_hops`) or folded into the layer-1
aggregation by ``gather_aggregate``
(:meth:`TieredFeatureStore.lookup_aggregate`). A cold (HOST/DISK) row
comes from one of three places, tried in order:

  1. an attached device cache (:class:`~repro_torch.core.gpu_cache.
     GPUFeatureCache`, :meth:`TieredFeatureStore.attach_cache`): hits skip
     the tier path; misses are admitted on return;
  2. the prefetch stage (:meth:`TieredFeatureStore.publish_stage`, fed by
     :class:`~repro_torch.core.prefetch.Prefetcher`): a device buffer of
     predicted cold rows;
  3. the host, through one gateway, :meth:`TieredFeatureStore._host_fetch`:
     an address-sorted numpy gather and one host→device copy.

Placement changes online: :meth:`TieredFeatureStore.swap_assignments`
exchanges the placements (and rows) of node pairs and
:meth:`TieredFeatureStore.promote_misses` swaps miss-hammered DISK rows up
into HOST. Tables are replaced, never written in place: a swap builds new
device tables with an out-of-place ``index_copy`` and new numpy mirrors,
and publishes them in one critical section, so a lookup that holds the
previous snapshot keeps reading coherent rows while kernels already queued
on the stream read the old tensors. Rows travel with their nodes, so a
lookup returns the same bits whatever the placement, the cache or the
stage hold.

The ``(N,)`` tier/slot tables are kept twice: as int32 device tensors
(the device-side gathers index them) and as numpy mirrors published in the
same snapshot, so host-side address resolution never copies a whole table
back from the device.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.placement import (PlacementPlan, TIER_DISK, TIER_HOST,
                                        TIER_HOT, TIER_NAMES, TIER_WARM)
from repro_torch.graph.sampler import fixed_size_unique
from repro_torch.kernels.gather_aggregate.ops import gather_aggregate
from repro_torch.kernels.tiered_gather.ops import tiered_gather

# Dispatch counters, the reference's schema.
STATS_SCHEMA: tuple = (
    "lookup_calls", "fused_calls", "fused_aggregates", "device_gathers",
    "host_fetches", "disk_misses", "spill_reads", "prefetch_hits",
    "prefetch_misses", "cache_hits", "cache_misses", "cache_evictions")


def _new_stats() -> dict[str, int]:
    """Zeroed dispatch counters:

      lookup_calls / fused_calls   per-hop vs fused lookup entries
      fused_aggregates             ``lookup_aggregate`` entries
      device_gathers               device-tier gather dispatches, counted
                                   where they are issued (0 when every
                                   valid id was a cold cache hit)
      host_fetches                 host→device cold fetches actually issued
      disk_misses                  DISK rows read on the critical path
      spill_reads                  DISK rows read by the critical path
                                   and by prefetch reads
      prefetch_hits / _misses      cold rows served from the stage / sent
                                   to the host while a stage was published
      cache_hits / cache_misses    cold rows served by / missing the cache
      cache_evictions              residents displaced by admissions
    """
    return dict.fromkeys(STATS_SCHEMA, 0)


class DiskSpillTier:
    """mmap-backed DISK tier: one spill file + a copy-on-write overlay.

    The backing array is written once (at :meth:`TieredFeatureStore.build`)
    and then only read: with ``path`` it is an ``np.memmap`` reopened
    read-only, so cold rows live on disk, not in RAM. Rows written later
    land in a dict overlay instead of the file; ``copy()`` duplicates only
    the overlay. Indexing reads the backing store and applies the overlay.
    """

    def __init__(self, base: np.ndarray,
                 overlay: Optional[dict[int, np.ndarray]] = None,
                 path: Optional[str] = None):
        self._base = base
        self._overlay: dict[int, np.ndarray] = dict(overlay or {})
        self.path = path
        self._root = path       # first-generation file; .gN names derive
        self._generation = 0    # from it across compactions

    @staticmethod
    def build(rows: np.ndarray, path: Optional[str] = None) -> "DiskSpillTier":
        """Write the DISK-tier rows: to an ``np.memmap`` spill file (flushed,
        then reopened read-only) with ``path``, else kept in host memory."""
        if path is None:
            return DiskSpillTier(rows)
        mm = np.memmap(path, dtype=rows.dtype, mode="w+", shape=rows.shape)
        mm[:] = rows
        mm.flush()
        del mm  # close the writable map before reopening read-only
        base = np.memmap(path, dtype=rows.dtype, mode="r", shape=rows.shape)
        return DiskSpillTier(base, path=path)

    @property
    def shape(self) -> tuple:
        return self._base.shape

    @property
    def dtype(self) -> np.dtype:
        return self._base.dtype

    @property
    def overlay_rows(self) -> int:
        return len(self._overlay)

    def __len__(self) -> int:
        return self._base.shape[0]

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            hit = self._overlay.get(int(idx))
            return hit if hit is not None else np.asarray(self._base[idx])
        idx = np.asarray(idx)
        rows = np.asarray(self._base[idx])  # fancy indexing always copies
        if self._overlay:
            keys = np.fromiter(self._overlay, dtype=np.int64,
                               count=len(self._overlay))
            flat = idx.ravel()
            for i in np.flatnonzero(np.isin(flat, keys)):
                rows[i] = self._overlay[int(flat[i])]
        return rows

    def __setitem__(self, idx, vals) -> None:
        """Writes go to the overlay, never to the spill file."""
        idx = np.atleast_1d(np.asarray(idx))
        vals = np.atleast_2d(np.asarray(vals))
        for slot, row in zip(idx.ravel(), vals):
            self._overlay[int(slot)] = np.array(row)

    def copy(self) -> "DiskSpillTier":
        """Copy-on-write duplicate: shares the backing store, copies only
        the overlay."""
        dup = DiskSpillTier(self._base, self._overlay, self.path)
        dup._root, dup._generation = self._root, self._generation
        return dup

    @property
    def resident_nbytes(self) -> int:
        """Host-RAM bytes held: the overlay plus, without a spill file, the
        backing array."""
        row = int(self._base.itemsize * np.prod(self._base.shape[1:]))
        base = 0 if self.path is not None else int(self._base.nbytes)
        return base + row * len(self._overlay)

    def compact(self) -> "DiskSpillTier":
        """Fold the overlay into a fresh backing store (a new generation
        file ``<path>.gN`` with a spill file; the old file is unlinked
        best-effort) and return it as a new tier object."""
        merged = np.asarray(self)
        if self.path is None:
            return DiskSpillTier(merged)
        new_path = f"{self._root}.g{self._generation + 1}"
        fresh = DiskSpillTier.build(merged, new_path)
        fresh._root = self._root
        fresh._generation = self._generation + 1
        try:
            os.unlink(self.path)
        except OSError:
            pass
        return fresh

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = np.array(self._base)
        for slot, row in self._overlay.items():
            out[slot] = row
        return out.astype(dtype) if dtype is not None else out


@dataclasses.dataclass(eq=False)
class TieredFeatureStore:
    """Single-host runtime store: HOT/WARM on the device, HOST/DISK on the
    host, one snapshot per lookup; optional device cache and prefetch
    stage in front of the cold tiers; online migration by copy-on-write
    swaps."""

    plan: PlacementPlan
    feat_dim: int
    hot: torch.Tensor         # (n_hot, d) device
    warm: torch.Tensor        # (warm_total, d) device
    host: np.ndarray          # (host_total, d) host RAM
    disk: DiskSpillTier       # (rest, d) spill tier
    tier_t: torch.Tensor      # (N,) int32 device lookup tables
    slot_t: torch.Tensor
    owner_t: torch.Tensor     # (N,) int32 global warm owner (pod*G + dev), -1
    warm_base: torch.Tensor   # (world,) int32 row offset of each warm shard
    tier_np: np.ndarray       # (N,) int32 host mirrors of tier_t / slot_t
    slot_np: np.ndarray
    # every lookup reads (tables, mirrors, tier arrays, stage) as one
    # snapshot taken under this lock; migration and stage publication
    # replace them under it
    _mig_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)
    migrated_rows: int = 0    # lifetime count of rows moved between tiers
    stats: dict = dataclasses.field(default_factory=_new_stats, repr=False)
    _stats_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)
    # prefetch stage: (stage_slot, stage_rows), stage_slot a host-side (N,)
    # int32 table (-1 = unstaged), stage_rows a (budget, d) device buffer
    _stage: Optional[tuple] = dataclasses.field(default=None, repr=False)
    # per-node DISK critical-path miss counts (guarded by _stats_lock), the
    # signal for miss-driven promotion
    _disk_miss_counts: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)
    promoted_rows: int = 0    # lifetime count of miss-driven DISK promotions
    # optional device cache in front of the cold tiers (GPUFeatureCache)
    cache: Optional[object] = dataclasses.field(default=None, repr=False)

    @staticmethod
    def build(features: np.ndarray, plan: PlacementPlan, *,
              spill_path: Optional[str] = None,
              device: str | torch.device = "cuda") -> "TieredFeatureStore":
        """Lay the ``(N, d)`` feature matrix out across the four tiers of
        ``plan`` (the reference's layout: warm rows owner-major, host rows
        pod-major); ``spill_path`` backs the DISK tier with a spill file.
        HOT/WARM rows and the tier/slot/owner tables go to ``device``."""
        dev = resolve_device(device)
        n, d = features.shape
        topo = plan.topology
        world = topo.num_pods * topo.devices_per_pod
        hot_ids = np.flatnonzero(plan.tier == TIER_HOT)
        hot = np.zeros((max(plan.n_hot, 1), d), features.dtype)
        hot[plan.slot[hot_ids]] = features[hot_ids]

        owner_global = np.where(
            plan.tier == TIER_WARM,
            np.maximum(plan.pod_owner, 0).astype(np.int64) * topo.devices_per_pod
            + plan.device_owner, -1)
        counts = np.array([(owner_global == w).sum() for w in range(world)],
                          dtype=np.int64)
        base = np.zeros(world, dtype=np.int64)
        np.cumsum(counts[:-1], out=base[1:])
        warm = np.zeros((max(int(counts.sum()), 1), d), features.dtype)
        warm_ids = np.flatnonzero(plan.tier == TIER_WARM)
        warm_rows = base[owner_global[warm_ids]] + plan.slot[warm_ids]
        warm[warm_rows] = features[warm_ids]

        host_ids = np.flatnonzero(plan.tier == TIER_HOST)
        hcounts = np.zeros(topo.num_pods, dtype=np.int64)
        hbase = np.zeros(topo.num_pods, dtype=np.int64)
        for p in range(topo.num_pods):
            hcounts[p] = ((plan.tier == TIER_HOST)
                          & ((plan.pod_owner == p) | (plan.pod_owner == -1))).sum()
        np.cumsum(hcounts[:-1], out=hbase[1:])
        host = np.zeros((max(int(hcounts.sum()), 1), d), features.dtype)
        hpod = np.maximum(plan.pod_owner[host_ids], 0)
        host[hbase[hpod] + plan.slot[host_ids]] = features[host_ids]

        disk_ids = np.flatnonzero(plan.tier == TIER_DISK)
        disk_rows = np.zeros((max(disk_ids.shape[0], 1), d), features.dtype)
        disk_rows[plan.slot[disk_ids]] = features[disk_ids]
        disk = DiskSpillTier.build(disk_rows, spill_path)

        slot_flat = plan.slot.copy()
        slot_flat[warm_ids] = warm_rows
        slot_flat[host_ids] = hbase[hpod] + plan.slot[host_ids]
        tier_np = plan.tier.astype(np.int32)
        slot_np = slot_flat.astype(np.int32)
        return TieredFeatureStore(
            plan=plan, feat_dim=d,
            hot=torch.as_tensor(hot, device=dev),
            warm=torch.as_tensor(warm, device=dev), host=host, disk=disk,
            tier_t=torch.as_tensor(tier_np, device=dev),
            slot_t=torch.as_tensor(slot_np, device=dev),
            owner_t=torch.as_tensor(owner_global.astype(np.int32),
                                    device=dev),
            warm_base=torch.as_tensor(base.astype(np.int32), device=dev),
            tier_np=tier_np, slot_np=slot_np,
            _disk_miss_counts=np.zeros(n, dtype=np.int64))

    @property
    def device(self) -> torch.device:
        return self.hot.device

    # -- snapshot and accounting ---------------------------------------------
    def _snapshot(self) -> tuple:
        """Consistent view ``(hot, warm, host, disk, tier_t, slot_t,
        tier_np, slot_np, stage)``: tables and the stage are replaced,
        never mutated, so holding the references keeps one coherent
        placement and staging state."""
        with self._mig_lock:
            return (self.hot, self.warm, self.host, self.disk, self.tier_t,
                    self.slot_t, self.tier_np, self.slot_np, self._stage)

    def _count(self, **deltas: int) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self.stats[k] += v

    def reset_stats(self) -> dict[str, int]:
        """Zero the dispatch counters, returning the previous values."""
        with self._stats_lock:
            prev, self.stats = self.stats, _new_stats()
        return prev

    def snapshot_stats(self) -> dict[str, int]:
        """Copy of the dispatch counters without resetting them (the
        adaptive controller reads per-interval deltas from this)."""
        with self._stats_lock:
            return dict(self.stats)

    def tier_histogram(self, ids: np.ndarray) -> dict[str, int]:
        """How many of ``ids`` (``-1`` padding dropped) the plan places in
        each tier."""
        ids = np.asarray(ids)
        t = self.plan.tier[ids[ids >= 0]]
        return {TIER_NAMES[k]: int((t == k).sum())
                for k in (TIER_HOT, TIER_WARM, TIER_HOST, TIER_DISK)}

    def attach_cache(self, cache) -> "TieredFeatureStore":
        """Attach (``None`` detaches) a device cache
        (:class:`~repro_torch.core.gpu_cache.GPUFeatureCache`) in front of
        the cold tiers: lookups probe it for HOST/DISK ids before the tier
        path, serve hits from device memory and admit misses on return.
        Cached rows are copies of the feature values, so attaching or
        detaching never changes a lookup. Returns the store."""
        with self._mig_lock:
            self.cache = cache
        return self

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids, dtype=torch.int32,
                               device=self.device).reshape(-1)

    # -- lookup ----------------------------------------------------------------
    def lookup(self, ids, *, include_host: bool = True,
               dedup: bool = True) -> torch.Tensor:
        """Gather feature rows for one id vector.

        Args:
            ids: ``(M,)`` node ids (tensor or numpy); ``-1`` entries are
                padding and give all-zero rows.
            include_host: also resolve HOST/DISK ids (cache, stage, then
                :meth:`_host_fetch`); ``False`` returns zeros for them and
                bypasses cache and stage.
            dedup: deduplicate and sort ids (``fixed_size_unique``) first.

        Returns:
            ``(M, d)`` rows in input order, from one snapshot.
        """
        snap = self._snapshot()
        self._count(lookup_calls=1)
        ids = self._ids(ids)
        if dedup:
            uniq, inv = fixed_size_unique(ids, int(ids.shape[0]))
            out = self._cached_unique(uniq, include_host, snap,
                                      fused=False)[inv.long()]
        else:
            out = self._cached_unique(ids, include_host, snap, fused=False)
        return torch.where((ids >= 0)[:, None], out, 0.0)

    def lookup_hops(self, hops: Sequence, *,
                    include_host: bool = True) -> list[torch.Tensor]:
        """Fused feature collection for a whole layered sample: dedup all
        hops at once, one address-sorted ``tiered_gather`` over HOT/WARM,
        cold rows from the cache, the stage or at most one host fetch,
        then scatter rows back per hop. Bit-identical to
        ``[self.lookup(h) for h in hops]``.

        Args:
            hops: id vectors (seeds first), each ``(M_k,)`` with ``-1``
                padding; at least one non-empty.
            include_host: as in :meth:`lookup`.

        Returns:
            One ``(M_k, d)`` matrix per hop.

        Raises:
            ValueError: every hop is empty.
        """
        hops_t = [self._ids(h) for h in hops]
        sizes = [int(h.shape[0]) for h in hops_t]
        total = sum(sizes)
        if total == 0:
            raise ValueError("lookup_hops needs at least one non-empty hop")
        snap = self._snapshot()
        self._count(fused_calls=1)
        ids = torch.cat(hops_t)
        uniq, inv = fixed_size_unique(ids, total)
        rows = self._cached_unique(uniq, include_host, snap, fused=True)
        out = torch.where((ids >= 0)[:, None], rows[inv.long()], 0.0)
        return list(torch.split(out, sizes))

    def lookup_aggregate(self, hops: Sequence, *, include_host: bool = True
                         ) -> tuple[list[torch.Tensor], torch.Tensor]:
        """Fused feature collection + innermost-hop segment sum in one
        ``gather_aggregate`` launch: the dense ``(n_sampled, d)`` neighbor
        tensor is never materialized. Outer-hop rows ride in the same
        launch as singleton segments; cold (HOST/DISK) ids are resolved
        first, through the cache, the stage and the host gateway exactly as
        :meth:`lookup_hops` resolves them, into a side table addressed as
        tier 2, in the place host rows always took.

        The aggregate is bit-identical to :meth:`lookup_hops` followed by
        the model's fp32 in-order fan sum (``kernels.gather_aggregate.
        fan_sum``), on the CPU and on the card, with or without cache,
        stage and migration.

        Args:
            hops: ≥ 2 id vectors (seeds first); the innermost has
                ``len(hops[-2]) * fan`` entries, ``-1`` for absent children.
            include_host: as in :meth:`lookup`; ``False`` makes cold
                children contribute zero rows.

        Returns:
            ``(feats, agg_sum)``: ``feats`` the rows of ``hops[:-1]``
            (bit-identical to ``lookup_hops(hops)[:-1]``), ``agg_sum`` the
            ``(len(hops[-2]), d)`` per-parent child-row sums.

        Raises:
            ValueError: fewer than two hops, or the innermost hop is not a
                whole multiple of the previous one.
        """
        hops_t = [self._ids(h) for h in hops]
        sizes = [int(h.shape[0]) for h in hops_t]
        if len(hops_t) < 2:
            raise ValueError(
                "lookup_aggregate needs seeds plus at least one frontier")
        p, n_inner = sizes[-2], sizes[-1]
        if p == 0 or n_inner == 0 or n_inner % p:
            raise ValueError(
                "innermost hop must be a (P*fan,) frontier of the previous "
                f"hop, got sizes {sizes[-2:]}")
        fan = n_inner // p
        total = sum(sizes)
        n_outer = total - n_inner
        snap = self._snapshot()
        hot, warm = snap[0], snap[1]
        tier_tab, slot_tab = snap[6], snap[7]
        self._count(fused_calls=1, fused_aggregates=1)
        ids = torch.cat(hops_t)
        uniq, inv = fixed_size_unique(ids, total)
        # one device→host copy for everything the host-side address
        # resolution needs
        host_view = torch.cat([uniq, inv, hops_t[-1]]).cpu().numpy()
        uniq_np = host_view[:total]
        inv_inner = host_view[total + n_outer:2 * total]
        inner_np = host_view[2 * total:]
        valid_u = uniq_np >= 0
        safe = np.maximum(uniq_np, 0)
        tier_np, slot_np = tier_tab[safe], slot_tab[safe]
        cold = valid_u & (tier_np >= TIER_HOST)
        cold_idx = np.flatnonzero(cold)
        # per-unique kernel addresses: 0=hot, 1=warm, 2=cold table, 99=skip
        ktier = np.full(total, 99, np.int32)
        ktier[valid_u & (tier_np == TIER_HOT)] = 0
        ktier[valid_u & (tier_np == TIER_WARM)] = 1
        kslot = slot_np.copy()
        if include_host and cold_idx.size:
            # only the cold ids go through the cache and the stage, in
            # unique order; no device copy of them is made unless the
            # cache answers some
            cold_buf = self._cached_unique(None, include_host, snap,
                                           fused=True, cold_only=True,
                                           uniq_np=uniq_np[cold_idx])
            ktier[cold] = 2
            kslot[cold] = np.arange(cold_idx.size, dtype=np.int32)
        else:
            # device-only probe (or nothing cold): cold children contribute
            # zero rows, like the unfused include_host=False path
            cold_buf = hot.new_zeros((1, self.feat_dim))
        # one singleton segment per unique id (the outer-hop rows), then one
        # fan-wide segment per innermost parent. A -1 child aliases the
        # last unique slot through inv, so it is re-masked to 99 here.
        seg = np.zeros((2, total + p, fan), np.int32)
        seg[0] = 99
        seg[0, :total, 0] = ktier
        seg[1, :total, 0] = kslot
        seg[0, total:] = np.where(inner_np < 0, 99,
                                  ktier[inv_inner]).reshape(p, fan)
        seg[1, total:] = np.where(inner_np < 0, 0,
                                  kslot[inv_inner]).reshape(p, fan)
        seg_t = torch.from_numpy(seg).to(self.device)
        self._count(device_gathers=1)
        out = gather_aggregate(seg_t[0], seg_t[1], hot, warm, cold_buf)
        outer_rows = torch.where((ids[:n_outer] >= 0)[:, None],
                                 out[:total][inv[:n_outer].long()], 0.0)
        return list(torch.split(outer_rows, sizes[:-1])), out[total:]

    # -- tier paths ------------------------------------------------------------
    def _cached_unique(self, uniq: Optional[torch.Tensor],
                       include_host: bool, snap: tuple, *, fused: bool,
                       cold_only: bool = False,
                       uniq_np: Optional[np.ndarray] = None) -> torch.Tensor:
        """Route one id vector through the optional device cache, then the
        tier path for whatever remains.

        Cold (HOST/DISK) ids probe the cache first; hits are blanked to
        ``-1`` in the tier path's id vector, so they never reach the tier
        gather, the stage or the host. Missed rows flow through the tier
        path and are admitted on return. When every valid id is a cold
        cache hit the tier gather is skipped: ``device_gathers`` is counted
        here, where the gather is issued (1 per fused call, 2 per plain
        lookup, 0 for ``cold_only``, whose caller launches its own
        kernel). ``include_host=False`` bypasses the cache. ``uniq_np`` is
        ``uniq`` on the host when the caller already copied it; with
        ``cold_only`` it is the only form given (``uniq`` is ``None``).
        """
        gathers = 0 if cold_only else (1 if fused else 2)
        if cold_only:
            tier_path = self._cold_unique
        else:
            tier_path = self._fused_unique if fused else self._lookup_unique
        if include_host and uniq_np is None:
            uniq_np = uniq.cpu().numpy()
        # a single reference read: any published cache (or None) is valid,
        # cached rows being copies of the feature values
        cache = self.cache
        if cache is None or not include_host:
            self._count(device_gathers=gathers)
            return tier_path(uniq, uniq_np, include_host, snap)
        tier_np = snap[6][np.maximum(uniq_np, 0)]
        cold = (uniq_np >= 0) & (tier_np >= TIER_HOST)
        if not cold.any():
            self._count(device_gathers=gathers)
            return tier_path(uniq, uniq_np, include_host, snap)
        values, miss_index, miss_ids = cache.query(
            np.where(cold, uniq_np, -1))
        hit = cold.copy()
        hit[miss_index] = False
        self._count(cache_hits=int(hit.sum()),
                    cache_misses=int(miss_index.size))
        if not ((uniq_np >= 0) & ~hit).any():
            return values        # every valid id was a cold cache hit
        eff_np = np.where(hit, -1, uniq_np).astype(np.int32)
        eff = None if cold_only else torch.from_numpy(eff_np).to(self.device)
        self._count(device_gathers=gathers)
        rows = tier_path(eff, eff_np, include_host, snap)
        out = torch.where(torch.from_numpy(hit).to(self.device)[:, None],
                          values, rows)
        if miss_index.size:
            evicted = cache.replace(
                miss_ids, out[torch.from_numpy(miss_index).to(out.device)])
            self._count(cache_evictions=int(evicted))
        return out

    def _fused_unique(self, uniq: torch.Tensor, uniq_np: Optional[np.ndarray],
                      include_host: bool, snap: tuple) -> torch.Tensor:
        """One gather per tier class for a deduplicated id vector: HOT/WARM
        rows stream through ``tiered_gather`` in ascending (tier, slot)
        order (near-sequential reads, the paper's TLB optimization), and
        HOST/DISK rows come from the stage or one :meth:`_host_fetch`."""
        hot, warm = snap[0], snap[1]
        tier_t, slot_t = snap[4], snap[5]
        safe = uniq.long().clamp_min(0)
        tier, slot = tier_t[safe], slot_t[safe]
        # address-sort key: tier-major, slot-minor; slots clamp into the
        # device-tier span (host-tier slots may exceed it; their gather
        # gives zeros either way), keeping the key inside int32
        span = max(int(hot.shape[0]), int(warm.shape[0]), 1)
        key = tier * span + slot.clamp_max(span - 1)
        order = torch.argsort(key, stable=True)
        dev_sorted = tiered_gather(tier[order], slot[order], hot, warm)
        out = torch.empty_like(dev_sorted)
        out[order] = dev_sorted
        if include_host:
            out = self._resolve_cold(uniq_np, out, snap)
        return torch.where((uniq >= 0)[:, None], out, 0.0)

    def _cold_unique(self, uniq: Optional[torch.Tensor], uniq_np: np.ndarray,
                     include_host: bool, snap: tuple) -> torch.Tensor:
        """Cold-rows-only tier path of :meth:`lookup_aggregate`:
        ``uniq_np`` holds HOST/DISK ids, ``-1`` where the cache answered
        (``uniq`` is unused: no device copy of the ids is needed).
        Their rows come through the stage and the host gateway exactly as
        the full paths resolve them, with no device-tier gather (the fused
        kernel reads HOT/WARM rows itself); ``-1`` positions are zeros.
        With nothing staged and no ``-1``, the host gateway's rows are the
        result as they come."""
        if snap[8] is None and bool((uniq_np >= 0).all()):
            return self._fetch_cold(uniq_np, snap[6][uniq_np],
                                    snap[7][uniq_np], snap)
        out = snap[0].new_zeros((uniq_np.shape[0], self.feat_dim))
        return self._resolve_cold(uniq_np, out, snap)

    def _lookup_unique(self, ids: torch.Tensor, ids_np: Optional[np.ndarray],
                       include_host: bool, snap: tuple) -> torch.Tensor:
        """The per-hop path: one gather from each device tier, selected per
        row, then the cold rows."""
        hot, warm = snap[0], snap[1]
        tier_t, slot_t = snap[4], snap[5]
        safe = ids.long().clamp_min(0)
        tier, slot = tier_t[safe], slot_t[safe].long()
        out = torch.zeros((ids.shape[0], self.feat_dim), dtype=hot.dtype,
                          device=hot.device)
        out = torch.where((tier == TIER_HOT)[:, None],
                          hot[slot.clamp_max(hot.shape[0] - 1)], out)
        out = torch.where((tier == TIER_WARM)[:, None],
                          warm[slot.clamp_max(warm.shape[0] - 1)], out)
        if include_host:
            out = self._resolve_cold(ids_np, out, snap)
        return torch.where((ids >= 0)[:, None], out, 0.0)

    def _resolve_cold(self, ids_np: np.ndarray, out: torch.Tensor,
                      snap: tuple) -> torch.Tensor:
        """Return ``out`` with the HOST/DISK rows of ``ids_np`` filled in
        (the caller owns ``out``).

        Staged ids are gathered from the device stage (a full-width gather
        and a ``where``); the rest fall back to one :meth:`_host_fetch`.
        Tier and slot come from the host mirrors, so no table crosses to
        the host; a lookup whose cold ids are all staged (or that has none)
        issues no fetch. Prefetch hit/miss and DISK counters land in the
        dispatch stats, and each critical-path DISK miss in the per-node
        counts :meth:`promote_misses` reads.
        """
        tier_tab, slot_tab, stage = snap[6], snap[7], snap[8]
        safe = np.maximum(ids_np, 0)
        tier_np, slot_np = tier_tab[safe], slot_tab[safe]
        cold = (tier_np >= TIER_HOST) & (ids_np >= 0)
        if not cold.any():
            return out
        miss = cold
        if stage is not None:
            stage_slot, stage_rows = stage
            sslot = stage_slot[safe]
            hit = cold & (sslot >= 0)
            miss = cold & ~hit
            self._count(prefetch_hits=int(hit.sum()),
                        prefetch_misses=int(miss.sum()))
            if hit.any():
                sidx = torch.from_numpy(
                    np.where(hit, sslot, -1).astype(np.int32)).to(out.device)
                gathered = stage_rows.index_select(0, sidx.clamp_min(0))
                out = torch.where((sidx >= 0)[:, None], gathered, out)
        if miss.any():
            idx = np.flatnonzero(miss)
            out[torch.from_numpy(idx).to(out.device)] = self._fetch_cold(
                ids_np[idx], tier_np[idx], slot_np[idx], snap)
        return out

    def _fetch_cold(self, ids_np: np.ndarray, tier_np: np.ndarray,
                    slot_np: np.ndarray, snap: tuple) -> torch.Tensor:
        """Rows of cold ids that missed cache and stage, through one
        :meth:`_host_fetch`: counts the fetch and its DISK reads, and each
        DISK id in the per-node miss counts :meth:`promote_misses` reads.
        Returns ``(K, d)`` on the device."""
        disk_ids = ids_np[tier_np == TIER_DISK]
        self._count(host_fetches=1, disk_misses=int(disk_ids.size),
                    spill_reads=int(disk_ids.size))
        if disk_ids.size:
            with self._stats_lock:
                if self._disk_miss_counts is not None:
                    np.add.at(self._disk_miss_counts, disk_ids, 1)
        return self._host_fetch(tier_np, slot_np, snap[2], snap[3])

    def _host_fetch(self, tier_np: np.ndarray, slot_np: np.ndarray, host,
                    disk) -> torch.Tensor:
        """The one host→device gateway for cold rows: a numpy gather from
        the HOST and DISK tiers, address-sorted by slot (the paper's TLB
        optimization), then one copy to the device. Returns ``(K, d)``."""
        out = np.zeros((tier_np.shape[0], self.feat_dim), host.dtype)
        for t, store in ((TIER_HOST, host), (TIER_DISK, disk)):
            idx = np.flatnonzero(tier_np == t)
            if idx.size:
                order = np.argsort(slot_np[idx], kind="stable")
                out[idx[order]] = store[slot_np[idx][order]]
        return torch.from_numpy(out).to(self.device)

    # -- prefetch staging ------------------------------------------------------
    def publish_stage(self, stage_slot: Optional[np.ndarray],
                      stage_rows: Optional[torch.Tensor]) -> None:
        """Atomically publish (or clear) the prefetch stage.

        Args:
            stage_slot: ``(N,)`` int32 host table mapping node id → row of
                ``stage_rows`` (``-1`` = unstaged), or ``None`` to clear.
            stage_rows: ``(budget, d)`` device buffer of the staged rows,
                already filled (ignored when ``stage_slot`` is ``None``).
                The caller publishes it only once its copy has completed,
                and keeps it on the stream the lookups use
                (:class:`~repro_torch.core.prefetch.Prefetcher` does both).

        In-flight lookups keep the previous stage; new ones see the new
        one, never a torn mix.
        """
        stage = None if stage_slot is None else (stage_slot, stage_rows)
        with self._mig_lock:
            self._stage = stage

    def staged_rows(self) -> int:
        """Cold rows currently staged on the device (0 = no stage)."""
        with self._mig_lock:
            stage = self._stage
        return 0 if stage is None else int((stage[0] >= 0).sum())

    def read_cold_rows(self, ids: np.ndarray) -> np.ndarray:
        """Read the feature rows of ``ids`` for staging, off the critical
        path: host-side reads of whichever tier holds each row in one
        snapshot, so a migration racing the prefetcher still yields exact
        values. DISK reads count as ``spill_reads``; a row that a
        promotion moved to the device is read from there (only those
        rows cross back).

        Args:
            ids: ``(K,)`` valid node ids (no ``-1`` padding).

        Returns:
            ``(K, d)`` feature rows in ``ids`` order.
        """
        hot, warm, host, disk, _, _, tier_tab, slot_tab, _ = self._snapshot()
        ids = np.asarray(ids)
        tier, slot = tier_tab[ids], slot_tab[ids]
        out = np.zeros((ids.shape[0], self.feat_dim), host.dtype)
        m_host, m_disk = tier == TIER_HOST, tier == TIER_DISK
        if m_host.any():
            out[m_host] = host[slot[m_host]]
        if m_disk.any():
            out[m_disk] = disk[slot[m_disk]]
            self._count(spill_reads=int(m_disk.sum()))
        for t, src in ((TIER_HOT, hot), (TIER_WARM, warm)):
            idx = np.flatnonzero(tier == t)   # raced a promotion
            if idx.size:
                rows = np.minimum(slot[idx], src.shape[0] - 1)
                out[idx] = src[torch.from_numpy(rows).to(src.device)].cpu()
        return out

    # -- miss-driven promotion -------------------------------------------------
    def promote_misses(self, *, budget: int = 32, min_misses: int = 1) -> int:
        """Swap the most-missed DISK rows up into the HOST tier.

        Candidates are DISK-tier nodes with at least ``min_misses``
        critical-path misses since their last promotion, hottest first;
        victims are HOST-tier rows with the fewest misses, coldest build
        rank (highest slot) first. Swaps ride :meth:`swap_assignments`.

        Args:
            budget: max node pairs to exchange this call.
            min_misses: miss-count threshold for promotion.

        Returns:
            Feature rows moved (``2 *`` pairs), also accumulated into
            :attr:`promoted_rows` and :attr:`migrated_rows`.
        """
        with self._stats_lock:
            if self._disk_miss_counts is None:
                return 0
            counts = self._disk_miss_counts.copy()
        # tier and slot from one snapshot: two attribute loads could tear
        # across a migration publish
        snap = self._snapshot()
        tier, slot = snap[6], snap[7]
        cand = np.flatnonzero((tier == TIER_DISK) & (counts >= min_misses))
        hosts = np.flatnonzero(tier == TIER_HOST)
        if not cand.size or not hosts.size:
            return 0
        cand = cand[np.argsort(-counts[cand], kind="stable")][:budget]
        victims = hosts[np.lexsort((-slot[hosts], counts[hosts]))]
        k = min(cand.size, victims.size)
        pairs = list(zip(cand[:k].tolist(), victims[:k].tolist()))
        moved = self.swap_assignments(pairs)
        with self._stats_lock:
            self._disk_miss_counts[cand[:k]] = 0
            self.promoted_rows += moved
        return moved

    # -- online migration ------------------------------------------------------
    def swap_assignments(self, pairs: list[tuple[int, int]]) -> int:
        """Exchange the complete (tier, slot, owner) assignments, and the
        stored feature rows, of disjoint node pairs, atomically with
        respect to concurrent lookups.

        Each node inherits its partner's placement, so per-tier counts,
        capacity and the owner-major warm layout are preserved, and a
        lookup returns the same bits before, during and after the swap
        (rows travel with their nodes). The rows of all pairs are read in
        one indexed gather per tier; new device tables come from an
        out-of-place ``index_copy`` (a kernel queued earlier on the stream
        still reads the old tensor), new host arrays from copies, and all
        of them, with the numpy mirrors and the plan, are published in one
        critical section. The cache then drops the migrated ids.

        Args:
            pairs: ``(a, b)`` node-id pairs; ids pairwise disjoint.

        Returns:
            Feature rows moved (``2 * len(pairs)``), also accumulated into
            :attr:`migrated_rows`.

        Raises:
            ValueError: a node id appears in more than one pair.
        """
        if not pairs:
            return 0
        flat = [n for ab in pairs for n in ab]
        if len(set(flat)) != len(flat):
            raise ValueError("migration pairs must be disjoint")
        with self._mig_lock:
            hot, warm, host, disk = self.hot, self.warm, self.host, self.disk
            tier, slot = self.tier_np.copy(), self.slot_np.copy()
            owner_t = self.owner_t
        owner = owner_t.cpu().numpy().copy()
        stores = {TIER_HOT: hot, TIER_WARM: warm, TIER_HOST: host,
                  TIER_DISK: disk}
        dev = self.device

        # 1) read every migrating row out of its current tier, one indexed
        #    read per tier
        nodes = np.asarray(flat, np.int64)
        feat = np.zeros((nodes.size, self.feat_dim), host.dtype)
        for t, src in stores.items():
            idx = np.flatnonzero(tier[nodes] == t)
            if not idx.size:
                continue
            rows = slot[nodes[idx]].astype(np.int64)
            if isinstance(src, torch.Tensor):
                feat[idx] = src[torch.from_numpy(rows).to(dev)].cpu().numpy()
            else:
                feat[idx] = src[rows]

        # 2) exchange table entries, all on copies (the plan's too, so a
        #    failure before the publish leaves the store untouched)
        plan = self.plan
        p_tier, p_slot = plan.tier.copy(), plan.slot.copy()
        p_pod, p_dev = plan.pod_owner.copy(), plan.device_owner.copy()
        for a, b in pairs:
            for table in (tier, slot, owner, p_tier, p_slot, p_pod, p_dev):
                table[a], table[b] = table[b], table[a]

        # 3) write each row into its new home: out of place on the device,
        #    on a copy on the host
        new_stores = dict(stores)
        new_tier = tier[nodes]
        for t in np.unique(new_tier).tolist():
            idx = np.flatnonzero(new_tier == t)
            rows = slot[nodes[idx]].astype(np.int64)
            arr = stores[t]
            if isinstance(arr, torch.Tensor):
                new_stores[t] = arr.index_copy(
                    0, torch.from_numpy(rows).to(dev),
                    torch.from_numpy(feat[idx]).to(dev, arr.dtype))
            else:
                arr = arr.copy()
                arr[rows] = feat[idx]
                # bound the spill tier's RAM overlay under demotion churn
                if (isinstance(arr, DiskSpillTier)
                        and arr.overlay_rows > max(64, len(arr) // 8)):
                    arr = arr.compact()
                new_stores[t] = arr
        tier_t = torch.from_numpy(tier).to(dev)
        slot_t = torch.from_numpy(slot).to(dev)
        owner_t = torch.from_numpy(owner).to(dev)

        # 4) publish tables, mirrors and plan in one critical section
        with self._mig_lock:
            self.hot = new_stores[TIER_HOT]
            self.warm = new_stores[TIER_WARM]
            self.host = new_stores[TIER_HOST]
            self.disk = new_stores[TIER_DISK]
            self.tier_t, self.slot_t, self.owner_t = tier_t, slot_t, owner_t
            self.tier_np, self.slot_np = tier, slot
            plan.tier, plan.slot = p_tier, p_slot
            plan.pod_owner, plan.device_owner = p_pod, p_dev
            self.migrated_rows += 2 * len(pairs)
            cache = self.cache
        # drop exactly the migrated ids from the cache: capacity hygiene (a
        # node promoted to the device stops holding a cache row), never
        # correctness, since rows travel with their nodes
        if cache is not None:
            cache.invalidate(flat)
        return 2 * len(pairs)
