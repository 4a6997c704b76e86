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

Address resolution runs on the device: tier and slot come from the
``(N,)`` int32 device tables, and ``gather_aggregate``'s segment plan is
built there. Only the ids that are really cold (HOST/DISK) cross to the
host, and a snapshot whose placement holds no cold row reads nothing
back. The tables' numpy mirrors, published in the same snapshot, give the
host chain the tier and slot of those few ids, and serve migration and
staging reads, without copying a table back from the device.

:class:`ShardedFeatureStore` is the distributed layout over a device mesh
(paper §5.3's one-sided reads): HOT rows replicated, WARM rows sharded by
FAP owner, read through an owner-sorted dedup exchange planned on the host,
with per-shard stages and spill files in front of the host miss path.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device, trace
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


class _Cold(NamedTuple):
    """The cold ids of one lookup, resolved by the host chain: their
    positions in the lookup's id vector (on the device), their ``(K, d)``
    rows, and whether the lookup still needs its device-tier gather
    (``False`` when the cache answered every valid id)."""
    pos: torch.Tensor
    rows: torch.Tensor
    gather: bool


def _segment_plan(uniq: torch.Tensor, inv_inner: torch.Tensor,
                  inner: torch.Tensor, tier: torch.Tensor, slot: torch.Tensor,
                  cold: Optional[_Cold], p: int, fan: int) -> torch.Tensor:
    """``gather_aggregate``'s ``(2, total + p, fan)`` int32 tier/slot plan,
    built on the device from the unique ids, the inverse of the innermost
    hop ``inner`` and the unique ids' ``tier``/``slot``: one singleton
    segment per unique id (the outer-hop rows), then one fan-wide segment
    per innermost parent. Kernel tiers: 0 = hot, 1 = warm, 2 = the cold
    side table (rows numbered 0..K-1 in unique order), 99 = skip. A cold
    id left unresolved (``cold`` ``None``) is skipped with its slot kept;
    a ``-1`` child aliases the last unique slot through the inverse, so it
    is re-masked to 99 / 0."""
    ktier = torch.where((uniq >= 0) & (tier < TIER_HOST), tier, 99)
    kslot = slot
    if cold is not None:
        ktier.index_fill_(0, cold.pos, 2)
        kslot = slot.index_copy(0, cold.pos, torch.arange(
            int(cold.pos.shape[0]), dtype=slot.dtype, device=slot.device))
    absent = (inner < 0).view(p, fan)
    inv_inner = inv_inner.long()

    def rows(addr, skip):
        return torch.cat([
            F.pad(addr[:, None], (0, fan - 1), value=skip),
            addr[inv_inner].view(p, fan).masked_fill_(absent, skip)])

    return torch.stack([rows(ktier, 99), rows(kslot, 0)])


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
    # the device the tables were built on; migration replaces the tables
    # under _mig_lock but never moves them, so this needs no lock
    built_on: Optional[torch.device] = dataclasses.field(default=None,
                                                         repr=False)
    # HOST/DISK rows of the placement: 0 lets a lookup skip looking for
    # cold ids; replaced with the tables, under _mig_lock
    n_cold: int = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.n_cold = int((self.tier_np >= TIER_HOST).sum())

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
        # a pod's rows in (slot, id) order: a plan that numbers a pod's
        # HOST slots 0..k-1 (every Quiver plan) keeps hbase + slot, and
        # ``hash_placement``, which numbers them per device so a pod's
        # devices share slot numbers, gets a row per id all the same
        order = np.lexsort((host_ids, plan.slot[host_ids], hpod))
        first = np.searchsorted(hpod[order], hpod[order])
        host_rows = np.empty_like(host_ids)
        host_rows[order] = hbase[hpod[order]] + np.arange(order.size) - first
        host[host_rows] = features[host_ids]

        disk_ids = np.flatnonzero(plan.tier == TIER_DISK)
        disk_rows = np.zeros((max(disk_ids.shape[0], 1), d), features.dtype)
        disk_rows[plan.slot[disk_ids]] = features[disk_ids]
        disk = DiskSpillTier.build(disk_rows, spill_path)

        slot_flat = plan.slot.copy()
        slot_flat[warm_ids] = warm_rows
        slot_flat[host_ids] = host_rows
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
            _disk_miss_counts=np.zeros(n, dtype=np.int64), built_on=dev)

    @property
    def device(self) -> torch.device:
        """The device of the HOT/WARM tables: the one they were built on."""
        return self.built_on

    # -- snapshot and accounting ---------------------------------------------
    def _snapshot(self) -> tuple:
        """Consistent view ``(hot, warm, host, disk, tier_t, slot_t,
        tier_np, slot_np, stage, n_cold)``: tables and the stage are
        replaced, never mutated, so holding the references keeps one
        coherent placement and staging state."""
        with self._mig_lock:
            return (self.hot, self.warm, self.host, self.disk, self.tier_t,
                    self.slot_t, self.tier_np, self.slot_np, self._stage,
                    self.n_cold)

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
            out = self._lookup_unique(uniq, include_host, snap)[inv.long()]
        else:
            out = self._lookup_unique(ids, include_host, snap)
        return torch.where((ids >= 0)[:, None], out, 0.0)

    def lookup_hops(self, hops: Sequence, *,
                    include_host: bool = True) -> list[torch.Tensor]:
        """Fused feature collection for a whole layered sample: dedup all
        hops at once, resolve addresses on the device, one address-sorted
        ``tiered_gather`` over HOT/WARM, cold rows from the cache, the
        stage or at most one host fetch, then scatter rows back per hop.
        Bit-identical to ``[self.lookup(h) for h in hops]``.

        Args:
            hops: id vectors (seeds first), each ``(M_k,)`` with ``-1``
                padding; at least one non-empty.
            include_host: as in :meth:`lookup`.

        Returns:
            One ``(M_k, d)`` matrix per hop.

        Raises:
            ValueError: every hop is empty.
        """
        with trace.span("lookup_hops"):
            hops_t = [self._ids(h) for h in hops]
            sizes = [int(h.shape[0]) for h in hops_t]
            total = sum(sizes)
            if total == 0:
                raise ValueError(
                    "lookup_hops needs at least one non-empty hop")
            snap = self._snapshot()
            self._count(fused_calls=1)
            ids = torch.cat(hops_t)
            with trace.span("dedup"):
                uniq, inv = fixed_size_unique(ids, total)
            rows = self._fused_unique(uniq, include_host, snap)
            out = torch.where((ids >= 0)[:, None], rows[inv.long()], 0.0)
            return list(torch.split(out, sizes))

    def lookup_aggregate(self, hops: Sequence, *, include_host: bool = True
                         ) -> tuple[list[torch.Tensor], torch.Tensor]:
        """Fused feature collection + innermost-hop segment sum in one
        ``gather_aggregate`` launch: the dense ``(n_sampled, d)`` neighbor
        tensor is never materialized. Outer-hop rows ride in the same
        launch as singleton segments. The segment plan is built on the
        device; cold (HOST/DISK) ids are resolved first, through the
        cache, the stage and the host gateway exactly as
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
        with trace.span("lookup_aggregate"):
            hops_t = [self._ids(h) for h in hops]
            sizes = [int(h.shape[0]) for h in hops_t]
            if len(hops_t) < 2:
                raise ValueError(
                    "lookup_aggregate needs seeds plus at least one frontier")
            p, n_inner = sizes[-2], sizes[-1]
            if p == 0 or n_inner == 0 or n_inner % p:
                raise ValueError(
                    "innermost hop must be a (P*fan,) frontier of the "
                    f"previous hop, got sizes {sizes[-2:]}")
            fan = n_inner // p
            total = sum(sizes)
            n_outer = total - n_inner
            snap = self._snapshot()
            hot, warm = snap[0], snap[1]
            self._count(fused_calls=1, fused_aggregates=1)
            ids = torch.cat(hops_t)
            with trace.span("dedup"):
                uniq, inv = fixed_size_unique(ids, total)
            with trace.span("resolve"):
                tier, slot, cold = self._resolve(uniq, include_host, snap)
                seg = _segment_plan(uniq, inv[n_outer:], hops_t[-1], tier,
                                    slot, cold, p, fan)
            # nothing cold resolved (include_host=False, or no cold id):
            # cold children contribute zero rows
            cold_buf = (hot.new_zeros((1, self.feat_dim)) if cold is None
                        else cold.rows)
            self._count(device_gathers=1)
            with trace.span("gather"):
                out = gather_aggregate(seg[0], seg[1], hot, warm, cold_buf)
            if trace.on:
                trace.count("gather_rows", int(seg[0].numel()))
                trace.count("gather_rows_valid", (seg[0] != 99).sum())
            outer_rows = torch.where((ids[:n_outer] >= 0)[:, None],
                                     out[:total][inv[:n_outer].long()], 0.0)
            return list(torch.split(outer_rows, sizes[:-1])), out[total:]

    # -- address resolution and tier paths -------------------------------------
    def _resolve(self, ids: torch.Tensor, include_host: bool, snap: tuple
                 ) -> tuple[torch.Tensor, torch.Tensor, Optional[_Cold]]:
        """Address resolution of one id vector on the device, the step the
        three tier paths share: ``(tier, slot, cold)``, ``tier`` and
        ``slot`` gathered from the snapshot's tables (a ``-1`` id reads
        node 0's).

        With ``include_host`` and a placement that holds cold rows, the
        valid HOST/DISK ids are compacted on the device, and only they
        cross to the host, in position order, where :meth:`_cold_rows`
        resolves them; ``cold`` is ``None`` when there are none. Otherwise
        nothing is read back. Counts ``cold_ids``, the ids sent to the host.
        """
        tier_t, slot_t = snap[4], snap[5]
        safe = ids.long().clamp_min(0)
        tier, slot = tier_t[safe], slot_t[safe]
        cold, n = None, 0
        if include_host and snap[9]:
            valid = ids >= 0
            pos = torch.nonzero(valid & (tier >= TIER_HOST)).squeeze(1)
            n = int(pos.shape[0])
            if n:
                with trace.span("ids_to_host"):
                    # one copy: the cold ids, then the count of valid ids
                    got = torch.cat([ids[pos], valid.sum(
                        dtype=torch.int32)[None]]).cpu().numpy()
                cold = _Cold(pos, *self._cold_rows(got[:-1], int(got[-1]),
                                                   snap))
        if trace.on:
            trace.count("cold_ids", n)
        return tier, slot, cold

    def _cold_rows(self, ids_np: np.ndarray, n_valid: int, snap: tuple
                   ) -> tuple[torch.Tensor, bool]:
        """The host chain for the cold ids of one call: ``(rows, gather)``.

        ``ids_np`` holds valid HOST/DISK ids in the call's order (ascending
        for a deduplicated call). They probe the optional device cache;
        the misses come from the stage, else from one :meth:`_host_fetch`,
        and are admitted to the cache on return. ``rows`` is ``(K, d)`` on
        the device in ``ids_np`` order; ``gather`` is ``False`` when the
        cache answered every one of the call's ``n_valid`` valid ids, so
        that the call issues no device-tier gather.
        """
        # a single reference read: any published cache (or None) is valid,
        # cached rows being copies of the feature values
        cache = self.cache  # quiverlint: disable=lock-discipline atomic reference read, any snapshot valid
        if cache is None:
            return self._stage_or_fetch(ids_np, snap), True
        values, miss_index, miss_ids = cache.query(ids_np)
        self._count(cache_hits=int(ids_np.size - miss_index.size),
                    cache_misses=int(miss_index.size))
        if not miss_index.size:
            return values, ids_np.size < n_valid
        rows = self._stage_or_fetch(miss_ids, snap)
        values[torch.from_numpy(miss_index).to(values.device)] = rows
        self._count(cache_evictions=int(cache.replace(miss_ids, rows)))
        return values, True

    def _stage_or_fetch(self, ids_np: np.ndarray, snap: tuple
                        ) -> torch.Tensor:
        """Rows of valid cold ids the cache did not answer: staged ids from
        the device stage, the rest through one :meth:`_fetch_cold`. Tier
        and slot come from the host mirrors; prefetch hits and misses land
        in the dispatch stats. Returns ``(K, d)`` on the device."""
        tier_np, slot_np, stage = snap[6][ids_np], snap[7][ids_np], snap[8]
        if stage is None:
            return self._fetch_cold(ids_np, tier_np, slot_np, snap)
        stage_slot, stage_rows = stage
        sslot = stage_slot[ids_np]
        miss = np.flatnonzero(sslot < 0)
        self._count(prefetch_hits=int(ids_np.size - miss.size),
                    prefetch_misses=int(miss.size))
        if miss.size == ids_np.size:
            return self._fetch_cold(ids_np, tier_np, slot_np, snap)
        # a miss reads stage row 0 here and is overwritten below
        rows = stage_rows.index_select(0, torch.from_numpy(
            np.maximum(sslot, 0)).to(stage_rows.device))
        if miss.size:
            rows[torch.from_numpy(miss).to(rows.device)] = self._fetch_cold(
                ids_np[miss], tier_np[miss], slot_np[miss], snap)
        return rows

    def _fused_unique(self, uniq: torch.Tensor, include_host: bool,
                      snap: tuple) -> torch.Tensor:
        """One gather per tier class for a deduplicated id vector: HOT/WARM
        rows stream through ``tiered_gather`` in ascending (tier, slot)
        order (near-sequential reads, the paper's TLB optimization), and
        the cold rows :meth:`_resolve` returns are written over their
        positions."""
        hot, warm = snap[0], snap[1]
        with trace.span("resolve"):
            tier, slot, cold = self._resolve(uniq, include_host, snap)
        if cold is not None and not cold.gather:
            out = hot.new_zeros((uniq.shape[0], self.feat_dim))
        else:
            self._count(device_gathers=1)
            # address-sort key: tier-major, slot-minor; slots clamp into
            # the device-tier span (host-tier slots may exceed it; their
            # gather gives zeros either way), keeping the key inside int32
            span = max(int(hot.shape[0]), int(warm.shape[0]), 1)
            key = tier * span + slot.clamp_max(span - 1)
            order = torch.argsort(key, stable=True)
            tier_s, slot_s = tier[order], slot[order]
            with trace.span("gather"):
                dev_sorted = tiered_gather(tier_s, slot_s, hot, warm)
            if trace.on:
                trace.count("gather_rows", int(uniq.shape[0]))
                trace.count("gather_rows_valid", (uniq >= 0).sum())
            out = torch.empty_like(dev_sorted)
            out[order] = dev_sorted
        if cold is not None:
            out[cold.pos] = cold.rows
        return torch.where((uniq >= 0)[:, None], out, 0.0)

    def _lookup_unique(self, ids: torch.Tensor, include_host: bool,
                       snap: tuple) -> torch.Tensor:
        """The per-hop path: one gather from each device tier, selected per
        row, then the cold rows :meth:`_resolve` returns."""
        hot, warm = snap[0], snap[1]
        tier, slot, cold = self._resolve(ids, include_host, snap)
        if cold is not None and not cold.gather:
            out = hot.new_zeros((ids.shape[0], self.feat_dim))
        else:
            self._count(device_gathers=2)
            slot = slot.long()
            out = torch.zeros((ids.shape[0], self.feat_dim),
                              dtype=hot.dtype, device=hot.device)
            out = torch.where((tier == TIER_HOT)[:, None],
                              hot[slot.clamp_max(hot.shape[0] - 1)], out)
            out = torch.where((tier == TIER_WARM)[:, None],
                              warm[slot.clamp_max(warm.shape[0] - 1)], out)
        if cold is not None:
            out[cold.pos] = cold.rows
        return torch.where((ids >= 0)[:, None], out, 0.0)

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
        with trace.span("host_fetch"):
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
        hot, warm, host, disk, _, _, tier_tab, slot_tab, _, _ = \
            self._snapshot()
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
        n_cold = int((tier >= TIER_HOST).sum())

        # 4) publish tables, mirrors and plan in one critical section
        with self._mig_lock:
            self.hot = new_stores[TIER_HOT]
            self.warm = new_stores[TIER_WARM]
            self.host = new_stores[TIER_HOST]
            self.disk = new_stores[TIER_DISK]
            self.tier_t, self.slot_t, self.owner_t = tier_t, slot_t, owner_t
            self.tier_np, self.slot_np = tier, slot
            self.n_cold = n_cold
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


# ---------------------------------------------------------------------------
# Distributed store: one-sided reads over the mesh
# ---------------------------------------------------------------------------

# Dispatch counters of the sharded exchange, the reference's schema.
SHARDED_STATS_SCHEMA: tuple = (
    "exchanges", "exchanged_ids", "stage_hits", "stage_misses",
    "host_fetches", "cold_rows", "spill_reads")


def _new_sharded_stats() -> dict[str, int]:
    """Zeroed dispatch counters of the sharded exchange:

      exchanges        dedup exchanges dispatched
      exchanged_ids    distinct (shard, id) pairs moved through the
                       exchange: an id repeated across hops costs one
                       entry however many positions repeat it
      stage_hits       cold id occurrences resolved from a per-shard stage
                       inside the exchange
      stage_misses     cold id occurrences left to the host miss path
      host_fetches     host cold fetches actually issued
      cold_rows        id occurrences those fetches resolved
      spill_reads      rows read from the per-shard DISK spill files
    """
    return dict.fromkeys(SHARDED_STATS_SCHEMA, 0)


def _host(x) -> np.ndarray:
    """``x`` (a tensor on any device, or array-like) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _upload(parts: Sequence[np.ndarray], device: torch.device
            ) -> list[torch.Tensor]:
    """The integer vectors ``parts`` as int64 tensors on ``device``,
    through one host→device copy."""
    flat = np.concatenate([np.asarray(p, np.int64).reshape(-1)
                           for p in parts])
    return list(torch.split(torch.from_numpy(flat).to(device),
                            [int(np.size(p)) for p in parts]))


@dataclasses.dataclass(eq=False)
class _ShardGroup:
    """The shards of the mesh that live on one device, with that device's
    copies: the replicated HOT rows and id tables, the warm rows of its
    shards in shard order, and each shard's position in the group."""

    device: torch.device
    shards: tuple             # mesh shard indices, ascending
    hot: torch.Tensor         # (n_hot, d) replica
    warm: torch.Tensor        # (len(shards) * rows_per_dev, d)
    tier_t: torch.Tensor      # (N,) int32 replicas
    slot_t: torch.Tensor
    owner_t: torch.Tensor
    gpos_np: np.ndarray       # (world,) position in this group, -1 elsewhere
    gpos: torch.Tensor        # the same, int64 on ``device``
    every: bool               # the group holds every shard of the mesh


class ShardedFeatureStore:
    """Feature store laid out over a mesh axis (paper §5.3, distributed).

    hot  : ``(n_hot, d)`` replicated on every device of the mesh
    warm : ``(world * rows_per_dev, d)`` sharded: shard ``w`` owns rows
           ``[w * rows_per_dev, (w + 1) * rows_per_dev)`` on ``devices[w]``

    The mesh is single-controller (:class:`~repro_torch.launch.mesh.Mesh`):
    this one object plans every lookup on the host and issues the work of
    every shard. Two exchange strategies, as in the reference:

    ``"alltoall"`` (default) — the owner-sorted, capacity-bounded dedup
    exchange. Each shard's slice of the request vector is deduplicated
    across all hops on the host, sorted by owner and padded to a pow2
    per-(requester, owner) capacity; owners answer with one gather from
    their warm shard (and their stage shard, for staged cold ids), and the
    answers travel back to the requesters. The shards of one device are
    served by one gather over all their requests, and a block moves with
    ``.to(device)``: no copy between shards of one card, a peer copy
    between cards. Cold ids without a staged row fall back to one host
    fetch (:meth:`read_cold_rows`) merged after the exchange.

    ``"allgather"`` (baseline) — every shard publishes the warm slots it
    wants, owners answer each of them, and the answers are summed back to
    the requester; cold ids are resolved by a host post-pass. As in the
    reference, a remote read is that sum of the owner's row and the other
    owners' zeros, so a ``-0.0`` element read from another shard comes
    back ``+0.0``; every other read copies bits.

    Rows are otherwise moved and selected, never operated on: lookups are
    bit-identical to the single-host :class:`TieredFeatureStore`. Built
    with :meth:`from_tiered` the store keeps the source store for host
    fetches and, with ``spill_dir=``, per-shard :class:`DiskSpillTier`
    files; a directly constructed store reads cold ids as zeros. Counters
    land in :attr:`stats` (schema ``SHARDED_STATS_SCHEMA``), which the
    serving engine reports under ``summary()["store"]``.
    """

    def __init__(self, mesh, axis_name: str, hot, warm, tier_t, slot_t,
                 owner_t, strategy: str = "alltoall"):
        self.mesh, self.axis = mesh, axis_name
        self.world = int(mesh.shape[axis_name])
        if self.world and warm.shape[0] % self.world:
            raise ValueError(
                f"warm.shape[0] ({warm.shape[0]}) must be divisible by the "
                f"mesh world size ({self.world}) — a ragged warm buffer "
                f"would silently truncate the last shard")
        if strategy not in ("alltoall", "allgather"):
            raise ValueError(f"unknown exchange strategy {strategy!r} "
                             f"(want 'alltoall' or 'allgather')")
        world = max(self.world, 1)
        per = warm.shape[0] // world
        self.rows_per_dev = per
        self.strategy = strategy
        self.feat_dim = int(hot.shape[1])
        hot = torch.as_tensor(hot)
        warm = torch.as_tensor(warm)
        # host mirrors of the id tables: static (the sharded store never
        # migrates), so a lookup's planning costs no device round trip
        self._tier_np = _host(tier_t).astype(np.int32)
        self._slot_np = _host(slot_t).astype(np.int64)
        self._owner_np = _host(owner_t).astype(np.int64)
        self._has_cold = bool((self._tier_np >= TIER_HOST).any())
        tables = [torch.from_numpy(t.astype(np.int32))
                  for t in (self._tier_np, self._slot_np, self._owner_np)]
        self._groups: list[_ShardGroup] = []
        for dev, shards in mesh.groups():
            every = shards == tuple(range(world))
            if every:
                rows = warm
            else:
                idx = np.concatenate([np.arange(s * per, (s + 1) * per)
                                      for s in shards])
                rows = warm.index_select(0, torch.from_numpy(idx)
                                         .to(warm.device))
            gpos = np.full(world, -1, np.int64)
            gpos[list(shards)] = np.arange(len(shards))
            self._groups.append(_ShardGroup(
                dev, shards, hot.to(dev), rows.to(dev),
                *(t.to(dev) for t in tables), gpos,
                torch.from_numpy(gpos).to(dev), every))
        # each owner's position on the answer buffers' owner axis (owners
        # in group order, then shard order within a group)
        order = [s for g in self._groups for s in g.shards]
        self._opos = np.empty(world, np.int64)
        self._opos[order] = np.arange(world)
        self._tiered: Optional[TieredFeatureStore] = None
        self._spill: Optional[list] = None
        self._spill_slot: Optional[np.ndarray] = None
        self._spill_dtype = np.dtype(np.float32)
        self._stage = None
        self._stage_lock = threading.Lock()
        self.stats = _new_sharded_stats()
        self._stats_lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        """The first shard's device: lookups return there, and a caller
        hands :meth:`publish_stage` its rows there."""
        return self._groups[0].device

    @property
    def hot(self) -> torch.Tensor:
        """The HOT rows' replica on :attr:`device`."""
        return self._groups[0].hot

    @staticmethod
    def from_tiered(store: TieredFeatureStore, mesh, axis_name: str,
                    strategy: str = "alltoall", *,
                    spill_dir: Optional[str] = None
                    ) -> "ShardedFeatureStore":
        """The sharded view of a single-host store whose placement was made
        for this mesh: warm shards padded to one size on the device, warm
        slots rebased onto the padded shards, the source store kept for the
        host miss path, and with ``spill_dir`` one spill file a shard.

        Raises:
            ValueError: the placement's world is not the mesh's.
        """
        topo = store.plan.topology
        world = topo.num_pods * topo.devices_per_pod
        mesh_world = int(mesh.shape[axis_name])
        if world != mesh_world:
            raise ValueError(f"the placement is for {world} devices, the "
                             f"mesh has {mesh_world}")
        hot, warm, _, _, _, _, tier, slot, _, _ = store._snapshot()
        rows = int(warm.shape[0])
        per = -(-rows // world)
        base = _host(store.warm_base).astype(np.int64)
        counts = np.diff(np.append(base, rows))
        owner = _host(store.owner_t).astype(np.int64)
        slot = slot.astype(np.int64)
        src = np.concatenate([base[w] + np.arange(counts[w])
                              for w in range(world)])
        dst = np.concatenate([w * per + np.arange(counts[w])
                              for w in range(world)])
        padded = warm.new_zeros((per * world, store.feat_dim))
        if src.size:
            padded.index_copy_(
                0, torch.from_numpy(dst).to(warm.device),
                warm.index_select(0, torch.from_numpy(src).to(warm.device)))
        new_slot = slot.copy()
        m = tier == TIER_WARM
        new_slot[m] = slot[m] - base[owner[m]] + owner[m] * per
        ss = ShardedFeatureStore(mesh, axis_name, hot, padded, tier,
                                 new_slot.astype(np.int32), owner, strategy)
        ss._tiered = store    # cold-tier (HOST/DISK) miss path
        if spill_dir is not None:
            ss._attach_spill(store, spill_dir)
        return ss

    def _attach_spill(self, store: TieredFeatureStore, spill_dir) -> None:
        """One :class:`DiskSpillTier` file a shard (shard ``w`` owns the
        DISK rows of ids with ``id % world == w``, file
        ``shard{w:03d}.spill``) and the id → shard-local row table the
        miss path reads through. Rows are copied at build time and stay
        exact under source-store migration (rows travel with nodes)."""
        world = max(self.world, 1)
        os.makedirs(spill_dir, exist_ok=True)
        n = self._tier_np.shape[0]
        spill_slot = np.full(n, -1, np.int32)
        tiers: list = []
        disk_ids = np.flatnonzero(self._tier_np == TIER_DISK)
        for w in range(world):
            ids_w = disk_ids[disk_ids % world == w]
            if ids_w.size == 0:
                tiers.append(None)
                continue
            rows = store.read_cold_rows(ids_w)
            path = os.path.join(spill_dir, f"shard{w:03d}.spill")
            tiers.append(DiskSpillTier.build(rows, path))
            spill_slot[ids_w] = np.arange(ids_w.size, dtype=np.int32)
            self._spill_dtype = rows.dtype
        self._spill = tiers
        self._spill_slot = spill_slot

    def read_cold_rows(self, ids: np.ndarray) -> np.ndarray:
        """Host-side exact reader of cold (HOST/DISK) rows: the dedup
        exchange's miss path and the stage source a
        :class:`~repro_torch.core.prefetch.Prefetcher` reads through. DISK
        rows come from this store's per-shard spill files when it has them
        (counted as ``spill_reads``); everything else delegates to the
        source store's :meth:`TieredFeatureStore.read_cold_rows`. Without a
        source store cold rows read as zeros.

        Args:
            ids: ``(K,)`` node ids (``-1`` reads zeros).

        Returns:
            ``(K, d)`` rows in ``ids`` order.
        """
        ids = np.asarray(ids).reshape(-1)
        if self._spill is None or self._spill_slot is None:
            if self._tiered is None:
                return np.zeros((ids.shape[0], self.feat_dim),
                                self._spill_dtype)
            return self._tiered.read_cold_rows(ids)
        world = max(self.world, 1)
        safe = np.maximum(ids, 0)
        srow = self._spill_slot[safe]
        local = (ids >= 0) & (self._tier_np[safe] == TIER_DISK) & (srow >= 0)
        out = np.zeros((ids.shape[0], self.feat_dim), self._spill_dtype)
        if local.any():
            idx = np.flatnonzero(local)
            own = safe[idx] % world
            for w in np.unique(own):
                sel = idx[own == w]
                out[sel] = self._spill[int(w)][srow[sel]]
            with self._stats_lock:
                self.stats["spill_reads"] += int(local.sum())
        rest = (ids >= 0) & ~local
        if rest.any() and self._tiered is not None:
            out[rest] = self._tiered.read_cold_rows(ids[rest])
        return out

    def publish_stage(self, stage_slot: Optional[np.ndarray],
                      stage_rows) -> None:
        """Publish (``stage_slot, stage_rows``) or clear (``None, None``)
        the per-shard stages.

        Takes the global layout of :meth:`TieredFeatureStore.publish_stage`
        (what the :class:`~repro_torch.core.prefetch.Prefetcher` hands
        over: ``stage_rows`` already copied to :attr:`device`) and rebins
        it on the device: cold id ``i`` goes to shard ``i % world``, each
        shard is padded to one pow2 row capacity ``cap`` (the reference's
        ``(local, buf, cap)`` layout), and each device's block moves to
        that device. The stage is published only once those copies have
        completed; in-flight lookups keep the previous one.
        """
        if stage_slot is None or stage_rows is None:
            with self._stage_lock:
                self._stage = None
            return
        world = max(self.world, 1)
        stage_slot = np.asarray(stage_slot)
        ids = np.flatnonzero(stage_slot >= 0)
        if ids.size == 0:
            with self._stage_lock:
                self._stage = None
            return
        rows = torch.as_tensor(stage_rows)
        owner = ids % world
        order = np.argsort(owner, kind="stable")
        ids_o, own_o = ids[order], owner[order]
        counts = np.bincount(own_o, minlength=world)
        cap = 1 << max(int(counts.max()) - 1, 0).bit_length()
        starts = np.zeros(world, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        rank = np.arange(ids_o.size) - starts[own_o]
        local = np.full(stage_slot.shape[0], -1, np.int32)
        local[ids_o] = rank
        src = stage_slot[ids_o]
        bufs = []
        for g in self._groups:
            mine = g.gpos_np[own_o] >= 0
            buf = rows.new_zeros((len(g.shards) * cap, rows.shape[1]))
            if mine.any():
                dst_t, src_t = _upload(
                    [g.gpos_np[own_o[mine]] * cap + rank[mine], src[mine]],
                    rows.device)
                buf.index_copy_(0, dst_t, rows.index_select(0, src_t))
            bufs.append(buf.to(g.device, non_blocking=True))
        for dev in {str(b.device): b.device for b in [rows, *bufs]}.values():
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        with self._stage_lock:
            self._stage = (local, tuple(bufs), int(cap))

    @property
    def tier_table_host(self) -> np.ndarray:
        """Host mirror of the per-node tier table (static: the sharded
        store never migrates)."""
        return self._tier_np

    @property
    def tier_np(self) -> np.ndarray:
        """The tier mirror under the name the prefetcher reads."""
        return self._tier_np

    def staged_rows(self) -> int:
        """Rows currently staged across all shards (0 with no stage)."""
        stage = self._snapshot_stage()
        return 0 if stage is None else int((stage[0] >= 0).sum())

    def _snapshot_stage(self):
        with self._stage_lock:
            return self._stage

    def snapshot_stats(self) -> dict[str, int]:
        """Coherent copy of the dispatch counters."""
        with self._stats_lock:
            return dict(self.stats)

    def reset_stats(self) -> dict[str, int]:
        """Snapshot and zero the dispatch counters."""
        with self._stats_lock:
            out = dict(self.stats)
            for k in out:
                self.stats[k] = 0
        return out

    def _check_world_multiple(self, m: int, what: str) -> None:
        world = max(self.world, 1)
        if m == 0 or m % world:
            raise ValueError(
                f"{what} = {m} must be a non-zero multiple of the mesh "
                f"world size ({world}) so each device's shard is static — "
                f"pad with -1 (executor padding guarantees this)")

    # -- lookup ----------------------------------------------------------------
    def lookup(self, ids) -> torch.Tensor:
        """Rows of ``(world * m,)`` global ids, shard ``w`` requesting
        positions ``[w * m, (w + 1) * m)``; ``-1`` pads give zeros.
        Returns ``(world * m, d)`` on :attr:`device`.

        Raises:
            ValueError: ``len(ids)`` is zero or not a multiple of the
                mesh world size.
        """
        ids = ids.reshape(-1) if isinstance(ids, torch.Tensor) \
            else np.asarray(ids).reshape(-1)
        self._check_world_multiple(int(ids.shape[0]), "len(ids)")
        return self._lookup(ids)

    def lookup_hops(self, hops: Sequence) -> list[torch.Tensor]:
        """Fused multi-hop :meth:`lookup`: ONE exchange over the
        concatenated hop ids (under ``"alltoall"`` deduplicated across
        hops, so a neighbor in several frontiers crosses once), rows split
        back per hop; bit-identical to per-hop calls.

        Args:
            hops: ``(M_k,)`` id vectors (tensors or numpy), ``-1`` padded;
                each ``M_k`` a non-zero multiple of the mesh world size.

        Returns:
            One ``(M_k, d)`` matrix per hop, on :attr:`device`.

        Raises:
            ValueError: no hop, or a hop length that is zero or not a
                multiple of the mesh world size (the hop is named).
        """
        hops = [h.reshape(-1) if isinstance(h, torch.Tensor)
                else np.asarray(h).reshape(-1) for h in hops]
        if not hops:
            raise ValueError("lookup_hops needs at least one hop")
        sizes = [int(h.shape[0]) for h in hops]
        for k, s in enumerate(sizes):
            self._check_world_multiple(s, f"hop {k} length")
        if all(isinstance(h, torch.Tensor) for h in hops):
            ids = torch.cat([h.to(self.device) for h in hops])
        else:
            ids = np.concatenate([_host(h) for h in hops])
        return list(torch.split(self._lookup(ids), sizes))

    def _lookup(self, ids) -> torch.Tensor:
        if self.strategy == "allgather":
            return self._lookup_allgather(ids)
        return self._lookup_dedup(_host(ids).astype(np.int64))

    def _positions(self, g: _ShardGroup, m_dev: int) -> np.ndarray:
        """Request positions of the shards of ``g``, in shard order."""
        return np.concatenate([np.arange(s * m_dev, (s + 1) * m_dev)
                               for s in g.shards])

    def _lookup_allgather(self, ids) -> torch.Tensor:
        """Baseline exchange: every wanted warm slot is published to every
        owner, owners answer the slots they hold (zeros elsewhere) and the
        answers are summed back to the requester; HOT and local WARM rows
        are read in place; cold ids are resolved by a host post-pass."""
        world, per = max(self.world, 1), self.rows_per_dev
        ids_t = (ids if isinstance(ids, torch.Tensor)
                 else torch.from_numpy(ids)).to(self.device)
        m = int(ids_t.shape[0])
        m_dev = m // world
        parts = []
        for g in self._groups:
            pos = None if g.every else self._positions(g, m_dev)
            my_np = (np.repeat(np.arange(world), m_dev) if pos is None
                     else pos // m_dev)
            if pos is None:
                (my,) = _upload([my_np], g.device)
                ids_g = ids_t.to(g.device)
            else:
                my, pos_t = _upload([my_np, pos], g.device)
                ids_g = ids_t.to(g.device).index_select(0, pos_t)
            safe = ids_g.long().clamp_min(0)
            tier = g.tier_t[safe]
            slot = g.slot_t[safe].long()
            out = torch.where((tier == TIER_HOT)[:, None],
                              g.hot[slot.clamp(0, g.hot.shape[0] - 1)], 0.0)
            is_warm = tier == TIER_WARM
            local = is_warm & (g.owner_t[safe].long() == my)
            lrow = (slot - my * per).clamp(0, per - 1)
            out = torch.where(local[:, None], g.warm[g.gpos[my] * per + lrow],
                              out)
            remote = is_warm & ~local
            want = torch.where(remote, slot, -1)
            answered = torch.zeros_like(out)
            for owner in self._groups:
                w = want.to(owner.device)
                o = torch.div(w, per, rounding_mode="floor").clamp(
                    0, world - 1)
                gp = owner.gpos[o]
                rows = owner.warm[gp.clamp_min(0) * per
                                  + (w - o * per).clamp(0, per - 1)]
                owned = (w >= 0) & (gp >= 0)
                answered = answered + torch.where(
                    owned[:, None], rows, 0.0).to(g.device)
            out = torch.where(remote[:, None], answered, out)
            parts.append((pos, torch.where((ids_g >= 0)[:, None], out, 0.0)))
        out = self._assemble(parts, m)
        # cold (HOST/DISK) post-pass, gated by the static tier mirror: a
        # store with no cold tier never copies the ids to the host
        if self._tiered is None or not self._has_cold:
            return out
        ids_np = _host(ids).reshape(-1)
        cold = (ids_np >= 0) & (self._tier_np[np.maximum(ids_np, 0)]
                                >= TIER_HOST)
        if not cold.any():
            return out
        rows = self._tiered.read_cold_rows(ids_np[cold])
        with self._stats_lock:
            self.stats["host_fetches"] += 1
            self.stats["cold_rows"] += int(cold.sum())
        (idx,) = _upload([np.flatnonzero(cold)], out.device)
        out.index_copy_(0, idx, torch.from_numpy(rows).to(out.device,
                                                          out.dtype))
        return out

    def _assemble(self, parts: list, m: int) -> torch.Tensor:
        """The ``(m, d)`` result on :attr:`device` from each group's rows
        (``(None, rows)`` when one group holds every position)."""
        if len(parts) == 1 and parts[0][0] is None:
            return parts[0][1]
        out = torch.zeros((m, self.feat_dim), dtype=parts[0][1].dtype,
                          device=self.device)
        for pos, rows in parts:
            (idx,) = _upload([pos], self.device)
            out.index_copy_(0, idx, rows.to(self.device))
        return out

    def _lookup_dedup(self, ids_np: np.ndarray) -> torch.Tensor:
        """Owner-sorted, capacity-bounded dedup exchange (``"alltoall"``).

        Host planning (the reference's numpy, step for step): each shard's
        slice of the request vector is deduplicated across every hop,
        classified per tier, and its distinct WARM/staged-cold ids sorted
        by owner into a ``(world, world, cap)`` request tensor, ``cap`` the
        pow2 ceiling of the largest per-(requester, owner) count. Then
        :meth:`_exchange` moves requests to owners and rows back, HOT rows
        come from the replica on the requester's device, and cold ids
        without a staged row take one host fetch (:meth:`read_cold_rows`)
        merged after the exchange, counted only when issued."""
        world = max(self.world, 1)
        per = self.rows_per_dev
        m = ids_np.shape[0]
        m_dev = m // world
        stage = self._snapshot_stage()
        stage_local = stage[0] if stage is not None else None

        safe = np.maximum(ids_np, 0)
        tier = self._tier_np[safe]
        valid = ids_np >= 0
        is_hot = valid & (tier == TIER_HOT)
        is_warm = valid & (tier == TIER_WARM)
        is_cold = valid & (tier >= TIER_HOST)
        staged = (is_cold & (stage_local[safe] >= 0)
                  if stage_local is not None
                  else np.zeros(m, dtype=bool))
        exch = is_warm | staged
        miss = is_cold & ~staged

        # owner + owner-local row into (warm_shard ++ stage_shard); values
        # at non-exchange positions are never read
        owner = np.where(is_warm, self._owner_np[safe], safe % world)
        lrow = np.where(is_warm, self._slot_np[safe] - owner * per,
                        per + (stage_local[safe]
                               if stage_local is not None else 0))
        # per-shard cross-hop dedup: shard i requests each distinct id of
        # its slice once, whatever the hop multiplicity
        dev = np.repeat(np.arange(world), m_dev)
        eidx = np.flatnonzero(exch)
        n = self._tier_np.shape[0]
        pair = dev[eidx] * (n + 1) + ids_np[eidx]
        upair, urep, uinv = np.unique(pair, return_index=True,
                                      return_inverse=True)
        rep = eidx[urep]
        u_dev, u_own, u_row = dev[rep], owner[rep], lrow[rep]
        # owner-sort within each shard (address-sorted requests)
        order = np.lexsort((u_row, u_own, u_dev))
        sd, so, sr = u_dev[order], u_own[order], u_row[order]
        grp = sd * world + so
        first = np.ones(grp.shape[0], dtype=bool)
        first[1:] = grp[1:] != grp[:-1]
        gstart = np.flatnonzero(first)
        glen = np.diff(np.append(gstart, grp.shape[0]))
        rank = np.arange(grp.shape[0]) - np.repeat(gstart, glen)
        cmax = int(glen.max()) if glen.size else 0
        cap = 1 << max(cmax - 1, 0).bit_length()
        req = np.full((world * world, cap), -1, np.int32)
        req[sd * world + so, rank] = sr
        # per-unique index into its requester's flat (world*cap) answer
        # buffer, fanned out to every request position
        sel_u = np.zeros(upair.shape[0], np.int64)
        sel_u[order] = so * cap + rank
        sel = np.full(m, -1, np.int64)
        sel[eidx] = sel_u[uinv]
        hslot = np.where(is_hot, self._slot_np[safe], -1)

        with self._stats_lock:
            self.stats["exchanges"] += 1
            self.stats["exchanged_ids"] += int(upair.shape[0])
            self.stats["stage_hits"] += int(staged.sum())
            self.stats["stage_misses"] += int(miss.sum())

        out = self._exchange(req.reshape(world, world, cap), sel, hslot,
                             stage)
        if not miss.any():
            return out
        if self._tiered is None and self._spill is None:
            return out    # no cold source: directly constructed store
        miss_ids, minv = np.unique(ids_np[miss], return_inverse=True)
        rows = self.read_cold_rows(miss_ids)[minv]
        with self._stats_lock:
            self.stats["host_fetches"] += 1
            self.stats["cold_rows"] += int(miss.sum())
        (idx,) = _upload([np.flatnonzero(miss)], out.device)
        out.index_copy_(0, idx, torch.from_numpy(rows).to(out.device,
                                                          out.dtype))
        return out

    def _exchange(self, req: np.ndarray, sel: np.ndarray, hslot: np.ndarray,
                  stage) -> torch.Tensor:
        """The data movement of the dedup exchange.

        Owners: each device answers every request addressed to its shards
        with one gather from its warm rows (staged rows copied over the
        stage entries), giving ``(world, k·cap, d)`` answer blocks laid out
        requester-major. Back: each requester device takes its requesters'
        blocks from every owner device (``.to``: no copy on one card) and
        reads its positions' rows from them, and its HOT rows from its
        own replica; everything else stays zero.

        Args:
            req: ``(world, world, cap)`` owner-local rows per (requester,
                owner), ``-1`` padded (rows ``>= rows_per_dev`` are staged
                rows).
            sel: ``(m,)`` index into the requester's ``(world·cap)``
                answer buffer (``owner·cap + rank``), ``-1`` elsewhere.
            hslot: ``(m,)`` HOT slot, ``-1`` elsewhere.
            stage: the snapshot :meth:`publish_stage` published, or None.
        """
        world, cap = req.shape[0], req.shape[2]
        per, d = self.rows_per_dev, self.feat_dim
        m = sel.shape[0]
        m_dev = m // world
        n_hot = self.hot.shape[0]
        answers = []
        for gi, g in enumerate(self._groups):
            lr = req[:, list(g.shards), :].astype(np.int64)   # (W, k, cap)
            kpos = np.arange(len(g.shards))[None, :, None]
            widx = kpos * per + np.clip(lr, 0, per - 1)
            spos = np.flatnonzero((lr >= per).reshape(-1))
            if spos.size:
                sidx = (kpos * stage[2] + lr - per).reshape(-1)[spos]
                widx_t, spos_t, sidx_t = _upload([widx, spos, sidx],
                                                 g.device)
                ans = g.warm.index_select(0, widx_t)
                ans.index_copy_(0, spos_t,
                                stage[1][gi].index_select(0, sidx_t))
            else:
                (widx_t,) = _upload([widx], g.device)
                ans = g.warm.index_select(0, widx_t)
            answers.append(ans.view(world, len(g.shards) * cap, d))
        parts = []
        for g in self._groups:
            pos = None if g.every else self._positions(g, m_dev)
            s = sel if pos is None else sel[pos]
            h = hslot if pos is None else hslot[pos]
            sp, hp = np.flatnonzero(s >= 0), np.flatnonzero(h >= 0)
            r = (sp // m_dev if pos is None
                 else g.gpos_np[pos[sp] // m_dev])
            o, j = s[sp] // cap, s[sp] % cap
            aidx = r * (world * cap) + self._opos[o] * cap + j
            hidx = np.clip(h[hp], 0, n_hot - 1)
            sp_t, aidx_t, hp_t, hidx_t = _upload([sp, aidx, hp, hidx],
                                                 g.device)
            if g.every:
                back = answers[0]
            else:   # this group's requester rows of every owner's block
                back = torch.cat(
                    [a.index_select(0, _upload([g.shards], a.device)[0])
                     .to(g.device, non_blocking=True) for a in answers],
                    dim=1)
            out = torch.zeros((m if pos is None else pos.size, d),
                              dtype=g.hot.dtype, device=g.device)
            if hp.size:
                out.index_copy_(0, hp_t, g.hot.index_select(0, hidx_t))
            if sp.size:
                out.index_copy_(0, sp_t,
                                back.reshape(-1, d).index_select(0, aidx_t))
            parts.append((pos, out))
        return self._assemble(parts, m)
