"""Tiered feature store (paper §5.3) on one host and one device.

  HOT   rows live in device memory (replicated in a multi-device layout).
  WARM  rows live in device memory (partitioned in a multi-device layout).
  HOST  rows live in host RAM (numpy).
  DISK  rows live in an mmap-backed spill tier (:class:`DiskSpillTier`).

Every lookup reads one consistent snapshot of the tier tables. The device
tiers are gathered by the hand-written ``tiered_gather`` kernel
(:meth:`TieredFeatureStore.lookup_hops`) or folded into the layer-1
aggregation by ``gather_aggregate``
(:meth:`TieredFeatureStore.lookup_aggregate`). HOST/DISK rows reach the
device through one gateway, :meth:`TieredFeatureStore._host_fetch`: an
address-sorted numpy gather and one host→device copy.

The ``(N,)`` tier/slot tables are kept twice: as int32 device tensors
(the device-side gathers index them) and as numpy mirrors published in the
same snapshot, so host-side address resolution never copies a whole table
back from the device.

Not ported yet: the device cache (``GPUFeatureCache``), prefetch
staging (``publish_stage``) and online migration (``swap_assignments``,
``promote_misses``). The store has no way to attach a cache or a stage.
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

# Dispatch counters, the reference's schema. The prefetch and cache
# counters stay 0 until those tiers are ported.
STATS_SCHEMA: tuple = (
    "lookup_calls", "fused_calls", "fused_aggregates", "device_gathers",
    "host_fetches", "disk_misses", "spill_reads", "prefetch_hits",
    "prefetch_misses", "cache_hits", "cache_misses", "cache_evictions")


def _new_stats() -> dict[str, int]:
    """Zeroed dispatch counters:

      lookup_calls / fused_calls   per-hop vs fused lookup entries
      fused_aggregates             ``lookup_aggregate`` entries
      device_gathers               device-tier gather dispatches
      host_fetches                 host→device cold fetches actually issued
      disk_misses / spill_reads    DISK rows read on the critical path
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
    host, one snapshot per lookup."""

    plan: PlacementPlan
    feat_dim: int
    hot: torch.Tensor         # (n_hot, d) device
    warm: torch.Tensor        # (warm_total, d) device
    host: np.ndarray          # (host_total, d) host RAM
    disk: DiskSpillTier       # (rest, d) spill tier
    tier_t: torch.Tensor      # (N,) int32 device lookup tables
    slot_t: torch.Tensor
    tier_np: np.ndarray       # (N,) int32 host mirrors of tier_t / slot_t
    slot_np: np.ndarray
    # every lookup reads (tables, mirrors, tier arrays) as one snapshot
    # taken under this lock
    _mig_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)
    stats: dict = dataclasses.field(default_factory=_new_stats, repr=False)
    _stats_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    @staticmethod
    def build(features: np.ndarray, plan: PlacementPlan, *,
              spill_path: Optional[str] = None,
              device: str | torch.device = "cuda") -> "TieredFeatureStore":
        """Lay the ``(N, d)`` feature matrix out across the four tiers of
        ``plan`` (the reference's layout: warm rows owner-major, host rows
        pod-major); ``spill_path`` backs the DISK tier with a spill file.
        HOT/WARM rows and the tier/slot tables go to ``device``."""
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
            tier_np=tier_np, slot_np=slot_np)

    @property
    def device(self) -> torch.device:
        return self.hot.device

    # -- snapshot and accounting ---------------------------------------------
    def _snapshot(self) -> tuple:
        """Consistent view ``(hot, warm, host, disk, tier_t, slot_t,
        tier_np, slot_np)``: tables are replaced, never mutated, so holding
        the references keeps one coherent placement."""
        with self._mig_lock:
            return (self.hot, self.warm, self.host, self.disk, self.tier_t,
                    self.slot_t, self.tier_np, self.slot_np)

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
        """Copy of the dispatch counters without resetting them."""
        with self._stats_lock:
            return dict(self.stats)

    def tier_histogram(self, ids: np.ndarray) -> dict[str, int]:
        """How many of ``ids`` (``-1`` padding dropped) the plan places in
        each tier."""
        ids = np.asarray(ids)
        t = self.plan.tier[ids[ids >= 0]]
        return {TIER_NAMES[k]: int((t == k).sum())
                for k in (TIER_HOT, TIER_WARM, TIER_HOST, TIER_DISK)}

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
            include_host: also resolve HOST/DISK ids (through
                :meth:`_host_fetch`); ``False`` returns zeros for them.
            dedup: deduplicate and sort ids (``fixed_size_unique``) first.

        Returns:
            ``(M, d)`` rows in input order, from one snapshot.
        """
        snap = self._snapshot()
        self._count(lookup_calls=1, device_gathers=2)
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
        hops at once, one address-sorted ``tiered_gather`` over HOT/WARM,
        at most one host fetch for HOST/DISK, then scatter rows back per
        hop. Bit-identical to ``[self.lookup(h) for h in hops]``.

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
        self._count(fused_calls=1, device_gathers=1)
        ids = torch.cat(hops_t)
        uniq, inv = fixed_size_unique(ids, total)
        rows = self._fused_unique(uniq, include_host, snap)
        out = torch.where((ids >= 0)[:, None], rows[inv.long()], 0.0)
        return list(torch.split(out, sizes))

    def lookup_aggregate(self, hops: Sequence, *, include_host: bool = True
                         ) -> tuple[list[torch.Tensor], torch.Tensor]:
        """Fused feature collection + innermost-hop segment sum in one
        ``gather_aggregate`` launch: the dense ``(n_sampled, d)`` neighbor
        tensor is never materialized. Outer-hop rows ride in the same
        launch as singleton segments; cold (HOST/DISK) ids are resolved
        first through :meth:`_cold_unique` into a side table addressed as
        tier 2.

        The aggregate is bit-identical to :meth:`lookup_hops` followed by
        the model's fp32 in-order fan sum (``kernels.gather_aggregate.
        fan_sum``), on the CPU and on the card.

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
        hot, warm, host, disk, _, _, tier_tab, slot_tab = snap
        self._count(fused_calls=1, fused_aggregates=1, device_gathers=1)
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
            cold_buf = self._cold_unique(tier_np[cold_idx], slot_np[cold_idx],
                                         host, disk)
            ktier[cold] = 2
            kslot[cold] = np.arange(cold_idx.size, dtype=np.int32)
        else:
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
        out = gather_aggregate(seg_t[0], seg_t[1], hot, warm, cold_buf)
        outer_rows = torch.where((ids[:n_outer] >= 0)[:, None],
                                 out[:total][inv[:n_outer].long()], 0.0)
        return list(torch.split(outer_rows, sizes[:-1])), out[total:]

    # -- tier paths ------------------------------------------------------------
    def _fused_unique(self, uniq: torch.Tensor, include_host: bool,
                      snap: tuple) -> torch.Tensor:
        """One gather per tier class for a deduplicated id vector: HOT/WARM
        rows stream through ``tiered_gather`` in ascending (tier, slot)
        order (near-sequential reads, the paper's TLB optimization), and
        HOST/DISK rows come from one :meth:`_host_fetch`."""
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
            self._resolve_cold(uniq, out, snap)
        return torch.where((uniq >= 0)[:, None], out, 0.0)

    def _lookup_unique(self, ids: torch.Tensor, include_host: bool,
                       snap: tuple) -> torch.Tensor:
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
            self._resolve_cold(ids, out, snap)
        return torch.where((ids >= 0)[:, None], out, 0.0)

    def _resolve_cold(self, ids: torch.Tensor, out: torch.Tensor,
                      snap: tuple) -> None:
        """Write the HOST/DISK rows of ``ids`` into ``out`` in place (the
        caller owns ``out``). Tier and slot come from the host mirrors, so
        only ``ids`` crosses to the host; a lookup with no cold id issues
        no fetch."""
        tier_tab, slot_tab = snap[6], snap[7]
        ids_np = ids.cpu().numpy()
        safe = np.maximum(ids_np, 0)
        tier_np, slot_np = tier_tab[safe], slot_tab[safe]
        idx = np.flatnonzero((tier_np >= TIER_HOST) & (ids_np >= 0))
        if idx.size:
            rows = self._cold_unique(tier_np[idx], slot_np[idx], snap[2],
                                     snap[3])
            out[torch.as_tensor(idx, device=out.device)] = rows

    def _cold_unique(self, tier_np: np.ndarray, slot_np: np.ndarray, host,
                     disk) -> torch.Tensor:
        """Resolve cold rows (one entry per HOST/DISK id) through the single
        host→device gateway, counting one fetch and the DISK rows read."""
        n_disk = int((tier_np == TIER_DISK).sum())
        self._count(host_fetches=1, disk_misses=n_disk, spill_reads=n_disk)
        return self._host_fetch(tier_np, slot_np, host, disk)

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
