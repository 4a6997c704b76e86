"""Address resolution on the device (``TieredFeatureStore._resolve`` and
``_segment_plan``) against the host resolution it replaced, kept here as
an oracle (:class:`HostResolved`): with every row on the device and with
HOST/DISK rows, a device cache, a published stage, migrated rows and a
spill file, ``gather_aggregate``'s plan equals the oracle's numpy plan
entry for entry, every lookup returns the oracle's bits, and the dispatch
counters, the cache's counters and the DISK miss counts come out equal.
The fused paths also equal per-hop ``lookup`` and ``lookup_hops`` + the
fan sum."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (GPUFeatureCache, TieredFeatureStore,
                              TopologySpec, quiver_placement)
from repro_torch.core import feature_store
from repro_torch.core.placement import (TIER_HOST, TIER_HOT, TIER_WARM)
from repro_torch.graph.sampler import fixed_size_unique
from repro_torch.kernels.gather_aggregate import fan_sum
from repro_torch.kernels.gather_aggregate.ops import gather_aggregate
from repro_torch.kernels.tiered_gather.ops import tiered_gather

N, D, FAN = 900, 12, (4, 3)
PLACEMENTS = {
    # every row on the device: HOT and WARM only
    "device": dict(num_pods=1, devices_per_pod=1, rows_per_device=N,
                   rows_host=0, hot_replicate_fraction=0.3),
    # HOT, WARM, HOST and DISK rows
    "tiered": dict(num_pods=1, devices_per_pod=1, rows_per_device=220,
                   rows_host=330, hot_replicate_fraction=0.3),
}
SETUPS = ("plain", "cache", "stage", "swapped", "all")


class HostResolved(TieredFeatureStore):
    """The store with its former host address resolution: the unique ids
    copied to the host, tier and slot read from the numpy mirrors, the
    segment plan built in numpy and copied to the device. Each plan it
    launches is kept in :attr:`plans`."""

    plans: list

    @staticmethod
    def of(store: TieredFeatureStore) -> "HostResolved":
        out = HostResolved(**{f.name: getattr(store, f.name)
                              for f in dataclasses.fields(store) if f.init})
        out.plans = []
        return out

    def lookup(self, ids, *, include_host=True, dedup=True):
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

    def lookup_hops(self, hops, *, include_host=True):
        hops_t = [self._ids(h) for h in hops]
        sizes = [int(h.shape[0]) for h in hops_t]
        total = sum(sizes)
        snap = self._snapshot()
        self._count(fused_calls=1)
        ids = torch.cat(hops_t)
        uniq, inv = fixed_size_unique(ids, total)
        rows = self._cached_unique(uniq, include_host, snap, fused=True)
        out = torch.where((ids >= 0)[:, None], rows[inv.long()], 0.0)
        return list(torch.split(out, sizes))

    def lookup_aggregate(self, hops, *, include_host=True):
        hops_t = [self._ids(h) for h in hops]
        sizes = [int(h.shape[0]) for h in hops_t]
        p, n_inner = sizes[-2], sizes[-1]
        fan = n_inner // p
        total = sum(sizes)
        n_outer = total - n_inner
        snap = self._snapshot()
        hot, warm = snap[0], snap[1]
        self._count(fused_calls=1, fused_aggregates=1)
        ids = torch.cat(hops_t)
        uniq, inv = fixed_size_unique(ids, total)
        host_view = torch.cat([uniq, inv, hops_t[-1]]).cpu().numpy()
        seg, cold_buf = self._host_plan(host_view, total, n_outer, p, fan,
                                        include_host, snap)
        self.plans.append(seg)
        seg_t = torch.from_numpy(seg).to(self.device)
        self._count(device_gathers=1)
        out = gather_aggregate(seg_t[0], seg_t[1], hot, warm, cold_buf)
        outer_rows = torch.where((ids[:n_outer] >= 0)[:, None],
                                 out[:total][inv[:n_outer].long()], 0.0)
        return list(torch.split(outer_rows, sizes[:-1])), out[total:]

    def _host_plan(self, host_view, total, n_outer, p, fan, include_host,
                   snap):
        hot, tier_tab, slot_tab = snap[0], snap[6], snap[7]
        uniq_np = host_view[:total]
        inv_inner = host_view[total + n_outer:2 * total]
        inner_np = host_view[2 * total:]
        valid_u = uniq_np >= 0
        safe = np.maximum(uniq_np, 0)
        tier_np, slot_np = tier_tab[safe], slot_tab[safe]
        cold = valid_u & (tier_np >= TIER_HOST)
        cold_idx = np.flatnonzero(cold)
        ktier = np.full(total, 99, np.int32)
        ktier[valid_u & (tier_np == TIER_HOT)] = 0
        ktier[valid_u & (tier_np == TIER_WARM)] = 1
        kslot = slot_np.copy()
        if include_host and cold_idx.size:
            cold_buf = self._cached_unique(None, include_host, snap,
                                           fused=True, cold_only=True,
                                           uniq_np=uniq_np[cold_idx])
            ktier[cold] = 2
            kslot[cold] = np.arange(cold_idx.size, dtype=np.int32)
        else:
            cold_buf = hot.new_zeros((1, self.feat_dim))
        seg = np.zeros((2, total + p, fan), np.int32)
        seg[0] = 99
        seg[0, :total, 0] = ktier
        seg[1, :total, 0] = kslot
        seg[0, total:] = np.where(inner_np < 0, 99,
                                  ktier[inv_inner]).reshape(p, fan)
        seg[1, total:] = np.where(inner_np < 0, 0,
                                  kslot[inv_inner]).reshape(p, fan)
        return seg, cold_buf

    def _cached_unique(self, uniq, include_host, snap, *, fused,
                       cold_only=False, uniq_np=None):
        gathers = 0 if cold_only else (1 if fused else 2)
        if cold_only:
            tier_path = self._host_cold_unique
        else:
            tier_path = (self._host_fused_unique if fused
                         else self._host_lookup_unique)
        if include_host and uniq_np is None:
            uniq_np = uniq.cpu().numpy()
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
            return values
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

    def _host_fused_unique(self, uniq, uniq_np, include_host, snap):
        hot, warm = snap[0], snap[1]
        tier_t, slot_t = snap[4], snap[5]
        safe = uniq.long().clamp_min(0)
        tier, slot = tier_t[safe], slot_t[safe]
        span = max(int(hot.shape[0]), int(warm.shape[0]), 1)
        key = tier * span + slot.clamp_max(span - 1)
        order = torch.argsort(key, stable=True)
        dev_sorted = tiered_gather(tier[order], slot[order], hot, warm)
        out = torch.empty_like(dev_sorted)
        out[order] = dev_sorted
        if include_host:
            out = self._host_resolve_cold(uniq_np, out, snap)
        return torch.where((uniq >= 0)[:, None], out, 0.0)

    def _host_cold_unique(self, uniq, uniq_np, include_host, snap):
        if snap[8] is None and bool((uniq_np >= 0).all()):
            return self._fetch_cold(uniq_np, snap[6][uniq_np],
                                    snap[7][uniq_np], snap)
        out = snap[0].new_zeros((uniq_np.shape[0], self.feat_dim))
        return self._host_resolve_cold(uniq_np, out, snap)

    def _host_lookup_unique(self, ids, ids_np, include_host, snap):
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
            out = self._host_resolve_cold(ids_np, out, snap)
        return torch.where((ids >= 0)[:, None], out, 0.0)

    def _host_resolve_cold(self, ids_np, out, snap):
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


@pytest.fixture(scope="module")
def feats():
    return np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)


def _fap():
    return np.random.default_rng(0).random(N)


def _store(feats, placement, setup, spill_path=None):
    """A store of ``placement`` with ``setup`` applied: a device cache
    small enough to evict, a stage over every other cold id, a swap of
    device rows with others; ``all`` is all three over a spill file."""
    store = TieredFeatureStore.build(
        feats, quiver_placement(_fap(), TopologySpec(**PLACEMENTS[placement])),
        spill_path=spill_path if setup == "all" else None, device="cpu")
    tier = store.tier_np
    if setup in ("swapped", "all"):
        hot = np.flatnonzero(tier == TIER_HOT)
        other = np.flatnonzero(tier != TIER_HOT)[::-1]
        store.swap_assignments(list(zip(hot[:20].tolist(),
                                        other[:20].tolist())))
    if setup in ("stage", "all"):
        staged = np.flatnonzero(store.tier_np >= TIER_HOST)[::2][:60]
        stage_slot = np.full(N, -1, np.int32)
        stage_slot[staged] = np.arange(staged.size, dtype=np.int32)
        store.publish_stage(stage_slot, torch.from_numpy(feats[staged]))
    if setup in ("cache", "all"):
        store.attach_cache(GPUFeatureCache.for_store(store, 24))
    return store


def _pair(feats, placement, setup, tmp_path):
    return (_store(feats, placement, setup, str(tmp_path / "a.spill")),
            HostResolved.of(_store(feats, placement, setup,
                                   str(tmp_path / "b.spill"))))


def _hops(batch, seed, pool=None):
    """Seeds, then FAN frontiers; ``-1`` ids, and absent children in the
    innermost hop."""
    rng = np.random.default_rng(seed)
    draw = ((lambda s: rng.integers(-1, N, size=s)) if pool is None
            else (lambda s: rng.choice(pool, size=s)))
    hops = [draw(batch * k).astype(np.int32)
            for k in (1, FAN[0], FAN[0] * FAN[1])]
    hops[-1][::5] = -1
    return hops


def _bits(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.numpy().tobytes() == b.numpy().tobytes())


def _calls(store):
    """One call sequence over every path: cold-only batches twice in a
    row, so that the second is answered by the cache alone."""
    cold = np.flatnonzero(store.tier_np >= TIER_HOST)
    pool = cold[:12] if cold.size else np.arange(12)
    return [("lookup", _hops(8, 1)[1], {}),
            ("lookup", _hops(8, 2)[2], {"dedup": False}),
            ("lookup", _hops(8, 3)[1], {"include_host": False}),
            ("lookup_hops", _hops(8, 4), {}),
            ("lookup_hops", _hops(8, 5), {"include_host": False}),
            ("lookup_aggregate", _hops(8, 6), {}),
            ("lookup_aggregate", _hops(8, 7), {"include_host": False}),
            ("lookup_hops", _hops(2, 8, pool), {}),
            ("lookup_hops", _hops(2, 8, pool), {}),
            ("lookup", _hops(2, 9, pool)[2], {}),
            ("lookup", _hops(2, 9, pool)[2], {"dedup": False}),
            ("lookup_aggregate", _hops(2, 10, pool), {}),
            ("lookup_aggregate", _hops(2, 10, pool), {}),
            ("lookup_hops", _hops(8, 11), {})]


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, tuple):
        return [*out[0], out[1]]
    return list(out)


@pytest.mark.parametrize("setup", SETUPS)
@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
def test_bits_and_counters_equal_host_resolution(feats, placement, setup,
                                                 tmp_path):
    new, old = _pair(feats, placement, setup, tmp_path)
    assert new.n_cold == old.n_cold
    assert (new.n_cold == 0) == (placement == "device")
    for name, arg, kw in _calls(new):
        a = _flat(getattr(new, name)(arg, **kw))
        b = _flat(getattr(old, name)(arg, **kw))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert _bits(x, y), (name, kw)
    assert new.snapshot_stats() == old.snapshot_stats()
    assert np.array_equal(new._disk_miss_counts, old._disk_miss_counts)
    if new.cache is not None:
        assert new.cache.stats == old.cache.stats
        assert np.array_equal(new.cache._slot_of, old.cache._slot_of)
    stats = new.snapshot_stats()
    if placement == "tiered" and setup in ("cache", "all"):
        assert stats["cache_hits"] and stats["cache_evictions"]
    if placement == "tiered" and setup in ("stage", "all"):
        assert stats["prefetch_hits"] and stats["prefetch_misses"]
    if placement == "tiered":
        assert stats["host_fetches"] and stats["disk_misses"]
    else:
        assert not stats["host_fetches"] and not stats["cache_misses"]


@pytest.mark.parametrize("include_host", [True, False])
@pytest.mark.parametrize("setup", SETUPS)
@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
def test_device_plan_equals_host_plan(feats, placement, setup, include_host,
                                      tmp_path, monkeypatch):
    new, old = _pair(feats, placement, setup, tmp_path)
    plans = []

    def recorded(tier, slot, *rest):
        plans.append(torch.stack([tier, slot]).numpy())
        return gather_aggregate(tier, slot, *rest)

    monkeypatch.setattr(feature_store, "gather_aggregate", recorded)
    cold = np.flatnonzero(new.tier_np >= TIER_HOST)
    batches = [_hops(8, 20), _hops(8, 21)]
    if cold.size:
        batches += [_hops(4, 22, cold[:30]), _hops(4, 22, cold[:30])]
    for hops in batches:
        a = new.lookup_aggregate(hops, include_host=include_host)
        b = old.lookup_aggregate(hops, include_host=include_host)
        for x, y in zip(_flat(a), _flat(b)):
            assert _bits(x, y)
    assert len(plans) == len(old.plans) == len(batches)
    for got, want in zip(plans, old.plans):
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)
    kinds = np.unique(np.concatenate([p[0].ravel() for p in plans]))
    assert {0, 1, 99} <= set(kinds.tolist())
    assert (2 in kinds) == (include_host and placement == "tiered")
    assert new.snapshot_stats() == old.snapshot_stats()


@pytest.mark.parametrize("setup", SETUPS)
@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
def test_fused_paths_equal_per_hop_lookup(feats, placement, setup, tmp_path):
    store = _store(feats, placement, setup, str(tmp_path / "s.spill"))
    for seed in (30, 31):
        hops = _hops(8, seed)
        rows = store.lookup_hops(hops)
        for h, r in zip(hops, rows):
            assert _bits(store.lookup(h), r)
            assert np.array_equal(r.numpy(),
                                  np.where((h >= 0)[:, None],
                                           feats[np.maximum(h, 0)], 0))
        p, fan = hops[1].shape[0], FAN[1]
        m = torch.from_numpy((hops[2] >= 0).astype(np.float32)).reshape(
            p, fan, 1)
        feats_a, agg = store.lookup_aggregate(hops)
        assert _bits(agg, fan_sum(rows[2].reshape(p, fan, -1) * m))
        for x, y in zip(feats_a, rows[:2]):
            assert _bits(x, y)
