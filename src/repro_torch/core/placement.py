"""Workload-aware feature placement (paper §5.2): numpy copy of the
reference's ``core/placement.py`` (``quiver_placement``, its types,
``migration_pairs`` for serve-time re-placement, and ``expert_placement``,
FAP's analogue for MoE experts).

Tiers: HOT rows are replicated in every device's memory, WARM rows are
partitioned across devices, HOST rows live in host RAM and DISK rows in
the spill tier. The algorithm is the paper's steps (i)–(v): sort by FAP,
compute per-device capacity, partition-vs-replicate depending on the
interconnect, then balance aggregated FAP per device with a snake
assignment. The same FAP array gives the same plan, bit for bit, in both
packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

TIER_HOT, TIER_WARM, TIER_HOST, TIER_DISK = 0, 1, 2, 3
TIER_NAMES = {TIER_HOT: "hot", TIER_WARM: "warm", TIER_HOST: "host",
              TIER_DISK: "disk"}


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Deployment topology: pods (servers) of devices, per-device row
    budget, host RAM rows, and which interconnects are fast."""

    num_pods: int = 1
    devices_per_pod: int = 8
    numa_groups_per_pod: int = 1
    rows_per_device: int = 1024       # N_g — feature rows per device budget
    rows_host: int = 4096             # N_m — rows in host RAM per pod
    rows_disk: Optional[int] = None   # N_d — None = unbounded cold store
    has_fast_intrapod: bool = True
    has_fast_interpod: bool = True
    hot_replicate_fraction: float = 0.25

    @property
    def group_devices(self) -> int:
        return max(1, self.devices_per_pod // self.numa_groups_per_pod)


@dataclasses.dataclass
class PlacementPlan:
    """Per-node placement decision consumed by the feature store.

    tier[i]         ∈ {HOT, WARM, HOST, DISK}
    pod_owner[i]    owning pod, -1 ⇒ replicated across pods
    device_owner[i] owning device within pod, -1 ⇒ replicated across devices
    slot[i]         row index inside the owning store
    """

    tier: np.ndarray
    pod_owner: np.ndarray
    device_owner: np.ndarray
    slot: np.ndarray
    topology: TopologySpec
    n_hot: int
    warm_rows_per_device: int
    host_rows_per_pod: int
    dim_sharded: bool = False
    name: str = "quiver"

    def tier_counts(self) -> dict[str, int]:
        return {TIER_NAMES[t]: int((self.tier == t).sum())
                for t in (TIER_HOT, TIER_WARM, TIER_HOST, TIER_DISK)}

    def validate(self) -> None:
        n = self.tier.shape[0]
        assert self.pod_owner.shape == (n,) and self.slot.shape == (n,)
        hot = self.tier == TIER_HOT
        warm = self.tier == TIER_WARM
        assert (self.device_owner[hot] == -1).all()
        assert (self.device_owner[warm] >= 0).all()
        if not self.dim_sharded:
            for p in range(self.topology.num_pods):
                in_pod = (self.pod_owner == p) | (self.pod_owner == -1)
                for d in range(self.topology.devices_per_pod):
                    owned = int((warm & in_pod & (self.device_owner == d)).sum())
                    assert self.n_hot + owned <= self.topology.rows_per_device, \
                        (p, d, self.n_hot, owned)


def _snake(ranks: np.ndarray, num_buckets: int) -> np.ndarray:
    """Boustrophedon assignment: balances the aggregated sorted-FAP mass per
    bucket while keeping per-bucket counts equal (paper step v)."""
    period = 2 * num_buckets
    r = ranks % period
    return np.where(r < num_buckets, r, period - 1 - r).astype(np.int16)


def quiver_placement(fap: np.ndarray, topo: TopologySpec, *,
                     name: str = "quiver") -> PlacementPlan:
    n = fap.shape[0]
    order = np.argsort(-fap, kind="stable")  # (i) sort by FAP desc

    g = topo.group_devices                       # (ii) per-group capacity
    n_g = topo.rows_per_device
    hot_frac = 1.0 if not topo.has_fast_intrapod else topo.hot_replicate_fraction
    n_hot = min(int(round(hot_frac * n_g)), n_g, n)
    warm_per_dev = n_g - n_hot
    warm_per_pod = g * warm_per_dev
    if topo.has_fast_interpod:                   # (iv) partition across pods
        warm_total = topo.num_pods * warm_per_pod
        host_total = topo.num_pods * topo.rows_host
    else:                                        # replicate warm set per pod
        warm_total = warm_per_pod
        host_total = topo.rows_host
    warm_total = min(warm_total, max(n - n_hot, 0))
    host_total = min(host_total, max(n - n_hot - warm_total, 0))

    tier = np.full(n, TIER_DISK, dtype=np.int8)
    pod_owner = np.full(n, -1, dtype=np.int16)
    device_owner = np.full(n, -1, dtype=np.int16)
    slot = np.zeros(n, dtype=np.int64)

    hot_ids = order[:n_hot]
    tier[hot_ids] = TIER_HOT
    slot[hot_ids] = np.arange(n_hot)

    warm_ids = order[n_hot:n_hot + warm_total]
    wr = np.arange(warm_total)
    tier[warm_ids] = TIER_WARM
    if topo.has_fast_interpod and topo.num_pods > 1:
        pod_of = _snake(wr, topo.num_pods)
        pod_owner[warm_ids] = pod_of
        within = np.zeros(warm_total, dtype=np.int64)
        for p in range(topo.num_pods):
            m = pod_of == p
            within[m] = np.arange(int(m.sum()))
    else:
        within = wr
    device_owner[warm_ids] = _snake(within, g)   # (v) balance FAP per device
    dslot = np.zeros(warm_total, dtype=np.int64)
    dev = device_owner[warm_ids]
    pw = pod_owner[warm_ids]
    for key in set(zip(pw.tolist(), dev.tolist())) if warm_total else set():
        m = (pw == key[0]) & (dev == key[1])
        dslot[m] = np.arange(int(m.sum()))
    slot[warm_ids] = dslot

    host_ids = order[n_hot + warm_total:n_hot + warm_total + host_total]
    tier[host_ids] = TIER_HOST
    hr = np.arange(host_total)
    if topo.has_fast_interpod and topo.num_pods > 1:
        hpod = _snake(hr, topo.num_pods)
        pod_owner[host_ids] = hpod
        hslot = np.zeros(host_total, dtype=np.int64)
        for p in range(topo.num_pods):
            m = hpod == p
            hslot[m] = np.arange(int(m.sum()))
        slot[host_ids] = hslot
    else:
        slot[host_ids] = hr

    disk_ids = order[n_hot + warm_total + host_total:]
    slot[disk_ids] = np.arange(disk_ids.shape[0])

    plan = PlacementPlan(tier=tier, pod_owner=pod_owner,
                         device_owner=device_owner, slot=slot, topology=topo,
                         n_hot=n_hot, warm_rows_per_device=warm_per_dev,
                         host_rows_per_pod=topo.rows_host, name=name)
    plan.validate()
    return plan


# ---------------------------------------------------------------------------
# Online re-placement (serve-time adaptation)
# ---------------------------------------------------------------------------
def migration_pairs(current_tier: np.ndarray, target_tier: np.ndarray,
                    score: np.ndarray, *, budget: int
                    ) -> list[tuple[int, int]]:
    """Plan one bounded migration step toward ``target_tier``.

    Returns up to ``budget`` disjoint ``(promote, demote)`` node pairs:
    ``promote`` currently sits in a colder tier than its target, ``demote``
    occupies the target tier but belongs colder. Swapping the two complete
    (tier, slot, owner) assignments preserves every per-tier count and
    capacity invariant, so a plan stays valid mid-migration. Each swap puts
    the promoted node in its final tier; the demoted node inherits the
    promoted node's old tier, which may still differ from its own target —
    later steps converge it (3-cycles resolve over multiple steps).

    ``score`` (typically the fresh FAP) orders candidates: hottest promotions
    and coldest demotions first, so a truncated budget moves the most
    valuable rows.
    """
    cur = np.asarray(current_tier)
    tgt = np.asarray(target_tier)
    assert cur.shape == tgt.shape
    pairs: list[tuple[int, int]] = []
    used: set[int] = set()
    for t in (TIER_HOT, TIER_WARM, TIER_HOST):
        if len(pairs) >= budget:
            break
        want_in = np.flatnonzero((tgt == t) & (cur > t))
        leaving = np.flatnonzero((cur == t) & (tgt > t))
        want_in = [int(i) for i in want_in[np.argsort(-score[want_in],
                                                      kind="stable")]
                   if int(i) not in used]
        leaving = [int(i) for i in leaving[np.argsort(score[leaving],
                                                      kind="stable")]
                   if int(i) not in used]
        for a, b in zip(want_in, leaving):
            pairs.append((a, b))
            used.add(a)
            used.add(b)
            if len(pairs) >= budget:
                break
    return pairs


# ---------------------------------------------------------------------------
# FAP-style placement for MoE experts
# ---------------------------------------------------------------------------
def expert_placement(expert_prob: np.ndarray, num_devices: int,
                     replication_budget: int) -> np.ndarray:
    """Distribute ``replication_budget`` extra expert replicas by access
    probability (router statistics ≙ FAP, e.g. an MoE layer's
    ``expert_load``). Returns (num_experts,) replica counts ≥ 1, at most
    ``num_devices``; proportional (largest-remainder) allocation, the
    remainders ranked by the reference's own ``np.argsort``, so ties fall
    as they do there."""
    p = np.asarray(expert_prob, dtype=np.float64)
    p = p / max(p.sum(), 1e-12)
    extra = p * replication_budget
    base = np.floor(extra).astype(np.int64)
    rem = replication_budget - int(base.sum())
    if rem > 0:
        top = np.argsort(-(extra - base))[:rem]
        base[top] += 1
    return np.minimum(1 + base, num_devices)
