"""Fig. 15: feature-aggregation cost under placement policies: Quiver's
FAP placement against hash (DGL), degree (AliGraph), training frequency
(GNNLab/PaGraph) and P3's feature-dimension partitioning, over the ids a
seeded serving stream touches.

    PYTHONPATH=src python -m repro_torch.bench.run --only placement_compare \
        [--size products]

The topology is 2 servers of 4 cards: HOT rows replicated in each card's
HBM, WARM rows on one card of the server (a peer card over NVLink for 3
of 4 reads), HOST rows in pinned host memory over PCIe, DISK rows in the
spill file. Two views a policy:

* modeled: each touched row costs ``HBM_bw / tier_bw`` (the rates of
  :func:`~repro_torch.bench.common.tier_bandwidths`, measured in this run
  or, for a peer card on a one-card machine, the published NVLink rate;
  the derived field names which); the mean cost a batch, and the p95 of
  the slowest tier a batch touches (the tail gates the model's start,
  paper §5.2). P3 splits every row over the server's G cards: (G−1)/G of
  its bytes at the WARM rate, 1/G at the HOT rate;
* measured: each non-P3 placement's store is built on the device, and
  one ``lookup_hops`` of the first request's ids (device tiers only, one
  ``tiered_gather`` launch) is timed; every store's reads of the whole
  stream are held to the features bit for bit
  (:func:`~repro_torch.bench.common.check_lookups`). A store is freed
  before the next is built.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.common import (bandwidth_sources, build_serving_stack,
                                      check_lookups, emit, fused_lookups,
                                      tier_bandwidths, tier_rates, timeit)
from repro_torch.core import (TieredFeatureStore, TopologySpec,
                              degree_placement, freq_placement,
                              hash_placement, monte_carlo_fap, p3_placement,
                              quiver_placement)
from repro_torch.core.placement import TIER_HOT, TIER_NAMES, TIER_WARM
from repro_torch.graph import host_sample
from repro_torch.serving import pad_to_bucket


def run(*, nodes: int = 6000, avg_degree: float = 10.0, d_feat: int = 64,
        device: str | torch.device = "cuda") -> dict:
    """Build the five plans over one stack, emit each policy's modeled
    mean cost and p95 gating tier, and (not P3) its measured lookup µs.
    Returns the stores' ``lookup_hops`` count, the plans validated and the
    ids each store was held to."""
    stack = build_serving_stack(nodes=nodes, avg_degree=avg_degree,
                                d_feat=d_feat, fanouts=(6, 4), device=device)
    dev = stack["store"].device
    g, feats, fap = stack["graph"], stack["feats"], stack["fap"]
    stack["store"] = None  # the figure builds its own stores
    topo = TopologySpec(num_pods=2, devices_per_pod=4,
                        rows_per_device=g.num_nodes // 16,
                        rows_host=g.num_nodes // 3,
                        hot_replicate_fraction=0.3)

    # training-frequency baseline: counts from a *uniform* seed workload
    # (the train/serve distribution shift of paper §2.3)
    train_freq = monte_carlo_fap(g, stack["fanouts"], requests=1500, seed=9)

    plans = {
        "quiver": quiver_placement(fap, topo),
        "hash": hash_placement(g.num_nodes, topo),
        "degree": degree_placement(g.out_degree, topo),
        "freq": freq_placement(train_freq, topo),
        "p3": p3_placement(g.num_nodes, topo),
    }
    for plan in plans.values():
        plan.validate()

    # serving workload: ids actually touched by sampled requests
    stack["gen"].rng = np.random.default_rng(3)
    rng = np.random.default_rng(4)
    touched = []
    for r in stack["gen"].stream(120, seeds_per_request=8):
        hops = host_sample(rng, g, r.seeds, stack["fanouts"])
        t = np.concatenate(hops)
        touched.append(t[t >= 0])
    stream = np.concatenate(touched)

    bw = tier_bandwidths(dev)
    rate = tier_rates(bw)
    cost = np.array([rate[TIER_HOT] / rate[t] for t in sorted(rate)])
    sources = bandwidth_sources(bw)
    summary = {"fused_lookups": 0, "validated": sorted(plans),
               "bitwise_ids": {}}
    for name, plan in plans.items():
        if plan.dim_sharded:
            # P3: every row is split across all G cards → (G-1)/G of each
            # row's bytes cross NVLink on every fetch, no cold tier
            g_dev = topo.devices_per_pod
            per_row = (cost[TIER_WARM] * (g_dev - 1) / g_dev
                       + cost[TIER_HOT] / g_dev)
            costs = [len(t) * per_row for t in touched]
            emit(f"placement/{name}_mean_cost", float(np.mean(costs)),
                 f"modeled;dim-sharded;{sources}")
            emit(f"placement/{name}_p95_tail_tier", float(cost[TIER_WARM]),
                 "every fetch crosses NVLink;tier=warm")
            continue
        costs = [float(cost[plan.tier[t]].sum()) for t in touched]
        tail_tiers = np.array([int(plan.tier[t].max()) for t in touched])
        p95_tier = int(np.quantile(tail_tiers, 0.95, method="higher"))
        store = TieredFeatureStore.build(feats, plan, device=dev)
        # bucket-pad the measured id vector as the serving executors do,
        # so every policy is timed at one shape
        ids = pad_to_bucket(touched[0][:512].astype(np.int32))
        t_lookup = timeit(
            lambda: store.lookup_hops([ids], include_host=False),
            repeats=3, device=dev)
        hist = store.tier_histogram(stream)
        tot = sum(hist.values())
        emit(f"placement/{name}_mean_cost", float(np.mean(costs)),
             f"hot%={hist['hot']/tot:.2f};warm%={hist['warm']/tot:.2f};"
             f"disk%={hist['disk']/tot:.3f};modeled;{sources}")
        emit(f"placement/{name}_p95_tail_tier",
             float(np.quantile(cost[tail_tiers], 0.95)),
             f"slowest tier gating batch;tier={TIER_NAMES[p95_tier]}")
        emit(f"placement/{name}_lookup_us", t_lookup * 1e6,
             "measured lookup_hops, device tiers (tiered_gather)")
        summary["bitwise_ids"][name] = check_lookups(store, feats, stream)
        summary["fused_lookups"] += fused_lookups(store)
        del store
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return summary
