"""Fig. 16: feature-collection throughput of the one-sided read engine
(the tiered store) against RPC-style collection through the host CPU.

    PYTHONPATH=src python -m repro_torch.bench.run --only feature_collection \
        [--size products]

Two views:

* modeled GB/s: each tier's bytes of a Zipf-1.3 id stream at the rates of
  :func:`~repro_torch.bench.common.tier_bandwidths` (HOT local HBM, WARM
  a peer card over NVLink, HOST pinned memory over PCIe, DISK the spill
  file then PCIe; the derived field says which were measured and which
  are spec). RPC collection moves every byte through the host CPU with
  one extra copy: half the pinned host rate;
* measured GB/s of the code paths on the device: ``lookup_hops`` of the
  stream without host rows (``tiered_gather``) and with them (the host
  gateway), against a host gather followed by a pageable copy to the
  card. The store's reads are held to the features bit for bit
  (:func:`~repro_torch.bench.common.check_lookups`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.common import (bandwidth_sources, build_serving_stack,
                                      check_lookups, emit, fused_lookups,
                                      tier_bandwidths, tier_rates, timeit)
from repro_torch.core.placement import (TIER_DISK, TIER_HOST, TIER_HOT,
                                        TIER_WARM)


def run(*, nodes: int = 20000, avg_degree: float = 10.0, d_feat: int = 256,
        num_ids: int = 8192, device: str | torch.device = "cuda") -> dict:
    """Emit the modeled tiered and RPC GB/s, the dedup saving, and the
    measured device-tier, with-host and RPC-style GB/s for ``num_ids``
    Zipf-1.3 ids ranked by FAP."""
    stack = build_serving_stack(nodes=nodes, avg_degree=avg_degree,
                                d_feat=d_feat, hot_frac=0.5, rows_frac=0.5,
                                device=device)
    store, feats, plan = stack["store"], stack["feats"], stack["store"].plan
    dev = store.device
    rng = np.random.default_rng(0)
    m = num_ids
    fap_order = np.argsort(-stack["fap"])
    ids = fap_order[rng.zipf(1.3, size=m) % stack["graph"].num_nodes]
    ids = ids.astype(np.int32)
    row_bytes = feats.shape[1] * 4
    total_bytes = m * row_bytes

    # ---- modeled on the card's tiers ----------------------------------
    bw = tier_bandwidths(dev)
    rate = tier_rates(bw)
    tiers = plan.tier[ids]
    t_model = sum((tiers == t).sum() * row_bytes / rate[t]
                  for t in (TIER_HOT, TIER_WARM, TIER_HOST, TIER_DISK))
    emit("collection/tiered_modeled_GBps", total_bytes / t_model / 1e9,
         f"hot={np.mean(tiers==TIER_HOT):.2f};"
         f"warm={np.mean(tiers==TIER_WARM):.2f};"
         f"host={np.mean(tiers==TIER_HOST):.2f};"
         f"disk={np.mean(tiers==TIER_DISK):.2f};{bandwidth_sources(bw)}")
    emit("collection/rpc_modeled_GBps", rate[TIER_HOST] / 2 / 1e9,
         f"all bytes CPU-mediated;half the pinned host rate "
         f"({bw['host']['source']})")
    # dedup: fraction of gather bytes saved by id-sort+unique
    uniq = np.unique(ids)
    emit("collection/dedup_bytes_saved_pct",
         100.0 * (1 - uniq.size / ids.size), "sorted-unique before fetch")

    # ---- measured on the device -----------------------------------------
    t = timeit(lambda: store.lookup_hops([ids], include_host=False),
               repeats=5, device=dev)
    emit("collection/tiered_device_measured_GBps", total_bytes / t / 1e9,
         f"{m} rows x {feats.shape[1]}f32;device tiers (tiered_gather)")
    t_host = timeit(lambda: store.lookup_hops([ids]), repeats=3, device=dev)
    emit("collection/tiered_with_host_measured_GBps",
         total_bytes / t_host / 1e9, "host gateway for HOST/DISK rows")

    def rpc_collect(idx):
        return torch.from_numpy(feats[np.maximum(idx, 0)]).to(dev)

    t_rpc = timeit(lambda: rpc_collect(ids), repeats=3, device=dev)
    emit("collection/rpc_style_measured_GBps", total_bytes / t_rpc / 1e9,
         "host gather + pageable copy to the device")
    checked = check_lookups(store, feats, ids)
    return {"fused_lookups": fused_lookups(store),
            "bitwise_ids": {plan.name: checked}}
