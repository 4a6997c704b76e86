"""Fig. 2/3: skew in sampled-neighbour counts and aggregated feature
sizes on a power-law graph, the irregularity that motivates Quiver.

    PYTHONPATH=src python -m repro_torch.bench.run --only motivation

The figure describes the workload, not a device: the graph, the exact
host sampler and the sizes are host numpy (draw for draw the reference's,
so one seed gives the same sizes in both packages). ``device`` is only
checked, as every figure's is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bench.common import emit
from repro_torch.graph import host_sample, power_law_graph, realized_size


def run(*, nodes: int = 20000, avg_degree: float = 12.0,
        device: str | torch.device = "cuda") -> dict:
    """Emit the p05/p95/max sampled sizes, the p50 feature megabytes and
    the max/min size ratio for fanouts 25-10 and 50-35 (200 batches of 8
    seeds each, d 128 fp32)."""
    resolve_device(device)
    g = power_law_graph(nodes, avg_degree, seed=0)
    rng = np.random.default_rng(0)
    d_feat = 128
    for fanouts, tag in (((25, 10), "25-10"), ((50, 35), "50-35")):
        sizes = []
        for _ in range(200):
            seeds = rng.integers(0, g.num_nodes, size=8)
            sizes.append(realized_size(host_sample(rng, g, seeds, fanouts)))
        sizes = np.asarray(sizes)
        feat_mb = sizes * d_feat * 4 / 2**20
        emit(f"motivation/sampled_nodes_{tag}_p05",
             float(np.quantile(sizes, .05)),
             f"p95={np.quantile(sizes, .95):.0f};max={sizes.max()}")
        emit(f"motivation/feat_mb_{tag}_p50", float(np.quantile(feat_mb, .5)),
             f"p95={np.quantile(feat_mb, .95):.2f}MB")
        emit(f"motivation/size_skew_{tag}", float(sizes.max() / sizes.min()),
             "max/min sampled-size ratio")
    return {"fused_lookups": 0}
