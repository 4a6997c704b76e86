"""Fig. 9: throughput and p99 latency of Quiver's PSGS-hybrid routing
against static host-only and device-only execution, through the serving
engine on the same seeded workload.

    PYTHONPATH=src python -m repro_torch.bench.run --only serve_throughput \
        [--size products]

At the reference's size (5,000 nodes, 60 requests submitted at once) the
p99 is close to the largest of 60 samples: a check that the path runs.
``--size products`` serves 600 requests on the ogbn-products-sized graph,
first all at once (the rps a system sustains), then paced at 100 a second
on the same engine (the latency at a load every system keeps up with).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.common import (build_serving_stack, emit,
                                      fused_lookups, make_engine)
from repro_torch.serving import HybridScheduler, StaticScheduler


def run(*, nodes: int = 5000, avg_degree: float = 10.0, d_feat: int = 64,
        requests: int = 60, rate: float | None = None,
        device: str | torch.device = "cuda") -> dict:
    """Serve ``requests`` requests of 8 seeds (one request a batch) under
    each system, all at once, then, where ``rate`` is given, again at
    ``rate`` a second; emit the burst's rps with p99 and the routed
    counts, and the paced run's p99 with its rps and p50."""
    stack = build_serving_stack(nodes=nodes, avg_degree=avg_degree,
                                d_feat=d_feat, device=device)
    psgs = stack["psgs"]
    gen = stack["gen"]
    per = 8

    for name, router_fn in (
            ("quiver", lambda: HybridScheduler(psgs, float(np.median(psgs))
                                               * per * 2)),
            ("host_only", lambda: StaticScheduler("host")),
            ("device_only", lambda: StaticScheduler("device"))):
        engine = make_engine(stack, router_fn(), num_workers=2, max_batch=32)
        gen.rng = np.random.default_rng(7)  # same workload for all systems
        batches = [[r] for r in gen.stream(requests, seeds_per_request=per)]
        engine.warmup(batches[0])  # warm every executor outside measurement
        s = engine.run(batches).summary()
        emit(f"serve_throughput/{name}_rps", s["throughput_rps"],
             f"p99={s['p99_ms']:.1f}ms;host={s['routed_host']};"
             f"dev={s['routed_device']}")
        if rate:
            s = engine.run(batches, pace_s=1.0 / rate).summary()
            emit(f"serve_throughput/{name}_paced_p99_ms", s["p99_ms"],
                 f"offered={rate:g}rps;rps={s['throughput_rps']:.2f};"
                 f"p50={s['p50_ms']:.2f}ms;n={s['requests']};"
                 f"host={s['routed_host']};dev={s['routed_device']}")
        engine.close()
    return {"fused_lookups": fused_lookups(stack["store"])}
