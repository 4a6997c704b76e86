"""Fig. 13: robustness to data skew. PSGS routing against static host
and device execution over small, medium and large (hub) workloads at
batch 4 and 96.

    PYTHONPATH=src python -m repro_torch.bench.run --only skew_robustness

The paper's claim is checked as the reference checks it: the executor
PSGS routes each batch to must take at most 1.5× the better static
executor's time, plus 1 ms. Both executors are timed in alternation
(``interleaved_times``), the median of each, so that a burst of load on
the host's shared cores does not fall on one of them alone.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.common import (build_serving_stack, close_executors,
                                      emit, fused_lookups, make_executors,
                                      timeit)
from repro_torch.serving import HybridScheduler

ROUNDS = 11  # alternating timed calls of each executor


def interleaved_times(host, device_fn, *, rounds: int = ROUNDS,
                      device: str | torch.device = "cuda") -> tuple:
    """Median seconds of ``host()`` and of ``device_fn()`` over ``rounds``
    alternating calls of each (two untimed calls of each first). The host
    shares its cores, so a stretch of contention lands on both executors
    alike instead of on whichever was being timed then."""
    th, td = [], []
    for r in range(rounds):
        warmup = 2 if r == 0 else 0
        th.append(timeit(host, repeats=1, warmup=warmup, device=device))
        td.append(timeit(device_fn, repeats=1, warmup=warmup, device=device))
    return float(np.median(th)), float(np.median(td))


def run(*, nodes: int = 5000, avg_degree: float = 10.0, d_feat: int = 64,
        device: str | torch.device = "cuda") -> dict:
    """Time host and device executors on each workload and batch size,
    route by the PSGS threshold ``median · batch · 2``, emit the three
    times and the route, and assert the routed time."""
    stack = build_serving_stack(nodes=nodes, avg_degree=avg_degree,
                                d_feat=d_feat, fanouts=(10, 5), device=device)
    dev = stack["store"].device
    psgs = stack["psgs"]
    order = np.argsort(psgs)
    workloads = {
        "small": order[:512],            # low-degree seeds
        "medium": order[len(order) // 2: len(order) // 2 + 512],
        "large": order[-512:],           # hub seeds
    }
    for batch in (4, 96):
        for wname, pool in workloads.items():
            seeds = pool[:batch].astype(np.int64)
            executors = make_executors(stack, max_batch=batch)
            t_host, t_dev = interleaved_times(
                lambda: executors["host"].process(seeds),
                lambda: executors["device"].process(seeds), device=dev)
            close_executors(executors)
            # PSGS picks per-batch using the throughput threshold
            thr = float(np.median(psgs)) * batch * 2
            hybrid = HybridScheduler(psgs, thr)
            t_psgs = t_host if hybrid.route(seeds) == "host" else t_dev
            emit(f"skew/{wname}_b{batch}_host_us", t_host * 1e6, "")
            emit(f"skew/{wname}_b{batch}_device_us", t_dev * 1e6, "")
            emit(f"skew/{wname}_b{batch}_psgs_us", t_psgs * 1e6,
                 f"routed={hybrid.routed};threshold={thr:.1f}")
            # the PSGS strategy must match the best static choice
            best = min(t_host, t_dev)
            assert t_psgs <= best * 1.5 + 1e-3, (
                f"{wname} b{batch}: routed {t_psgs * 1e6:.1f} us against "
                f"host {t_host * 1e6:.1f}, device {t_dev * 1e6:.1f}, "
                f"threshold {thr:.1f}, {hybrid.routed}")
    return {"fused_lookups": fused_lookups(stack["store"])}
