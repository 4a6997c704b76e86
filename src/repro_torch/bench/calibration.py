"""Fig. 6: measured per-executor latency against accumulated PSGS, and
the four crossover operating points, through the N-way executor
calibration (host sampling against device sampling, both over the tiered
store on the card).

    PYTHONPATH=src python -m repro_torch.bench.run --only calibration

The ``*_avg_ms_*`` rows keep the reference's names; their value is the
fitted average latency in µs (the ``us_per_call`` column), as the
reference's is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.common import (build_serving_stack, close_executors,
                                      emit, fused_lookups, make_executors)
from repro_torch.serving import CalibrationResult, calibrate_executors


def run(*, nodes: int = 5000, avg_degree: float = 10.0, d_feat: int = 64,
        device: str | torch.device = "cuda") -> dict:
    """Calibrate both executors on 8 batches of 32 seeds spread over the
    PSGS quantiles; emit the curves at the q20/q50/q90 batch PSGS and each
    policy's threshold."""
    stack = build_serving_stack(nodes=nodes, avg_degree=avg_degree,
                                d_feat=d_feat, device=device)
    executors = make_executors(stack, num_workers=1, max_batch=64)
    psgs = stack["psgs"]
    order = np.argsort(psgs)
    batches = [order[int(q * len(order)):][:32].astype(np.int64)
               for q in np.linspace(0.05, 0.95, 8)]
    curves = calibrate_executors(executors, batches, psgs, repeats=3)
    close_executors(executors)
    calib = CalibrationResult(host=curves["host"], device=curves["device"])
    for q in (0.2, 0.5, 0.9):
        x = float(np.quantile(psgs, q) * 32)
        emit(f"calibration/host_avg_ms_q{int(q*100)}",
             calib.host.eval_avg(x) * 1e6, f"psgs={x:.0f};unit=us")
        emit(f"calibration/device_avg_ms_q{int(q*100)}",
             calib.device.eval_avg(x) * 1e6, f"psgs={x:.0f};unit=us")
    for policy in ("cpu_preferred", "gpu_preferred", "latency_preferred",
                   "throughput_preferred"):
        emit(f"calibration/threshold_{policy}", calib.threshold(policy),
             "accumulated-PSGS crossover")
    return {"fused_lookups": fused_lookups(stack["store"])}
