"""Fig. 10: latency predictability under PSGS-Strict, PSGS-Loose and
Batchsize-Bound batching.

    PYTHONPATH=src python -m repro_torch.bench.run --only policy_cdf

The paper's claim is that cost-aware (PSGS-budget) batches have
predictable processing latency, while fixed-size batches inherit the
per-request cost variance. On the card a batch still pays a fixed host
cost (the host sampler's Python loop, one operator issue per op, one
synchronize) of the order of the batch's device work, which would blur a
queueing comparison. So the claim is measured directly: the distribution
of each policy's per-batch processing time (the same request stream,
the same host executor), and the spread of each batch's accumulated
PSGS. PSGS budgeting should compress p99/p50 and the coefficient of
variation; Batchsize-Bound should not.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.common import (build_serving_stack, close_executors,
                                      emit, fused_lookups, make_executors,
                                      timeit)
from repro_torch.core import DynamicBatcher


def _compose(batcher, requests):
    batches = []
    for r in requests:
        out = batcher.add(r)
        if out:
            batches.append(out)
    tail = batcher.flush()
    if tail:
        batches.append(tail)
    return batches


def run(*, nodes: int = 5000, device: str | torch.device = "cuda") -> dict:
    """Compose 256 one-seed requests under each policy, time every batch
    on the host executor; emit the p50 batch ms (p99/p50, cv and the
    batch count beside it) and the per-batch PSGS spread."""
    stack = build_serving_stack(nodes=nodes, fanouts=(25, 10),
                                distribution="uniform", device=device)
    dev = stack["store"].device
    psgs = stack["psgs"]
    med = float(np.median(psgs))
    stack["gen"].rng = np.random.default_rng(11)
    requests = list(stack["gen"].stream(256, seeds_per_request=1))

    executors = make_executors(stack, num_workers=1, max_batch=64)
    host = executors["host"]
    host.warmup(requests[0].seeds)

    policies = {
        "psgs_strict": DynamicBatcher(deadline_s=1e9, psgs_budget=med * 16,
                                      psgs_table=psgs, max_batch=64),
        "psgs_loose": DynamicBatcher(deadline_s=1e9, psgs_budget=med * 48,
                                     psgs_table=psgs, max_batch=64),
        "batchsize_bound": DynamicBatcher(deadline_s=1e9, max_batch=16),
    }
    for name, batcher in policies.items():
        batches = _compose(batcher, list(requests))
        times, works = [], []
        for b in batches:
            seeds = np.concatenate([r.seeds for r in b])
            times.append(timeit(lambda: host.process(seeds), repeats=2,
                                warmup=1, device=dev))
            works.append(float(psgs[seeds].sum()))
        times = np.asarray(times)
        works = np.asarray(works)
        emit(f"policy_cdf/{name}_batch_p50_ms",
             float(np.quantile(times, 0.5) * 1e3),
             f"p99/p50={np.quantile(times,0.99)/np.quantile(times,0.5):.2f};"
             f"cv={times.std()/times.mean():.2f};batches={len(batches)}")
        emit(f"policy_cdf/{name}_work_cv",
             float(works.std() / max(works.mean(), 1e-9)),
             "per-batch accumulated-PSGS spread")
    close_executors(executors)
    return {"fused_lookups": fused_lookups(stack["store"])}
