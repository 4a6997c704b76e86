"""Multi-model serving: one registry over a shared store against isolated
engines.

Deployments co-serve several GNNs over one graph and one feature store.
The registry path (:class:`~repro_torch.serving.ModelRegistry` and one
``ServingEngine``) shares the store, the samplers and the admission
window across models and keeps calibration and routing per model; the
alternative runs one engine a model, each with its own copy of the
store. On a two-model mix (a small and a wide GraphSAGE) this reports:

  1. each model's PSGS cut-point (``CostModelRouter.crossover``): the
     routing divergence that per-model calibration exists for;
  2. store memory: one shared store against the per-engine copies;
  3. throughput of the interleaved two-model stream through the shared
     engine against the same requests through two isolated engines.

    PYTHONPATH=src python -m repro_torch.bench.run --only multi_model

``dry_run=True`` takes the reference's CI sizes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.common import (build_serving_stack, emit,
                                      make_executors, make_model_infer_fn,
                                      store_bytes)
from repro_torch.core import TieredFeatureStore
from repro_torch.serving import (CostModelRouter, ModelRegistry,
                                 ServingEngine, calibrate_executors)

MODELS = {"small": (32, 32), "wide": (128, 128)}


def _probe_batches(psgs: np.ndarray, per: int) -> list[np.ndarray]:
    order = np.argsort(psgs)
    return [order[int(q * order.size):][:per].astype(np.int64)
            for q in np.linspace(0.05, 0.95, 6)]


def run(*, dry_run: bool = False,
        device: str | torch.device = "cuda") -> dict:
    """Emit each model's cut-point, the shared and isolated rps, the store
    memory of both and their throughput ratio; returns the results."""
    nodes = 800 if dry_run else 4000
    n_req, per = (12, 6) if dry_run else (80, 8)
    stack = build_serving_stack(nodes=nodes, device=device)
    psgs, gen, store = stack["psgs"], stack["gen"], stack["store"]
    batches = _probe_batches(psgs, per)
    results: dict = {}

    # -- shared-store registry: one engine, two models -----------------------
    infer_fns = {m: make_model_infer_fn(stack, hidden, seed=i)
                 for i, (m, hidden) in enumerate(MODELS.items())}
    registry = ModelRegistry()
    curves_by_model = {}
    for i, m in enumerate(MODELS):
        ex = make_executors(stack, num_workers=2, max_batch=32,
                            infer_fn=infer_fns[m], rng_seed=i)
        curves = calibrate_executors(ex, batches, psgs, repeats=2)
        curves_by_model[m] = curves
        router = CostModelRouter.from_curves(psgs, curves,
                                             "latency_preferred",
                                             executors=ex)
        registry.register(m, ex, router, infer_fn=infer_fns[m])
        cut = router.crossover("host", "device")
        results.setdefault("cutpoints", {})[m] = cut
        emit(f"multi_model/cutpoint_{m}", cut,
             "host/device PSGS crossover (per-model calibration)")

    shared = ServingEngine(registry, max_inflight=32)
    gen.rng = np.random.default_rng(11)
    reqs = list(gen.stream(n_req, seeds_per_request=per,
                           models=list(MODELS)))
    shared.warmup([reqs[0]])
    m_shared = shared.run([[r] for r in reqs])
    s = m_shared.summary()
    results["shared"] = {"rps": s["throughput_rps"], "p99_ms": s["p99_ms"],
                         "models": s["models"]}
    emit("multi_model/shared_rps", s["throughput_rps"],
         f"p99={s['p99_ms']:.1f}ms;interleaved {len(MODELS)}-model stream")
    shared.close()

    # -- isolated engines: one store COPY + one engine per model -------------
    iso_stores = {m: TieredFeatureStore.build(stack["feats"], store.plan,
                                              device=store.device)
                  for m in MODELS}
    t_iso = 0.0
    iso_requests = 0
    for i, m in enumerate(MODELS):
        ex = make_executors(stack, num_workers=2, max_batch=32,
                            infer_fn=infer_fns[m], store=iso_stores[m],
                            rng_seed=i)
        router = CostModelRouter.from_curves(psgs, curves_by_model[m],
                                             "latency_preferred",
                                             executors=ex)
        engine = ServingEngine(ex, router, max_inflight=32)
        gen.rng = np.random.default_rng(11)  # same workload as shared mode
        mine = [r for r in gen.stream(n_req, seeds_per_request=per,
                                      models=list(MODELS)) if r.model == m]
        for r in mine:
            r.model = "default"  # isolated engines are single-model
        engine.warmup([mine[0]])
        mm = engine.run([[r] for r in mine])
        t_iso += mm.finished - mm.started
        iso_requests += mm.requests
        engine.close()
    iso_rps = iso_requests / max(t_iso, 1e-9)
    results["isolated"] = {"rps": iso_rps}
    emit("multi_model/isolated_rps", iso_rps,
         f"{len(MODELS)} single-model engines, per-engine store copies")

    # -- memory: shared store vs per-engine copies ---------------------------
    mem_shared = store_bytes(store)
    mem_iso = sum(store_bytes(st) for st in iso_stores.values())
    results["store_mb"] = {"shared": mem_shared / 2**20,
                           "isolated": mem_iso / 2**20}
    emit("multi_model/store_shared_mb", mem_shared / 2**20,
         f"isolated={mem_iso / 2**20:.1f}MB;"
         f"saving={(1 - mem_shared / max(mem_iso, 1)) * 100:.0f}%")
    emit("multi_model/throughput_ratio_x",
         s["throughput_rps"] / max(iso_rps, 1e-9),
         "shared registry vs isolated engines on the same request mix")
    return results
