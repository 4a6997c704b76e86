"""Fused gather→aggregate: the first layer's neighbour sums straight from
the tier tables against gather-then-aggregate.

The unfused serve path pays for the innermost hop twice: ``lookup_hops``
writes the dense ``(n_sampled, d)`` neighbour tensor, then the model's
first layer reads it back to sum each fan-sized segment into its parent.
``TieredFeatureStore.lookup_aggregate`` (the ``gather_aggregate`` kernel)
folds that sum into the gather, so the dense tensor is never written.

The feature width flips a gather between latency- and bandwidth-bound,
so every claim is swept over ``DIMS``; at each width this asserts

  1. bit identity: the fused outer-hop rows, the aggregate (against the
     in-order fp32 fan sum of ``lookup_hops``' rows) and the model's
     output all equal the unfused path's;
  2. fewer kernel dispatches a request (a gather plus the model's
     reduction pass against one fused launch);
  3. fewer modeled bytes for the innermost hop (:func:`deep_bytes`);

and measures store-level collection plus inference time, serving rps and
p99 with the executors flipped between the two paths (their outputs
asserted equal), and, on the card, the launch-shape autotune of the CUDA
kernel (:func:`~repro_torch.kernels.gather_aggregate.
autotune_gather_aggregate`), emitted as ``gather_aggregate/
autotune_lanes`` (the reference's row, ``autotune_block_rows``, names
the Pallas tile it sweeps). On the CPU there is no kernel to tune: no
autotune row, and ``"autotune": "needs cuda"`` in the results.

    PYTHONPATH=src python -m repro_torch.bench.run --only gather_aggregate

``dry_run=True`` takes the reference's CI sizes (all three widths and
every assertion kept).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.common import (build_serving_stack, emit, make_engine,
                                      make_executors, same_bits, timeit,
                                      write_bench_json)
from repro_torch.bench.fused_gather import sample_hops
from repro_torch.kernels.gather_aggregate import (autotune_gather_aggregate,
                                                  fan_sum)
from repro_torch.serving import HybridScheduler

DIMS = (16, 64, 256)


def deep_bytes(hops, p: int, d: int, *, fused: bool) -> int:
    """Modeled innermost-hop traffic a request (fp32): both paths read each
    valid child row from its tier table once; the unfused path also writes
    the dense ``(n_inner, d)`` tensor and reads it back for the model's
    segment sum, the fused path writes only the ``(P, d)`` aggregate."""
    inner = hops[-1]
    n_inner = int(inner.shape[0])
    n_valid = int((inner >= 0).sum())
    reads_src = n_valid * d * 4
    agg_write = p * d * 4
    if fused:
        return reads_src + agg_write
    return reads_src + 2 * n_inner * d * 4 + agg_write


def run(*, dry_run: bool = False,
        device: str | torch.device = "cuda") -> dict:
    """Emit the width sweep's dispatches, bytes and times, the executors'
    identity, each mode's serving rps and, on the card, the autotune's
    best plan; returns the results written to
    ``BENCH_gather_aggregate.json``."""
    nodes = 700 if dry_run else 4000
    n_req, per = (10, 8) if dry_run else (50, 8)
    repeats = 3 if dry_run else 5
    fanouts = (4, 3)
    results: dict = {"sweep": []}

    # -- 1) embedding-dim sweep: identity + dispatches + bytes + latency -----
    for d_feat in DIMS:
        stack = build_serving_stack(nodes=nodes, d_feat=d_feat,
                                    fanouts=fanouts, seed=0, device=device)
        store, gen = stack["store"], stack["gen"]
        dev = store.device
        gen.rng = np.random.default_rng(7)
        hops = sample_hops(stack, gen.make_request(per).seeds)
        p = int(hops[-2].shape[0])
        fan = fanouts[-1]

        store.reset_stats()
        feats_u = store.lookup_hops(hops)
        s_u = store.reset_stats()
        feats_f, agg = store.lookup_aggregate(hops)
        s_f = store.reset_stats()

        # bit identity: outer rows, the aggregate, and the model output
        child = feats_u[-1].reshape(p, fan, -1)
        m = (hops[-1] >= 0).float().reshape(p, fan, 1)
        expected = fan_sum(child * m)
        ident = (all(same_bits(a, b) for a, b in zip(feats_u[:-1], feats_f))
                 and same_bits(agg, expected))
        infer = stack["infer_fn"]
        out_ident = same_bits(infer(feats_u, hops),
                             infer(feats_f, hops, deep_agg=agg))
        assert ident and out_ident, (
            f"fused/unfused layer-1 paths diverged at d={d_feat}: "
            f"collect={ident} model={out_ident}")

        # kernel dispatches a request: the unfused path runs the tier
        # gather AND a model-side reduction pass over the dense deepest-hop
        # tensor; the fused path folds the reduction into its one dispatch
        disp_u = s_u["device_gathers"] + 1
        disp_f = s_f["device_gathers"]
        assert disp_f < disp_u, (disp_f, disp_u)

        bytes_u = deep_bytes(hops, p, d_feat, fused=False)
        bytes_f = deep_bytes(hops, p, d_feat, fused=True)
        assert bytes_f < bytes_u, (bytes_f, bytes_u)

        t_u = timeit(lambda: infer(store.lookup_hops(hops), hops),
                     repeats=repeats, device=dev)
        t_f = timeit(lambda: (lambda ff, ag: infer(ff, hops, deep_agg=ag))(
            *store.lookup_aggregate(hops)), repeats=repeats, device=dev)
        store.reset_stats()

        row = {"d_feat": d_feat, "bit_identical": ident and out_ident,
               "dispatches": {"unfused": disp_u, "fused": disp_f},
               "deep_hop_bytes": {"unfused": bytes_u, "fused": bytes_f},
               "collect_infer_us": {"unfused": t_u * 1e6,
                                    "fused": t_f * 1e6}}
        results["sweep"].append(row)
        emit(f"gather_aggregate/d{d_feat}_dispatches", float(disp_f),
             f"unfused={disp_u};bit_identical={int(ident and out_ident)}")
        emit(f"gather_aggregate/d{d_feat}_deep_bytes", float(bytes_f),
             f"unfused={bytes_u};"
             f"saved={1 - bytes_f / max(bytes_u, 1):.0%}")
        emit(f"gather_aggregate/d{d_feat}_collect_infer_us", t_f * 1e6,
             f"unfused={t_u * 1e6:.0f}us")

    # -- 2) executor-level equivalence + end-to-end serving ------------------
    stack = build_serving_stack(nodes=nodes, fanouts=fanouts, seed=0,
                                device=device)
    store, psgs, gen = stack["store"], stack["psgs"], stack["gen"]
    gen.rng = np.random.default_rng(7)
    seeds = gen.make_request(per).seeds

    ex_u = make_executors(stack, num_workers=1, rng_seed=11)
    ex_f = make_executors(stack, num_workers=1, fuse_aggregate=True,
                          rng_seed=11)
    # identical rng seeds → identical sampled hops → outputs must match
    exec_ident = same_bits(ex_u["host"].process(seeds),
                          ex_f["host"].process(seeds))
    assert exec_ident, "executor outputs diverged under fuse_aggregate"
    results["executor_bit_identical"] = exec_ident
    emit("gather_aggregate/executor_bit_identical", float(exec_ident))
    for e in (*ex_u.values(), *ex_f.values()):
        e.close()

    thr = float(np.median(psgs)) * per * 2
    for mode in ("fused", "fuse_aggregate"):
        engine = make_engine(stack, HybridScheduler(psgs, thr),
                             num_workers=2, max_batch=32,
                             fuse_aggregate=mode == "fuse_aggregate")
        gen.rng = np.random.default_rng(7)  # same workload for both modes
        reqs = list(gen.stream(n_req, seeds_per_request=per))
        engine.warmup([reqs[0]])
        store.reset_stats()
        metrics = engine.run([[r] for r in reqs])
        stats = store.reset_stats()
        s = metrics.summary()
        results[mode] = {"rps": s["throughput_rps"], "p99_ms": s["p99_ms"],
                         "fused_aggregates": stats["fused_aggregates"]}
        emit(f"gather_aggregate/{mode}_rps", s["throughput_rps"],
             f"p99={s['p99_ms']:.1f}ms;"
             f"fused_aggregates={stats['fused_aggregates']}")
        engine.close()
    results["serve_speedup_x"] = (results["fuse_aggregate"]["rps"]
                                  / max(results["fused"]["rps"], 1e-9))
    emit("gather_aggregate/serve_speedup_x", results["serve_speedup_x"],
         "fuse_aggregate vs fused end-to-end throughput")

    # -- 3) launch-shape autotune of the CUDA kernel (card only) -------------
    if store.device.type != "cuda":
        results["autotune"] = "needs cuda"
    else:
        rng = np.random.default_rng(3)
        s_seg = 64 if dry_run else 256
        dev = store.device
        tier = torch.from_numpy(rng.choice(
            [0, 1, 99], size=(s_seg, fanouts[-1]),
            p=[.5, .4, .1]).astype(np.int32)).to(dev)
        slot = torch.from_numpy(rng.integers(
            0, max(int(store.hot.shape[0]), 1),
            (s_seg, fanouts[-1])).astype(np.int32)).to(dev)
        tune = autotune_gather_aggregate(
            tier, slot, store.hot, store.warm,
            store.hot.new_zeros((1, store.feat_dim)),
            repeats=2 if dry_run else 5)
        results["autotune"] = tune
        best, default = tune["best"], tune["default"]
        key = "{vec_bytes}x{lanes}x{blocks}"
        emit("gather_aggregate/autotune_lanes", float(best["lanes"]),
             f"blocks={best['blocks']};vec_bytes={best['vec_bytes']};"
             f"best_us={tune['timings_us'][key.format(**best)]:.3f};"
             f"default={default['lanes']}x{default['blocks']};"
             f"default_us={tune['timings_us'][key.format(**default)]:.3f};"
             f"plans={len(tune['timings_us'])}")

    write_bench_json("gather_aggregate", results)
    return results
