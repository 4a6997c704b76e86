"""Where a request's time goes on the card.

    PYTHONPATH=src python -m repro_torch.bench.profile_serve --requests 50 \
        [--cold-path] [--spill-path P]

Builds the launcher's default stack (``repro_torch.launch.serve``) on
``cuda`` and, for each executor (host sampling, device sampling) and each
feature-collection path (fused ``lookup_hops``, ``lookup_aggregate``),
serves ``--requests`` requests synchronously, one at a time.
``--cold-path`` attaches what the launcher's ``--adaptive --prefetch
--gpu-cache`` attach (the launcher's own helpers build them): the device
cache, the prefetch stage, and the adaptive controller, fed each request's
seeds and latency as the engine's hooks would be, so its control steps
migrate rows and refresh the stage between requests. Each row reports:

* stage breakdown on the host clock, each stage ending in a device
  synchronize: sample, collect (feature store + kernel), infer (model);
* under ``torch.profiler``: the device's busy time per request (kernels
  and copies on the card) and its idle share, ``1 - busy / wall``, plus
  the device time of the five costliest device activities;
* host fetches (cold rows sent to the host gateway), cache hits and
  prefetch hits per request over the profiled pass.

Prints one JSON object per (executor, path) and, with ``--out``, writes
them all to that file. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.graph import device_sample, host_sample_dense
from repro_torch.launch import serve as launcher
from repro_torch.serving import pad_to_bucket

# control period, in requests, under --cold-path: short enough that a
# 50-request pass takes several control steps
COLD_ADAPT_INTERVAL = 16


def _sync() -> None:
    torch.cuda.synchronize()


def _one_request(kind, path, stack, fanouts, seeds, rng, gen, graph_dev,
                 controller=None):
    """Serve one request stage by stage; returns (stage → seconds)."""
    graph, _, _, _, store, _, infer = stack
    if controller is not None:
        controller.on_admit(kind, seeds)
    t0 = time.perf_counter()
    if kind == "host":
        hops_np = host_sample_dense(rng, graph, pad_to_bucket(
            seeds.astype(np.int32)), fanouts)
        hops = [torch.from_numpy(h).cuda() for h in hops_np]
    else:
        hops = device_sample(gen, *graph_dev,
                             torch.from_numpy(seeds.astype(np.int32)).cuda(),
                             fanouts)
    _sync()
    t1 = time.perf_counter()
    if path == "fuse_aggregate":
        feats, deep = store.lookup_aggregate(hops)
    else:
        feats, deep = store.lookup_hops(hops), None
    _sync()
    t2 = time.perf_counter()
    if deep is None:
        infer(feats, hops)
    else:
        infer(feats, hops, deep_agg=deep)
    _sync()
    t3 = time.perf_counter()
    if controller is not None:
        controller.on_batch_complete(kind, seeds, t3 - t0)
    return {"sample": t1 - t0, "collect": t2 - t1, "infer": t3 - t2}


def profile_path(kind, path, stack, fanouts, requests, batch,
                 controller=None):
    graph = stack[0]
    seeds = [r.seeds for r in stack[5].stream(requests, batch)]
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    graph_dev = graph.device_arrays("cuda")

    def serve_all():
        return [_one_request(kind, path, stack, fanouts, s, rng, gen,
                             graph_dev, controller) for s in seeds]

    store = stack[4]
    serve_all()  # warm-up: kernel loads, allocator, cuBLAS handles
    stages = serve_all()
    before = store.snapshot_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_all()
        wall = time.perf_counter() - t0
    after = store.snapshot_stats()
    busy_us, by_name = 0.0, defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            by_name[e.name] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    per_req = {k: statistics.median(s[k] for s in stages) * 1e3
               for k in ("sample", "collect", "infer")}
    return {"executor": kind, "path": path, "requests": requests,
            "batch": batch, "stage_p50_ms": per_req,
            "request_p50_ms": statistics.median(
                sum(s.values()) for s in stages) * 1e3,
            "profiled_wall_ms_per_request": wall / requests * 1e3,
            "device_busy_ms_per_request": busy_us / requests / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "top_device_ms_per_request": {
                name: us / requests / 1e3 for name, us in top},
            "per_request": {k: (after[k] - before[k]) / requests
                            for k in ("host_fetches", "cache_hits",
                                      "prefetch_hits")}}


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(prog="repro_torch.bench.profile_serve")
    p.add_argument("--requests", type=int, default=50)
    p.add_argument("--out", default=None, help="write the rows as JSON here")
    p.add_argument("--cold-path", action="store_true",
                   help="the launcher's --adaptive --prefetch --gpu-cache, "
                        f"a control step every {COLD_ADAPT_INTERVAL} "
                        "requests")
    p.add_argument("--spill-path", default=None,
                   help="back the DISK tier with a spill file here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    flags = (["--adaptive", "--prefetch", "--gpu-cache", "--adapt-interval",
              str(COLD_ADAPT_INTERVAL)] if args.cold_path else [])
    if args.spill_path:
        flags += ["--spill-path", args.spill_path]
    d = launcher.parse_args(flags)
    fanouts = launcher.fanouts_of(d)
    stack = launcher.stack_from_args(d)
    graph, _, psgs, fap, store, _, _ = stack
    # no router: requests are served one at a time on a fixed executor
    controller = launcher.make_controller(d, graph, fanouts, store, None,
                                          psgs)
    # with a controller the prefetcher refreshes on its steps, not as a hook
    prefetcher = launcher.make_prefetcher(d, store, fap, controller, [])
    launcher.make_gpu_cache(d, store, controller)
    rows = []
    try:
        for kind in ("host", "device"):
            for path in ("fused", "fuse_aggregate"):
                row = profile_path(kind, path, stack, fanouts,
                                   args.requests, d.batch, controller)
                row["flags"] = flags
                print(json.dumps(row), flush=True)
                rows.append(row)
    finally:
        if prefetcher is not None:
            prefetcher.close()
    if controller is not None:
        print(json.dumps({"adaptation": controller.report(),
                          "migrated_rows": store.migrated_rows}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": torch.cuda.get_device_name(0), "rows": rows},
                      f, indent=2)
    return rows


if __name__ == "__main__":
    main()
