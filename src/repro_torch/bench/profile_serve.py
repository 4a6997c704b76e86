"""Where a request's time goes on the card.

    PYTHONPATH=src python -m repro_torch.bench.profile_serve --requests 50

Builds the launcher's default stack (``repro_torch.launch.serve``) on
``cuda`` and, for each executor (host sampling, device sampling) and each
feature-collection path (fused ``lookup_hops``, ``lookup_aggregate``),
serves ``--requests`` requests synchronously, one at a time:

* stage breakdown on the host clock, each stage ending in a device
  synchronize: sample, collect (feature store + kernel), infer (model);
* under ``torch.profiler``: the device's busy time per request (kernels
  and copies on the card) and its idle share, ``1 - busy / wall``, plus
  the device time of the five costliest device activities.

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


def _sync() -> None:
    torch.cuda.synchronize()


def _one_request(kind, path, stack, fanouts, seeds, rng, gen, graph_dev):
    """Serve one request stage by stage; returns (stage → seconds)."""
    graph, _, _, _, store, _, infer = stack
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
    return {"sample": t1 - t0, "collect": t2 - t1, "infer": t3 - t2}


def profile_path(kind, path, stack, fanouts, requests, batch):
    graph = stack[0]
    seeds = [r.seeds for r in stack[5].stream(requests, batch)]
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    graph_dev = graph.device_arrays("cuda")

    def serve_all():
        return [_one_request(kind, path, stack, fanouts, s, rng, gen,
                             graph_dev) for s in seeds]

    serve_all()  # warm-up: kernel loads, allocator, cuBLAS handles
    stages = serve_all()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_all()
        wall = time.perf_counter() - t0
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
                name: us / requests / 1e3 for name, us in top}}


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(prog="repro_torch.bench.profile_serve")
    p.add_argument("--requests", type=int, default=50)
    p.add_argument("--out", default=None, help="write the rows as JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    d = launcher.parse_args([])
    fanouts = tuple(int(x) for x in d.fanouts.split(","))
    stack = launcher.build_stack(nodes=d.nodes, avg_degree=d.avg_degree,
                                 d_feat=d.d_feat, fanouts=fanouts,
                                 hot_frac=d.hot_frac, device="cuda")
    rows = []
    for kind in ("host", "device"):
        for path in ("fused", "fuse_aggregate"):
            row = profile_path(kind, path, stack, fanouts, args.requests,
                               d.batch)
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": torch.cuda.get_device_name(0), "rows": rows},
                      f, indent=2)
    return rows


if __name__ == "__main__":
    main()
