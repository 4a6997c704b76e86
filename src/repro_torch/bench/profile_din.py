"""Where a DIN batch's time goes on the card.

    PYTHONPATH=src python -m repro_torch.bench.profile_din --batches 20 \\
        --out profile_din.json

Builds the ``recsys_din --config din`` stack (10M-row item table in the
tiered store, batches of 512) on ``cuda`` and serves ``--batches`` batches
synchronously, one at a time, after a warm-up of the same size:

* stage breakdown on the host clock, each stage ending in a device
  synchronize: lookup (the two ``store.lookup`` calls, target and history
  ids) and forward (``din_forward`` on those rows: attention MLP, the two
  ``embedding_bag`` launches, main MLP);
* under ``torch.profiler``: the device's busy time per batch (kernels and
  copies on the card), its idle share ``1 - busy / wall``, and the five
  costliest device activities;
* the same device profile for one retrieval of ``--candidates``
  candidates.

Prints one JSON object per row and, with ``--out``, writes them all to
that file. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import recsys_din
from repro_torch.models.din import din_forward

KEYS = ("target_item", "target_cate", "hist_items", "hist_cates",
        "dense_feat")


def _one_batch(stack, batch) -> dict[str, float]:
    """Serve one batch stage by stage; returns (stage → seconds)."""
    lookup = recsys_din.item_lookup(stack.store)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = [lookup(batch["target_item"]), lookup(batch["hist_items"])]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fetched = iter(rows)
    din_forward(stack.model, stack.cfg, *(batch[k] for k in KEYS),
                item_lookup=lambda _ids: next(fetched))
    torch.cuda.synchronize()
    return {"lookup": t1 - t0, "forward": time.perf_counter() - t1}


def _device_profile(fn) -> tuple[float, float, dict[str, float]]:
    """Run ``fn`` under the profiler: (wall s, device busy µs, µs by
    device activity)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, by_name = 0.0, defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            by_name[e.name] += us
    return wall, busy_us, by_name


def _top(by_name: dict[str, float], per: int) -> dict[str, float]:
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {name: us / per / 1e3 for name, us in top}


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(prog="repro_torch.bench.profile_din")
    p.add_argument("--batches", type=int, default=20)
    p.add_argument("--candidates", type=int, default=1_000_000)
    p.add_argument("--out", default=None, help="write the rows as JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_din needs a CUDA device")
    stack = recsys_din.build_stack("din", device="cuda")
    batches = [recsys_din.draw_batch(stack)
               for _ in range(2 * args.batches)]
    warm, timed = batches[:args.batches], batches[args.batches:]
    for b in warm:  # kernel loads, allocator, cuBLAS handles
        _one_batch(stack, b)
    stages = [_one_batch(stack, b) for b in timed]
    wall, busy_us, by_name = _device_profile(
        lambda: [recsys_din.score_batch(stack, b) for b in timed])
    n = len(timed)
    rows = [{
        "path": "serve", "batches": n, "batch": stack.batch,
        "stage_p50_ms": {k: statistics.median(s[k] for s in stages) * 1e3
                         for k in ("lookup", "forward")},
        "batch_p50_ms": statistics.median(
            sum(s.values()) for s in stages) * 1e3,
        "profiled_wall_ms_per_batch": wall / n * 1e3,
        "device_busy_ms_per_batch": busy_us / n / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "top_device_ms_per_batch": _top(by_name, n)}]
    if args.candidates:
        recsys_din.score_candidates(stack, timed[0], args.candidates)
        wall, busy_us, by_name = _device_profile(
            lambda: recsys_din.score_candidates(stack, timed[0],
                                                args.candidates))
        rows.append({
            "path": "retrieval", "candidates": args.candidates,
            "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "top_device_ms": _top(by_name, 1)})
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": torch.cuda.get_device_name(0), "rows": rows},
                      f, indent=2)
    return rows


if __name__ == "__main__":
    main()
