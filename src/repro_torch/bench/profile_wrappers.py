"""Where an eager call of a serve kernel's wrapper spends its host time.

    PYTHONPATH=src python -m repro_torch.bench.profile_wrappers \
        --calls 1000 --out chiprun_out/profile_wrappers.json

For ``tiered_gather_cuda`` and ``gather_aggregate_cuda`` at the serve
path's shapes (M 1,952 rows; S 2,272 segments of fan 5, 1,952 of them
one child and four pads; d 128 fp32; tables of 1,250 / 3,750 / 9 rows,
drawn from ``--seed``):

* ``call_ms``: host clock over ``--calls`` back-to-back eager calls that
  end in one synchronize, divided by the count (the host's cost of a call
  whenever it exceeds the kernel's);
* ``device_ms``: CUDA events over the same calls replayed from a CUDA
  graph (the kernel alone);
* under ``cProfile``, the functions that take the most of the calls'
  time, by own time, in microseconds a call (``cProfile`` slows Python
  code, so read them as shares);
* ``host_parts``: the host clock, per call, of steps any wrapper of a
  kernel that returns a fresh tensor pays on this host (allocating the
  output with ``torch.empty``; one PyTorch op's launch, an in-place add
  on one element; the current device and stream queries), beside which
  the wrappers' own cost can be read.

Prints one JSON object per wrapper and, with ``--out``, writes them all
there. Needs a CUDA device. Only the two wrappers' public signatures are
used, so the same script measures any tree that has them.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import time

import numpy as np
import torch

from repro_torch.kernels.gather_aggregate import kernel as ga_kernel
from repro_torch.kernels.tiered_gather import kernel as tg_kernel

D = 128
HOT, WARM, COLD = 1250, 3750, 9
M = 1952
SINGLES, FULL, FAN = 1952, 320, 5


def _inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def table(rows):
        return torch.from_numpy(rng.normal(size=(rows, D))
                                .astype(np.float32)).to(dev)

    hot, warm, cold = table(HOT), table(WARM), table(COLD)
    tier = rng.integers(0, 2, M).astype(np.int32)
    slot = rng.integers(0, WARM, M).astype(np.int32)
    seg_tier = np.full((SINGLES + FULL, FAN), 99, np.int32)
    seg_tier[:SINGLES, 0] = rng.integers(0, 3, SINGLES)
    seg_tier[SINGLES:] = rng.integers(0, 3, (FULL, FAN))
    seg_slot = rng.integers(0, COLD, seg_tier.shape).astype(np.int32)

    def dev_i32(a):
        return torch.from_numpy(a).to(dev)

    return {"tiered_gather": (tg_kernel.tiered_gather_cuda,
                              (dev_i32(tier), dev_i32(slot), hot, warm)),
            "gather_aggregate": (ga_kernel.gather_aggregate_cuda,
                                 (dev_i32(seg_tier), dev_i32(seg_slot), hot,
                                  warm, cold))}


def _device_ms(fn, args, inner: int = 20, reps: int = 25) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn(*args)
    g.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return float(np.median(samples))


def _call_ms(fn, args, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def _profile(fn, args, calls: int, top: int) -> list[dict]:
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    for _ in range(calls):
        fn(*args)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = []
    for (path, line, name), (_, ncalls, tottime, cumtime, _) in stats.items():
        rows.append({"function": f"{path.rsplit('/', 1)[-1]}:{line}({name})",
                     "calls_per_call": ncalls / calls,
                     "own_us": tottime / calls * 1e6,
                     "cumulative_us": cumtime / calls * 1e6})
    rows.sort(key=lambda r: -r["own_us"])
    return rows[:top]


def _host_parts(calls: int) -> dict:
    dev = torch.device("cuda")
    one = torch.zeros(1, device=dev)

    def device_guard():
        with torch.cuda.device(dev):
            pass

    parts = {
        "torch.empty((1952, 128)) on the card":
            lambda: torch.empty((M, D), device=dev),
        "one.add_(1): a PyTorch op's launch": lambda: one.add_(1),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "with torch.cuda.device(dev)": device_guard,
    }
    out = {}
    for name, fn in parts.items():
        for _ in range(50):
            fn()
        out[name] = _call_ms(lambda *_: fn(), (), calls) * 1e3
    return out


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(prog="repro_torch.bench.profile_wrappers")
    p.add_argument("--calls", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--out", default=None, help="write the rows as JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_wrappers needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    rows = []
    for name, (fn, fargs) in _inputs(args.seed).items():
        for _ in range(50):                   # build, load, warm up
            fn(*fargs)
        row = {"wrapper": name, "card": card, "calls": args.calls,
               "call_ms": _call_ms(fn, fargs, args.calls),
               "device_ms": _device_ms(fn, fargs),
               "profile": _profile(fn, fargs, args.calls, args.top)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    parts = _host_parts(args.calls)
    print(json.dumps({"host_parts_us": parts}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows, "host_parts_us": parts},
                      f, indent=1)
    return rows


if __name__ == "__main__":
    main()
