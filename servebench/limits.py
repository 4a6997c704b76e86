"""Readings that the limits of ``correct`` are set from: for each seed,
the cell's inputs and stack, a short window at the cell's own load, then
the sampled answers against the reference (the program's readings) and
the TF32 reference put in the program's place (the control's).

    python3 servebench/limits.py --workload reddit-sage2.bulk \
        --seeds 101,102,103 --seconds 8

One JSON line a seed. The lower reading of a number is the largest the
program gives over a dozen seeds or more; the upper, the smallest the
control gives.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from servebench import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="servebench/limits.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("servebench: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(run.ROOT / "src"))
    device = torch.device("cuda", 0)
    spec = run.cell_spec(run.load_json(run.ROOT / "BENCHMARK.json"),
                         args.workload, run.BENCH_DIR)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        prep = run.prepare(spec["cfg"], spec["traffic"], seed, device)
        res = run.drive(prep, spec["traffic"], args.seconds, seed)
        readings = run.answers(prep, res, device, control=True)
        print(json.dumps({"seed": seed, "failed": res.failed,
                          "seconds": time.perf_counter() - t, **readings}),
              flush=True)
        del prep, res
        run._free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
