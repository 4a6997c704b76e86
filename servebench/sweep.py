"""The knee of an open-loop cell: the stack built once, then the mix at
each offered rate in turn.

    python3 servebench/sweep.py --workload products-sage3.mixed \
        --seed 11 --seconds 51 --rates 16,20,24,28,32

For each rate: p50, p99, the share of requests under 400 ms, how late the
generator ran, and the backlog's growth (the median latency of the last
fifth of the requests over that of the first fifth). A rate holds when
its p99 stays under 400 ms and the backlog grows by at most half; the
sweep stops after the first rate that does not hold. The knee is the
highest rate that holds on every seed swept; a cell runs at about 0.8 of
it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from servebench import loops, run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="servebench/sweep.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("servebench: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(run.ROOT / "src"))
    device = torch.device("cuda", 0)
    spec = run.cell_spec(run.load_json(run.ROOT / "BENCHMARK.json"),
                         args.workload, run.BENCH_DIR)
    traffic = dict(spec["traffic"], check_requests=0)
    prep = run.prepare(spec["cfg"], traffic, args.seed, device)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        res = run.drive(prep, dict(traffic, rate_rps=rate), args.seconds,
                        args.seed + i)
        lat = loops.latencies_ms(res)
        fifth = max(len(lat) // 5, 1)
        late = loops.lateness_ms(res)
        p99 = float(np.quantile(lat, 0.99))
        growth = float(np.median(lat[-fifth:])
                       / max(np.median(lat[:fifth]), 1e-9))
        holds = p99 < 400.0 and growth <= 1.5
        print(json.dumps({
            "rate_rps": rate, "requests": int(lat.size),
            "failed": int(res.failed),
            "p50_ms": float(np.quantile(lat, 0.5)), "p99_ms": p99,
            "pct_in_400ms": float((lat < 400).mean()),
            "backlog_growth": growth, "holds": holds,
            "generator_late_p99_ms": float(np.quantile(late, 0.99)),
            "routed": res.metrics.summary()["routed"]}), flush=True)
        if not holds:
            break
    prep.engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
