"""Runner of the benchmarks: the paper's tables and figures, the serving
benchmarks of Quiver's own mechanisms, and the two reports of the
dry-run's output (``scalability``, ``roofline``), one module each.

    PYTHONPATH=src python -m repro_torch.bench.run [--only NAME[,NAME...]] \
        [--device cuda|cpu] [--size reference|products] [--json-out PATH]

Prints ``name,us_per_call,derived`` CSV rows; ``--json-out`` also writes
every row and each module's status as JSON (point it at a git-ignored
path, e.g. ``BENCH_figures.json`` or under ``build/``). ``--size
products`` runs ``placement_compare``, ``feature_collection``,
``calibration``, ``skew_robustness`` and ``serve_throughput`` (600
requests, at once and then paced) at ogbn-products' size (2,449,029 nodes,
average degree 25.26, d 100 fp32); the other modules keep the
reference's sizes. Runs on the card unless ``--device cpu``. Exits 1 if
any module failed.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
import traceback

MODULES = [
    "motivation",          # Fig. 2/3 skew
    "metric_cost",         # Tab. 1 metric precompute
    "calibration",         # Fig. 6 PSGS<->latency + crossovers
    "skew_robustness",     # Fig. 13
    "placement_compare",   # Fig. 15
    "feature_collection",  # Fig. 16
    "serve_throughput",    # Fig. 9
    "fused_gather",        # fused feature-collection hot path
    "gather_aggregate",    # fused gather→aggregate layer-1 path
    "prefetch",            # cold-tier staging vs critical-path fetches
    "sharded_hierarchy",   # dedup exchange + per-shard staging/spill
    "flash_crowd",         # device cache vs adaptive-only under drift
    "gateway_soak",        # SLO-aware admission vs FIFO under overload
    "multi_model",         # shared-store registry vs isolated engines
    "policy_cdf",          # Fig. 10
    "workload_drift",      # online adaptation vs frozen placement
    "scalability",         # Fig. 11/12 (from the dry-run's output)
    "roofline",            # roofline report (from the dry-run's output)
]
# the serving benchmarks of Quiver's mechanisms; the two that read the
# dry-run's output (repro_torch.launch.dryrun); the rest are the paper's
# eight tables and figures
SERVING = ("fused_gather", "gather_aggregate", "prefetch", "sharded_hierarchy",
           "flash_crowd", "gateway_soak", "multi_model", "workload_drift")
DRYRUN = ("scalability", "roofline")
FIGURES = [m for m in MODULES if m not in SERVING + DRYRUN]
# ogbn-products (2,449,029 nodes, 61,859,140 edges, 100 fp32 features)
PRODUCTS = dict(nodes=2449029, avg_degree=25.26, d_feat=100)
SIZES = {"reference": {},
         "products": {"placement_compare": PRODUCTS,
                      "feature_collection": PRODUCTS,
                      "calibration": PRODUCTS,
                      "skew_robustness": PRODUCTS,
                      "serve_throughput": {**PRODUCTS, "requests": 600,
                                           "rate": 100.0}}}


def run_modules(names, *, device: str = "cuda",
                size: str = "reference") -> dict:
    """Run each named module's ``run`` at ``size`` on ``device``, catching
    and printing a module's failure so the rest still run. Returns
    ``{name: {"status": "ok" | "failed", "seconds", **run's summary}}``."""
    out = {}
    for name in names:
        t0 = time.time()
        try:
            mod = importlib.import_module(f"repro_torch.bench.{name}")
            summary = mod.run(device=device, **SIZES[size].get(name, {}))
            out[name] = {"status": "ok", **summary}
            print(f"# {name} done in {time.time()-t0:.1f}s", file=sys.stderr,
                  flush=True)
        except Exception:
            out[name] = {"status": "failed"}
            print(f"# {name} FAILED:\n{traceback.format_exc()}",
                  file=sys.stderr, flush=True)
        out[name]["seconds"] = time.time() - t0
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--only", default=None, metavar="NAME[,NAME...]")
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", choices=sorted(SIZES), default="reference")
    p.add_argument("--json-out", default=None, metavar="PATH",
                   help="also write every emitted row + per-module status "
                        "as JSON to PATH")
    args = p.parse_args(argv)
    mods = args.only.split(",") if args.only else MODULES
    unknown = sorted(set(mods) - set(MODULES))
    if unknown:
        p.error(f"unknown module(s) {unknown}; choose from {MODULES}")
    print("name,us_per_call,derived")
    status = run_modules(mods, device=args.device, size=args.size)
    if args.json_out:
        from repro_torch.bench.common import ROWS
        with open(args.json_out, "w") as f:
            json.dump({"modules": {n: s["status"] for n, s in status.items()},
                       "device": args.device, "size": args.size,
                       "rows": [{"name": n, "value": v, "derived": d}
                                for n, v, d in ROWS]}, f, indent=2)
            f.write("\n")
        print(f"# wrote {args.json_out} ({len(ROWS)} rows)", file=sys.stderr)
    if any(s["status"] != "ok" for s in status.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
