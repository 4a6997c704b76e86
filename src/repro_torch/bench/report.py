"""The §Dry-run and §Roofline tables from the dry-run's output
(:mod:`repro_torch.launch.dryrun`) — ported from ``benchmarks/report.py``.

    PYTHONPATH=src python -m repro_torch.bench.report \
        [dryrun|roofline|delta|all]

The port counts under ``FakeTensorMode`` (every execution), so its
columns are counted FLOPs and bytes a device, the count's seconds in
place of the compile's, and no loop factor multiplies them.
"""
from __future__ import annotations

import json
import sys

DRYRUN_JSON = "artifacts/dryrun_torch.json"


def load(path: str) -> dict:
    with open(path) as f:
        return {(r["arch"], r["shape"], r["mesh"]): r
                for r in json.load(f) if r.get("ok")}


def dryrun_table(path: str = DRYRUN_JSON) -> str:
    recs = load(path)
    lines = ["| arch | shape | mesh | count s | peak HBM GiB/dev | "
             "counted GFLOP/dev | counted GB/dev† | collective GB/dev‡ | "
             "loop× (recorded) | collectives (ag/ar/rs/a2a/cp) |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(recs.items()):
        c = r["collectives"]["counts"]
        lines.append(
            f"| {a} | {s} | {m} | {r['count_s']:.1f} "
            f"| {r['memory']['peak_hbm_bytes'] / 2**30:.2f} "
            f"| {r['cost']['flops'] / 1e9:.1f} "
            f"| {r['cost']['bytes_accessed'] / 1e9:.1f} "
            f"| {r['collectives']['total_bytes'] / 1e9:.2f} "
            f"| {r.get('loop_factor', 1)} "
            f"| {c['all-gather']}/{c['all-reduce']}/{c['reduce-scatter']}"
            f"/{c['all-to-all']}/{c['collective-permute']} |")
    lines.append("\n† unfused (every op's inputs and outputs). "
                 "‡ modeled from the sharding rules, not parsed.")
    return "\n".join(lines)


def roofline_table(path: str = DRYRUN_JSON) -> str:
    from repro_torch.bench.roofline import model_flops
    recs = load(path)
    lines = ["| arch | shape | mesh | compute ms | memory ms | "
             "collective ms | dominant | step LB ms | model/counted FLOPs |",
             "|---|---|---|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(recs.items()):
        ro = r["roofline"]
        ratio = model_flops(a, s) / r["world"] / max(r["cost"]["flops"], 1.0)
        lines.append(
            f"| {a} | {s} | {m} | {ro['compute_s'] * 1e3:.2f} "
            f"| {ro['memory_s'] * 1e3:.2f} | {ro['collective_s'] * 1e3:.2f} "
            f"| {ro['dominant'].replace('_s', '')} "
            f"| {ro['step_lower_bound_s'] * 1e3:.2f} | {ratio:.2f} |")
    return "\n".join(lines)


def before_after(baseline: str = "artifacts/dryrun_torch_baseline.json",
                 current: str = DRYRUN_JSON) -> str:
    b = load(baseline)
    c = load(current)
    lines = ["| cell | metric | baseline | optimized | Δ |",
             "|---|---|---|---|---|"]
    cells = [("equiformer-v2", "ogb_products", "16x16"),
             ("qwen1.5-4b", "decode_32k", "16x16"),
             ("qwen1.5-4b", "long_500k", "16x16"),
             ("gin-tu", "ogb_products", "16x16"),
             ("qwen3-4b", "decode_32k", "16x16"),
             ("phi3.5-moe-42b", "decode_32k", "16x16")]
    for cell in cells:
        if cell not in b or cell not in c:
            continue
        rb, rc = b[cell], c[cell]
        rows = [
            ("peak HBM GiB/dev", rb["memory"]["peak_hbm_bytes"] / 2**30,
             rc["memory"]["peak_hbm_bytes"] / 2**30),
            ("collective GB/dev", rb["collectives"]["total_bytes"] / 1e9,
             rc["collectives"]["total_bytes"] / 1e9),
            ("memory-term ms", rb["roofline"]["memory_s"] * 1e3,
             rc["roofline"]["memory_s"] * 1e3),
        ]
        for name, vb, vc in rows:
            d = vb / vc if vc > 0 else float("inf")
            lines.append(f"| {cell[0]}×{cell[1]} | {name} | {vb:.2f} "
                         f"| {vc:.2f} | {d:.1f}× |")
    return "\n".join(lines)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "all"
    if which in ("dryrun", "all"):
        print("## Dry-run\n")
        print(dryrun_table())
    if which in ("roofline", "all"):
        print("\n## Roofline\n")
        print(roofline_table())
    if which in ("delta", "all"):
        print("\n## Before/after\n")
        print(before_after())


if __name__ == "__main__":
    main()
