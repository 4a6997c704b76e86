"""Fig. 11/12 analogue: steps a second from 1 to 512 cards, derived from
the dry-run's counts (:mod:`repro_torch.launch.dryrun`) — ported from
``benchmarks/scalability.py``. No cluster is timed: the model is
``step ≥ max(compute, memory, collective)``, compute and memory split
evenly over the cards, the collective bytes scaled from the 256-card
record by the ring factor and divided by the rate of a group that size
(``hlo_analysis.collective_bw``: NVLink within an 8-card node, the
network beyond).

    PYTHONPATH=src python -m repro_torch.bench.run --only scalability

The port's counts are per executed step already, so nothing is
multiplied by ``loop_factor`` (the reference multiplies its XLA counts).
Prints a ``scalability/skipped`` row when the JSON is missing.
"""
from __future__ import annotations

import json
import os

import torch

from repro_torch.bench.common import emit
from repro_torch.launch.hlo_analysis import HBM_BW, PEAK_FLOPS, collective_bw

DRYRUN_JSON = "artifacts/dryrun_torch.json"
CELLS = [("gin-tu", "ogb_products", "graph-serving GNN"),
         ("qwen1.5-4b", "train_4k", "dense LM train"),
         ("deepseek-moe-16b", "train_4k", "MoE LM train")]
CHIPS = (1, 8, 64, 256, 512)


def run(path: str = DRYRUN_JSON, device: str = "cuda") -> dict:
    """One row a cell and card count. ``device`` is the runner's and
    unused: this module reads a file."""
    if not os.path.exists(path):
        print(f"scalability/skipped,0,{path} missing - run dryrun first")
        return {"skipped": True}
    with open(path) as f:
        recs = {(r["arch"], r["shape"], r["world"]): r
                for r in json.load(f) if r["ok"]}
    rows = 0
    for arch, shape, tag in CELLS:
        base = recs.get((arch, shape, 256))
        if base is None:
            continue
        peak = PEAK_FLOPS[getattr(torch, base["dtype"])]
        g_flops = base["cost"]["flops"] * 256
        g_bytes = base["cost"]["bytes_accessed"] * 256
        coll_per_dev = base["collectives"]["total_bytes"]
        for chips in CHIPS:
            compute = g_flops / chips / peak
            memory = g_bytes / chips / HBM_BW
            ring = (chips - 1) / chips if chips > 1 else 0.0
            coll = (coll_per_dev * (256 / chips) * (ring / (255 / 256))
                    / collective_bw(chips))
            step = max(compute, memory, coll)
            bound = ("coll" if coll == step
                     else "mem" if memory == step else "comp")
            emit(f"scalability/{arch}_{shape}_c{chips}_steps_per_s",
                 1.0 / step, f"{tag};bound={bound}")
            rows += 1
    return {"rows": rows}


if __name__ == "__main__":
    run()
