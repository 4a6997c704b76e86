"""Tab. 1: the cost of precomputing the PSGS and FAP tables on the card,
and the table's memory, against graph size; the paper's claim is minutes
for 100M+ nodes on a GPU, through O(K·|E|) sparse passes.

    PYTHONPATH=src python -m repro_torch.bench.run --only metric_cost

Each call includes the COO build on the host and its copy to the card, as
a placement refresh pays them. Beyond the reference's three sizes, one
row at ogbn-products' size (2,449,029 nodes, average degree 25.26) with
the card's peak memory over the FAP call (its ordered segment sum sorts
every edge once a hop).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.bench.common import emit, timeit
from repro_torch.core import compute_fap, compute_psgs
from repro_torch.graph import power_law_graph

# (nodes, average degree): the reference's three sizes, then ogbn-products
SIZES = ((2000, 12.0), (20000, 12.0), (100000, 12.0), (2449029, 25.26))
FANOUTS = (25, 10)


def run(*, sizes=SIZES, device: str | torch.device = "cuda") -> dict:
    """Emit the PSGS and FAP precompute µs, and PSGS µs per edge, at each
    ``(nodes, average degree)`` of ``sizes``."""
    dev = resolve_device(device)
    for n, avg_degree in sizes:
        g = power_law_graph(n, avg_degree, seed=0)
        t_psgs = timeit(lambda: compute_psgs(g, FANOUTS, device=dev),
                        repeats=3, warmup=1, device=dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t_fap = timeit(lambda: compute_fap(g, FANOUTS, device=dev),
                       repeats=3, warmup=1, device=dev)
        peak = ""
        if dev.type == "cuda":
            peak = (f"peak_GB="
                    f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f}")
        emit(f"metric_cost/psgs_us_n{n}", t_psgs * 1e6,
             f"edges={g.num_edges};table_MB={n*4/2**20:.2f}")
        emit(f"metric_cost/fap_us_n{n}", t_fap * 1e6, peak)
        emit(f"metric_cost/psgs_us_per_edge_n{n}",
             t_psgs * 1e6 / g.num_edges, "O(K|E|) check")
    return {"fused_lookups": 0}
