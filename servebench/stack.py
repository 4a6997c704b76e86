"""The system under test: the port's single-host serving stack, built as
its serve launcher builds it (``launch/serve.py``: ``build_executors``, a
calibrated ``CostModelRouter``, ``ServingEngine``), over the graph,
features and weights the benchmark drew, serving the configuration's
architecture (``servebench/archs/<arch>.py``).

:class:`Capture` wraps the executors' ``run`` and the model's
``infer_fn`` so that, for the requests the check samples, what the timed
path produced is kept: every hop's ids and a sample of the collected
feature rows (and of the innermost sums under ``lookup_aggregate``); the
served output is the request's own result. Requests outside the sample
pay one dictionary lookup.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import numpy as np
import torch

from servebench.inputs import Graph

# feature rows the check samples per hop and per call
CHECK_ROWS = 1024


@dataclasses.dataclass
class Record:
    """One ``infer_fn`` call of a checked request, on the host."""

    hops: list            # per hop (M_k,) int32 ids, -1 padded
    feat_pos: list        # per collected hop, sampled row positions
    feat_rows: list       # per collected hop, the rows at those positions
    agg_pos: object       # sampled innermost parents (lookup_aggregate)
    agg_rows: object      # the innermost sums at those parents


class Capture:
    """Keeps what the timed path produced for the sampled requests."""

    def __init__(self, seed: int):
        self._tl = threading.local()
        self._lock = threading.Lock()
        self._want: set = set()
        self._got: dict = {}
        self._gen = torch.Generator().manual_seed(seed)

    def want(self, seeds: np.ndarray) -> None:
        """Capture the request whose seed array is ``seeds``."""
        with self._lock:
            self._want.add(np.asarray(seeds, np.int64).tobytes())

    def wrap_run(self, executor) -> None:
        """Route ``executor.run`` (what its lanes call) through the
        capture."""
        run = executor.run

        def captured_run(seeds):
            key = np.asarray(seeds, np.int64).tobytes()
            with self._lock:
                wanted = key in self._want
            if not wanted:
                return run(seeds)
            self._tl.calls = []
            try:
                out = run(seeds)
            finally:
                calls, self._tl.calls = self._tl.calls, None
            with self._lock:
                self._got[id(out)] = (out, calls)
            return out

        executor.run = captured_run

    def wrap_infer(self, infer: Callable) -> Callable:
        """``infer_fn`` that records its inputs and output while a captured
        ``run`` is on this thread."""

        def infer_fn(hop_feats, hop_ids, deep_agg=None):
            if deep_agg is None:
                out = infer(hop_feats, hop_ids)
            else:
                out = infer(hop_feats, hop_ids, deep_agg=deep_agg)
            calls = getattr(self._tl, "calls", None)
            if calls is not None:
                calls.append(self._record(hop_feats, hop_ids, deep_agg))
            return out

        return infer_fn

    def _positions(self, n: int, device) -> torch.Tensor:
        with self._lock:
            pos = torch.randint(0, max(n, 1), (min(CHECK_ROWS, n),),
                                generator=self._gen)
        return pos.to(device)

    def _record(self, hop_feats, hop_ids, deep_agg) -> tuple:
        fpos = [self._positions(f.shape[0], f.device) for f in hop_feats]
        frows = [f.index_select(0, p) for f, p in zip(hop_feats, fpos)]
        apos = arows = None
        if deep_agg is not None:
            apos = self._positions(deep_agg.shape[0], deep_agg.device)
            arows = deep_agg.index_select(0, apos)
        return (list(hop_ids), fpos, frows, apos, arows)

    def take(self, result) -> list | None:
        """The records of a captured request's served result, moved to the
        host, or ``None``."""
        with self._lock:
            got = self._got.pop(id(result), None)
        if got is None:
            return None
        cpu = (lambda t: None if t is None else t.detach().cpu())
        return [Record(hops=[cpu(h) for h in c[0]],
                       feat_pos=[cpu(p) for p in c[1]],
                       feat_rows=[cpu(r) for r in c[2]],
                       agg_pos=cpu(c[3]), agg_rows=cpu(c[4]))
                for c in got[1]]


def warm_lanes(executors: dict, batches: list) -> None:
    """Run every batch on every executor's lanes, as many at once as it
    has lanes, so that each lane thread has made its own first calls
    (a thread's first matrix product creates its cuBLAS handle) before
    the window. Calibration runs the executors on the calling thread
    only."""
    for ex in executors.values():
        for b in batches:
            for fut in [ex.submit(b) for _ in range(ex.capacity)]:
                fut.result()


def seed_prob(graph: Graph) -> np.ndarray:
    """The serving workload's seed law as a probability vector (what the
    launcher hands FAP)."""
    w = graph.out_degree.astype(np.float64) + 1e-6
    return w / w.sum()


def build(cfg: dict, arch, graph: Graph, feats: np.ndarray, weights: dict,
          cal_batches: list, capture: Capture, device: torch.device, *,
          phase: Callable[[str], None] = lambda name: None):
    """PSGS and FAP on ``device``, Quiver's placement over the
    configuration's topology, the tiered store, ``arch``'s ``infer_fn``
    over ``weights``, the launcher's host and device executors, the router
    calibrated on ``cal_batches``; returns the ``ServingEngine``."""
    from repro_torch.core import (TieredFeatureStore, TopologySpec,
                                  compute_fap, compute_psgs, quiver_placement)
    from repro_torch.graph import CSRGraph
    from repro_torch.launch.serve import build_executors
    from repro_torch.serving import (CostModelRouter, ServingEngine,
                                     calibrate_executors)

    g = CSRGraph(indptr=graph.indptr, indices=graph.indices,
                 num_nodes=graph.num_nodes)
    fanouts = tuple(cfg["fanouts"])
    topo_cfg, ex_cfg = cfg["topology"], cfg["executor"]
    psgs = compute_psgs(g, fanouts, device=device)
    phase("psgs")
    fap = compute_fap(g, fanouts, seed_prob=seed_prob(graph), device=device)
    phase("fap")
    topo = TopologySpec(num_pods=1, devices_per_pod=1,
                        rows_per_device=int(topo_cfg["rows_per_device"]),
                        rows_host=int(topo_cfg["rows_host"]),
                        hot_replicate_fraction=float(topo_cfg["hot_frac"]))
    store = TieredFeatureStore.build(feats, quiver_placement(fap, topo),
                                     device=device)
    phase("placement and store")
    infer = capture.wrap_infer(arch.infer_fn(cfg, weights, device))
    executors = build_executors(
        g, store, fanouts, infer, psgs, num_workers=int(ex_cfg["lanes"]),
        max_batch=int(ex_cfg["max_batch"]), fused=True,
        fuse_aggregate=cfg["collect"] == "lookup_aggregate")
    for ex in executors.values():
        capture.wrap_run(ex)
    try:
        # four timed calls a batch and executor, so that one slow call
        # moves the fitted crossover less from run to run
        curves = calibrate_executors(executors, cal_batches, psgs, repeats=4)
    except BaseException:
        for ex in executors.values():
            ex.close()
        raise
    phase(f"calibration over {len(cal_batches)} batches")
    warm_lanes(executors, cal_batches)
    phase("lanes warmed")
    router = CostModelRouter.from_curves(psgs, curves, ex_cfg["policy"],
                                         executors=executors)
    return ServingEngine(executors, router,
                         max_inflight=int(ex_cfg["max_inflight"]),
                         admission=ex_cfg["admission"])
