"""GNN request types, workload generation and dynamic batching (paper
§4.2.2): numpy port of the reference's ``core/serving.py``.

The batcher closes a batch when (a) the batching deadline expires, (b) the
accumulated PSGS reaches the budget, or (c) the max batch size is hit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.serving.registry import DEFAULT_MODEL

__all__ = ["Request", "WorkloadGenerator", "DynamicBatcher", "batch_seeds",
           "DEFAULT_MODEL", "PRIORITIES"]

# SLO priority classes (gateway admission ordering): interactive traffic
# outranks batch, subject to the gateway's anti-starvation aging bound.
PRIORITIES = ("interactive", "batch")


@dataclasses.dataclass
class Request:
    req_id: int
    seeds: np.ndarray            # (s,) seed node ids
    arrival: float               # seconds (monotonic-clock domain)
    done: Optional[float] = None
    model: str = DEFAULT_MODEL   # registry entry that serves this request
    # SLO fields (gateway traffic): priority class, deadline RELATIVE to
    # arrival (None = no deadline), and the terminal outcome — exactly one
    # of {"completed", "shed_window", "shed_deadline"} once the request
    # leaves the system
    priority: str = "batch"
    deadline_s: Optional[float] = None
    outcome: Optional[str] = None

    @property
    def latency(self) -> float:
        assert self.done is not None
        return self.done - self.arrival


class WorkloadGenerator:
    """Client emulation. Seed nodes are drawn out-degree-weighted by default
    ("representative of real-world serving workloads", paper §6.1); uniform
    and zipf options cover the training-vs-serving distribution-shift
    experiments."""

    def __init__(self, num_nodes: int, out_degree: np.ndarray, *,
                 distribution: str = "degree", zipf_a: float = 1.4,
                 seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.num_nodes = num_nodes
        if distribution == "degree":
            w = out_degree.astype(np.float64) + 1e-6
            self.p = w / w.sum()
        elif distribution == "uniform":
            self.p = None
        elif distribution == "zipf":
            w = 1.0 / np.power(np.arange(1, num_nodes + 1), zipf_a)
            self.p = (w / w.sum())[self.rng.permutation(num_nodes)]
        else:
            raise ValueError(distribution)
        self._next_id = 0

    def set_seed_prob(self, p: Optional[np.ndarray]) -> None:
        """Shift the live seed distribution mid-stream (workload drift
        emulation). ``None`` reverts to uniform; otherwise ``p`` is
        normalized over the node set."""
        if p is None:
            self.p = None
            return
        p = np.asarray(p, dtype=np.float64)
        if p.shape != (self.num_nodes,):
            raise ValueError(f"seed_prob must have shape ({self.num_nodes},)")
        self.p = p / max(p.sum(), 1e-12)

    def make_request(self, seeds_per_request: int = 1, *,
                     model: str = DEFAULT_MODEL, priority: str = "batch",
                     deadline_s: Optional[float] = None) -> Request:
        seeds = self.rng.choice(self.num_nodes, size=seeds_per_request,
                                p=self.p)
        self._next_id += 1
        return Request(self._next_id, seeds.astype(np.int64),
                       time.monotonic(), model=model, priority=priority,
                       deadline_s=deadline_s)

    def stream(self, n: int, seeds_per_request: int = 1, *,
               models: Optional[list[str]] = None,
               priorities: Optional[Sequence[str]] = None,
               deadlines: Optional[Sequence[Optional[float]]] = None
               ) -> Iterator[Request]:
        """Yield ``n`` requests. ``models`` (optional) tags them round-robin
        across the given model names — the interleaved multi-model client
        mix; ``None`` keeps the untagged single-model stream. ``priorities``
        / ``deadlines`` (optional, cycled round-robin in lockstep with the
        request index) tag the SLO class and relative deadline of each
        request — the mixed interactive+batch client mix the gateway
        benchmarks drive."""
        for i in range(n):
            model = models[i % len(models)] if models else DEFAULT_MODEL
            pr = priorities[i % len(priorities)] if priorities else "batch"
            dl = deadlines[i % len(deadlines)] if deadlines else None
            yield self.make_request(seeds_per_request, model=model,
                                    priority=pr, deadline_s=dl)


class DynamicBatcher:
    """Accumulates requests into batches closed by deadline / PSGS budget /
    max size. ``psgs_budget=None`` degenerates to Batchsize-Bound.

    Batches never mix models: ``ServingEngine.serve_stream`` keeps one
    ``clone()`` per model, and ``add`` additionally closes the pending batch
    whenever the incoming request carries a different ``model`` tag
    (defense in depth for callers driving one instance by hand)."""

    def __init__(self, *, deadline_s: float = 0.002,
                 psgs_budget: Optional[float] = None, max_batch: int = 1024,
                 psgs_table: Optional[np.ndarray] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.deadline_s = deadline_s
        self.psgs_budget = psgs_budget
        self.max_batch = max_batch
        self.psgs_table = psgs_table
        # injectable seconds source for the batching deadline (tests pass
        # a fake clock instead of sleeping past deadline_s)
        self.clock = clock
        self._pending: list[Request] = []
        self._opened: Optional[float] = None
        self._model: Optional[str] = None
        self._acc_psgs = 0.0

    def clone(self) -> "DynamicBatcher":
        """Fresh empty batcher with the same bounds — multi-model streams
        need one batcher per model. Built via ``type(self)`` so subclasses
        stay subclasses (override when a subclass adds constructor
        arguments)."""
        return type(self)(deadline_s=self.deadline_s,
                          psgs_budget=self.psgs_budget,
                          max_batch=self.max_batch,
                          psgs_table=self.psgs_table,
                          clock=self.clock)

    def add(self, req: Request) -> Optional[list[Request]]:
        """Add a request; returns a closed batch if a boundary was hit (or
        the previous pending batch when ``req`` carries a different model
        tag — the new request is then queued fresh)."""
        model = getattr(req, "model", DEFAULT_MODEL)
        closed = None
        if self._pending and model != self._model:
            closed = self.flush()
        if self._opened is None:
            self._opened = self.clock()
        self._model = model
        self._pending.append(req)
        if self.psgs_table is not None:
            self._acc_psgs += float(
                self.psgs_table[req.seeds[req.seeds >= 0]].sum())
        if closed is not None:
            # the model boundary already closed a batch this call; the new
            # request's own bounds are evaluated on the next add (or flush)
            return closed
        full = len(self._pending) >= self.max_batch
        over_budget = (self.psgs_budget is not None
                       and self._acc_psgs >= self.psgs_budget)
        expired = self.clock() - self._opened >= self.deadline_s
        if full or over_budget or expired:
            return self.flush()
        return None

    def flush(self) -> Optional[list[Request]]:
        if not self._pending:
            return None
        batch, self._pending = self._pending, []
        self._opened, self._acc_psgs, self._model = None, 0.0, None
        return batch


def batch_seeds(batch: list[Request]) -> np.ndarray:
    return np.concatenate([r.seeds for r in batch])
