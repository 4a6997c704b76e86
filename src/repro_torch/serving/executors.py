"""Pluggable serving executors (paper §4.2–§4.3, generalized).

  ``HostExecutor``     exact dynamic-shape sampling on the host (CPU path).
  ``DeviceExecutor``   padded static-shape sampling on the device (GPU
                       path); oversized batches are chunked, never
                       truncated.

Every executor owns ``capacity`` worker lanes (threads) and exposes
``cost(seeds)`` (accumulated PSGS), ``submit(seeds)`` → a
``concurrent.futures.Future`` of the model output, and ``capacity``.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graph.sampler import device_sample, host_sample_dense


def pad_to_bucket(arr: np.ndarray, *, min_size: int = 16,
                  fill: int = -1) -> np.ndarray:
    """Pad a dynamic-size host array up to the next power-of-two bucket, so
    the shapes a model sees stay O(log max_size)."""
    n = max(int(arr.shape[0]), 1)
    size = max(min_size, 1 << (n - 1).bit_length())
    out = np.full((size,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[:arr.shape[0]] = arr  # arr may be empty: pad-only bucket
    return out


def _accumulated_psgs(psgs_table: np.ndarray, seeds: np.ndarray) -> float:
    """Accumulated PSGS of a batch (paper §4.2.2), ``-1`` ignored."""
    seeds = np.asarray(seeds)
    return float(psgs_table[seeds[seeds >= 0]].sum())


@runtime_checkable
class Executor(Protocol):
    """What the router and engine require of an executor.

    Attributes:
        name: registry key used by the router and the engine.
        kind: ``"host"`` | ``"device"`` — selects which latency statistic
            a routing policy judges this executor by.
        capacity: number of concurrent worker lanes (batches in flight).
    """

    name: str
    kind: str
    capacity: int

    def cost(self, seeds: np.ndarray) -> float:
        """Accumulated PSGS of the batch (batch size without a table)."""
        ...

    def submit(self, seeds: np.ndarray) -> Future:
        """Enqueue a batch; the future resolves to ``(B, d_out)``."""
        ...


class BaseExecutor:
    """Shared machinery: worker lanes, PSGS costing, inflight accounting.

    Subclasses implement ``process(seeds)`` returning one output row per
    seed.
    """

    kind = "device"

    def __init__(self, name: str, *, device: str | torch.device = "cuda",
                 capacity: int = 1, psgs_table: Optional[np.ndarray] = None,
                 rng_seed: int = 0, fused: bool = True,
                 fuse_aggregate: bool = False):
        self.name = name
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.psgs_table = psgs_table
        # fused: one cross-hop dedup + one gather (store.lookup_hops)
        # instead of per-hop lookups; same output bits
        self.fused = bool(fused)
        # fuse_aggregate: the store also reduces the innermost hop
        # (store.lookup_aggregate); infer_fn must accept deep_agg=
        self.fuse_aggregate = bool(fuse_aggregate)
        self._pool = ThreadPoolExecutor(max_workers=self.capacity,
                                        thread_name_prefix=f"exec-{name}")
        self._lock = threading.Lock()
        self._inflight = 0
        self._seed_rng = np.random.default_rng(rng_seed)

    def cost(self, seeds: np.ndarray) -> float:
        """Routing signal: accumulated PSGS (or batch size if no table)."""
        seeds = np.asarray(seeds)
        if self.psgs_table is None:
            return float((seeds >= 0).sum())
        return _accumulated_psgs(self.psgs_table, seeds)

    def _child_seed(self) -> int:
        with self._lock:
            return int(self._seed_rng.integers(0, 2**63))

    def _child_rng(self) -> np.random.Generator:
        """A fresh numpy generator per batch (thread-safe across lanes)."""
        return np.random.default_rng(self._child_seed())

    def _next_generator(self) -> torch.Generator:
        """A fresh torch generator on the executor's device per batch."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._child_seed())
        return gen

    @property
    def inflight(self) -> int:
        """Batches submitted and not yet completed."""
        with self._lock:
            return self._inflight

    def process(self, seeds: np.ndarray) -> torch.Tensor:
        """Subclass hook: sample + collect features + infer for one batch.

        Raises:
            NotImplementedError: on the base class.
        """
        raise NotImplementedError

    def _collect(self, store, hops):
        """``(hop_feats, deep_agg)``: ``store.lookup_aggregate`` under
        ``fuse_aggregate`` (``hop_feats`` then omits the innermost hop),
        else ``store.lookup_hops`` (``fused``) or per-hop lookups."""
        if self.fuse_aggregate and len(hops) > 1:
            return store.lookup_aggregate(hops)
        if self.fused:
            return store.lookup_hops(hops), None
        return [store.lookup(h) for h in hops], None

    def _infer(self, store, hops) -> torch.Tensor:
        hop_feats, deep_agg = self._collect(store, hops)
        if deep_agg is not None:
            return self.infer_fn(hop_feats, hops, deep_agg=deep_agg)
        return self.infer_fn(hop_feats, hops)

    def collect_mode(self, store) -> str:
        """The feature-collection path :meth:`_collect` takes:
        ``"fuse_aggregate"``, ``"fused"`` or ``"per_hop"``."""
        if self.fuse_aggregate:
            return "fuse_aggregate"
        return "fused" if self.fused else "per_hop"

    def supports(self, seeds: np.ndarray) -> bool:
        """Eligibility for a batch (routers skip executors returning
        False)."""
        return True

    def stores(self) -> list:
        """The feature store(s) this executor reads."""
        store = getattr(self, "store", None)
        return [store] if store is not None else []

    def run(self, seeds: np.ndarray) -> torch.Tensor:
        """Synchronous path: process, then wait for the device."""
        out = self.process(np.asarray(seeds))
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
        return out

    def submit(self, seeds: np.ndarray) -> Future:
        """Enqueue a batch on a worker lane; resolves to the output of
        :meth:`run`."""
        with self._lock:
            self._inflight += 1
        fut = self._pool.submit(self.run, seeds)
        fut.add_done_callback(self._one_done)
        return fut

    def _one_done(self, _fut: Future) -> None:
        with self._lock:
            self._inflight -= 1

    def warmup(self, seeds: np.ndarray, *, rounds: int = 2) -> None:
        """Run ``rounds`` synchronous passes outside any measured window."""
        for _ in range(rounds):
            self.run(seeds)

    def close(self) -> None:
        """Shut down the worker-lane pool (blocks until lanes drain)."""
        self._pool.shutdown(wait=True)


class HostExecutor(BaseExecutor):
    """Exact host sampling (the 'CPU path') in the dense fan-out layout;
    seeds are bucket-padded. The same ``rng_seed`` draws the same hops as
    the reference's ``HostExecutor``."""

    kind = "host"

    def __init__(self, graph, store, fanouts: Sequence[int],
                 infer_fn: Callable, *, capacity: int = 1,
                 psgs_table: Optional[np.ndarray] = None, rng_seed: int = 0,
                 fused: bool = True, fuse_aggregate: bool = False,
                 name: str = "host"):
        super().__init__(name, device=store.device, capacity=capacity,
                         psgs_table=psgs_table, rng_seed=rng_seed,
                         fused=fused, fuse_aggregate=fuse_aggregate)
        self.graph = graph
        self.store = store
        self.fanouts = tuple(fanouts)
        self.infer_fn = infer_fn

    def process(self, seeds: np.ndarray) -> torch.Tensor:
        """Host sampling → feature collection → inference."""
        n = int(seeds.shape[0])
        seeds_p = pad_to_bucket(np.asarray(seeds).astype(np.int32))
        hops_np = host_sample_dense(self._child_rng(), self.graph, seeds_p,
                                    self.fanouts)
        hops = [torch.from_numpy(h).to(self.device) for h in hops_np]
        return self._infer(self.store, hops)[:n]


class DeviceExecutor(BaseExecutor):
    """Padded on-device pipeline (the 'GPU path'): one static shape
    (``max_batch``); larger batches run in ``max_batch`` chunks and are
    re-concatenated — no seed is dropped."""

    kind = "device"

    def __init__(self, graph_dev: tuple[torch.Tensor, torch.Tensor], store,
                 fanouts: Sequence[int], infer_fn: Callable, *,
                 max_batch: int = 128, capacity: int = 1,
                 psgs_table: Optional[np.ndarray] = None, rng_seed: int = 0,
                 fused: bool = True, fuse_aggregate: bool = False,
                 name: str = "device"):
        super().__init__(name, device=store.device, capacity=capacity,
                         psgs_table=psgs_table, rng_seed=rng_seed,
                         fused=fused, fuse_aggregate=fuse_aggregate)
        self.graph_dev = graph_dev
        self.store = store
        self.fanouts = tuple(fanouts)
        self.infer_fn = infer_fn
        self.max_batch = int(max_batch)

    def process(self, seeds: np.ndarray) -> torch.Tensor:
        """Device sampling → feature collection → inference, chunked at
        ``max_batch``."""
        seeds = np.asarray(seeds)
        n = int(seeds.shape[0])
        outs = []
        for lo in range(0, max(n, 1), self.max_batch):
            chunk = seeds[lo:lo + self.max_batch]
            seeds_p = np.full((self.max_batch,), -1, np.int32)
            seeds_p[:chunk.shape[0]] = chunk
            hops = device_sample(self._next_generator(), *self.graph_dev,
                                 torch.from_numpy(seeds_p).to(self.device),
                                 self.fanouts)
            outs.append(self._infer(self.store, hops)[:chunk.shape[0]])
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
