"""Pluggable serving executors (paper §4.2–§4.3, generalized).

  ``HostExecutor``     exact dynamic-shape sampling on the host (CPU path).
  ``DeviceExecutor``   padded static-shape sampling on the device (GPU
                       path); oversized batches are chunked, never
                       truncated.
  ``ShardedExecutor``  the distributed path: each mesh shard samples its
                       slice of the seeds, features come from the sharded
                       store's exchange.

Every executor owns ``capacity`` worker lanes (threads) and exposes
``cost(seeds)`` (accumulated PSGS), ``submit(seeds)`` → a
``concurrent.futures.Future`` of the model output, and ``capacity``.
"""
from __future__ import annotations

import threading
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch import resolve_device, trace
from repro_torch.graph.sampler import (device_sample, hop_from_uniform,
                                       host_sample_dense)


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
        ``fuse_aggregate`` where the store has it (``hop_feats`` then omits
        the innermost hop), else ``store.lookup_hops`` (``fused``) or
        per-hop lookups."""
        if (self.fuse_aggregate and len(hops) > 1
                and hasattr(store, "lookup_aggregate")):
            return store.lookup_aggregate(hops)
        if self.fused and hasattr(store, "lookup_hops"):
            return store.lookup_hops(hops), None
        return [store.lookup(h) for h in hops], None

    def _infer(self, store, hops) -> torch.Tensor:
        hop_feats, deep_agg = self._collect(store, hops)
        with trace.span("model"):
            if deep_agg is not None:
                return self.infer_fn(hop_feats, hops, deep_agg=deep_agg)
            return self.infer_fn(hop_feats, hops)

    def collect_mode(self, store) -> str:
        """The feature-collection path :meth:`_collect` takes for ``store``
        on a multi-hop sample: ``"fuse_aggregate"``, ``"fused"`` or
        ``"per_hop"`` (a flag the store cannot honour is downgraded)."""
        if self.fuse_aggregate and hasattr(store, "lookup_aggregate"):
            return "fuse_aggregate"
        if self.fused and hasattr(store, "lookup_hops"):
            return "fused"
        return "per_hop"

    def supports(self, seeds: np.ndarray) -> bool:
        """Eligibility for a batch (routers skip executors returning
        False)."""
        return True

    def stores(self) -> list:
        """The feature store(s) this executor reads (the engine reports
        their dispatch counters)."""
        return [s for s in (getattr(self, "store", None),
                            getattr(self, "sstore", None)) if s is not None]

    def run(self, seeds: np.ndarray) -> torch.Tensor:
        """Synchronous path: process, then wait for the device."""
        out = self.process(np.asarray(seeds))
        if out.is_cuda:
            with trace.span("sync"):
                torch.cuda.current_stream(out.device).synchronize()
        return out

    def submit(self, seeds: np.ndarray) -> Future:
        """Enqueue a batch on a worker lane; resolves to the output of
        :meth:`run`. Traced, the lane records how long the batch waited
        for it (``lane_wait``) and its whole run (``lane``)."""
        with self._lock:
            self._inflight += 1
        if trace.on:
            fut = self._pool.submit(self._lane, seeds,
                                    time.perf_counter_ns(), trace.batch())
        else:
            fut = self._pool.submit(self.run, seeds)
        fut.add_done_callback(self._one_done)
        return fut

    def _lane(self, seeds: np.ndarray, t_submit: int,
              batch: Optional[int]) -> torch.Tensor:
        trace.record("lane_wait", t_submit, executor=self.name, batch=batch)
        with trace.span("lane", cpu=True, executor=self.name, batch=batch):
            return self.run(seeds)

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
        rng = self._child_rng()
        with trace.span("host_sample"):
            hops_np = host_sample_dense(rng, self.graph, seeds_p,
                                        self.fanouts)
        with trace.span("hops_to_device"):
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
            gen = self._next_generator()
            seeds_t = torch.from_numpy(seeds_p).to(self.device)
            with trace.span("device_sample"):
                hops = device_sample(gen, *self.graph_dev, seeds_t,
                                     self.fanouts)
            outs.append(self._infer(self.store, hops)[:chunk.shape[0]])
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _shard_seed(child: int, shard: int) -> int:
    """The sampling seed of one shard: the batch's child seed folded with
    the shard index (the counterpart of ``fold_in(key, axis_index)``)."""
    return int(np.random.SeedSequence([child, shard])
               .generate_state(1, np.uint64)[0])


class ShardedExecutor(BaseExecutor):
    """Distributed serving path over a mesh axis.

    Each shard samples its contiguous slice of the (mesh-padded) seed
    vector against the replicated CSR, from its own ``torch.Generator``
    (the batch's child seed folded with the shard index); the shards of one
    device are sampled together, each from its own draws. Features come
    from the sharded store's fused ``lookup_hops`` (by default the
    owner-sorted dedup exchange of paper §5.3); a store built with
    ``ShardedFeatureStore.from_tiered`` resolves HOST/DISK rows exactly.
    A directly constructed store reads cold ids as zeros: pass
    ``tier_table`` (the placement's per-node tiers) there, so
    :meth:`supports` declares cold-seed batches ineligible and the router
    keeps them elsewhere.

    The sharded store serves whole rows only, so ``fuse_aggregate=True``
    warns once and falls back to ``lookup_hops``; :meth:`collect_mode`
    reports the mode taken. ``max_batch`` is rounded up to a multiple of
    the mesh world size so every shard's slice has one static size.
    """

    kind = "device"
    _warned_fuse_aggregate = False

    def __init__(self, mesh, axis_name: str,
                 graph_dev: tuple[torch.Tensor, torch.Tensor],
                 sharded_store, fanouts: Sequence[int], infer_fn: Callable,
                 *, max_batch: int = 128, capacity: int = 1,
                 psgs_table: Optional[np.ndarray] = None,
                 tier_table: Optional[np.ndarray] = None, rng_seed: int = 0,
                 fused: bool = True, fuse_aggregate: bool = False,
                 name: str = "sharded"):
        super().__init__(name, device=sharded_store.device,
                         capacity=capacity, psgs_table=psgs_table,
                         rng_seed=rng_seed, fused=fused,
                         fuse_aggregate=fuse_aggregate)
        if fuse_aggregate and not hasattr(sharded_store, "lookup_aggregate"):
            self._warn_fuse_aggregate_downgrade()
        self.tier_table = tier_table
        self.mesh = mesh
        self.axis = axis_name
        self.sstore = sharded_store
        self.world = int(sharded_store.world)
        self.max_batch = -(-int(max_batch) // self.world) * self.world
        self.fanouts = tuple(fanouts)
        self.infer_fn = infer_fn
        # (device, shards, replicated (indptr, indices)) per mesh device
        self._groups = [(dev, shards, tuple(a.to(dev) for a in graph_dev))
                        for dev, shards in mesh.groups()]

    @classmethod
    def _warn_fuse_aggregate_downgrade(cls) -> None:
        if cls._warned_fuse_aggregate:
            return
        cls._warned_fuse_aggregate = True
        warnings.warn(
            "ShardedExecutor: fuse_aggregate=True has no effect — the "
            "sharded store serves whole rows only (no lookup_aggregate); "
            "falling back to the fused lookup_hops path. The active mode "
            "is reported as collect_mode in "
            "ServeMetrics.summary()['store'].", RuntimeWarning, stacklevel=3)

    def supports(self, seeds: np.ndarray) -> bool:
        """Eligible only when every valid seed lives on a device tier
        (HOT/WARM), where ``tier_table`` is set; always ``True``
        without it (stores built with ``from_tiered`` are exact for
        every id)."""
        if self.tier_table is None:
            return True
        seeds = np.asarray(seeds)
        seeds = seeds[seeds >= 0]
        return bool((self.tier_table[seeds] <= 1).all())

    def sample(self, seeds_p: np.ndarray, child: int) -> list[torch.Tensor]:
        """The hops of one mesh-padded seed vector on the store's device:
        shard ``w`` samples ``seeds_p[w*m:(w+1)*m]`` from a generator
        seeded with ``_shard_seed(child, w)``, and hop ``k`` is the shards'
        hops ``k`` in shard order."""
        m = seeds_p.shape[0] // self.world
        per_shard: dict[int, list[torch.Tensor]] = {}
        for dev, shards, (indptr, indices) in self._groups:
            gens = [torch.Generator(device=dev).manual_seed(
                _shard_seed(child, s)) for s in shards]
            frontier = torch.from_numpy(np.concatenate(
                [seeds_p[s * m:(s + 1) * m] for s in shards])).to(dev)
            hops = [frontier]
            rows = m
            for fan in self.fanouts:
                u = torch.cat([torch.rand((rows, fan), generator=gen,
                                          device=dev) for gen in gens])
                frontier = hop_from_uniform(u, indptr, indices, frontier,
                                            fan)
                hops.append(frontier)
                rows *= fan
            for i, s in enumerate(shards):
                per_shard[s] = [h.view(len(shards), -1)[i] for h in hops]
        if len(self._groups) == 1:
            return hops
        return [torch.cat([per_shard[s][k].to(self.device)
                           for s in range(self.world)])
                for k in range(len(self.fanouts) + 1)]

    def process(self, seeds: np.ndarray) -> torch.Tensor:
        """Per-shard sampling → sharded feature reads → inference, chunked
        at the mesh-padded ``max_batch``; one output row per seed."""
        seeds = np.asarray(seeds)
        n = int(seeds.shape[0])
        outs = []
        for lo in range(0, max(n, 1), self.max_batch):
            chunk = seeds[lo:lo + self.max_batch]
            seeds_p = np.full((self.max_batch,), -1, np.int32)
            seeds_p[:chunk.shape[0]] = chunk
            hops = self.sample(seeds_p, self._child_seed())
            outs.append(self._infer(self.sstore, hops)[:chunk.shape[0]])
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
