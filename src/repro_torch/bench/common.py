"""Shared harness of the paper-figure benchmarks (``repro_torch.bench.run``):
the row sink, the timer, the serving stack the figures share, and the
tier bandwidths their cost models divide by.

Functions that build device state (:func:`timeit`,
:func:`build_serving_stack`, :func:`tier_bandwidths`) take ``device=`` and
default to ``"cuda"``; asking for the card where there is none raises
(:func:`repro_torch.resolve_device`). The functions over a built stack
(:func:`make_executors`, :func:`make_engine`, :func:`make_model_infer_fn`)
follow its store's device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (TieredFeatureStore, TopologySpec,
                              WorkloadGenerator, compute_fap, compute_psgs,
                              quiver_placement)
from repro_torch.core.placement import (TIER_DISK, TIER_HOST, TIER_HOT,
                                        TIER_WARM)
from repro_torch.graph import power_law_graph
from repro_torch.kernels.build import int_bits
from repro_torch.launch import serve as launcher
from repro_torch.serving import DeviceExecutor, HostExecutor, ServingEngine

ROWS: list[tuple] = []

# tier_bandwidths' transfer sizes on the card; on the CPU every tier is a
# host copy and CPU_COPY_BYTES is enough to time one
HBM_COPY_BYTES = 1 << 30
HOST_COPY_BYTES = 256 << 20
DISK_READ_BYTES = 256 << 20
CPU_COPY_BYTES = 16 << 20
# NVLink 4 on the H100 SXM: 900 GB/s over both directions, 450 GB/s one
# way (NVIDIA's H100 data sheet). A WARM row on a peer card crosses it
# one way.
NVLINK4_GBPS_PER_DIRECTION = 450.0


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    """Record one ``name,value,derived`` row and print it."""
    ROWS.append((name, us_per_call, derived))
    print(f"{name},{us_per_call:.2f},{derived}", flush=True)


def write_bench_json(name: str, payload: dict, out_dir: str | None = None
                     ) -> str:
    """Write ``payload`` to ``BENCH_<name>.json`` (git-ignored) in
    ``out_dir``, ``$BENCH_JSON_DIR`` or the current directory; returns
    the path."""
    out_dir = out_dir or os.environ.get("BENCH_JSON_DIR", ".")
    path = os.path.join(out_dir, f"BENCH_{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def latency_percentiles(metrics) -> dict:
    """p50/p95/p99 (ms) of a ``ServeMetrics``' raw latency samples."""
    lat = np.asarray(metrics.latencies if metrics.latencies else [0.0])
    return {f"p{int(q * 100)}_ms": float(np.quantile(lat, q) * 1e3)
            for q in (0.5, 0.95, 0.99)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(fn: Callable, *args, repeats: int = 5, warmup: int = 2,
           device: str | torch.device = "cuda") -> float:
    """Median wall time of ``fn(*args)`` in seconds. On the card each
    clock read follows a ``torch.cuda.synchronize``, so the time covers
    the kernels ``fn`` queued, not only their issue."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn(*args)
    _sync(dev)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def build_serving_stack(*, nodes: int = 6000, avg_degree: float = 10.0,
                        d_feat: int = 64, fanouts=(6, 4), seed: int = 0,
                        hot_frac: float = 0.25, rows_frac: float = 0.25,
                        distribution: str = "degree",
                        spill_path: str | None = None,
                        device: str | torch.device = "cuda") -> dict:
    """The skewed end-to-end stack the serving benchmarks share, drawn from
    ``seed`` as the reference harness draws it: power-law graph, features,
    PSGS and FAP (on ``device``), a one-device topology, the Quiver
    placement and its tiered store, and GraphSAGE 64-64 (weights from a
    ``torch.Generator`` seeded with ``seed``). ``spill_path`` backs the
    DISK tier with a spill file."""
    dev = resolve_device(device)
    graph = power_law_graph(nodes, avg_degree, seed=seed)
    rng = np.random.default_rng(seed + 1)
    feats = rng.normal(size=(nodes, d_feat)).astype(np.float32)
    psgs = compute_psgs(graph, fanouts, device=dev)
    gen = WorkloadGenerator(nodes, graph.out_degree,
                            distribution=distribution, seed=seed + 2)
    fap = compute_fap(graph, fanouts, seed_prob=gen.p, device=dev)
    topo = TopologySpec(num_pods=1, devices_per_pod=1,
                        rows_per_device=max(int(nodes * rows_frac), 64),
                        rows_host=max(int(nodes * 0.4), 64),
                        hot_replicate_fraction=hot_frac)
    store = TieredFeatureStore.build(feats, quiver_placement(fap, topo),
                                     spill_path=spill_path, device=dev)
    infer_fn = launcher.make_model_infer_fn(d_feat, (64, 64), fanouts,
                                            seed=seed, device=dev)
    return dict(graph=graph, feats=feats, psgs=psgs, fap=fap, gen=gen,
                store=store, infer_fn=infer_fn, fanouts=tuple(fanouts),
                topo=topo)


def make_model_infer_fn(stack, hidden: tuple[int, ...] = (64, 64), *,
                        seed: int = 0):
    """Another GraphSAGE ``infer_fn`` over the stack's fanouts, on its
    store's device (the launcher's own function, so the two stay one
    definition)."""
    return launcher.make_model_infer_fn(
        stack["feats"].shape[1], tuple(hidden), stack["fanouts"], seed=seed,
        device=stack["store"].device)


def store_bytes(store) -> int:
    """Resident bytes of a tiered store's feature rows over all tiers; a
    spill-backed DISK tier counts only its RAM overlay."""
    total = int(store.hot.nelement() * store.hot.element_size()
                + store.warm.nelement() * store.warm.element_size()
                + store.host.nbytes)
    resident = getattr(store.disk, "resident_nbytes", None)
    return total + int(resident if resident is not None
                       else np.asarray(store.disk).nbytes)


def make_executors(stack, *, num_workers: int = 2, max_batch: int = 128,
                   fused: bool = True, fuse_aggregate: bool = False,
                   infer_fn=None, store=None, rng_seed: int = 0) -> dict:
    """Host + device executor pair over a built stack, on its store's
    device. ``fused=False`` takes the per-hop lookups, ``fuse_aggregate``
    the gather→aggregate path (``store.lookup_aggregate``); ``infer_fn``
    and ``store`` override the stack's (one pair a model over a shared or
    copied store)."""
    g = stack["graph"]
    infer_fn = infer_fn if infer_fn is not None else stack["infer_fn"]
    store = store if store is not None else stack["store"]
    flags = dict(capacity=num_workers, psgs_table=stack["psgs"],
                 fused=fused, fuse_aggregate=fuse_aggregate,
                 rng_seed=rng_seed)
    host = HostExecutor(g, store, stack["fanouts"], infer_fn, **flags)
    device = DeviceExecutor(g.device_arrays(store.device), store,
                            stack["fanouts"], infer_fn, max_batch=max_batch,
                            **flags)
    return {"host": host, "device": device}


def make_engine(stack, router, *, num_workers: int = 2, max_batch: int = 128,
                fused: bool = True,
                fuse_aggregate: bool = False) -> ServingEngine:
    """A serving engine over :func:`make_executors`' pair and ``router``."""
    return ServingEngine(make_executors(stack, num_workers=num_workers,
                                        max_batch=max_batch, fused=fused,
                                        fuse_aggregate=fuse_aggregate),
                         router)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (compared as integers, so -0.0 is not
    +0.0)."""
    return a.dtype == b.dtype and torch.equal(int_bits(a), int_bits(b))


def fused_lookups(*stores) -> int:
    """``lookup_hops`` calls the stores have served: with no device cache
    attached each launched ``tiered_gather`` exactly once on the card."""
    return sum(int(s.stats["fused_calls"]) for s in stores)


# ---------------------------------------------------------------------------
# tier bandwidths
# ---------------------------------------------------------------------------
def card_name(device: str | torch.device = "cuda") -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    ``"cpu"`` on the CPU."""
    if resolve_device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _copy_seconds(dst: torch.Tensor, src: torch.Tensor, *, reps: int,
                  devices: tuple[torch.device, ...]) -> float:
    """Median seconds of ``dst.copy_(src)``: a warm-up copy, then ``reps``
    copies each between synchronizes of every device involved."""
    def sync():
        for d in devices:
            _sync(d)

    dst.copy_(src, non_blocking=True)
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        sync()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _entry(nbytes: int, seconds: float, source: str, how: str) -> dict:
    return {"GBps": nbytes / seconds / 1e9, "source": source, "how": how}


def _disk_read(nbytes: int) -> tuple[float, float]:
    """Seconds to read an ``nbytes`` ``np.memmap`` spill file into RAM:
    first after ``fsync`` and ``POSIX_FADV_DONTNEED`` (an advisory
    eviction of its pages from the page cache), then again with its pages
    cached."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tier.spill")
        n = nbytes // 4
        mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(n,))
        mm[:] = np.arange(n, dtype=np.float32)
        mm.flush()
        del mm
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
        times = []
        for _ in range(2):
            mm = np.memmap(path, dtype=np.float32, mode="r", shape=(n,))
            t0 = time.perf_counter()
            rows = np.array(mm)
            times.append(time.perf_counter() - t0)
            del mm, rows
    return times[0], times[1]


def tier_bandwidths(device: str | torch.device = "cuda") -> dict:
    """Rates (GB/s of rows delivered) of the four tiers of Quiver's GPU
    topology, measured in this run where the machine allows it:

    * ``hbm``  (HOT, local device memory): a device-to-device copy of 1 GiB
      (the copy reads and writes: twice the bytes cross HBM);
    * ``warm`` (WARM, a peer card over NVLink): a peer copy card 0 → card 1
      of 256 MiB with two cards; on one card the H100 SXM's published
      NVLink 4 rate a direction, ``"source": "spec"``;
    * ``host`` (HOST, pinned host memory over PCIe): a pinned host-to-
      device copy of 256 MiB; ``host_pageable`` the same from pageable
      memory;
    * ``disk`` (DISK, the spill file): a 256 MiB ``np.memmap`` read into
      RAM after an advisory page-cache drop; ``disk_warm`` the read again
      with its pages cached.

    Each entry is ``{"GBps", "source", "how"}``; ``card`` is ``nvidia-smi``'s
    name and power limit. ``source`` is ``"measured"`` (this run, on the
    card), ``"spec"`` (a published rate) or ``"cpu"``: on the CPU every
    tier but ``disk`` is one measured host copy of 16 MiB.
    """
    dev = resolve_device(device)
    out = {"card": card_name(dev), "device": str(dev)}
    if dev.type == "cuda":
        src = torch.empty(HBM_COPY_BYTES, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        out["hbm"] = _entry(HBM_COPY_BYTES, _copy_seconds(
            dst, src, reps=10, devices=(dev,)), "measured",
            "device-to-device copy of 1 GiB")
        del src, dst
        dst = torch.empty(HOST_COPY_BYTES, dtype=torch.uint8, device=dev)
        for key, pinned in (("host", True), ("host_pageable", False)):
            src = torch.empty(HOST_COPY_BYTES, dtype=torch.uint8,
                              pin_memory=pinned)
            src.fill_(1)
            out[key] = _entry(HOST_COPY_BYTES, _copy_seconds(
                dst, src, reps=5, devices=(dev,)), "measured",
                f"{'pinned' if pinned else 'pageable'} host-to-device "
                "copy of 256 MiB")
        if torch.cuda.device_count() >= 2:
            peer = torch.device("cuda", 1 if dev.index in (None, 0) else 0)
            pdst = torch.empty(HOST_COPY_BYTES, dtype=torch.uint8,
                               device=peer)
            p2p = torch.cuda.can_device_access_peer(dst.device.index or 0,
                                                    peer.index)
            out["warm"] = _entry(HOST_COPY_BYTES, _copy_seconds(
                pdst, dst, reps=5, devices=(dev, peer)), "measured",
                f"peer copy {dev} → {peer} of 256 MiB (peer access "
                f"{'on' if p2p else 'off'})")
            del pdst
        else:
            out["warm"] = {"GBps": NVLINK4_GBPS_PER_DIRECTION,
                           "source": "spec",
                           "how": "one card: H100 SXM NVLink 4, 450 GB/s "
                                  "a direction (data sheet)"}
        del dst
        disk_bytes = DISK_READ_BYTES
    else:
        src = torch.ones(CPU_COPY_BYTES, dtype=torch.uint8)
        dst = torch.empty_like(src)
        secs = _copy_seconds(dst, src, reps=5, devices=(dev,))
        for key in ("hbm", "warm", "host", "host_pageable"):
            out[key] = _entry(CPU_COPY_BYTES, secs, "cpu",
                              "measured host copy of 16 MiB (no card)")
        disk_bytes = CPU_COPY_BYTES
    first, again = _disk_read(disk_bytes)
    mib = disk_bytes >> 20
    out["disk"] = _entry(disk_bytes, first, "measured",
                         f"np.memmap read of {mib} MiB after fsync and "
                         "POSIX_FADV_DONTNEED (advisory; eviction not "
                         "verified)")
    out["disk_warm"] = _entry(disk_bytes, again, "measured",
                              f"np.memmap read of {mib} MiB, page cache "
                              "warm")
    return out


def tier_rates(bw: dict) -> dict[int, float]:
    """Bytes/s a row of each tier reaches the model at, from
    :func:`tier_bandwidths`: HOT at the HBM copy rate, WARM at the peer
    rate, HOST at the pinned rate, DISK read from the spill file and then
    sent over PCIe (the two rates in series)."""
    rate = {k: bw[k]["GBps"] * 1e9 for k in ("hbm", "warm", "host", "disk")}
    return {TIER_HOT: rate["hbm"], TIER_WARM: rate["warm"],
            TIER_HOST: rate["host"],
            TIER_DISK: 1.0 / (1.0 / rate["disk"] + 1.0 / rate["host"])}


def bandwidth_sources(bw: dict) -> str:
    """``tier=source`` for the four tiers, for a modeled row's derived
    field."""
    return ",".join(f"{k}={bw[k]['source']}"
                    for k in ("hbm", "warm", "host", "disk"))


def format_bandwidths(bw: dict) -> str:
    """:func:`tier_bandwidths`' table, one line a tier, under the card's
    name and power limit."""
    lines = [f"tier bandwidths ({bw['card']}; {bw['device']}):"]
    for k in ("hbm", "warm", "host", "host_pageable", "disk", "disk_warm"):
        e = bw[k]
        lines.append(f"  {k:14s} {e['GBps']:12.3f} GB/s  {e['source']}: "
                     f"{e['how']}")
    return "\n".join(lines)


def close_executors(executors: dict) -> None:
    """Shut down every executor's worker lanes."""
    for ex in executors.values():
        ex.close()



def check_lookups(store, feats: np.ndarray, ids: np.ndarray) -> int:
    """Hold a store's reads of ``ids`` to the features indexed on the
    host, bit for bit: ``lookup`` and ``lookup_hops`` without host rows
    (HOST/DISK rows read as zeros) and ``lookup`` with them. Raises
    AssertionError on a difference; returns the ids checked."""
    ids = np.asarray(ids, dtype=np.int32)
    safe = np.maximum(ids, 0)
    want = np.where((ids >= 0)[:, None], feats[safe], np.float32(0))
    want_dev = np.where((store.plan.tier[safe] < TIER_HOST)[:, None], want,
                        np.float32(0))
    reads = (("lookup(include_host=False)", want_dev,
              store.lookup(ids, include_host=False)),
             ("lookup_hops(include_host=False)", want_dev,
              store.lookup_hops([ids], include_host=False)[0]),
             ("lookup", want, store.lookup(ids)))
    for what, exp, got in reads:
        got = got.cpu().numpy()
        assert got.dtype == exp.dtype and np.array_equal(
            got.view(np.int32), exp.view(np.int32)), (
            f"{store.plan.name}: {what} differs from the features in "
            f"{int((got != exp).any(axis=1).sum())} of {ids.size} rows")
    return int(ids.size)
