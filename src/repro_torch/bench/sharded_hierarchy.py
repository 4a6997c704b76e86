"""Sharded-store hierarchy: the dedup exchange, per-shard staging and
spill files against the allgather strategy with its host post-pass.

The paper's distributed design partitions features over the cards by
access probability. ``ShardedFeatureStore`` serves the whole hierarchy
through the mesh exchange: cold (HOST/DISK) ids resolve from per-shard
device stages inside the exchange, an id repeated across hops crosses
once, and the host is the miss path. On a zipf-skewed multi-hop workload
this reports:

  1. bit identity: the owner-sorted dedup exchange (``alltoall``) returns
     the rows of per-hop ``lookup`` calls, of the ``allgather`` strategy
     and of the single-host ``TieredFeatureStore``, HOST and DISK ids
     included, staged and unstaged (asserted);
  2. host fetches a request with per-shard staging and spill files below
     the allgather baseline's; stage hits and spill reads both exercised
     (asserted);
  3. cross-hop dedup: one exchange a lookup, whose ``exchanged_ids``
     equals the distinct (shard, id) pairs and stays below the raw
     occurrences (asserted).

    PYTHONPATH=src python -m repro_torch.bench.run --only sharded_hierarchy

The mesh is single-controller (:mod:`repro_torch.launch.mesh`): ``world``
logical shards, placed round-robin over the cards (the reference takes
its world from ``len(jax.devices())``). The default, 4, puts four shards
on one card, one a card where there are four. ``dry_run=True`` takes the
reference's CI sizes.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.bench.common import emit, write_bench_json
from repro_torch.core import (Prefetcher, ShardedFeatureStore,
                              TieredFeatureStore, TopologySpec,
                              WorkloadGenerator, compute_fap,
                              quiver_placement)
from repro_torch.core.placement import TIER_WARM
from repro_torch.graph import power_law_graph
from repro_torch.launch.mesh import make_host_mesh

FANOUTS = (6, 4)
WORLD = 4


def _build(nodes: int, world: int, spill_path: str, device):
    """Source tiered store with real HOST and DISK (spill file) tiers,
    warm sized per shard, plus the workload's FAP and zipf pieces."""
    graph = power_law_graph(nodes, 10.0, seed=0)
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(nodes, 48)).astype(np.float32)
    gen = WorkloadGenerator(nodes, graph.out_degree, distribution="zipf",
                            seed=2)
    fap = compute_fap(graph, FANOUTS, seed_prob=gen.p, device=device)
    # small HBM tiers so the skewed stream actually exercises HOST + DISK
    topo = TopologySpec(num_pods=1, devices_per_pod=world,
                        rows_per_device=max(int(nodes * 0.08) // world, 16),
                        rows_host=max(int(nodes * 0.25), 32),
                        hot_replicate_fraction=0.3)
    src = TieredFeatureStore.build(feats, quiver_placement(fap, topo),
                                   spill_path=spill_path, device=device)
    return graph, feats, gen, fap, src


def hop_ids(rng, gen, world: int, sizes) -> list[np.ndarray]:
    """One request's hop id vectors: zipf-distributed draws with forced
    cross-hop duplication (the frontier overlap the dedup exchange
    collapses) and ``-1`` padding, each length a multiple of ``world``."""
    hops = []
    for s in sizes:
        s = -(-s // world) * world
        ids = rng.choice(gen.num_nodes, size=s, p=gen.p).astype(np.int32)
        if hops:  # duplicate a slice of the previous hop into this one
            take = min(len(hops[-1]), s // 2)
            ids[:take] = hops[-1][:take]
        ids[rng.random(s) < 0.05] = -1  # padding flows through
        hops.append(ids)
    return hops


def _np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _check_identity(src, base, dedup, fap, gen, rng) -> None:
    """Every path returns the same rows for the same ids: per-hop and
    fused, allgather and alltoall, sharded and single-host, staged or
    not."""
    hops = hop_ids(rng, gen, base.world, (16, 64, 192))
    want = [_np(src.lookup(h)) for h in hops]

    def check(store, label):
        fused = store.lookup_hops(hops)
        per_hop = [store.lookup(h) for h in hops]
        for k, w in enumerate(want):
            assert np.array_equal(w, _np(fused[k])), \
                f"{label}: fused hop {k} diverged from single-host store"
            assert np.array_equal(w, _np(per_hop[k])), \
                f"{label}: per-hop lookup hop {k} diverged"

    check(base, "allgather")
    check(dedup, "alltoall")
    pf = Prefetcher(dedup, budget=gen.num_nodes)
    try:
        pf.refresh(scores=np.maximum(fap, 1e-12))  # stage the full cold set
        check(dedup, "alltoall+staged")
    finally:
        dedup.publish_stage(None, None)
        pf.close()
    emit("sharded_hierarchy/bit_identical", 1.0,
         "alltoall==allgather==per-hop==single-host, HOST/DISK included, "
         "staged and unstaged")


def run(*, dry_run: bool = False, world: int = WORLD,
        device: str | torch.device = "cuda") -> dict:
    """Emit the identity, host fetches a request (allgather post-pass
    against staged alltoall) and the exchange's dedup at ``world``
    logical shards; returns the results (also in
    ``BENCH_sharded_hierarchy.json``)."""
    nodes = 800 if dry_run else 4000
    n_req = 8 if dry_run else 48
    sizes = (4, 16, 48) if dry_run else (8, 32, 128)
    mesh = make_host_mesh(world, device=device)
    spill = tempfile.NamedTemporaryFile(suffix=".spill", delete=False)
    spill.close()
    spill_dir = tempfile.mkdtemp(prefix="shard_spill_")
    try:
        graph, feats, gen, fap, src = _build(nodes, world, spill.name,
                                             mesh.devices[0])
        base = ShardedFeatureStore.from_tiered(src, mesh, "x",
                                               strategy="allgather")
        dedup = ShardedFeatureStore.from_tiered(src, mesh, "x",
                                                strategy="alltoall",
                                                spill_dir=spill_dir)
        results: dict = {"world": world, "dry_run": dry_run}

        # -- 1) bit-identity across every path -------------------------------
        _check_identity(src, base, dedup, fap, gen, np.random.default_rng(11))

        # -- 2) host fetches a request: post-pass baseline vs staged ---------
        n_cold = int((dedup.tier_table_host >= 2).sum())
        for mode, store in (("baseline", base), ("staged", dedup)):
            pf = None
            if mode == "staged":
                pf = Prefetcher(store, budget=n_cold)
                staged = pf.refresh(scores=np.maximum(fap, 1e-12))
                prep = store.reset_stats()
                # staging reads the DISK shard files through read_cold_rows
                assert prep["spill_reads"] > 0, prep
                emit("sharded_hierarchy/staged_rows", float(staged),
                     f"cold_rows={n_cold};spill_reads={prep['spill_reads']}")
            rng = np.random.default_rng(7)  # same workload both modes
            store.reset_stats()
            for _ in range(n_req):
                store.lookup_hops(hop_ids(rng, gen, world, sizes))
            stats = store.reset_stats()
            if pf is not None:
                pf.close()
            results[mode] = {"host_cb_per_req": stats["host_fetches"] / n_req,
                             "cold_rows": stats["cold_rows"],
                             "stage_hits": stats["stage_hits"],
                             "stage_misses": stats["stage_misses"]}
            emit(f"sharded_hierarchy/{mode}_host_cb_per_req",
                 results[mode]["host_cb_per_req"],
                 f"cold_rows={stats['cold_rows']};"
                 f"stage_hits={stats['stage_hits']}")
        off, on = results["baseline"], results["staged"]
        assert off["host_cb_per_req"] > 0, off  # baseline pays the post-pass
        assert on["host_cb_per_req"] < off["host_cb_per_req"], results
        assert on["stage_hits"] > 0, on
        emit("sharded_hierarchy/host_cb_reduction_x",
             off["host_cb_per_req"] / max(on["host_cb_per_req"], 1e-9),
             f"hits={on['stage_hits']};misses={on['stage_misses']}")
        dedup.publish_stage(None, None)

        # -- 3) cross-hop duplicates are exchanged exactly once ---------------
        rng = np.random.default_rng(13)
        hops = hop_ids(rng, gen, world, sizes)
        cat = np.concatenate(hops).astype(np.int64)
        m_dev = cat.size // world
        shard = np.repeat(np.arange(world), m_dev)
        warm = (cat >= 0) & (dedup.tier_table_host[np.maximum(cat, 0)]
                             == TIER_WARM)
        occurrences = int(warm.sum())
        distinct = len({(d, i) for d, i in zip(shard[warm], cat[warm])})
        dedup.reset_stats()
        dedup.lookup_hops(hops)
        st = dedup.reset_stats()
        assert st["exchanges"] == 1, st
        assert st["exchanged_ids"] == distinct, (st, distinct)
        assert distinct < occurrences, (distinct, occurrences)
        results["dedup"] = {"exchanged_ids": distinct,
                            "occurrences": occurrences}
        emit("sharded_hierarchy/exchanged_ids_per_req", float(distinct),
             f"occurrences={occurrences}")
        emit("sharded_hierarchy/dedup_savings_x",
             occurrences / max(distinct, 1),
             "warm occurrences ÷ ids actually exchanged")
        write_bench_json("sharded_hierarchy", results)
        return results
    finally:
        os.unlink(spill.name)
        shutil.rmtree(spill_dir, ignore_errors=True)
