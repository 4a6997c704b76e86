"""Quiver serving launcher on PyTorch: the paper's single-host serving path.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 200 \
        --adaptive --prefetch --gpu-cache

Builds the stack — synthetic skewed graph → PSGS/FAP → placement → tiered
store → GraphSAGE ``sage-base`` (hidden 128-128) → host and device
executors → per-executor latency calibration → cost-model router →
serving engine — then serves ``--requests`` requests of ``--batch`` seeds
each and prints a JSON report. Runs on ``--device cuda`` (default; raises
without a card) or ``--device cpu``.

The cold path and control loop: ``--spill-path`` backs the DISK tier with
an ``np.memmap`` spill file; ``--prefetch`` stages predicted cold rows in a
device buffer so HOST/DISK reads leave the request's critical path;
``--gpu-cache`` puts a device row cache in front of the cold tiers
(``--gpu-cache-rows``); ``--adaptive`` runs the online control loop (FAP
re-placement by swap migration, router refit, cold-path sizing; every
``--adapt-interval`` completed batches). ``--gateway`` puts the SLO
gateway in front of the engine: priority classes (``--priority
interactive|batch|mixed``), a relative deadline for interactive requests
(``--deadline-ms``), slack-ordered admission with aging, shedding before
dispatch, and ``--telemetry`` prints its streaming samples. Repeatable
``--models name=preset`` co-serves several GraphSAGE models over the one
shared store, each with its own calibration and router.

``--sharded`` adds the distributed executor: the store rebuilt over a
single-controller mesh of ``--mesh-world`` shards (default: one a card;
shards beyond the cards share them round-robin, so ``--mesh-world 4``
runs four shards on one card), HOT rows replicated and WARM rows sharded
by FAP owner, read through the dedup exchange; ``--sharded-spill-dir``
gives each shard its own DISK spill file. With ``--models`` every model
gets a sharded executor over the one sharded store.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (DynamicBatcher, GPUFeatureCache, Prefetcher,
                              ShardedFeatureStore, TieredFeatureStore,
                              TopologySpec, WorkloadGenerator, compute_fap,
                              compute_psgs, quiver_placement)
from repro_torch.graph import power_law_graph
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.gnn_basic import SAGE, sage_init
from repro_torch.serving import (AdaptiveConfig, AdaptiveController,
                                 CostModelRouter, DeviceExecutor,
                                 FrequencySketch, GatewayConfig,
                                 HostExecutor, MicroBatcher, ModelRegistry,
                                 ServingEngine, ServingGateway,
                                 ShardedExecutor, StaticScheduler,
                                 build_model_entry, calibrate_executors)

# --models presets: hidden layer widths of the GraphSAGE each model serves
# (all share the graph, store and samplers; only the model compute
# differs, which is what per-model calibration captures)
MODEL_PRESETS = {
    "sage-small": (64, 64),
    "sage-base": (128, 128),
    "sage-wide": (256, 256),
    "sage-deep": (128, 128, 128),
}
# hidden widths of the single served model
HIDDEN = MODEL_PRESETS["sage-base"]


def make_infer_fn(model: SAGE, fanouts: Sequence[int]):
    """``infer_fn(hop_feats, hop_ids[, deep_agg])`` over ``model``: masks
    come from the hop ids (``-1`` = absent), ``deep_agg`` is the innermost
    hop pre-reduced by ``TieredFeatureStore.lookup_aggregate``."""
    fanouts = tuple(fanouts)

    @torch.inference_mode()
    def infer_fn(hop_feats, hop_ids, deep_agg=None):
        masks = [(h >= 0).float()[:, None] for h in hop_ids]
        return model(hop_feats, fanouts, hop_masks=masks, deep_agg=deep_agg)

    return infer_fn


def make_model_infer_fn(d_feat: int, hidden: Sequence[int],
                        fanouts: Sequence[int], *, seed: int = 0,
                        device: str | torch.device = "cuda"):
    """One served model's ``infer_fn``: GraphSAGE with ``hidden`` widths,
    weights from a ``torch.Generator`` seeded with ``seed``."""
    model = sage_init(torch.Generator().manual_seed(seed),
                      [d_feat, *hidden], device=device)
    return make_infer_fn(model, fanouts)


def build_stack(*, nodes: int, avg_degree: float, d_feat: int,
                fanouts: tuple[int, ...], hot_frac: float, seed: int = 0,
                spill_path: Optional[str] = None,
                device: str | torch.device = "cuda"):
    """Graph, features, PSGS, FAP, store, workload generator and
    ``infer_fn`` — drawn from ``seed`` exactly as the reference launcher
    draws them (the model weights come from a ``torch.Generator`` seeded
    with ``seed``)."""
    dev = resolve_device(device)
    graph = power_law_graph(nodes, avg_degree, seed=seed)
    rng = np.random.default_rng(seed + 1)
    feats = rng.normal(size=(nodes, d_feat)).astype(np.float32)

    psgs = compute_psgs(graph, fanouts, device=dev)
    gen = WorkloadGenerator(nodes, graph.out_degree, seed=seed + 2)
    fap = compute_fap(graph, fanouts, seed_prob=gen.p, device=dev)
    topo = TopologySpec(num_pods=1, devices_per_pod=1,
                        rows_per_device=max(nodes // 4, 64),
                        rows_host=max(nodes // 2, 64),
                        hot_replicate_fraction=hot_frac)
    plan = quiver_placement(fap, topo)
    store = TieredFeatureStore.build(feats, plan, spill_path=spill_path,
                                     device=dev)
    infer_fn = make_model_infer_fn(d_feat, HIDDEN, fanouts, seed=seed,
                                   device=dev)
    return graph, feats, psgs, fap, store, gen, infer_fn


def stack_from_args(args: argparse.Namespace) -> tuple:
    """:func:`build_stack` at the size, spill file and device that
    :func:`parse_args` output names."""
    return build_stack(
        nodes=args.nodes, avg_degree=args.avg_degree, d_feat=args.d_feat,
        fanouts=fanouts_of(args), hot_frac=args.hot_frac,
        spill_path=args.spill_path, device=args.device)


def fanouts_of(args: argparse.Namespace) -> tuple[int, ...]:
    """``--fanouts`` as a tuple of ints."""
    return tuple(int(x) for x in args.fanouts.split(","))


def parse_model_specs(specs: list[str]) -> dict[str, tuple[int, ...]]:
    """``name=preset`` flags → {model name: hidden widths}; raises
    SystemExit on malformed specs, duplicate names or unknown presets."""
    models: dict[str, tuple[int, ...]] = {}
    for spec in specs:
        name, sep, preset = spec.partition("=")
        if not sep or not name:
            raise SystemExit(f"--models expects name=preset, got {spec!r}")
        if name in models:
            raise SystemExit(f"--models: duplicate model name {name!r}")
        if preset not in MODEL_PRESETS:
            raise SystemExit(f"--models: unknown preset {preset!r}; "
                             f"choose from {sorted(MODEL_PRESETS)}")
        models[name] = MODEL_PRESETS[preset]
    return models


def require_shards(world: int) -> None:
    """Exit unless the sharded store has at least two shards."""
    if world < 2:
        raise SystemExit(
            "--sharded needs ≥2 shards; on one card or the CPU set "
            "--mesh-world (e.g. --mesh-world 4)")


def mesh_world_of(args: argparse.Namespace) -> int:
    """``--mesh-world``, defaulting to the number of cards (1 on the
    CPU)."""
    if args.mesh_world is not None:
        return args.mesh_world
    return torch.cuda.device_count() if args.device == "cuda" else 1


def build_sharded_store(graph, feats, fap, *, hot_frac: float = 0.25,
                        spill_dir: Optional[str] = None,
                        world: Optional[int] = None,
                        device: str | torch.device = "cuda"):
    """Mesh and sharded feature store shared by every model's sharded
    executor (built once: co-serving keeps one copy of the rows). The
    placement is rebuilt over the mesh, with HBM (hot + warm) sized to
    cover every node as the reference sizes it; with ``spill_dir`` the
    DISK rows are split into per-shard spill files (shard = id % world).

    Returns:
        ``(mesh, sstore, splan)``.

    Raises:
        SystemExit: fewer than two shards.
    """
    mesh = make_host_mesh(world, device=device)
    require_shards(mesh.world)
    print(f"[serve] sharded: {mesh.world} shards on "
          f"{[str(d) for d, _ in mesh.groups()]}")
    topo = TopologySpec(num_pods=1, devices_per_pod=mesh.world,
                        rows_per_device=max(-(-graph.num_nodes // mesh.world),
                                            64),
                        rows_host=max(graph.num_nodes // 2, 64),
                        hot_replicate_fraction=hot_frac)
    splan = quiver_placement(fap, topo)
    sstore = ShardedFeatureStore.from_tiered(
        TieredFeatureStore.build(feats, splan, device=mesh.devices[0]),
        mesh, "x", spill_dir=spill_dir)
    return mesh, sstore, splan


def sharded_executor(graph, sharded, fanouts, infer_fn, psgs, *,
                     max_batch: int, rng_seed: int = 0, fused: bool = True,
                     fuse_aggregate: bool = False) -> ShardedExecutor:
    """The distributed executor over a :func:`build_sharded_store` result;
    the placement's tier table keeps cold-seed batches off it, as the
    reference launcher does."""
    mesh, sstore, splan = sharded
    return ShardedExecutor(
        mesh, "x", graph.device_arrays(sstore.device), sstore, fanouts,
        infer_fn, max_batch=max_batch, psgs_table=psgs,
        tier_table=splan.tier, rng_seed=rng_seed, fused=fused,
        fuse_aggregate=fuse_aggregate)


def build_executors(graph, store, fanouts, infer_fn, psgs, *,
                    num_workers: int, max_batch: int, sharded: bool = False,
                    feats=None, fap=None, hot_frac: float = 0.25,
                    fused: bool = True, fuse_aggregate: bool = False,
                    sharded_spill_dir: Optional[str] = None,
                    mesh_world: Optional[int] = None) -> dict:
    """Host + device executors over the shared store, plus with
    ``sharded`` the distributed executor over a sharded store built from
    ``feats`` and ``fap`` (:func:`build_sharded_store`, ``mesh_world``
    shards on the store's device type). ``fuse_aggregate`` folds the
    innermost hop into the gather; the sharded executor downgrades it with
    a one-time warning (its store serves whole rows only)."""
    executors = {
        "host": HostExecutor(graph, store, fanouts, infer_fn,
                             capacity=num_workers, psgs_table=psgs,
                             fused=fused, fuse_aggregate=fuse_aggregate),
        "device": DeviceExecutor(graph.device_arrays(store.device), store,
                                 fanouts, infer_fn, max_batch=max_batch,
                                 capacity=num_workers, psgs_table=psgs,
                                 fused=fused, fuse_aggregate=fuse_aggregate),
    }
    if sharded:
        parts = build_sharded_store(graph, feats, fap, hot_frac=hot_frac,
                                    spill_dir=sharded_spill_dir,
                                    world=mesh_world,
                                    device=store.device.type)
        executors["sharded"] = sharded_executor(
            graph, parts, fanouts, infer_fn, psgs, max_batch=max_batch,
            fused=fused, fuse_aggregate=fuse_aggregate)
    return executors


def make_prefetcher(args, store, fap, controller, hooks, *,
                    sstore=None) -> list:
    """``--prefetch`` wiring shared by the single- and multi-model paths:
    build the cold-tier prefetcher, hand it to the adaptive controller
    (refresh per control step, shared sketch) or, without ``--adaptive``,
    register it as an engine hook with its own sketch and refresh cadence,
    then stage the offline-FAP prediction before serving starts. With a
    sharded store (``sstore``) a second prefetcher drives its per-shard
    stages from the same signal (the controller's sketch, or the first
    prefetcher's).

    Returns:
        The prefetchers built, the single-host store's first (empty
        without ``--prefetch``).
    """
    if not args.prefetch:
        return []
    pfs = []
    for st in (store, sstore):
        if st is None:
            continue
        pf = Prefetcher(st, budget=args.prefetch_budget,
                        refresh_every=(None if controller is not None
                                       else args.adapt_interval))
        if controller is not None:
            controller.attach_prefetcher(pf)
        else:
            pf.sketch = (pfs[0].sketch if pfs
                         else FrequencySketch(store.plan.tier.shape[0]))
            hooks.append(pf)
        pfs.append(pf)
        staged = pf.refresh(scores=fap)
        where = " across the mesh shards" if st is sstore else ""
        print(f"[serve] prefetch: staged {staged} cold rows{where} "
              f"(budget {args.prefetch_budget})")
    return pfs


def make_gpu_cache(args, store, controller):
    """``--gpu-cache`` wiring shared by the single- and multi-model paths:
    a device row cache in front of the store's cold tiers
    (``--gpu-cache-rows``). With ``--adaptive`` it shares the controller's
    sketch (frequency-weighted eviction, capacity sized each control step);
    without it the capacity stays fixed and eviction is plain CLOCK."""
    if not args.gpu_cache:
        return None
    cache = GPUFeatureCache.for_store(
        store, args.gpu_cache_rows,
        sketch=controller.sketch if controller is not None else None)
    store.attach_cache(cache)
    print(f"[serve] gpu-cache: {args.gpu_cache_rows} rows in front of the "
          f"cold tiers"
          + (" (controller-sized)" if controller is not None else ""))
    return cache


def make_gateway(args, engine, controller):
    """``--gateway`` wiring shared by the single- and multi-model paths:
    the SLO gateway in front of the engine and, with ``--adaptive``, handed
    to the controller so each control step tunes its admission window."""
    if not args.gateway:
        return None
    gw = ServingGateway(engine,
                        config=GatewayConfig(queue_limit=args.gateway_queue))
    if controller is not None:
        controller.attach_gateway(gw)
    print(f"[serve] gateway: queue_limit={args.gateway_queue}, "
          f"priority mix {args.priority!r}"
          + (f", deadline {args.deadline_ms:.0f} ms"
             if args.deadline_ms is not None else ""))
    return gw


def priority_stream_kwargs(args) -> dict:
    """``--priority`` / ``--deadline-ms`` → ``WorkloadGenerator.stream``
    kwargs: class tags (cycled round-robin for ``mixed``) and the relative
    deadline carried by interactive requests (batch requests stay
    deadline-free, so aging, not slack, keeps them moving)."""
    if not args.gateway:
        return {}
    dl = args.deadline_ms * 1e-3 if args.deadline_ms is not None else None
    if args.priority == "mixed":
        return {"priorities": ("interactive", "batch"),
                "deadlines": (dl, None)}
    return {"priorities": (args.priority,), "deadlines": (dl,)}


def _serve_and_report(args, engine, psgs, reqs, controller,
                      prefetcher=None, cache=None, gateway=None) -> dict:
    """Shared tail of the single- and multi-model paths: warm-up, then the
    gateway path (per-request SLO admission), the micro-batched stream
    (with ``--adapt-micro`` attachment) or one request a batch; prints the
    JSON report and returns the metrics summary with a section for each
    of ``adaptation``, ``prefetch``, ``gpu_cache`` and ``gateway`` that
    ran."""
    engine.warmup([reqs[0]])
    report: dict = {}
    if gateway is not None:
        metrics = gateway.serve(reqs)
        report["gateway"] = gateway.report()
        print("[serve] gateway:", json.dumps(report["gateway"]))
        if args.telemetry:
            samples = gateway.telemetry_samples()
            print(f"[serve] telemetry: {len(samples)} samples, last 5:")
            for s in samples[-5:]:
                print("  ", json.dumps(s))
    elif args.micro_batch > 0:
        # stream path: per-request ingest, then the PSGS-aware coalescing
        # stage feeds super-batches under its deadline
        micro = MicroBatcher(deadline_s=args.micro_deadline_ms * 1e-3,
                             max_seeds=args.micro_batch, psgs_table=psgs)
        if args.adapt_micro and controller is not None:
            controller.attach_micro(micro)
        metrics = engine.serve_stream(
            reqs, DynamicBatcher(deadline_s=0.0, max_batch=1), micro=micro)
        print(f"[serve] micro-batching: {micro.emitted} super-batches, "
              f"{micro.coalesced} coalesced, final bounds "
              f"max_seeds={micro.max_seeds} "
              f"deadline_ms={micro.deadline_s * 1e3:.2f}")
    else:
        metrics = engine.run([[r] for r in reqs])
    summary = metrics.summary()
    print(json.dumps(summary, indent=2))
    for key, part in (("adaptation", controller), ("prefetch", prefetcher),
                      ("gpu_cache", cache)):
        if part is not None:
            report[key] = part.report()
            print(f"[serve] {key.replace('_', '-')}:",
                  json.dumps(report[key]))
    return {**summary, **report}


def _calibrated_router(args, executors, graph, psgs):
    """Calibration (paper Fig. 6): measure every executor across the PSGS
    range and fit avg+tail curves; a static policy skips it."""
    if args.policy in ("host_only", "device_only"):
        return StaticScheduler("host" if args.policy == "host_only"
                               else "device")
    order = np.argsort(psgs)
    batches = [order[int(q * graph.num_nodes):][:args.batch]
               .astype(np.int64) for q in np.linspace(0.05, 0.95, 8)]
    curves = calibrate_executors(executors, batches, psgs, repeats=2)
    router = CostModelRouter.from_curves(psgs, curves, args.policy,
                                         executors=executors)
    mid = float(np.median(psgs)) * args.batch
    ests = {n: round(router.estimate(n, mid) * 1e3, 2) for n in router.names}
    print(f"[serve] calibrated est @median-batch (ms): {ests}")
    return router


def make_controller(args, graph, fanouts, store, router, psgs):
    """``--adaptive``: the control loop over ``store`` (and ``router``, a
    router, a list of them, or ``None`` to leave routing alone)."""
    if not args.adaptive:
        return None
    return AdaptiveController(
        graph, fanouts, store, router, psgs_table=psgs,
        config=AdaptiveConfig(interval_batches=args.adapt_interval,
                              rows_per_step=args.adapt_rows,
                              drift_threshold=args.drift_threshold))


def _serve_engine(args, engine, psgs, gen, store, fap, controller, hooks,
                  models=None, sstore=None) -> dict:
    """Attach the cold path and the gateway to ``engine``, serve the
    request stream, and close the prefetchers and the engine whatever
    happens."""
    prefetchers, cache = [], None
    try:
        prefetchers = make_prefetcher(args, store, fap, controller, hooks,
                                      sstore=sstore)
        cache = make_gpu_cache(args, store, controller)
        for h in hooks:
            engine.add_hook(h)
        gateway = make_gateway(args, engine, controller)
        reqs = list(gen.stream(args.requests, seeds_per_request=args.batch,
                               models=models,
                               **priority_stream_kwargs(args)))
        return _serve_and_report(args, engine, psgs, reqs, controller,
                                 prefetchers[0] if prefetchers else None,
                                 cache, gateway)
    finally:
        try:
            engine.close()
        finally:
            for pf in prefetchers:
                pf.close()


def serve_multi_model(args, fanouts, graph, psgs, fap, store, gen, *,
                      sharded=None, hooks: Sequence = ()) -> dict:
    """The ``--models`` path: one engine, one shared store, N models.

    Per model: its own ``infer_fn`` (preset hidden widths), executor set
    over the shared store (with ``sharded``, a :func:`build_sharded_store`
    result, also a sharded executor over the one sharded store),
    calibration and router, so each model gets its own PSGS cut-point.
    Requests are tagged round-robin across the models; admission stays
    global; the report breaks down per model.
    """
    specs = parse_model_specs(args.models)
    order = np.argsort(psgs)
    cal_batches = [order[int(q * graph.num_nodes):][:args.batch]
                   .astype(np.int64) for q in np.linspace(0.05, 0.95, 8)]
    registry = ModelRegistry()
    for i, (name, hidden) in enumerate(specs.items()):
        infer = make_model_infer_fn(args.d_feat, hidden, fanouts, seed=i,
                                    device=store.device)
        extra = None if sharded is None else {"sharded": sharded_executor(
            graph, sharded, fanouts, infer, psgs, max_batch=args.batch,
            rng_seed=i, fused=args.fused)}
        entry = build_model_entry(
            name, graph=graph, store=store, fanouts=fanouts, infer_fn=infer,
            psgs_table=psgs, policy=args.policy, capacity=args.workers,
            max_batch=args.batch, fused=args.fused, rng_seed=i,
            calibration_batches=cal_batches, extra_executors=extra)
        registry.add(entry)
        cut = entry.router.crossover("host", "device")
        print(f"[serve] model {name!r} ({'x'.join(map(str, hidden))}): "
              f"host/device PSGS cut-point {cut:.1f}")

    hooks = list(hooks)
    controller = make_controller(args, graph, fanouts, store,
                                      registry.routers(), psgs)
    if controller is not None:
        hooks.insert(0, controller)
    engine = ServingEngine(registry, max_inflight=args.max_inflight,
                           admission=args.admission)
    return _serve_engine(args, engine, psgs, gen, store, fap, controller,
                         hooks, models=list(specs),
                         sstore=None if sharded is None else sharded[1])


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The launcher's flags, with the reference's cross-flag checks; an
    unknown flag or a failed check exits with an error."""
    p = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--nodes", type=int, default=20000)
    p.add_argument("--avg-degree", type=float, default=12.0)
    p.add_argument("--d-feat", type=int, default=128)
    p.add_argument("--fanouts", default="10,5")
    p.add_argument("--requests", type=int, default=300)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--policy", default="latency_preferred",
                   choices=["cpu_preferred", "gpu_preferred",
                            "latency_preferred", "throughput_preferred",
                            "host_only", "device_only"])
    p.add_argument("--hot-frac", type=float, default=0.25)
    p.add_argument("--sharded", action="store_true",
                   help="register the distributed executor over the sharded "
                        "store (needs ≥2 shards, see --mesh-world)")
    p.add_argument("--mesh-world", type=int, default=None,
                   help="shards of the sharded store's mesh (default: the "
                        "number of cards, 1 on --device cpu); shards beyond "
                        "the cards share them round-robin (needs --sharded)")
    p.add_argument("--max-inflight", type=int, default=64,
                   help="admission window: outstanding batches")
    p.add_argument("--admission", default="wait", choices=["wait", "shed"],
                   help="behavior when the admission window is full")
    p.add_argument("--models", action="append", default=None,
                   metavar="NAME=PRESET",
                   help="co-serve a named model from a preset (repeatable; "
                        f"presets: {sorted(MODEL_PRESETS)}). All models "
                        "share the graph and feature store; each gets its "
                        "own calibration, router and metrics.")
    p.add_argument("--adaptive", action="store_true",
                   help="online adaptation loop: live FAP re-placement by "
                        "swap migration, router drift refit, cold-path "
                        "sizing")
    p.add_argument("--adapt-micro", action="store_true",
                   help="let the controller tune the micro-batcher's "
                        "deadline/max_seeds toward the latency-curve knee "
                        "(needs --adaptive and --micro-batch > 0)")
    p.add_argument("--adapt-interval", type=int, default=32,
                   help="control period in completed batches")
    p.add_argument("--adapt-rows", type=int, default=64,
                   help="max feature rows migrated per control step")
    p.add_argument("--drift-threshold", type=float, default=0.25,
                   help="relative latency-curve drift that triggers a "
                        "router refit")
    p.add_argument("--fused", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="fused feature collection (cross-hop dedup + one "
                        "tiered_gather launch); --no-fused keeps per-hop "
                        "store lookups")
    p.add_argument("--fuse-aggregate", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="fold the innermost-hop aggregation into the "
                        "gather (gather_aggregate kernel)")
    p.add_argument("--micro-batch", type=int, default=0,
                   help="coalesce requests into super-batches of up to this "
                        "many seeds before admission (0 = off)")
    p.add_argument("--micro-deadline-ms", type=float, default=4.0,
                   help="max milliseconds a request may wait in the "
                        "micro-batching stage")
    p.add_argument("--prefetch", action="store_true",
                   help="stage predicted cold (HOST/DISK) rows in a device "
                        "buffer off the critical path; refreshed per "
                        "control step with --adaptive, else every "
                        "--adapt-interval batches")
    p.add_argument("--prefetch-budget", type=int, default=1024,
                   help="max cold rows staged per refresh")
    p.add_argument("--gpu-cache", action="store_true",
                   help="device row cache in front of the cold tiers; "
                        "controller-sized under --adaptive")
    p.add_argument("--gpu-cache-rows", type=int, default=2048,
                   help="device-cache row capacity (initial under "
                        "--adaptive)")
    p.add_argument("--gateway", action="store_true",
                   help="SLO gateway in front of the engine: priority "
                        "classes, deadline-slack ordering with aging, "
                        "shedding before dispatch")
    p.add_argument("--gateway-queue", type=int, default=256,
                   help="gateway admission-queue bound (tuned live under "
                        "--adaptive)")
    p.add_argument("--priority", default="batch",
                   choices=["interactive", "batch", "mixed"],
                   help="priority class of the request stream (mixed = "
                        "alternating interactive/batch; needs --gateway)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="relative deadline of interactive requests (needs "
                        "--gateway)")
    p.add_argument("--telemetry", action="store_true",
                   help="print the gateway's telemetry samples after "
                        "serving (needs --gateway)")
    p.add_argument("--spill-path", default=None,
                   help="write DISK-tier rows to an np.memmap spill file at "
                        "this path; omit to keep them in host memory")
    p.add_argument("--sharded-spill-dir", default=None,
                   help="directory for the sharded store's per-shard spill "
                        "files (shard = id %% world); omit to serve sharded "
                        "cold misses from the single-host source store "
                        "(needs --sharded)")
    args = p.parse_args(argv)
    if args.adapt_micro and not (args.adaptive and args.micro_batch > 0):
        raise SystemExit("--adapt-micro needs --adaptive and "
                         "--micro-batch > 0")
    if not args.gateway and (args.priority != "batch" or args.telemetry
                             or args.deadline_ms is not None):
        raise SystemExit("--priority/--deadline-ms/--telemetry need "
                         "--gateway")
    if args.gateway and args.micro_batch > 0:
        raise SystemExit("--gateway dispatches per request (admission "
                         "ordering is the point); drop --micro-batch")
    if args.sharded_spill_dir is not None and not args.sharded:
        raise SystemExit("--sharded-spill-dir needs --sharded")
    if args.mesh_world is not None and not args.sharded:
        raise SystemExit("--mesh-world needs --sharded")
    if args.sharded:
        require_shards(mesh_world_of(args))
    if args.models:
        if args.policy in ("host_only", "device_only"):
            raise SystemExit("--models needs a cost-model policy "
                             "(per-model routing is the point)")
        parse_model_specs(args.models)
    return args


def serve(args: argparse.Namespace, *, stack: Optional[tuple] = None,
          hooks: Sequence = ()) -> dict:
    """Build, calibrate and serve per ``args``.

    Args:
        args: :func:`parse_args` output.
        stack: a :func:`build_stack` result to serve over instead of
            building one from ``args``.
        hooks: extra engine hooks (``on_admit`` / ``on_batch_complete``),
            called after the launcher's own.

    Returns:
        The metrics summary (``ServeMetrics.summary()``), plus the
        ``adaptation``, ``prefetch``, ``gpu_cache`` and ``gateway`` reports
        of the parts that ran.
    """
    fanouts = fanouts_of(args)
    if stack is None:
        stack = stack_from_args(args)
    graph, feats, psgs, fap, store, gen, infer_fn = stack
    print(f"[serve] graph: {graph.num_nodes} nodes / {graph.num_edges} edges;"
          f" tiers: {store.plan.tier_counts()}; device: {store.device}"
          + (f"; spill: {store.disk.path}" if store.disk.path else ""))
    if args.models:
        sharded = None
        if args.sharded:
            sharded = build_sharded_store(
                graph, feats, fap, hot_frac=args.hot_frac,
                spill_dir=args.sharded_spill_dir, world=mesh_world_of(args),
                device=store.device.type)
        return serve_multi_model(args, fanouts, graph, psgs, fap, store, gen,
                                 sharded=sharded, hooks=hooks)
    static = args.policy in ("host_only", "device_only")
    if args.sharded and static:
        print("[serve] note: static policy can never route to the sharded "
              "executor; skipping its construction")
    executors = build_executors(graph, store, fanouts, infer_fn, psgs,
                                num_workers=args.workers,
                                max_batch=args.batch,
                                sharded=args.sharded and not static,
                                feats=feats, fap=fap,
                                hot_frac=args.hot_frac, fused=args.fused,
                                fuse_aggregate=args.fuse_aggregate,
                                sharded_spill_dir=args.sharded_spill_dir,
                                mesh_world=mesh_world_of(args))
    print(f"[serve] executors: {sorted(executors)}")
    sstore = getattr(executors.get("sharded"), "sstore", None)
    try:
        router = _calibrated_router(args, executors, graph, psgs)
    except BaseException:
        for ex in executors.values():
            ex.close()
        raise
    hooks = list(hooks)
    controller = make_controller(args, graph, fanouts, store,
                                      None if static else router, psgs)
    if controller is not None:
        hooks.insert(0, controller)
    engine = ServingEngine(executors, router, max_inflight=args.max_inflight,
                           admission=args.admission)
    return _serve_engine(args, engine, psgs, gen, store, fap, controller,
                         hooks, sstore=sstore)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return serve(parse_args(argv))


if __name__ == "__main__":
    main()
