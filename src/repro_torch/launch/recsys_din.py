"""DIN recsys serving with FAP-style embedding placement: item popularity
drives which rows of the item table live on the device, through the same
tiered feature store as the GNN features (port of
``examples/recsys_din.py``).

    PYTHONPATH=src python -m repro_torch.launch.recsys_din --device cpu \\
        --config example
    PYTHONPATH=src python -m repro_torch.launch.recsys_din --config din \\
        --batches 8 --candidates 1000000
    PYTHONPATH=src python -m repro_torch.launch.recsys_din --config din \\
        --train-steps 3

Configurations:

* ``example`` — the example script's own settings and draws: 50,000
  items, history 50, 256 requests per batch, 4 devices' worth of rows
  (4,000 each, 40% HOT) and 20,000 HOST rows, every draw from
  ``np.random.default_rng(0)`` in the script's order.
* ``din`` — ``repro_torch.configs.din.CONFIG`` (10,000,000 items,
  history 100) at ``serve_p99`` (512 requests per batch), with the
  example's topology scaled by n_items / 50,000: 800,000 rows per device
  (320,000 HOT + 4 × 480,000 WARM on the card) and 4,000,000 HOST rows;
  the other 3,760,000 rows are DISK.

Each batch is drawn on the host (Zipf-1.2 item popularity, uniform
categories, normal dense features), then scored by ``din_forward`` with
the item table served by ``TieredFeatureStore.lookup``; the batch time
covers the lookups and the forward and ends in a device synchronize.
``--candidates N`` then scores N uniform candidates for the first user
of the first batch with ``din_score_candidates``. Prints one JSON report.

``--train-steps N`` trains instead of serving: N steps of the reference's
``train_batch`` cell (``configs/din.py::train_step``: ``din_loss``, its
gradients, ``AdamW(lr=1e-3, weight_decay=0.0)``) at the config's train
batch, 65,536 for ``din`` (history 100, the 10M-row item table: nothing
cut) and 256 for ``example``. The item table is a plain parameter on the
device, as in the reference's cell, not behind the tiered store. Each step
draws its batch as serving does (Zipf-1.2 items over the same
popularity, uniform categories, normal dense features, in that order from
``np.random.default_rng(0)``), then labels ``rng.integers(0, 2, B)``
(Bernoulli(0.5), as the reference's ``din_smoke`` draws them). The report
holds the losses, step ms and their stages (forward, backward, optimizer),
``embedding_bag`` launches and peak device memory.

Runs on ``--device cuda`` (default; raises without a card) or ``cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import din as din_config
from repro_torch.configs.din import CONFIG, RETRIEVAL_CHUNK, SHAPES
from repro_torch.core import TieredFeatureStore, TopologySpec, quiver_placement
from repro_torch.kernels import embedding_bag as eb
from repro_torch.models.din import (DIN, DINConfig, din_forward, din_init,
                                    din_score_candidates)
from repro_torch.training import StageTimer

EXAMPLE = DINConfig(n_items=50_000, n_cates=500, embed_dim=18, hist_len=50,
                    n_dense_feat=8)

# config name → (model config, requests per batch, placement topology)
SETTINGS = {
    "example": (EXAMPLE, 256, TopologySpec(
        num_pods=1, devices_per_pod=4, rows_per_device=4000,
        rows_host=20000, hot_replicate_fraction=0.4)),
    "din": (CONFIG, SHAPES["serve_p99"]["batch"], TopologySpec(
        num_pods=1, devices_per_pod=4, rows_per_device=800_000,
        rows_host=4_000_000, hot_replicate_fraction=0.4)),
}

# requests per train step (the din config's is the train_batch shape's)
TRAIN_BATCH = {"example": 256, "din": SHAPES["train_batch"]["batch"]}


@dataclasses.dataclass
class DinStack:
    """Model, placed item table and the request source of one run."""

    cfg: DINConfig
    model: DIN
    store: TieredFeatureStore
    batch: int
    rng: np.random.Generator
    popularity: np.ndarray  # (n_items,) float32 draw probabilities


@dataclasses.dataclass
class Retrieval:
    """One user scored against ``items``/``cates``."""

    items: torch.Tensor
    cates: torch.Tensor
    scores: torch.Tensor
    ms: float


def build_stack(config: str = "example", *,
                device: str | torch.device = "cuda",
                model: Optional[DIN] = None) -> DinStack:
    """Weights (``din_init`` from a ``torch.Generator`` seeded with 0,
    unless ``model`` is given), item popularity, placement and the tiered
    store of the item table, drawn as the example script draws them (from
    ``np.random.default_rng(0)``)."""
    cfg, batch, topo = SETTINGS[config]
    dev = resolve_device(device)
    if model is None:
        model = din_init(torch.Generator().manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(0)
    pop = popularity(cfg, rng)
    plan = quiver_placement(pop, topo)
    store = TieredFeatureStore.build(model.item_embed.detach().cpu().numpy(),
                                     plan, device=dev)
    return DinStack(cfg, model, store, batch, rng, pop / pop.sum())


def popularity(cfg: DINConfig, rng: np.random.Generator) -> np.ndarray:
    """Item popularity (the recsys FAP): Zipf-1.2 over a random
    permutation of the items, fp32, unnormalised."""
    pop = 1.0 / np.power(np.arange(1, cfg.n_items + 1), 1.2)
    return pop[rng.permutation(cfg.n_items)].astype(np.float32)


def draw_requests(cfg: DINConfig, b: int, rng: np.random.Generator,
                  p: np.ndarray, device: torch.device, *,
                  labels: bool = False) -> dict[str, torch.Tensor]:
    """``b`` requests drawn from ``rng`` in order: target items and
    history items by popularity ``p``, categories uniform, dense features
    normal; with ``labels``, then ``rng.integers(0, 2, b)`` as
    ``label``."""
    t_len = cfg.hist_len
    draws = dict(
        target_item=rng.choice(cfg.n_items, size=b, p=p),
        target_cate=rng.integers(0, cfg.n_cates, b),
        hist_items=rng.choice(cfg.n_items, size=(b, t_len), p=p),
        hist_cates=rng.integers(0, cfg.n_cates, (b, t_len)),
        dense_feat=rng.normal(size=(b, cfg.n_dense_feat)))
    if labels:
        draws["label"] = rng.integers(0, 2, b)
    return {k: torch.as_tensor(v.astype(np.float32 if k == "dense_feat"
                                        else np.int32), device=device)
            for k, v in draws.items()}


def draw_batch(stack: DinStack) -> dict[str, torch.Tensor]:
    """The next batch of requests, on the store's device."""
    return draw_requests(stack.cfg, stack.batch, stack.rng,
                         stack.popularity, stack.store.device)


def item_lookup(store: TieredFeatureStore) -> Callable:
    """``ids (...)`` → rows ``(..., d)`` through ``store.lookup``."""
    def lookup(ids: torch.Tensor) -> torch.Tensor:
        rows = store.lookup(ids.reshape(-1))
        return rows.reshape(tuple(ids.shape) + (store.feat_dim,))
    return lookup


def score_batch(stack: DinStack, batch: dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """``(B,)`` logits for one batch, the item rows served by the store."""
    return din_forward(stack.model, stack.cfg, batch["target_item"],
                       batch["target_cate"], batch["hist_items"],
                       batch["hist_cates"], batch["dense_feat"],
                       item_lookup=item_lookup(stack.store))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(stack: DinStack, batches: int
          ) -> tuple[dict, list[dict], list[torch.Tensor]]:
    """Draw and score ``batches`` batches through the store.

    Returns:
        ``(report, batches, logits)``: the JSON-able report (per-batch
        milliseconds and their median, the HOT/WARM/HOST/DISK mix of the
        history ids, the store's counters), the batches served and their
        logits.
    """
    dev = stack.store.device
    served, logits, ms = [], [], []
    tiers = dict.fromkeys(("hot", "warm", "host", "disk"), 0)
    stack.store.reset_stats()
    for _ in range(batches):
        batch = draw_batch(stack)
        _sync(dev)
        t0 = time.perf_counter()
        out = score_batch(stack, batch)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in stack.store.tier_histogram(
                batch["hist_items"].cpu().numpy().ravel()).items():
            tiers[k] += v
        served.append(batch)
        logits.append(out)
    total = max(sum(tiers.values()), 1)
    report = {
        "device": str(dev), "items": stack.cfg.n_items,
        "batch": stack.batch, "batches": batches,
        "placement": stack.store.plan.tier_counts(),
        "tier_counts": tiers,
        "tier_mix": {k: v / total for k, v in tiers.items()},
        "batch_ms": ms, "p50_ms": statistics.median(ms) if ms else None,
        "store": stack.store.snapshot_stats()}
    return report, served, logits


def score_candidates(stack: DinStack, user: dict[str, torch.Tensor], n: int,
                     *, chunk: int = RETRIEVAL_CHUNK) -> Retrieval:
    """Score ``n`` uniform candidates for the first user of ``user`` (a
    batch) with ``din_score_candidates``; the time ends in a device
    synchronize."""
    cfg, dev = stack.cfg, stack.store.device
    items = torch.as_tensor(stack.rng.integers(0, cfg.n_items, n)
                            .astype(np.int32), device=dev)
    cates = torch.as_tensor(stack.rng.integers(0, cfg.n_cates, n)
                            .astype(np.int32), device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    scores = din_score_candidates(
        stack.model, cfg, user["hist_items"][0], user["hist_cates"][0],
        user["dense_feat"][0], items, cates, chunk=chunk)
    _sync(dev)
    return Retrieval(items, cates, scores, (time.perf_counter() - t0) * 1e3)


def train_cell(config: str, *, device: str | torch.device = "cuda"
               ) -> tuple[DIN, Callable, Callable]:
    """The ``train_batch`` cell at ``TRAIN_BATCH[config]`` (module
    docstring): ``(model, draw() -> batch, step(batch, timer) -> loss)``,
    ``step`` one ``configs/din.py::train_step`` that keeps the optimizer
    state between calls."""
    cfg = SETTINGS[config][0]
    b = TRAIN_BATCH[config]
    dev = resolve_device(device)
    model = din_init(torch.Generator().manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(0)
    p = popularity(cfg, rng)
    p = p / p.sum()
    opt = din_config.train_optimizer()
    state = [opt.init(dict(model.named_parameters()))]

    def draw() -> dict[str, torch.Tensor]:
        return draw_requests(cfg, b, rng, p, dev, labels=True)

    def step(batch: dict[str, torch.Tensor],
             timer: StageTimer) -> torch.Tensor:
        state[0], loss = din_config.train_step(model, opt, state[0], batch,
                                               cfg, timer=timer)
        return loss
    return model, draw, step


def train(config: str, steps: int, *,
          device: str | torch.device = "cuda") -> dict:
    """``steps`` steps of :func:`train_cell`; returns the report."""
    cfg = SETTINGS[config][0]
    dev = resolve_device(device)
    model, draw, step = train_cell(config, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = eb.LAUNCHES.value
    losses, step_ms, stages = [], [], []
    for _ in range(steps):
        batch = draw()
        timer = StageTimer(dev)
        losses.append(float(step(batch, timer)))
        step_ms.append(sum(timer.ms.values()))
        stages.append(timer.ms)
    return {"config": config, "device": str(dev), "items": cfg.n_items,
            "batch": TRAIN_BATCH[config], "hist_len": cfg.hist_len,
            "steps": steps,
            "params": sum(x.numel() for x in model.parameters()),
            "losses": losses, "step_ms": step_ms, "stage_ms": stages,
            "embedding_bag_launches": eb.LAUNCHES.value - launches0,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The launcher's flags; an unknown flag exits with an error."""
    p = argparse.ArgumentParser(prog="repro_torch.launch.recsys_din")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--config", default="example", choices=sorted(SETTINGS))
    p.add_argument("--batches", type=int, default=1)
    p.add_argument("--candidates", type=int, default=0,
                   help="score this many candidates for one user (0: skip)")
    p.add_argument("--train-steps", type=int, default=0,
                   help="train this many train_batch steps instead of "
                        "serving (0: serve)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    if args.train_steps:
        report = train(args.config, args.train_steps, device=args.device)
        print(json.dumps(report))
        return report
    stack = build_stack(args.config, device=args.device)
    report, served, logits = serve(stack, args.batches)
    report["config"] = args.config
    if logits:
        scores = torch.cat(logits)
        report["score_mean"] = float(scores.mean())
        report["score_std"] = float(scores.std())
    if args.candidates and served:
        ret = score_candidates(stack, served[0], args.candidates)
        report["retrieval"] = {"candidates": args.candidates,
                               "chunk": RETRIEVAL_CHUNK, "ms": ret.ms,
                               "finite": bool(torch.isfinite(ret.scores)
                                              .all())}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
