"""Where a GIN-TU training step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.bench.profile_train \\
        [--out profile_train.json]

At the ``ogb_products`` shape, runs ``repro_torch.launch.train``'s step by
hand, one stage at a time, each ending in a device synchronize:

* ``batch`` — ``make_concrete_batch`` on the host (numpy draws);
* ``h2d`` — the batch's copy to the card;
* ``ell`` — the forward and transposed ELL tables (``ell_pair``);
* ``forward`` — GIN-TU and the loss (5 ``segment_spmm`` launches);
* ``backward`` — gradients (4 ``segment_spmm`` launches);
* ``optimizer`` — the AdamW update.

Step 0 warms up (kernel build and load, cuBLAS handles); the next
``TIMED_STEPS`` steps give the stage times (median); one more step runs
under ``torch.profiler`` for the device's busy time and idle share
(``1 - busy / wall``) over the whole step and over its device part (from
the copy on), and the device time of the costliest activities. Prints one
JSON object and, with ``--out``, writes it to that file. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import gin_tu
from repro_torch.configs.gnn_common import (SHAPES, classification_loss,
                                            make_concrete_batch)
from repro_torch.kernels import segment_spmm as sp
from repro_torch.models.gnn_basic import gin_full_graph
from repro_torch.training import AdamW

STAGES = ("batch", "h2d", "ell", "forward", "backward", "optimizer")
TIMED_STEPS = 2


def _stamp(stamps: list, dev: torch.device) -> None:
    torch.cuda.synchronize(dev)
    stamps.append(time.perf_counter())


def one_step(model, opt, opt_state, info: dict, seed: int,
             dev: torch.device):
    """One training step stage by stage; returns (new optimizer state,
    stage → seconds, stage → segment_spmm launches)."""
    params = dict(model.named_parameters())
    stamps, launches = [time.perf_counter()], {}

    def stage(name):
        _stamp(stamps, dev)
        launches[name] = sp.LAUNCHES.value
        sp.LAUNCHES.reset()

    sp.LAUNCHES.reset()
    host = make_concrete_batch(info, seed=seed, device="cpu")
    stage("batch")
    batch = {k: v.to(dev) for k, v in host.items()}
    stage("h2d")
    ell = sp.ell_pair(batch["src"], batch["dst"], info["nodes"])
    stage("ell")
    logits = gin_full_graph(model, batch["node_feat"], batch["src"],
                            batch["dst"], num_nodes=info["nodes"], ell=ell)
    loss = classification_loss(logits, batch["labels"])
    stage("forward")
    grads = torch.autograd.grad(loss, list(params.values()))
    stage("backward")
    _, opt_state = opt.update(dict(zip(params, grads)), opt_state, params)
    stage("optimizer")
    secs = {k: b - a for k, a, b in zip(STAGES, stamps, stamps[1:])}
    return opt_state, secs, launches


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="repro_torch.bench.profile_train")
    p.add_argument("--out", default=None, help="write the report here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    dev = torch.device("cuda")
    info = SHAPES["ogb_products"]
    model = gin_tu._init(torch.Generator().manual_seed(0), info["d_feat"],
                         info["classes"], "custom", device=dev)
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    opt_state = opt.init(dict(model.named_parameters()))

    opt_state, _, _ = one_step(model, opt, opt_state, info, 0, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    timed = []
    for s in range(TIMED_STEPS):
        opt_state, secs, launches = one_step(model, opt, opt_state, info,
                                             1 + s, dev)
        timed.append(secs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt_state, secs, _ = one_step(model, opt, opt_state, info,
                                      1 + TIMED_STEPS, dev)
        wall = time.perf_counter() - t0
    busy_us, by_name = 0.0, defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            by_name[e.name] += us
    device_wall = wall - secs["batch"]
    report = {
        "card": torch.cuda.get_device_name(0), "shape": info,
        "timed_steps": TIMED_STEPS,
        "stage_p50_ms": {k: statistics.median(t[k] for t in timed) * 1e3
                         for k in STAGES},
        "step_p50_ms": statistics.median(sum(t.values())
                                         for t in timed) * 1e3,
        "segment_spmm_launches": launches,
        "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "profiled_step_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_idle_share_after_batch": 1.0 - busy_us / 1e6 / device_wall,
        "top_device_ms": {name: us / 1e3 for name, us in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:8]},
    }
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
