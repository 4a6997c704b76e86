"""Where a step of the two train cells' time goes on the card.

    PYTHONPATH=src python -m repro_torch.bench.profile_train_cells \\
        [--cell lm|din] [--arch qwen3-4b] [--mesh-world W --model M] \\
        [--out profile_train_cells.json]

Each cell is built by its launcher's ``train_cell``. ``lm`` is ``--arch``
(qwen3-4b by default) ``train_4k`` as ``repro_torch.launch.lm --shape
train_4k`` runs it (published widths and depth, fp32 weights and AdamW
state, bf16 activations, B 1, 4,096 positions); with ``--mesh-world W
[--model M]`` on that launcher's ``("data", "model")`` mesh (one shard a
card, round-robin past the cards; its default batch and micro-batches;
a dense arch by ZeRO-1, an MoE arch such as deepseek-moe-16b by full
FSDP), the stages adding the data-axis sum (``data_sum``) and, for a
dense arch, the ZeRO-1 gather (``gather``), and the report each card's
busy time and busy share of the profiled step (the idle shares are then
of all the cards' time). ``din``
is DIN ``train_batch`` as ``repro_torch.launch.recsys_din --config din
--train-steps`` runs it (B 65,536, history 100, 10M items). Each step's
batch is drawn first (DIN's on the host, as the launcher draws it, then
copied) and the step timed apart from it. Step 0 warms up; the next
``TIMED_STEPS`` steps give the stage times (forward, backward, optimizer:
the launchers' ``StageTimer``, median); one more step runs under
``torch.profiler`` for the device's busy time, its idle share over that
step's stages (``1 - busy / wall``; the profiler's own host cost in each
op's issue inflates it where ops are many and small) and over the median
unprofiled step (``1 - busy / step_p50``), and the device time of the
costliest kernels. Prints one JSON object and, with ``--out``, writes it
to that file. Needs a CUDA device.
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

from repro_torch.launch import lm, recsys_din
from repro_torch.training import StageTimer

TIMED_STEPS = 2
TOP = 12


def _cell(name: str, *, arch: str = "qwen3-4b", mesh_world: int = 1,
          model: int | None = None):
    """(model, draw() -> batch, step(batch, timer) -> loss) of the cell,
    built by its launcher."""
    if name == "lm":
        argv = ["--arch", arch, "--shape", "train_4k", "--mesh-world",
                str(mesh_world)]
        if mesh_world == 1:
            argv += ["--batch", "1"]
        if model is not None:
            argv += ["--model", str(model)]
        cell, _, draw, step = lm.train_cell(lm.parse_args(argv))
        return cell, draw, step
    return recsys_din.train_cell("din")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="repro_torch.bench.profile_train_cells")
    p.add_argument("--cell", default="lm", choices=["lm", "din"])
    p.add_argument("--arch", default="qwen3-4b", help="lm: the arch")
    p.add_argument("--mesh-world", type=int, default=1,
                   help="lm: shards of the train mesh")
    p.add_argument("--model", type=int, default=None,
                   help="lm: the mesh's model axis (default --mesh-world)")
    p.add_argument("--out", default=None, help="write the report here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_cells needs a CUDA device")
    dev = torch.device("cuda")
    model, draw, step = _cell(args.cell, arch=args.arch,
                              mesh_world=args.mesh_world, model=args.model)
    devices = (lm.train_devices(model) if args.cell == "lm" else [dev])
    step(draw(), StageTimer(devices))
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
    timed, losses = [], []
    for _ in range(TIMED_STEPS):
        timer = StageTimer(devices)
        losses.append(float(step(draw(), timer)))
        timed.append(timer.ms)
    timer = StageTimer(devices)
    batch = draw()
    for d in devices:
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses.append(float(step(batch, timer)))
        wall = time.perf_counter() - t0
    busy_us, by_name = 0.0, defaultdict(float)
    by_card = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            by_name[e.name] += us
            by_card[e.device_index] += us
    stage_wall = sum(timer.ms.values()) / 1e3
    n = len(devices)        # the idle shares are of every card's time
    step_p50 = statistics.median(sum(t.values()) for t in timed)
    report = {
        "card": torch.cuda.get_device_name(0), "cell": args.cell,
        "arch": args.arch if args.cell == "lm" else None,
        "mesh_world": args.mesh_world, "model": args.model,
        "params": sum(x.numel() for x in model.parameters()),
        "timed_steps": TIMED_STEPS, "losses": losses,
        "stage_p50_ms": {k: statistics.median(t[k] for t in timed)
                         for k in timed[0]},
        "step_p50_ms": step_p50,
        "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "card_peak_bytes": [torch.cuda.max_memory_allocated(d)
                            for d in devices],
        "profiled_step_ms": wall * 1e3,
        "profiled_stage_ms": timer.ms,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / stage_wall / n,
        "device_idle_share_of_p50_step": (1.0 - busy_us / 1e3 / step_p50
                                          / n),
        "card_busy_ms": {str(i): us / 1e3 for i, us in
                         sorted(by_card.items())},
        "card_busy_share": {str(i): us / 1e6 / stage_wall for i, us in
                            sorted(by_card.items())},
        "top_device_ms": {name: us / 1e3 for name, us in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]},
    }
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
