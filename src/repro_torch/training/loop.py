"""Fault-tolerant training loop (``src/repro/training/loop.py``):

* deterministic per-step batches (restart-safe: step n always sees batch n);
* periodic checkpoints (async when the manager is) and resume from the
  latest durable step;
* the reference's loss/throughput log line.

PyTorch runs eagerly, so there is no ``jit``; the loop trains a copy of
the caller's model, as the reference never consumes the caller's
(donated) parameters.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import AdamW, AdamWState


class StageTimer:
    """Milliseconds per named stage of a step on the host clock, each
    stage ended by a synchronize of every device given (so their work is
    inside it). ``start()`` opens a step; ``lap(name)`` closes the running
    stage and adds it to ``ms[name]``."""

    def __init__(self, device: torch.device | Sequence[torch.device]):
        devices = ([device] if isinstance(device, (str, torch.device))
                   else list(device))
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.ms: dict[str, float] = {}
        self._t = 0.0

    def _now(self) -> float:
        for dev in self.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return time.perf_counter()

    def start(self) -> None:
        self._t = self._now()

    def lap(self, name: str) -> None:
        now = self._now()
        self.ms[name] = self.ms.get(name, 0.0) + (now - self._t) * 1e3
        self._t = now


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt_state: AdamWState
    step: int


def make_train_step(loss_fn: Callable, opt: AdamW) -> Callable:
    """``step(model, opt_state, batch) -> (model, opt_state, loss)``: the
    loss ``loss_fn(model, batch)``, its gradient for every parameter, and
    one optimizer update in place."""
    def step(model, opt_state, batch):
        params = dict(model.named_parameters())
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        _, opt_state = opt.update(dict(zip(params, grads)), opt_state, params)
        return model, opt_state, loss.detach()

    return step


def _tree(model: nn.Module, opt_state: AdamWState) -> dict:
    return {"params": model.state_dict(),
            "opt": {"step": opt_state.step, "mu": opt_state.mu,
                    "nu": opt_state.nu}}


def run_training(*, loss_fn: Callable, model: nn.Module, opt: AdamW,
                 batch_fn: Callable[[int], dict], steps: int,
                 ckpt: Optional[CheckpointManager] = None,
                 ckpt_every: int = 50, log_every: int = 10,
                 log_fn: Callable[[str], None] = print) -> TrainState:
    """Train a copy of ``model`` for ``steps`` steps (resuming from
    ``ckpt``'s latest step when it has one); step ``s`` trains on
    ``batch_fn(s)``. Logs the mean loss every ``log_every`` steps, saves
    every ``ckpt_every`` steps and at the end."""
    model = copy.deepcopy(model)
    opt_state = opt.init(dict(model.named_parameters()))
    start = 0
    if ckpt is not None:
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest, _tree(model, opt_state))
            model.load_state_dict(state["params"])
            opt_state = AdamWState(**state["opt"])
            start = latest
            log_fn(f"[resume] restored step {latest}")
    step_fn = make_train_step(loss_fn, opt)
    t0 = time.perf_counter()
    losses = []
    for s in range(start, steps):
        batch = batch_fn(s)  # deterministic per-step → restart-safe
        model, opt_state, loss = step_fn(model, opt_state, batch)
        losses.append(loss)
        if (s + 1) % log_every == 0:
            mean = float(torch.stack(losses).mean())
            dt = time.perf_counter() - t0
            log_fn(f"step {s+1}/{steps} loss={mean:.4f} "
                   f"steps/s={log_every/dt:.2f}")
            losses, t0 = [], time.perf_counter()
        if ckpt is not None and (s + 1) % ckpt_every == 0:
            ckpt.save(s + 1, _tree(model, opt_state),
                      metadata={"loss": float(loss)}, block=False)
    if ckpt is not None:
        ckpt.save(steps, _tree(model, opt_state), block=True)
        ckpt.wait()
    return TrainState(model=model, opt_state=opt_state, step=steps)
