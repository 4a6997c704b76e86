"""AdamW with linear warm-up and global-norm clipping — the reference's own
math (``src/repro/training/optimizer.py::AdamW``), not
``torch.optim.AdamW``, whose schedule, clipping and decay differ:

* learning rate ``lr · min(step / warmup_steps, 1)``;
* gradients scaled by ``min(1, clip_norm / (‖g‖₂ + 1e-9))`` over all
  parameters together;
* ``m ← b1·m + (1-b1)·g``, ``v ← b2·v + (1-b2)·g²`` in fp32;
* ``u = (m / (1-b1ᵗ)) / (sqrt(v / (1-b2ᵗ)) + eps) + weight_decay · p``
  (decay added to the update, before the learning rate), ``p ← p - lr·u``.

Parameters are named tensors (``dict(model.named_parameters())``). The
update writes them, and the state's ``mu``/``nu``, in place under
``torch.no_grad``, one tensor at a time — the reference returns new
arrays. In place keeps the model's own tensors and holds at most a few
temporaries the size of the largest tensor beside them, where new arrays
would take a second copy of every gradient (the clipped ones) and of the
state: at qwen3-4b's 4.4B parameters that is +17.65 GB and +35.3 GB on top
of the 70.58 GB of fp32 weights, gradients and state. The operations and
their order are the reference's, so the bits are those of an out-of-place
update. A caller that keeps a state across an update sees it change
(``CheckpointManager.save`` copies the leaves to the host before it
returns).

On a mesh the same update runs on each shard's blocks (``update``'s
``(shard, name)`` keys, :func:`repro_torch.configs.lm_common.train_step`):
each shard updates its block of the FSDP layout with its own mu and nu —
the ZeRO-1 step of the reference's dense ``train_4k`` cell, or the full
FSDP one of its MoE cell, where that block is the shard's whole weight
block.

The int8 error-feedback gradient compression (:func:`compress_int8`,
:func:`compressed_grad_tree` and their inverses) is the reference's: as
there, only tests call it; no step does.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    step: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100

    def init(self, params: dict[str, torch.Tensor]) -> AdamWState:
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return AdamWState(step=0, mu=zeros,
                          nu={k: z.clone() for k, z in zeros.items()})

    def schedule(self, step: int) -> float:
        return self.lr * min(step / max(self.warmup_steps, 1), 1.0)

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict, *,
               norm_keys: Optional[Iterable] = None
               ) -> tuple[dict, AdamWState]:
        """One step. Writes ``params`` and ``state.mu``/``state.nu`` in
        place, tensor by tensor, and returns them with the step count
        advanced; ``grads`` are read, never written.

        The keys are parameter names, or on a mesh ``(shard, name)``: each
        shard's block of a parameter (a view into its weight), of its
        gradient and of its state, each on the shard's device. The clipping
        norm then counts each distinct block once: ``norm_keys`` names
        those (default: every key), in the order their squares are summed;
        the one clipping scale is moved to each block's device."""
        step = state.step + 1
        scale = None
        if self.clip_norm is not None:
            keys = grads if norm_keys is None else norm_keys
            scale = torch.clamp(self.clip_norm
                                / (global_norm(grads[k] for k in keys)
                                   + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step
        bc2 = 1 - b2 ** step
        lr = self.schedule(step)
        for k, p in params.items():
            g = grads[k]
            if scale is not None:
                g = g * scale.to(g.device)
            g = g.float()
            mu, nu = state.mu[k], state.nu[k]
            # m ← b1·m + (1-b1)·g;  v ← b2·v + (1-b2)·g²
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            del g
            # u = (m/bc1) / (sqrt(v/bc2) + eps) + wd·p;  p ← p - lr·u
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            u.add_(self.weight_decay * p.float())
            p.copy_((p.float() - u.mul_(lr)).to(p.dtype))
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ ‖t‖²)`` over all tensors, in fp32, summed in their order
    on the first tensor's device."""
    total, dev = 0, None
    for t in tensors:
        sq = torch.sum(torch.square(t.float()))
        dev = sq.device if dev is None else dev
        total = total + sq.to(dev)
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# Int8 error-feedback gradient compression: quantize per tensor before a
# data-parallel reduction, keep the quantization residual and re-inject it
# next step (4x fewer bytes on the wire than fp32).
# ---------------------------------------------------------------------------
def compress_int8(g: torch.Tensor, err: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(q int8, scale fp32 scalar, new_err)`` for the gradient ``g``
    plus the carried residual ``err``, in the reference's expressions:
    ``gc = g + err`` and ``scale = max|gc| / 127 + 1e-12`` in fp32, ``q =
    clip(round(gc / scale), ±127)`` (round half to even), ``new_err = gc
    − q·scale``."""
    gc = g.float() + err
    scale = gc.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(gc / scale), -127, 127).to(torch.int8)
    return q, scale, gc - q.float() * scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_grad_tree(grads: dict[str, torch.Tensor],
                         err_tree: dict[str, torch.Tensor]
                         ) -> tuple[dict, dict, dict]:
    """:func:`compress_int8` over named gradients: ``(q, scales,
    new_errs)``, each keyed as ``grads``."""
    out = {k: compress_int8(g, err_tree[k]) for k, g in grads.items()}
    return tuple({k: v[i] for k, v in out.items()} for i in range(3))


def decompress_grad_tree(q_tree: dict[str, torch.Tensor],
                         s_tree: dict[str, torch.Tensor]
                         ) -> dict[str, torch.Tensor]:
    return {k: decompress_int8(q, s_tree[k]) for k, q in q_tree.items()}

