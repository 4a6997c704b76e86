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
update writes them in place under ``torch.no_grad`` — the reference
returns new arrays; in place keeps the model's own tensors and saves a
copy of each. Not ported: the int8 gradient-compression helpers (they come
with data parallelism, ROADMAP A10b).
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
    def update(self, grads: dict[str, torch.Tensor], state: AdamWState,
               params: dict[str, torch.Tensor]
               ) -> tuple[dict[str, torch.Tensor], AdamWState]:
        """One step. Writes ``params`` in place and returns them with the
        new state."""
        step = state.step + 1
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm
                                / (global_norm(grads.values()) + 1e-9),
                                max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step
        bc2 = 1 - b2 ** step
        lr = self.schedule(step)
        mu, nu = {}, {}
        for k, p in params.items():
            g = grads[k].float()
            mu[k] = b1 * state.mu[k] + (1 - b1) * g
            nu[k] = b2 * state.nu[k] + (1 - b2) * torch.square(g)
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            p.copy_((p.float() - lr * u).to(p.dtype))
        return params, AdamWState(step=step, mu=mu, nu=nu)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ ‖t‖²)`` over all tensors, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))

