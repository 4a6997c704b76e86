"""DIN [recsys]: embed_dim 18, seq_len 100, attention MLP 80-40, main MLP
200-80, target attention [arXiv:1706.06978] — the configuration and shapes
of ``src/repro/configs/din.py``.

Shapes: ``train_batch`` (B 65,536 train step: :func:`train_step`),
``serve_p99`` (B 512 online forward), ``serve_bulk`` (B 262,144 offline
scoring) and ``retrieval_cand`` (1 user × 1,000,000 candidates, in chunks
of :data:`RETRIEVAL_CHUNK`).

The item table (10⁷ rows × 18) is the hot path; serving reads it through
the tiered feature store, training updates it as a plain parameter on the
device, as the reference's cell does (``repro_torch.launch.recsys_din``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import Arch, register
from repro_torch.models.din import DIN, DINConfig, din_loss
from repro_torch.training.loop import StageTimer
from repro_torch.training.optimizer import AdamW, AdamWState

CONFIG = DINConfig(n_items=10_000_000, n_cates=10_000, embed_dim=18,
                   hist_len=100, attn_mlp=(80, 40), mlp=(200, 80),
                   n_dense_feat=8)

SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, candidates=1_000_000),
}

# candidates per din_forward call in retrieval scoring (the reference's
# retrieval cell uses this chunk)
RETRIEVAL_CHUNK = 31_250


def train_optimizer() -> AdamW:
    """The reference cell's optimizer: ``AdamW(lr=1e-3,
    weight_decay=0.0)`` (warm-up 100, clipping at norm 1)."""
    return AdamW(lr=1e-3, weight_decay=0.0)


def train_step(model: DIN, opt: AdamW, opt_state: AdamWState, batch: dict,
               cfg: DINConfig = CONFIG, *,
               timer: Optional[StageTimer] = None
               ) -> tuple[AdamWState, torch.Tensor]:
    """The ``train_batch`` cell's step: :func:`~repro_torch.models.din.
    din_loss` on ``batch``, its gradient for every parameter of ``model``
    (the tables included), and one ``opt`` update in place. Returns the
    new state and the loss. With ``timer``, the stages ``forward``,
    ``backward`` and ``optimizer`` are timed (a device synchronize
    after each)."""
    params = dict(model.named_parameters())
    if timer:
        timer.start()
    loss = din_loss(model, cfg, batch)
    if timer:
        timer.lap("forward")
    grads = torch.autograd.grad(loss, list(params.values()))
    if timer:
        timer.lap("backward")
    _, opt_state = opt.update(dict(zip(params, grads)), opt_state, params)
    if timer:
        timer.lap("optimizer")
    return opt_state, loss.detach()


ARCH = register(Arch(
    name="din", family="recsys",
    description="Deep Interest Network: target attention over user history, "
                "10M-row item table through the tiered store."))
