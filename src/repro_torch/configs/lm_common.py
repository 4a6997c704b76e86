"""Shapes of the LM serving and training cells, the smoke reduction and the
``train_4k`` cell's step of ``src/repro/configs/lm_common.py``, without its
sharding machinery.

Shapes (per assignment):
  train_4k    — train_step,  seq 4096,   global_batch 256
  prefill_32k — serve prefill, seq 32768, global_batch 32
  decode_32k  — serve decode (1 new token, 32k KV cache), batch 128
  long_500k   — serve decode, 524288 KV cache, batch 1
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.transformer import LM, LMConfig, lm_loss
from repro_torch.training.loop import StageTimer
from repro_torch.training.optimizer import AdamW, AdamWState

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def smoke_config(cfg: LMConfig) -> LMConfig:
    """``lm_smoke``'s reduction: vocab 512, d 64, 2 layers, 4 heads, kv
    ``max(1, 4·kv/H)``, head_dim 16, fp32; d_ff 128, or with MoE d_ff 0 and
    at most 8 experts, top-k at most 2, expert d_ff 64 and, with shared
    experts, d_ff_shared 64."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, num_experts=min(moe.num_experts, 8),
                                  top_k=min(moe.top_k, 2), d_ff=64,
                                  d_ff_shared=64 if moe.n_shared else 0)
    return dataclasses.replace(
        cfg, vocab=512, d_model=64, n_layers=2, n_heads=4,
        n_kv=max(1, 4 * cfg.n_kv // cfg.n_heads), head_dim=16,
        d_ff=128 if moe is None else 0, moe=moe, dtype="float32")


# blockwise_attention's chunks at the smoke reduction (lm_smoke's q_chunk
# and kv_chunk; the port's LMConfig does not carry them)
SMOKE_CHUNKS = dict(q_chunk=32, kv_chunk=32)


def train_optimizer() -> AdamW:
    """The ``train_4k`` cell's optimizer: ``AdamW(lr=3e-4)`` (weight
    decay 0.1, warm-up 100, clipping at norm 1)."""
    return AdamW(lr=3e-4)


def train_step(model: LM, opt: AdamW, opt_state: AdamWState, batch: dict,
               cfg: LMConfig, *, micro: int = 1,
               chunks: Optional[dict] = None,
               timer: Optional[StageTimer] = None
               ) -> tuple[AdamWState, torch.Tensor]:
    """The ``train_4k`` cell's step on ``batch`` (``tokens``, ``targets``:
    ``(B, S)``), then one ``opt`` update of ``model`` in place.

    With ``micro == 1``: ``lm_loss`` and its gradient. With ``micro > 1``
    (``B % micro == 0``): the reference's micro path — ``lm_loss`` of
    each ``B/micro``-row micro-batch in order, their gradients summed from
    zero in each parameter's ``.grad`` (in place), divided by ``micro``,
    and the loss the mean of the micro losses. ``chunks``: the
    ``q_chunk``/``kv_chunk`` of ``lm_loss`` (its defaults when None).
    With ``timer``, the stages ``forward``, ``backward`` (summed over
    micro-batches) and ``optimizer`` are timed. The gradients are released
    after the update. Returns the new state and the loss."""
    tokens, targets = batch["tokens"], batch["targets"]
    b = tokens.shape[0]
    if micro < 1 or b % micro:
        raise ValueError(f"batch {b} does not split into {micro} "
                         "micro-batches")
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None if micro == 1 else torch.zeros_like(p)
    mb = b // micro
    losses = []
    if timer:
        timer.start()
    for i in range(micro):
        rows = slice(i * mb, (i + 1) * mb)
        loss = lm_loss(model, tokens[rows], targets[rows], cfg,
                       **(chunks or {}))
        if timer:
            timer.lap("forward")
        loss.backward()
        if timer:
            timer.lap("backward")
        losses.append(loss.detach())
    grads = {k: p.grad for k, p in params.items()}
    if micro > 1:
        for g in grads.values():
            g.div_(micro)
    loss = losses[0] if micro == 1 else torch.stack(losses).mean()
    _, opt_state = opt.update(grads, opt_state, params)
    for p in params.values():
        p.grad = None
    if timer:
        timer.lap("optimizer")
    return opt_state, loss
