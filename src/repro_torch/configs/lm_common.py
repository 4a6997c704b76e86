"""Shapes of the LM serving and training cells and the smoke reduction of
``src/repro/configs/lm_common.py``, without its cell, sharding and
optimizer machinery.

Shapes (per assignment):
  train_4k    — train_step,  seq 4096,   global_batch 256
  prefill_32k — serve prefill, seq 32768, global_batch 32
  decode_32k  — serve decode (1 new token, 32k KV cache), batch 128
  long_500k   — serve decode, 524288 KV cache, batch 1
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import LMConfig

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
