"""DIN [recsys]: embed_dim 18, seq_len 100, attention MLP 80-40, main MLP
200-80, target attention [arXiv:1706.06978] — the configuration and shapes
of ``src/repro/configs/din.py``.

Shapes: ``serve_p99`` (B 512 online forward), ``serve_bulk`` (B 262,144
offline scoring), ``retrieval_cand`` (1 user × 1,000,000 candidates, in
chunks of :data:`RETRIEVAL_CHUNK`) and ``train_batch`` (B 65,536 train
step — not ported: it needs ``din_loss`` and a backward, which come with
the training slice).

The item table (10⁷ rows × 18) is the hot path; it is served through the
tiered feature store (``repro_torch.launch.recsys_din``).
"""
from __future__ import annotations

from repro_torch.configs.base import Arch, register
from repro_torch.models.din import DINConfig

CONFIG = DINConfig(n_items=10_000_000, n_cates=10_000, embed_dim=18,
                   hist_len=100, attn_mlp=(80, 40), mlp=(200, 80),
                   n_dense_feat=8)

SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, candidates=1_000_000),
}

# shapes whose path the port does not run yet, and why
NOT_PORTED = {"train_batch": "needs din_loss and a backward (training)"}

# candidates per din_forward call in retrieval scoring (the reference's
# retrieval cell uses this chunk)
RETRIEVAL_CHUNK = 31_250

ARCH = register(Arch(
    name="din", family="recsys",
    description="Deep Interest Network: target attention over user history, "
                "10M-row item table through the tiered store."))
