"""Deep Interest Network (arXiv:1706.06978): the serving forward and the
training loss.

Port of ``src/repro/models/din.py``: embed_dim 18, history length 100,
attention MLP 80-40 (sigmoid), main MLP 200-80 (silu), target attention.
The item-embedding table is the hot path; :func:`din_forward` takes an
``item_lookup`` hook through which the tiered feature store serves it.

Both reductions over the user history — the attention-weighted interest
sum and the masked history mean — are one ``embedding_bag`` kernel launch
each: the gathered history ``(B, T, 2d)`` is viewed as a ``(B·T, 2d)``
table and bag ``b`` holds ids ``b·T + t`` for its valid slots (``-1``
elsewhere). The bags go through the ``embedding_bag`` autograd Function
(:func:`~repro_torch.kernels.embedding_bag.ops.embedding_bag_autograd`):
the forward launches the kernel, and the backward gives the history rows
and the attention scores their gradients, so :func:`din_loss` trains
through the same two launches a batch that serving makes.

:func:`din_logits` is the differentiable forward; :func:`din_forward`
(serving) is it under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models.common import mlp_from_numpy, mlp_init, to_device


@dataclasses.dataclass(frozen=True)
class DINConfig:
    n_items: int = 200_000
    n_cates: int = 2_000
    embed_dim: int = 18
    hist_len: int = 100
    attn_mlp: tuple[int, ...] = (80, 40)
    mlp: tuple[int, ...] = (200, 80)
    n_dense_feat: int = 4


class DIN(nn.Module):
    """Item and category tables, attention MLP (sigmoid) and main MLP
    (silu); both MLPs end in one un-squashed unit. The tables are
    parameters like the rest (the reference's train cell updates them);
    serving reads them under ``torch.no_grad``."""

    def __init__(self, item_embed: torch.Tensor, cate_embed: torch.Tensor,
                 attn: nn.Module, mlp: nn.Module):
        super().__init__()
        self.item_embed = nn.Parameter(item_embed)
        self.cate_embed = nn.Parameter(cate_embed)
        self.attn = attn
        self.mlp = mlp


def _dims(cfg: DINConfig) -> tuple[list[int], list[int]]:
    de = 2 * cfg.embed_dim                  # item ⊕ category
    attn_in = 4 * de                        # [hist, target, h-t, h*t]
    mlp_in = 3 * de + cfg.n_dense_feat      # interest ⊕ target ⊕ hist mean
    return [attn_in, *cfg.attn_mlp, 1], [mlp_in, *cfg.mlp, 1]


def din_init(generator: torch.Generator, cfg: DINConfig, *,
             device: str | torch.device = "cuda") -> DIN:
    """Random weights drawn on the CPU from ``generator`` in the
    reference's order (item table, category table, attention MLP, main
    MLP; tables ``N(0, 0.05²)``), then moved to ``device``."""
    dev = resolve_device(device)
    d = cfg.embed_dim
    item = torch.randn((cfg.n_items, d), generator=generator) * 0.05
    cate = torch.randn((cfg.n_cates, d), generator=generator) * 0.05
    attn_dims, mlp_dims = _dims(cfg)
    model = DIN(item, cate, mlp_init(generator, attn_dims, act=torch.sigmoid),
                mlp_init(generator, mlp_dims, act=F.silu))
    return to_device(model, dev).eval()


def din_from_numpy(params_np: dict, device: str | torch.device = "cuda"
                   ) -> DIN:
    """Carry the reference's ``din_init`` tree, as numpy arrays
    (``{"item_embed", "cate_embed", "attn": [{w, b}], "mlp": [{w, b}]}``),
    into a :class:`DIN` on ``device``."""
    model = DIN(torch.tensor(np.asarray(params_np["item_embed"], np.float32)),
                torch.tensor(np.asarray(params_np["cate_embed"], np.float32)),
                mlp_from_numpy(params_np["attn"], act=torch.sigmoid),
                mlp_from_numpy(params_np["mlp"], act=F.silu))
    return model.to(resolve_device(device)).eval()


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, *,
                  mode: str = "sum") -> torch.Tensor:
    """The model's EmbeddingBag (``repro.models.din.embedding_bag``):
    ids ``(..., bag)`` with ``-1`` padding → ``(..., d)``. Its weighted
    mean divides by ``max(Σ valid·w, 1)`` — unlike the kernel's, which
    divides by the valid count — so it is the kernel's weighted sum over
    that divisor."""
    lead, bag = tuple(ids.shape[:-1]), int(ids.shape[-1])
    ids2 = ids.reshape(-1, bag).to(torch.int32).contiguous()
    w2 = (weights.reshape(-1, bag).to(table.dtype).contiguous()
          if weights is not None else None)
    out = bag_ops.embedding_bag(table, ids2, w2, mode="sum")
    if mode == "mean":
        w = (ids2 >= 0).to(table.dtype)
        if w2 is not None:
            w = w * w2
        out = out / w.sum(-1, keepdim=True).clamp_min(1.0)
    return out.reshape(lead + (table.shape[1],))


def _embed_pair(model: DIN, item_ids: torch.Tensor, cate_ids: torch.Tensor,
                lookup: Optional[Callable] = None) -> torch.Tensor:
    """item ⊕ category embedding; ``lookup`` overrides the item-table
    gather (where the tiered feature store plugs in).

    The tables are read by ``F.embedding``: the same rows as indexing,
    and in training its backward sums a row's many slots (a Zipf-hot
    item is ~1/6 of a batch's history) in parallel segments, where
    indexing's accumulating ``index_put_`` adds them one after another
    (PERF.md, §5)."""
    if lookup is not None:
        it = lookup(item_ids)
    else:
        it = F.embedding(item_ids.long().clamp_min(0), model.item_embed)
        it = torch.where((item_ids >= 0)[..., None], it, 0.0)
    ct = F.embedding(cate_ids.long().clamp_min(0), model.cate_embed)
    ct = torch.where((cate_ids >= 0)[..., None], ct, 0.0)
    return torch.cat([it, ct], dim=-1)


def din_logits(model: DIN, cfg: DINConfig, target_item: torch.Tensor,
               target_cate: torch.Tensor, hist_items: torch.Tensor,
               hist_cates: torch.Tensor, dense_feat: torch.Tensor, *,
               item_lookup: Optional[Callable] = None) -> torch.Tensor:
    """target_*: ``(B,)``; hist_*: ``(B, T)`` with ``-1`` padding; dense:
    ``(B, F)`` → ``(B,)`` CTR logits, differentiable in every parameter.
    ``cfg`` is kept for the reference's signature; the widths come from
    ``model``."""
    tgt = _embed_pair(model, target_item, target_cate, item_lookup)  # (B,de)
    hist = _embed_pair(model, hist_items, hist_cates, item_lookup)   # (B,T,de)
    mask = hist_items >= 0
    bsz, t_len, de = hist.shape

    t = tgt[:, None, :].to(hist.dtype).expand_as(hist)
    a_in = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    scores = model.attn(a_in)[..., 0]                                # (B, T)
    scores = torch.where(mask, scores, 0.0)
    # the history as a (B·T, de) table, bag b = its valid slots; the item
    # mask decides validity (category rows of item-padded slots are not 0)
    table = hist.reshape(bsz * t_len, de)
    slots = torch.arange(bsz * t_len, dtype=torch.int32,
                         device=hist.device).reshape(bsz, t_len)
    ids = torch.where(mask, slots, -1)
    interest = bag_ops.embedding_bag_autograd(
        table, ids, scores.to(table.dtype), mode="sum")              # (B, de)
    hist_mean = bag_ops.embedding_bag_autograd(table, ids, None, mode="mean")

    x = torch.cat([interest, tgt, hist_mean, dense_feat], dim=-1)
    return model.mlp(x)[..., 0]


@torch.no_grad()
def din_forward(model: DIN, cfg: DINConfig, target_item: torch.Tensor,
                target_cate: torch.Tensor, hist_items: torch.Tensor,
                hist_cates: torch.Tensor, dense_feat: torch.Tensor, *,
                item_lookup: Optional[Callable] = None) -> torch.Tensor:
    """Serving: :func:`din_logits` under ``torch.no_grad``."""
    return din_logits(model, cfg, target_item, target_cate, hist_items,
                      hist_cates, dense_feat, item_lookup=item_lookup)


def din_loss(model: DIN, cfg: DINConfig, batch: dict,
             item_lookup: Optional[Callable] = None) -> torch.Tensor:
    """The reference's ``din_loss``: the mean over the batch of the
    logistic loss ``max(z, 0) - z·y + log1p(exp(-|z|))`` in fp32, ``z``
    the :func:`din_logits` of ``batch`` (``target_item``,
    ``target_cate``, ``hist_items``, ``hist_cates``, ``dense_feat``) and
    ``y`` its ``label``."""
    logits = din_logits(model, cfg, batch["target_item"],
                        batch["target_cate"], batch["hist_items"],
                        batch["hist_cates"], batch["dense_feat"],
                        item_lookup=item_lookup)
    y = batch["label"].float()
    z = logits.float()
    return torch.mean(torch.clamp_min(z, 0) - z * y
                      + torch.log1p(torch.exp(-z.abs())))


@torch.no_grad()
def din_score_candidates(model: DIN, cfg: DINConfig,
                         user_hist_items: torch.Tensor,
                         user_hist_cates: torch.Tensor,
                         dense_feat: torch.Tensor, cand_items: torch.Tensor,
                         cand_cates: torch.Tensor, *,
                         chunk: int = 65536) -> torch.Tensor:
    """Retrieval scoring: one user's history vs N candidates through the
    full DIN tower, in candidate chunks of ``chunk`` (the last padded with
    id 0, as the reference pads, and the tail dropped).

    user_hist_*: ``(T,)``; dense_feat: ``(F,)``; cand_*: ``(N,)``.
    Returns ``(N,)`` scores.
    """
    n = int(cand_items.shape[0])
    chunks = -(-n // chunk)
    if chunks == 0:
        return dense_feat.new_zeros((0,))
    pad = chunks * chunk - n
    ci = F.pad(cand_items, (0, pad), value=0).reshape(chunks, chunk)
    cc = F.pad(cand_cates, (0, pad), value=0).reshape(chunks, chunk)
    hist_i = user_hist_items[None].expand(chunk, -1)
    hist_c = user_hist_cates[None].expand(chunk, -1)
    dense = dense_feat[None].expand(chunk, -1)
    scores = [din_forward(model, cfg, ci[k], cc[k], hist_i, hist_c, dense)
              for k in range(chunks)]
    return torch.cat(scores)[:n]
