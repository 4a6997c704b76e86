"""Plain PyTorch reference of GraphSAGE (mean aggregator) over one layered
sample, as ``servebench/reference/<arch>.py`` for ``"arch": "sage"``.

It imports nothing of the program; the sample's rules and the collected
rows are ``servebench/reference/sample.py``'s. Model (one layer ℓ at
every remaining hop level, the last without relu):

    agg  = Σ_{valid children} x_child / max(#valid children, 1)
    h'   = LayerNorm(x_self · W_self + b_self + agg · W_neigh + b_neigh)

:func:`embed` with ``tf32=True`` is the control: the same equations with
every matrix product's operands rounded to TF32.
"""
from __future__ import annotations

from typing import Sequence

import torch

from servebench.reference.sample import round_tf32, rows

LN_EPS = 1e-5


def _linear(x, w, b, tf32: bool):
    if tf32:
        x, w = round_tf32(x), round_tf32(w)
    return x @ w + b


def embed(weights: dict, feats: torch.Tensor,
          hops: Sequence[torch.Tensor], fanouts: Sequence[int], *,
          tf32: bool = False) -> torch.Tensor:
    """GraphSAGE over one layered sample; returns the seed rows
    ``(len(hops[0]), d_out)``. ``weights`` holds ``{"layers": [{"self":
    {w, b}, "neigh": {w, b}, "ln": {g, b}}]}`` as tensors on ``feats``'
    device, ``w`` as ``(d_in, d_out)``."""
    dev = feats.device
    ids = [h.to(dev).long() for h in hops]
    h = [rows(feats, i) for i in ids]
    masks = [(i >= 0).to(torch.float32)[:, None] for i in ids]
    layers = weights["layers"]
    L = len(layers)
    for li, p in enumerate(layers):
        nxt = []
        for lvl in range(L - li):
            fan = fanouts[lvl]
            parents = h[lvl].shape[0]
            m = masks[lvl + 1].view(parents, fan, 1)
            child = h[lvl + 1].view(parents, fan, -1)
            agg = (child * m).sum(1) / m.sum(1).clamp_min(1.0)
            z = (_linear(h[lvl], p["self"]["w"], p["self"]["b"], tf32)
                 + _linear(agg, p["neigh"]["w"], p["neigh"]["b"], tf32))
            mu = z.mean(-1, keepdim=True)
            var = ((z - mu) ** 2).mean(-1, keepdim=True)
            z = (z - mu) / torch.sqrt(var + LN_EPS) * p["ln"]["g"] \
                + p["ln"]["b"]
            nxt.append(z if li == L - 1 else torch.relu(z))
        h = nxt
    return h[0]


def weights_on(weights_np: dict, device: torch.device) -> dict:
    """The numpy weight tree as float32 tensors on ``device``."""
    t = (lambda a: torch.as_tensor(a, dtype=torch.float32, device=device))
    return {"layers": [{k: {kk: t(vv) for kk, vv in v.items()}
                        for k, v in layer.items()}
                       for layer in weights_np["layers"]]}
