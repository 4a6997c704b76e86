"""Dense and layer-norm building blocks, and their conversion from the
reference's parameter dicts.

Layouts differ: the reference's ``dense`` computes ``x @ w + b`` with ``w``
shaped ``(d_in, d_out)``, while ``nn.Linear`` stores ``weight`` as
``(d_out, d_in)``, so :func:`dense_from_numpy` transposes. The reference's
``layer_norm`` keys are ``g``/``b``, eps 1e-5, biased variance — what
``nn.LayerNorm(dim, eps=1e-5)`` computes.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

LN_EPS = 1e-5


def dense_init(generator: torch.Generator, d_in: int, d_out: int) -> nn.Linear:
    """``nn.Linear`` initialised like the reference's ``dense_init``:
    weights ``N(0, 1/d_in)``, zero bias. Drawn on the CPU from
    ``generator``, so one seed gives the same weights on any device."""
    lin = nn.Linear(d_in, d_out)
    with torch.no_grad():
        lin.weight.copy_(torch.randn((d_out, d_in), generator=generator)
                         / math.sqrt(d_in))
        lin.bias.zero_()
    return lin


def layer_norm_init(dim: int) -> nn.LayerNorm:
    """The reference's ``layer_norm``: unit gain, zero bias, eps 1e-5."""
    return nn.LayerNorm(dim, eps=LN_EPS)


def dense_from_numpy(p: dict) -> nn.Linear:
    """``{"w": (d_in, d_out), "b": (d_out,)}`` → ``nn.Linear``."""
    w = np.asarray(p["w"], dtype=np.float32)
    lin = nn.Linear(w.shape[0], w.shape[1], bias="b" in p)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(w.T))
        if "b" in p:
            lin.bias.copy_(torch.tensor(np.asarray(p["b"], np.float32)))
    return lin


def layer_norm_from_numpy(p: dict) -> nn.LayerNorm:
    """``{"g": (dim,), "b": (dim,)}`` → ``nn.LayerNorm`` (eps 1e-5)."""
    g = np.asarray(p["g"], dtype=np.float32)
    ln = nn.LayerNorm(g.shape[0], eps=LN_EPS)
    with torch.no_grad():
        ln.weight.copy_(torch.tensor(g))
        ln.bias.copy_(torch.tensor(np.asarray(p["b"], np.float32)))
    return ln
