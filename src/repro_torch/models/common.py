"""Dense, layer-norm, RMS-norm and MLP building blocks, and their
conversion from the reference's parameter dicts.

Layouts differ: the reference's ``dense`` computes ``x @ w + b`` with ``w``
shaped ``(d_in, d_out)``, while ``nn.Linear`` stores ``weight`` as
``(d_out, d_in)``, so :func:`dense_from_numpy` transposes. The reference's
``layer_norm`` keys are ``g``/``b``, eps 1e-5, biased variance — what
``nn.LayerNorm(dim, eps=1e-5)`` computes. Its ``rms_norm`` (eps 1e-6)
computes in fp32 whatever the input type and casts back.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5
RMS_EPS = 1e-6


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = True) -> nn.Linear:
    """``nn.Linear`` initialised like the reference's ``dense_init``:
    weights ``N(0, 1/d_in)``, zero bias (none with ``bias=False``). Drawn
    on the CPU from ``generator``, so one seed gives the same weights on
    any device."""
    lin = nn.Linear(d_in, d_out, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(torch.randn((d_out, d_in), generator=generator)
                         / math.sqrt(d_in))
        if bias:
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


class MLP(nn.Module):
    """The reference's ``mlp``: dense layers with ``act`` after every layer
    but the last (``final_act=False``), so the output is un-squashed."""

    def __init__(self, layers: Sequence[nn.Linear], act=F.silu):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < last:
                x = self.act(x)
        return x


def mlp_init(generator: torch.Generator, dims: Sequence[int], *,
             act=F.silu) -> MLP:
    """``dims = [d_in, h1, ..., d_out]``; layer i is ``dense_init`` of
    dims[i] → dims[i+1], drawn in order from ``generator``."""
    return MLP([dense_init(generator, a, b)
                for a, b in zip(dims[:-1], dims[1:])], act)


def mlp_from_numpy(params: Sequence[dict], *, act=F.silu) -> MLP:
    """The reference's ``mlp_init`` list of ``{"w", "b"}`` dicts → MLP."""
    return MLP([dense_from_numpy(p) for p in params], act)


def count_params(model: nn.Module) -> int:
    """Number of parameter entries (the reference's ``count_params``)."""
    return sum(p.numel() for p in model.parameters())


def linspace(start: float, stop: float, num: int, *,
             device: str | torch.device = "cpu") -> torch.Tensor:
    """float32 ``jnp.linspace(start, stop, num)`` with the bits XLA gives
    it on the CPU: ``start·(1 - i·r) + (stop·r)·i`` for ``r = 1/(num-1)``
    rounded to float32 (XLA turns the division by the constant into that
    product and reassociates it), and ``stop`` itself last.
    ``torch.linspace`` steps from both ends, so its interior points differ
    from these in the last place."""
    if num < 2:
        return torch.full((num,), start, dtype=torch.float32, device=device)
    i = torch.arange(num - 1, dtype=torch.float32, device=device)
    r, lo, hi = (torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (1.0 / (num - 1), start, stop))
    return torch.cat([lo * (1 - i * r) + (hi * r) * i, hi[None]])


def rms_norm(x: torch.Tensor, g: torch.Tensor, *,
             eps: float = RMS_EPS) -> torch.Tensor:
    """The reference's ``rms_norm``: ``x / sqrt(mean(x²) + eps) · g`` in
    fp32 (the gain upcast before the multiply), cast back to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * g.float()).to(x.dtype)


class RMSNorm(nn.Module):
    """:func:`rms_norm` with its gain ``weight`` (unit at init)."""

    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype,
                                              device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight)
