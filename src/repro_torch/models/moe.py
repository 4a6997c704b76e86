"""Mixture-of-Experts FFN with fixed-capacity dispatch on PyTorch: the
port of ``src/repro/models/moe.py``.

Covers both MoE configurations of the reference:
  * deepseek-moe-16b — 2 shared + 64 fine-grained routed experts, top-6
  * phi3.5-moe-42b   — 16 experts, top-2

Dispatch is the reference's: each token's top-k experts in token-major
order, a slot for each assignment (its expert's running count of earlier
assignments), tokens written into a fixed ``(E, cap, d)`` buffer (an
assignment past capacity is dropped into a sink row, GShard semantics),
the experts as three batched matrix products (``torch.bmm``, as the
reference's einsums), and the results folded back with the routing
weights. Every step is torch ops: the reference's is jnp outside any
Pallas kernel.

:func:`moe_apply` is the composition of the stages :func:`moe_route`,
:func:`moe_dispatch`, :func:`moe_experts`, :func:`moe_combine`,
:func:`moe_shared` and :func:`moe_stats`; ``bench/profile_lm.py`` times
them one by one and :func:`moe_apply_routed` runs all but the router, so
the card's routing can be fed to a CPU run.

Bits the port holds equal to the reference (in fp32, for the same router
probabilities): the chosen experts and their order, each assignment's
slot and whether it is kept, the dispatch buffer's layout, the per-expert
load and the dropped count. Where they would drift:

* Ties. ``jax.lax.top_k`` puts the lower expert index first among equal
  probabilities; :func:`moe_route` takes the first k of a stable
  descending sort, which does the same (``torch.topk`` promises no order).
* Dispatch. The reference adds each token into a zeroed buffer
  (``.at[buf_idx].add``). Kept buffer indices are unique, so a kept row
  is ``0 + x``: the same value, except that a ``-0.0`` element becomes
  ``+0.0``. :func:`moe_dispatch` follows that rule: it copies ``x + 0.0``
  (the same IEEE sum) into zeros with ``index_copy_``. Dropped
  assignments all land in the sink row, where which of them is written
  last is unspecified; the sink is cut off. (An accumulating
  ``index_put_`` gives the same bits, but on CUDA it serialises the
  sink's duplicates: 1.6 s of a 2.6 s deepseek-moe-16b prefill on an
  H100 80GB HBM3 at 700 W; PERF.md.)
* No host sync. Counts are integer ``scatter_add_`` sums, not
  ``torch.bincount``, which reads its input's maximum back to the host on
  the card, so a decode step issues all its layers without waiting.
* Combine. The reference's ``.at[flat_t].add`` adds token t's k weighted
  rows (assignments ``t·k … t·k+k-1``) in that order into zeros, rounding
  to the activation dtype after each add. :func:`moe_combine` folds them
  from zero in that order through a ``(T, k, d)`` view; ``index_add_``
  would add by atomics on the card, in no fixed order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's ``MoEConfig``, field for field."""
    num_experts: int
    top_k: int
    d_ff: int                    # per-expert FFN width
    n_shared: int = 0            # always-on shared experts (DeepSeek-MoE)
    d_ff_shared: int = 0         # total width of the shared FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert for ``tokens`` tokens: the reference's float
    expression ``ceil(T·k·cf / E)``, at least 1."""
    return max(int(math.ceil(tokens * cfg.top_k * cfg.capacity_factor
                             / cfg.num_experts)), 1)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class SharedExperts(nn.Module):
    """The always-on SwiGLU FFN: ``w1``/``w3 (d, ffs)``, ``w2 (ffs, d)``."""

    def __init__(self, d_model: int, d_ff: int, *, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.w1 = _param((d_model, d_ff), dtype, device)
        self.w3 = _param((d_model, d_ff), dtype, device)
        self.w2 = _param((d_ff, d_model), dtype, device)


class MoE(nn.Module):
    """One MoE FFN: ``router (d, E)`` in fp32 whatever ``dtype`` is (as the
    reference draws it), ``w1``/``w3 (E, d, ff)``, ``w2 (E, ff, d)``, and
    with ``n_shared`` a :class:`SharedExperts` ``shared``. Calling it runs
    :func:`moe_apply` and keeps the stats as ``last_stats`` (the last
    call's; a prefill's are overwritten by the next decode step)."""

    def __init__(self, d_model: int, cfg: MoEConfig, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        e, ff = cfg.num_experts, cfg.d_ff
        self.cfg = cfg
        self.router = _param((d_model, e), torch.float32, device)
        self.w1 = _param((e, d_model, ff), dtype, device)
        self.w3 = _param((e, d_model, ff), dtype, device)
        self.w2 = _param((e, ff, d_model), dtype, device)
        if cfg.n_shared:
            self.shared = SharedExperts(d_model, cfg.d_ff_shared,
                                        dtype=dtype, device=device)
        self.last_stats: Optional[dict] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, self.last_stats = moe_apply(self, x, self.cfg)
        return out


@torch.no_grad()
def init_moe_(moe: MoE, generator: torch.Generator) -> MoE:
    """Draw ``moe``'s weights in place from ``generator`` with the
    reference's distributions (``moe_init``): ``router``, ``w1``, ``w3`` ~
    N(0, 1/d), ``w2`` ~ N(0, 1/ff); shared ``w1``/``w3`` ~ N(0, 1/d),
    ``w2`` ~ N(0, 1/ffs). Each is drawn in its dtype and then scaled."""
    d = moe.router.shape[0]
    sc_in = 1.0 / math.sqrt(d)
    draws = [(moe.router, sc_in), (moe.w1, sc_in), (moe.w3, sc_in),
             (moe.w2, 1.0 / math.sqrt(moe.cfg.d_ff))]
    if moe.cfg.n_shared:
        s = moe.shared
        draws += [(s.w1, sc_in), (s.w3, sc_in),
                  (s.w2, 1.0 / math.sqrt(moe.cfg.d_ff_shared))]
    for p, scale in draws:
        p.normal_(generator=generator).mul_(scale)
    return moe


def moe_init(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32) -> MoE:
    """A :class:`MoE` on ``generator``'s device, drawn by
    :func:`init_moe_`."""
    return init_moe_(MoE(d_model, cfg, dtype=dtype,
                         device=generator.device), generator)


@torch.no_grad()
def load_moe_(moe: MoE, params: dict) -> MoE:
    """Copy the reference's ``moe_init`` dict (``router``, ``w1``, ``w3``,
    ``w2`` and, with shared experts, ``shared``'s ``w1``/``w3``/``w2``)
    into ``moe`` in place, cast to each parameter's dtype."""
    def put(p: torch.Tensor, arr) -> None:
        p.copy_(torch.tensor(np.asarray(arr, dtype=np.float32)))

    for name in ("router", "w1", "w3", "w2"):
        put(getattr(moe, name), params[name])
    if moe.cfg.n_shared:
        for name in ("w1", "w3", "w2"):
            put(getattr(moe.shared, name), params["shared"][name])
    return moe


def moe_from_numpy(params: dict, cfg: MoEConfig, *,
                   dtype: torch.dtype = torch.float32,
                   device: str | torch.device = "cuda") -> MoE:
    """The reference's ``moe_init`` dict → :class:`MoE` in ``dtype`` (the
    router in fp32) on ``device`` (the card unless the caller asks for the
    CPU)."""
    d_model = np.asarray(params["router"]).shape[0]
    return load_moe_(MoE(d_model, cfg, dtype=dtype,
                         device=resolve_device(device)), params)


class DispatchPlan(NamedTuple):
    """Where each flat assignment ``i = t·k + j`` goes: ``flat_t`` its
    token, ``slot`` its place in its expert's buffer, ``keep`` whether
    ``slot < cap``, ``buf_idx`` its row of the ``(E·cap + 1, d)`` buffer
    (``E·cap``, the sink, when dropped)."""
    flat_t: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    buf_idx: torch.Tensor
    cap: int


def moe_route(moe: MoE, x: torch.Tensor, cfg: MoEConfig
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 router logits and softmax, then the top-k of each token (the
    first k of a stable descending sort: the lower expert first on ties,
    as ``jax.lax.top_k``), weights renormalised by ``max(Σ, 1e-9)``.
    Returns ``(probs (T, E), top_w (T, k), top_e (T, k))``."""
    probs = torch.softmax(x.float() @ moe.router, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :cfg.top_k], top_e[:, :cfg.top_k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_w, top_e


def moe_plan(top_e: torch.Tensor, cfg: MoEConfig) -> DispatchPlan:
    """The flat ``(T·k)`` assignments in token-major order and their
    slots: an assignment's slot is the number of earlier assignments to
    its expert (the reference's exclusive cumsum over a one-hot, here as a
    stable sort by expert, in integers)."""
    t, k = top_e.shape
    e = cfg.num_experts
    cap = capacity(t, cfg)
    flat_e = top_e.reshape(-1)
    n = flat_e.numel()
    flat_t = torch.arange(t, device=top_e.device)[:, None].expand(t, k)
    flat_t = flat_t.reshape(-1)
    counts = torch.zeros(e, dtype=flat_e.dtype, device=flat_e.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    sorted_e, order = torch.sort(flat_e, stable=True)
    slot = torch.empty_like(flat_e)
    slot[order] = torch.arange(n, device=top_e.device) - starts[sorted_e]
    keep = slot < cap
    buf_idx = torch.where(keep, flat_e * cap + slot,
                          torch.full_like(flat_e, e * cap))
    return DispatchPlan(flat_t, slot, keep, buf_idx, cap)


def moe_dispatch(x: torch.Tensor, plan: DispatchPlan, cfg: MoEConfig
                 ) -> torch.Tensor:
    """The ``(E, cap, d)`` dispatch buffer in ``x``'s dtype, zeros but for
    each kept assignment's token at its row, as ``x + 0.0`` (so ``-0.0``
    becomes ``+0.0``, as in the reference's add into zeros); dropped ones
    go to the sink row, which is cut off."""
    e, d = cfg.num_experts, x.shape[1]
    buf = torch.zeros((e * plan.cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, plan.buf_idx, x[plan.flat_t].add_(0.0))
    return buf[:-1].reshape(e, plan.cap, d)


def moe_experts(moe: MoE, dispatch: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its buffer rows: ``silu(b @ w1) · (b @
    w3) @ w2`` as three ``torch.bmm`` in the buffer's dtype."""
    dt = dispatch.dtype
    h1 = torch.bmm(dispatch, moe.w1.to(dt))
    h3 = torch.bmm(dispatch, moe.w3.to(dt))
    return torch.bmm(F.silu(h1) * h3, moe.w2.to(dt))


def moe_combine(y: torch.Tensor, plan: DispatchPlan, top_w: torch.Tensor
                ) -> torch.Tensor:
    """Gather each assignment's expert row (zero when dropped), scale it
    by its weight cast to the activation dtype, and fold token t's k rows
    from zero in assignment order, in the activation dtype."""
    e, cap, d = y.shape
    t, k = top_w.shape
    flat_y = y.reshape(e * cap, d)
    gathered = flat_y[plan.buf_idx.clamp_max(e * cap - 1)]
    gathered = torch.where(plan.keep[:, None], gathered,
                           torch.zeros((), dtype=y.dtype, device=y.device))
    rows = (gathered * top_w.reshape(-1, 1).to(y.dtype)).view(t, k, d)
    out = torch.zeros((t, d), dtype=y.dtype, device=y.device)
    for j in range(k):
        out = out + rows[:, j]
    return out


def moe_shared(moe: MoE, x: torch.Tensor) -> torch.Tensor:
    """The shared experts' SwiGLU ``silu(x @ w1) · (x @ w3) @ w2``."""
    s, dt = moe.shared, x.dtype
    hs = F.silu(x @ s.w1.to(dt)) * (x @ s.w3.to(dt))
    return hs @ s.w2.to(dt)


def moe_stats(probs: torch.Tensor, top_e: torch.Tensor, plan: DispatchPlan,
              cfg: MoEConfig) -> dict:
    """Router statistics: ``expert_load`` (kept assignments per expert,
    fp32, as the reference's bincount weighted by ``keep``), ``dropped``,
    the Switch-style ``aux_loss`` ``w · E · Σ_e f_e · P_e``, and
    ``capacity`` (``cap``, an int)."""
    e = cfg.num_experts
    load = torch.zeros(e, dtype=plan.slot.dtype, device=plan.slot.device)
    load.scatter_add_(0, top_e.reshape(-1), plan.keep.to(load.dtype))
    load = load.float()
    importance = probs.sum(0)
    f = load / load.sum().clamp_min(1.0)
    pr = importance / importance.sum().clamp_min(1e-9)
    aux = cfg.router_aux_weight * e * torch.sum(f * pr)
    return {"aux_loss": aux, "expert_load": load,
            "dropped": (~plan.keep).sum(), "capacity": plan.cap}


def moe_apply_routed(moe: MoE, x: torch.Tensor, cfg: MoEConfig,
                     probs: torch.Tensor, top_w: torch.Tensor,
                     top_e: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """:func:`moe_apply` after the router, on the routing given."""
    plan = moe_plan(top_e, cfg)
    out = moe_combine(moe_experts(moe, moe_dispatch(x, plan, cfg)), plan,
                      top_w)
    if cfg.n_shared:
        out = out + moe_shared(moe, x)
    return out, moe_stats(probs, top_e, plan, cfg)


def moe_apply(moe: MoE, x: torch.Tensor, cfg: MoEConfig
              ) -> tuple[torch.Tensor, dict]:
    """x: ``(T, d)`` tokens → ``(out (T, d)`` in ``x``'s dtype, stats)``;
    see :func:`moe_stats` for the stats (the FAP-for-experts signal)."""
    return moe_apply_routed(moe, x, cfg, *moe_route(moe, x, cfg))
