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

Expert parallelism. The reference constrains the dispatch buffer and the
expert outputs to the ``"expert"`` axis (``shard(dispatch, "expert", None,
None)``), which its ``lm_rules`` binds to the mesh's ``"model"`` axis, and
shards ``w1``/``w3``/``w2`` on it. A :class:`MoE` built on a mesh does
that explicitly (single-controller, as :mod:`repro_torch.launch.mesh`):
shard ``i`` holds experts ``[lo_i, hi_i)`` (:func:`expert_ranges`, the
block layout of the constraint's divisibility-aware spec: all on the home
shard when ``E`` does not divide the axis) as an :class:`ExpertShard` on
``mesh.devices[i]``, and no whole expert tensor exists. :func:`moe_experts`
copies each shard's rows of the buffer to its device
(:func:`moe_exchange_out`), runs each shard's products there
(:func:`moe_shard_products`) and copies the rows back into an ``(E, cap,
d)`` buffer on the home device in expert order (:func:`moe_exchange_back`),
all issued before any copy-back and with no host synchronisation: a copy
between cards orders itself on both cards' streams. Each logical shard
runs its own products, even where several share a card, so one card runs
what W cards run, minus the peer copies. Everything else (router, plan,
dispatch, combine, shared experts, stats) runs on the home device. A
``torch.bmm`` over a block of experts computes each expert's product as
the whole batch does, so the split changes where the products run, not
their values on the CPU (the tests hold it bit for bit); on the card
cuBLAS may choose another algorithm for another batch count.

Training on a ``("data", "model")`` mesh (:mod:`repro_torch.models.fsdp`)
splits each micro-batch's tokens over data groups; :func:`moe_apply_groups`
routes each group on its home device and plans the whole micro-batch as
one, as the reference's ``moe_apply`` over the micro-batch's ``b·S``
tokens does.
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
from repro_torch.kernels.build import LaunchCounter
from repro_torch.sharding import block_ranges, spec

EXPERT_WEIGHTS = ("w1", "w3", "w2")
# torch.bmm expert products: three for each shard that holds experts, at
# every MoE call (one shard without a mesh)
PRODUCTS = LaunchCounter()


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


class ExpertShard(nn.Module):
    """One shard's experts ``[lo, hi)`` on ``device``: ``w1``/``w3 (hi -
    lo, d, ff)``, ``w2 (hi - lo, ff, d)``."""

    def __init__(self, lo: int, hi: int, d_model: int, d_ff: int, *,
                 dtype: torch.dtype, device):
        super().__init__()
        n = hi - lo
        self.lo, self.hi = lo, hi
        self.device = torch.device(device)
        self.w1 = _param((n, d_model, d_ff), dtype, self.device)
        self.w3 = _param((n, d_model, d_ff), dtype, self.device)
        self.w2 = _param((n, d_ff, d_model), dtype, self.device)


def expert_ranges(mesh, rules, cfg: MoEConfig) -> list[tuple[int, int]]:
    """Each shard's experts ``[lo, hi)`` on a one-axis ``mesh``: the block
    of the expert axis that the reference's ``shard(dispatch, "expert",
    None, None)`` gives it under ``rules`` (divisibility-aware: when the
    experts do not divide the axis it is unsharded, and the home shard
    holds them all)."""
    entry = spec(mesh, rules, (cfg.num_experts,), "expert")[0]
    return block_ranges(mesh, entry, cfg.num_experts)


class MoE(nn.Module):
    """One MoE FFN: ``router (d, E)`` in fp32 whatever ``dtype`` is (as the
    reference draws it), ``w1``/``w3 (E, d, ff)``, ``w2 (E, ff, d)``, and
    with ``n_shared`` a :class:`SharedExperts` ``shared``. Calling it runs
    :func:`moe_apply` and keeps the stats as ``last_stats`` (the last
    call's; a prefill's are overwritten by the next decode step).

    With a ``mesh`` (and its ``rules``, which bind ``"expert"``), the
    experts are ``shards``, one :class:`ExpertShard` a mesh shard on its
    device (:func:`expert_ranges`), and there is no ``w1``/``w3``/``w2``;
    the router and the shared experts stay on ``device``, the home
    device. Without one, ``shards`` is None."""

    def __init__(self, d_model: int, cfg: MoEConfig, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 mesh=None, rules=None):
        super().__init__()
        e, ff = cfg.num_experts, cfg.d_ff
        self.cfg = cfg
        self.router = _param((d_model, e), torch.float32, device)
        if mesh is None:
            self.shards = None
            self.w1 = _param((e, d_model, ff), dtype, device)
            self.w3 = _param((e, d_model, ff), dtype, device)
            self.w2 = _param((e, ff, d_model), dtype, device)
        else:
            if rules is None:
                raise ValueError("an MoE on a mesh needs the rules that "
                                 "bind its \"expert\" axis")
            self.shards = nn.ModuleList(
                ExpertShard(lo, hi, d_model, ff, dtype=dtype, device=dev)
                for (lo, hi), dev in zip(expert_ranges(mesh, rules, cfg),
                                         mesh.devices))
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
    ``w2`` ~ N(0, 1/ffs). Each is drawn in its dtype and then scaled. On a
    mesh each expert weight is drawn whole on the generator's device, as
    without one (so the bits are the same on the same device), then each
    shard takes its slice and the whole tensor is freed."""
    for name, scale in moe_draws(moe.router.shape[0], moe.cfg):
        if name not in EXPERT_WEIGHTS or moe.shards is None:
            moe.get_parameter(name).normal_(generator=generator).mul_(scale)
            continue
        part = getattr(moe.shards[0], name)
        whole = torch.empty((moe.cfg.num_experts, *part.shape[1:]),
                            dtype=part.dtype, device=generator.device)
        whole.normal_(generator=generator).mul_(scale)
        for s in moe.shards:
            getattr(s, name).copy_(whole[s.lo:s.hi])
        del whole
    return moe


def moe_draws(d_model: int, cfg: MoEConfig) -> list[tuple[str, float]]:
    """The reference's ``moe_init`` draws in their order: each weight's
    name under :class:`MoE` and its scale (``router``, ``w1``, ``w3``
    ~ N(0, 1/d), ``w2`` ~ N(0, 1/ff); ``shared.w1``/``shared.w3`` ~ N(0,
    1/d), ``shared.w2`` ~ N(0, 1/ffs))."""
    sc_in = 1.0 / math.sqrt(d_model)
    draws = [("router", sc_in), ("w1", sc_in), ("w3", sc_in),
             ("w2", 1.0 / math.sqrt(cfg.d_ff))]
    if cfg.n_shared:
        draws += [("shared.w1", sc_in), ("shared.w3", sc_in),
                  ("shared.w2", 1.0 / math.sqrt(cfg.d_ff_shared))]
    return draws


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
    into ``moe`` in place, cast to each parameter's dtype; on a mesh each
    shard takes its experts' slice."""
    def put(p: torch.Tensor, arr) -> None:
        p.copy_(torch.tensor(np.asarray(arr, dtype=np.float32)))

    put(moe.router, params["router"])
    for name in EXPERT_WEIGHTS:
        if moe.shards is None:
            put(getattr(moe, name), params[name])
        else:
            for s in moe.shards:
                put(getattr(s, name), np.asarray(params[name])[s.lo:s.hi])
    if moe.cfg.n_shared:
        for name in EXPERT_WEIGHTS:
            put(getattr(moe.shared, name), params["shared"][name])
    return moe


def moe_from_numpy(params: dict, cfg: MoEConfig, *,
                   dtype: torch.dtype = torch.float32,
                   device: str | torch.device = "cuda", mesh=None,
                   rules=None) -> MoE:
    """The reference's ``moe_init`` dict → :class:`MoE` in ``dtype`` (the
    router in fp32) on ``device`` (the card unless the caller asks for the
    CPU); with ``mesh`` and ``rules``, its experts split over the mesh."""
    d_model = np.asarray(params["router"]).shape[0]
    return load_moe_(MoE(d_model, cfg, dtype=dtype,
                         device=resolve_device(device), mesh=mesh,
                         rules=rules), params)


def gather_experts(moe: MoE, device: str | torch.device = "cpu"
                   ) -> dict[str, torch.Tensor]:
    """``w1``, ``w3``, ``w2`` in the reference's ``(E, d, ff)`` / ``(E, ff,
    d)`` layout on ``device``: the shards' slices in expert order (a
    copy), or the whole tensors without a mesh."""
    if moe.shards is None:
        return {n: getattr(moe, n).detach().to(device)
                for n in EXPERT_WEIGHTS}
    return {n: torch.cat([getattr(s, n).detach().to(device)
                          for s in moe.shards]) for n in EXPERT_WEIGHTS}


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
    return route(x, moe.router, cfg)


def route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`moe_route` by the fp32 ``router (d, E)``."""
    probs = torch.softmax(x.float() @ router, dim=-1)
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


def _swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
            w2: torch.Tensor) -> torch.Tensor:
    """``silu(x @ w1) · (x @ w3) @ w2`` as three ``torch.bmm`` in ``x``'s
    dtype, counted in :data:`PRODUCTS`."""
    dt = x.dtype
    h1 = torch.bmm(x, w1.to(dt))
    h3 = torch.bmm(x, w3.to(dt))
    out = torch.bmm(F.silu(h1) * h3, w2.to(dt))
    for _ in range(3):
        PRODUCTS.add()
    return out


def _holding(moe: MoE) -> list[ExpertShard]:
    return [s for s in moe.shards if s.hi > s.lo]


def moe_exchange_out(moe: MoE, dispatch: torch.Tensor
                     ) -> list[torch.Tensor]:
    """Each expert-holding shard's rows ``dispatch[lo:hi]`` on its device
    (no copy for a shard on the buffer's own device)."""
    return [dispatch[s.lo:s.hi].to(s.device) for s in _holding(moe)]


def moe_shard_products(moe: MoE, parts: list[torch.Tensor]
                       ) -> list[torch.Tensor]:
    """Each expert-holding shard's SwiGLU on its rows, on its device."""
    return [_swiglu(x, s.w1, s.w3, s.w2)
            for s, x in zip(_holding(moe), parts)]


def moe_exchange_back(moe: MoE, ys: list[torch.Tensor],
                      dispatch: torch.Tensor) -> torch.Tensor:
    """The shards' output rows copied into one ``(E, cap, d)`` buffer on
    the dispatch buffer's device, in expert order."""
    y = torch.empty_like(dispatch)
    for s, part in zip(_holding(moe), ys):
        y[s.lo:s.hi].copy_(part)
    return y


def moe_experts(moe: MoE, dispatch: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its buffer rows: ``silu(b @ w1) · (b @
    w3) @ w2`` as three ``torch.bmm`` in the buffer's dtype; on a mesh,
    each shard's three on its own device, every copy-in and product
    issued before any copy-back."""
    if moe.shards is None:
        return _swiglu(dispatch, moe.w1, moe.w3, moe.w2)
    parts = moe_exchange_out(moe, dispatch)
    return moe_exchange_back(moe, moe_shard_products(moe, parts), dispatch)


def moe_combine(y: torch.Tensor, plan: DispatchPlan, top_w: torch.Tensor
                ) -> torch.Tensor:
    """Gather each assignment's expert row (zero when dropped), scale it
    by its weight cast to the activation dtype, and fold token t's k rows
    from zero in assignment order, in the activation dtype."""
    return fold(assignment_rows(y, plan), top_w)


def assignment_rows(y: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """Each flat assignment's expert row of ``y (E, cap, d)``, zero when
    dropped: ``(T·k, d)``."""
    e, cap, d = y.shape
    gathered = y.reshape(e * cap, d)[plan.buf_idx.clamp_max(e * cap - 1)]
    return torch.where(plan.keep[:, None], gathered,
                       torch.zeros((), dtype=y.dtype, device=y.device))


def fold(rows: torch.Tensor, top_w: torch.Tensor) -> torch.Tensor:
    """Token t's k assignment ``rows`` (``(T·k, d)``, token-major) scaled
    by their weights ``top_w (T, k)`` cast to the rows' dtype, folded from
    zero in assignment order."""
    t, k = top_w.shape
    d = rows.shape[1]
    rows = (rows * top_w.reshape(-1, 1).to(rows.dtype)).view(t, k, d)
    out = torch.zeros((t, d), dtype=rows.dtype, device=rows.device)
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
    return _stats(top_e, plan, probs.sum(0), cfg)


def _stats(top_e: torch.Tensor, plan: DispatchPlan, importance: torch.Tensor,
           cfg: MoEConfig) -> dict:
    """:func:`moe_stats` from the router probabilities' column sums."""
    e = cfg.num_experts
    load = torch.zeros(e, dtype=plan.slot.dtype, device=plan.slot.device)
    load.scatter_add_(0, top_e.reshape(-1), plan.keep.to(load.dtype))
    load = load.float()
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


# ---------------------------------------------------------------------------
# the MoE of a micro-batch split over data groups (training on a mesh)
# ---------------------------------------------------------------------------
def moe_apply_groups(xs: list[torch.Tensor], routers: list[torch.Tensor],
                     pieces: list[tuple], cfg: MoEConfig, device
                     ) -> tuple[list[torch.Tensor], dict]:
    """The reference's ``moe_apply`` over one micro-batch whose tokens are
    split over data groups, without its shared experts.

    Args:
        xs: each group's tokens ``(T_g, d)`` on its home device.
        routers: each group's whole fp32 router ``(d, E)`` on that device.
        pieces: ``(lo, hi, w1, w3, w2)``: experts ``[lo, hi)`` whole, on
            the device that runs them; together ``[0, E)`` in order.
        cfg: the MoE's config.
        device: where the plan, the dispatch buffer and the expert outputs
            live (the mesh's home device).

    Each group routes its own tokens on its home device (:func:`route`);
    the plan is the micro-batch's: :func:`moe_plan` of the groups'
    ``top_e`` concatenated in group order (the micro-batch's row order),
    so the capacity is that of all ``Σ T_g`` tokens and each slot counts
    the earlier assignments of every group, as the reference's one plan
    over the micro-batch does (a plan made group by group would give
    other capacities and other drops); the tokens
    are written into one ``(E, cap, d)`` buffer on ``device``, each piece's
    rows copied to its device, its three products run there (every copy
    and product issued before any copy-back), and the outputs copied back
    in expert order; each group takes its
    assignments' rows and folds them in assignment order on its home
    device (:func:`fold`). The stats are the micro-batch's
    (:func:`moe_stats`), the importance the groups' column sums added in
    group order. Returns each group's output and the stats."""
    routes = [route(x, r, cfg) for x, r in zip(xs, routers)]
    top_e = torch.cat([t.to(device) for _, _, t in routes])
    plan = moe_plan(top_e, cfg)
    dispatch = moe_dispatch(torch.cat([x.to(device) for x in xs]), plan, cfg)
    parts = [part.to(w[0].device) for part, (_, _, *w) in zip(
        dispatch.split([hi - lo for lo, hi, *_ in pieces]), pieces)]
    ys = [_swiglu(x, *w) for x, (_, _, *w) in zip(parts, pieces)]
    rows = assignment_rows(torch.cat([y.to(device) for y in ys]), plan)
    outs = [fold(r.to(x.device), top_w) for r, x, (_, top_w, _) in zip(
        rows.split([x.shape[0] * cfg.top_k for x in xs]), xs, routes)]
    importance = routes[0][0].sum(0).to(device)
    for probs, _, _ in routes[1:]:
        importance = importance + probs.sum(0).to(device)
    return outs, _stats(top_e, plan, importance, cfg)
