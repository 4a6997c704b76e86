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

The dry-run's cell (:func:`build_din_cell`) reads the tables directly;
its rules row-shard them over the "model" axis and the batch over the
data axes (the cross-shard gather is the roofline collective).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import resolve_device
from repro_torch.configs.base import Arch, CellSpec, fake_to, register
from repro_torch.models.din import (DIN, DINConfig, din_forward, din_init,
                                    din_loss, din_score_candidates)
from repro_torch.sharding import Rules, spec, tree_shardings
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


# ---------------------------------------------------------------------------
# The dry-run's cell, rules and smoke
# ---------------------------------------------------------------------------
def din_rules(mesh) -> Rules:
    if mesh is None:
        return Rules({})
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return Rules({"batch": dp, "rows": "model", "cand": dp})


def _param_specs(cfg: DINConfig, mesh, rules: Rules, model: DIN) -> dict:
    """``{parameter name: spec}``: the tables row-sharded, the MLPs
    replicated (the reference's ``_param_specs``)."""
    s = partial(spec, mesh, rules)
    specs = {n: () for n, _ in model.named_parameters()}
    specs["item_embed"] = s((cfg.n_items, cfg.embed_dim), "rows", None)
    specs["cate_embed"] = s((cfg.n_cates, cfg.embed_dim), "rows", None)
    return specs


def _batch_abstract(cfg: DINConfig, b: int, device: torch.device) -> dict:
    """The batch of ``b`` examples as empty tensors on ``device`` (fake
    under an active ``FakeTensorMode``)."""
    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    return {
        "target_item": t((b,), torch.int32),
        "target_cate": t((b,), torch.int32),
        "hist_items": t((b, cfg.hist_len), torch.int32),
        "hist_cates": t((b, cfg.hist_len), torch.int32),
        "dense_feat": t((b, cfg.n_dense_feat), torch.float32),
        "label": t((b,), torch.int32),
    }


def _batch_specs(cfg: DINConfig, b: int, mesh, rules: Rules) -> dict:
    s = partial(spec, mesh, rules)
    return {
        "target_item": s((b,), "batch"),
        "target_cate": s((b,), "batch"),
        "hist_items": s((b, cfg.hist_len), "batch", None),
        "hist_cates": s((b, cfg.hist_len), "batch", None),
        "dense_feat": s((b, cfg.n_dense_feat), "batch", None),
        "label": s((b,), "batch"),
    }


def concrete_batch(cfg: DINConfig, b: int, gen: torch.Generator,
                   device: torch.device) -> dict:
    """A batch of ``b`` uniform draws on ``device`` from ``gen`` (on that
    device): ids in range, history ids from -1 (padding) up, labels 0/1."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    return {
        "target_item": ints(0, cfg.n_items, (b,)),
        "target_cate": ints(0, cfg.n_cates, (b,)),
        "hist_items": ints(-1, cfg.n_items, (b, cfg.hist_len)),
        "hist_cates": ints(0, cfg.n_cates, (b, cfg.hist_len)),
        "dense_feat": torch.randn((b, cfg.n_dense_feat), generator=gen,
                                  device=device),
        "label": ints(0, 2, (b,)),
    }


def build_din_cell(cfg: DINConfig, shape: str, mesh, *,
                   device: str | torch.device = "cuda") -> CellSpec:
    """The reference's ``build_din_cell`` on fake tensors of ``device``:
    ``train_batch`` is :func:`train_step`; ``serve_p99``/``serve_bulk``
    one ``din_forward``; ``retrieval_cand`` one user's history against
    1,000,000 candidates in chunks of :data:`RETRIEVAL_CHUNK`."""
    info = SHAPES[shape]
    rules = din_rules(mesh)
    dev = torch.device(device)
    mode = FakeTensorMode()
    with mode:
        model = fake_to(din_init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu"), dev)
    pspecs = _param_specs(cfg, mesh, rules, model)
    psh = tree_shardings(mesh, pspecs)
    meta = {"family": "recsys", "cfg": cfg, "shape": shape, "info": info,
            "rules": rules,
            "batch_spec": (spec(mesh, rules, (info["candidates"],), "cand")
                           if info["kind"] == "retrieval" else
                           spec(mesh, rules, (info["batch"],), "batch"))}

    def make_model(seed: int, device):
        dev = resolve_device(device)
        return dev, din_init(torch.Generator().manual_seed(seed), cfg,
                             device=dev)

    if info["kind"] == "train":
        opt = train_optimizer()
        b = info["batch"]
        with mode:
            opt_state = opt.init(dict(model.named_parameters()))
            batch = _batch_abstract(cfg, b, dev)
        in_sh = (None if mesh is None else
                 (psh, AdamWState(step=None, mu=psh, nu=psh),
                  tree_shardings(mesh, _batch_specs(cfg, b, mesh, rules))))

        def step(model, opt_state, batch):
            return train_step(model, opt, opt_state, batch, cfg)

        def make_args(seed: int, device):
            dev, model = make_model(seed, device)
            gen = torch.Generator(device=dev).manual_seed(seed)
            return (model, opt.init(dict(model.named_parameters())),
                    concrete_batch(cfg, b, gen, dev))

        return CellSpec(step_fn=step, args=(model, opt_state, batch),
                        in_shardings=in_sh, donate_argnums=(0, 1),
                        kind="train", fake_mode=mode, make_args=make_args,
                        meta=meta)

    if info["kind"] == "serve":
        b = info["batch"]
        with mode:
            batch = _batch_abstract(cfg, b, dev)
            batch.pop("label")
        bspecs = _batch_specs(cfg, b, mesh, rules)
        bspecs.pop("label")

        def step(model, batch):
            return din_forward(model, cfg, batch["target_item"],
                               batch["target_cate"], batch["hist_items"],
                               batch["hist_cates"], batch["dense_feat"])

        def make_args(seed: int, device):
            dev, model = make_model(seed, device)
            gen = torch.Generator(device=dev).manual_seed(seed)
            batch = concrete_batch(cfg, b, gen, dev)
            batch.pop("label")
            return model, batch

        return CellSpec(
            step_fn=step, args=(model, batch),
            in_shardings=(None if mesh is None else
                          (psh, tree_shardings(mesh, bspecs))),
            out_shardings=(None if mesh is None else tree_shardings(
                mesh, spec(mesh, rules, (b,), "batch"))),
            kind="serve", fake_mode=mode, make_args=make_args, meta=meta)

    # retrieval: one user, 1M candidates
    n = info["candidates"]
    with mode:
        args = (model,
                torch.empty((cfg.hist_len,), dtype=torch.int32, device=dev),
                torch.empty((cfg.hist_len,), dtype=torch.int32, device=dev),
                torch.empty((cfg.n_dense_feat,), device=dev),
                torch.empty((n,), dtype=torch.int32, device=dev),
                torch.empty((n,), dtype=torch.int32, device=dev))
    s = partial(spec, mesh, rules)

    def step(model, hi, hc, df, ci, cc):
        return din_score_candidates(model, cfg, hi, hc, df, ci, cc,
                                    chunk=RETRIEVAL_CHUNK)

    def make_args(seed: int, device):
        dev, model = make_model(seed, device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        user = concrete_batch(cfg, 1, gen, dev)
        cand = concrete_batch(cfg, n, gen, dev)
        return (model, user["hist_items"][0], user["hist_cates"][0],
                user["dense_feat"][0], cand["target_item"],
                cand["target_cate"])

    in_sh = (None if mesh is None else
             (psh, tree_shardings(mesh, ()), tree_shardings(mesh, ()),
              tree_shardings(mesh, ()),
              tree_shardings(mesh, s((n,), "cand")),
              tree_shardings(mesh, s((n,), "cand"))))
    return CellSpec(step_fn=step, args=args, in_shardings=in_sh,
                    out_shardings=(None if mesh is None else tree_shardings(
                        mesh, s((n,), "cand"))),
                    kind="serve", fake_mode=mode, make_args=make_args,
                    meta=meta)


SMOKE_CONFIG = DINConfig(n_items=2000, n_cates=64, embed_dim=18,
                         hist_len=20, n_dense_feat=8)


def din_smoke(*, model: Optional[DIN] = None) -> dict:
    """The reference's ``din_smoke`` on the CPU: a 2,000-item config, a
    batch of 32 drawn from ``np.random.default_rng(0)`` in the
    reference's order, the loss and one AdamW update, then one user's
    scores against 1,000 candidates (drawn next) in chunks of 256.
    ``model`` defaults to ``din_init`` on seed 0 (pass the reference's,
    carried over, to compare). Asserts finite outputs."""
    cfg = SMOKE_CONFIG
    rng = np.random.default_rng(0)
    if model is None:
        model = din_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = 32

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))

    batch = {
        "target_item": ints(0, 2000, b),
        "target_cate": ints(0, 64, b),
        "hist_items": ints(-1, 2000, (b, 20)),
        "hist_cates": ints(0, 64, (b, 20)),
        "dense_feat": torch.from_numpy(
            rng.normal(size=(b, 8)).astype(np.float32)),
        "label": ints(0, 2, b),
    }
    opt = train_optimizer()
    opt_state, loss = train_step(
        model, opt, opt.init(dict(model.named_parameters())), batch, cfg)
    scores = din_score_candidates(
        model, cfg, batch["hist_items"][0], batch["hist_cates"][0],
        batch["dense_feat"][0], ints(0, 2000, 1000), ints(0, 64, 1000),
        chunk=256)
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(scores).all())
    return {"loss": float(loss), "n_scores": int(scores.shape[0])}


ARCH = register(Arch(
    name="din", family="recsys",
    description="Deep Interest Network: target attention over user history, "
                "10M-row item table through the tiered store.",
    shape_names=tuple(SHAPES),
    build_cell=lambda shape, mesh, **kw: build_din_cell(CONFIG, shape, mesh,
                                                        **kw),
    smoke=din_smoke))
