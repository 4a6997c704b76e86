"""The port's MoE serving path (``repro_torch.models.moe``, the MoE branch of
``models.transformer``, the deepseek-moe-16b and phi3.5-moe-42b configs,
``core.placement.expert_placement`` and the LM launcher's MoE archs)
against the reference, on the CPU. Inputs come from
``np.random.default_rng``; weights from ``repro.models.moe.moe_init`` /
``repro.models.transformer.lm_init``, carried by ``moe_from_numpy`` /
``lm_from_numpy``.

What is held, and how:
* bit for bit: the chosen experts ``top_e`` (order included), each
  assignment's ``slot`` and ``keep``, the dispatch buffer (compared as
  integers, so the ``-0.0`` → ``+0.0`` rule of the reference's add into
  zeros is pinned), ``expert_load``, ``dropped``, and ``expert_placement``;
* fp32 ``top_w``, MoE output and ``aux_loss`` within ``FP32_TOL`` (1e-5),
  LM logits within 1e-4 and the bf16 KV cache within one bf16 ulp, as the
  dense LM tests hold them;
* bf16 activations and expert weights: the routing is fp32 on both sides
  and bitwise again; the outputs within ``BF16_ULPS`` (4) bf16 ulps of the
  output's largest magnitude, since the two sides round the expert
  products, the SiLU and each of the k combine adds to bf16 from sums
  taken in other orders.

Equal routing rests on the two sides' fp32 router probabilities, which
differ in the last bits (held within ``PROB_TOL``). Each parity case first
asserts that its smallest gap between adjacent sorted probabilities, among
a token's k + 1 largest, is at least ``MIN_GAP`` (more than twice
``PROB_TOL``), so equal routing is expected, not lucky.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_moe_16b as ref_deepseek
from repro.configs import phi35_moe_42b as ref_phi
from repro.core import placement as ref_placement
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro_torch.configs import (LM_ARCHS, deepseek_moe_16b, lm_common,
                                 phi35_moe_42b)
from repro_torch.core import expert_placement
from repro_torch.kernels.flash_attention.ref import bf16_ulp
from repro_torch.launch import lm as launcher
from repro_torch.models import moe, transformer

FP32_TOL = 1e-5
LM_FP32_TOL = 1e-4
BF16_ULPS = 4
PROB_TOL = 4e-7   # router probabilities (< 1): a few fp32 ulps
MIN_GAP = 1e-6    # > 2 · PROB_TOL: routing then cannot flip
PROMPT = 40
PAIRS = {"deepseek-moe-16b": (ref_deepseek.CONFIG, deepseek_moe_16b.CONFIG),
         "phi3.5-moe-42b": (ref_phi.CONFIG, phi35_moe_42b.CONFIG)}


@pytest.fixture(autouse=True)
def _serving_without_grad():
    """Serving runs under ``torch.no_grad``, as ``lm_prefill`` does."""
    with torch.no_grad():
        yield


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _port_cfg(ref_cfg):
    return moe.MoEConfig(**dataclasses.asdict(ref_cfg))


def _ref_apply(params, x, cfg):
    """The reference's ``moe_apply`` on ``x``, with what it computed on the
    way: the router probabilities and top-k (captured at
    ``jax.lax.top_k``) and the dispatch buffer (its first ``shard`` call)."""
    seen = {}
    top_k = jax.lax.top_k

    def record_top_k(probs, k):
        seen["probs"] = np.asarray(probs)
        w, e = top_k(probs, k)
        seen["top_w"], seen["top_e"] = np.asarray(w), np.asarray(e)
        return w, e

    def record_shard(a, *names):
        seen.setdefault("dispatch", np.asarray(a))
        return a

    with mock.patch.object(jax.lax, "top_k", record_top_k):
        out, stats = ref_moe.moe_apply(params, x, cfg, shard=record_shard)
    w = seen["top_w"]
    seen["top_w"] = w / np.maximum(w.sum(-1, keepdims=True), 1e-9)
    # the reference's slot: exclusive cumsum over a one-hot (moe.py:81-84)
    flat_e = jnp.asarray(seen["top_e"]).reshape(-1)
    onehot = jax.nn.one_hot(flat_e, cfg.num_experts, dtype=jnp.int32)
    seen["slot"] = np.asarray(((jnp.cumsum(onehot, 0) - onehot)
                               * onehot).sum(-1))
    return out, stats, seen


def _min_gap(probs, k):
    """Smallest gap between adjacent sorted probabilities among each
    token's ``k + 1`` largest (its ``k`` when there are only ``k``)."""
    top = -np.sort(-probs, axis=-1)[:, :k + 1]
    return float((top[:, :-1] - top[:, 1:]).min())


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t.view(torch.int32)).numpy()


def _ref_bits(a, dtype) -> np.ndarray:
    return _bits(torch.tensor(np.asarray(a, np.float32)).to(dtype))


def _inputs(t, d, seed, jdtype):
    """(T, d) tokens from the seed, with ``-0.0`` in some elements."""
    x = np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)
    x[::7, 0] = -0.0
    x[3, :5] = -0.0
    return jnp.asarray(x, jdtype)


CASES = [(k, shared, cf) for k in (1, 2, 6) for shared in (0, 2)
         for cf in (8.0, 0.25)]


@pytest.mark.parametrize("k,n_shared,cf", CASES)
def test_moe_apply_matches_reference_fp32(k, n_shared, cf):
    e, d, t = 8, 32, 160
    rcfg = ref_moe.MoEConfig(num_experts=e, top_k=k, d_ff=16,
                             n_shared=n_shared,
                             d_ff_shared=24 if n_shared else 0,
                             capacity_factor=cf)
    params = ref_moe.moe_init(jax.random.key(k * 10 + n_shared), d, rcfg)
    x = _inputs(t, d, seed=k + n_shared, jdtype=jnp.float32)
    want, want_stats, seen = _ref_apply(params, x, rcfg)
    assert _min_gap(seen["probs"], k) >= MIN_GAP

    cfg = _port_cfg(rcfg)
    m = moe.moe_from_numpy(_np_tree(params), cfg, device="cpu")
    xt = torch.tensor(np.asarray(x))
    probs, top_w, top_e = moe.moe_route(m, xt, cfg)
    plan = moe.moe_plan(top_e, cfg)
    cap = moe.capacity(t, cfg)
    assert cap == int(np.ceil(t * k * cf / e)) == plan.cap
    assert np.array_equal(top_e.numpy(), seen["top_e"])
    assert np.array_equal(plan.slot.numpy(), seen["slot"])
    assert np.array_equal(plan.keep.numpy(), seen["slot"] < cap)
    assert np.array_equal(plan.flat_t.numpy(), np.repeat(np.arange(t), k))
    dispatch = moe.moe_dispatch(xt, plan, cfg)
    assert dispatch.shape == (e, cap, d)
    assert np.array_equal(_bits(dispatch),
                          _ref_bits(seen["dispatch"], torch.float32))
    np.testing.assert_allclose(probs.numpy(), seen["probs"], rtol=0,
                               atol=PROB_TOL)
    np.testing.assert_allclose(top_w.numpy(), seen["top_w"],
                               rtol=FP32_TOL, atol=FP32_TOL)

    got, stats = moe.moe_apply(m, xt, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FP32_TOL, atol=FP32_TOL)
    assert np.array_equal(stats["expert_load"].numpy(),
                          np.asarray(want_stats["expert_load"]))
    assert stats["expert_load"].dtype == torch.float32
    assert int(stats["dropped"]) == int(want_stats["dropped"])
    np.testing.assert_allclose(float(stats["aux_loss"]),
                               float(want_stats["aux_loss"]),
                               rtol=FP32_TOL, atol=FP32_TOL)
    assert stats["capacity"] == cap
    if cf == 8.0:
        assert int(stats["dropped"]) == 0
    else:
        assert int(stats["dropped"]) > 0
    assert float(stats["expert_load"].sum()) + int(stats["dropped"]) \
        == t * k


@pytest.mark.parametrize("k,n_shared", [(2, 0), (6, 2)])
def test_moe_apply_matches_reference_bf16(k, n_shared):
    """bf16 activations and expert weights (router fp32): routing, slots,
    dispatch bits and stats equal; outputs within ``BF16_ULPS`` ulps."""
    e, d, t = 8, 32, 160
    rcfg = ref_moe.MoEConfig(num_experts=e, top_k=k, d_ff=16,
                             n_shared=n_shared,
                             d_ff_shared=24 if n_shared else 0)
    params = ref_moe.moe_init(jax.random.key(7 + k), d, rcfg,
                              dtype=jnp.bfloat16)
    x = _inputs(t, d, seed=20 + k, jdtype=jnp.bfloat16)
    want, want_stats, seen = _ref_apply(params, x, rcfg)
    assert _min_gap(seen["probs"], k) >= MIN_GAP
    cfg = _port_cfg(rcfg)
    m = moe.moe_from_numpy(_np_tree(params), cfg, dtype=torch.bfloat16,
                           device="cpu")
    assert m.router.dtype == torch.float32
    xt = torch.tensor(np.asarray(x, np.float32)).bfloat16()
    _, _, top_e = moe.moe_route(m, xt, cfg)
    plan = moe.moe_plan(top_e, cfg)
    assert np.array_equal(top_e.numpy(), seen["top_e"])
    assert np.array_equal(plan.slot.numpy(), seen["slot"])
    assert np.array_equal(_bits(moe.moe_dispatch(xt, plan, cfg)),
                          _ref_bits(seen["dispatch"], torch.bfloat16))
    got, stats = moe.moe_apply(m, xt, cfg)
    assert got.dtype == torch.bfloat16
    want_t = torch.tensor(np.asarray(want, np.float32))
    allow = BF16_ULPS * bf16_ulp(want_t.abs().max())
    assert float((got.float() - want_t).abs().max()) <= float(allow)
    assert np.array_equal(stats["expert_load"].numpy(),
                          np.asarray(want_stats["expert_load"]))
    assert int(stats["dropped"]) == int(want_stats["dropped"])


@pytest.mark.parametrize("k", [1, 2, 6])
def test_forced_ties_pick_the_lower_expert(k):
    """Router columns equal in pairs (2j, 2j+1), with integer tokens and
    quarter-integer router entries, so the logits are exact and each pair
    ties exactly: port and reference take the same experts, in the same
    order, and give the same output."""
    e, d, t = 8, 16, 64
    rcfg = ref_moe.MoEConfig(num_experts=e, top_k=k, d_ff=8,
                             capacity_factor=0.5)
    params = ref_moe.moe_init(jax.random.key(3), d, rcfg)
    rng = np.random.default_rng(9)
    half = rng.integers(-4, 5, size=(d, e // 2)).astype(np.float32) / 4
    params["router"] = jnp.asarray(np.repeat(half, 2, axis=1))
    x = jnp.asarray(rng.integers(-3, 4, size=(t, d)).astype(np.float32))
    want, want_stats, seen = _ref_apply(params, x, rcfg)
    probs = seen["probs"]
    assert (probs[:, 0::2] == probs[:, 1::2]).all()  # every pair ties
    cfg = _port_cfg(rcfg)
    m = moe.moe_from_numpy(_np_tree(params), cfg, device="cpu")
    xt = torch.tensor(np.asarray(x))
    _, _, top_e = moe.moe_route(m, xt, cfg)
    assert np.array_equal(top_e.numpy(), seen["top_e"])
    # within a tied pair the even (lower) expert comes first
    paired = top_e.numpy() // 2
    lower = top_e.numpy() % 2 == 0
    for j in range(k - 1):
        same = paired[:, j] == paired[:, j + 1]
        assert lower[same, j].all()
    got, stats = moe.moe_apply(m, xt, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FP32_TOL, atol=FP32_TOL)
    assert np.array_equal(stats["expert_load"].numpy(),
                          np.asarray(want_stats["expert_load"]))


# ---------------------------------------------------------------------------
# the reference's own oracle tests (tests/test_models.py:101-136), on the port
# ---------------------------------------------------------------------------
def test_moe_matches_dense_oracle():
    cfg = moe.MoEConfig(num_experts=4, top_k=2, d_ff=16,
                        capacity_factor=8.0)
    m = moe.moe_init(torch.Generator().manual_seed(0), 8, cfg)
    x = torch.randn((32, 8), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, stats = moe.moe_apply(m, x, cfg)
        probs = torch.softmax(x @ m.router, -1)
        tw, te = torch.topk(probs, 2)
        tw = tw / tw.sum(-1, keepdim=True)
        yo = torch.zeros_like(x)
        for e in range(4):
            h = torch.nn.functional.silu(x @ m.w1[e]) * (x @ m.w3[e])
            w = torch.where(te == e, tw, 0.0).sum(-1)
            yo = yo + (h @ m.w2[e]) * w[:, None]
    np.testing.assert_allclose(y.numpy(), yo.numpy(), atol=1e-5)
    assert int(stats["dropped"]) == 0


def test_moe_capacity_drops_overflow():
    cfg = moe.MoEConfig(num_experts=4, top_k=1, d_ff=8,
                        capacity_factor=0.25)
    m = moe.moe_init(torch.Generator().manual_seed(0), 8, cfg)
    x = torch.randn((64, 8), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        y, stats = moe.moe_apply(m, x, cfg)
    assert int(stats["dropped"]) > 0
    assert bool(torch.isfinite(y).all())
    assert float(stats["expert_load"].sum()) + int(stats["dropped"]) == 64


def test_moe_router_stats_feed_expert_placement():
    cfg = moe.MoEConfig(num_experts=8, top_k=2, d_ff=8)
    m = moe.moe_init(torch.Generator().manual_seed(0), 8, cfg)
    x = torch.randn((128, 8), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        m(x)
    load = m.last_stats["expert_load"].numpy()
    reps = expert_placement(load, 8, 4)
    assert reps.sum() == 12
    assert np.array_equal(reps, ref_placement.expert_placement(load, 8, 4))


def _placement_loads():
    rng = np.random.default_rng(11)
    for e in (4, 8, 16, 64):
        yield rng.integers(0, 500, size=e).astype(np.float32)
        yield np.full(e, 7.0, np.float32)          # every remainder ties
        yield np.zeros(e, np.float32)
        yield np.tile([3.0, 3.0, 1.0, 1.0], e // 4).astype(np.float32)
        yield rng.dirichlet(np.ones(e)).astype(np.float32)


def test_expert_placement_matches_reference_bitwise():
    n = 0
    for load in _placement_loads():
        for devices in (1, 4, 8):
            for budget in range(0, 2 * load.size + 3):
                got = expert_placement(load, devices, budget)
                want = ref_placement.expert_placement(load, devices, budget)
                assert got.dtype == want.dtype
                assert np.array_equal(got, want), (load, devices, budget)
                n += 1
    assert n > 1000


def test_moe_init_distributions():
    cfg = moe.MoEConfig(num_experts=4, top_k=2, d_ff=128, n_shared=2,
                        d_ff_shared=256)
    m = moe.moe_init(torch.Generator().manual_seed(0), 256, cfg,
                     dtype=torch.bfloat16)
    assert m.router.dtype == torch.float32
    assert m.w1.dtype == m.shared.w2.dtype == torch.bfloat16
    assert m.w1.shape == (4, 256, 128) and m.w2.shape == (4, 128, 256)
    assert m.shared.w1.shape == (256, 256)
    for p, std in ((m.router, 256 ** -0.5), (m.w1, 256 ** -0.5),
                   (m.w3, 256 ** -0.5), (m.w2, 128 ** -0.5),
                   (m.shared.w1, 256 ** -0.5), (m.shared.w2, 256 ** -0.5)):
        assert abs(float(p.detach().float().std()) / std - 1) < 0.05
    assert not torch.equal(m.w1[0], m.w1[1])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _ref_smoke(cfg_full):
    """``repro.configs.lm_common.lm_smoke``'s reduction of an MoE config."""
    m = cfg_full.moe
    m = dataclasses.replace(m, num_experts=min(m.num_experts, 8),
                            top_k=min(m.top_k, 2), d_ff=64,
                            d_ff_shared=64 if m.n_shared else 0)
    return dataclasses.replace(
        cfg_full, vocab=512, d_model=64, n_layers=2, n_heads=4,
        n_kv=max(1, 4 * cfg_full.n_kv // cfg_full.n_heads), head_dim=16,
        d_ff=0, moe=m, dtype="float32", q_chunk=32, kv_chunk=32)


def _without_chunks(cfg):
    out = dataclasses.asdict(cfg)
    for key in ("q_chunk", "kv_chunk"):
        out.pop(key)
    return out


@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_moe_configs_and_param_counts_match_reference(arch):
    ref_cfg, port_cfg = PAIRS[arch]
    assert dataclasses.asdict(port_cfg) == _without_chunks(ref_cfg)
    assert LM_ARCHS[arch] is port_cfg
    assert transformer.lm_param_count(port_cfg) == \
        ref_tf.lm_param_count(ref_cfg)
    assert transformer.lm_active_param_count(port_cfg) == \
        ref_tf.lm_active_param_count(ref_cfg)
    smoke = lm_common.smoke_config(port_cfg)
    assert dataclasses.asdict(smoke) == _without_chunks(_ref_smoke(ref_cfg))
    assert transformer.lm_param_count(smoke) == \
        ref_tf.lm_param_count(_ref_smoke(ref_cfg))
    assert transformer.lm_active_param_count(smoke) == \
        ref_tf.lm_active_param_count(_ref_smoke(ref_cfg))


def test_moe_param_counts():
    ds, phi = deepseek_moe_16b.CONFIG, phi35_moe_42b.CONFIG
    assert transformer.lm_param_count(ds) == 16_879_568_896
    assert transformer.lm_active_param_count(ds) == 2_830_747_648
    assert transformer.lm_param_count(phi) == 41_872_527_360
    model = transformer.LM(lm_common.smoke_config(ds), device="meta")
    assert sum(p.numel() for p in model.parameters()) == \
        transformer.lm_param_count(lm_common.smoke_config(ds))
    assert not hasattr(model.layers[0], "w1")
    assert model.layers[0].moe.router.dtype == torch.float32


def _models(arch):
    ref_full, port_full = PAIRS[arch]
    rcfg = _ref_smoke(ref_full)
    pcfg = lm_common.smoke_config(port_full)
    params = ref_tf.lm_init(jax.random.key(0), rcfg)
    model = transformer.lm_from_numpy(_np_tree(params), pcfg, device="cpu")
    return rcfg, params, pcfg, model


def _tokens(batch=2, length=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(
        0, 512, size=(batch, length)).astype(np.int32)


def _within_one_ulp(got, want):
    got, want = got.float(), want.float()
    return bool(((got - want).abs()
                 <= bf16_ulp(torch.maximum(got.abs(), want.abs()))).all())


@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_moe_prefill_matches_reference(arch):
    rcfg, params, pcfg, model = _models(arch)
    toks = _tokens()
    want, want_cache = ref_tf.lm_prefill(params, jnp.asarray(toks), rcfg)
    got, cache = transformer.lm_prefill(model, torch.tensor(toks).long(),
                                        pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LM_FP32_TOL, atol=LM_FP32_TOL)
    for key in ("k", "v"):
        assert cache[key].shape == (2, 2, PROMPT, pcfg.n_kv, 16)
        assert _within_one_ulp(cache[key],
                               torch.tensor(np.asarray(want_cache[key],
                                                       np.float32)))
    for blk in model.layers:  # each layer's stats of this prefill
        st = blk.moe.last_stats
        assert st["capacity"] == moe.capacity(2 * PROMPT, pcfg.moe)
        assert float(st["expert_load"].sum()) + int(st["dropped"]) == \
            2 * PROMPT * pcfg.moe.top_k


@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_moe_decode_matches_reference(arch):
    """Greedy decode from an empty fp32 cache, four steps, each step's
    logits within 1e-4 of the reference's."""
    rcfg, params, pcfg, model = _models(arch)
    toks = _tokens(seed=1)
    jc = ref_tf.init_decode_cache(rcfg, 2, 8, jnp.float32)
    tc = transformer.init_decode_cache(pcfg, 2, 8, dtype=torch.float32,
                                       device="cpu")
    step = toks[:, :1]
    for t in range(4):
        want, jc = ref_tf.lm_decode_step(params, jnp.asarray(step), jc,
                                         jnp.asarray(t + 1, jnp.int32), rcfg)
        got, tc = transformer.lm_decode_step(
            model, torch.tensor(step).long(), tc, t + 1, pcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LM_FP32_TOL, atol=LM_FP32_TOL)
        step = got.argmax(-1).numpy().astype(np.int32)[:, None]
        assert np.array_equal(step[:, 0], np.asarray(want).argmax(-1))
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=LM_FP32_TOL, atol=LM_FP32_TOL)


def test_moe_decode_matches_teacher_forced_prefill():
    """The reference's decode-consistency check (tests/test_models.py:
    142-164) on the port: capacity factor 8, so nothing drops in the
    prefill or in a decode step; the last step's logits equal the
    prefill's at the last position."""
    cfg = transformer.LMConfig(
        vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv=2, head_dim=8,
        d_ff=0, moe=moe.MoEConfig(num_experts=4, top_k=2, d_ff=32,
                                  capacity_factor=8.0))
    model = transformer.lm_init(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, 64, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    full, _ = transformer.lm_prefill(model, toks, cfg)
    assert all(int(b.moe.last_stats["dropped"]) == 0 for b in model.layers)
    cache = transformer.init_decode_cache(cfg, 2, 16, dtype=torch.float32,
                                          device="cpu")
    for t in range(12):
        logits, cache = transformer.lm_decode_step(model, toks[:, t:t + 1],
                                                   cache, t + 1, cfg)
        assert all(int(b.moe.last_stats["dropped"]) == 0
                   for b in model.layers)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_moe_lm_init_distributions():
    cfg = dataclasses.replace(lm_common.smoke_config(
        deepseek_moe_16b.CONFIG), d_model=256)
    model = transformer.lm_init(torch.Generator().manual_seed(0), cfg,
                                dtype=torch.bfloat16)
    a, b = model.layers[0].moe, model.layers[1].moe
    assert a.router.dtype == torch.float32 and a.w1.dtype == torch.bfloat16
    assert not torch.equal(a.w1, b.w1) and not torch.equal(a.router,
                                                           b.router)
    assert abs(float(a.w2.float().std()) / 64 ** -0.5 - 1) < 0.05
    assert abs(float(a.shared.w2.float().std()) / 64 ** -0.5 - 1) < 0.05


def test_moe_from_numpy_defaults_to_the_card():
    rcfg = ref_moe.MoEConfig(num_experts=4, top_k=2, d_ff=8)
    params = _np_tree(ref_moe.moe_init(jax.random.key(0), 8, rcfg))
    cfg = _port_cfg(rcfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            moe.moe_from_numpy(params, cfg)
    m = moe.moe_from_numpy(params, cfg, device="cpu")
    assert all(p.device.type == "cpu" for p in m.parameters())


@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_launcher_serves_moe_smoke_on_cpu(arch):
    report = launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                            "--prompt-len", "24", "--new-tokens", "3",
                            "--batch", "2", "--seed", "3"])
    cfg = lm_common.smoke_config(LM_ARCHS[arch])
    assert report["logits_finite"] and report["flash_launches"] == 0
    assert report["active_params"] == \
        transformer.lm_active_param_count(cfg) < report["params"]
    (req,) = report["requests"]
    ids = np.asarray(req["generated"])
    assert ids.shape == (2, 4) and ((ids >= 0) & (ids < 512)).all()
    st = req["moe_prefill"]
    tk = 2 * 24 * cfg.moe.top_k
    assert st["capacity"] == moe.capacity(2 * 24, cfg.moe)
    assert st["assignments"] == tk
    load = np.asarray(st["expert_load_by_layer"])
    assert load.shape == (cfg.n_layers, cfg.moe.num_experts)
    assert (load.sum(1) + np.asarray(st["dropped_by_layer"]) == tk).all()
    assert st["dropped"] == sum(st["dropped_by_layer"])
    assert st["dropped_share"] == st["dropped"] / (tk * cfg.n_layers)
    assert np.allclose(st["max_load_share_by_layer"],
                       load.max(1) / st["capacity"])
    assert (load <= st["capacity"]).all()
    # the report's first token is the argmax of a prefill on the same draw
    gen = torch.Generator().manual_seed(3)
    model = transformer.lm_init(gen, cfg, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=gen)
    logits, _ = transformer.lm_prefill(model, tokens, cfg)
    assert logits.argmax(-1).tolist() == [r[0] for r in req["generated"]]
    assert launcher.moe_prefill_report(model, 48) == st


def test_launcher_admits_what_fits_one_card(capsys):
    """deepseek-moe-16b (33.76 GB of bf16 weights) serves at full width;
    phi3.5-moe-42b only under ``--smoke``, and its refusal counts the
    parameters that make its 83.75 GB."""
    assert launcher.parse_args(["--arch", "deepseek-moe-16b"]).arch == \
        "deepseek-moe-16b"
    assert launcher.parse_args(["--arch", "phi3.5-moe-42b", "--smoke"]).smoke
    with pytest.raises(SystemExit) as exc:
        launcher.parse_args(["--arch", "phi3.5-moe-42b", "--seed", "1"])
    assert exc.value.code == 2
    assert "41,872,527,360 parameters, 83.75 GB" in capsys.readouterr().err


class _NamedStages:
    """``profile_lm._Stages`` without CUDA events: records stage names."""

    def __init__(self):
        self.names = []

    def start(self, name):
        self.names.append(name)

    def stop(self):
        pass

    def totals(self):
        from repro_torch.bench import profile_lm
        return {n: 0.0 for n in profile_lm.STAGES if n in self.names}


@pytest.mark.parametrize("arch", sorted(PAIRS) + ["qwen3-4b"])
def test_profile_split_equals_prefill_bitwise(arch, monkeypatch):
    """``bench/profile_lm.py``'s stage-by-stage prefill computes what
    ``lm_prefill`` computes, bit for bit, in bf16 serving weights; an MoE
    arch's FFN is split into router, dispatch, experts, combine (and
    shared), and its router stats equal ``lm_prefill``'s."""
    from repro_torch.bench import profile_lm
    monkeypatch.setattr(profile_lm, "_Stages", _NamedStages)
    cfg = lm_common.smoke_config(LM_ARCHS[arch])
    model = transformer.lm_init(torch.Generator().manual_seed(0), cfg,
                                dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (1, 96),
                         generator=torch.Generator().manual_seed(1))
    staged, stages = profile_lm.staged_prefill(model, toks, cfg)
    staged_stats = [b.moe.last_stats for b in model.layers] if cfg.moe \
        else []
    want, _ = transformer.lm_prefill(model, toks, cfg)
    assert torch.equal(staged, want)
    moe_stages = ["router", "dispatch", "experts", "combine"]
    if cfg.moe is None:
        assert "ffn" in stages and not set(moe_stages) & set(stages)
        return
    assert "ffn" not in stages and set(moe_stages) <= set(stages)
    assert ("shared" in stages) == bool(cfg.moe.n_shared)
    for st, blk in zip(staged_stats, model.layers):
        assert torch.equal(st["expert_load"],
                           blk.moe.last_stats["expert_load"])
