"""The port's dense LM serving path (``repro_torch.models.transformer``,
``models.attention``, ``configs.lm_common`` and the LM configs, the
``repro_torch.launch.lm`` launcher) against the reference, on the CPU at
the reference's smoke reduction, with weights carried from
``repro.models.transformer.lm_init`` by ``lm_from_numpy`` and tokens from
``np.random.default_rng``.

Tolerances: fp32 logits within 1e-4; the bf16 KV cache within one bf16 ulp
(both sides compute k/v in fp32 and round once). A bf16 model (weights and
activations) rounds at many places, in other orders on the two sides, and
the reference's ``blockwise_attention`` rounds ``p`` to bf16 where the
kernel keeps it fp32: bf16 logits and caches within 0.0625, four bf16 ulps
at their magnitude (2–4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import codeqwen15_7b as ref_codeqwen
from repro.configs import qwen3_4b as ref_qwen3
from repro.configs import qwen15_4b as ref_qwen15
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro_torch.configs import (LM_ARCHS, codeqwen15_7b, lm_common,
                                 qwen3_4b, qwen15_4b)
from repro_torch.kernels import flash_attention as fa_pkg
from repro_torch.kernels.flash_attention.ref import bf16_ulp
from repro_torch.launch import lm as launcher
from repro_torch.models import attention, common, transformer

FP32_TOL = 1e-4
BF16_TOL = 0.0625
PAIRS = {"qwen3-4b": (ref_qwen3.CONFIG, qwen3_4b.CONFIG),
         "qwen1.5-4b": (ref_qwen15.CONFIG, qwen15_4b.CONFIG)}
PROMPT = 40


def _ref_smoke(cfg, dtype="float32"):
    """``repro.configs.lm_common.lm_smoke``'s reduction of ``cfg``."""
    return dataclasses.replace(
        cfg, vocab=512, d_model=64, n_layers=2, n_heads=4,
        n_kv=max(1, 4 * cfg.n_kv // cfg.n_heads), head_dim=16, d_ff=128,
        dtype=dtype, q_chunk=32, kv_chunk=32)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _models(arch, dtype):
    """(reference cfg, reference params, port cfg, port model) at the smoke
    reduction, weights and activations in ``dtype``."""
    ref_full, port_full = PAIRS[arch]
    rcfg = _ref_smoke(ref_full, dtype)
    pcfg = dataclasses.replace(lm_common.smoke_config(port_full), dtype=dtype)
    params = ref_tf.lm_init(jax.random.key(0), rcfg, dtype=jnp.dtype(dtype))
    np_params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                       params)
    model = transformer.lm_from_numpy(np_params, pcfg,
                                      dtype=getattr(torch, dtype),
                                      device="cpu")
    return rcfg, params, pcfg, model


def _tokens(batch=2, length=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(
        0, 512, size=(batch, length)).astype(np.int32)


def _within_one_ulp(got, want):
    """|got - want| ≤ one bf16 ulp of the larger magnitude."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs()
                 <= bf16_ulp(torch.maximum(got.abs(), want.abs()))).all())


@pytest.mark.parametrize("name,ref_cfg,port_cfg", [
    ("qwen3_4b", ref_qwen3.CONFIG, qwen3_4b.CONFIG),
    ("qwen15_4b", ref_qwen15.CONFIG, qwen15_4b.CONFIG),
    ("codeqwen15_7b", ref_codeqwen.CONFIG, codeqwen15_7b.CONFIG)])
def test_configs_match_reference(name, ref_cfg, port_cfg):
    """Value for value, but the reference's blockwise chunking."""
    ref = dataclasses.asdict(ref_cfg)
    for key in ("q_chunk", "kv_chunk"):
        ref.pop(key)
    assert dataclasses.asdict(port_cfg) == ref
    assert transformer.lm_param_count(port_cfg) == \
        ref_tf.lm_param_count(ref_cfg)
    assert transformer.lm_active_param_count(port_cfg) == \
        ref_tf.lm_active_param_count(ref_cfg)
    assert port_cfg.adtype == torch.bfloat16


def test_qwen3_param_count_and_registry():
    assert transformer.lm_param_count(qwen3_4b.CONFIG) == 4_411_415_040
    assert set(LM_ARCHS) == {"qwen3-4b", "qwen1.5-4b", "codeqwen1.5-7b",
                             "deepseek-moe-16b", "phi3.5-moe-42b"}
    assert lm_common.SHAPES["prefill_32k"] == dict(kind="prefill",
                                                   seq=32768, batch=32)


@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_smoke_config_matches_lm_smoke(arch):
    ref_full, port_full = PAIRS[arch]
    ref = dataclasses.asdict(_ref_smoke(ref_full))
    for key in ("q_chunk", "kv_chunk"):
        ref.pop(key)
    assert dataclasses.asdict(lm_common.smoke_config(port_full)) == ref


@pytest.mark.parametrize("x_dtype,g_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32")])
def test_rms_norm_matches_reference(x_dtype, g_dtype):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(3, 5, 48)) * 3, jnp.dtype(x_dtype))
    g = jnp.asarray(rng.normal(size=(48,)), jnp.dtype(g_dtype))
    want = ref_common.rms_norm({"g": g}, x)
    got = common.rms_norm(_t(x).to(getattr(torch, x_dtype)),
                          _t(g).to(getattr(torch, g_dtype)))
    assert got.dtype == getattr(torch, x_dtype)
    if x_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    else:
        assert _within_one_ulp(got, _t(want))
    norm = common.RMSNorm(48)
    assert torch.equal(norm.weight, torch.ones(48))
    assert torch.equal(norm(_t(x)), common.rms_norm(_t(x), torch.ones(48)))


def test_rope_matches_reference():
    rng = np.random.default_rng(2)
    pos = np.array([0, 1, 7, 63, 300, 32767])
    cos_r, sin_r = ref_attn.rope_angles(jnp.asarray(pos), 16, 1e6)
    cos, sin = attention.rope_angles(torch.tensor(pos), 16, 1e6)
    assert cos.dtype == torch.float32 and cos.shape == (6, 8)
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_r), atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_r), atol=2e-6)
    for dtype in ("float32", "bfloat16"):
        x = jnp.asarray(rng.normal(size=(2, 6, 3, 16)), jnp.dtype(dtype))
        c, s = ref_attn.rope_angles(jnp.arange(6), 16)
        want = ref_attn.apply_rope(x, c[None], s[None])
        c_t, s_t = attention.rope_angles(torch.arange(6), 16)
        got = attention.apply_rope(_t(x).to(getattr(torch, dtype)),
                                   c_t[None], s_t[None])
        assert got.dtype == getattr(torch, dtype)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6)
        else:  # rotated in fp32 on both sides, rounded once
            assert _within_one_ulp(got, _t(want))


def test_decode_attention_and_expand_kv_match_reference():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 1, 8, 16))
    kc = rng.normal(size=(2, 10, 2, 16))
    vc = rng.normal(size=(2, 10, 2, 16))
    for dtype in ("float32", "bfloat16"):
        jdt = jnp.dtype(dtype)
        want = ref_attn.decode_attention(
            jnp.asarray(q, jnp.float32), jnp.asarray(kc, jdt),
            jnp.asarray(vc, jdt), jnp.asarray(7))
        tdt = getattr(torch, dtype)
        got = attention.decode_attention(
            torch.tensor(q, dtype=torch.float32),
            _t(jnp.asarray(kc, jdt)).to(tdt), _t(jnp.asarray(vc, jdt)).to(tdt),
            7)
        # bf16: p is rounded to bf16 on both sides after sums taken in
        # other orders, so a p may land one bf16 ulp apart
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-6 if dtype == "float32" else 2e-3)
    k = torch.tensor(kc, dtype=torch.float32)
    assert torch.equal(attention._expand_kv(k, 4),
                       _t(ref_attn._expand_kv(jnp.asarray(kc), 4)))
    assert attention._expand_kv(k, 1) is k


@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_prefill_matches_reference(arch):
    rcfg, params, pcfg, model = _models(arch, "float32")
    toks = _tokens()
    want, want_cache = ref_tf.lm_prefill(params, jnp.asarray(toks), rcfg)
    got, cache = transformer.lm_prefill(model, torch.tensor(toks).long(),
                                        pcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FP32_TOL, atol=FP32_TOL)
    for key in ("k", "v"):
        assert cache[key].dtype == torch.bfloat16
        assert cache[key].shape == (2, 2, PROMPT, pcfg.n_kv, 16)
        assert _within_one_ulp(cache[key], _t(want_cache[key]))


@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_decode_step_matches_reference(arch):
    """One step on the reference's prefill cache (fp32 decode cache, as
    ``lm_smoke`` uses), then three more from an empty cache."""
    rcfg, params, pcfg, model = _models(arch, "float32")
    toks = _tokens()
    _, pre = ref_tf.lm_prefill(params, jnp.asarray(toks), rcfg)
    jc = ref_tf.init_decode_cache(rcfg, 2, PROMPT + 1, jnp.float32)
    jc = {k: c.at[:, :, :PROMPT].set(pre[k].astype(jnp.float32))
          for k, c in jc.items()}
    tc = transformer.init_decode_cache(pcfg, 2, PROMPT + 1,
                                       dtype=torch.float32, device="cpu")
    for k in ("k", "v"):
        tc[k][:, :, :PROMPT] = _t(pre[k])
    tok = np.array([[3], [7]], np.int32)
    want, jc = ref_tf.lm_decode_step(params, jnp.asarray(tok), jc,
                                     jnp.asarray(PROMPT + 1, jnp.int32),
                                     rcfg)
    got, out = transformer.lm_decode_step(model, torch.tensor(tok).long(),
                                          tc, PROMPT + 1, pcfg)
    assert out is tc
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FP32_TOL, atol=FP32_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=FP32_TOL, atol=FP32_TOL)

    jc = ref_tf.init_decode_cache(rcfg, 2, 8, jnp.float32)
    tc = transformer.init_decode_cache(pcfg, 2, 8, dtype=torch.float32,
                                       device="cpu")
    for t in range(3):
        step = toks[:, t:t + 1]
        want, jc = ref_tf.lm_decode_step(params, jnp.asarray(step), jc,
                                         jnp.asarray(t + 1, jnp.int32), rcfg)
        got, tc = transformer.lm_decode_step(
            model, torch.tensor(step).long(), tc, t + 1, pcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_bf16_model_matches_reference_loosely(arch):
    """bf16 weights and activations: prefill logits and cache, then one
    decode step on a bf16 cache, within ``BF16_TOL``."""
    rcfg, params, pcfg, model = _models(arch, "bfloat16")
    toks = _tokens(seed=4)
    want, want_cache = ref_tf.lm_prefill(params, jnp.asarray(toks), rcfg)
    got, cache = transformer.lm_prefill(model, torch.tensor(toks).long(),
                                        pcfg)
    assert float((got - _t(want)).abs().max()) <= BF16_TOL
    for key in ("k", "v"):
        assert float((cache[key].float() - _t(want_cache[key])).abs()
                     .max()) <= BF16_TOL
    jc = ref_tf.init_decode_cache(rcfg, 2, PROMPT + 1)
    jc = {k: c.at[:, :, :PROMPT].set(want_cache[k]) for k, c in jc.items()}
    tc = transformer.init_decode_cache(pcfg, 2, PROMPT + 1, device="cpu")
    for k in ("k", "v"):
        tc[k][:, :, :PROMPT] = _t(want_cache[k])
    tok = np.array([[5], [9]], np.int32)
    want, _ = ref_tf.lm_decode_step(params, jnp.asarray(tok), jc,
                                    jnp.asarray(PROMPT + 1, jnp.int32), rcfg)
    got, _ = transformer.lm_decode_step(model, torch.tensor(tok).long(), tc,
                                        PROMPT + 1, pcfg)
    assert float((got - _t(want)).abs().max()) <= BF16_TOL


def test_prefill_attention_is_one_flash_call_per_layer(monkeypatch):
    """The transformer reaches the kernel through ``ops.flash_attention``
    once per layer, causal, with q (B, S, H, dh) and k/v (B, S, KV, dh)."""
    from repro_torch.kernels.flash_attention import ops
    _, _, pcfg, model = _models("qwen3-4b", "float32")
    calls = []
    original = ops.flash_attention

    def spy(q, k, v, *, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return original(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "flash_attention", spy)
    before = fa_pkg.LAUNCHES.value
    transformer.lm_prefill(model, torch.tensor(_tokens()).long(), pcfg)
    assert calls == [((2, PROMPT, 4, 16), (2, PROMPT, 1, 16), True)] * 2
    assert fa_pkg.LAUNCHES.value == before  # CPU tensors: plain version


def test_lm_init_distributions():
    cfg = dataclasses.replace(lm_common.smoke_config(qwen15_4b.CONFIG),
                              d_model=256, d_ff=512, vocab=1024)
    model = transformer.lm_init(torch.Generator().manual_seed(0), cfg)
    blk = model.layers[0]
    for p, std in ((model.embed, 0.02), (model.unembed, 256 ** -0.5),
                   (blk.wq, 256 ** -0.5), (blk.wo, 64 ** -0.5),
                   (blk.w1, 256 ** -0.5), (blk.w2, 512 ** -0.5)):
        assert abs(float(p.detach().std()) / std - 1) < 0.05
        assert abs(float(p.detach().mean())) < 0.1 * std
    assert torch.equal(blk.ln1.weight, torch.ones(256))
    assert not blk.bq.any() and not blk.bv.any()
    assert not torch.equal(blk.wq, model.layers[1].wq)
    bf = transformer.lm_init(torch.Generator().manual_seed(0), cfg,
                             dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())


def test_launcher_smoke_on_cpu():
    """``--smoke --device cpu`` end to end: two requests of greedy decode,
    the first token the argmax of a prefill on the same weights and
    prompt, no kernel launch on the CPU."""
    report = launcher.main(["--smoke", "--device", "cpu", "--prompt-len",
                            "24", "--new-tokens", "3", "--requests", "2",
                            "--batch", "2", "--seed", "5"])
    assert report["logits_finite"] and report["flash_launches"] == 0
    assert report["peak_bytes"] is None and len(report["requests"]) == 2
    for req in report["requests"]:
        ids = np.asarray(req["generated"])
        assert ids.shape == (2, 4) and ((ids >= 0) & (ids < 512)).all()
        assert req["prefill_ms"] > 0 and req["decode_ms_per_token"] > 0
    cfg = lm_common.smoke_config(qwen3_4b.CONFIG)
    gen = torch.Generator().manual_seed(5)
    model = transformer.lm_init(gen, cfg, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=gen)
    logits, _ = transformer.lm_prefill(model, tokens, cfg)
    first = [r[0] for r in report["requests"][0]["generated"]]
    assert logits.argmax(-1).tolist() == first


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b"])
def test_launcher_refuses_moe_archs(arch, capsys):
    """Only an MoE arch whose bf16 weights exceed one card is refused at
    full width; the message gives the reckoning and the four-card item."""
    with pytest.raises(SystemExit) as exc:
        launcher.parse_args(["--arch", arch])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "83.75 GB of bf16 weights against one 80 GB card" in err
    assert "ROADMAP A13" in err


def test_launcher_defaults_and_cuda_without_card():
    args = launcher.parse_args([])
    assert (args.arch, args.device, args.batch, args.prompt_len,
            args.new_tokens, args.requests) == ("qwen3-4b", "cuda", 1,
                                                32768, 16, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            launcher.main(["--smoke"])


@pytest.mark.parametrize("fn", ["init_decode_cache", "lm_from_numpy"])
def test_model_entry_points_default_to_the_card(fn):
    """Both run on the card unless the caller asks for the CPU: the default
    goes through ``resolve_device``, so without a card it raises, and
    ``device="cpu"`` puts every tensor on the CPU."""
    rcfg = _ref_smoke(ref_qwen3.CONFIG)
    pcfg = lm_common.smoke_config(qwen3_4b.CONFIG)
    if fn == "init_decode_cache":
        def make(**kw):
            cache = transformer.init_decode_cache(pcfg, 1, 4, **kw)
            return list(cache.values())
    else:
        params = jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float32),
            ref_tf.lm_init(jax.random.key(0), rcfg))

        def make(**kw):
            return list(transformer.lm_from_numpy(params, pcfg,
                                                  **kw).parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    else:
        assert all(t.device.type == "cuda" for t in make())
    assert all(t.device.type == "cpu" for t in make(device="cpu"))
