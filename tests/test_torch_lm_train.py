"""The port's LM training path (``models/attention.py::blockwise_attention``
and ``reference_attention``, ``models/transformer.py::lm_forward`` and
``lm_loss``, ``configs/lm_common.py::train_step``, the LM launcher's
``--shape train_4k``) and ``training/optimizer.py``'s in-place update,
against the reference on the CPU at ``lm_smoke``'s reduction, weights
carried from ``repro.models.transformer.lm_init`` and tokens from
``np.random.default_rng``.

The train step is held against the reference's own cell step,
``build_lm_cell(cfg, "train_4k", None).step_fn``, built with its
``AdamW(lr=3e-4)`` replaced by one at lr 1e-2 with no warm-up (weight
decay 0.1 and clipping at 1 kept), so that the step moves every entry by
about 1e-2. Tolerances, fp32 throughout:

* loss within 1e-5 (the same sums in another order);
* the optimizer's first moment after the step, ``mu = 0.1·(clipped
  gradient)``, per parameter within 1e-5 of its largest entry;
* each parameter's change within 1e-4 per entry and 1e-3 of its norm,
  over the entries whose gradient is 0 or above 1e-5 of the parameter's
  largest: Adam's first step moves an entry by ``lr·g/(|g| + 1e-8)``, so
  an entry whose gradient is within rounding of zero moves by an amount
  rounding decides; every entry's gradient is still held by the
  first-moment check. At most 1 in 100 entries may be left out (14–40 of
  ~135,000–150,000 here). A missing update or a wrong sign is off by
  ~1e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.lm_common as ref_lm_common
from repro.configs import codeqwen15_7b as ref_codeqwen
from repro.configs import deepseek_moe_16b as ref_deepseek
from repro.configs import phi35_moe_42b as ref_phi
from repro.configs import qwen3_4b as ref_qwen3
from repro.configs import qwen15_4b as ref_qwen15
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro.training.optimizer import AdamW as JaxAdamW
from repro_torch.configs import LM_ARCHS, lm_common
from repro_torch.launch import lm as launcher
from repro_torch.models import attention, common, transformer
from repro_torch.training import StageTimer
from repro_torch.training.optimizer import AdamW, AdamWState

REF_CONFIGS = {"qwen3-4b": ref_qwen3.CONFIG, "qwen1.5-4b": ref_qwen15.CONFIG,
               "codeqwen1.5-7b": ref_codeqwen.CONFIG,
               "deepseek-moe-16b": ref_deepseek.CONFIG,
               "phi3.5-moe-42b": ref_phi.CONFIG}
OPT = dict(lr=1e-2, warmup_steps=1)
SEQ, BATCH = 64, 2
GRAD_TOL = 1e-5
STEP_ATOL, STEP_NORM = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its shapes are tiny, and the
    suite's parallel workers would otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref_smoke(cfg):
    """``repro.configs.lm_common.lm_smoke``'s reduction of ``cfg``."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, num_experts=min(moe.num_experts, 8),
                                  top_k=min(moe.top_k, 2), d_ff=64,
                                  d_ff_shared=64 if moe.n_shared else 0)
    return dataclasses.replace(
        cfg, vocab=512, d_model=64, n_layers=2, n_heads=4,
        n_kv=max(1, 4 * cfg.n_kv // cfg.n_heads), head_dim=16,
        d_ff=128 if cfg.moe is None else 0, moe=moe, dtype="float32",
        q_chunk=32, kv_chunk=32)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32)
            for k in ("tokens", "targets")}


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _as_port(tree, cfg):
    """A reference parameter tree as the port's state dict."""
    return transformer.lm_from_numpy(_np(tree), cfg,
                                     device="cpu").state_dict()


def _ref_step(rcfg, params, batch):
    """The reference cell's step at ``OPT``: (new params, mu, loss)."""
    saved = ref_lm_common.AdamW
    ref_lm_common.AdamW = lambda lr: JaxAdamW(**OPT)
    try:
        cell = ref_lm_common.build_lm_cell(rcfg, "train_4k", None)
    finally:
        ref_lm_common.AdamW = saved
    state = JaxAdamW(**OPT).init(params)
    new, state, loss = cell.step_fn(
        params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    return new, state.mu, float(loss)


def _hold_step(old, new_ref, new_got, mu_ref, mu_got):
    """The module docstring's first-moment and parameter-change checks;
    returns how many entries were left out as within rounding of zero."""
    left_out = 0
    for k in new_ref:
        m_ref, m_got = mu_ref[k], mu_got[k]
        size = float(m_ref.abs().max())
        assert float((m_got - m_ref).abs().max()) <= GRAD_TOL * size, k
        d_ref, d_got = new_ref[k] - old[k], new_got[k] - old[k]
        # an exact zero (an embedding row no token of the batch reads) is
        # zero on both sides and moves by the weight decay alone
        keep = (m_ref.abs() > GRAD_TOL * size) | (m_ref == 0)
        left_out += int((~keep).sum())
        assert float(d_ref.abs().max()) > 5e-3, k   # the step moved it
        diff = (d_got - d_ref)[keep]
        assert float(diff.abs().max()) <= STEP_ATOL, k
        assert float(diff.norm()) <= STEP_NORM * float(d_ref.norm()), k
    return left_out


@pytest.mark.parametrize("arch", sorted(REF_CONFIGS))
def test_train_step_matches_reference_cell(arch):
    rcfg = _ref_smoke(REF_CONFIGS[arch])
    pcfg = lm_common.smoke_config(LM_ARCHS[arch])
    params = ref_tf.lm_init(jax.random.key(0), rcfg)
    batch = _batch()
    new_ref, mu_ref, loss_ref = _ref_step(rcfg, params, batch)

    model = transformer.lm_from_numpy(_np(params), pcfg, device="cpu")
    old = {k: v.clone() for k, v in model.state_dict().items()}
    opt = AdamW(**OPT)
    state = opt.init(dict(model.named_parameters()))
    state, loss = lm_common.train_step(model, opt, state, _port_batch(batch),
                                       pcfg, chunks=lm_common.SMOKE_CHUNKS)
    assert state.step == 1
    assert abs(float(loss) - loss_ref) <= 1e-5
    left_out = _hold_step(old, _as_port(new_ref, pcfg), model.state_dict(),
                          _as_port(mu_ref, pcfg), state.mu)
    n = sum(v.numel() for v in old.values())
    assert left_out <= n // 100
    assert all(p.grad is None for p in model.parameters())


def test_micro_two_equals_micro_one():
    """The micro path (gradients summed in ``.grad`` from zero, over 2)
    against one micro-batch: the same loss and step, within the module's
    tolerances (two half-batch means and their sum round differently)."""
    pcfg = lm_common.smoke_config(LM_ARCHS["qwen3-4b"])
    batch = _port_batch(_batch(seed=4))
    runs = []
    for micro in (1, 2):
        model = transformer.lm_init(torch.Generator().manual_seed(0), pcfg)
        old = {k: v.clone() for k, v in model.state_dict().items()}
        opt = AdamW(**OPT)
        state = opt.init(dict(model.named_parameters()))
        state, loss = lm_common.train_step(model, opt, state, batch, pcfg,
                                           micro=micro,
                                           chunks=lm_common.SMOKE_CHUNKS)
        runs.append((float(loss), model.state_dict(), state.mu))
    (l1, p1, m1), (l2, p2, m2) = runs
    assert abs(l1 - l2) <= 1e-5
    _hold_step(old, p1, p2, m1, m2)
    with pytest.raises(ValueError, match="micro-batches"):
        lm_common.train_step(model, opt, state, batch, pcfg, micro=3)


def _attention_case(seed, sq, skv, h, kv, dh):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((2, sq, h, dh), (2, skv, kv, dh), (2, skv, kv, dh))]


# Each limit is of the tensor's largest magnitude: (output, gradients).
# fp32: the same sums in another order. bf16: both sides round q, k, v,
# ``p`` and the output to bf16 at the same points of the forward, so the
# outputs agree to within 1.4e-6 (CPU reading: 0 and 1.33e-6 in the two
# bf16 cases); an otherwise identical blockwise pass that keeps ``p`` in
# fp32 is off by 2.72e-3 and 4.26e-3 there
# (``test_blockwise_attention_bf16_limit_rejects_fp32_p``), so 1e-4 tells
# the two apart. The gradients cannot: the reference's ``jax.grad`` of its
# loop rounds the cotangents to bf16 at points of its own, 3.6e-3–7.1e-3
# from the port's gradients with bf16 ``p`` and 3.6e-3–7.1e-3 from the
# fp32-``p`` control's alike; 1e-2 holds them above that reading.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-4, 1e-2)}
BF16_CASES = [(True, 3, (32, 16)), (False, 0, (16, 32))]


def _reference_attention_grads(q, k, v, dtype, causal, q_offset, chunks):
    """The reference's ``blockwise_attention`` output and the q/k/v
    gradients of ``sum(out²)`` under ``jax.grad``, as fp32 tensors."""
    qc, kc = chunks

    def ref_loss(q, k, v):
        out = ref_attn.blockwise_attention(q, k, v, causal=causal,
                                           q_chunk=qc, kv_chunk=kc,
                                           q_offset=q_offset)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, out), grads = jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x, jnp.dtype(dtype)) for x in (q, k, v)))
    return [torch.tensor(np.asarray(x, np.float32)) for x in (out, *grads)]


def _errors(got, want):
    """Each tensor's max |got - want| over its largest |want|."""
    return [float((g.detach().float() - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("dtype,causal,q_offset,chunks", [
    ("float32", True, 3, (32, 16)), ("float32", True, -20, (16, 32)),
    ("float32", False, 0, (32, 16)), ("float32", True, 0, (512, 1024)),
    *(("bfloat16", *case) for case in BF16_CASES)])
def test_blockwise_attention_matches_reference(dtype, causal, q_offset,
                                               chunks):
    """Output and q/k/v gradients of ``sum(out²)`` against the reference's
    ``blockwise_attention`` under ``jax.grad``, at 70 queries and keys
    (chunks that do not divide them), GQA 4|2, a causal offset (negative:
    the first rows attend nothing and give zeros), and without the causal
    mask; the reference's default chunks clipped to the lengths. Within
    ``TOL[dtype]`` (its comment)."""
    q, k, v = _attention_case(0, 70, 70, 4, 2, 16)
    want = _reference_attention_grads(q, k, v, dtype, causal, q_offset,
                                      chunks)
    tq, tk, tv = (torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
                  for x in (q, k, v))
    out = attention.blockwise_attention(tq, tk, tv, causal=causal,
                                        q_chunk=chunks[0],
                                        kv_chunk=chunks[1],
                                        q_offset=q_offset)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    (out.float() ** 2).sum().backward()
    out_err, *grad_errs = _errors((out, tq.grad, tk.grad, tv.grad), want)
    out_tol, grad_tol = TOL[dtype]
    assert out_err <= out_tol
    assert max(grad_errs) <= grad_tol
    if q_offset < 0:
        assert not out[:, :-q_offset].float().abs().any()


@pytest.mark.parametrize("causal,q_offset,chunks", BF16_CASES)
def test_blockwise_attention_bf16_limit_rejects_fp32_p(causal, q_offset,
                                                       chunks):
    """The control for ``TOL["bfloat16"]``'s output limit: the same
    blockwise pass over the same bf16 values with ``p`` kept in fp32 (the
    ``flash_attention`` kernel's choice), its output cast to bf16, is off
    the reference by more than the limit, so the limit sees where ``p``
    is rounded."""
    q, k, v = _attention_case(0, 70, 70, 4, 2, 16)
    want = _reference_attention_grads(q, k, v, "bfloat16", causal, q_offset,
                                      chunks)[0]
    tq, tk, tv = (torch.tensor(x).to(torch.bfloat16).float()
                  for x in (q, k, v))
    control = attention.blockwise_attention(
        tq, tk, tv, causal=causal, q_chunk=chunks[0], kv_chunk=chunks[1],
        q_offset=q_offset).to(torch.bfloat16)
    assert _errors([control], [want])[0] > 10 * TOL["bfloat16"][0]


def test_blockwise_attention_skips_only_fully_masked_blocks(monkeypatch):
    """At 4 query and 4 key chunks, causal, the forward computes the 10
    blocks on or below the diagonal, and the backward the same 10."""
    calls = []
    original = attention._block_scores

    def counting(*args):
        calls.append(args[2:4])
        return original(*args)

    monkeypatch.setattr(attention, "_block_scores", counting)
    q, k, v = (torch.randn(1, 64, 2, 8, requires_grad=True)
               for _ in range(3))
    attention.blockwise_attention(q, k, v, q_chunk=16,
                                  kv_chunk=16).sum().backward()
    assert len(calls) == 20 and all(j <= i for i, j in calls)


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 5),
                                             (False, 0)])
def test_reference_attention_matches_reference(causal, q_offset):
    q, k, v = _attention_case(1, 24, 30, 4, 2, 8)
    want = ref_attn.reference_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                        causal=causal, q_offset=q_offset)
    got = attention.reference_attention(*(torch.from_numpy(x)
                                          for x in (q, k, v)),
                                        causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_chunked_cross_entropy_equals_whole_logits():
    """The chunked loss and its gradients against autograd of the whole
    ``(N, V)`` logits, at a chunk that does not divide N."""
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(37, 16, generator=gen, requires_grad=True)
    u = torch.randn(16, 50, generator=gen, requires_grad=True)
    tgt = torch.randint(0, 50, (37,), generator=gen)
    nll = transformer.ChunkedCrossEntropy.apply(h, u, tgt, 8)
    w = torch.rand(37, generator=gen)
    gh, gu = torch.autograd.grad((nll * w).sum(), (h, u))
    logits = h @ u
    want = torch.logsumexp(logits, -1) - logits.gather(1, tgt[:, None])[:, 0]
    wh, wu = torch.autograd.grad((want * w).sum(), (h, u))
    torch.testing.assert_close(nll, want, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(gh, wh, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gu, wu, rtol=1e-5, atol=1e-6)


def test_lm_loss_matches_reference_moe_aux():
    """``lm_loss`` (nll plus the routers' aux loss) against the reference's
    on an MoE config, and the value the aux adds."""
    rcfg = _ref_smoke(ref_deepseek.CONFIG)
    pcfg = lm_common.smoke_config(LM_ARCHS["deepseek-moe-16b"])
    params = ref_tf.lm_init(jax.random.key(2), rcfg)
    b = _batch(seed=7)
    want = float(ref_tf.lm_loss(params, jnp.asarray(b["tokens"]),
                                jnp.asarray(b["targets"]), rcfg))
    model = transformer.lm_from_numpy(_np(params), pcfg, device="cpu")
    pb = _port_batch(b)
    got = transformer.lm_loss(model, pb["tokens"], pb["targets"], pcfg,
                              **lm_common.SMOKE_CHUNKS)
    assert abs(float(got.detach()) - want) <= 1e-5
    _, aux = transformer.lm_forward(model, pb["tokens"], pcfg,
                                    **lm_common.SMOKE_CHUNKS)
    assert 0 < float(aux) < 1


def _old_update(opt, grads, state, params):
    """``AdamW.update`` as it was before it worked in place: new clipped
    gradients, new ``mu``/``nu`` dicts."""
    step = state.step + 1
    if opt.clip_norm is not None:
        from repro_torch.training.optimizer import global_norm
        scale = torch.clamp(opt.clip_norm
                            / (global_norm(grads.values()) + 1e-9), max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
    b1, b2 = opt.b1, opt.b2
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    lr = opt.schedule(step)
    mu, nu = {}, {}
    for k, p in params.items():
        g = grads[k].float()
        mu[k] = b1 * state.mu[k] + (1 - b1) * g
        nu[k] = b2 * state.nu[k] + (1 - b2) * torch.square(g)
        u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + opt.eps)
        u = u + opt.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    return params, AdamWState(step=step, mu=mu, nu=nu)


@pytest.mark.parametrize("kw", [
    dict(lr=0.05, weight_decay=0.1, clip_norm=0.5, warmup_steps=3),
    dict(lr=1e-3, weight_decay=0.0, clip_norm=None, warmup_steps=1),
    dict()])
@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
def test_in_place_update_keeps_bits(kw, pdtype):
    """Four updates: parameters, ``mu`` and ``nu`` bitwise equal to the
    out-of-place update's; the parameters and the state are the same
    tensors throughout (``data_ptr``), and the gradients are not
    written."""
    gen = torch.Generator().manual_seed(0)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    params = {k: torch.randn(s, generator=gen).to(pdtype)
              for k, s in shapes.items()}
    twin = {k: p.clone() for k, p in params.items()}
    opt = AdamW(**kw)
    state, twin_state = opt.init(params), opt.init(twin)
    ptrs = {k: (p.data_ptr(), state.mu[k].data_ptr(),
                state.nu[k].data_ptr()) for k, p in params.items()}
    for _ in range(4):
        grads = {k: torch.randn(s, generator=gen).to(pdtype)
                 for k, s in shapes.items()}
        before = {k: g.clone() for k, g in grads.items()}
        _, state = opt.update(grads, state, params)
        _, twin_state = _old_update(opt, grads, twin_state, twin)
        for k in shapes:
            assert torch.equal(grads[k], before[k])
            for got, want in ((params[k], twin[k]),
                              (state.mu[k], twin_state.mu[k]),
                              (state.nu[k], twin_state.nu[k])):
                assert torch.equal(got.view(torch.int16 if got.dtype ==
                                            torch.bfloat16 else torch.int32),
                                   want.view(torch.int16 if want.dtype ==
                                             torch.bfloat16 else
                                             torch.int32)), k
            assert (params[k].data_ptr(), state.mu[k].data_ptr(),
                    state.nu[k].data_ptr()) == ptrs[k]
    assert state.step == twin_state.step == 4


def test_param_bytes_matches_reference():
    """fp32 weights: the reference's ``param_bytes`` of its tree; bf16: two
    bytes an entry."""
    pcfg = lm_common.smoke_config(LM_ARCHS["deepseek-moe-16b"])
    params = ref_tf.lm_init(jax.random.key(0),
                            _ref_smoke(ref_deepseek.CONFIG))
    model = transformer.lm_from_numpy(_np(params), pcfg, device="cpu")
    assert common.param_bytes(model) == ref_common.param_bytes(params)
    dense = transformer.lm_init(torch.Generator().manual_seed(0),
                                lm_common.smoke_config(LM_ARCHS["qwen3-4b"]),
                                dtype=torch.bfloat16)
    assert common.param_bytes(dense) == 2 * common.count_params(dense)


def test_launcher_trains_smoke_on_cpu(capsys):
    report = launcher.main(["--shape", "train_4k", "--smoke", "--device",
                            "cpu", "--steps", "2", "--batch", "2"])
    assert report["shape"] == "train_4k" and report["micro"] == 2
    assert report["seq"] == 64 and report["steps"] == 2
    assert len(report["losses"]) == 2 and all(
        np.isfinite(x) for x in report["losses"])
    assert abs(report["losses"][0] - np.log(512)) < 1.0
    assert set(report["stage_ms"][0]) == {"forward", "backward",
                                          "optimizer"}
    assert '"shape": "train_4k"' in capsys.readouterr().out


@pytest.mark.parametrize("arch,gb,world", [("codeqwen1.5-7b", "131.0", 2),
                                           ("deepseek-moe-16b", "270.1", 4),
                                           ("phi3.5-moe-42b", "670.0", 16)])
def test_launcher_refuses_train_state_beyond_one_card(arch, gb, world,
                                                      capsys):
    """World 1 is refused, naming the rule that splits the state (ZeRO-1,
    ROADMAP A10b; an MoE's full FSDP) and the smallest ``--mesh-world``
    that fits, one shard a card."""
    with pytest.raises(SystemExit) as e:
        launcher.parse_args(["--shape", "train_4k", "--arch", arch])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"{gb} GB of fp32 train state" in err
    assert ("full FSDP" if "moe" in arch else "A10b") in err
    assert f"one shard a card, is --mesh-world {world}\n" in err


def test_launcher_trains_an_moe_on_a_mesh_on_the_cpu():
    """``--arch deepseek-moe-16b --smoke --mesh-world 4 --model 2`` trains
    on the CPU: finite losses, the stages without a ZeRO-1 gather, each
    shard's bytes as planned, and each step's router stats with kept +
    dropped = T·k in every layer and no load over the capacity."""
    report = launcher.main(["--arch", "deepseek-moe-16b", "--shape",
                            "train_4k", "--smoke", "--device", "cpu",
                            "--steps", "2", "--mesh-world", "4", "--model",
                            "2"])
    assert (report["data"], report["model"], report["batch"],
            report["micro"]) == (2, 2, 2, 1)
    assert all(np.isfinite(x) for x in report["losses"])
    assert set(report["stage_ms"][0]) == {"forward", "backward",
                                          "data_sum", "optimizer"}
    sb = report["shard_bytes"]
    assert sb["weights"] == sb["planned_weights"]
    assert sb["state"] == sb["planned_state"]
    (card,) = report["cards"]
    assert card["working_bytes"] > 0
    for step in report["moe"]:
        assert step["assignments"] == 2 * 64 * 2
        for load, dropped in zip(step["expert_load_by_layer"],
                                 step["dropped_by_layer"]):
            assert sum(load) + dropped == step["assignments"]
            assert max(load) <= step["capacity"]


def test_train_cell_is_what_the_launcher_trains():
    """``train`` runs ``train_cell``'s step (what the train cells'
    profiler wraps): a fresh cell from the same flags gives the same
    losses."""
    args = launcher.parse_args(["--shape", "train_4k", "--smoke", "--device",
                                "cpu", "--steps", "2"])
    report = launcher.train(args)
    model, seq, draw, step = launcher.train_cell(args)
    assert seq == report["seq"] and model.cfg.vocab == 512
    assert [float(step(draw(), StageTimer("cpu"))) for _ in range(2)] == \
        report["losses"]


def test_profile_builds_the_launchers_cells(monkeypatch):
    from repro_torch.bench import profile_train_cells
    seen = []
    monkeypatch.setattr(launcher, "train_cell", lambda args: (
        seen.append(args), (None, 0, None, None))[1])
    monkeypatch.setattr(profile_train_cells.recsys_din, "train_cell",
                        lambda config: seen.append(config))
    profile_train_cells._cell("lm")
    profile_train_cells._cell("din")
    args, config = seen
    assert (args.arch, args.shape, args.batch, args.micro, args.device,
            args.seed, args.smoke) == ("qwen3-4b", "train_4k", 1, 1, "cuda",
                                       0, False)
    assert config == "din"


def test_launcher_train_defaults():
    args = launcher.parse_args(["--shape", "train_4k"])
    assert (args.arch, args.batch, args.micro, args.steps) == (
        "qwen3-4b", 1, 1, 3)
    assert launcher.parse_args([]).shape == "prefill_32k"
    with pytest.raises(SystemExit):
        launcher.parse_args(["--shape", "train_4k", "--batch", "3",
                             "--micro", "2"])


def test_profile_train_cells_needs_a_card(monkeypatch):
    """The train cells' profiler measures the card only: without one it
    exits before building anything."""
    from repro_torch.bench import profile_train_cells
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cell in ("lm", "din"):
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            profile_train_cells.main(["--cell", cell])
