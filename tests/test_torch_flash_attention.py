"""The port's ``flash_attention`` plain version (what the CPU runs, and what
the CUDA kernel is held to on the card) against the reference's Pallas body
in interpret mode, on the same numpy-seeded inputs.

Tolerance (``ref.tolerance``): fp32 within 2e-5 (rtol = atol, the
reference's own ``tests/test_kernels.py`` TOL); bf16 within one bf16 ulp of
the larger magnitude plus 2e-5 — both sides keep fp32 values within the
fp32 tolerance and round them once, and an output that cancels to near
zero can differ by more than its own ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.flash_attention import attention_ref, flash_attention_pallas
from repro.models.attention import blockwise_attention
from repro_torch.kernels import flash_attention as fa_pkg
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, sq, skv, h, kv, dh, dtype="float32"):
    """q/k/v from ``np.random.default_rng(seed)`` rounded to ``dtype``, as
    (jax arrays, torch tensors) holding the same values."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(b, sq, h, dh)),
              rng.normal(size=(b, skv, kv, dh)),
              rng.normal(size=(b, skv, kv, dh)))
    jdt, tdt = DTYPES[dtype]
    jx = tuple(jnp.asarray(a, jdt) for a in arrays)
    tx = tuple(torch.tensor(np.asarray(a, np.float32)).to(tdt)
               for a in jx)
    return jx, tx


def _torch(x, dtype):
    return torch.tensor(np.asarray(x, np.float32)).to(DTYPES[dtype][1])


@pytest.mark.parametrize("b,sq,h,kv,dh,causal", [
    (1, 128, 4, 4, 64, True),
    (2, 256, 4, 2, 64, True),
    (1, 128, 8, 1, 128, True),
    (2, 96, 4, 4, 32, False),
    (1, 257, 2, 2, 64, True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_equals_pallas_sweep(b, sq, h, kv, dh, causal, dtype):
    """The reference's kernel sweep (``tests/test_kernels.py``)."""
    (q, k, v), (qt, kt, vt) = _inputs(sq * h + dh, b, sq, sq, h, kv, dh,
                                      dtype)
    want = _torch(flash_attention_pallas(q, k, v, causal=causal, block_q=64,
                                         block_kv=64), dtype)
    got = fa_ref.flash_attention_plain(qt, kt, vt, causal=causal)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert fa_ref.within_tolerance(got, want)


@pytest.mark.parametrize("block_q,block_kv", [(32, 32), (128, 64), (64, 128)])
def test_plain_equals_pallas_block_shapes(block_q, block_kv):
    """The Pallas body's block shape changes only its rounding."""
    (q, k, v), (qt, kt, vt) = _inputs(0, 1, 192, 192, 4, 2, 64)
    want = _torch(flash_attention_pallas(q, k, v, causal=True,
                                         block_q=block_q, block_kv=block_kv),
                  "float32")
    got = fa_ref.flash_attention_plain(qt, kt, vt, causal=True)
    assert fa_ref.within_tolerance(got, want)


@pytest.mark.parametrize("kv", [8, 4, 2, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_groups(kv, causal):
    """H = 8 query heads over KV kv heads (group 1/2/4/8): head h reads kv
    head h // group."""
    (q, k, v), (qt, kt, vt) = _inputs(kv, 2, 72, 72, 8, kv, 32)
    want = _torch(flash_attention_pallas(q, k, v, causal=causal), "float32")
    got = fa_ref.flash_attention_plain(qt, kt, vt, causal=causal)
    assert fa_ref.within_tolerance(got, want)
    # group expansion by hand: the same as attending each head on its own
    rep = torch.repeat_interleave
    alone = fa_ref.flash_attention_plain(qt, rep(kt, 8 // kv, dim=2),
                                         rep(vt, 8 // kv, dim=2),
                                         causal=causal)
    assert fa_ref.within_tolerance(got, alone)


def test_causal_sq_below_skv_follows_the_pallas_body():
    """Sq < Skv causal: the Pallas body masks ``kv_pos <= q_pos`` (aligned
    top-left, as ``blockwise_attention`` with q_offset 0); its oracle
    ``attention_ref`` aligns bottom-right. The port follows the body. At
    q (1,16,2,16), k/v (1,24,2,16) from seed 0 the two references split by
    2.865."""
    (q, k, v), (qt, kt, vt) = _inputs(0, 1, 16, 24, 2, 2, 16)
    pallas = np.asarray(flash_attention_pallas(q, k, v, causal=True))
    oracle = np.asarray(attention_ref(q, k, v, causal=True))
    blockwise = np.asarray(blockwise_attention(q, k, v, causal=True))
    assert abs(float(np.abs(pallas - oracle).max()) - 2.865) < 1e-3
    got = fa_ref.flash_attention_plain(qt, kt, vt, causal=True)
    assert fa_ref.within_tolerance(got, _torch(pallas, "float32"))
    assert fa_ref.within_tolerance(got, _torch(blockwise, "float32"))
    assert float((got - _torch(oracle, "float32")).abs().max()) > 2.0


@pytest.mark.parametrize("sq,skv", [(40, 24), (24, 40)])
@pytest.mark.parametrize("causal", [True, False])
def test_sq_not_skv(sq, skv, causal):
    (q, k, v), (qt, kt, vt) = _inputs(sq + skv, 2, sq, skv, 4, 2, 16)
    want = _torch(flash_attention_pallas(q, k, v, causal=causal), "float32")
    got = fa_ref.flash_attention_plain(qt, kt, vt, causal=causal)
    assert fa_ref.within_tolerance(got, want)


@pytest.mark.parametrize("sq,skv", [(0, 8), (8, 0)])
def test_empty_inputs_reference_raises_port_gives_zeros(sq, skv):
    """The Pallas wrapper raises ``TypeError`` at Sq = 0 and at Skv = 0
    (its padded block is larger than the operand); the port returns zeros
    shaped like q: an empty output, or ``acc / max(l, 1e-20)`` with
    nothing accumulated."""
    (q, k, v), (qt, kt, vt) = _inputs(1, 1, sq, skv, 2, 2, 16)
    with pytest.raises(TypeError):
        flash_attention_pallas(q, k, v)
    for dtype in (torch.float32, torch.bfloat16):
        out = fa_ops.flash_attention(qt.to(dtype), kt.to(dtype), vt.to(dtype))
        assert out.shape == (1, sq, 2, 16) and out.dtype == dtype
        assert not out.any()


def test_plain_rejects_unpaired_shapes():
    q = torch.zeros((1, 8, 6, 16))
    with pytest.raises(ValueError):
        fa_ref.flash_attention_plain(q, torch.zeros((1, 8, 4, 16)),
                                     torch.zeros((1, 8, 4, 16)))
    with pytest.raises(ValueError):
        fa_ref.flash_attention_plain(q, torch.zeros((1, 8, 2, 8)),
                                     torch.zeros((1, 8, 2, 8)))


def test_masked_scores_are_finite():
    """Masked scores are -1e30, not -inf, so no NaN arises even when a row
    has only masked keys in a block (rows past the diagonal in bf16)."""
    _, (qt, kt, vt) = _inputs(5, 1, 300, 300, 2, 1, 32, "bfloat16")
    out = fa_ref.flash_attention_plain(qt * 100, kt * 100, vt)
    assert bool(torch.isfinite(out).all())


def test_cpu_tensors_dispatch_to_plain():
    """CPU tensors take the plain version and launch nothing; the CUDA
    wrapper refuses CPU tensors instead of falling back."""
    _, (qt, kt, vt) = _inputs(3, 2, 50, 50, 4, 2, 32)
    before = fa_pkg.LAUNCHES.value
    out = fa_ops.flash_attention(qt, kt, vt, causal=True)
    assert torch.equal(out, fa_ref.flash_attention_plain(qt, kt, vt))
    assert fa_pkg.LAUNCHES.value == before
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_cuda(qt, kt, vt)


def test_bf16_tolerance_covers_one_ulp_and_cancellation():
    """The bf16 allowance: one ulp of the larger magnitude (2^-7 at
    [1, 2)) on top of the fp32 tolerance."""
    want = torch.tensor([1.0, 1.0, 3e-6, 0.3], dtype=torch.bfloat16)
    got = torch.tensor([1.0078125, 1.015625, 3.5e-6, 0.3],
                       dtype=torch.bfloat16)
    ok = ((got.float() - want.float()).abs()
          <= fa_ref.tolerance(got, want)).tolist()
    assert ok == [True, False, True, True]
    assert float(fa_ref.bf16_ulp(torch.tensor([1.5]))) == 2.0 ** -7


# --- the bf16 kernel's exact split of p (ref.split_bf16x3) -----------------

SPLIT_EXACT_FROM = 2.0 ** -110  # 7.7037e-34: below, lo runs out of range


def _split_sum(p):
    hi, mid, lo = fa_ref.split_bf16x3(p)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    return (hi.float() + mid.float()) + lo.float()


def _split_samples(kind):
    gen = torch.Generator().manual_seed(7)
    if kind == "uniform":
        return torch.rand(200_000, generator=gen)
    if kind == "exp":  # p = exp(s - m) for s - m down to -87
        return torch.exp(-87.0 * torch.rand(200_000, generator=gen))
    if kind == "tiny":
        return torch.exp(-104.0 * torch.rand(200_000, generator=gen))
    # 0, 1, the exactness edge and its float neighbours, fp32's extremes
    edge = torch.tensor(SPLIT_EXACT_FROM)
    return torch.stack([
        torch.tensor(0.0), torch.tensor(1.0), edge,
        torch.nextafter(edge, torch.tensor(1.0)),
        torch.nextafter(edge, torch.tensor(0.0)),
        torch.tensor(torch.finfo(torch.float32).tiny),
        torch.tensor(torch.finfo(torch.float32).smallest_normal / 3),
        torch.nextafter(torch.tensor(1.0), torch.tensor(0.0)),
        torch.tensor(1.0 / 3.0), torch.tensor(float(np.exp(-87.0)))])


@pytest.mark.parametrize("kind", ["uniform", "exp", "tiny", "edges"])
def test_split_bf16x3_is_exact(kind):
    """``(hi + mid) + lo`` equals p bit for bit for p in [2^-110, 1]
    (including 0 and 1), and is within 1e-40 below 2^-110."""
    p = _split_samples(kind).float()
    got = _split_sum(p)
    big = p >= SPLIT_EXACT_FROM
    assert torch.equal(got[big], p[big])
    if bool((~big).any()):
        assert float((got[~big] - p[~big]).abs().max()) <= 1e-40
    assert torch.equal(got[p == 0], p[p == 0])


@settings(max_examples=300, deadline=None, database=None)
@given(st.floats(min_value=0.0, max_value=1.0, width=32))
def test_split_bf16x3_property(x):
    p = torch.tensor([x], dtype=torch.float32)
    got = _split_sum(p)
    if x >= SPLIT_EXACT_FROM:
        assert torch.equal(got, p)
    else:
        assert float((got - p).abs()) <= 1e-40


def _split_fold_fp32(q, k, v, causal, terms=3):
    """The bf16 kernel's tiling and split under exact fp32 sums: q·kᵀ in
    fp32, scaled after the dot, ``-1e30`` masks, an online softmax over
    128-key tiles up to the last row of its 128-query tile, each tile's
    p·v as the sum of its bf16 terms (``ref.split_bf16x3``; ``terms=1``
    keeps only ``hi``) times v, folded as ``acc = acc·corr + pv``. The
    tensor core truncates as it sums, which this cannot reproduce: that
    is pinned on the card (``tests/test_torch_card.py``, and the layer 35
    check of ``chip_smoke.py``)."""
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = 1.0 / np.sqrt(dh)
    qf = (q.float().reshape(b, sq, kvh, group, dh).permute(0, 2, 3, 1, 4)
          .reshape(b, kvh, group * sq, dh))
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    q_pos = torch.arange(sq).repeat(group)[:, None]
    m = torch.full((b, kvh, group * sq, 1), fa_ref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    end = min(skv, -(-sq // 128) * 128) if causal else skv
    for j0 in range(0, end, 128):
        j1 = min(j0 + 128, skv)
        s = (qf @ kf[:, :, j0:j1].transpose(-1, -2)) * scale
        if causal:
            kv_pos = torch.arange(j0, j1)[None, :]
            s = torch.where(kv_pos <= q_pos, s, fa_ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = torch.zeros_like(acc)
        for term in fa_ref.split_bf16x3(p)[:terms]:
            pv = pv + term.float() @ vf[:, :, j0:j1]
        acc = acc * corr + pv
        m = m_new
    out = acc / l.clamp_min(1e-20)
    return (out.reshape(b, kvh, group, sq, dh).permute(0, 3, 1, 2, 4)
            .reshape(b, sq, h, dh).to(q.dtype))


@pytest.mark.parametrize("b,sq,h,kv,dh,causal", [
    (1, 128, 4, 4, 64, True),
    (2, 256, 4, 2, 64, True),
    (1, 128, 8, 1, 128, True),
    (2, 96, 4, 4, 32, False),
    (1, 257, 2, 2, 64, True),
])
def test_split_emulation_within_tolerance(b, sq, h, kv, dh, causal):
    """The three-term split with the kernel's 128-key tile fold, summed in
    exact fp32, stays within the unchanged ``ref.tolerance`` of
    ``flash_attention_plain`` over the sweep's shapes (the bf16 inputs of
    ``test_plain_equals_pallas_sweep``; the split serves bf16 only)."""
    _, (qt, kt, vt) = _inputs(sq * h + dh, b, sq, sq, h, kv, dh, "bfloat16")
    got = _split_fold_fp32(qt, kt, vt, causal)
    want = fa_ref.flash_attention_plain(qt, kt, vt, causal=causal)
    assert got.dtype == want.dtype
    assert fa_ref.within_tolerance(got, want)


def test_one_bf16_term_breaks_the_fp32_contract():
    """p rounded to bf16 (what ``scaled_dot_product_attention`` does) is
    off the fp32 contract where the three terms, under fp32 sums, are
    not."""
    _, (qt, kt, vt) = _inputs(11, 1, 256, 256, 4, 2, 64)
    want = fa_ref.flash_attention_plain(qt, kt, vt)
    assert fa_ref.within_tolerance(_split_fold_fp32(qt, kt, vt, True), want)
    assert not fa_ref.within_tolerance(
        _split_fold_fp32(qt, kt, vt, True, terms=1), want)
