"""Card-only checks of the port's CUDA kernels (marked ``cuda``; they skip
where there is no NVIDIA GPU). This file imports no JAX, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import embedding_bag as eb_pkg
from repro_torch.kernels import gather_aggregate as ga_pkg
from repro_torch.kernels import tiered_gather as tg_pkg
from repro_torch.kernels import flash_attention as fa_pkg
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.kernels.gather_aggregate import ops as ga_ops
from repro_torch.kernels.gather_aggregate import ref as ga_ref
from repro_torch.kernels import segment_spmm as sp_pkg
from repro_torch.kernels.build import LanePlan, int_bits
from repro_torch.kernels.segment_spmm import ops as sp_ops
from repro_torch.kernels.segment_spmm import ref as sp_ref
from repro_torch.kernels.tiered_gather import ops as tg_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.tiered_gather import ref as tg_ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA-only)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_equal_plain_on_card(card, dtype):
    """Each CUDA kernel is bitwise equal to its plain version (slots out of
    range on purpose: both clamp), and each launch is counted once."""
    rng = np.random.default_rng(0)
    hot = torch.from_numpy(rng.normal(size=(50, 128)).astype(np.float32))
    hot = hot.to(card, dtype)
    warm = (hot[:40] * 2).contiguous()
    cold = (hot[:9] * 3).contiguous()
    tier = torch.from_numpy(rng.choice([0, 1, 2, 99], size=(300, 5))
                            .astype(np.int32)).to(card)
    slot = torch.from_numpy(rng.integers(-2, 60, size=(300, 5))
                            .astype(np.int32)).to(card)
    before = tg_pkg.LAUNCHES.value, ga_pkg.LAUNCHES.value
    flat_t, flat_s = tier.reshape(-1), slot.reshape(-1)
    assert torch.equal(tg_ops.tiered_gather(flat_t, flat_s, hot, warm),
                       tg_ref.tiered_gather_ref(flat_t, flat_s, hot, warm))
    assert torch.equal(ga_ops.gather_aggregate(tier, slot, hot, warm, cold),
                       ga_ref.gather_aggregate_ref(tier, slot, hot, warm,
                                                   cold))
    torch.cuda.synchronize()
    assert (tg_pkg.LAUNCHES.value, ga_pkg.LAUNCHES.value) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_kernels_empty_grid_on_card(card):
    """An empty grid returns zeros without a launch."""
    before = tg_pkg.LAUNCHES.value, ga_pkg.LAUNCHES.value
    hot = torch.ones((4, 8), device=card)
    z1 = torch.zeros(0, dtype=torch.int32, device=card)
    assert tg_ops.tiered_gather(z1, z1, hot, hot).shape == (0, 8)
    for s, fan in ((0, 3), (5, 0)):
        z2 = torch.zeros((s, fan), dtype=torch.int32, device=card)
        out = ga_ops.gather_aggregate(z2, z2, hot, hot, hot)
        assert out.shape == (s, 8) and not out.any()
    assert (tg_pkg.LAUNCHES.value, ga_pkg.LAUNCHES.value) == before


# The serve kernels' lane plans on the card: (d, dtype, table offset in
# rows). d 16 puts 4 lanes on a row in fp32 (2 in bf16), d 256 fp32 takes
# two passes, bf16 d 37 has 74-byte rows (one-element vectors); offset 1
# is the hot[1:] view (a bf16 d 37 row in: 74 bytes).
SERVE_SWEEP = ([(d, dt, 0) for dt in (torch.float32, torch.bfloat16)
                for d in (16, 64, 128, 256)] + [(37, torch.bfloat16, 0)]
               + [(d, torch.bfloat16, 1) for d in (16, 37, 64, 128, 256)])


def _serve_inputs(card, d, dtype, offset, segments, fan, seed):
    """Tables with rows of -0.0 (whole rows, and -0.0 among other values)
    and (tier, slot) addresses over all three tiers, pads (99, -1) and
    slots past either end; segment 0 is one -0.0 hot row and three pads,
    segment 1 (fan > 1) nothing but -0.0 warm rows."""
    rng = np.random.default_rng(seed)

    def table(rows, off=0):
        x = rng.normal(size=(rows + off, d)).astype(np.float32)
        return torch.from_numpy(x).to(card, dtype)[off:]

    hot, warm, cold = table(51, offset), table(40), table(9)
    hot[3] = -0.0
    warm[5] = -0.0
    cold[0] = -0.0
    hot[7, ::3] = -0.0
    tier = rng.choice([0, 1, 2, 99, -1], p=[.3, .3, .2, .15, .05],
                      size=(segments, fan)).astype(np.int32)
    slot = rng.integers(-2, 60, size=(segments, fan)).astype(np.int32)
    tier[0], slot[0] = 99, 0
    tier[0, 0], slot[0, 0] = 0, 3
    if fan > 1:
        tier[1], slot[1] = 1, 5
    return (hot, warm, cold, torch.from_numpy(tier).to(card),
            torch.from_numpy(slot).to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("fan", [1, 5, 33])
@pytest.mark.parametrize("d, dtype, offset", SERVE_SWEEP,
                         ids=[f"{d}-{str(dt)[6:]}-off{o}"
                              for d, dt, o in SERVE_SWEEP])
def test_serve_kernels_sweep_bitwise_on_card(card, d, dtype, offset, fan):
    """Both serve kernels equal their plain versions bit for bit across
    widths, fans (33 is longer than a window of 32 children), the hot[1:]
    view and rows of -0.0: a -0.0 singleton folds to +0.0 and copies as
    -0.0. A repeated call gives the same bits; one launch per call."""
    hot, warm, cold, tier, slot = _serve_inputs(card, d, dtype, offset, 300,
                                                fan, 7 + d + fan)
    before = tg_pkg.LAUNCHES.value, ga_pkg.LAUNCHES.value
    want = ga_ref.gather_aggregate_ref(tier, slot, hot, warm, cold)
    first = ga_ops.gather_aggregate(tier, slot, hot, warm, cold)
    again = ga_ops.gather_aggregate(tier, slot, hot, warm, cold)
    flat_t, flat_s = tier.reshape(-1), slot.reshape(-1)
    want_tg = tg_ref.tiered_gather_ref(flat_t, flat_s, hot, warm)
    first_tg = tg_ops.tiered_gather(flat_t, flat_s, hot, warm)
    again_tg = tg_ops.tiered_gather(flat_t, flat_s, hot, warm)
    torch.cuda.synchronize()
    assert torch.equal(int_bits(first), int_bits(want))
    assert torch.equal(int_bits(again), int_bits(first))
    assert not int_bits(first)[0].any()                  # +0.0 after the fold
    assert torch.equal(int_bits(first_tg), int_bits(want_tg))
    assert torch.equal(int_bits(again_tg), int_bits(first_tg))
    assert torch.equal(int_bits(first_tg[0]), int_bits(hot[3]))  # -0.0 copied
    assert (int_bits(hot[3]) != 0).all()
    assert (tg_pkg.LAUNCHES.value, ga_pkg.LAUNCHES.value) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 128])
def test_serve_kernels_grid_stride_on_card(card, d):
    """200,000 segments (1,000,000 rows for the gather): more than the
    grid holds at once, so warps walk several units; still bit for bit."""
    from repro_torch.kernels.gather_aggregate import kernel as ga_kernel
    from repro_torch.kernels.tiered_gather import kernel as tg_kernel
    s, fan = 200_000, 5
    hot, warm, cold, tier, slot = _serve_inputs(card, d, torch.float32, 0,
                                                s, fan, 99)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for mod, rows in ((ga_kernel, s), (tg_kernel, s * fan)):
        plan = mod.copy_plan(d, 4, hot.data_ptr(), rows, sms)
        assert plan.blocks * mod.WARPS * plan.rows_per_warp < rows
    got = ga_ops.gather_aggregate(tier, slot, hot, warm, cold)
    want = ga_ref.gather_aggregate_ref(tier, slot, hot, warm, cold)
    flat_t, flat_s = tier.reshape(-1), slot.reshape(-1)
    got_tg = tg_ops.tiered_gather(flat_t, flat_s, hot, warm)
    want_tg = tg_ref.tiered_gather_ref(flat_t, flat_s, hot, warm)
    torch.cuda.synchronize()
    assert torch.equal(int_bits(got), int_bits(want))
    assert torch.equal(int_bits(got_tg), int_bits(want_tg))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_equals_plain_on_card(card, dtype):
    """The CUDA ``embedding_bag`` is bitwise equal to its plain version
    (sum and mean, with and without weights; padded rows, an all-padding
    bag and ids past the table on purpose), one counted launch per call,
    and an empty grid gives zeros without a launch."""
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.normal(size=(300, 36)).astype(np.float32))
    table = table.to(card, dtype)
    ids = rng.integers(-1, 320, size=(64, 100)).astype(np.int32)
    ids[0] = -1
    ids = torch.from_numpy(ids).to(card)
    w = torch.from_numpy(rng.normal(size=(64, 100)).astype(np.float32))
    w = w.to(card, dtype)
    before = eb_pkg.LAUNCHES.value
    for mode in ("sum", "mean"):
        for weights in (None, w):
            got = eb_ops.embedding_bag(table, ids, weights, mode=mode)
            want = eb_ref.embedding_bag_ref(table, ids, weights, mode=mode)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (mode, weights is not None)
            assert not got[0].any()
    assert eb_pkg.LAUNCHES.value == before + 4
    for b, bag, d in ((0, 5, 36), (4, 0, 36), (4, 5, 0)):
        out = eb_ops.embedding_bag(
            torch.ones((3, d), device=card, dtype=dtype),
            torch.zeros((b, bag), dtype=torch.int32, device=card))
        assert out.shape == (b, d) and not out.any()
    assert eb_pkg.LAUNCHES.value == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [100, 64, 300])
def test_segment_spmm_equals_plain_on_card(card, dtype, d):
    """The CUDA ``segment_spmm`` is bitwise equal to its plain version
    (weighted or not; -1 anywhere in a row, an all-padding row, ids past
    the table; d with a masked tail and d over one 128-column pass), one
    counted launch per call, and an empty grid gives zeros without a
    launch."""
    rng = np.random.default_rng(3)
    feat = torch.from_numpy(rng.normal(size=(500, d)).astype(np.float32))
    feat = feat.to(card, dtype)
    ids = rng.integers(-1, 520, size=(700, 45)).astype(np.int32)
    ids[0] = -1
    ids = torch.from_numpy(ids).to(card)
    w = torch.from_numpy(rng.normal(size=(700, 45)).astype(np.float32))
    w = w.to(card, dtype)
    before = sp_pkg.LAUNCHES.value
    for weights in (None, w):
        got = sp_ops.segment_spmm(ids, feat, weights)
        want = sp_ref.segment_spmm_plain(ids, feat, weights)
        torch.cuda.synchronize()
        assert torch.equal(got, want), weights is not None
        assert not got[0].any()
    assert sp_pkg.LAUNCHES.value == before + 2
    for n, dmax, width in ((0, 5, d), (4, 0, d), (4, 5, 0)):
        out = sp_ops.segment_spmm(
            torch.zeros((n, dmax), dtype=torch.int32, device=card),
            torch.ones((3, width), device=card, dtype=dtype))
        assert out.shape == (n, width) and not out.any()
    assert sp_pkg.LAUNCHES.value == before + 2


@pytest.mark.cuda
def test_segment_spmm_gradient_on_card(card):
    """The autograd Function's backward (the kernel on the transposed
    table) equals the plain version's on the CPU bitwise, and a repeated
    backward gives the same bits."""
    n = 2000
    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.integers(0, n, 30000).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, 30000).astype(np.int32))
    x = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32))
    grads = []
    for dev in (card, card, torch.device("cpu")):
        ids, ids_t = sp_ref.ell_pair(src.to(dev), dst.to(dev), n)
        a = x.to(dev).requires_grad_()
        out = sp_ops.segment_spmm_autograd(ids, a, ids_t=ids_t)
        (out * r.to(dev)).sum().backward()
        grads.append(a.grad.cpu())
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(grads[0], grads[2])


# Edge cases of the gather-sum kernels' copy rings: (name, rows, d, lists,
# list length, dtype, table offset in rows, id kind). "long" lists outrun
# the ring (segment_spmm's per-warp ring holds 48-256 rows; embedding_bag's
# d-300 ring 128 and its d-36 ring 384); offset 1 is an unaligned view
# (feat[1:]: 200 bytes in for bf16 d 100, 72 for bf16 d 36); bf16 d 37 has
# 74-byte rows (staged through registers); "mid" pads a random half of each
# list anywhere; "none" is all padding; "past" draws ids past the table.
GATHER_EDGES = [
    ("long lists d64", 400, 64, 300, 300, torch.float32, 0, "mid"),
    ("long lists d300", 400, 300, 200, 300, torch.float32, 0, "mid"),
    ("long lists d36", 400, 36, 200, 500, torch.float32, 0, "mid"),
    ("unaligned view d100", 500, 100, 300, 53, torch.bfloat16, 1, "mid"),
    ("unaligned view d36", 500, 36, 300, 100, torch.bfloat16, 1, "mid"),
    ("bf16 d37", 500, 37, 300, 100, torch.bfloat16, 0, "mid"),
    ("bf16 d37 long", 500, 37, 100, 300, torch.bfloat16, 0, "past"),
    ("mid-list padding d36", 500, 36, 300, 100, torch.float32, 0, "mid"),
    ("mid-list padding d100", 500, 100, 300, 53, torch.float32, 0, "mid"),
    ("all padding", 500, 64, 50, 53, torch.float32, 0, "none"),
    ("past the table", 500, 100, 300, 53, torch.float32, 0, "past"),
]


def _gather_inputs(card, rows, d, lists, length, dtype, offset, kind, seed):
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.normal(size=(rows + offset, d))
                            .astype(np.float32)).to(card, dtype)
    table = base[offset:]
    if offset:
        assert table.data_ptr() != base.data_ptr() and table.is_contiguous()
    hi = rows + 40 if kind == "past" else rows
    ids = rng.integers(0, hi, size=(lists, length)).astype(np.int32)
    if kind == "mid":
        ids[rng.random(ids.shape) < 0.5] = -1
        ids[::7] = -1
    elif kind == "none":
        ids[:] = -1
    else:
        ids[rng.random(ids.shape) < 0.2] = -3
    w = torch.from_numpy(rng.normal(size=(lists, length)).astype(np.float32))
    return table, torch.from_numpy(ids).to(card), w.to(card, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GATHER_EDGES, ids=[c[0] for c in GATHER_EDGES])
def test_segment_spmm_ring_edges_on_card(card, case):
    """``segment_spmm`` bitwise equal to its plain version on the copy
    ring's edge cases, weighted or not, and a repeated call gives the same
    bits (a missing wait or barrier shows as a difference between runs)."""
    _, rows, d, lists, length, dtype, offset, kind = case
    feat, ids, w = _gather_inputs(card, rows, d, lists, length, dtype,
                                  offset, kind, 5)
    before = sp_pkg.LAUNCHES.value
    for weights in (None, w):
        want = sp_ref.segment_spmm_plain(ids, feat, weights)
        first = sp_ops.segment_spmm(ids, feat, weights)
        again = sp_ops.segment_spmm(ids, feat, weights)
        torch.cuda.synchronize()
        assert torch.equal(first, want), weights is not None
        assert torch.equal(again, first), weights is not None
        if kind == "none":
            assert not first.any()
    assert sp_pkg.LAUNCHES.value == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("case", GATHER_EDGES, ids=[c[0] for c in GATHER_EDGES])
def test_embedding_bag_ring_edges_on_card(card, case):
    """``embedding_bag`` bitwise equal to its plain version on the copy
    ring's edge cases (sum and mean, weighted or not), and a repeated call
    gives the same bits."""
    _, rows, d, lists, length, dtype, offset, kind = case
    table, ids, w = _gather_inputs(card, rows, d, lists, length, dtype,
                                   offset, kind, 6)
    before = eb_pkg.LAUNCHES.value
    for mode in ("sum", "mean"):
        for weights in (None, w):
            want = eb_ref.embedding_bag_ref(table, ids, weights, mode=mode)
            first = eb_ops.embedding_bag(table, ids, weights, mode=mode)
            again = eb_ops.embedding_bag(table, ids, weights, mode=mode)
            torch.cuda.synchronize()
            assert torch.equal(first, want), (mode, weights is not None)
            assert torch.equal(again, first), (mode, weights is not None)
            if kind == "none":
                assert not first.any()
    assert eb_pkg.LAUNCHES.value == before + 8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_equals_plain_on_card(card, dtype):
    """The CUDA ``flash_attention`` within ``ref.tolerance`` of its plain
    version (fp32: 2e-5; bf16: one ulp of the larger magnitude plus 2e-5)
    over head widths 16-128, GQA groups 1/2/4/8, causal or full, Sq != Skv
    (Skv > Sq aligned top-left), tail tiles of the bf16 kernel's 128-query
    and 128-key tiles, B 2 with sequences shorter than a tile, a 4,096-token
    causal case, and q scaled ×8 (p spans ~80 binades, so the bf16
    kernel's ``mid``/``lo`` terms matter); one counted launch per call.
    Then B 2 with a 100-token first sequence and inf in every k/v row of
    the second: the first sequence's output must not change, so no tile
    of it reads across the batch boundary."""
    gen = torch.Generator(device=card).manual_seed(0)
    # (B, Sq, Skv, H, KV, dh, causal, q scale)
    shapes = [(1, 128, 128, 4, 4, 64, True, 1), (2, 96, 96, 4, 4, 32, False, 1),
              (1, 257, 257, 2, 2, 64, True, 1),
              (1, 16, 24, 2, 2, 128, True, 1),
              (2, 40, 24, 8, 2, 96, True, 1), (1, 24, 40, 8, 1, 32, False, 1),
              (2, 300, 300, 20, 20, 128, True, 1),
              (1, 70, 70, 4, 1, 16, True, 1),
              (1, 1000, 1000, 32, 8, 128, True, 1),
              (1, 200, 700, 8, 2, 64, True, 1),
              (1, 200, 700, 8, 8, 96, False, 1),
              (2, 100, 100, 4, 1, 128, True, 1),
              (2, 60, 300, 8, 8, 16, False, 1),
              (1, 4096, 4096, 8, 2, 128, True, 1),
              (1, 384, 384, 32, 8, 128, True, 8),
              (1, 300, 300, 8, 1, 64, False, 8)]
    before = fa_pkg.LAUNCHES.value
    for b, sq, skv, h, kv, dh, causal, scale in shapes:
        q = torch.randn((b, sq, h, dh), generator=gen, device=card) * scale
        k = torch.randn((b, skv, kv, dh), generator=gen, device=card)
        v = torch.randn((b, skv, kv, dh), generator=gen, device=card)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        got = fa_ops.flash_attention(q, k, v, causal=causal)
        want = fa_ref.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert fa_ref.within_tolerance(got, want), (b, sq, skv, h, kv, dh)
    assert fa_pkg.LAUNCHES.value == before + len(shapes)

    q = torch.randn((2, 100, 4, 128), generator=gen, device=card).to(dtype)
    k = torch.randn((2, 100, 2, 128), generator=gen, device=card).to(dtype)
    v = torch.randn((2, 100, 2, 128), generator=gen, device=card).to(dtype)
    k[1] = float("inf")
    v[1] = float("inf")
    for causal in (True, False):
        got = fa_ops.flash_attention(q, k, v, causal=causal)[:1]
        want = fa_ref.flash_attention_plain(q[:1], k[:1], v[:1],
                                            causal=causal)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert fa_ref.within_tolerance(got, want)


@pytest.mark.cuda
def test_flash_attention_empty_and_refused_on_card(card):
    """Sq = 0 and Skv = 0 give zeros without a launch; inputs the kernel
    does not take raise instead of reaching the plain version."""
    before = fa_pkg.LAUNCHES.value
    for sq, skv in ((0, 8), (8, 0)):
        q = torch.ones((1, sq, 4, 64), device=card, dtype=torch.bfloat16)
        k = torch.ones((1, skv, 2, 64), device=card, dtype=torch.bfloat16)
        out = fa_ops.flash_attention(q, k, k)
        assert out.shape == q.shape and not out.any()
    assert fa_pkg.LAUNCHES.value == before
    q = torch.ones((1, 8, 4, 48), device=card)
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.flash_attention_cuda(q, q, q)
    q = torch.ones((1, 8, 4, 64), device=card)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_cuda(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_cuda(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_cuda(q, q[:, :, :3], q[:, :, :3])
    assert fa_pkg.LAUNCHES.value == before


@pytest.mark.cuda
def test_lm_prefill_card_matches_cpu(card):
    """The smoke-size qwen3-4b prefill on the card (one kernel launch per
    layer) against the same weights on the CPU: logits within 1e-4."""
    from repro_torch.configs import lm_common, qwen3_4b
    from repro_torch.models import transformer as tf
    cfg = lm_common.smoke_config(qwen3_4b.CONFIG)
    cpu = tf.lm_init(torch.Generator().manual_seed(0), cfg)
    dev = tf.LM(cfg, device=card)
    dev.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 150),
                           generator=torch.Generator().manual_seed(1))
    before = fa_pkg.LAUNCHES.value
    got, cache = tf.lm_prefill(dev, tokens.to(card), cfg)
    want, want_cache = tf.lm_prefill(cpu, tokens, cfg)
    assert fa_pkg.LAUNCHES.value == before + cfg.n_layers
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert cache["k"].shape == want_cache["k"].shape


@pytest.mark.cuda
def test_moe_card_matches_cpu(card):
    """The smoke-size deepseek-moe-16b prefill and two decode steps on the
    card against the same weights on the CPU: every layer's router stats
    of the prefill equal (the same experts kept), logits within 1e-4."""
    from repro_torch.configs import deepseek_moe_16b, lm_common
    from repro_torch.models import transformer as tf
    cfg = lm_common.smoke_config(deepseek_moe_16b.CONFIG)
    cpu = tf.lm_init(torch.Generator().manual_seed(0), cfg)
    dev = tf.LM(cfg, device=card)
    dev.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 150),
                           generator=torch.Generator().manual_seed(1))
    before = fa_pkg.LAUNCHES.value
    got, _ = tf.lm_prefill(dev, tokens.to(card), cfg)
    want, want_cache = tf.lm_prefill(cpu, tokens, cfg)
    assert fa_pkg.LAUNCHES.value == before + cfg.n_layers
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    for a, b in zip(dev.layers, cpu.layers):
        sa, sb = a.moe.last_stats, b.moe.last_stats
        assert torch.equal(sa["expert_load"].cpu(), sb["expert_load"])
        assert int(sa["dropped"]) == int(sb["dropped"])
    dc = tf.init_decode_cache(cfg, 2, 152, dtype=torch.float32, device=card)
    cc = tf.init_decode_cache(cfg, 2, 152, dtype=torch.float32,
                              device="cpu")
    for key in ("k", "v"):  # both decode on the CPU prefill's cache
        dc[key][:, :, :150] = want_cache[key].to(card)
        cc[key][:, :, :150] = want_cache[key]
    tok = want.argmax(-1)[:, None]
    for pos in (151, 152):
        got, dc = tf.lm_decode_step(dev, tok.to(card), dc, pos, cfg)
        want, cc = tf.lm_decode_step(cpu, tok, cc, pos, cfg)
        assert float((got.cpu() - want).abs().max()) <= 1e-4
        tok = want.argmax(-1)[:, None]


# The rule of chip_smoke.py's phase 7d for expert shards against one card:
# bit for bit, or, should cuBLAS pick another algorithm for a batch of 4
# experts than for 16, the logits within its LM_BF16_CPU_TOL with equal
# greedy ids.
EP_LOGITS_TOL = 0.125
EP_PROMPT = 1024
EP_STEPS = 4


def _phi_two_layers():
    import dataclasses
    from repro_torch.configs import phi35_moe_42b
    return dataclasses.replace(phi35_moe_42b.CONFIG, n_layers=2)


def _ep_serve(card, cfg, tokens, mesh=None):
    """phi3.5 at full width from seed 0 in bf16 weights (on ``mesh``):
    the prefill's logits and ``EP_STEPS`` greedy decode steps' on its
    cache, on the CPU."""
    from repro_torch.models import transformer as tf
    model = tf.lm_init(torch.Generator(device=card).manual_seed(0), cfg,
                       dtype=torch.bfloat16, mesh=mesh)
    logits, pc = tf.lm_prefill(model, tokens, cfg)
    cache = tf.init_decode_cache(cfg, 1, EP_PROMPT + EP_STEPS, device=card)
    for key in ("k", "v"):
        cache[key][:, :, :EP_PROMPT] = pc[key]
    out = [logits]
    for t in range(EP_STEPS):
        logits, cache = tf.lm_decode_step(model, out[-1].argmax(-1)[:, None],
                                          cache, EP_PROMPT + t + 1, cfg)
        out.append(logits)
    return [x.cpu() for x in out]


def _held_like_one_card(want, got):
    if all(torch.equal(a, b) for a, b in zip(want, got)):
        return
    diff = max(float((a - b).abs().max()) for a, b in zip(want, got))
    assert diff <= EP_LOGITS_TOL, diff
    assert all(torch.equal(a.argmax(-1), b.argmax(-1))
               for a, b in zip(want, got))


@pytest.mark.cuda
def test_expert_shards_on_one_card_serve_as_one_card(card):
    """phi3.5-moe-42b at full width, 2 layers: four logical expert shards
    of card 0 against no mesh, a 1,024-token prefill and four decode
    steps, each shard running three products a call."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    cfg = _phi_two_layers()
    tokens = torch.randint(0, cfg.vocab, (1, EP_PROMPT), device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(1))
    want = _ep_serve(card, cfg, tokens)
    torch.cuda.empty_cache()
    moe.PRODUCTS.reset()
    got = _ep_serve(card, cfg, tokens,
                    make_host_mesh(4, device="cuda", axis_name="model"))
    assert moe.PRODUCTS.value == 3 * 4 * cfg.n_layers * (1 + EP_STEPS)
    _held_like_one_card(want, got)


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs (one expert shard a card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_expert_shards_on_four_cards(four_cards):
    """phi3.5-moe-42b at full width, 2 layers, one expert shard a card:
    each card's allocated bytes after the draw are its planned weights
    (``serve_placement``: its experts; card 0 also everything else) within
    1%, and the logits follow the one-card model's on card 0."""
    from repro_torch.configs import lm_common
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    card = four_cards
    cfg = _phi_two_layers()
    tokens = torch.randint(0, cfg.vocab, (1, EP_PROMPT), device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(1))
    want = _ep_serve(card, cfg, tokens)
    torch.cuda.empty_cache()
    mesh = make_host_mesh(4, device="cuda", axis_name="model")
    assert [d.index for d in mesh.devices] == [0, 1, 2, 3]
    before = [torch.cuda.memory_allocated(i) for i in range(4)]
    model = tf.lm_init(torch.Generator(device=card).manual_seed(0), cfg,
                       dtype=torch.bfloat16, mesh=mesh)
    held = [torch.cuda.memory_allocated(i) - before[i] for i in range(4)]
    planned = lm_common.serve_placement(cfg, 4).weight_bytes
    for i in range(4):
        assert abs(held[i] - planned[i]) <= 0.01 * planned[i], (i, held,
                                                                 planned)
    del model
    torch.cuda.empty_cache()
    _held_like_one_card(want, _ep_serve(card, cfg, tokens, mesh))


def _cold_path_stores(card, n=4000, d=64):
    """A card store and a CPU store over the same features and plan."""
    from repro_torch.core import (TieredFeatureStore, TopologySpec,
                                  quiver_placement)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    topo = TopologySpec(num_pods=1, devices_per_pod=1, rows_per_device=1000,
                        rows_host=2000, hot_replicate_fraction=0.25)
    fap = rng.random(n)
    stores = [TieredFeatureStore.build(feats, quiver_placement(fap, topo),
                                       device=dev) for dev in (card, "cpu")]
    return feats, fap, stores


@pytest.mark.cuda
def test_cold_path_card_matches_cpu(card):
    """Cache, stage (uploaded on the side stream) and swaps on the card:
    lookups equal the CPU store's bit for bit, counter for counter."""
    from repro_torch.core import GPUFeatureCache, Prefetcher
    feats, fap, (dev, cpu) = _cold_path_stores(card)
    n = feats.shape[0]
    pfs = []
    for s in (dev, cpu):
        s.attach_cache(GPUFeatureCache.for_store(s, 256))
        pf = Prefetcher(s, budget=512)
        pf.refresh(scores=fap)
        pfs.append(pf)
    assert dev._stage[1].device.type == card.type
    assert dev.staged_rows() == 512
    rng = np.random.default_rng(1)
    hot = np.flatnonzero(dev.tier_np == 0)
    cold = np.flatnonzero(dev.tier_np >= 2)
    for step in range(6):
        hops = [rng.integers(-1, n, s).astype(np.int32) for s in (32, 320,
                                                                  1600)]
        seen = []
        for s in (dev, cpu):
            hops_s = [torch.from_numpy(h).to(s.device) for h in hops]
            feats_a, agg = s.lookup_aggregate(hops_s)
            seen.append([r.cpu() for r in s.lookup_hops(hops_s)]
                        + [f.cpu() for f in feats_a] + [agg.cpu()])
        for x, y in zip(*seen):
            assert x.view(torch.int32).equal(y.view(torch.int32))
        pairs = list(zip(hot[step * 8:(step + 1) * 8].tolist(),
                         cold[step * 8:(step + 1) * 8].tolist()))
        for s in (dev, cpu):
            s.swap_assignments(pairs)
    assert dev.snapshot_stats() == cpu.snapshot_stats()
    assert dev.cache.report() == cpu.cache.report()
    st = dev.snapshot_stats()
    assert st["cache_hits"] > 0 and st["prefetch_hits"] > 0
    assert torch.equal(dev.lookup(np.arange(n)).cpu(),
                       torch.from_numpy(feats))
    for pf in pfs:
        pf.close()


@pytest.mark.cuda
def test_stage_churn_and_migration_exact_on_card(card):
    """One thread looks up through a small cache on the card while another
    re-publishes the stage (side-stream uploads) and the main thread
    migrates: every row read equals the pristine store's bits."""
    import threading
    from repro_torch.core import (GPUFeatureCache, Prefetcher,
                                  migration_pairs, quiver_placement)
    feats, fap, (dev, _) = _cold_path_stores(card)
    _, _, (pristine, _) = _cold_path_stores(card)
    n = feats.shape[0]
    dev.attach_cache(GPUFeatureCache.for_store(dev, 64))
    rng = np.random.default_rng(7)
    hops = [torch.from_numpy(rng.integers(0, n, s).astype(np.int32)).to(card)
            for s in (32, 320)]
    want = [r.view(torch.int32).clone() for r in pristine.lookup_hops(hops)]
    want_agg = pristine.lookup_aggregate(hops)[1].view(torch.int32).clone()
    stop, errors = threading.Event(), []
    pf = Prefetcher(dev, budget=n)

    def reader():
        while not stop.is_set():
            got = dev.lookup_hops(hops)
            agg = dev.lookup_aggregate(hops)[1]
            if not (all(g.view(torch.int32).equal(w)
                        for g, w in zip(got, want))
                    and agg.view(torch.int32).equal(want_agg)):
                errors.append("torn lookup on the card")
                return

    def refresher():
        r = np.random.default_rng(13)
        while not stop.is_set():
            scores = r.random(n)
            scores[scores < 0.5] = 0.0
            pf.refresh(scores=scores)

    threads = [threading.Thread(target=reader),
               threading.Thread(target=refresher)]
    for t in threads:
        t.start()
    try:
        drifted = fap.copy()
        drifted[np.argsort(fap)[:400]] += fap.max() * 3
        tgt = quiver_placement(drifted, dev.plan.topology)
        for _ in range(10):
            pairs = migration_pairs(dev.plan.tier, tgt.tier, drifted,
                                    budget=100)
            if pairs:
                dev.swap_assignments(pairs)
            dev.promote_misses(budget=8)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    pf.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors and dev.migrated_rows > 0


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["device", "cold"])
def test_device_resolution_card_matches_cpu(card, placement, monkeypatch):
    """Address resolution on the card: ``lookup_aggregate`` and
    ``lookup_hops`` give the CPU store's rows and sums bit for bit, with
    every row on the card or not. With every row on the card a call copies
    nothing from the device; otherwise only the distinct cold ids and one
    count (int32) cross."""
    from repro_torch.core import (TieredFeatureStore, TopologySpec,
                                  quiver_placement)
    n, d = 4000, 64
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    topo = TopologySpec(num_pods=1, devices_per_pod=1,
                        rows_per_device=n if placement == "device" else 1000,
                        rows_host=2000, hot_replicate_fraction=0.25)
    fap = rng.random(n)
    dev, cpu = [TieredFeatureStore.build(feats, quiver_placement(fap, topo),
                                         device=x) for x in (card, "cpu")]
    assert (dev.n_cold == 0) == (placement == "device")
    copied = []

    def spy(real):
        def call(self, *a, **k):
            out = real(self, *a, **k)
            if self.is_cuda and not (isinstance(out, torch.Tensor)
                                     and out.is_cuda):
                copied.append(self.numel() * self.element_size())
            return out
        return call

    def draw():
        return [rng.integers(-1, n, s).astype(np.int32)
                for s in (64, 640, 3200)]

    first = draw()                            # builds the kernels
    for s in (dev, cpu):
        s.lookup_hops(first)
        s.lookup_aggregate(first)
    for step in range(3):
        hops = draw()
        ids = np.unique(np.concatenate(hops))
        n_cold = int((dev.tier_np[ids[ids >= 0]] >= 2).sum())
        hops_d = [torch.from_numpy(h).to(card) for h in hops]
        want = cpu.lookup_hops(hops) + list(cpu.lookup_aggregate(hops)[1:])
        for call in ("lookup_hops", "lookup_aggregate"):
            copied.clear()
            with monkeypatch.context() as m:
                for name in ("cpu", "to", "item", "tolist", "__bool__",
                             "__int__", "__float__", "__index__"):
                    m.setattr(torch.Tensor, name,
                              spy(getattr(torch.Tensor, name)))
                got = getattr(dev, call)(hops_d)
            if call == "lookup_hops":
                rows = list(got)
            else:
                feats_a, agg = got
                assert all(x.equal(y) for x, y in zip(feats_a, rows[:2]))
                rows.append(agg)
            assert sum(copied) == (4 * (n_cold + 1) if n_cold else 0), (
                call, copied, n_cold)
        assert (n_cold == 0) == (placement == "device")
        for x, y in zip(rows, want):
            assert x.cpu().view(torch.int32).equal(y.view(torch.int32))
    assert dev.snapshot_stats() == cpu.snapshot_stats()


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["alltoall", "allgather"])
def test_sharded_lookups_card_match_cpu(card, strategy, tmp_path):
    """Four logical shards on the card: the sharded exchange, with its
    stage (uploaded by the prefetcher, rebinned on the card) on and off and
    per-shard spill files, equals the port on the CPU bit for bit and
    counter for counter, -0.0 rows included."""
    from repro_torch.core import (Prefetcher, ShardedFeatureStore,
                                  TieredFeatureStore, TopologySpec,
                                  quiver_placement)
    from repro_torch.launch.mesh import make_host_mesh
    rng = np.random.default_rng(0)
    n, d = 4000, 128
    feats = rng.normal(size=(n, d)).astype(np.float32)
    feats[rng.choice(n, 400, replace=False)] = -0.0
    fap = rng.random(n)
    topo = TopologySpec(num_pods=1, devices_per_pod=4, rows_per_device=250,
                        rows_host=1000, hot_replicate_fraction=0.25)
    plan = quiver_placement(fap, topo)
    stores, pfs = [], []
    for dev in (card, torch.device("cpu")):
        ss = ShardedFeatureStore.from_tiered(
            TieredFeatureStore.build(feats, plan, device=dev),
            make_host_mesh(4, device=dev.type), "x", strategy,
            spill_dir=str(tmp_path / dev.type))
        stores.append(ss)
        pfs.append(Prefetcher(ss, budget=512))
    assert stores[0].device.type == "cuda"
    for staged in (False, True, False):
        for ss, pf in zip(stores, pfs):
            if staged:
                pf.refresh(scores=fap)
            else:
                ss.publish_stage(None, None)
        for step in range(3):
            hops = [rng.integers(-1, n, s).astype(np.int32)
                    for s in (32, 320, 1600)]
            hops[2][:320] = hops[1]
            seen = [[r.cpu() for r in ss.lookup_hops(
                [torch.from_numpy(h).to(ss.device) for h in hops])]
                for ss in stores]
            for x, y in zip(*seen):
                assert x.view(torch.int32).equal(y.view(torch.int32))
    assert stores[0].snapshot_stats() == stores[1].snapshot_stats()
    st = stores[0].snapshot_stats()
    if strategy == "alltoall":   # allgather reads cold rows from the source
        assert st["exchanges"] > 0 and st["stage_hits"] > 0
        assert st["spill_reads"] > 0
    else:
        assert st["host_fetches"] > 0
    for pf in pfs:
        pf.close()


@pytest.mark.cuda
def test_psgs_fap_and_placement_are_bitwise_on_card(card):
    """ROADMAP C1: PSGS and FAP at the serve launcher's default graph
    (20,000 nodes, average degree 12, fan-outs 10, 5; the hub node takes
    105,387 of the 239,991 edges), computed twice on the card, equal each
    other and the CPU bit for bit, and so do the ``quiver_placement``
    tiers built from each FAP."""
    from repro_torch.core import (TopologySpec, WorkloadGenerator,
                                  compute_fap, compute_psgs,
                                  quiver_placement)
    from repro_torch.graph import power_law_graph
    from repro_torch.launch import serve as serve_launcher
    args = serve_launcher.parse_args([])
    fanouts = serve_launcher.fanouts_of(args)
    graph = power_law_graph(args.nodes, args.avg_degree, seed=0)
    gen = WorkloadGenerator(args.nodes, graph.out_degree, seed=2)
    topo = TopologySpec(num_pods=1, devices_per_pod=1,
                        rows_per_device=args.nodes // 4,
                        rows_host=args.nodes // 2,
                        hot_replicate_fraction=args.hot_frac)
    runs = [(compute_psgs(graph, fanouts, device=dev),
             compute_fap(graph, fanouts, seed_prob=gen.p, device=dev))
            for dev in (card, card, "cpu")]
    for name, i in (("psgs", 0), ("fap", 1)):
        want = runs[2][i].view(np.int32)
        for r in runs[:2]:
            split = int((r[i].view(np.int32) != want).sum())
            assert split == 0, f"{name}: {split} entries differ from the CPU"
    tiers = [quiver_placement(r[1], topo).tier for r in runs]
    assert np.array_equal(tiers[0], tiers[2])
    assert np.array_equal(tiers[1], tiers[2])


# geometric training: full widths on a small graph, card vs the CPU port
GEO_GRAPH = dict(nodes=256, edges=1024, d_feat=64, classes=16, graphs=None)


def _geometric_grads(mod, dev, dtype):
    from repro_torch.configs.gnn_common import make_concrete_batch
    model = mod._init(torch.Generator().manual_seed(0), GEO_GRAPH["d_feat"],
                      GEO_GRAPH["classes"], "custom", device=dev).to(dtype)
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in make_concrete_batch(GEO_GRAPH, seed=0,
                                             device=dev).items()}
    named = dict(model.named_parameters())
    loss = mod._loss(model, batch, GEO_GRAPH, "custom")
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), {k: g.cpu().double()
                                  for k, g in zip(named, grads)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["schnet", "meshgraphnet",
                                  "equiformer-v2"])
def test_geometric_card_matches_cpu(card, arch):
    """Each geometric architecture at its published widths: the card's
    loss within 1e-4 of the CPU port's, and every gradient against the
    CPU port in fp64 within 1e-3 of its own size (MeshGraphNet 1e-2: a
    ReLU flipped by fp32 rounding moves its unit's row; EquiformerV2's
    logit biases over their weight's size; ``chip_smoke.py`` says why),
    all of it within 1e-3 in norm; no kernel of the repo launches."""
    from repro_torch.launch import train as launcher
    mod = launcher.ADAPTERS[arch]
    before = [m.LAUNCHES.value for m in (tg_pkg, ga_pkg, eb_pkg, sp_pkg,
                                         fa_pkg)]
    loss, got = _geometric_grads(mod, card, torch.float32)
    assert before == [m.LAUNCHES.value for m in (tg_pkg, ga_pkg, eb_pkg,
                                                 sp_pkg, fa_pkg)]
    want_loss, _ = _geometric_grads(mod, "cpu", torch.float32)
    _, witness = _geometric_grads(mod, "cpu", torch.float64)
    assert abs(loss - want_loss) <= 1e-4
    tol = 1e-2 if arch == "meshgraphnet" else 1e-3
    for k, w in witness.items():
        size_key = (k[:-len("bias")] + "weight"
                    if k.endswith("alpha.layers.1.bias") else k)
        size = float(witness[size_key].abs().max())
        diff = float((got[k] - w).abs().max())
        assert (diff <= tol * size) if size else diff == 0, (k, diff, size)
    num = torch.sqrt(sum(((got[k] - w) ** 2).sum()
                         for k, w in witness.items()))
    den = torch.sqrt(sum((w ** 2).sum() for w in witness.values()))
    assert float(num / den) <= 1e-3


@pytest.mark.cuda
def test_equiformer_equivariance_at_lmax6_on_card(card):
    """Full-width EquiformerV2 (l_max 6) on the card: node logits
    unchanged under a rotation of the positions, and 8 edge chunks equal
    to 1, within 5e-5 (the CPU port: 5.7e-6 and 4.8e-6 at 512 nodes)."""
    from repro_torch.configs import equiformer_v2
    from repro_torch.configs.gnn_common import make_concrete_batch
    from repro_torch.models.equiformer_v2 import equiformer_forward
    from repro_torch.models.so3 import rotation_matrix_zyz
    model = equiformer_v2._init(torch.Generator().manual_seed(0), 64, 16,
                                "custom", device=card)
    b = make_concrete_batch(GEO_GRAPH, seed=1, device=card)
    src = torch.where(b["src"] == b["dst"], -1, b["src"])  # no self-loops
    rot = torch.as_tensor(rotation_matrix_zyz(0.4, 1.0, -0.3),
                          dtype=torch.float32, device=card)
    kw = dict(num_nodes=GEO_GRAPH["nodes"], node_feat=b["node_feat"])
    with torch.no_grad():
        base = equiformer_forward(model, b["species"], b["positions"], src,
                                  b["dst"], **kw)
        turned = equiformer_forward(model, b["species"],
                                    b["positions"] @ rot.T, src, b["dst"],
                                    **kw)
        chunked = equiformer_forward(model, b["species"], b["positions"],
                                     src, b["dst"], edge_chunks=8, **kw)
    assert bool(torch.isfinite(base).all())
    assert float((turned - base).abs().max()) <= 5e-5
    assert float((chunked - base).abs().max()) <= 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["schnet", "meshgraphnet",
                                  "equiformer-v2"])
def test_launcher_trains_geometric_on_card(card, arch, tmp_path):
    """``repro_torch.launch.train --arch A`` on the card: finite losses,
    a checkpoint, and a resumed run that ends with the uninterrupted
    run's last loss within 1e-4."""
    from repro_torch.launch import train as launcher
    argv = ["--device", "cuda", "--arch", arch, "--nodes", "512",
            "--edges", "4096"]
    whole = launcher.main(argv + ["--steps", "3"])
    assert len(whole["losses"]) == 3 and all(np.isfinite(whole["losses"]))
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    launcher.main(argv + ["--steps", "2"] + ck)
    resumed = launcher.main(argv + ["--steps", "3"] + ck)
    assert resumed["step"] == 3 and len(resumed["losses"]) == 1
    assert abs(resumed["losses"][0] - whole["losses"][2]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_backward_on_card_matches_cpu(card, mode):
    """The ``embedding_bag`` autograd Function on the card (the kernel's
    forward, the torch-op backward) against the CPU (plain forward, the
    same backward): the forward bitwise, both gradients within 1e-5 of
    their largest entry (the table's gradient adds repeated rows with
    atomics on the card), with hot repeated ids and padding."""
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(50, 36, generator=gen)
    ids = torch.randint(-1, 50, (64, 100), generator=gen, dtype=torch.int32)
    ids[:, ::7] = 3                                  # a hot row
    w = torch.randn(64, 100, generator=gen)
    g = torch.randn(64, 36, generator=gen)
    res = {}
    for dev in (card, torch.device("cpu")):
        t = table.to(dev).requires_grad_()
        ww = w.to(dev).requires_grad_()
        before = eb_pkg.LAUNCHES.value
        out = eb_ops.embedding_bag_autograd(t, ids.to(dev), ww, mode=mode)
        gt, gw = torch.autograd.grad(out, (t, ww), g.to(dev))
        res[dev.type] = (out.detach().cpu(), gt.cpu(), gw.cpu(),
                         eb_pkg.LAUNCHES.value - before)
    (o1, t1, w1, n1), (o2, t2, w2, n2) = res["cuda"], res["cpu"]
    assert (n1, n2) == (1, 0)
    assert torch.equal(o1, o2)
    for a, b in ((t1, t2), (w1, w2)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
def test_sage_full_graph_through_segment_spmm_on_card(card):
    """``sage_full_graph`` on the card launches ``segment_spmm`` once a
    layer, and its neighbour sums equal the port's ``scatter_spmm(h, dst,
    src, N)`` within 1e-5 of their size; the output is within 1e-4 of the
    CPU port's."""
    from repro_torch.graph import power_law_graph
    from repro_torch.graph.segment import scatter_spmm
    from repro_torch.models import gnn_basic
    g = power_law_graph(3000, 12, seed=0)
    src, dst = (torch.as_tensor(a.astype(np.int32)) for a in g.to_coo())
    x = torch.randn(3000, 64, generator=torch.Generator().manual_seed(1))
    ell = sp_ref.ell_table(dst.to(card), src.to(card), 3000)
    before = sp_pkg.LAUNCHES.value
    agg = sp_ops.segment_spmm(ell, x.to(card))
    want = scatter_spmm(x.to(card), dst.to(card), src.to(card), 3000)
    assert sp_pkg.LAUNCHES.value - before == 1
    assert float((agg - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    model = gnn_basic.sage_init(torch.Generator().manual_seed(0),
                                [64, 64, 64], device=card)
    cpu_model = gnn_basic.sage_init(torch.Generator().manual_seed(0),
                                    [64, 64, 64], device="cpu")
    before = sp_pkg.LAUNCHES.value
    with torch.no_grad():
        out = gnn_basic.sage_full_graph(model, x.to(card), src.to(card),
                                        dst.to(card), num_nodes=3000)
        ref_out = gnn_basic.sage_full_graph(cpu_model, x, src, dst,
                                            num_nodes=3000)
    assert sp_pkg.LAUNCHES.value - before == 2
    assert float((out.cpu() - ref_out).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_qwen3_train_step_peak_below_card(card):
    """One qwen3-4b ``train_4k`` step at its published widths and depth
    (fp32 weights and AdamW state, bf16 activations, B 1, 4,096
    positions) through the launcher: a finite loss between ln V and ln V
    + 1.5 (unit-variance logits at init give about ln V + 0.5) and a peak
    below the card's memory."""
    import gc
    import math
    from repro_torch.launch import lm as launcher
    gc.collect()
    torch.cuda.empty_cache()
    report = launcher.main(["--shape", "train_4k", "--steps", "1"])
    total = torch.cuda.get_device_properties(card).total_memory
    assert report["params"] == 4_411_415_040
    assert 0 < report["losses"][0] - math.log(151936) < 1.5
    assert report["peak_bytes"] < total


@pytest.mark.cuda
@pytest.mark.parametrize("world", [4, 8])
def test_halo_gather_card_equals_cpu(card, world):
    """``halo_gather`` over ``world`` shards on the card (round-robin over
    its cards) gives the CPU's rows bit for bit, drops included, and its
    gradient reaches the owners' rows as on the CPU."""
    from repro_torch.core import halo
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    rows, m, cap = 64, 300, 40
    rng = np.random.default_rng(world)
    x = rng.normal(size=(world * rows, 16)).astype(np.float32)
    want = [rng.integers(-1, world * rows, m).astype(np.int32)
            for _ in range(world)]
    outs, grads = [], []
    for mesh in (make_host_mesh(world, device="cuda"),
                 Mesh(("cpu",) * world)):
        xt = torch.tensor(x, device=mesh.devices[0], requires_grad=True)
        xs = [part.to(dev) for part, dev in zip(xt.split(rows),
                                                mesh.devices)]
        got = halo.halo_gather(xs, [torch.from_numpy(w) for w in want],
                               mesh=mesh, rows_per_shard=rows, cap_pp=cap)
        sum(g.sum().cpu() * (i + 1) for i, g in enumerate(got)).backward()
        outs.append(torch.stack([g.cpu() for g in got]))
        grads.append(xt.grad.cpu())
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_gin_halo_loss_through_segment_spmm_on_card(card):
    """The sharded GIN-TU loss at 4 shards on the card: 5 + 4
    ``segment_spmm`` launches a card, the unsharded loss's value (no id
    dropped: the same rows summed in the same order), and within 1e-5 of
    the CPU's sharded loss."""
    from repro_torch.configs import gin_tu, gnn_common
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    info = dict(nodes=2048, edges=16384, d_feat=32, classes=7, graphs=None)
    losses = {}
    for dev, mesh in (("cuda", make_host_mesh(4, device="cuda")),
                      ("cpu", Mesh(("cpu",) * 4))):
        model = gin_tu._init(torch.Generator().manual_seed(0), 32, 7,
                             "custom", device=dev)
        batch = gnn_common.make_concrete_batch(info, seed=0, device="cpu")
        cell = gnn_common.build_halo_cell(gin_tu.ARCH.adapter, info,
                                          "custom", mesh, cap_pp=4096)
        sp_pkg.LAUNCHES.reset()
        loss = cell.loss(model, cell.shard(batch))
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert sp_pkg.LAUNCHES.value == 9 * len(cell.ctx.groups)
            whole = gin_tu._loss(model, {k: v.to(dev) for k, v in
                                         batch.items()}, info, "custom")
            assert abs(float(loss.detach()) - float(whole.detach())) <= 1e-6
        assert cell.ctx.stats["dropped_ids"] == 0
        losses[dev] = float(loss.detach())
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-5


@pytest.mark.cuda
def test_large_smem_kernels_launch_on_every_card(card):
    """``segment_spmm`` at d 100 and 128 and ``embedding_bag`` over bags of
    500 at d 128 ask for more than 48 KB of shared memory a block, which
    each card must allow before its first launch there (the limit is a
    per-device attribute): card by card, in order, each equals its plain
    version bit for bit."""
    rng = np.random.default_rng(7)
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        ids = torch.from_numpy(rng.integers(-1, 3000, (500, 40))
                               .astype(np.int32)).to(dev)
        for d in (100, 128):
            feat = torch.from_numpy(rng.normal(size=(3000, d))
                                    .astype(np.float32)).to(dev)
            assert torch.equal(sp_ops.segment_spmm(ids, feat),
                               sp_ref.segment_spmm_plain(ids, feat)), (i, d)
        table = torch.from_numpy(rng.normal(size=(3000, 128))
                                 .astype(np.float32)).to(dev)
        bags = torch.from_numpy(rng.integers(-1, 3000, (64, 500))
                                .astype(np.int32)).to(dev)
        assert torch.equal(eb_ops.embedding_bag(table, bags, None),
                           eb_ref.embedding_bag_ref(table, bags, None)), i


@pytest.mark.cuda
@pytest.mark.parametrize("d, dtype, offset", [
    (16, torch.float32, 0), (64, torch.float32, 0), (256, torch.float32, 0),
    (16, torch.bfloat16, 0), (37, torch.bfloat16, 0),
    (256, torch.bfloat16, 1)])
def test_gather_aggregate_autotune_plans_bitwise_on_card(card, d, dtype,
                                                         offset):
    """Every launch shape the autotune sweeps gives the plain version's
    bits (compared as integers, rows of -0.0 included): the fold is
    ordered over the fan axis whatever the plan. The autotune times them
    all, the default among them, and counts its wrapper calls."""
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.gather_aggregate import autotune, kernel
    gen = torch.Generator(device=card).manual_seed(d)

    def table(rows, off=0):
        x = torch.randn((rows + off, d), generator=gen, device=card)
        x = x.to(dtype)[off:]
        x[::7] = -0.0
        return x

    hot, warm, cold = table(51, offset), table(40), table(9)
    segs, fan = 2272, 5
    tier = torch.randint(0, 4, (segs, fan), generator=gen, device=card,
                         dtype=torch.int32)
    tier[tier == 3] = 99
    slot = torch.randint(-2, 60, (segs, fan), generator=gen, device=card,
                         dtype=torch.int32)
    want = ga_ref.gather_aggregate_ref(tier, slot, hot, warm, cold)
    out = kernel.gather_aggregate_cuda(tier, slot, hot, warm, cold)
    addr = (hot.data_ptr() | warm.data_ptr() | cold.data_ptr()
            | out.data_ptr())
    plans = autotune.candidate_plans(d, hot.element_size(), addr, segs,
                                     sm_count(card))
    assert len(plans) > 1
    for plan in plans:
        got = kernel.gather_aggregate_cuda(tier, slot, hot, warm, cold,
                                           plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(int_bits(got), int_bits(want)), plan
    before = ga_pkg.LAUNCHES.value
    tune = autotune.autotune_gather_aggregate(tier, slot, hot, warm, cold,
                                              repeats=3)
    assert len(tune["timings_us"]) == len(plans)
    assert autotune.plan_key(plans[0]) in tune["timings_us"]
    assert tune["default"] == autotune.plan_dict(plans[0])
    assert tune["launches"] == ga_pkg.LAUNCHES.value - before > 0
    assert all(t > 0 for t in tune["timings_us"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [
    LanePlan(8, 2, 3, 10, 1, 1), LanePlan(8, 2, 64, 0, 1, 1),
    LanePlan(8, 2, 2, 16, 1, 0), LanePlan(16, 1, 1, 32, 1, 1)],
    ids=["lanes3", "lanes64", "blocks0", "vec16_row16_at8"])
def test_gather_aggregate_refuses_plans_it_cannot_run_on_card(card, plan):
    """The wrapper refuses a plan the kernel cannot run, and launches
    nothing: the C side the lanes and the grid, ``check_plan`` a vector
    that does not divide every row's address (for the 16-byte vector the
    table of fp32 d 4 rows starts 8 bytes past the allocation)."""
    from repro_torch.kernels.gather_aggregate import kernel
    flat = torch.ones(26, device=card)
    hot = (flat[2:] if plan.vec_bytes == 16 else flat)[:24].view(6, 4)
    assert hot.data_ptr() % 16 == (8 if plan.vec_bytes == 16 else 0)
    tier = torch.zeros((3, 2), dtype=torch.int32, device=card)
    before = ga_pkg.LAUNCHES.value
    with pytest.raises((RuntimeError, ValueError)):
        kernel.gather_aggregate_cuda(tier, tier, hot, hot, hot, plan=plan)
    assert ga_pkg.LAUNCHES.value == before



def _tp_smoke_run(mesh, steps: int = 2):
    """codeqwen1.5-7b's smoke reduction, fp32, ``steps`` steps of the
    ``train_4k`` cell (B 16, 64 positions, micro 4) on ``mesh``:
    ``(losses, gathered weights, gathered mu, model)``."""
    from repro_torch.configs import LM_ARCHS, lm_common
    from repro_torch.models import transformer as tf
    cfg = lm_common.smoke_config(LM_ARCHS["codeqwen1.5-7b"])
    home = mesh.devices[0]
    lm = tf.lm_init(torch.Generator(device=home).manual_seed(0), cfg,
                    mesh=mesh, rules=lm_common.train_rules(mesh, cfg))
    opt = lm_common.train_optimizer()
    state = opt.init(lm_common.zero1_params(lm))
    gen = torch.Generator(device=home).manual_seed(1)
    losses = []
    for _ in range(steps):
        toks = torch.randint(0, cfg.vocab, (2, 16, 64), generator=gen,
                             device=home)
        state, loss = lm_common.train_step(
            lm, opt, state, {"tokens": toks[0], "targets": toks[1]}, cfg,
            micro=4, chunks=lm_common.SMOKE_CHUNKS)
        losses.append(loss.item())
    return (losses, tf.gathered_state_dict(lm),
            lm_common.gathered_opt_state(lm, state)["mu"], lm)


def _on_card0(model: int):
    """Four logical shards of a ``(4 // model, model)`` mesh, all on card
    0."""
    from repro_torch.launch.mesh import Mesh
    return Mesh((torch.device("cuda", 0),) * 4, ("data", "model"),
                (4 // model, model))


@pytest.mark.cuda
@pytest.mark.parametrize("model", [4, 2])
def test_tp_train_on_logical_shards_repeats_bitwise(card, model):
    """Four logical shards on card 0: two runs of the smoke-size step give
    the same bits (losses, weights, mu), every sum in an order the port
    fixes."""
    a, b = _tp_smoke_run(_on_card0(model)), _tp_smoke_run(_on_card0(model))
    assert a[0] == b[0]
    for x, y in ((a[1], b[1]), (a[2], b[2])):
        assert all(torch.equal(x[k], y[k]) for k in x)


@pytest.mark.cuda
@pytest.mark.parametrize("model", [4, 2])
def test_tp_train_on_four_cards(four_cards, model):
    """One shard a card against four logical shards on card 0: the same
    bits (losses, weights, mu), every card's blocks on that card."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(4, model=model, device="cuda")
    assert [d.index for d in mesh.devices] == [0, 1, 2, 3]
    four = _tp_smoke_run(mesh)
    for i, sh in enumerate(four[3].shards):
        assert all(p.device == torch.device("cuda", i)
                   for p in sh.parameters())
    one = _tp_smoke_run(_on_card0(model))
    assert four[0] == one[0]
    for x, y in ((four[1], one[1]), (four[2], one[2])):
        assert all(torch.equal(x[k], y[k]) for k in x)


def _fsdp_moe_run(mesh, card, steps: int = 2):
    """deepseek-moe-16b's smoke reduction in fp32, ``lm_init`` from seed 0
    on the CPU and copied onto the card (``mesh``'s shards, by the
    reference's full FSDP; world 1 without a mesh), ``steps`` steps of the
    ``train_4k`` cell (B 16, 64 positions, micro 4) on batches drawn on
    the CPU from seed 1 (their smallest gap between a token's k-th and
    (k+1)-th router probabilities is 1.8e-5 on the CPU: far above the
    card's fp32 rounding): ``(losses, gathered weights, gathered mu,
    model)``."""
    from repro_torch.configs import LM_ARCHS, lm_common
    from repro_torch.models import transformer as tf
    cfg = lm_common.smoke_config(LM_ARCHS["deepseek-moe-16b"])
    one = tf.lm_init(torch.Generator().manual_seed(0), cfg)
    if mesh is None:
        lm = one.to(card)
    else:
        lm = tf.LM(cfg, device=mesh.devices[0], mesh=mesh,
                   rules=lm_common.train_rules(mesh, cfg))
        for name, p in one.named_parameters():
            lm.load_full(name, p.detach().to(card))
    opt = lm_common.train_optimizer()
    state = opt.init(lm_common.zero1_params(lm) if mesh is not None
                     else dict(lm.named_parameters()))
    toks = torch.randint(0, cfg.vocab, (steps, 2, 16, 64),
                         generator=torch.Generator().manual_seed(1)).to(card)
    losses = []
    for t in range(steps):
        state, loss = lm_common.train_step(
            lm, opt, state, {"tokens": toks[t, 0], "targets": toks[t, 1]},
            cfg, micro=4, chunks=lm_common.SMOKE_CHUNKS)
        losses.append(loss.item())
    if mesh is None:
        return losses, tf.gathered_state_dict(lm), dict(state.mu), lm
    return (losses, tf.gathered_state_dict(lm),
            lm_common.gathered_opt_state(lm, state)["mu"], lm)


@pytest.mark.cuda
@pytest.mark.parametrize("model", [4, 2, 1])
def test_fsdp_moe_train_on_logical_shards_matches_world_1(card, model):
    """Four logical shards on card 0 at (4 / model, model): two runs give
    the same bits (losses, weights, mu), and they follow world 1 on the
    card: each loss within 1e-5, the gathered mu within 1e-4 of its norm
    (fp32; the card's sums in other orders; limits set before the card
    ran it)."""
    mesh = _on_card0(model)
    a, b = _fsdp_moe_run(mesh, card), _fsdp_moe_run(mesh, card)
    assert a[0] == b[0]
    for x, y in ((a[1], b[1]), (a[2], b[2])):
        assert all(torch.equal(x[k], y[k]) for k in x)
    one = _fsdp_moe_run(None, card)
    assert max(abs(p - q) for p, q in zip(a[0], one[0])) <= 1e-5
    num = sum(float(((a[2][k].cpu() - one[2][k].cpu()) ** 2).sum())
              for k in one[2])
    den = sum(float((one[2][k].cpu() ** 2).sum()) for k in one[2])
    assert (num / den) ** 0.5 <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("model", [4, 2, 1])
def test_fsdp_moe_on_four_cards(four_cards, model):
    """deepseek-moe-16b's smoke reduction by full FSDP, one shard a card,
    against four logical shards on card 0: the same bits (losses, weights,
    mu), every shard's blocks on its card."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(4, model=model, device="cuda")
    assert [d.index for d in mesh.devices] == [0, 1, 2, 3]
    four = _fsdp_moe_run(mesh, four_cards)
    for i, sh in enumerate(four[3].shards):
        assert all(p.device == torch.device("cuda", i)
                   for p in sh.parameters())
    one = _fsdp_moe_run(_on_card0(model), four_cards)
    assert four[0] == one[0]
    for x, y in ((four[1], one[1]), (four[2], one[2])):
        assert all(torch.equal(x[k], y[k]) for k in x)


@pytest.mark.cuda
def test_program_idle_gaps_name_all_device_idle_time(card, monkeypatch):
    """A traced short window of reddit-sage2.bulk at its own size with the
    port's tracer on: the line reports ``program_idle_gaps`` and the
    feature store's metrics, and the program's spans name every idle
    second of the device, within 1%."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    from servebench import program, run
    line, _, prog = program.traced_cell(
        run.load_json(root / "BENCHMARK.json"), "reddit-sage2.bulk", 5005,
        4.0, True, device=torch.device("cuda", 0))
    assert line["correct"] is True, line["checks"]
    idle = line["device"]["window_s"] - line["device"]["busy_s"]
    assert line["program_idle_gaps"]
    assert sum(prog.gaps.values()) == pytest.approx(idle, rel=0.01)
    assert sum(v for _, v in line["program_idle_gaps"]) <= idle * 1.01
    assert {"collect_host_ms", "collect_wait_ms"} <= set(line["metrics"])
