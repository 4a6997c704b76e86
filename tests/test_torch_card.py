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


def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


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
    assert torch.equal(_bits(first), _bits(want))
    assert torch.equal(_bits(again), _bits(first))
    assert not _bits(first)[0].any()                  # +0.0 after the fold
    assert torch.equal(_bits(first_tg), _bits(want_tg))
    assert torch.equal(_bits(again_tg), _bits(first_tg))
    assert torch.equal(_bits(first_tg[0]), _bits(hot[3]))  # -0.0 copied
    assert (_bits(hot[3]) != 0).all()
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
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got_tg), _bits(want_tg))


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
