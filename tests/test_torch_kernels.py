"""Port kernels against the JAX reference: the plain PyTorch versions of
``tiered_gather`` and ``gather_aggregate`` are bitwise equal to the Pallas
kernels in interpret mode (fp32 and bf16, tier-99 pads, clamped slots,
ragged/degree-0/empty segments), the dispatch takes the plain version only
for CPU tensors, and no non-CPU call can reach it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather_aggregate.kernel import gather_aggregate_pallas
from repro.kernels.gather_aggregate.ref import gather_aggregate_ref
from repro.kernels.tiered_gather.kernel import tiered_gather_pallas
from repro.kernels.tiered_gather.ref import tiered_gather_ref
from repro_torch import resolve_device
from repro_torch.kernels import gather_aggregate as ga_pkg
from repro_torch.kernels import tiered_gather as tg_pkg
from repro_torch.kernels.gather_aggregate import ops as ga_ops
from repro_torch.kernels.gather_aggregate import ref as ga_ref
from repro_torch.kernels.tiered_gather import ops as tg_ops
from repro_torch.kernels.tiered_gather import ref as tg_ref

# fp32 sums taken in another order than the in-order fan loop
TOL = dict(rtol=2e-5, atol=2e-5)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tables(rng, dtype, *rows, d):
    """The same fp32 draws rounded to ``dtype`` on both sides (round to
    nearest even in both frameworks, so the bits agree)."""
    jdt, tdt = DTYPES[dtype]
    out = []
    for r in rows:
        x = rng.normal(size=(r, d)).astype(np.float32)
        out.append((jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)))
    return out


def _np(x):
    """Exact fp32 numpy view of a JAX or torch array (bf16 → fp32 is
    exact, so equal fp32 means equal bits)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# tiered_gather
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", [(37, 16), (64, 48), (5, 128)])
def test_tiered_gather_plain_equals_pallas(dtype, m, d):
    rng = np.random.default_rng(m * d)
    h, w = 23, 17
    (hot_j, hot_t), (warm_j, warm_t) = _tables(rng, dtype, h, w, d=d)
    tier = rng.choice([0, 1, 2, 3, 99, -1], size=m,
                      p=[.35, .35, .1, .1, .05, .05]).astype(np.int32)
    # slots past the end on purpose: every version clamps them to the last
    # row of the selected table
    slot = rng.integers(0, max(h, w) + 5, size=m).astype(np.int32)
    plain = tg_ref.tiered_gather_ref(torch.from_numpy(tier),
                                     torch.from_numpy(slot), hot_t, warm_t)
    pallas = tiered_gather_pallas(jnp.asarray(tier), jnp.asarray(slot),
                                  hot_j, warm_j, interpret=True)
    ref = tiered_gather_ref(jnp.asarray(tier), jnp.asarray(slot), hot_j,
                            warm_j)
    assert plain.dtype == DTYPES[dtype][1] and plain.shape == (m, d)
    assert np.array_equal(_np(plain), _np(pallas))
    assert np.array_equal(_np(plain), _np(ref))
    assert not _np(plain)[(tier != 0) & (tier != 1)].any()  # pads are zero
    # a negative slot clamps to row 0 as in the reference's ref.py (the
    # store never makes one; Pallas interpret mode wraps it instead)
    neg = np.full(m, -2, np.int32)
    plain_neg = tg_ref.tiered_gather_ref(torch.from_numpy(tier),
                                         torch.from_numpy(neg), hot_t, warm_t)
    ref_neg = tiered_gather_ref(jnp.asarray(tier), jnp.asarray(neg), hot_j,
                                warm_j)
    assert np.array_equal(_np(plain_neg), _np(ref_neg))


def test_tiered_gather_empty_m():
    hot = torch.ones((4, 8))
    out = tg_ops.tiered_gather(torch.zeros(0, dtype=torch.int32),
                               torch.zeros(0, dtype=torch.int32), hot, hot)
    ref = tiered_gather_ref(jnp.zeros(0, jnp.int32), jnp.zeros(0, jnp.int32),
                            jnp.ones((4, 8)), jnp.ones((4, 8)))
    assert out.shape == ref.shape == (0, 8)


# ---------------------------------------------------------------------------
# gather_aggregate
# ---------------------------------------------------------------------------
def _addresses(rng, s, fan, h, w, k):
    """Random (tier, slot) segment matrix over 3 sources + invalid pads,
    with a degree-0 and a degree-1 segment."""
    tier = rng.choice([0, 1, 2, 99], size=(s, fan),
                      p=[.4, .3, .2, .1]).astype(np.int32)
    tier[0] = 99
    tier[1, 1:] = 99
    slot = np.zeros((s, fan), np.int32)
    for t, rows in ((0, h), (1, w), (2, k)):
        slot[tier == t] = rng.integers(0, rows, (tier == t).sum())
    return tier, slot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 64, 256])
def test_gather_aggregate_plain_equals_pallas(dtype, d):
    rng = np.random.default_rng(d)
    s, fan, h, w, k = 37, 5, 50, 40, 9
    (hot_j, hot_t), (warm_j, warm_t), (cold_j, cold_t) = _tables(
        rng, dtype, h, w, k, d=d)
    tier, slot = _addresses(rng, s, fan, h, w, k)
    plain = ga_ref.gather_aggregate_ref(torch.from_numpy(tier),
                                        torch.from_numpy(slot), hot_t,
                                        warm_t, cold_t)
    pallas = gather_aggregate_pallas(jnp.asarray(tier), jnp.asarray(slot),
                                     hot_j, warm_j, cold_j, interpret=True)
    assert plain.dtype == DTYPES[dtype][1] and plain.shape == (s, d)
    assert np.array_equal(_np(plain), _np(pallas))
    assert not _np(plain)[0].any()  # degree-0 segment is an exact zero row
    if dtype == "float32":
        ref = gather_aggregate_ref(jnp.asarray(tier), jnp.asarray(slot),
                                   hot_j, warm_j, cold_j)
        np.testing.assert_allclose(_np(plain), _np(ref), **TOL)


@pytest.mark.parametrize("s,fan", [(0, 3), (5, 0), (6, 3)])
def test_gather_aggregate_empty_and_invalid(s, fan):
    """Empty grids and all-invalid segments give exact zeros, as the Pallas
    kernel does (its empty-grid guard, and tier 99 contributing 0)."""
    d = 8
    hot = torch.ones((4, d))
    tier = torch.full((s, fan), 99, dtype=torch.int32)
    out = ga_ops.gather_aggregate(tier, torch.zeros_like(tier), hot, hot,
                                  torch.ones((1, d)))
    pallas = gather_aggregate_pallas(jnp.asarray(tier.numpy()),
                                     jnp.zeros((s, fan), jnp.int32),
                                     jnp.ones((4, d)), jnp.ones((4, d)),
                                     jnp.ones((1, d)), interpret=True)
    assert out.shape == pallas.shape == (s, d)
    assert np.array_equal(out.numpy(), np.asarray(pallas))
    assert not out.any()


def _bits(x):
    """The fp32 bits of a JAX or torch array (bf16 → fp32 is exact and
    keeps the sign of zero, so equal bits here mean equal bits there)."""
    return _np(x).view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_negative_zero_rows_plain_equals_pallas_bitwise(dtype):
    """Rows of -0.0: the fold starts at +0.0, so a singleton -0.0 row (or a
    fan of them) sums to +0.0, while the copy keeps -0.0; the plain
    versions agree with the Pallas kernels in interpret mode bit for bit,
    with rows that hold -0.0 among other values too."""
    rng = np.random.default_rng(11)
    d, fan = 16, 3
    (hot_j, hot_t), (warm_j, warm_t), (cold_j, cold_t) = _tables(
        rng, dtype, 6, 5, 2, d=d)
    neg = {"hot": 2, "warm": 4, "cold": 1}
    jdt = DTYPES[dtype][0]
    hot_j = hot_j.at[neg["hot"]].set(jnp.asarray(-0.0, jdt))
    warm_j = warm_j.at[neg["warm"]].set(jnp.asarray(-0.0, jdt))
    cold_j = cold_j.at[neg["cold"]].set(jnp.asarray(-0.0, jdt))
    hot_j = hot_j.at[0, ::3].set(jnp.asarray(-0.0, jdt))  # mixed row
    for t, key in ((hot_t, "hot"), (warm_t, "warm"), (cold_t, "cold")):
        t[neg[key]] = -0.0
    hot_t[0, ::3] = -0.0
    assert np.array_equal(_bits(hot_t), _bits(hot_j))
    # segments: a -0.0 singleton of each tier, a fan of -0.0 rows, the
    # mixed row alone and among others, and an all-pad segment
    tier = np.array([[0, 99, 99], [1, 99, 99], [2, 99, 99], [0, 1, 2],
                     [0, 99, 99], [0, 1, 0], [99, 99, 99]], np.int32)
    slot = np.array([[2, 0, 0], [4, 0, 0], [1, 0, 0], [2, 4, 1],
                     [0, 0, 0], [0, 1, 3], [0, 0, 0]], np.int32)
    args_t = (torch.from_numpy(tier), torch.from_numpy(slot), hot_t, warm_t,
              cold_t)
    args_j = (jnp.asarray(tier), jnp.asarray(slot), hot_j, warm_j, cold_j)
    plain = ga_ref.gather_aggregate_ref(*args_t)
    pallas = gather_aggregate_pallas(*args_j, interpret=True)
    assert np.array_equal(_bits(plain), _bits(pallas))
    assert not _bits(plain)[:4].any()           # +0.0 after the fold
    flat = (torch.from_numpy(tier[:, 0].copy()),
            torch.from_numpy(slot[:, 0].copy()), hot_t, warm_t)
    plain_tg = tg_ref.tiered_gather_ref(*flat)
    pallas_tg = tiered_gather_pallas(
        jnp.asarray(tier[:, 0]), jnp.asarray(slot[:, 0]), hot_j, warm_j,
        interpret=True)
    assert np.array_equal(_bits(plain_tg), _bits(pallas_tg))
    assert (_bits(plain_tg)[:2] == np.uint32(0x80000000)).all()  # -0.0
    assert not _bits(plain_tg)[2].any()         # tier 2: not a copy tier


def test_fan_sum_is_in_order_fp32():
    """``fan_sum`` adds child 0, then 1, ... in fp32 — the kernel's order."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(7, 25, 3)).astype(np.float32))
    acc = np.zeros((7, 3), np.float32)
    for n in range(25):
        acc = acc + x[:, n].numpy()
    assert np.array_equal(ga_ref.fan_sum(x).numpy(), acc)


# ---------------------------------------------------------------------------
# dispatch seams
# ---------------------------------------------------------------------------
def _tg_args(device):
    z = torch.zeros(4, dtype=torch.int32, device=device)
    t = torch.zeros((3, 8), device=device)
    return z, z, t, t


def _ga_args(device):
    z = torch.zeros((4, 2), dtype=torch.int32, device=device)
    t = torch.zeros((3, 8), device=device)
    return z, z, t, t, t


def test_ops_take_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    hot = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    tier = torch.tensor([0, 1, 99, 0], dtype=torch.int32)
    slot = torch.tensor([5, 2, 0, 1], dtype=torch.int32)
    assert torch.equal(tg_ops.tiered_gather(tier, slot, hot, hot),
                       tg_ref.tiered_gather_ref(tier, slot, hot, hot))
    t2, s2 = tier.reshape(2, 2), slot.reshape(2, 2)
    assert torch.equal(ga_ops.gather_aggregate(t2, s2, hot, hot, hot),
                       ga_ref.gather_aggregate_ref(t2, s2, hot, hot, hot))
    assert tg_pkg.LAUNCHES.value == 0 and ga_pkg.LAUNCHES.value == 0


@pytest.mark.parametrize("which", ["tiered_gather", "gather_aggregate"])
def test_non_cpu_tensors_never_reach_plain_version(monkeypatch, which):
    """With the plain version rigged to fail, a non-CPU request must raise
    from the kernel wrapper (``meta`` tensors stand in for CUDA ones where
    there is no card) — there is no fallback path to the plain version."""
    def rigged(*_a, **_k):
        raise AssertionError("plain version reached from a non-CPU call")

    if which == "tiered_gather":
        monkeypatch.setattr(tg_ref, "tiered_gather_ref", rigged)
        call, args = tg_ops.tiered_gather, _tg_args
    else:
        monkeypatch.setattr(ga_ref, "gather_aggregate_ref", rigged)
        call, args = ga_ops.gather_aggregate, _ga_args
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        call(*args("meta"))
    with pytest.raises(AssertionError, match="plain version reached"):
        call(*args("cpu"))


def test_cuda_wrappers_reject_cpu_tensors_and_cuda_needs_a_card():
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tg_pkg.tiered_gather_cuda(*_tg_args("cpu"))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ga_pkg.gather_aggregate_cuda(*_ga_args("cpu"))
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no|False"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
