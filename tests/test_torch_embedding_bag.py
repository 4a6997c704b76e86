"""Port ``embedding_bag`` against the JAX reference: the plain PyTorch
version is bitwise equal to the Pallas kernel in interpret mode (fp32,
the sweep of ``tests/test_kernels.py``), close in bf16, zeros on an empty
grid, clamps an id ≥ V to row V-1 as the Pallas body does, and divides a
weighted mean by the valid count; the dispatch takes the plain version
only for CPU tensors, and the CUDA wrapper refuses anything else.

XLA compiles the Pallas body's ``acc + row * w`` to one fused
multiply-add, so a weighted step is an FMA in the port too
(``ref.fma_f32``, pinned against an exact oracle here)."""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.kernel import embedding_bag_pallas
from repro.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels import embedding_bag as eb_pkg
from repro_torch.kernels.embedding_bag import kernel as eb_kernel
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref

# the tests/test_kernels.py sweep: (B, bag, V, d, mode, weighted)
SWEEP = [(21, 7, 100, 64, "sum", False), (21, 7, 100, 64, "mean", False),
         (8, 20, 1000, 18, "sum", True), (64, 3, 50, 128, "mean", True)]


def _inputs(bsz, bag, v, d, weighted, dtype=np.float32):
    rng = np.random.default_rng(bsz * bag)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(-1, v, size=(bsz, bag)).astype(np.int32)
    ids[0] = -1                       # an all-padding bag
    w = rng.normal(size=(bsz, bag)).astype(np.float32) if weighted else None
    return table, ids, w


@pytest.mark.parametrize("bsz,bag,v,d,mode,weighted", SWEEP)
def test_plain_equals_pallas_fp32(bsz, bag, v, d, mode, weighted):
    table, ids, w = _inputs(bsz, bag, v, d, weighted)
    plain = eb_ref.embedding_bag_ref(
        torch.from_numpy(table), torch.from_numpy(ids),
        None if w is None else torch.from_numpy(w), mode=mode)
    pallas = embedding_bag_pallas(
        jnp.asarray(table), jnp.asarray(ids),
        None if w is None else jnp.asarray(w), mode=mode, interpret=True)
    assert plain.dtype == torch.float32 and plain.shape == (bsz, d)
    assert np.array_equal(plain.numpy(), np.asarray(pallas))
    assert not plain[0].any()         # all-padding bag is an exact zero row


@pytest.mark.parametrize("bsz,bag,v,d,mode,weighted", SWEEP)
def test_plain_close_to_pallas_bf16(bsz, bag, v, d, mode, weighted):
    """bf16 table and weights, fp32 accumulation on both sides; the two
    frameworks may round bf16 at other places, so 1e-2."""
    table, ids, w = _inputs(bsz, bag, v, d, weighted)
    t_t = torch.from_numpy(table).to(torch.bfloat16)
    w_t = None if w is None else torch.from_numpy(w).to(torch.bfloat16)
    plain = eb_ref.embedding_bag_ref(t_t, torch.from_numpy(ids), w_t,
                                     mode=mode)
    pallas = embedding_bag_pallas(
        jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(ids),
        None if w is None else jnp.asarray(w).astype(jnp.bfloat16),
        mode=mode, interpret=True)
    assert plain.dtype == torch.bfloat16
    np.testing.assert_allclose(plain.float().numpy(),
                               np.asarray(pallas.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("b,bag,d", [(0, 4, 8), (3, 0, 8), (3, 4, 0)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_empty_grid_gives_zeros(b, bag, d, mode):
    table = torch.ones((5, d))
    ids = torch.zeros((b, bag), dtype=torch.int32)
    out = eb_ops.embedding_bag(table, ids, mode=mode)
    pallas = embedding_bag_pallas(jnp.ones((5, d)),
                                  jnp.zeros((b, bag), jnp.int32), mode=mode,
                                  interpret=True)
    assert out.shape == pallas.shape == (b, d)
    assert not out.any()


def test_id_past_the_table_clamps_to_last_row():
    """The Pallas body clamps an id ≥ V to row V-1 ([9, 11, 13] here); the
    reference's jnp oracle gives NaN for it. The port follows the body."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[0, 5, -1]], np.int32)
    plain = eb_ops.embedding_bag(torch.from_numpy(table),
                                 torch.from_numpy(ids))
    pallas = embedding_bag_pallas(jnp.asarray(table), jnp.asarray(ids),
                                  interpret=True)
    assert plain.tolist() == [[9.0, 11.0, 13.0]]
    assert np.array_equal(plain.numpy(), np.asarray(pallas))
    assert np.isnan(np.asarray(embedding_bag_ref(jnp.asarray(table),
                                                 jnp.asarray(ids)))).all()


def test_weighted_mean_divides_by_valid_count():
    """Kernel semantics: a weighted mean divides by the valid count, not by
    Σ w ([.75, 2, 3.25] here, as the Pallas body and its oracle give)."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[0, 1, -1]], np.int32)
    w = np.array([[2.0, 0.5, 7.0]], np.float32)
    plain = eb_ops.embedding_bag(torch.from_numpy(table),
                                 torch.from_numpy(ids), torch.from_numpy(w),
                                 mode="mean")
    pallas = embedding_bag_pallas(jnp.asarray(table), jnp.asarray(ids),
                                  jnp.asarray(w), mode="mean", interpret=True)
    np.testing.assert_array_equal(plain.numpy(), [[0.75, 2.0, 3.25]])
    assert np.array_equal(plain.numpy(), np.asarray(pallas))
    np.testing.assert_allclose(
        np.asarray(embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                     jnp.asarray(w), mode="mean")),
        [[0.75, 2.0, 3.25]])


def _fma_oracle(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """a·b + c rounded once to fp32 (nearest, ties to even), exactly."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    guess = np.float32(float(exact))
    cands = [np.nextafter(guess, np.float32(-np.inf)), guess,
             np.nextafter(guess, np.float32(np.inf))]
    dist = [abs(Fraction(float(x)) - exact) for x in cands]
    best = min(dist)
    ties = [x for x, e in zip(cands, dist) if e == best]
    return min(ties, key=lambda x: int(np.float32(x).view(np.int32)) & 1)


def test_fma_f32_rounds_once():
    """``fma_f32`` is an IEEE fused multiply-add on random fp32 triples and
    on one where rounding through fp64 would round twice:
    0.25(1+2⁻²³) · 0.25(1-2⁻²³) + (2²⁰ + 0.125) = 2²⁰ + 0.125 + 2⁻⁴ - 2⁻⁵⁰,
    just below a midpoint that fp64 rounds onto."""
    rng = np.random.default_rng(5)
    a, b, c = (rng.normal(size=300).astype(np.float32)
               * np.float32(2.0) ** rng.integers(-20, 20, 300)
               .astype(np.float32) for _ in range(3))
    hard = np.array([0.25 * (1 + 2 ** -23), 0.25 * (1 - 2 ** -23),
                     2 ** 20 + 0.125], np.float32)
    a, b, c = (np.append(x, h) for x, h in zip((a, b, c), hard))
    got = eb_ref.fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_fma_oracle(*t) for t in zip(a, b, c)], np.float32)
    assert np.array_equal(got, want)
    assert got[-1] == np.float32(2 ** 20 + 0.125)
    assert (a[-1].astype(np.float64) * b[-1] + c[-1]).astype(
        np.float32) != got[-1]          # the naive fp64 route rounds twice


@pytest.mark.parametrize("weighted", [False, True])
def test_sum_is_in_bag_order_fp32(weighted):
    """The plain version adds term 0, then 1, ... in fp32 — the kernel's
    order — a weighted term as one fused multiply-add."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(40, 5)).astype(np.float32)
    ids = rng.integers(-1, 40, size=(6, 30)).astype(np.int32)
    w = rng.normal(size=(6, 30)).astype(np.float32)
    acc = torch.zeros((6, 5))
    for j in range(30):
        row = torch.from_numpy(table[np.maximum(ids[:, j], 0)])
        wj = torch.from_numpy((ids[:, j] >= 0).astype(np.float32)
                              * (w[:, j] if weighted else 1.0))
        wj = wj[:, None].expand_as(acc)
        acc = eb_ref.fma_f32(row, wj, acc) if weighted else acc + row * wj
    out = eb_ref.embedding_bag_ref(
        torch.from_numpy(table), torch.from_numpy(ids),
        torch.from_numpy(w) if weighted else None)
    assert torch.equal(out, acc)


def test_ops_take_plain_version_on_cpu():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([[0, 3, -1], [2, 2, 1]], dtype=torch.int32)
    w = torch.tensor([[1.0, -2.0, 3.0], [0.5, 0.25, 1.0]])
    before = eb_pkg.LAUNCHES.value
    for mode in ("sum", "mean"):
        for weights in (None, w):
            assert torch.equal(
                eb_ops.embedding_bag(table, ids, weights, mode=mode),
                eb_ref.embedding_bag_ref(table, ids, weights, mode=mode))
    assert eb_pkg.LAUNCHES.value == before
    with pytest.raises(ValueError, match="mode"):
        eb_ops.embedding_bag(table, ids, mode="max")


def test_non_cpu_tensors_never_reach_plain_version(monkeypatch):
    """With the plain version rigged to fail, a non-CPU request must raise
    from the kernel wrapper (``meta`` tensors stand in for CUDA ones where
    there is no card) — there is no fallback path to the plain version."""
    def rigged(*_a, **_k):
        raise AssertionError("plain version reached from a non-CPU call")

    monkeypatch.setattr(eb_ref, "embedding_bag_ref", rigged)
    table = torch.zeros((3, 8), device="meta")
    ids = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        eb_ops.embedding_bag(table, ids)
    # a CPU table with non-CPU ids is not an all-CPU call either
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        eb_ops.embedding_bag(torch.zeros((3, 8)), ids)


def test_cuda_wrapper_rejects_cpu_tensors():
    table = torch.zeros((3, 8))
    ids = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        eb_kernel.embedding_bag_cuda(table, ids)
