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
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.kernels.gather_aggregate import ops as ga_ops
from repro_torch.kernels.gather_aggregate import ref as ga_ref
from repro_torch.kernels.tiered_gather import ops as tg_ops
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
