"""Card-only checks of the port's CUDA kernels (marked ``cuda``; they skip
where there is no NVIDIA GPU). This file imports no JAX, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gather_aggregate as ga_pkg
from repro_torch.kernels import tiered_gather as tg_pkg
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
