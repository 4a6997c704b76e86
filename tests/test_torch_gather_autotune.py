"""The launch-shape autotune of the ``gather_aggregate`` CUDA kernel
(``kernels/gather_aggregate/autotune.py``), held on the CPU: every
candidate plan passes the checks the kernel's C side makes
(``csrc/gather_aggregate.cu``: the vector tiles the row, the lanes are a
power of two of at most 32, at least one block) and the alignment check
the wrapper adds, the default plan is among them, and CPU tensors are
refused. The plans' bits on the card are held in
``tests/test_torch_card.py``."""
import pytest
import torch

from repro_torch.kernels.build import LanePlan
from repro_torch.kernels.gather_aggregate import autotune, kernel

BASE = 0x7F3A_0000_0000   # a CUDA allocation: 256-byte aligned
SMS = 132                 # an H100 SXM's SMs
ELEM = {torch.float32: 4, torch.bfloat16: 2}


def _c_side_accepts(plan: LanePlan, d: int, elem: int) -> bool:
    """``launch``'s refusal test in ``csrc/gather_aggregate.cu``, and the
    vector widths its switch instantiates (2 bytes only for bf16)."""
    row_bytes = d * elem
    widths = (16, 8, 4, 2) if elem == 2 else (16, 8, 4)
    return (plan.vec_bytes >= elem and row_bytes % plan.vec_bytes == 0
            and plan.vec_bytes in widths
            and 1 <= plan.lanes <= 32 and not plan.lanes & (plan.lanes - 1)
            and plan.blocks >= 1)


# (dtype, table offset in bytes): offset 2 is the hot[1:] view in bf16
@pytest.mark.parametrize("dtype, offset", [(torch.float32, 0),
                                           (torch.bfloat16, 0),
                                           (torch.bfloat16, 2)])
@pytest.mark.parametrize("d", [16, 37, 64, 100, 256])
def test_candidates_pass_the_kernel_checks(d, dtype, offset):
    elem = ELEM[dtype]
    addr = BASE + offset
    segments = 2272
    plans = autotune.candidate_plans(d, elem, addr, segments, SMS)
    default = kernel.copy_plan(d, elem, addr, segments, SMS)
    assert plans[0] == default
    assert len(set(plans)) == len(plans)
    for p in plans:
        assert _c_side_accepts(p, d, elem), p
        kernel.check_plan(p, d, elem, addr)      # raises if not
        assert p.vec_bytes == default.vec_bytes
        assert p.row_vectors * p.vec_bytes == d * elem
        assert p.lanes <= default.lanes          # tiles the row
        assert p.rows_per_warp * p.lanes == 32
        assert p.passes == -(-p.row_vectors // p.lanes)
    swept = {(p.lanes, p.blocks) for p in plans[1:]}
    lanes = [n for n in autotune.DEFAULT_LANES if n <= default.lanes]
    assert swept == {(n, SMS * m) for n in lanes
                     for m in autotune.DEFAULT_BLOCK_MULTIPLES} - {
        (default.lanes, default.blocks)}


def test_sweep_widths_follow_the_row():
    """d 16 fp32 is four 16-byte vectors: lanes 1, 2 and 4; d 256 fp32
    takes all six lane counts; blocks run 1, 2, 4 and MIN_BLOCKS SMs."""
    small = autotune.candidate_plans(16, 4, BASE, 100, SMS)
    assert sorted({p.lanes for p in small}) == [1, 2, 4]
    wide = autotune.candidate_plans(256, 4, BASE, 100, SMS)
    assert sorted({p.lanes for p in wide}) == [1, 2, 4, 8, 16, 32]
    assert {p.blocks for p in wide[1:]} == {SMS, 2 * SMS, 4 * SMS,
                                            kernel.MIN_BLOCKS * SMS}


@pytest.mark.parametrize("plan, match", [
    (LanePlan(16, 1, 1, 32, 1, 1), "vec_bytes"),      # misaligned table
    (LanePlan(8, 2, 3, 10, 1, 1), "lanes"),
    (LanePlan(8, 2, 64, 0, 1, 1), "lanes"),
    (LanePlan(8, 2, 2, 16, 1, 0), "blocks"),
])
def test_check_plan_refuses_what_the_kernel_cannot_run(plan, match):
    """A plan the kernel cannot run is refused before it launches: a
    vector that does not divide every row's address by ``check_plan``,
    the rest by the C side (``_c_side_accepts`` mirrors it; the card's
    refusal is held in ``tests/test_torch_card.py``), which ``check_plan``
    leaves it to."""
    addr = BASE + 8 if plan.vec_bytes == 16 else BASE
    if match == "vec_bytes":
        with pytest.raises(ValueError, match=match):
            kernel.check_plan(plan, 4, 4, addr)
    else:
        kernel.check_plan(plan, 4, 4, addr)      # aligned: passes here
        assert not _c_side_accepts(plan, 4, 4)


def test_check_plan_refuses_a_vector_that_does_not_tile_the_row():
    with pytest.raises(ValueError, match="vec_bytes"):
        kernel.check_plan(LanePlan(16, 1, 1, 32, 1, 1), 37, 2, BASE)


def test_cpu_tensors_raise():
    """No plain fallback: the autotune, like the wrapper, needs the card."""
    tier = torch.zeros((4, 3), dtype=torch.int32)
    hot = torch.zeros((5, 16))
    with pytest.raises(ValueError, match="CUDA"):
        autotune.autotune_gather_aggregate(tier, tier, hot, hot, hot)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.gather_aggregate_cuda(tier, tier, hot, hot, hot,
                                     plan=kernel.copy_plan(16, 4, BASE, 4,
                                                           SMS))
