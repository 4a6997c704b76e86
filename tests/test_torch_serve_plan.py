"""The lane plans of the two serve kernels (``tiered_gather`` and
``gather_aggregate``), held on the CPU: the vector width each row and
every table's and the output's address allow, the lanes a row, the rows a
warp, the passes over a row and the grid. The kernels themselves run only
on the card (``tests/test_torch_card.py``)."""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.gather_aggregate import kernel as ga_kernel
from repro_torch.kernels.tiered_gather import kernel as tg_kernel

CSRC = Path(build.__file__).resolve().parents[1] / "csrc"
BASE = 0x7F3A_0000_0000  # a CUDA allocation: 256-byte aligned
H100_SMS = 132
KERNELS = {"tiered_gather": tg_kernel, "gather_aggregate": ga_kernel}
# base offsets in bytes a tensor of each dtype can start at (a float32
# tensor always starts on 4 bytes)
CASES = [(d, elem, off) for d in (1, 16, 37, 64, 128, 256)
         for elem, offs in ((4, (0, 4, 8)), (2, (0, 2, 4, 8)))
         for off in offs]


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("d, elem, offset", CASES)
def test_width_lanes_and_rows_a_warp(kernel, d, elem, offset):
    """The widest vector (16, 8, 4 bytes, else one element) that every row
    starts on and divides into; the fewest lanes (a power of two, at most
    32) that cover a row in one vector each; a warp's lanes split into
    whole rows; passes cover the row and no more."""
    addr = BASE + offset
    plan = KERNELS[kernel].copy_plan(d, elem, addr, 1000, H100_SMS)
    row = d * elem
    assert plan.vec_bytes in (16, 8, 4, elem)
    assert row % plan.vec_bytes == 0 and addr % plan.vec_bytes == 0
    assert all(row % w or addr % w for w in (16, 8, 4) if w > plan.vec_bytes)
    assert plan.row_vectors * plan.vec_bytes == row
    lanes = plan.lanes
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
    assert lanes >= min(plan.row_vectors, 32)
    assert lanes == 1 or lanes // 2 < plan.row_vectors
    assert plan.rows_per_warp * lanes == 32
    assert (plan.passes - 1) * lanes < plan.row_vectors <= plan.passes * lanes


@pytest.mark.parametrize("d, elem, offset, vec, lanes, passes", [
    (128, 4, 0, 16, 32, 1),    # the serve path: 512-byte fp32 rows
    (16, 4, 0, 16, 4, 1),      # 64-byte rows: 8 rows a warp
    (256, 4, 0, 16, 32, 2),    # two passes
    (64, 2, 0, 16, 8, 1),      # bf16 d 64: 128-byte rows
    (128, 2, 256, 16, 16, 1),  # hot[1:] in bf16 d 128: still 16 bytes
    (36, 2, 72, 8, 16, 1),     # hot[1:] in bf16 d 36: 8 bytes
    (37, 2, 0, 2, 32, 2),      # bf16 d 37: 74-byte rows, one element each
    (37, 2, 74, 2, 32, 2),
    (1, 4, 0, 4, 1, 1),        # one fp32 column: 32 rows a warp
])
def test_plan_on_the_paths_shapes(d, elem, offset, vec, lanes, passes):
    for mod in KERNELS.values():
        plan = mod.copy_plan(d, elem, BASE + offset, 1000, H100_SMS)
        assert (plan.vec_bytes, plan.lanes, plan.passes) == (vec, lanes,
                                                             passes)


def test_an_unaligned_output_or_table_narrows_the_vector():
    """The address is every table's and the output's OR-ed together: one
    table 8 bytes in is enough to take 8-byte vectors for all."""
    aligned = ga_kernel.copy_plan(128, 4, BASE, 100, H100_SMS)
    one_off = ga_kernel.copy_plan(128, 4, BASE | (BASE + 8) | BASE, 100,
                                  H100_SMS)
    assert (aligned.vec_bytes, one_off.vec_bytes) == (16, 8)
    assert one_off.lanes == 32 and one_off.passes == 2


@pytest.mark.parametrize("kernel, rows", [("tiered_gather", 1952),
                                          ("gather_aggregate", 2272)])
def test_serve_inputs_are_all_in_flight_at_once(kernel, rows):
    """At the serve path's sizes (M 1,952 rows; S 2,272 segments; d 128
    fp32) every row or segment has its own warp and every block of the
    grid is resident at once on an H100's 132 SMs: no warp walks twice."""
    mod = KERNELS[kernel]
    plan = mod.copy_plan(128, 4, BASE, rows, H100_SMS)
    assert plan.rows_per_warp == 1
    assert plan.blocks == -(-rows // mod.WARPS)
    assert plan.blocks <= H100_SMS * mod.MIN_BLOCKS


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("rows", [200_000, 10**7])
def test_large_inputs_go_grid_stride(kernel, rows):
    """Past what the card holds at once the grid stays at its resident
    size and warps walk the rest."""
    mod = KERNELS[kernel]
    plan = mod.copy_plan(128, 4, BASE, rows, H100_SMS)
    assert plan.blocks == H100_SMS * mod.MIN_BLOCKS
    assert plan.blocks * mod.WARPS * plan.rows_per_warp < rows


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_small_inputs_take_one_block(kernel):
    plan = KERNELS[kernel].copy_plan(16, 4, BASE, 1, H100_SMS)
    assert plan.blocks == 1 and plan.rows_per_warp == 8


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plan_constants_match_the_kernel_source(kernel):
    """The plan sizes the grid as the kernel launches it: the block's warps
    and the blocks ``__launch_bounds__`` keeps on an SM are the same
    numbers on both sides."""
    mod = KERNELS[kernel]
    text = (CSRC / f"{kernel}.cu").read_text()
    names = {"kThreads": 32 * mod.WARPS, "kWarps": mod.WARPS,
             "kMinBlocks": mod.MIN_BLOCKS}
    for name, value in names.items():
        m = re.search(rf"constexpr int {name} = ([^;]+);", text)
        assert m, name
        expr = m.group(1)
        for other, v in names.items():
            expr = re.sub(rf"\b{other}\b", str(v), expr)
        assert eval(expr, {}) == value, (name, expr)
    assert "__launch_bounds__(kThreads, kMinBlocks)" in text
    assert mod.DESIGN
