"""The copy plans of the two gather-sum kernels (``segment_spmm`` and
``embedding_bag``), held on the CPU: the ``cp.async`` width each row and
table address allows, the shared memory a block takes, the blocks an SM
fits and the ring's depth. The kernels themselves run only on the card
(``tests/test_torch_card.py``)."""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.embedding_bag import kernel as eb_kernel
from repro_torch.kernels.segment_spmm import kernel as sp_kernel

CSRC = Path(build.__file__).resolve().parents[1] / "csrc"
BASE = 0x7F3A_0000_0000  # a CUDA allocation: 256-byte aligned
ELEM = {"float32": 4, "bfloat16": 2}


def _plans(d, elem, base, bag=100):
    return {"segment_spmm": sp_kernel.copy_plan(d, elem, base),
            "embedding_bag": eb_kernel.copy_plan(d, elem, base, bag)}


@pytest.mark.parametrize("kernel", ["segment_spmm", "embedding_bag"])
@pytest.mark.parametrize("offset", [0, 2, 4, 8])
@pytest.mark.parametrize("d", [1, 3, 36, 37, 64, 100, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_is_the_widest_copy_every_row_and_tile_allows(kernel, offset,
                                                            d, dtype):
    """Every row and every 128-column tile of it starts on a chunk and is a
    whole number of chunks; no wider copy would be; 0 (register staging)
    exactly when neither bytes nor address is a multiple of 4."""
    elem = ELEM[dtype]
    base = BASE + offset
    chunk = _plans(d, elem, base)[kernel].chunk_bytes
    row = d * elem
    if chunk == 0:
        assert row % 4 or base % 4
        return
    assert chunk in (16, 8, 4)
    for r in (0, 1, 2, 7, 1000):
        for c0 in range(0, d, 128):
            tile = min(d - c0, 128) * elem
            assert (base + r * row + c0 * elem) % chunk == 0
            assert tile % chunk == 0
    wider = [w for w in (16, 8) if w > chunk]
    assert all(row % w or base % w for w in wider)


@pytest.mark.parametrize("d, elem, offset, want", [
    (64, 4, 0, 16),     # ogb_products layer 2, fp32: 256-byte rows
    (100, 4, 0, 16),    # layer 1, fp32: 400-byte rows
    (100, 2, 0, 8),     # bf16 d 100: 200-byte rows
    (100, 2, 200, 8),   # feat[1:] in bf16: starts 200 bytes in
    (36, 4, 0, 16),     # DIN history rows, fp32: 144 bytes
    (36, 2, 0, 8),      # DIN in bf16: 72 bytes
    (36, 2, 72, 8),     # table[1:] in bf16
    (37, 2, 0, 0),      # bf16 odd width: 74-byte rows, staged
    (37, 2, 74, 0),
])
def test_chunk_on_the_paths_shapes(d, elem, offset, want):
    for plan in _plans(d, elem, BASE + offset).values():
        assert plan.chunk_bytes == want


@pytest.mark.parametrize("d, elem, offset, want", [
    (64, 4, 0, True),      # ogb_products d 64: 256-byte rows, two lines
    (64, 4, 256, True),    # feat[1:] of it: still whole lines
    (64, 2, 0, True),      # bf16 d 64: one line a row
    (32, 4, 0, True),
    (100, 4, 0, False),    # 400-byte rows end mid-line: bulk copies
    (36, 4, 0, False),
    (64, 4, 16, False),    # a view that starts mid-line
    (100, 2, 0, False),    # 8-byte copies
])
def test_segment_spmm_fetches_whole_lines_only_where_rows_are_lines(
        d, elem, offset, want):
    chunk = sp_kernel.copy_plan(d, elem, BASE + offset).chunk_bytes
    assert sp_kernel.whole_lines(d * elem, BASE + offset, chunk) is want


# the shapes chip_smoke.py hands the kernels (main path and its edge cases)
SMOKE_SPMM = [(100, 4, 0), (64, 4, 0), (100, 2, 0), (64, 2, 0),
              (100, 2, 200), (37, 2, 0), (37, 4, 0)]
SMOKE_BAG = [(36, 4, 0, 100), (36, 2, 0, 100), (36, 4, 0, 500),
             (36, 2, 72, 100), (37, 2, 0, 100), (37, 4, 0, 500)]


@pytest.mark.parametrize("d, elem, offset", SMOKE_SPMM)
def test_segment_spmm_plan_fits_two_blocks_an_sm(d, elem, offset):
    plan = sp_kernel.copy_plan(d, elem, BASE + offset)
    assert plan.smem_bytes <= build.SMEM_PER_BLOCK
    assert plan.blocks_per_sm >= 2
    assert 2 * (plan.smem_bytes + build.SMEM_RESERVED) <= build.SMEM_PER_SM
    assert plan.rows_per_block == sp_kernel.WARPS
    # each warp's ring holds a whole window of 32 ids, and its slots,
    # weights, ids, window records and ids copied ahead fit its share
    assert plan.ring_rows >= 32
    slot = -(-min(d, 128) * elem // 16) * 16
    assert (8 * sp_kernel.GROUPS + plan.ring_rows * (slot + 8)
            + 4 * sp_kernel.GROUPS + 4 * 32 * sp_kernel.WINDOWS
            <= plan.smem_bytes // sp_kernel.WARPS)
    assert plan.smem_bytes % (16 * sp_kernel.WARPS) == 0
    # rows in flight an SM, the rings full: over Little's law's ~25 KB
    in_flight = plan.blocks_per_sm * plan.rows_per_block * plan.ring_rows \
        * min(d, 128) * elem
    assert in_flight >= 25 * 1024 or d * elem < 128


@pytest.mark.parametrize("d, elem, offset, bag", SMOKE_BAG)
def test_embedding_bag_plan_fits_two_blocks_an_sm(d, elem, offset, bag):
    plan = eb_kernel.copy_plan(d, elem, BASE + offset, bag)
    assert plan.smem_bytes <= build.SMEM_PER_BLOCK
    assert plan.blocks_per_sm >= 2
    assert plan.rows_per_block == 1
    assert plan.ring_rows % eb_kernel.THREADS == 0
    slot = -(-min(d, 128) * elem // 16) * 16
    assert plan.ring_rows * (slot + 8) + 16 <= plan.smem_bytes
    if bag <= 128:
        assert plan.ring_rows >= bag  # DIN's bag of 100: one pass


def test_embedding_bag_plan_takes_dins_bag_in_one_pass():
    """serve_p99's 512 bags of 100 fp32 rows of 144 bytes: every bag's rows
    fit one ring, and all 512 blocks are resident at once on 132 SMs."""
    plan = eb_kernel.copy_plan(36, 4, BASE, 100)
    assert plan.ring_rows >= 100
    assert plan.blocks_per_sm * 132 >= 512


@pytest.mark.parametrize("d", [1, 2, 3, 17, 36, 64, 100, 127, 128, 129, 255,
                               300, 512, 1000, 2048, 4095, 4096])
@pytest.mark.parametrize("elem", [4, 2])
def test_ring_depth_for_wide_rows(d, elem):
    """Rows wider than a tile take more tiles, not a shallower ring: up to
    d 4,096 each plan still holds a whole window and fits the card."""
    sp = sp_kernel.copy_plan(d, elem, BASE)
    eb = eb_kernel.copy_plan(d, elem, BASE, 300)
    assert sp.ring_rows >= 32
    assert eb.ring_rows >= eb_kernel.THREADS
    for plan in (sp, eb):
        assert 1 <= plan.ring_rows
        assert plan.smem_bytes <= build.SMEM_PER_BLOCK
        assert plan.blocks_per_sm >= 2


@pytest.mark.parametrize("source, names", [
    ("segment_spmm.cu", {"kWarps": sp_kernel.WARPS,
                         "kWindows": sp_kernel.WINDOWS,
                         "kGroups": sp_kernel.GROUPS,
                         "kMaxSmem": build.SMEM_PER_BLOCK}),
    ("embedding_bag.cu", {"kThreads": eb_kernel.THREADS,
                          "kTileCols": eb_kernel.TILE_COLS,
                          "kMaxSmem": build.SMEM_PER_BLOCK}),
])
def test_plan_constants_match_the_kernel_source(source, names):
    """The plan lays out shared memory as the kernel reads it: the
    constants both sides use are the same numbers."""
    text = (CSRC / source).read_text()
    for name, value in names.items():
        m = re.search(rf"constexpr int {name} = ([^;]+);", text)
        assert m, name
        expr = m.group(1)
        for other, v in names.items():
            expr = re.sub(rf"\b{other}\b", str(v), expr)
        assert eval(expr, {}) == value, (name, expr)
