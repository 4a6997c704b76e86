"""Launch-shape autotune of the fused gather→aggregate CUDA kernel.

Replaces ``src/repro/kernels/gather_aggregate/autotune.py``, which sweeps
the Pallas kernel's ``block_rows`` × ``block_dim`` tiles. The CUDA kernel
has no tiles: its launch shape is the vector width of each load
(``vec_bytes``, fixed by the row's bytes and the tables' alignment), the
lanes a segment takes (``lanes``) and the grid (``blocks``). This sweeps
the last two over the caller's real inputs on the card and picks the
fastest, beside :func:`~.kernel.copy_plan`'s default. Every plan computes
the same bits (the fold is ordered over the fan axis whatever the
plan), and each candidate's output is held to the default plan's before
it is timed.

The result is a report: nothing applies the best plan. The serve path
keeps ``copy_plan``.
"""
from __future__ import annotations

import statistics

import torch

from repro_torch.kernels.build import LanePlan, int_bits, sm_count
from repro_torch.kernels.gather_aggregate import kernel

DEFAULT_LANES = (1, 2, 4, 8, 16, 32)
# blocks as multiples of the card's SMs; MIN_BLOCKS is what the kernel's
# __launch_bounds__ keeps resident on each
DEFAULT_BLOCK_MULTIPLES = (1, 2, 4, kernel.MIN_BLOCKS)
INNER = 20   # launches a timed CUDA graph replays


def plan_key(plan: LanePlan) -> str:
    """``"<vec_bytes>x<lanes>x<blocks>"``, the key of ``timings_us``."""
    return f"{plan.vec_bytes}x{plan.lanes}x{plan.blocks}"


def plan_dict(plan: LanePlan) -> dict:
    return {"vec_bytes": plan.vec_bytes, "lanes": plan.lanes,
            "blocks": plan.blocks}


def candidate_plans(d: int, elem: int, addr: int, segments: int,
                    sms: int) -> list[LanePlan]:
    """The launch shapes to sweep for ``segments`` sums of ``d`` values of
    ``elem`` bytes on a card of ``sms`` SMs; ``addr`` is the tables' and
    the output's addresses OR-ed. The default plan comes first; then each
    lane count of ``DEFAULT_LANES`` that tiles the row (at most the
    default's, the fewest lanes that cover the row in one vector each, so
    no lane of a group is idle) at ``sms × m`` blocks for each ``m`` of
    ``DEFAULT_BLOCK_MULTIPLES``, all at the default's vector width."""
    default = kernel.copy_plan(d, elem, addr, segments, sms)
    vec, nvec = default.vec_bytes, default.row_vectors
    plans = [default]
    for n in DEFAULT_LANES:
        if n > default.lanes:
            continue
        for m in DEFAULT_BLOCK_MULTIPLES:
            p = LanePlan(vec, nvec, n, 32 // n, -(-nvec // n), sms * m)
            if p not in plans:
                plans.append(p)
    return plans


def _graph_us(fn, *, repeats: int) -> float:
    """Median µs of one ``fn()`` on the card: ``INNER`` calls captured in a
    CUDA graph (device time only, no host issue), replayed once to warm
    up, then ``repeats`` replays between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(INNER):
            fn()
    graph.replay()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) * 1e3 / INNER)
    return statistics.median(samples)


def autotune_gather_aggregate(tier: torch.Tensor, slot: torch.Tensor,
                              hot: torch.Tensor, warm: torch.Tensor,
                              cold: torch.Tensor, *,
                              repeats: int = 5) -> dict:
    """Time every candidate launch shape of the kernel on these inputs.

    Each candidate's output must equal the default plan's bit for bit
    (compared as integers) before it is timed; its time is the median of
    ``repeats`` CUDA-event samples of ``INNER`` launches replayed from a
    CUDA graph, after one warm-up replay.

    Returns:
        ``{"best": {"vec_bytes", "lanes", "blocks"}, "default": {...},
        "timings_us": {"VxLxB": median µs, ...}, "launches": int}`` —
        ``launches`` the wrapper calls this made (its launch counter's
        increase; graph replays launch without the wrapper).

    Raises:
        ValueError: the tensors are not on a CUDA device (as
            :func:`~.kernel.gather_aggregate_cuda`: there is no plain
            fallback to tune).
        AssertionError: a candidate's bits differ from the default's.
    """
    dev = hot.device
    if dev.type != "cuda":
        raise ValueError("autotune_gather_aggregate needs CUDA tensors, got "
                         f"{dev}")
    addr = hot.data_ptr() | warm.data_ptr() | cold.data_ptr()
    before = kernel.LAUNCHES.value
    want = kernel.gather_aggregate_cuda(tier, slot, hot, warm, cold)
    # the output's address joins the alignment: a fresh (S, d) allocation
    # of the caching allocator, as every timed call's is
    addr |= want.data_ptr()
    plans = candidate_plans(int(hot.shape[1]), hot.element_size(), addr,
                            int(tier.shape[0]), sm_count(dev))
    timings: dict[str, float] = {}
    for plan in plans:
        got = kernel.gather_aggregate_cuda(tier, slot, hot, warm, cold,
                                           plan=plan)
        if not torch.equal(int_bits(got), int_bits(want)):
            raise AssertionError(f"gather_aggregate plan {plan_key(plan)} "
                                 "differs from the default plan's bits")
        timings[plan_key(plan)] = _graph_us(
            lambda p=plan: kernel.gather_aggregate_cuda(tier, slot, hot,
                                                        warm, cold, plan=p),
            repeats=repeats)
    best = min(plans, key=lambda p: timings[plan_key(p)])
    return {"best": plan_dict(best), "default": plan_dict(plans[0]),
            "timings_us": timings,
            "launches": kernel.LAUNCHES.value - before}
