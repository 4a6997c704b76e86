"""The served model's share of the card's fp32 peak over the window, in
%: FLOPs of the seeds completed in the window, counted from shapes alone
(the architecture's ``flops_per_seed``, ``servebench/archs/<arch>.py``;
unpadded seeds), over the window's length times 67 TFLOP/s."""

from servebench.costs import FP32_FLOPS_PER_S


def read(ctx):
    if not ctx["on_card"]:
        return None
    flops = ctx["served_seeds"] * ctx["arch"].flops_per_seed(ctx["cfg"])
    if not flops:
        return None
    return 100.0 * flops / (ctx["window_s"] * FP32_FLOPS_PER_S)
