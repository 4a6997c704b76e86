"""The served model's share of the card's fp32 peak over the window, in
%: FLOPs of the seeds completed in the window, counted from shapes alone
(``servebench.costs.sage_flops_per_seed``, unpadded seeds), over the
window's length times 67 TFLOP/s."""

from servebench.costs import FP32_FLOPS_PER_S, sage_flops_per_seed


def read(ctx):
    if not ctx["on_card"]:
        return None
    cfg = ctx["cfg"]
    dims = [cfg["feat_dim"], *cfg["hidden"], cfg["classes"]]
    flops = ctx["served_seeds"] * sage_flops_per_seed(dims, cfg["fanouts"])
    if not flops:
        return None
    return 100.0 * flops / (ctx["window_s"] * FP32_FLOPS_PER_S)
