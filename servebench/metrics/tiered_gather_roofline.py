"""``tiered_gather``'s share of its HBM roofline, in %: the least bytes of
the first recorded launches of the window (distinct rows read once, tier
and slot words, the output written; ``servebench.costs``) over 3.35 TB/s,
divided by the device time of the same launches in the trace."""

from servebench.costs import HBM_BYTES_PER_S


def read(ctx):
    return ctx["roofline"]("tiered_gather", HBM_BYTES_PER_S)
