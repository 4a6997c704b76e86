"""Share of the id slots the gather kernels were launched over that
held a valid id, in % (the store's ``gather_rows_valid`` over
``gather_rows``): a device batch is padded to ``max_batch`` seeds."""


def read(ctx):
    c = ctx["program"].counts
    rows = c.get("gather_rows", 0)
    return 100.0 * c.get("gather_rows_valid", 0) / rows if rows else None
