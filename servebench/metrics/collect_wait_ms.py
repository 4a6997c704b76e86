"""Median copy time of one feature collection call, in ms: its
``ids_to_host`` (the unique ids' copy to the host, which waits for the
device) and ``plan_to_device`` (the segment plan's copy) spans."""

import statistics


def read(ctx):
    d = ctx["program"].per_call_ms(("lookup_hops", "lookup_aggregate"),
                                   ("ids_to_host", "plan_to_device"))
    return statistics.median(d) if d else None
