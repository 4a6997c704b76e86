"""Median host work of one feature collection call, in ms: its
``resolve`` (address resolution; under ``lookup_aggregate`` the segment
plan) and ``host_fetch`` spans, their union."""

import statistics


def read(ctx):
    d = ctx["program"].per_call_ms(("lookup_hops", "lookup_aggregate"),
                                   ("resolve", "host_fetch"))
    return statistics.median(d) if d else None
