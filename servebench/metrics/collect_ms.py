"""Median host-clock time of one feature collection call of the tiered
store (``lookup_hops`` or ``lookup_aggregate``): host planning, cold
fetches and the launches, not the device's wait."""

import statistics


def read(ctx):
    d = ctx["span_ms"]("lookup_hops") + ctx["span_ms"]("lookup_aggregate")
    return statistics.median(d) if d else None
