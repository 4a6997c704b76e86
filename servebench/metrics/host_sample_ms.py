"""Median host-clock time of one call of the host sampler
(``host_sample_dense``, as the executors module calls it)."""

import statistics


def read(ctx):
    d = ctx["span_ms"]("host_sample")
    return statistics.median(d) if d else None
