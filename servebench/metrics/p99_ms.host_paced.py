"""99th percentile of every request's latency from its due time, in ms,
a failed request counting as missing every limit. Held as a per-layer
reading: the device is idle most of the window, so the tail is paced by
the host (lanes, the interpreter lock, the cold fetches) and swings too
widely from run to run for an end-to-end bound."""

import numpy as np


def read(ctx):
    lat = ctx["latencies_ms"]
    if lat.size == 0:
        return None
    return float(np.quantile(np.where(np.isfinite(lat), lat, 1e9), 0.99))
