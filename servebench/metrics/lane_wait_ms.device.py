"""Mean wait of the device executor's batches for a lane (``lane_wait``:
from ``submit`` until a lane starts the batch). The mean, since most
batches find a lane free and the median reads about 0."""

import statistics


def read(ctx):
    d = ctx["program"].span_ms("lane_wait", executor="device")
    return statistics.fmean(d) if d else None
