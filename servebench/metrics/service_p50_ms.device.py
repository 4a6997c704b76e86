"""Median service time of the device executor's batches, submit to done
(lane queueing and processing; ``ServeMetrics.executor_percentiles``)."""


def read(ctx):
    ex = ctx["summary"].get("executors", {}).get("device")
    return None if not ex or not ex.get("batches") else ex["p50_ms"]
