"""Longest garbage collection in the window (the tracer's ``gc``
spans), in ms: a pause of every thread."""


def read(ctx):
    d = ctx["program"].span_ms("gc")
    return max(d) if d else None
