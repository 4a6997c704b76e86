"""Share of the window's device idle time with a batch in flight (inside
a ``lane_wait`` or ``lane`` span), in %: the device trace's idle gaps
named by the program's spans at their midpoints."""


def read(ctx):
    gaps = ctx["program"].gaps
    idle = sum(gaps.values()) if gaps else 0.0
    if idle <= 0:
        return None
    return 100.0 * (1.0 - gaps.get("no_batch_in_flight", 0.0) / idle)
