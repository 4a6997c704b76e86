"""Share of the lanes' wall time off the CPU, in %: one minus the lane
threads' CPU time over the wall time of the window's ``lane`` spans
(waiting for the interpreter lock, the device, a blocking call)."""


def read(ctx):
    lanes = ctx["program"].named("lane")
    wall = sum(s.t1 - s.t0 for s in lanes)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - sum(s.attrs["cpu_ns"] for s in lanes) / wall)
