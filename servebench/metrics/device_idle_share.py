"""Share of the traced window with no kernel, copy or memset on the
device, in %: one minus the union of their intervals over the window."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
