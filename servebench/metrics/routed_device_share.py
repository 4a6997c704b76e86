"""Share of the window's batches the router sent to the device executor
(``ServeMetrics.routed``), in %: the PSGS router's choice."""


def read(ctx):
    routed = ctx["summary"].get("routed", {})
    total = sum(routed.values())
    if not total:
        return None
    return 100.0 * routed.get("device", 0) / total
