"""Median over routed batches of how far the router's prediction missed
the batch's ``lane`` time, in % of the prediction. The policy is not
load-aware, so the calibrated curve predicts a synchronous ``run``; the
prediction is the estimate ``CostModelRouter.route`` compared."""

import statistics


def read(ctx):
    prog = ctx["program"]
    lane_s = {s.attrs["batch"]: (s.t1 - s.t0) * 1e-9
              for s in prog.named("lane")}
    err = [100.0 * abs(lane_s[r.attrs["batch"]] - r.attrs["predicted_s"])
           / r.attrs["predicted_s"] for r in prog.named("route")
           if r.attrs.get("predicted_s", 0) > 0
           and r.attrs.get("batch") in lane_s]
    return statistics.median(err) if err else None
