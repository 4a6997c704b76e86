"""How steady Fig. 13's check is (``skew_robustness``): the module run
``--trials`` times with each executor timed on its own (the median of 3,
host then device, as the reference times them) and with the two timed
in alternation (``skew_robustness.interleaved_times``), in turns, first
on a quiet host and then beside ``--busy`` processes that spin on the
host's cores.

    PYTHONPATH=src python -m repro_torch.bench.skew_timing \
        [--trials 6] [--busy 6] [--device cuda|cpu] [--nodes 5000]

Prints one JSON line a trial: the timing, the load, whether the check
held, and the worst ratio of a routed time to its limit
(``1.5 · best + 1 ms``) over the six (workload, batch) pairs; a ratio
over 1 fails the check.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from repro_torch.bench import common
from repro_torch.bench import skew_robustness as skew

SPIN = "import time\nt = time.time()\nwhile time.time() - t < {s}: pass"


def separate_times(host, device_fn, *, rounds: int = skew.ROUNDS,
                   device="cuda") -> tuple:
    """Each executor's median of 3 on its own, host first (``rounds`` is
    unused: the signature is ``interleaved_times``')."""
    return (common.timeit(host, repeats=3, device=device),
            common.timeit(device_fn, repeats=3, device=device))


def worst_ratio(rows: dict) -> float:
    """The largest routed time over its limit among ``skew/*`` rows."""
    worst = 0.0
    for name, us in rows.items():
        if name.endswith("_psgs_us"):
            pair = name[:-len("_psgs_us")]
            best = min(rows[pair + "_host_us"], rows[pair + "_device_us"])
            worst = max(worst, us / (1.5 * best + 1000.0))
    return worst


def trial(timing: str, load: str, *, device: str, nodes: int) -> dict:
    """One run of ``skew_robustness`` under ``timing``; its rows are kept
    off stdout."""
    saved = skew.interleaved_times, skew.emit
    skew.interleaved_times = TIMINGS[timing]
    rows = {}
    skew.emit = lambda name, us, derived="": rows.__setitem__(name, us)
    t0 = time.perf_counter()
    try:
        skew.run(device=device, nodes=nodes)
        held = True
    except AssertionError:
        held = False
    finally:
        skew.interleaved_times, skew.emit = saved
    return {"timing": timing, "load": load, "held": held,
            "worst_over_limit": worst_ratio(rows),
            "seconds": time.perf_counter() - t0}


TIMINGS = {"separate": separate_times,
           "interleaved": skew.interleaved_times}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--busy", type=int, default=6,
                    help="spinning processes in the loaded half (0: none)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=5000)
    args = ap.parse_args(argv)
    kw = dict(device=args.device, nodes=args.nodes)
    trial("interleaved", "warm-up", **kw)
    loads = [("quiet", 0)] + ([(f"busy{args.busy}", args.busy)]
                              if args.busy else [])
    for load, n in loads:
        spin = [subprocess.Popen([sys.executable, "-c", SPIN.format(s=600)])
                for _ in range(n)]
        try:
            for _ in range(args.trials):
                for timing in TIMINGS:
                    print(json.dumps(trial(timing, load, **kw)), flush=True)
        finally:
            for p in spin:
                p.kill()
                p.wait()


if __name__ == "__main__":
    main()
