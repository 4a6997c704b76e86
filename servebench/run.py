"""One cell of the port's serving benchmark, once.

    python3 servebench/run.py --workload products-sage3.mixed --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout: draws the cell's inputs from ``--seed``,
builds the port's serving stack (``src/repro_torch``) over them, warms
the cell's shapes (the router's calibration runs every executor at every
request size the mix sends), measures for ``--seconds``, checks a sample
of the answers against the plain reference and prints one JSON line last
on standard output. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics (host-clock spans around calls into
the program and a ``torch.profiler`` trace of the window).

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``servebench/configs/<config>.json``, its mix in
``servebench/traffic/<traffic>.json``, the configuration's ``arch`` in
``servebench/archs/<arch>.py`` (its weights, the port's ``infer_fn``, the
function the ``model`` span wraps, its FLOPs a seed and the ``collect``
modes it takes) and ``servebench/reference/<arch>.py`` (its plain
equations), each kernel in ``servebench/kernels/<kernel>.py`` (built,
recorded and costed in the cells whose configuration's ``collect`` or
``arch`` its ``LAUNCHED_BY`` names), and each per-layer metric's reader in
``servebench/metrics/<metric>.py``. A cell imports only its own
architecture and kernel files: of the others it reads ``COLLECTS`` and
``LAUNCHED_BY`` as literals, so a file whose imports only a later
program has stops no cell. Exits 2, printing no result, when
there is no CUDA device (or fewer than the cell asks for), when the
program is not in the checkout, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ast  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from servebench import check, inputs, loops, stack, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that no run may load, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str, bench_dir: Path) -> dict:
    """The cell ``name`` of ``bench`` with its configuration, mix and the
    metrics it reports."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return {"cell": cell,
            "cfg": load_json(bench_dir / "configs" / f"{cell['config']}.json"),
            "traffic": load_json(bench_dir / "traffic"
                                 / f"{cell['traffic']}.json"),
            "end_to_end": e2e, "per_layer": layer}


def load(bench_dir: Path, folder: str, name: str):
    """The module ``servebench/<folder>/<name>.py`` of ``bench_dir``,
    loaded from its file."""
    path = bench_dir / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"servebench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(bench_dir: Path, metric: str):
    """``read(ctx)`` of ``servebench/metrics/<metric>.py``."""
    return load(bench_dir, "metrics", metric).read


def _stems(bench_dir: Path, folder: str) -> list:
    return sorted(p.stem for p in (bench_dir / folder).glob("*.py"))


def arch_of(cfg: dict, bench_dir: Path):
    """``(archs/<arch>.py, reference/<arch>.py)`` of the configuration's
    ``arch``; stops when it names none of ``archs/``, asks for a
    ``collect`` the architecture does not take, or the program lacks the
    function its ``MODEL_SPAN`` names (a model that a later program
    brings): before any input is drawn."""
    known = _stems(bench_dir, "archs")
    name = cfg.get("arch")
    if name not in known:
        raise SystemExit(f"configuration {cfg.get('name')!r}: arch "
                         f"{name!r} is not one of {known}")
    arch = load(bench_dir, "archs", name)
    if cfg["collect"] not in arch.COLLECTS:
        raise SystemExit(f"configuration {cfg.get('name')!r}: arch {name!r} "
                         f"takes collect {list(arch.COLLECTS)}, not "
                         f"{cfg['collect']!r}")
    module, fn = arch.MODEL_SPAN
    try:
        getattr(importlib.import_module(module), fn)
    except (ImportError, AttributeError) as e:
        raise SystemExit(f"configuration {cfg.get('name')!r}: arch {name!r} "
                         f"serves {module}.{fn}, which the program lacks "
                         f"({e})") from None
    return arch, load(bench_dir, "reference", name)


def literal(path: Path, name: str):
    """The literal that ``path`` assigns to ``name`` at its top level, read
    without importing the file (which may import what the program lacks);
    ``None`` where it assigns none."""
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name):
            try:
                return ast.literal_eval(node.value)
            except ValueError:
                raise SystemExit(f"{path.name}: {name} is not a literal: "
                                 f"{ast.unparse(node.value)}") from None
    return None


def cell_kernels(cfg: dict, bench_dir: Path) -> dict:
    """The ``servebench/kernels/<kernel>.py`` that ``cfg``'s serving path
    launches, by name: those whose ``LAUNCHED_BY`` is ``("collect", c)``
    or ``("arch", a)`` with the configuration's own ``c`` or ``a``. Stops
    on a kernel file whose declaration is missing or names a key or value
    that no file of ``archs/`` knows. Declarations and the architectures'
    ``COLLECTS`` are read as literals (``literal``): only the cell's own
    kernel files are imported, and no architecture's."""
    archs = _stems(bench_dir, "archs")
    known = {"collect": sorted({c for a in archs for c in literal(
                 bench_dir / "archs" / f"{a}.py", "COLLECTS") or ()}),
             "arch": archs}
    chosen = {}
    for name in _stems(bench_dir, "kernels"):
        decl = literal(bench_dir / "kernels" / f"{name}.py", "LAUNCHED_BY")
        if not (isinstance(decl, tuple) and len(decl) == 2
                and decl[1] in known.get(decl[0], ())):
            raise SystemExit(
                f"kernel {name!r}: LAUNCHED_BY is {decl!r}, not "
                + " or ".join(f"({k!r}, one of {v})"
                              for k, v in known.items()))
        if cfg.get(decl[0]) == decl[1]:
            chosen[name] = load(bench_dir, "kernels", name)
    return chosen


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def _span_targets(arch):
    from repro_torch.core.feature_store import TieredFeatureStore
    from repro_torch.serving import executors
    from repro_torch.serving.router import CostModelRouter
    module, fn = arch.MODEL_SPAN
    return [(executors, "host_sample_dense", "host_sample"),
            (executors, "device_sample", "device_sample"),
            (TieredFeatureStore, "lookup_hops", "lookup_hops"),
            (TieredFeatureStore, "lookup_aggregate", "lookup_aggregate"),
            (TieredFeatureStore, "_host_fetch", "host_fetch"),
            (CostModelRouter, "route", "route"),
            (importlib.import_module(module), fn, "model")]


def log(msg: str) -> None:
    print(f"[servebench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Prepared:
    """A cell's inputs and the program's stack built over them, with the
    configuration's architecture (``archs/<arch>.py``), its reference
    (``reference/<arch>.py``) and the kernels its path launches
    (``cell_kernels``)."""

    cfg: dict
    arch: object
    ref: object
    kernels: dict
    graph: inputs.Graph
    feats: np.ndarray
    weights: dict
    law: inputs.SeedLaw
    capture: stack.Capture
    engine: object


def prepare(cfg: dict, traffic: dict, seed: int, device: torch.device,
            bench_dir: Path = BENCH_DIR) -> Prepared:
    """Draw the inputs from ``seed`` and build the stack over them (the
    router's calibration warms every request size the mix sends)."""
    from repro_torch.kernels.build import build

    arch, ref = arch_of(cfg, bench_dir)
    kerns = cell_kernels(cfg, bench_dir)
    t = time.perf_counter()

    def phase(name: str) -> None:
        nonlocal t
        now = time.perf_counter()
        log(f"{name} {now - t:.3f} s")
        t = now

    if device.type == "cuda":
        build(tuple(k.BUILD for k in kerns.values()))
        phase(f"kernels {sorted(kerns)}")
    graph = inputs.power_law_graph(cfg["nodes"], cfg["num_edges"],
                                   cfg["exponent"], seed, device)
    phase(f"graph ({graph.num_edges} edges)")
    feats = inputs.features(cfg["nodes"], cfg["feat_dim"], seed, device)
    weights = arch.weights(cfg, seed, device)
    law = inputs.SeedLaw(graph.out_degree, traffic["seed_law"])
    phase("features and weights")
    capture = stack.Capture(inputs.sub_seed(seed, 99))
    engine = stack.build(cfg, arch, graph, feats, weights,
                         inputs.calibration_batches(traffic, law, seed),
                         capture, device, phase=phase)
    # the window starts on the allocator's pool as calibration and the
    # lanes' warm-up left it: no empty_cache here
    gc.collect()
    return Prepared(cfg, arch, ref, kerns, graph, feats, weights, law,
                    capture, engine)


def drive(prep: Prepared, traffic: dict, seconds: float,
          seed: int) -> loops.LoopResult:
    """The mix's loop over the prepared stack for ``seconds``."""
    from repro_torch.core import Request

    n_check = int(traffic["check_requests"])
    if traffic["loop"] == "open":
        schedule = inputs.open_schedule(traffic, prep.law, seconds, seed,
                                        n_check)
        return loops.open_loop(prep.engine, schedule, seconds,
                               prep.capture, Request)
    reqs = inputs.ClosedRequests(traffic, prep.law, seed, n_check,
                                 int(traffic["check_horizon"]))
    return loops.closed_loop(prep.engine, reqs, int(traffic["clients"]),
                             seconds, prep.capture, Request)


def answers(prep: Prepared, res: loops.LoopResult, device: torch.device,
            *, control: bool = False) -> dict:
    """Take what the timed path produced for the sampled requests, free
    the program's stack, then hold it against the reference."""
    items = []
    for s in res.sent:
        if not s.checked or s.future is None or not s.future.done() \
                or s.future.exception() is not None:
            continue
        result = s.future.result()
        records = prep.capture.take(result)
        items.append((s.request.seeds, result.detach().cpu(), records))
    prep.engine.close()
    prep.engine = prep.capture = None
    res.sent.clear()
    _free(device)
    return check.compare(prep.ref, prep.cfg, prep.graph, prep.feats,
                         prep.weights, items, device, control=control)


def roofline(red, kernels: dict, launch_bytes: dict, kernel: str,
             hbm: float):
    """``kernel``'s share of its HBM roofline, in %: the least bytes of its
    first recorded launches over ``hbm`` bytes/s, over the device time of
    as many of its launches in the reduced trace ``red``. ``None`` without
    a trace, for a kernel the cell did not record, or where the trace
    holds none of its launches."""
    if red is None or kernel not in launch_bytes:
        return None
    evs = sorted((ts, dur) for n, ts, dur in red["kernels"]
                 if kernels[kernel].TRACE_NAME in n)
    k = min(len(evs), len(launch_bytes[kernel]))
    dev_s = sum(d for _, d in evs[:k]) * 1e-6
    if k == 0 or dev_s <= 0:
        return None
    return 100.0 * sum(launch_bytes[kernel][:k]) / hbm / dev_s


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             traced: bool, *, device: torch.device,
             bench_dir: Path = BENCH_DIR,
             t_start: float = T_START) -> tuple[dict, list]:
    """Run one cell once; returns ``(result line, [(check, value,
    limit)])``. ``device`` cpu runs the same path on the CPU (no device
    trace, no device metrics)."""
    spec = cell_spec(bench, name, bench_dir)
    cfg, traffic = spec["cfg"], spec["traffic"]
    prep = prepare(cfg, traffic, seed, device, bench_dir)
    arch, kerns = prep.arch, prep.kernels

    spans = launches = dtrace = None
    if traced:
        spans = trace.Spans(_span_targets(arch)).__enter__()
        launches = {k: trace.Launches(importlib.import_module(m.MODULE),
                                      m.WRAPPER).__enter__()
                    for k, m in kerns.items()}
        if device.type == "cuda":
            dtrace = trace.DeviceTrace()
            dtrace.start()
    clock_gap = time.perf_counter() - time.monotonic()
    setup_s = time.perf_counter() - t_start
    try:
        res = drive(prep, traffic, seconds, seed)
    finally:
        events = dtrace.stop() if dtrace is not None else None
        if traced:
            spans.__exit__(None, None, None)
            for rec in launches.values():
                rec.__exit__(None, None, None)
    summary = res.metrics.summary()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    window_s = res.t_end - res.t0
    served = loops.seeds_completed(res)
    lat = loops.latencies_ms(res)
    # a failed request counts as missing every limit
    finite = np.where(np.isfinite(lat), lat, 1e9)
    e2e_values = {"setup_s": setup_s}
    if traffic["loop"] == "open":
        e2e_values["p50_ms"] = float(np.quantile(finite, 0.5))
    else:
        e2e_values["seeds_per_s"] = served / window_s

    line_metrics: dict = {}
    breakdown = None
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        t0p, t1p = res.t0 + clock_gap, res.t_end + clock_gap
        red = None
        if events is not None:
            red = trace.reduce_trace(events, dtrace.mark_host, t0p, t1p,
                                     spans)
            dev_info["busy_s"] = red["busy_s"]
            dev_info["window_s"] = red["window_s"]
            breakdown = {"device_ops": red["device_ops"],
                         "idle_gaps": red["idle_gaps"]}
        bytes_of = {k: [kerns[k].least_bytes(*a) for a in rec.args]
                    for k, rec in launches.items()}
        del launches

        ctx = {"summary": summary, "cfg": cfg, "trace": red,
               "span_ms": lambda n: spans.durations_ms(n, t0p, t1p),
               "roofline": functools.partial(roofline, red, kerns, bytes_of),
               "served_seeds": served,
               "window_s": window_s, "latencies_ms": lat,
               "on_card": device.type == "cuda", "arch": arch}
        for m in spec["per_layer"]:
            value = reader(bench_dir, m["name"])(ctx)
            if value is not None:
                line_metrics[m["name"]] = {"value": float(value),
                                           "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            line_metrics[m["name"]] = {"value": float(e2e_values[m["name"]]),
                                       "unit": m["unit"]}

    lateness = loops.lateness_ms(res)
    readings = answers(prep, res, device)
    rows = check.judge(readings, res.failed, cfg["limits"])
    line = {"correct": check.passed(rows), "attempted": len(lat),
            "failed": int(res.failed), "metrics": line_metrics,
            "device": dev_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if traffic["loop"] == "open":
        line["latency_ms"] = {"mean": float(finite.mean()),
                              **{f"p{q}": float(np.quantile(finite, q / 100))
                                 for q in (50, 75, 90, 95, 99)}}
        line["generator_late_ms"] = {
            "p50": float(np.quantile(lateness, 0.5)),
            "p99": float(np.quantile(lateness, 0.99)),
            "max": float(lateness.max())}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return line, rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="servebench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench_json = ROOT / "BENCHMARK.json"
    program = ROOT / "src" / "repro_torch"
    if not bench_json.is_file() or not program.is_dir():
        print(f"servebench: the program is not in this checkout "
              f"({program} missing)", file=sys.stderr)
        return 2
    bench = load_json(bench_json)
    chips = next((int(c["chips"]) for c in bench["workloads"]
                  if c["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"servebench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    line, rows = run_cell(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), device=torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"servebench: the run loaded {bad}", file=sys.stderr)
        return 2
    if "generator_late_ms" in line:
        print("generator late (ms): " + json.dumps(line["generator_late_ms"]))
    for n, v, lim in rows:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
