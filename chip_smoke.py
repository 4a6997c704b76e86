#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the result line):

1. device  — a CUDA device must be present; prints ``nvidia-smi``'s card
             name and power limit.
2. build   — compiles every CUDA kernel from ``src/repro_torch/csrc`` with
             ``nvcc`` (one process per source, all at once), timed.
3. kernels — at the serve path's own inputs (captured from one request of
             the default launcher stack, fp32 and bf16) and on clamped,
             all-invalid and empty-grid cases, each kernel must be bitwise
             equal to its plain PyTorch version. Times the kernel, the
             plain version and one PyTorch library call computing the same
             function (``index_select`` / ``F.embedding_bag`` on a
             pre-concatenated table; the port never calls them) with CUDA
             events, as medians; computes each kernel's HBM/compute bound
             from the inputs.
4. serve   — runs the port's launcher (``repro_torch.launch.serve``) at its
             defaults on ``cuda`` twice, fused and ``--fuse-aggregate``,
             with the launch counters set to 0 just before each run and
             read just after: each path's kernel must have launched. Then
             the same host-sampled hops must give bitwise-equal outputs on
             the two paths, and the card's ``HostExecutor`` outputs must be
             finite, of the served shape, and within 1e-4 of the port on
             the CPU for the same seed.
5. summary — one ``{"kernels": [...]}`` line, then the result line
             ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SERVE_REQUESTS = 200
CPU_TOL = 1e-4            # card vs CPU model outputs (fp32, other sum order)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, *, inner: int = 20, reps: int = 25,
            graph: bool = True) -> float:
    """Median milliseconds per call of ``fn`` on the card: CUDA events
    around ``inner`` back-to-back calls, after a warm-up. With ``graph``
    the calls are captured once in a CUDA graph and replayed, so the time
    is the device's alone; without it, eager calls, so the host's cost of
    issuing each call counts too."""
    import torch
    fn()
    torch.cuda.synchronize()
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(inner):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(inner):
                fn()
    run()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


# ---------------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------------
def capture_serve_inputs(stack, fanouts, seeds):
    """The exact arguments the store hands each kernel for one request of
    the default stack (one fused and one fuse-aggregate request)."""
    from repro_torch.core import feature_store as fs
    from repro_torch.serving import HostExecutor
    graph, _, _, _, store, _, infer = stack
    captured = {}
    originals = {"tiered_gather": fs.tiered_gather,
                 "gather_aggregate": fs.gather_aggregate}

    def recorder(name):
        def wrapped(*args):
            captured[name] = args
            return originals[name](*args)
        return wrapped

    try:
        for name in originals:
            setattr(fs, name, recorder(name))
        for fuse_aggregate in (False, True):
            ex = HostExecutor(graph, store, fanouts, infer, rng_seed=1,
                              fuse_aggregate=fuse_aggregate)
            ex.run(seeds)
            ex.close()
    finally:
        for name, fn in originals.items():
            setattr(fs, name, fn)
    return captured


def distinct_rows(tier, slot, tables):
    """Distinct (table, row) pairs a call must read at least once."""
    return sum(int(slot[tier == t].long().clamp(0, table.shape[0] - 1)
                   .unique().numel()) for t, table in enumerate(tables))


def kernel_phase(stack, fanouts, seeds) -> list[dict]:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import gather_aggregate as ga
    from repro_torch.kernels import tiered_gather as tg

    cap = capture_serve_inputs(stack, fanouts, seeds)
    check(set(cap) == {"tiered_gather", "gather_aggregate"},
          f"serve path reached only {sorted(cap)}")
    dev = torch.device("cuda")
    results = []

    # -- tiered_gather ------------------------------------------------------
    tier, slot, hot, warm = cap["tiered_gather"]
    m, d = tier.shape[0], hot.shape[1]
    log(f"tiered_gather serve inputs: M={m} d={d} hot={tuple(hot.shape)} "
        f"warm={tuple(warm.shape)} dtype={hot.dtype}")
    err = 0.0
    gen = torch.Generator(device=dev).manual_seed(0)
    rand_tier = torch.randint(0, 3, (m,), generator=gen, device=dev,
                              dtype=torch.int32)
    rand_tier[rand_tier == 2] = 99
    rand_slot = torch.randint(-5, max(hot.shape[0], warm.shape[0]) + 5, (m,),
                              generator=gen, device=dev, dtype=torch.int32)
    cases = {"serve": (tier, slot), "clamped": (rand_tier, rand_slot),
             "all-invalid": (torch.full_like(tier, 99), slot)}
    for dtype in (torch.float32, torch.bfloat16):
        h, w = hot.to(dtype), warm.to(dtype)
        for name, (t, s) in cases.items():
            got = tg.tiered_gather(t, s, h, w)
            want = tg.tiered_gather_ref(t, s, h, w)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"tiered_gather != plain ({name}, {dtype})")
            err = max(err, float((got.float() - want.float()).abs().max()))
            if name == "all-invalid":
                check(not got.any(), "tiered_gather all-invalid not zero")
        before = tg.LAUNCHES.value
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        check(tg.tiered_gather(z, z, h, w).shape == (0, d)
              and tg.LAUNCHES.value == before,
              "tiered_gather empty grid launched or misshaped")
    log(f"tiered_gather == plain bitwise (fp32, bf16; serve, clamped, "
        f"all-invalid, empty)")
    table = torch.cat([hot, warm, hot.new_zeros((1, d))])
    h_rows, w_rows = hot.shape[0], warm.shape[0]
    sl = slot.long()
    lib_idx = torch.where(tier == 0, sl.clamp(0, h_rows - 1),
                          torch.where(tier == 1,
                                      h_rows + sl.clamp(0, w_rows - 1),
                                      h_rows + w_rows))
    lib_out = torch.index_select(table, 0, lib_idx)
    log("index_select yardstick == kernel: "
        f"{torch.equal(lib_out, tg.tiered_gather(tier, slot, hot, warm))}")
    elem = hot.element_size()
    read_rows = distinct_rows(tier, slot, (hot, warm))
    nbytes = 8 * m + read_rows * d * elem + m * d * elem
    results.append({
        "name": "tiered_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/tiered_gather.cu",
        "replaces": "src/repro/kernels/tiered_gather/kernel.py:40",
        "max_abs_err": err,
        "ms": time_ms(lambda: tg.tiered_gather_cuda(tier, slot, hot, warm)),
        "plain_ms": time_ms(lambda: tg.tiered_gather_ref(tier, slot, hot,
                                                         warm)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": time_ms(lambda: torch.index_select(table, 0, lib_idx)),
        "call_ms": time_ms(lambda: tg.tiered_gather_cuda(tier, slot, hot,
                                                         warm), graph=False),
        "bytes": nbytes, "shape": [m, d]})

    # -- gather_aggregate ---------------------------------------------------
    tier, slot, hot, warm, cold = cap["gather_aggregate"]
    s, fan = tier.shape
    log(f"gather_aggregate serve inputs: S={s} fan={fan} d={d} "
        f"cold={tuple(cold.shape)} dtype={hot.dtype}")
    err = 0.0
    rand_tier = torch.randint(0, 4, (s, fan), generator=gen, device=dev,
                              dtype=torch.int32)
    rand_tier[rand_tier == 3] = 99
    rand_slot = torch.randint(-5, max(hot.shape[0], warm.shape[0]) + 5,
                              (s, fan), generator=gen, device=dev,
                              dtype=torch.int32)
    cases = {"serve": (tier, slot), "clamped": (rand_tier, rand_slot),
             "all-invalid": (torch.full_like(tier, 99), slot)}
    for dtype in (torch.float32, torch.bfloat16):
        h, w, c = hot.to(dtype), warm.to(dtype), cold.to(dtype)
        for name, (t, sl_) in cases.items():
            got = ga.gather_aggregate(t, sl_, h, w, c)
            want = ga.gather_aggregate_ref(t, sl_, h, w, c)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"gather_aggregate != plain ({name}, {dtype})")
            err = max(err, float((got.float() - want.float()).abs().max()))
            if name == "all-invalid":
                check(not got.any(), "gather_aggregate all-invalid not zero")
        before = ga.LAUNCHES.value
        for shape in ((0, fan), (s, 0)):
            z = torch.zeros(shape, dtype=torch.int32, device=dev)
            out = ga.gather_aggregate(z, z, h, w, c)
            check(out.shape == (shape[0], d) and not out.any(),
                  f"gather_aggregate empty grid {shape} wrong")
        check(ga.LAUNCHES.value == before,
              "gather_aggregate empty grid launched")
    log("gather_aggregate == plain bitwise (fp32, bf16; serve, clamped, "
        "all-invalid, empty)")
    table = torch.cat([hot, warm, cold, hot.new_zeros((1, d))])
    h_rows, w_rows, c_rows = hot.shape[0], warm.shape[0], cold.shape[0]
    sl = slot.long()
    lib_idx = torch.where(
        tier == 0, sl.clamp(0, h_rows - 1), torch.where(
            tier == 1, h_rows + sl.clamp(0, w_rows - 1), torch.where(
                tier == 2, h_rows + w_rows + sl.clamp(0, c_rows - 1),
                h_rows + w_rows + c_rows)))
    lib_out = F.embedding_bag(lib_idx, table, mode="sum")
    kern_out = ga.gather_aggregate(tier, slot, hot, warm, cold)
    log("embedding_bag yardstick max |diff| vs kernel: "
        f"{float((lib_out - kern_out).abs().max()):.3g}")
    valid = int((tier <= 2).logical_and(tier >= 0).sum())
    read_rows = distinct_rows(tier, slot, (hot, warm, cold))
    nbytes = 8 * s * fan + read_rows * d * elem + s * d * elem
    flops = valid * d
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    results.append({
        "name": "gather_aggregate", "route": "cuda",
        "source": "src/repro_torch/csrc/gather_aggregate.cu",
        "replaces": "src/repro/kernels/gather_aggregate/kernel.py:69",
        "max_abs_err": err,
        "ms": time_ms(lambda: ga.gather_aggregate_cuda(tier, slot, hot, warm,
                                                       cold)),
        "plain_ms": time_ms(lambda: ga.gather_aggregate_ref(tier, slot, hot,
                                                            warm, cold)),
        "bound_ms": bound_s * 1e3,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / FP32_FLOPS else "operations"),
        "library_ms": time_ms(lambda: F.embedding_bag(lib_idx, table,
                                                      mode="sum")),
        "call_ms": time_ms(lambda: ga.gather_aggregate_cuda(
            tier, slot, hot, warm, cold), graph=False),
        "bytes": nbytes, "shape": [s, fan, d]})
    for r in results:
        log(f"{r['name']} device time (CUDA graph replay): kernel "
            f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, library "
            f"{r['library_ms']:.5f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bytes']} bytes, {r['bound_by']}); eager wrapper call "
            f"{r['call_ms']:.5f} ms")
    return results


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------
def serve_phase(results: list[dict], stack, fanouts, gen_seeds) -> None:
    import numpy as np
    import torch
    from repro_torch.graph import host_sample_dense
    from repro_torch.kernels import gather_aggregate as ga
    from repro_torch.kernels import tiered_gather as tg
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import HostExecutor

    counters = {"tiered_gather": tg.LAUNCHES, "gather_aggregate": ga.LAUNCHES}
    path_kernel = {"fused": "tiered_gather",
                   "fuse_aggregate": "gather_aggregate"}
    launches = {}
    for path, extra in (("fused", []), ("fuse_aggregate",
                                        ["--fuse-aggregate"])):
        args = launcher.parse_args(["--device", "cuda", "--requests",
                                    str(SERVE_REQUESTS), *extra])
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        summary = launcher.serve(args)
        wall = time.perf_counter() - t0
        counts = {k: c.value for k, c in counters.items()}
        log(f"serve[{path}]: {summary['requests']} requests, "
            f"{summary['throughput_rps']:.2f} rps, p50 "
            f"{summary['p50_ms']:.3f} ms, p99 {summary['p99_ms']:.3f} ms, "
            f"routed {summary['routed']}, launches {counts}, "
            f"store {summary['store']}, wall {wall:.1f} s")
        check(summary["requests"] == SERVE_REQUESTS,
              f"serve[{path}] answered {summary['requests']} requests")
        kernel = path_kernel[path]
        check(counts[kernel] > 0, f"serve[{path}] never launched {kernel}")
        launches[kernel] = counts[kernel]
        print(json.dumps({"serve": path, "requests": summary["requests"],
                          "throughput_rps": summary["throughput_rps"],
                          "p50_ms": summary["p50_ms"],
                          "p99_ms": summary["p99_ms"],
                          "routed": summary["routed"],
                          "executors": summary["executors"],
                          "launches": counts}), flush=True)
    for r in results:
        r["launches"] = launches[r["name"]]

    graph, _, _, _, store, _, infer = stack
    rng = np.random.default_rng(7)
    for i in range(8):
        hops = [torch.from_numpy(h).cuda() for h in host_sample_dense(
            rng, graph, gen_seeds[i], fanouts)]
        fused = infer(store.lookup_hops(hops), hops)
        feats, agg = store.lookup_aggregate(hops)
        folded = infer(feats, hops, deep_agg=agg)
        torch.cuda.synchronize()
        check(torch.equal(fused, folded),
              f"fused != fuse-aggregate outputs on batch {i}")
    log("fused == fuse-aggregate outputs bitwise on 8 host-sampled batches")

    def host_outputs(st):
        g, _, _, _, st_store, _, st_infer = st
        ex = HostExecutor(g, st_store, fanouts, st_infer, rng_seed=0)
        try:
            return [ex.run(gen_seeds[i]).cpu() for i in range(4)]
        finally:
            ex.close()

    defaults = launcher.parse_args([])
    cpu_stack = launcher.build_stack(
        nodes=defaults.nodes, avg_degree=defaults.avg_degree,
        d_feat=defaults.d_feat, fanouts=fanouts, hot_frac=defaults.hot_frac,
        device="cpu")
    worst = 0.0
    for i, (a, b) in enumerate(zip(host_outputs(stack),
                                   host_outputs(cpu_stack))):
        check(a.shape == (gen_seeds[i].shape[0], launcher.HIDDEN[-1]),
              f"output shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a).all()), "non-finite card output")
        worst = max(worst, float((a - b).abs().max()))
    check(worst <= CPU_TOL, f"card vs CPU max |diff| {worst:.3g} > {CPU_TOL}")
    log(f"card HostExecutor outputs within {CPU_TOL} of the CPU port "
        f"(max |diff| {worst:.3g})")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: needs an NVIDIA GPU")
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it "
             "from a checkout of the repository")
    sys.path.insert(0, str(src))

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    # 3. kernels at the serve path's inputs
    from repro_torch.launch import serve as launcher
    fanouts = (10, 5)
    defaults = launcher.parse_args([])
    stack = launcher.build_stack(
        nodes=defaults.nodes, avg_degree=defaults.avg_degree,
        d_feat=defaults.d_feat, fanouts=fanouts, hot_frac=defaults.hot_frac,
        device="cuda")
    gen = stack[5]
    gen_seeds = [r.seeds for r in gen.stream(8, defaults.batch)]
    results = kernel_phase(stack, fanouts, gen_seeds[0])

    # 4. serve
    serve_phase(results, stack, fanouts, gen_seeds)

    # 5. summary
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
