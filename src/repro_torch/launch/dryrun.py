"""Dry-run: count EVERY (arch × shape) cell at full size without allocating
it, derive its share on the production meshes, and, on the card, run the
cells that fit one card — the counterpart of ``src/repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] \\
        [--shape S] [--mesh single|multi|both] \\
        [--out artifacts/dryrun_torch.json] [--append] \\
        [--device cuda|cpu] [--seed N]

The reference lowers and compiles each cell for 256 and 512 devices and
reads XLA's memory, cost and collective analysis. Here each cell's model,
optimizer state and inputs are built as fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and dtypes,
nothing allocated) on ``--device``, and its step runs once under three
counting modes:

  * ``FlopCounterMode``: the matrix products' operations, plus each
    kernel's own operations from its fake branch
    (:mod:`repro_torch.kernels.fake`, ``ref.cost``);
  * :class:`ByteCounter`: each aten op's input and output bytes, plus the
    kernels' ``ref.cost`` bytes — an unfused count (every op reads its
    inputs from and writes its outputs to memory), so an upper estimate
    of what a fused program moves;
  * :class:`LiveBytes`: the bytes of the storages the step allocates that
    are alive at once, at their peak.

The counter sees every op that runs, loops included, so the counts are
per executed step: the reference's ``loop_factor`` (XLA counts a loop
body once) is kept as a recorded field with the reference's values, and
``roofline_corrected`` equals ``roofline`` (``"counted": "every
execution"``); nothing is multiplied by it.

The counts do not depend on the mesh: each (arch × shape) is counted once
and each mesh's record derives from that count. A device's argument
bytes are exact from the specs (:mod:`repro_torch.sharding`); its
operations and bytes accessed are the global counts over ``world``; its
temporaries are the global peak over the size of the batch axes (a
model); its collectives are modeled
(:func:`repro_torch.launch.hlo_analysis.model_collectives`).

With ``--device cuda`` each cell whose modeled world-1 peak (arguments
plus the peak of the step's allocations, on one card) is under
``FIT_BYTES`` also runs for real on the card at world 1, from ``--seed``:
``measured`` holds the median step ms of 3 after a warm-up (CUDA events),
``torch.cuda.max_memory_allocated``, the kernels' launches, and
``bound_share``, the world-1 roofline bound over the measured step, beside
the card's name and power limit. A cell that raises ends ``ok: false``
with its error, and the rest go on. The port's dry-run sets no
``XLA_FLAGS`` and imports no JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import resolve_device
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels import fake as kernel_fake
from repro_torch.kernels.build import launch_counters
from repro_torch.launch.hlo_analysis import (model_collectives,
                                             roofline_terms)
from repro_torch.launch.mesh import make_production_mesh, mesh_world
from repro_torch.sharding import NamedSharding, shard_factor

FIT_BYTES = 72e9     # a cell runs on the card below this modeled peak
MEASURE_STEPS = 3

aten = torch.ops.aten
# gathers read at most as many source bytes as they write
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.embedding.default, aten.gather.default}
# in-place scatters touch at most as many destination bytes as they add
_SCATTERS = {aten.index_add_.default, aten.index_put_.default,
             aten._index_put_impl_.default, aten.index_copy_.default,
             aten.scatter_add_.default, aten.scatter_.src,
             aten.scatter_reduce_.two}
# ops that allocate without writing
_ALLOCS = {aten.empty.memory_format, aten.empty_like.default,
           aten.empty_strided.default, aten.new_empty.default,
           aten.new_empty_strided.default}
_TRANSCENDENTAL = {aten.exp.default, aten.exp_.default, aten.log.default,
                   aten.log1p.default, aten.tanh.default,
                   aten.sigmoid.default, aten.sin.default, aten.cos.default,
                   aten.sqrt.default, aten.sqrt_.default, aten.rsqrt.default,
                   aten.erf.default, aten.silu.default,
                   aten._softmax.default, aten._log_softmax.default,
                   aten.logsumexp.default}


def loop_factor(arch_name: str, shape: str) -> int:
    """The reference's outermost scan trip count a step (XLA counts a
    loop body once). Recorded only: the port's counter sees every
    execution, so nothing is multiplied by it."""
    lm_layers = {"qwen1.5-4b": 40, "qwen3-4b": 36, "codeqwen1.5-7b": 32,
                 "deepseek-moe-16b": 28, "phi3.5-moe-42b": 32}
    if arch_name in lm_layers:
        micro = 1
        if shape == "train_4k":
            micro = 8 if arch_name == "phi3.5-moe-42b" else 4
        return lm_layers[arch_name] * micro
    gnn_layers = {"equiformer-v2": 12, "schnet": 3, "meshgraphnet": 15}
    if arch_name in gnn_layers:
        return gnn_layers[arch_name]
    if arch_name == "din" and shape == "retrieval_cand":
        return 32
    return 1


def _tensors(tree, out: Optional[list] = None) -> list:
    """The tensors in nested lists, tuples and dicts (an op's arguments
    and results, a step's outputs), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a read or write of ``t`` touches: its elements, or the span
    its strides cover where that is less (an expanded tensor)."""
    n = t.numel()
    if n == 0:
        return 0
    span = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride()))
    return min(n, span) * t.element_size()


class ByteCounter(TorchDispatchMode):
    """Sums the input and output bytes of each aten op run under it
    (views, bare allocations and queries such as ``prim.device`` move
    nothing; a gather counts at most its
    output's bytes of its source, an in-place scatter at most twice its
    source's bytes of its destination), and the output elements of the
    transcendental ops."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _ALLOCS or func.namespace == "prim":
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not outs:        # a query (sizes, a device): no data moves
            return out
        self.ops += 1
        if func in _GATHERS:
            src, rest = ins[0], ins[1:]
            wrote = sum(tensor_bytes(t) for t in outs)
            self.bytes += (wrote + min(tensor_bytes(src), wrote)
                           + sum(tensor_bytes(t) for t in rest))
        elif func in _SCATTERS:
            dst, rest = ins[0], ins[1:]
            moved = sum(tensor_bytes(t) for t in rest)
            self.bytes += moved + 2 * min(tensor_bytes(dst), moved)
        else:
            self.bytes += sum(tensor_bytes(t) for t in ins + outs)
        if func in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        return out


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages allocated under it that are alive at
    once, and their peak. A storage counts from the op that first
    returns it (unless that op also took it: a view or an in-place op)
    until it is freed."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._held: dict = {}

    def _free(self, key) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        taken = {t.untyped_storage()._cdata
                 for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in taken or key in self._held:
                continue
            self._held[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


def _leaves(tree, prefix: str = "") -> dict:
    """``{path: tensor}`` of a cell's arguments or shardings: a module's
    parameters by name, dicts by key, named tuples by field, sequences
    by index."""
    if isinstance(tree, torch.nn.Module):
        return {f"{prefix}{n}": p for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}."))
        return out
    return {prefix.rstrip("."): tree}


def _shardings(cell) -> dict:
    """``{path: NamedSharding}`` matching :func:`_leaves` of the args."""
    if cell.in_shardings is None:
        return {}
    return {k: v for k, v in _leaves(tuple(cell.in_shardings)).items()
            if isinstance(v, NamedSharding)}


def count_cell(cell) -> dict:
    """Run ``cell``'s step once on its fake arguments under the counting
    modes. Returns the global counts: ``flops`` (matrix products and
    kernels), ``bytes_accessed``, ``transcendentals``, ``kernels`` (each
    kernel's calls, operations and bytes), ``peak_live`` (bytes),
    ``outputs`` and ``alias`` (bytes of the step's outputs, and of those
    that are its arguments updated in place), ``alias_keys`` (those
    arguments' paths), ``argument_bytes``."""
    args = cell.args
    arg_leaves = {k: v for k, v in _leaves(tuple(args)).items()
                  if isinstance(v, torch.Tensor)}
    kc = kernel_fake.KernelCounter()
    with cell.fake_mode, kernel_fake.counting(kc):
        with FlopCounterMode(display=False) as fc, ByteCounter() as bc, \
                LiveBytes() as lb:
            out = cell.step_fn(*args)
        outs = _tensors(out)
        out_storages = {t.untyped_storage()._cdata for t in outs}
        alias_keys = [k for k, t in arg_leaves.items()
                      if t.untyped_storage()._cdata in out_storages]
        out_bytes = sum(t.nbytes for t in outs)
    return {"flops": fc.get_total_flops() + kc.total_flops,
            "bytes_accessed": bc.bytes + kc.total_bytes,
            "transcendentals": bc.transcendentals, "ops": bc.ops,
            "kernels": {k: {"calls": kc.calls[k], "flops": kc.flops[k],
                            "bytes": kc.bytes[k]} for k in kc.calls},
            "peak_live": lb.peak, "outputs": out_bytes,
            "alias": sum(arg_leaves[k].nbytes for k in alias_keys),
            "alias_keys": alias_keys,
            "argument_bytes": sum(t.nbytes for t in arg_leaves.values())}


def mesh_record(cell, counts: dict, mesh) -> dict:
    """The record of one mesh from the cell's counts (module docstring)."""
    world = mesh_world(mesh)
    shard = _shardings(cell)
    args = {k: v for k, v in _leaves(tuple(cell.args)).items()
            if isinstance(v, torch.Tensor)}
    per_dev = {k: t.nbytes / (shard_factor(mesh, shard[k].spec)
                              if k in shard else 1)
               for k, t in args.items()}
    arg_dev = sum(per_dev.values())
    batch_div = shard_factor(mesh, cell.meta["batch_spec"])
    new_out = max(counts["outputs"] - counts["alias"], 0)
    alias_dev = sum(per_dev[k] for k in counts["alias_keys"])
    out_dev = alias_dev + new_out / batch_div
    temp_dev = max(counts["peak_live"] - new_out, 0) / batch_div
    memory = {"argument_bytes": int(arg_dev), "output_bytes": int(out_dev),
              "temp_bytes": int(temp_dev), "alias_bytes": int(alias_dev),
              "peak_hbm_bytes": int(arg_dev + out_dev + temp_dev
                                    - alias_dev)}
    flops = counts["flops"] / world
    nbytes = counts["bytes_accessed"] / world
    coll = model_collectives(cell, mesh, cell.meta["rules"])
    roof = roofline_terms(flops=flops, bytes_accessed=nbytes,
                          collective_bytes=coll.total_bytes,
                          collective_bw=coll.bw, dtype=cell.dtype)
    return {
        "mesh": "x".join(str(s) for s in mesh.shape.values()),
        "world": world, "memory": memory,
        "cost": {"flops": flops, "bytes_accessed": nbytes,
                 "transcendentals": counts["transcendentals"] / world,
                 "counted": "every execution",
                 "bytes_note": "unfused: every aten op's inputs and "
                               "outputs, plus the kernels' ref.cost bytes"},
        "collectives": {"counts": coll.counts,
                        "bytes_by_kind": coll.bytes_by_kind,
                        "total_bytes": coll.total_bytes, "bw": coll.bw,
                        "modeled": True},
        "roofline": roof, "roofline_corrected": roof}


def world1(cell, counts: dict) -> dict:
    """The cell on one card: its roofline (no collectives) and the modeled
    peak (every argument plus the peak of the step's allocations)."""
    roof = roofline_terms(flops=counts["flops"],
                          bytes_accessed=counts["bytes_accessed"],
                          collective_bytes=0.0, dtype=cell.dtype)
    return {"roofline": roof,
            "peak_hbm_bytes": counts["argument_bytes"] + counts["peak_live"]}


def measure_cell(cell, bound_s: float, *, seed: int,
                 device: torch.device) -> dict:
    """Run ``cell``'s step on the card with ``make_args(seed)``: a warm-up,
    then :data:`MEASURE_STEPS` steps timed by CUDA events; the median ms,
    the peak allocated bytes (``max_memory_allocated``, and
    ``resident_bytes`` already allocated before the arguments were made:
    the cell's own peak is their difference), the kernels' launches a
    timed step, and ``bound_share`` = ``bound_s`` over the median step."""
    from repro_torch.bench.common import card_name
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device)
    args = cell.make_args(seed, device)
    cell.step_fn(*args)
    torch.cuda.synchronize(device)
    counters = launch_counters()
    before = {k: c.value for k, c in counters.items()}
    times = []
    for _ in range(MEASURE_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cell.step_fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    step_ms = statistics.median(times)
    launches = {k: (c.value - before[k]) // MEASURE_STEPS
                for k, c in counters.items() if c.value > before[k]}
    peak = torch.cuda.max_memory_allocated(device)
    del args
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "step_ms_all": times, "peak_bytes": peak,
            "resident_bytes": resident, "launches_per_step": launches,
            "bound_ms": bound_s * 1e3,
            "bound_share": bound_s / (step_ms * 1e-3), "seed": seed,
            "card": card_name(device)}


def run_cell(arch_name: str, shape: str, multi_pods=(False, True), *,
             device: str | torch.device = "cuda", measure: bool = False,
             seed: int = 0, verbose: bool = True) -> list[dict]:
    """Count one (arch × shape) cell once and return one record for each
    production mesh in ``multi_pods`` (module docstring); with
    ``measure`` (needs the card), run it on the card when it fits."""
    arch = get_arch(arch_name)
    meshes = [make_production_mesh(multi_pod=m) for m in multi_pods]
    base = {"arch": arch_name, "shape": shape, "ok": False,
            "device": str(device)}
    records = [{**base, "mesh": "x".join(str(s) for s in m.shape.values()),
                "world": mesh_world(m)} for m in meshes]
    try:
        t0 = time.time()
        cells = [arch.build_cell(shape, m, device=device) for m in meshes]
        build_s = time.time() - t0
        t1 = time.time()
        counts = count_cell(cells[0])
        count_s = time.time() - t1
        one = world1(cells[0], counts)
        measured = None
        if measure and one["peak_hbm_bytes"] < FIT_BYTES:
            measured = measure_cell(
                cells[0], one["roofline"]["step_lower_bound_s"], seed=seed,
                device=torch.device(device))
        for rec, cell, mesh in zip(records, cells, meshes):
            rec.update(mesh_record(cell, counts, mesh))
            rec.update({
                "build_s": build_s, "count_s": count_s,
                "loop_factor": loop_factor(arch_name, shape),
                "kind": cell.kind, "notes": cell.notes,
                "dtype": str(cell.dtype).replace("torch.", ""),
                "global": {k: counts[k] for k in
                           ("flops", "bytes_accessed", "argument_bytes",
                            "peak_live", "ops", "kernels")},
                "world1": one, "ok": True})
            if measured is not None:
                rec["measured"] = measured
            if verbose:
                r = rec["roofline"]
                print(f"[ok] {arch_name:17s} {shape:14s} "
                      f"mesh={rec['mesh']:8s} count={count_s:6.1f}s "
                      f"hbm={rec['memory']['peak_hbm_bytes'] / 2**30:8.2f}GiB "
                      f"compute={r['compute_s'] * 1e3:9.3f}ms "
                      f"mem={r['memory_s'] * 1e3:9.3f}ms "
                      f"coll={r['collective_s'] * 1e3:9.3f}ms "
                      f"dom={r['dominant']}"
                      + (f" measured={measured['step_ms']:.3f}ms "
                         f"share={measured['bound_share']:.3f}"
                         if measured else ""), flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue
        for rec in records:
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {arch_name} {shape}: {records[0]['error']}",
                  flush=True)
    return records


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None, help="single arch id (default all)")
    p.add_argument("--shape", default=None)
    p.add_argument("--mesh", default="both",
                   choices=["single", "multi", "both"])
    p.add_argument("--out", default="artifacts/dryrun_torch.json")
    p.add_argument("--append", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="the fake tensors' device; cuda also runs the "
                        "cells that fit on the card")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    archs = [args.arch] if args.arch else list_archs()
    multi = {"single": (False,), "multi": (True,),
             "both": (False, True)}[args.mesh]
    records = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)
    for name in archs:
        arch = get_arch(name)
        shapes = [args.shape] if args.shape else list(arch.shape_names)
        for shape in shapes:
            new = run_cell(name, shape, multi, device=dev,
                           measure=dev.type == "cuda", seed=args.seed)
            keys = {(r["mesh"]) for r in new}
            records = [r for r in records
                       if not (r["arch"] == name and r["shape"] == shape
                               and r["mesh"] in keys)] + new
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)
    ok = sum(r["ok"] for r in records)
    print(f"\n{ok}/{len(records)} cells counted; results → {args.out}")


if __name__ == "__main__":
    main()
