"""CPU tests of the serving benchmark: a tiny cell end to end, the
reference against the port, the control and the planted faults failing,
new configurations, mixes, metrics, architectures and kernels found by
name (a cell builds and records only the kernels its path launches), the
import rules, and the yardstick's arithmetic. The card's test is marked
``cuda``.

    PYTHONPATH=src python -m pytest -q servebench
"""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from servebench import check, costs, inputs, run, trace  # noqa: E402
from servebench.reference import sage as ref, sample  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 17


def _tiny_cfg(collect: str, limits: dict) -> dict:
    return {"name": "tiny", "arch": "sage", "nodes": 3000,
            "num_edges": 30000, "exponent": 1.6, "feat_dim": 16,
            "hidden": [32, 32], "classes": 8, "fanouts": [4, 3, 2],
            "dtype": "float32", "collect": collect,
            "topology": {"rows_per_device": 750, "rows_host": 1500,
                         "hot_frac": 0.25},
            "executor": {"max_batch": 64, "lanes": 2, "max_inflight": 64,
                         "admission": "wait",
                         "policy": "latency_preferred"},
            "limits": limits}


def _limits(config: str) -> dict:
    return run.load_json(BENCH_DIR / "configs" / f"{config}.json")["limits"]


@pytest.fixture
def tiny(tmp_path):
    """A benchmark directory of tiny cells over the real metric readers,
    architectures, references and kernels, and the ``BENCHMARK.json``
    naming them."""
    for folder in ("metrics", "archs", "reference", "kernels"):
        shutil.copytree(BENCH_DIR / folder, tmp_path / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    cfgs = {"tiny": _tiny_cfg("lookup_hops", _limits("products-sage3")),
            "tinyagg": _tiny_cfg("lookup_aggregate",
                                 _limits("reddit-sage2"))}
    for name, cfg in cfgs.items():
        (tmp_path / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    mixes = {"tmixed": {"loop": "open", "arrivals": "poisson",
                        "rate_rps": 25.0,
                        "sizes": {"law": "log_uniform_int", "lo": 1,
                                  "hi": 64},
                        "seed_law": "out_degree", "check_requests": 6},
             "tbulk": {"loop": "closed", "clients": 4,
                       "sizes": {"law": "fixed", "n": 64},
                       "seed_law": "out_degree", "check_requests": 4,
                       "check_horizon": 8}}
    for name, mix in mixes.items():
        (tmp_path / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    bench = run.load_json(ROOT / "BENCHMARK.json")
    bench["workloads"] = [
        {"name": "tiny.mixed", "config": "tiny", "traffic": "tmixed",
         "chips": 1},
        {"name": "tiny.bulk", "config": "tinyagg", "traffic": "tbulk",
         "chips": 1}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["tiny.mixed"]
                              if "products-sage3.mixed" in m["workloads"]
                              else ["tiny.bulk"])
    return bench, tmp_path


def _run(tiny, cell, traced=False, seconds=1.0):
    bench, bench_dir = tiny
    return run.run_cell(bench, cell, SEED, seconds, traced, device=CPU,
                        bench_dir=bench_dir)


@pytest.mark.parametrize("cell", ["tiny.mixed", "tiny.bulk"])
def test_tiny_cell_prints_the_result_line(tiny, cell):
    line, rows = _run(tiny, cell)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    want = ({"p50_ms", "setup_s"} if cell == "tiny.mixed"
            else {"seeds_per_s", "setup_s"})
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert json.loads(json.dumps(line)) == line
    assert [r[0] for r in rows] == list(line["checks"])


def test_traced_tiny_cell_reports_per_layer_metrics(tiny):
    line, _ = _run(tiny, "tiny.mixed", traced=True)
    assert line["correct"] is True
    # no device on the CPU: only the host-side readers find something
    # (which executors served depends on the router's calibration)
    assert {"routed_device_share", "p99_ms.host_paced"} <= \
        set(line["metrics"])
    assert set(line["metrics"]) <= {"routed_device_share",
                                    "p99_ms.host_paced",
                                    "service_p50_ms.device"}
    assert "busy_s" not in line["device"]


def test_reference_follows_the_port_on_a_small_sample():
    """The port's GraphSAGE over hops its own samplers drew, against the
    reference; both samplers' hops obey the reference's rules."""
    from repro_torch.graph import CSRGraph, device_sample, host_sample_dense
    from repro_torch.models.gnn_basic import sage_from_numpy, sage_layered

    g = inputs.power_law_graph(2000, 20000, 1.6, SEED, CPU)
    csr = CSRGraph(indptr=g.indptr, indices=g.indices, num_nodes=g.num_nodes)
    feats = inputs.features(g.num_nodes, 12, SEED, CPU)
    w_np = inputs.sage_weights([12, 24, 24, 5], SEED, CPU)
    fanouts = [5, 4, 3]
    seeds = np.arange(0, 2000, 97)
    rg = sample.Graph(g.indptr, g.indices, g.num_nodes, CPU)
    hops_h = [torch.from_numpy(h) for h in host_sample_dense(
        np.random.default_rng(1), csr, np.pad(seeds, (0, 11),
                                              constant_values=-1),
        fanouts)]
    hops_d = device_sample(torch.Generator().manual_seed(1),
                           *csr.device_arrays(CPU),
                           torch.as_tensor(seeds, dtype=torch.int32),
                           fanouts)
    model = sage_from_numpy(w_np, device=CPU)
    feats_t = torch.from_numpy(feats)
    w = ref.weights_on(w_np, CPU)
    for hops in (hops_h, hops_d):
        assert sample.invalid_hops(rg, hops, torch.as_tensor(seeds),
                                   fanouts) == 0
        got = sage_layered(model, [sample.rows(feats_t, h) for h in hops],
                           fanouts, [(h >= 0).float()[:, None] for h in hops])
        want = ref.embed(w, feats_t, hops, fanouts)
        assert (got - want).abs().max() < 1e-5
    # a slot moved to a node that is not a neighbour breaks the rules
    bad = [h.clone() for h in hops_d]
    bad[2][7] = (bad[2][7] + 1) % g.num_nodes
    assert sample.invalid_hops(rg, bad, torch.as_tensor(seeds),
                               fanouts) >= 1


def test_the_lower_precision_control_fails(tiny):
    """The reference in the next precision below (TF32 products, bfloat16
    sums) in the program's place fails the limits that the program
    passes."""
    bench, bench_dir = tiny
    spec = run.cell_spec(bench, "tiny.bulk", bench_dir)
    prep = run.prepare(spec["cfg"], spec["traffic"], SEED, CPU)
    res = run.drive(prep, spec["traffic"], 1.0, SEED)
    r = run.answers(prep, res, CPU, control=True)
    lim = spec["cfg"]["limits"]
    assert r["embed_err"] <= lim["embed_err"] < r["control_embed_err"]
    assert r["agg_err"] <= lim["agg_err"] < r["control_agg_err"]


def _alter_answer(monkeypatch):
    from repro_torch.models import gnn_basic
    real = gnn_basic.sage_layered

    def altered(*a, **kw):
        out = real(*a, **kw)
        return torch.cat([out[:1] + 1e-2, out[1:]])
    monkeypatch.setattr(gnn_basic, "sage_layered", altered)


def _half_the_neighbours(monkeypatch):
    from repro_torch.models import gnn_basic
    real = gnn_basic.fan_sum

    def half(x):
        keep = max(x.shape[1] // 2, 1)
        return real(x[:, :keep]) * (x.shape[1] / keep)
    monkeypatch.setattr(gnn_basic, "fan_sum", half)


def _bad_sample(monkeypatch):
    from repro_torch.serving import executors
    real = executors.device_sample
    real_h = executors.host_sample_dense

    def moved(hops):
        last = hops[-1]
        last[0] = 0 if int(last[0]) != 0 else 1
        return hops
    monkeypatch.setattr(executors, "device_sample",
                        lambda *a: moved(real(*a)))
    monkeypatch.setattr(executors, "host_sample_dense",
                        lambda *a: moved(real_h(*a)))


def _bad_rows(monkeypatch):
    from repro_torch.core import feature_store
    real = feature_store.tiered_gather

    def shifted(tier, slot, hot, warm):
        return real(tier, slot, hot, warm) + 0.5
    monkeypatch.setattr(feature_store, "tiered_gather", shifted)


@pytest.mark.parametrize("fault,number", [
    (_alter_answer, "embed_err"),
    (_half_the_neighbours, "embed_err"),
    (_bad_sample, "hops_invalid"),
    (_bad_rows, "feature_mismatch")])
def test_a_planted_fault_makes_the_run_incorrect(tiny, monkeypatch, fault,
                                                 number):
    fault(monkeypatch)
    line, rows = _run(tiny, "tiny.mixed")
    assert line["correct"] is False
    failed = {n for n, v, lim in rows if v > lim}
    assert number in failed, line["checks"]


def test_new_files_are_found_by_name(tiny, tmp_path):
    """A configuration, a mix and a per-layer metric added as files (and
    entries of BENCHMARK.json) run with no edit of the harness."""
    bench, bench_dir = tiny
    cfg = _tiny_cfg("lookup_hops", _limits("products-sage3"))
    cfg.update(nodes=2500, fanouts=[3, 2], hidden=[16])
    (bench_dir / "configs" / "newcfg.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "small.json").write_text(json.dumps(
        {"loop": "open", "arrivals": "poisson", "rate_rps": 20.0,
         "sizes": {"law": "log_uniform_int", "lo": 1, "hi": 8},
         "seed_law": "out_degree", "check_requests": 4}))
    (bench_dir / "metrics" / "answered_share.py").write_text(
        "def read(ctx):\n"
        "    lat = ctx['latencies_ms']\n"
        "    return 100.0 * float((lat < float('inf')).mean())\n")
    bench["workloads"].append({"name": "newcfg.small", "config": "newcfg",
                               "traffic": "small", "chips": 1})
    bench["end_to_end"][0]["workloads"].append("newcfg.small")
    bench["per_layer"].append({"name": "answered_share", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine and executors",
                               "moves": "p50_ms",
                               "workloads": ["newcfg.small"]})
    line, _ = run.run_cell(bench, "newcfg.small", SEED, 1.0, True,
                           device=CPU, bench_dir=bench_dir)
    assert line["correct"] is True
    assert line["metrics"]["answered_share"]["value"] == 100.0


TOY_ARCH = """\
\"\"\"A toy one-layer model over the first two hops: tanh(x W_s + mean of
the valid children's rows W_n + b), in its own torch ops.\"\"\"
import importlib

import torch

from servebench import inputs

COLLECTS = ("lookup_hops",)
MODEL_SPAN = {span!r}
FAULT = {fault!r}
# the program's function the model hands its output to, or None
OP = {op!r}


def weights(cfg, seed, device):
    gen = torch.Generator(device=device).manual_seed(inputs.sub_seed(seed, 2))
    d, c = cfg["feat_dim"], cfg["classes"]
    w = torch.randn((2 * d + 1, c), generator=gen, device=device) / d ** 0.5
    w = w.cpu().numpy()
    return {{"self": w[:d], "neigh": w[d:2 * d], "b": w[-1]}}


def infer_fn(cfg, weights, device):
    fan = cfg["fanouts"][0]
    ws, wn, b = (torch.as_tensor(weights[k], device=device)
                 for k in ("self", "neigh", "b"))

    def infer(hop_feats, hop_ids, deep_agg=None):
        x = hop_feats[0]
        m = (hop_ids[1] >= 0).float().view(x.shape[0], fan, 1)
        kids = hop_feats[1].view(x.shape[0], fan, -1)
        agg = (kids * m).sum(1) / m.sum(1).clamp_min(1.0)
        out = torch.tanh(x @ ws + agg @ wn + b) + FAULT
        if OP is not None:
            out = getattr(importlib.import_module(OP[0]), OP[1])(out)
        return out

    return infer


def flops_per_seed(cfg):
    d, c, fan = cfg["feat_dim"], cfg["classes"], cfg["fanouts"][0]
    return 2 * 2 * d * c + fan * d
"""

TOY_REFERENCE = """\
\"\"\"The toy model's equations, seed by seed.\"\"\"
import torch


def weights_on(weights_np, device):
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in weights_np.items()}


def embed(w, feats, hops, fanouts, *, tf32=False):
    seeds = hops[0].to(feats.device).long()
    kids = hops[1].to(feats.device).long().view(-1, fanouts[0])
    out = []
    for s, row in zip(seeds.tolist(), kids):
        x = feats[s] if s >= 0 else torch.zeros_like(feats[0])
        valid = row[row >= 0]
        agg = (feats[valid].mean(0) if valid.numel()
               else torch.zeros_like(feats[0]))
        z = w["b"] + (x[:, None] * w["self"]).sum(0) \
            + (agg[:, None] * w["neigh"]).sum(0)
        out.append(torch.tanh(z))
    return torch.stack(out)
"""


# a kernel the program lacks (its wrapper, its source, its library) that
# only the toy architecture launches
TOY_KERNEL = """\
\"\"\"``toy_mix``: what the toy model hands its output to.\"\"\"

MODULE, WRAPPER = "repro_torch.models.gnn_basic", "toy_mix"
BUILD = "toy_mix"
TRACE_NAME = "toy_mix_kernel"
LAUNCHED_BY = ("arch", "toy")


def least_bytes(out):
    return 2 * out.numel() * out.element_size()
"""
TOY_OP = ("repro_torch.models.gnn_basic", "toy_mix")


def _add_toy(bench_dir: Path, *, fault: float = 0.0,
             span: tuple = ("torch", "tanh"), op=None) -> None:
    """The toy architecture and its reference, as files of ``bench_dir``."""
    (bench_dir / "archs" / "toy.py").write_text(TOY_ARCH.format(
        fault=fault, span=span, op=op))
    (bench_dir / "reference" / "toy.py").write_text(TOY_REFERENCE)


def _add_toy_cell(bench: dict, bench_dir: Path) -> str:
    """A configuration of the toy architecture and its closed-loop cell."""
    cfg = dict(_tiny_cfg("lookup_hops", _limits("products-sage3")),
               name="toycfg", arch="toy", fanouts=[4, 3])
    (bench_dir / "configs" / "toycfg.json").write_text(json.dumps(cfg))
    bench["workloads"].append({"name": "toycfg.bulk", "config": "toycfg",
                               "traffic": "tbulk", "chips": 1})
    bench["end_to_end"][1]["workloads"].append("toycfg.bulk")
    return "toycfg.bulk"


@pytest.mark.parametrize("fault", [0.0, 1e-2], ids=["sound", "faulted"])
def test_a_second_architecture_enters_by_new_files(tiny, fault):
    """A toy architecture added as files (its program side, its reference,
    a configuration naming it, a cell of BENCHMARK.json) runs ``correct``
    with no edit of the harness; a fault planted in its ``infer_fn`` fails
    ``embed_err``."""
    bench, bench_dir = tiny
    _add_toy(bench_dir, fault=fault)
    cell = _add_toy_cell(bench, bench_dir)
    line, rows = run.run_cell(bench, cell, SEED, 1.0, False,
                              device=CPU, bench_dir=bench_dir)
    assert set(line["metrics"]) == {"seeds_per_s", "setup_s"}
    failed = {n for n, v, lim in rows if v > lim}
    assert line["correct"] is (not fault), line["checks"]
    assert failed == ({"embed_err"} if fault else set()), line["checks"]


UNKNOWN_ARCH = "no_such_arch"


@pytest.mark.parametrize("change, two_archs", [
    ({"arch": None}, False),
    ({"arch": UNKNOWN_ARCH}, False),
    ({"collect": "lookup_all"}, False),
    ({"arch": None}, True),
    ({"arch": UNKNOWN_ARCH}, True),
    ({"collect": "lookup_all"}, True)],
    ids=["no_arch", "unknown_arch", "collect_not_taken",
         "no_arch_two_archs", "unknown_arch_two_archs",
         "collect_not_taken_two_archs"])
def test_a_configuration_the_archs_cannot_serve_is_refused(tiny, change,
                                                           two_archs):
    """The refusal names the architectures that ``archs/`` holds, or the
    ``collect`` modes the configuration's architecture takes, whichever
    architecture files are there."""
    bench, bench_dir = tiny
    if two_archs:
        _add_toy(bench_dir)
    archs = bench_dir / "archs"
    assert not (archs / f"{UNKNOWN_ARCH}.py").exists()
    known = sorted(p.stem for p in archs.glob("*.py"))
    says = (f"arch {change['arch']!r} is not one of {known}"
            if "arch" in change else
            f"arch 'sage' takes collect "
            f"{list(run.load(bench_dir, 'archs', 'sage').COLLECTS)}, "
            f"not 'lookup_all'")
    spec = run.cell_spec(bench, "tiny.mixed", bench_dir)
    cfg = {k: v for k, v in dict(spec["cfg"], **change).items()
           if v is not None}
    with pytest.raises(SystemExit, match=re.escape(says)):
        run.prepare(cfg, spec["traffic"], SEED, CPU, bench_dir)


@pytest.mark.parametrize("span", [
    ("repro_torch.models.gnn_basic", "toy_layered"),
    ("repro_torch.models.toy", "toy_layered")],
    ids=["function_missing", "module_missing"])
def test_a_model_the_program_lacks_stops_before_set_up(tiny, capsys, span):
    """An architecture whose ``MODEL_SPAN`` names a function the program
    lacks stops in ``arch_of``, naming it, before the graph is drawn."""
    bench, bench_dir = tiny
    _add_toy(bench_dir, span=span)
    spec = run.cell_spec(bench, "tiny.mixed", bench_dir)
    with pytest.raises(SystemExit, match=re.escape(".".join(span))):
        run.prepare(dict(spec["cfg"], arch="toy"), spec["traffic"], SEED,
                    CPU, bench_dir)
    assert "graph" not in capsys.readouterr().err


@pytest.fixture
def toys(tiny):
    """``tiny`` with the toy architecture (which hands its output to the
    program's ``toy_mix``) and a kernel file for ``toy_mix`` that only the
    toy architecture launches: its wrapper, its source and its library are
    all missing from the program."""
    from repro_torch.kernels.build import CSRC
    from repro_torch.models import gnn_basic

    bench, bench_dir = tiny
    assert not hasattr(gnn_basic, "toy_mix")
    assert not (CSRC / "toy_mix.cu").exists()
    _add_toy(bench_dir, op=TOY_OP)
    (bench_dir / "kernels" / "toy_mix.py").write_text(TOY_KERNEL)
    return tiny


@pytest.fixture
def recorded(monkeypatch):
    """Every kernel wrapper a traced run records launches of, by name, with
    the arguments recorded."""
    got = {}

    class Spy(trace.Launches):
        def __exit__(self, *exc):
            got[self.attr] = self.args
            return super().__exit__(*exc)

    monkeypatch.setattr(trace, "Launches", Spy)
    return got


@pytest.mark.parametrize("cell, launched", [
    ("tiny.mixed", "tiered_gather"), ("tiny.bulk", "gather_aggregate")])
def test_a_kernel_the_cell_does_not_launch_is_left_alone(toys, recorded,
                                                         cell, launched):
    """With a kernel file beside the real ones whose wrapper and library
    the program lacks, the tiny cells run traced and ``correct``, report
    the metrics they reported before and record only their own kernel."""
    line, _ = _run(toys, cell, traced=True)
    assert line["correct"] is True, line["checks"]
    if cell == "tiny.mixed":
        assert {"routed_device_share", "p99_ms.host_paced"} <= \
            set(line["metrics"]) <= {"routed_device_share",
                                     "p99_ms.host_paced",
                                     "service_p50_ms.device"}
    else:
        # no device on the CPU: rooflines, mfu and idle share are silent
        assert set(line["metrics"]) == {"collect_ms"}
    assert set(recorded) == {launched}
    assert recorded[launched]


def test_a_cell_selects_the_kernels_its_path_launches(toys):
    bench, bench_dir = toys
    _add_toy_cell(bench, bench_dir)

    def selected(config):
        cfg = run.load_json(bench_dir / "configs" / f"{config}.json")
        return set(run.cell_kernels(cfg, bench_dir))

    assert selected("tiny") == {"tiered_gather"}
    assert selected("tinyagg") == {"gather_aggregate"}
    assert selected("toycfg") == {"tiered_gather", "toy_mix"}


def test_the_toy_cell_records_its_kernel(toys, recorded, monkeypatch):
    """Once the program has ``toy_mix``, the toy architecture's cell
    records its launches beside ``lookup_hops``' gather."""
    from repro_torch.models import gnn_basic

    monkeypatch.setattr(gnn_basic, "toy_mix", lambda out: out.clone(),
                        raising=False)
    bench, bench_dir = toys
    cell = _add_toy_cell(bench, bench_dir)
    line, _ = run.run_cell(bench, cell, SEED, 1.0, True, device=CPU,
                           bench_dir=bench_dir)
    assert line["correct"] is True, line["checks"]
    assert set(recorded) == {"tiered_gather", "toy_mix"}
    assert all(recorded.values())


@pytest.mark.parametrize("decl, says", [
    (None, "LAUNCHED_BY is None"),
    (("arch", UNKNOWN_ARCH), f"LAUNCHED_BY is ('arch', {UNKNOWN_ARCH!r})"),
    (("model", "toy"), "LAUNCHED_BY is ('model', 'toy')"),
    ("lookup_hops", "LAUNCHED_BY is 'lookup_hops'")],
    ids=["missing", "unknown_value", "unknown_key", "not_a_pair"])
def test_a_kernel_declared_for_nothing_known_stops(toys, capsys, decl, says):
    """A kernel file with no ``LAUNCHED_BY``, or one naming what no
    architecture knows, stops every cell before set-up, naming the known
    keys and values: the architectures that ``archs/`` holds and, among
    the ``collect`` modes, those of ``sage``, whichever other
    architecture files are there."""
    bench, bench_dir = toys
    archs = bench_dir / "archs"
    assert not (archs / f"{UNKNOWN_ARCH}.py").exists()
    known = sorted(p.stem for p in archs.glob("*.py"))
    text = TOY_KERNEL.replace('LAUNCHED_BY = ("arch", "toy")\n',
                              "" if decl is None
                              else f"LAUNCHED_BY = {decl!r}\n")
    (bench_dir / "kernels" / "toy_mix.py").write_text(text)
    spec = run.cell_spec(bench, "tiny.mixed", bench_dir)
    with pytest.raises(SystemExit) as stop:
        run.prepare(spec["cfg"], spec["traffic"], SEED, CPU, bench_dir)
    msg = str(stop.value)
    assert msg.startswith(f"kernel 'toy_mix': {says}, not "), msg
    assert msg.endswith(f" or ('arch', one of {known})"), msg
    collects = re.search(r"\('collect', one of (\[[^]]*\])\)", msg)
    assert collects, msg
    assert set(run.load(bench_dir, "archs", "sage").COLLECTS) <= set(
        ast.literal_eval(collects.group(1)))
    assert "graph" not in capsys.readouterr().err


# an architecture and its kernel whose files import what the program
# lacks, as a later program's model would on the parent
BROKEN_ARCH = """\
from repro_torch.models.gnn_basic import no_such_model  # noqa: F401

COLLECTS = ("lookup_hops", "lookup_fused")
MODEL_SPAN = ("repro_torch.models.gnn_basic", "no_such_model")
"""
BROKEN_KERNEL = """\
from repro_torch.core.no_such_module import attend  # noqa: F401

MODULE, WRAPPER = "repro_torch.core.no_such_module", "attend"
BUILD = "no_such_attend"
TRACE_NAME = "no_such_attend_kernel"
LAUNCHED_BY = ("arch", "broken")
"""


def test_files_the_program_cannot_import_leave_other_cells_alone(tiny,
                                                                 recorded):
    """An ``archs/`` file and a ``kernels/`` file that import what the
    program lacks at their top level are read, not imported, by a cell of
    another architecture: the tiny cells run traced and ``correct`` and
    record only their own kernel; a kernel may name a ``collect`` that
    only the new architecture takes."""
    bench, bench_dir = tiny
    (bench_dir / "archs" / "broken.py").write_text(BROKEN_ARCH)
    (bench_dir / "kernels" / "broken_attend.py").write_text(BROKEN_KERNEL)
    (bench_dir / "kernels" / "fused.py").write_text(BROKEN_KERNEL.replace(
        '("arch", "broken")', '("collect", "lookup_fused")'))
    for cell, launched in (("tiny.mixed", "tiered_gather"),
                           ("tiny.bulk", "gather_aggregate")):
        recorded.clear()
        line, _ = _run(tiny, cell, traced=True)
        assert line["correct"] is True, line["checks"]
        assert set(recorded) == {launched}


def test_a_declaration_that_is_not_a_literal_stops(toys):
    """``LAUNCHED_BY`` is read without importing its file, so it has to
    be a literal."""
    bench, bench_dir = toys
    (bench_dir / "kernels" / "toy_mix.py").write_text(TOY_KERNEL.replace(
        'LAUNCHED_BY = ("arch", "toy")',
        'LAUNCHED_BY = tuple(["arch", "toy"])'))
    cfg = run.load_json(bench_dir / "configs" / "tiny.json")
    with pytest.raises(SystemExit, match=re.escape(
            "toy_mix.py: LAUNCHED_BY is not a literal: "
            "tuple(['arch', 'toy'])")):
        run.cell_kernels(cfg, bench_dir)


def test_the_roofline_of_a_kernel_not_recorded_reads_none():
    """The least bytes of the first recorded launches over the device time
    of as many of the kernel's first launches in the trace; ``None`` for a
    kernel the cell did not record, or without a trace."""
    kerns = {k: run.load(BENCH_DIR, "kernels", k)
             for k in ("tiered_gather", "gather_aggregate")}
    red = {"kernels": [("void tiered_gather_kernel<16>", 30.0, 4.0),
                       ("void gather_aggregate_kernel<float>", 5.0, 9.0),
                       ("void tiered_gather_kernel<16>", 10.0, 2.0)]}
    launch_bytes = {"tiered_gather": [3.35e6]}
    # one recorded launch: the trace's first, 2 us, at 3.35 TB/s: 50%
    assert run.roofline(red, kerns, launch_bytes, "tiered_gather",
                        3.35e12) == pytest.approx(50.0)
    assert run.roofline(red, kerns, launch_bytes, "gather_aggregate",
                        3.35e12) is None
    assert run.roofline(None, kerns, launch_bytes, "tiered_gather",
                        3.35e12) is None


def test_sage_draws_the_weights_inputs_draws():
    sage = run.load(BENCH_DIR, "archs", "sage")
    cfg = _tiny_cfg("lookup_hops", {})
    got = sage.weights(cfg, SEED, CPU)
    want = inputs.sage_weights([16, 32, 32, 8], SEED, CPU)
    assert len(got["layers"]) == len(want["layers"]) == 3
    for g, w in zip(got["layers"], want["layers"]):
        for part in ("self", "neigh", "ln"):
            for k in w[part]:
                assert g[part][k].dtype == w[part][k].dtype
                assert np.array_equal(g[part][k], w[part][k]), (part, k)


def _old_compare(cfg, graph, feats_np, weights_np, items, device):
    """``check.compare`` before architectures were found by name, without
    the control: GraphSAGE's reference called directly."""
    ref_ = types.SimpleNamespace(**{**vars(sample), **vars(ref)})
    ref_.no_tf32()
    fanouts = list(cfg["fanouts"])
    g = ref_.Graph(graph.indptr, graph.indices, graph.num_nodes, device)
    feats = torch.as_tensor(feats_np, device=device)
    w = ref_.weights_on(weights_np, device)
    out = {"uncaptured": 0, "hops_invalid": 0, "feature_mismatch": 0,
           "agg_err": 0.0, "embed_err": 0.0}
    for seeds, result, records in items:
        if not records:
            out["uncaptured"] += 1
            continue
        seeds_t = torch.as_tensor(seeds)
        lo = 0
        for rec in records:
            chunk = min(int(rec.hops[0].shape[0]), int(seeds_t.shape[0]) - lo)
            out["hops_invalid"] += ref_.invalid_hops(
                g, rec.hops, seeds_t[lo:lo + chunk], fanouts)
            for k, (pos, got) in enumerate(zip(rec.feat_pos, rec.feat_rows)):
                want = ref_.rows(feats, rec.hops[k][pos])
                out["feature_mismatch"] += int(
                    (got.to(device) != want).sum())
            if rec.agg_pos is not None:
                fan = fanouts[-1]
                parents = rec.hops[-2][rec.agg_pos]
                child = rec.hops[-1].view(-1, fan)[rec.agg_pos].reshape(-1)
                want = ref_.fan_sums(feats, parents, child, fan)
                gap = (rec.agg_rows.to(device) - want).abs().max()
                out["agg_err"] = max(out["agg_err"], float(gap))
            want = ref_.embed(w, feats, rec.hops, fanouts)[:chunk]
            got = torch.as_tensor(result[lo:lo + chunk]).to(device)
            out["embed_err"] = max(out["embed_err"],
                                   float((got - want).abs().max()))
            lo += chunk
        if lo != int(seeds_t.shape[0]):
            out["uncaptured"] += 1
    return out


@pytest.mark.parametrize("cell", ["tiny.mixed", "tiny.bulk"])
def test_the_checks_match_the_old_call_path(tiny, monkeypatch, cell):
    """On the sample a run captured, the checks read as the direct
    GraphSAGE calls read them, and ``archs/sage``'s ``infer_fn`` is the
    launcher's ``make_infer_fn(sage_from_numpy(...))`` bit for bit."""
    from repro_torch.launch.serve import make_infer_fn
    from repro_torch.models.gnn_basic import sage_from_numpy

    got = {}
    compare = check.compare

    def keep(ref_, cfg, graph, feats, weights, items, device, **kw):
        got["args"] = (cfg, graph, feats, weights, items)
        return compare(ref_, cfg, graph, feats, weights, items, device,
                       **kw)

    monkeypatch.setattr(check, "compare", keep)
    line, rows = _run(tiny, cell)
    cfg, graph, feats, weights, items = got["args"]
    assert any(recs for _, _, recs in items)
    old = _old_compare(cfg, graph, feats, weights, items, CPU)
    assert {n: v for n, v, _ in rows if n != "unanswered"} == \
        {n: old[n] for n, _, _ in rows if n != "unanswered"}
    fanouts = cfg["fanouts"]
    new_fn = run.load(tiny[1], "archs", "sage").infer_fn(cfg, weights, CPU)
    old_fn = make_infer_fn(sage_from_numpy(weights, device=CPU), fanouts)
    feats_t = torch.as_tensor(feats)
    for _, _, records in items:
        for rec in records:
            hop_feats = [sample.rows(feats_t, h) for h in rec.hops]
            deep = None
            if cfg["collect"] == "lookup_aggregate":
                deep = sample.fan_sums(feats_t, rec.hops[-2], rec.hops[-1],
                                       fanouts[-1])
                hop_feats = hop_feats[:-1]
            a = new_fn(hop_feats, rec.hops, deep_agg=deep)
            b = old_fn(hop_feats, rec.hops, deep_agg=deep)
            assert torch.equal(a, b)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``repro_torch`` is allowed in the
    harness, ``repro`` nowhere; the reference imports nothing of the
    program. A run in a fresh process loads none of them either."""
    for path in BENCH_DIR.rglob("*.py"):
        names = _imports(path)
        assert not names & set(run.FORBIDDEN), path
        if "reference" in path.parts:
            assert "repro_torch" not in names, path
    code = (
        "import sys, json, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from servebench import run\n"
        "b = run.load_json(run.ROOT / 'BENCHMARK.json')\n"
        "spec = run.cell_spec(b, 'products-sage3.mixed', run.BENCH_DIR)\n"
        "cfg = dict(spec['cfg'], nodes=1500, num_edges=9000, feat_dim=8,\n"
        "           hidden=[8], classes=4, fanouts=[3, 2],\n"
        "           topology=dict(rows_per_device=400, rows_host=700,\n"
        "                         hot_frac=0.25),\n"
        "           executor=dict(spec['cfg']['executor'], max_batch=16))\n"
        "tr = dict(spec['traffic'], sizes=dict(law='fixed', n=4))\n"
        "p = run.prepare(cfg, tr, 5, torch.device('cpu'))\n"
        "res = run.drive(p, dict(tr, rate_rps=20.0), 0.3, 5)\n"
        "run.answers(p, res, torch.device('cpu'))\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_harness_refuses_without_the_program_or_a_card(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files it exits 2 and prints no result."""
    shutil.copytree(BENCH_DIR, tmp_path / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "servebench/run.py", "--workload",
         "products-sage3.mixed", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_flops_a_seed_match_the_hand_worked_counts():
    assert costs.sage_flops_per_seed([100, 256, 256, 47],
                                     [15, 10, 5]) == 21_378_412
    assert costs.sage_flops_per_seed([602, 256, 41], [25, 10]) == 16_241_582


def test_kernel_costs_count_distinct_rows_once():
    assert costs.tiered_gather_cost(10, 4, 4, read_rows=3) == {
        "flops": 0, "bytes": 8 * 10 + 3 * 16 + 10 * 16}
    assert costs.gather_aggregate_cost(2, 5, 4, 4, read_rows=6,
                                       valid=8) == {
        "flops": 32, "bytes": 8 * 10 + 6 * 16 + 2 * 16}
    hot = torch.zeros(8, 4)
    tier = torch.tensor([0, 0, 1, 1, 2, 0], dtype=torch.int32)
    slot = torch.tensor([3, 3, 3, 1, 5, 0], dtype=torch.int32)
    # distinct device rows (0,3), (1,3), (1,1), (0,0); tier 2 reads none
    assert costs.tiered_gather_bytes(tier, slot, hot, hot) == \
        8 * 6 + 4 * 16 + 6 * 16
    seg_t = torch.tensor([[0, 2, 99], [2, 2, 1]], dtype=torch.int32)
    seg_s = torch.tensor([[1, 0, 0], [0, 1, 1]], dtype=torch.int32)
    # valid children 5, distinct rows (0,1), (2,0), (2,1), (1,1)
    assert costs.gather_aggregate_bytes(seg_t, seg_s, hot, hot, hot) == \
        8 * 6 + 4 * 16 + 2 * 16


def test_every_seed_gets_the_same_sizes_and_gaps():
    law = inputs.SeedLaw(np.arange(1, 101), "out_degree")
    mix = {"rate_rps": 30.0, "arrivals": "poisson",
           "sizes": {"law": "log_uniform_int", "lo": 1, "hi": 1024}}
    a = inputs.open_schedule(mix, law, 10.0, 1, 8)
    b = inputs.open_schedule(mix, law, 10.0, 2**31 + 3, 8)
    assert sorted(map(len, a.seeds)) == sorted(map(len, b.seeds))
    assert len(a.seeds) == len(b.seeds) == 300
    assert (np.diff(a.due) > 0).all() and 9.0 < a.due[-1] < 10.0
    big = int(np.argmax([len(s) for s in a.seeds]))
    assert big in a.checked and len(a.checked) == 8


def test_the_graph_law_is_drawn_from_the_seed():
    g1 = inputs.power_law_graph(3000, 30000, 1.6, 7, CPU)
    g2 = inputs.power_law_graph(3000, 30000, 1.6, 7, CPU)
    assert np.array_equal(g1.indices, g2.indices)
    src = np.repeat(np.arange(3000), g1.out_degree)
    assert not (src == g1.indices).any()
    assert 29000 < g1.num_edges <= 30000
    # zipf-ranked popularity: the most popular target takes a large share
    assert np.bincount(g1.indices).max() > 0.2 * g1.num_edges


def test_every_seed_gets_the_same_out_degrees():
    g1 = inputs.power_law_graph(3000, 30000, 1.6, 7, CPU)
    g2 = inputs.power_law_graph(3000, 30000, 1.6, 2**31 + 5, CPU)
    d1, d2 = inputs.out_degrees(3000, 30000), g1.out_degree
    assert d1.sum() >= 30000 and (d1 >= 1).all()
    # the multiset is fixed; only self loops, dropped, tell the seeds apart
    assert abs(np.sort(d2) - np.sort(d1)).sum() <= d1.sum() - g1.num_edges
    assert not np.array_equal(g1.out_degree, g2.out_degree)
    assert abs(g1.num_edges - g2.num_edges) < 100


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5001, 5002, 5003])
def test_control_fails_on_the_card_at_the_cell_size(card, seed):
    """reddit-sage2.bulk at its own size on the card: the program's
    readings pass their limits, the lower-precision control fails them."""
    spec = run.cell_spec(run.load_json(ROOT / "BENCHMARK.json"),
                         "reddit-sage2.bulk", BENCH_DIR)
    prep = run.prepare(spec["cfg"], spec["traffic"], seed, card)
    res = run.drive(prep, spec["traffic"], 4.0, seed)
    r = run.answers(prep, res, card, control=True)
    lim = spec["cfg"]["limits"]
    assert r["hops_invalid"] == 0 and r["feature_mismatch"] == 0
    assert r["embed_err"] <= lim["embed_err"] < r["control_embed_err"]
    assert r["agg_err"] <= lim["agg_err"] < r["control_agg_err"]
