"""§Roofline report: for each (arch × shape × mesh) of the dry-run's
output (:mod:`repro_torch.launch.dryrun`), the three roofline terms, the
dominant bound, and the analytic model FLOPs over the counted FLOPs —
ported from ``benchmarks/roofline.py``.

    PYTHONPATH=src python -m repro_torch.bench.run --only roofline

Reads ``artifacts/dryrun_torch.json``; prints a ``roofline/skipped`` row
when it is missing. Nothing runs on a device.
"""
from __future__ import annotations

import json
import os

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.bench.common import emit

DRYRUN_JSON = "artifacts/dryrun_torch.json"
# attention + main MLP parameters of DIN (tables excluded): the
# reference's constant
DIN_DENSE_PARAMS = 3.3e5


def model_flops(arch: str, shape: str) -> float:
    """The reference's analytic MODEL_FLOPS of one step: 6·N_active·tokens
    for LM training, 2·N_active·tokens for a prefill, 2·N_active·batch for
    a decode; DIN 2·dense params·(examples × history), ×3 to train; a GNN
    2·P·(N+E)/10·3 (parameters touched per node and edge, trained)."""
    from repro_torch.configs import LM_ARCHS, get_arch
    from repro_torch.models.common import count_params
    from repro_torch.models.transformer import lm_active_param_count

    if arch in LM_ARCHS:
        from repro_torch.configs.lm_common import SHAPES
        n_active = lm_active_param_count(LM_ARCHS[arch])
        info = SHAPES[shape]
        if info["kind"] == "train":
            return 6.0 * n_active * info["batch"] * info["seq"]
        if info["kind"] == "prefill":
            return 2.0 * n_active * info["batch"] * info["seq"]
        return 2.0 * n_active * info["batch"]
    if arch == "din":
        from repro_torch.configs.din import CONFIG, SHAPES
        info = SHAPES[shape]
        n = info.get("candidates", info["batch"]) * CONFIG.hist_len
        mult = 3.0 if info["kind"] == "train" else 1.0
        return 2.0 * DIN_DENSE_PARAMS * n * mult
    from repro_torch.configs.gnn_common import SHAPES
    info = SHAPES[shape]
    with FakeTensorMode():
        model = get_arch(arch).adapter.init(
            torch.Generator(), info["d_feat"], info["classes"] or 1, shape,
            device="cpu")
    p = count_params(model)
    return 2.0 * p * (info["nodes"] + info["edges"]) / 10.0 * 3.0


def load(path: str = DRYRUN_JSON) -> list[dict]:
    """The dry-run's records that ended ``ok``."""
    with open(path) as f:
        return [r for r in json.load(f) if r["ok"]]


def flops_ratio(r: dict) -> float:
    """Model FLOPs a device over the counted FLOPs a device."""
    mf = model_flops(r["arch"], r["shape"]) / r["world"]
    return mf / max(r["cost"]["flops"], 1.0)


def run(path: str = DRYRUN_JSON, device: str = "cuda") -> dict:
    """One row a record: the step's lower bound (µs), its dominant term,
    the bound's share of the three terms' sum, and model/counted FLOPs.
    ``device`` is the runner's and unused: this module reads a file."""
    if not os.path.exists(path):
        print(f"roofline/skipped,0,{path} missing")
        return {"skipped": True}
    recs = load(path)
    for r in recs:
        ro = r["roofline"]
        emit(f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}",
             ro["step_lower_bound_s"] * 1e6,
             f"dom={ro['dominant']};frac={ro['roofline_fraction']:.2f};"
             f"model/counted_flops={flops_ratio(r):.2f}")
    return {"records": len(recs)}


def markdown_table(path: str = DRYRUN_JSON) -> str:
    lines = ["| arch | shape | mesh | compute (ms) | memory (ms) | "
             "collective (ms) | dominant | HBM GiB/dev | model/counted "
             "FLOPs |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in load(path):
        ro = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {ro['compute_s'] * 1e3:.2f} | {ro['memory_s'] * 1e3:.2f} "
            f"| {ro['collective_s'] * 1e3:.2f} "
            f"| {ro['dominant'].replace('_s', '')} "
            f"| {r['memory']['peak_hbm_bytes'] / 2**30:.2f} "
            f"| {flops_ratio(r):.2f} |")
    return "\n".join(lines)


if __name__ == "__main__":
    run()
