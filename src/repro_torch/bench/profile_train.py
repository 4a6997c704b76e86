"""Where a GNN training step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.bench.profile_train \\
        [--arch gin-tu|schnet|meshgraphnet|equiformer-v2] \\
        [--out profile_train.json]

``gin-tu`` (default) runs at the ``ogb_products`` shape; the geometric
architectures at the training launcher's default graph (4,096 nodes,
32,768 edges, d_feat 64, 16 classes) and at their published widths
(``_init``: EquiformerV2 with 12 layers, 128 channels, l_max 6). The
launcher's step is run by hand, one stage at a time, each ending in a
device synchronize:

* ``batch`` — ``make_concrete_batch`` on the host (numpy draws);
* ``h2d`` — the batch's copy to the card;
* ``ell`` — (GIN-TU) the forward and transposed ELL tables (``ell_pair``);
* ``forward`` — the model and the loss (GIN-TU: 5 ``segment_spmm``
  launches);
* ``backward`` — gradients (GIN-TU: 4 ``segment_spmm`` launches; the
  geometric models recompute each layer first);
* ``optimizer`` — the AdamW update.

Step 0 warms up (kernel build and load, cuBLAS handles); the next
``TIMED_STEPS`` steps give the stage times (median); one more step runs
under ``torch.profiler`` for the device's busy time and idle share
(``1 - busy / wall``) over the whole step and over its device part (from
the copy on), and the device time of the costliest activities.

For ``equiformer-v2`` one more forward, without autograd, runs stage by
stage with CUDA events around each stage of each layer, summed over the
layers (``EQ_STAGES``): ``geometry`` (edge vectors, the rotation blocks
and the radial basis, once a step), ``norm_gather`` (the equivariant
layer norm and the source rows), ``rotate`` (into the edge frames and
back), ``so2`` (the radial MLP and the SO(2) products), ``attention``
(the logit MLP and the capped weights), ``message_sum`` (the two
``segment_sum``), ``finalize`` (the normalization and ``out_proj``),
``ffn`` and ``head``. The report gives its largest difference from the
model's own forward on the same batch (the message sums add by atomics,
so not bit for bit).

Prints one JSON object and, with ``--out``, writes it to that file. Needs
a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.bench.profile_lm import _Stages
from repro_torch.configs import gin_tu
from repro_torch.configs.gnn_common import (SHAPES, classification_loss,
                                            make_concrete_batch)
from repro_torch.graph.segment import segment_sum
from repro_torch.kernels import segment_spmm as sp
from repro_torch.launch import train as train_launcher
from repro_torch.models import equiformer_v2 as eq
from repro_torch.models.equiformer_v2 import (_eq_layer_norm, _ffn_block,
                                              _rbf, _rotate, infer_cfg)
from repro_torch.models.gnn_basic import gin_full_graph
from repro_torch.models.so3 import edge_rotation_blocks, num_coeffs
from repro_torch.training import AdamW

EQ_STAGES = ("geometry", "norm_gather", "rotate", "so2", "attention",
             "message_sum", "finalize", "ffn", "head")
TIMED_STEPS = 2


def _stamp(stamps: list, dev: torch.device) -> None:
    torch.cuda.synchronize(dev)
    stamps.append(time.perf_counter())


def one_step(model, opt, opt_state, info: dict, seed: int,
             dev: torch.device, arch: str = "gin-tu"):
    """One training step stage by stage; returns (new optimizer state,
    stage → seconds, stage → segment_spmm launches)."""
    params = dict(model.named_parameters())
    stamps, launches = [time.perf_counter()], {}

    def stage(name):
        _stamp(stamps, dev)
        launches[name] = sp.LAUNCHES.value
        sp.LAUNCHES.reset()

    sp.LAUNCHES.reset()
    host = make_concrete_batch(info, seed=seed, device="cpu")
    stage("batch")
    batch = {k: v.to(dev) for k, v in host.items()}
    stage("h2d")
    if arch == "gin-tu":
        ell = sp.ell_pair(batch["src"], batch["dst"], info["nodes"])
        stage("ell")
        logits = gin_full_graph(model, batch["node_feat"], batch["src"],
                                batch["dst"], num_nodes=info["nodes"],
                                ell=ell)
        loss = classification_loss(logits, batch["labels"])
    else:
        loss = train_launcher.ADAPTERS[arch]._loss(model, batch, info,
                                                   "custom")
    stage("forward")
    grads = torch.autograd.grad(loss, list(params.values()))
    stage("backward")
    _, opt_state = opt.update(dict(zip(params, grads)), opt_state, params)
    stage("optimizer")
    secs = {k: b - a for k, a, b in zip(launches, stamps, stamps[1:])}
    return opt_state, secs, launches


@torch.no_grad()
def staged_equiformer(model, batch: dict, info: dict, st=None
                      ) -> tuple[torch.Tensor, dict[str, float]]:
    """``equiformer_forward`` (one edge chunk) stage by stage under CUDA
    events (``st``, a ``_Stages`` over ``EQ_STAGES`` by default);
    returns the node outputs and ms by stage."""
    cfg = infer_cfg(model)
    l_max, C, H = cfg["l_max"], cfg["channels"], cfg["n_heads"]
    N = info["nodes"]
    st = st if st is not None else _Stages(EQ_STAGES)
    st.start("geometry")
    h0 = model.embed[batch["species"].long().clamp(
        0, model.embed.shape[0] - 1)] + model.feat_proj(batch["node_feat"])
    x = torch.cat([h0[:, None, :],
                   h0.new_zeros((N, num_coeffs(l_max) - 1, C))], dim=1)
    src, dst = batch["src"].long(), batch["dst"].long()
    valid = (src >= 0) & (dst >= 0)
    s, d = src.clamp_min(0), dst.clamp_min(0)
    rij = batch["positions"][d] - batch["positions"][s]
    dist = torch.sqrt((rij ** 2).sum(-1) + 1e-12)
    D, Dinv = edge_rotation_blocks(rij / torch.clamp(dist, min=1e-6)[:, None],
                                   l_max)
    rbf = _rbf(dist, cfg["n_rbf"], cfg["cutoff"])
    st.stop()
    for p in model.layers:
        st.start("norm_gather")
        h_src = _eq_layer_norm(p.ln1_g, x, l_max)[s]
        st.stop()
        st.start("rotate")
        x_rot = _rotate(D, h_src, l_max)
        st.stop()
        st.start("so2")
        blocks = p.so2.blocks(x_rot, F.silu(p.rad(rbf)))
        y = p.so2.assemble(blocks)
        st.stop()
        st.start("attention")
        E, S = y.shape[:2]
        logits = p.alpha(blocks[0].reshape(E, -1))
        w = torch.where(valid[:, None],
                        torch.exp(10.0 * torch.tanh(logits / 10.0)), 0.0)
        y = (y.reshape(E, S, H, C // H) * w[:, None, :, None]).reshape(E, S,
                                                                        C)
        st.stop()
        st.start("rotate")
        msg = torch.where(valid[:, None, None], _rotate(Dinv, y, l_max), 0.0)
        st.stop()
        st.start("message_sum")
        num, den = segment_sum(msg, d, N), segment_sum(w, d, N)
        st.stop()
        st.start("finalize")
        x = x + eq._attention_finalize(p, cfg, num, den)
        st.stop()
        st.start("ffn")
        x = x + _ffn_block(p, cfg, x)
        st.stop()
    st.start("head")
    out = model.out2(F.silu(model.out1(x[:, 0, :])))
    st.stop()
    return out, st.totals()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="repro_torch.bench.profile_train")
    p.add_argument("--arch", default="gin-tu",
                   choices=sorted(train_launcher.ADAPTERS))
    p.add_argument("--out", default=None, help="write the report here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    if args.arch == "gin-tu":
        info = SHAPES["ogb_products"]
        model = gin_tu._init(gen, info["d_feat"], info["classes"], "custom",
                             device=dev)
    else:
        d = train_launcher.parse_args(["--arch", args.arch])
        info = dict(nodes=d.nodes, edges=d.edges, d_feat=d.d_feat,
                    classes=d.classes, graphs=None)
        model = train_launcher.ADAPTERS[args.arch]._init(
            gen, info["d_feat"], info["classes"], "custom", device=dev)
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    opt_state = opt.init(dict(model.named_parameters()))

    opt_state, _, _ = one_step(model, opt, opt_state, info, 0, dev,
                               args.arch)
    torch.cuda.reset_peak_memory_stats(dev)
    timed = []
    for s in range(TIMED_STEPS):
        opt_state, secs, launches = one_step(model, opt, opt_state, info,
                                             1 + s, dev, args.arch)
        timed.append(secs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt_state, secs, _ = one_step(model, opt, opt_state, info,
                                      1 + TIMED_STEPS, dev, args.arch)
        wall = time.perf_counter() - t0
    busy_us, by_name = 0.0, defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            by_name[e.name] += us
    device_wall = wall - secs["batch"]
    report = {
        "card": torch.cuda.get_device_name(0), "arch": args.arch,
        "params": sum(p.numel() for p in model.parameters()), "shape": info,
        "timed_steps": TIMED_STEPS,
        "stage_p50_ms": {k: statistics.median(t[k] for t in timed) * 1e3
                         for k in timed[0]},
        "step_p50_ms": statistics.median(sum(t.values())
                                         for t in timed) * 1e3,
        "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "profiled_step_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_idle_share_after_batch": 1.0 - busy_us / 1e6 / device_wall,
        "top_device_ms": {name: us / 1e3 for name, us in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:8]},
    }
    if args.arch == "gin-tu":
        report["segment_spmm_launches"] = launches
    if args.arch == "equiformer-v2":
        batch = make_concrete_batch(info, seed=1 + TIMED_STEPS, device=dev)
        staged, stage_ms = staged_equiformer(model, batch, info)
        with torch.no_grad():
            want = eq.equiformer_forward(
                model, batch["species"], batch["positions"], batch["src"],
                batch["dst"], num_nodes=info["nodes"],
                node_feat=batch["node_feat"])
        report["forward_stage_ms"] = stage_ms
        report["staged_forward_ms"] = sum(stage_ms.values())
        report["staged_max_abs_diff"] = float((staged - want).abs().max())
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
