"""Roofline terms of one dry-run cell, and a model of its collectives —
the counterpart of ``src/repro/launch/hlo_analysis.py`` (the name is
kept so that a reader finds it).

The reference parses the optimized HLO of a compiled SPMD program and
sums the operands of every collective it finds. The port has no compiler
that places collectives, so :func:`model_collectives` **models, and does
not parse**, the collectives one step of a cell would make under its
sharding rules (:mod:`repro_torch.sharding`), with the reference's ring
weights for a group of ``g`` devices (bytes on the wire a device):
all-gather ``S·(g-1)/g`` of the gathered size ``S``, all-reduce
``2·S·(g-1)/g``, reduce-scatter ``S·(g-1)/g`` of the input size, all-to-all
``S·(g-1)/g`` of the buffer.

Modeled, a device and a step:
  * LM: the parameter all-gathers over the FSDP axes (once a serve step;
    twice a micro-batch in training, forward and recomputed backward);
    the gradients' reduce-scatter over the data axes each micro-batch,
    plus under ZeRO-1 (dense archs: weights replicated over the data
    axes, the optimizer state sharded, ``lm_common.py:147-157`` of the
    reference) one all-gather of the updated weights; two tensor-parallel
    all-reduces of ``(B_local, S, d)`` a layer forward and two backward;
    the MoE's all-to-all of its ``(E, cap, d)`` buffer at dispatch and at
    combine (twice more backward); the vocab-parallel embedding's
    all-reduce of ``(B_local, S, d)`` and, in training, the loss's
    log-sum-exp all-reduce of two fp32 numbers a position.
  * GNN: each layer's all-gather of the ``(N, w)`` source rows and
    reduce-scatter of the sums to the destination owners, or, on the halo
    cell, one all-to-all of ``world·cap_pp`` rows of ``w`` (and their
    int32 ids) a layer; both again backward; the replicated parameters'
    gradient all-reduce.
  * DIN: the exchange of the looked-up item and category rows (and their
    ids) within the "model" group that row-shards the tables (again
    backward in training), and the MLPs' gradient all-reduce over the
    data axes.

Constants are NVIDIA's H100 SXM5 80GB data sheet at 700 W.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.sharding import mesh_axis_size, shard_factor, spec_entry

# dense peaks; TF32 stays off in the port, so fp32 products run on the
# CUDA cores
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s a direction, within one 8-card node
NET_BW = 50e9                # bytes/s across nodes: one 400 Gb/s NIC a card
NODE_CARDS = 8               # cards joined by NVLink in one node

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_kind: dict           # ring-weighted per-device bytes on the wire
    bw: float = NET_BW            # the rate the collective term divides by

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def collective_bw(group: int) -> float:
    """The per-direction rate of a collective over ``group`` devices: a
    group that spans more than one 8-card node crosses the network. On
    both production meshes every group does (each axis is 16 wide and
    strides across nodes), so their collectives run at ``NET_BW``."""
    return NVLINK_BW if group <= NODE_CARDS else NET_BW


class _Tally:
    def __init__(self):
        self.counts = {k: 0 for k in _COLLECTIVES}
        self.bytes = {k: 0.0 for k in _COLLECTIVES}
        self.groups: list[int] = []

    def add(self, kind: str, size: float, g: int, times: int = 1) -> None:
        """``times`` collectives of ``kind`` over ``g`` devices, each of
        ``size`` bytes (gathered size, buffer, or reduce input)."""
        if g <= 1 or times <= 0 or size <= 0:
            return
        ring = (g - 1) / g
        wire = {"all-gather": size * ring, "all-reduce": 2.0 * size * ring,
                "reduce-scatter": size * ring, "all-to-all": size * ring,
                "collective-permute": size}[kind]
        self.counts[kind] += times
        self.bytes[kind] += wire * times
        self.groups.append(g)

    def stats(self) -> CollectiveStats:
        bw = min((collective_bw(g) for g in self.groups), default=NET_BW)
        return CollectiveStats(self.counts, self.bytes, bw)


def _named(tree) -> dict:
    """``{parameter name: NamedSharding}`` of a cell's model shardings."""
    return tree if isinstance(tree, dict) else {}


def model_collectives(cell, mesh, rules) -> CollectiveStats:
    """The collectives one step of ``cell`` makes on ``mesh`` under
    ``rules``, modeled as the module docstring says (none without a mesh
    or at world 1)."""
    tally = _Tally()
    if mesh is None or cell.in_shardings is None:
        return tally.stats()
    family = cell.meta["family"]
    if family == "lm":
        _lm(tally, cell, mesh, rules)
    elif family == "gnn":
        _gnn(tally, cell, mesh)
    else:
        _din(tally, cell, mesh, rules)
    return tally.stats()


def _lm(tally: _Tally, cell, mesh, rules) -> None:
    from repro_torch.models.moe import capacity
    cfg, info = cell.meta["cfg"], cell.meta["info"]
    micro = cell.meta["micro"]
    train = info["kind"] == "train"
    model = cell.args[0]
    params = dict(model.named_parameters())
    weights = _named(cell.in_shardings[0])
    fsdp = spec_entry(rules.axis("fsdp"))      # as a spec names it
    g_fsdp = mesh_axis_size(mesh, fsdp) if fsdp else 1
    tp = mesh_axis_size(mesh, rules.axis("tp")) if rules.axis("tp") else 1
    batch_div = shard_factor(mesh, cell.meta["batch_spec"])
    b_local = info["batch"] // batch_div
    s_eff = info["seq"] if info["kind"] in ("train", "prefill") else 1
    tokens = b_local // micro * s_eff
    act = torch.empty((), dtype=cfg.adtype).element_size()

    if train:
        opt = _named(cell.in_shardings[1].mu)
        for name, p in params.items():
            # gradients: reduce-scatter onto the optimizer state's shards
            s = opt[name].spec if name in opt else ()
            if fsdp and fsdp in s:
                share = shard_factor(mesh, s) / g_fsdp   # the other axes
                tally.add("reduce-scatter", p.numel() * 4 / share, g_fsdp,
                          micro)
                if cell.meta["zero1"]:      # the updated weights back
                    tally.add("all-gather", p.nbytes / share, g_fsdp)
    for name, p in params.items():
        s = weights[name].spec if name in weights else ()
        if fsdp and fsdp in s:
            gathered = p.nbytes / (shard_factor(mesh, s) / g_fsdp)
            tally.add("all-gather", gathered, g_fsdp,
                      2 * micro if train else 1)
    passes = 2 if train else 1           # forward, and backward
    tally.add("all-reduce", tokens * cfg.d_model * act, tp,
              2 * cfg.n_layers * passes * micro)
    tally.add("all-reduce", tokens * cfg.d_model * act, tp, passes * micro)
    if train:
        tally.add("all-reduce", tokens * 2 * 4, tp, micro)
    if cfg.moe is not None:
        g_e = mesh_axis_size(mesh, rules.axis("expert"))
        cap = capacity(tokens, cfg.moe)
        buf = cfg.moe.num_experts * cap * cfg.d_model * act
        tally.add("all-to-all", buf, g_e, 2 * cfg.n_layers * passes * micro)


def _gnn(tally: _Tally, cell, mesh) -> None:
    info, meta = cell.meta["info"], cell.meta
    layers, width = meta["exchange"]
    world = mesh_axis_size(mesh, tuple(mesh.shape))
    if shard_factor(mesh, meta["batch_spec"]) == 1:
        return                       # replicated batch: no exchange
    if meta["halo"]:
        rows = world * meta["cap_pp"]
        tally.add("all-to-all", rows * (width * 4 + 4), world, 2 * layers)
    else:
        rows = info["nodes"] * width * 4
        tally.add("all-gather", rows, world, 2 * layers)
        tally.add("reduce-scatter", rows, world, 2 * layers)
    grads = sum(p.nbytes for p in cell.args[0].parameters())
    tally.add("all-reduce", grads, world)


def _din(tally: _Tally, cell, mesh, rules) -> None:
    cfg, info = cell.meta["cfg"], cell.meta["info"]
    g_rows = mesh_axis_size(mesh, rules.axis("rows"))
    div = shard_factor(mesh, cell.meta["batch_spec"])
    if info["kind"] == "retrieval":
        lookups = info["candidates"] // div + cfg.hist_len
    else:
        lookups = info["batch"] // div * (cfg.hist_len + 1)
    train = info["kind"] == "train"
    row = 2 * (cfg.embed_dim * 4 + 4)           # item + category, with ids
    tally.add("all-to-all", lookups * row, g_rows, 2 if train else 1)
    if train:
        dp = rules.axis("batch")
        mlp = sum(p.nbytes for n, p in cell.args[0].named_parameters()
                  if not n.endswith("_embed"))
        tally.add("all-reduce", mlp, mesh_axis_size(mesh, dp) if dp else 1)


def roofline_terms(*, flops: float, bytes_accessed: float,
                   collective_bytes: float, collective_bw: float = NET_BW,
                   dtype: torch.dtype = torch.float32) -> dict:
    """All inputs are per-device quantities of one step; ``dtype`` picks
    the peak (:data:`PEAK_FLOPS`) the operations divide by."""
    compute_s = flops / PEAK_FLOPS[dtype]
    memory_s = bytes_accessed / HBM_BW
    collective_s = collective_bytes / collective_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return {**terms, "dominant": dominant,
            "roofline_fraction": (bound / total) if total > 0 else 0.0,
            "step_lower_bound_s": bound}
