"""The port's halo exchange (``repro_torch.core.halo``) and its
halo-sharded GIN-TU and EquiformerV2 losses against the JAX package, on
the CPU.

The reference runs inside ``shard_map`` over 8 fake host devices, so its
side runs once, in one subprocess for the module (``ref``): its
``halo_gather`` on three cases, GIN-TU's sharded loss and its gradients
(``jax.grad`` through the ``shard_map``) at two capacities, and
EquiformerV2's sharded loss at ``_reduced_init`` with 1 and 2 edge
chunks. The port runs at world 8 on two meshes: every shard on ``"cpu"``
(one group) and shards round-robin over three device names (three
groups: the exchange's multi-group path, ``.to`` between names that are
one CPU).

Bitwise: ``partition_edges_by_dst``, ``remote_fraction``,
``bucket_by_owner`` and ``halo_gather`` (rows are copied, never
computed), and GIN-TU's local neighbour sums (the ELL kernel's plain
version adds a node's edges in edge order, as the reference's
``segment_sum`` does). Tolerances: the losses within 1e-5 (the matrix
products differ in order); GIN-TU's gradients as
``tests/test_torch_train.py`` holds them (rtol/atol 1e-4); EquiformerV2's
losses within 1e-5, tighter than the reference's own 2e-3."""
import os
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import halo as jax_halo
from repro.graph.segment import segment_sum as jax_segment_sum
from repro.graph.sampler import fixed_size_unique as jax_unique
from repro_torch.configs import equiformer_v2, gin_tu, gnn_common
from repro_torch.core import halo
from repro_torch.launch.mesh import Mesh
from repro_torch.models.equiformer_v2 import equiformer_from_numpy
from repro_torch.models.gnn_basic import gin_from_numpy
from test_torch_train import _port_names
from tests.conftest import run_subprocess

WORLD = 8
MESHES = {"one_group": ("cpu",) * WORLD,
          "three_groups": ("cpu:0", "cpu:1", "cpu:2") * 2 + ("cpu:0",
                                                             "cpu:1")}
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = 1e-5
# (rows a shard, feature width, wanted ids a shard, id range low, cap_pp)
GATHERS = {"reference_test": (8, 5, 16, -1, 16),
           "over_capacity": (16, 3, 40, -1, 3),
           "duplicates": (8, 4, 32, -1, 4)}
GIN = dict(rows=16, d=12, classes=5, edges=640)
GIN_CAPS = {"no_drop": None, "drops": 4}
EQ = dict(rows=8, d=6, classes=4, edges=256)

_REF_CODE = """
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.core.halo import HaloCtx, halo_gather, partition_edges_by_dst
from repro.configs import equiformer_v2 as eqc, gin_tu
W = 8
GATHERS, GIN, GIN_CAPS, EQ = {cases!r}
mesh = make_mesh((W,), ("x",))
out = {{"gather": {{}}, "gin": {{}}, "eq": {{}}}}

for name, (rows, f, m, low, cap) in GATHERS.items():
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(W * rows, f)).astype(np.float32)
    want = rng.integers(low, W * rows // (2 if name == "duplicates" else 1),
                        size=(W, m)).astype(np.int32)
    def body(xl, wl, rows=rows, cap=cap):
        return halo_gather(xl, wl[0], axis="x", num_shards=W,
                           rows_per_shard=rows, cap_pp=cap)[None]
    g = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("x", None),
                P("x", None)), out_specs=P("x", None)))
    out["gather"][name] = (x, want, np.asarray(g(jnp.asarray(x),
                                                 jnp.asarray(want))))

def batch_of(rng, n, d, classes, edges):
    src = rng.integers(0, n, edges)
    dst = rng.integers(0, n, edges)
    ps, pd = partition_edges_by_dst(src, dst, n, W)
    b = {{"node_feat": rng.normal(size=(n, d)).astype(np.float32),
          "positions": rng.normal(size=(n, 3)).astype(np.float32),
          "species": rng.integers(0, 4, n).astype(np.int32),
          "src": ps, "dst": pd,
          "labels": rng.integers(0, classes, n).astype(np.int32)}}
    raw = dict(b, src=src.astype(np.int32), dst=dst.astype(np.int32))
    return b, raw, dict(nodes=n, edges=ps.shape[0], d_feat=d,
                        classes=classes, graphs=None)

def sharded(loss_sharded, params, batch, info, shape, rows, cap):
    ctx = HaloCtx(("x",), dict(mesh.shape), rows, cap)
    pspec = jax.tree_util.tree_map(lambda _: P(), params)
    bspec = {{k: P("x", None) if v.ndim == 2 else P("x")
              for k, v in batch.items()}}
    return jax.jit(shard_map(
        lambda p, b: loss_sharded(p, b, info, shape, ctx), mesh=mesh,
        in_specs=(pspec, bspec), out_specs=P()))

b, raw, info = batch_of(np.random.default_rng(0), W * GIN["rows"],
                        GIN["d"], GIN["classes"], GIN["edges"])
params = gin_tu._init(jax.random.key(0), GIN["d"], GIN["classes"],
                      "ogb_products")
for i, layer in enumerate(params["layers"]):
    layer["eps"] = jnp.asarray(0.1 * (i + 1), jnp.float32)
jb = {{k: jnp.asarray(v) for k, v in b.items()}}
out["gin"]["batch"], out["gin"]["raw"], out["gin"]["info"] = b, raw, info
out["gin"]["params"] = jax.tree_util.tree_map(np.asarray, params)
out["gin"]["global"] = float(gin_tu._loss(params, jb, info, "ogb_products"))
for name, cap in GIN_CAPS.items():
    cap = info["edges"] // W if cap is None else cap
    f = sharded(gin_tu._loss_sharded, params, jb, info, "ogb_products",
                GIN["rows"], cap)
    loss, grads = jax.value_and_grad(lambda p: f(p, jb))(params)
    out["gin"][name] = (cap, float(loss),
                        jax.tree_util.tree_map(np.asarray, grads))

b, raw, info = batch_of(np.random.default_rng(1), W * EQ["rows"], EQ["d"],
                        EQ["classes"], EQ["edges"])
params = eqc._reduced_init(jax.random.key(0), EQ["d"], EQ["classes"], "x")
jb = {{k: jnp.asarray(v) for k, v in b.items()}}
out["eq"]["batch"], out["eq"]["raw"], out["eq"]["info"] = b, raw, info
out["eq"]["params"] = jax.tree_util.tree_map(np.asarray, params)
eqc.EDGE_CHUNKS["unit1"], eqc.EDGE_CHUNKS["unit2"] = 1, 2
out["eq"]["global"] = float(eqc._loss(params, jb, info, "unit1"))
for chunks in (1, 2):
    f = sharded(eqc._loss_sharded, params, jb, info, f"unit{{chunks}}",
                EQ["rows"], info["edges"] // W)
    out["eq"][chunks] = float(f(params, jb))

with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
print("HALO_REF_OK")
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its shapes are tiny, and the
    suite's parallel workers would otherwise oversubscribe the cores (each
    of torch's small ops spinning up a thread team)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    """The reference's results at 8 fake devices, from one subprocess."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ref.pkl")
        code = _REF_CODE.format(cases=(GATHERS, GIN, GIN_CAPS, EQ))
        code = code.replace("sys.argv[1]", repr(path))
        r = run_subprocess(code, devices=WORLD, timeout=600)
        assert "HALO_REF_OK" in r.stdout, r.stderr[-3000:]
        with open(path, "rb") as fh:   # written by the subprocess above
            return pickle.load(fh)


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _sharded(cell, ref_part: dict) -> list[dict]:
    """The reference's batch laid out by ``cell``: its unpartitioned edges
    (``raw``) go through the port's partition, which gives the
    reference's edge order (``test_partition_and_remote_fraction_
    bitwise``), checked here again."""
    parts = cell.shard(_torch_batch(ref_part["raw"]))
    ctx = cell.ctx
    for k in ("src", "dst"):
        whole = ref_part["batch"][k].reshape(ctx.world, -1)
        for (_, shards), part in zip(ctx.groups, parts):
            assert np.array_equal(part[k].numpy(),
                                  whole[list(shards)].reshape(-1))
    return parts


def _cell(adapter, info, mesh_name, cap_pp, shape="ogb_products"):
    return gnn_common.build_halo_cell(adapter, info, shape,
                                      Mesh(MESHES[mesh_name]),
                                      cap_pp=cap_pp)


@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_partition_and_remote_fraction_bitwise(shards, seed):
    rng = np.random.default_rng(seed)
    n, e = 64 + seed * 7, 300
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    got = halo.partition_edges_by_dst(src, dst, n, shards)
    want = jax_halo.partition_edges_by_dst(src, dst, n, shards)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (halo.remote_fraction(src, dst, n, shards)
            == jax_halo.remote_fraction(src, dst, n, shards))


@pytest.mark.parametrize("u,owners,rows,cap,low", [
    (40, 8, 8, 16, -1), (64, 4, 16, 3, -1), (1, 2, 4, 1, 0),
    (33, 8, 5, 2, -1)])
def test_bucket_by_owner_bitwise(u, owners, rows, cap, low):
    """Over-capacity and ``-1`` ids get slot ``-1``; ``req`` and ``slot``
    equal the reference's bit for bit, on deduplicated input as
    ``halo_gather`` hands it and on raw ids."""
    rng = np.random.default_rng(u)
    ids = rng.integers(low, owners * rows, u).astype(np.int32)
    uniq = np.asarray(jax_unique(jnp.asarray(ids), u)[0])
    for x in (ids, uniq):
        got = halo.bucket_by_owner(torch.from_numpy(np.array(x)), owners,
                                   rows, cap)
        want = jax_halo.bucket_by_owner(jnp.asarray(x), owners, rows, cap)
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(GATHERS))
def test_halo_gather_bitwise_8_shards(ref, case, mesh_name):
    rows, _, _, _, cap = GATHERS[case]
    x, want, expect = ref["gather"][case]
    mesh = Mesh(MESHES[mesh_name])
    xs = [torch.from_numpy(x[s * rows:(s + 1) * rows]) for s in range(WORLD)]
    got = halo.halo_gather(xs, [torch.from_numpy(w) for w in want],
                           mesh=mesh, rows_per_shard=rows, cap_pp=cap)
    got = np.stack([g.numpy() for g in got])
    assert np.array_equal(got.view(np.int32), expect.view(np.int32))
    if case == "reference_test":     # the reference test's own expectation
        assert np.array_equal(got, np.where((want >= 0)[..., None],
                                            x[np.maximum(want, 0)], 0.0))
    if case == "over_capacity":
        assert (got == 0).all(-1).sum() > (want < 0).sum()   # drops happen


def test_halo_gather_gradient_reaches_owners():
    """d(Σ w·rows)/dx: each owner row receives the weights of every
    position that read it (not dropped), summed over requesters."""
    rows, f, m, cap = 8, 3, 20, 2
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(size=(WORLD * rows, f)), dtype=torch.float32,
                     requires_grad=True)
    want = [torch.from_numpy(rng.integers(-1, WORLD * rows, m)
                             .astype(np.int32)) for _ in range(WORLD)]
    mesh = Mesh(MESHES["three_groups"])
    out = halo.halo_gather(list(x.split(rows)), want, mesh=mesh,
                           rows_per_shard=rows, cap_pp=cap)
    weights = [torch.from_numpy(rng.normal(size=(m, f)).astype(np.float32))
               for _ in range(WORLD)]
    sum(((o * w).sum() for o, w in zip(out, weights))).backward()
    expect = np.zeros((WORLD * rows, f), np.float32)
    for o, w, ids in zip(out, weights, want):
        for j, i in enumerate(ids.tolist()):
            if i >= 0 and bool(o[j].ne(0).any()):   # read, not dropped
                expect[i] += w[j].numpy()
    np.testing.assert_allclose(x.grad.numpy(), expect, rtol=1e-6, atol=1e-6)
    assert (x.grad != 0).any()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_plan_counts_and_local_sums_bitwise(ref, mesh_name):
    """The plan's counters equal a numpy reckoning, and each shard's
    layer-1 neighbour sums (``segment_spmm`` over the ELL table into the
    exchange buffer) equal the reference's ``segment_sum`` of the same
    rows bit for bit, dropped ids included."""
    b, info = ref["gin"]["batch"], ref["gin"]["info"]
    rows, cap = GIN["rows"], GIN_CAPS["drops"]
    cell = _cell(gin_tu.ARCH.adapter, info, mesh_name, cap)
    ctx = cell.ctx
    sb = _sharded(cell, ref["gin"])
    plan, tables = gin_tu.halo_tables(sb, ctx)
    bufs = ctx.exchange(plan, [part["node_feat"] for part in sb])
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_plain
    e = info["edges"] // WORLD
    src, dst = b["src"].reshape(WORLD, e), b["dst"].reshape(WORLD, e)
    uniq = dropped = remote = 0
    for gi, (_, shards) in enumerate(ctx.groups):
        agg = segment_spmm_plain(tables[gi][0], bufs[gi])
        rows_g = ctx.gather([part["node_feat"] for part in sb], plan)[gi]
        for k, s in enumerate(shards):
            v = (src[s] >= 0) & (dst[s] >= 0)
            d_loc = np.clip(np.maximum(dst[s], 0) - s * rows, 0, rows - 1)
            h_src = rows_g[k * e:(k + 1) * e].numpy()
            want = jax_segment_sum(
                jnp.where(jnp.asarray(v)[:, None], jnp.asarray(h_src), 0.0),
                jnp.asarray(d_loc), rows)
            got = agg[k * rows:(k + 1) * rows].numpy()
            assert np.array_equal(got.view(np.int32),
                                  np.asarray(want).view(np.int32))
            u = np.unique(src[s][v])
            owner = u // rows
            uniq += u.size
            remote += int((owner != s).sum())
            dropped += int(sum(max(0, int((owner == o).sum()) - cap)
                               for o in range(WORLD)))
    assert plan.counts == {"unique_ids": uniq, "remote_ids": remote,
                           "dropped_ids": dropped}
    assert dropped > 0


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("cap_name", sorted(GIN_CAPS))
def test_gin_sharded_loss_and_gradients_match_reference(ref, cap_name,
                                                        mesh_name):
    """The sharded loss against the reference's shard_map loss (and, with
    nothing dropped, against the port's global loss), and every
    parameter's gradient, ε included, against ``jax.grad`` through the
    reference's shard_map."""
    b, info = ref["gin"]["batch"], ref["gin"]["info"]
    cap, ref_loss, ref_grads = ref["gin"][cap_name]
    model = gin_from_numpy(ref["gin"]["params"], device="cpu")
    cell = _cell(gin_tu.ARCH.adapter, info, mesh_name, cap)
    named = dict(model.named_parameters())
    loss = cell.loss(model, _sharded(cell, ref["gin"]))
    grads = torch.autograd.grad(loss, list(named.values()))
    loss_value = float(loss.detach())
    assert abs(loss_value - ref_loss) <= LOSS_TOL
    if cap_name == "no_drop":
        assert cell.ctx.stats["dropped_ids"] == 0
        whole = gin_tu._loss(model, _torch_batch(b), info, "ogb_products")
        assert abs(float(loss) - float(whole)) <= LOSS_TOL
        assert abs(float(loss) - ref["gin"]["global"]) <= LOSS_TOL
    else:
        assert cell.ctx.stats["dropped_ids"] > 0
    want = _port_names(ref_grads)
    assert sorted(want) == sorted(named)
    for name, g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD_TOL,
                                   err_msg=name)


def test_gin_sharded_step_launches_the_local_sums_through_segment_spmm(
        ref, monkeypatch):
    """Each layer's local sums go through ``segment_spmm`` (the kernel's
    dispatch), one call a group a layer forward and one a group for
    layers 2–5 backward: 9 a step on one group, 27 on three."""
    from repro_torch.kernels.segment_spmm import ops
    b, info = ref["gin"]["batch"], ref["gin"]["info"]
    model = gin_from_numpy(ref["gin"]["params"], device="cpu")
    original, calls = ops.segment_spmm, []

    def counted(ids, feat, weights=None):
        calls.append(feat.shape)
        return original(ids, feat, weights)

    monkeypatch.setattr(ops, "segment_spmm", counted)
    for mesh_name, groups in (("one_group", 1), ("three_groups", 3)):
        calls.clear()
        cell = _cell(gin_tu.ARCH.adapter, info, mesh_name, None)
        cell.loss(model, _sharded(cell, ref["gin"])).backward()
        assert len(calls) == 9 * groups


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_equiformer_sharded_loss_matches_reference(ref, mesh_name, chunks,
                                                   monkeypatch):
    b, info = ref["eq"]["batch"], ref["eq"]["info"]
    model = equiformer_from_numpy(ref["eq"]["params"], device="cpu")
    cell = _cell(equiformer_v2.ARCH.adapter, info, mesh_name,
                 info["edges"] // WORLD)
    monkeypatch.setitem(equiformer_v2.EDGE_CHUNKS, "unit2", 2)
    shape = "unit2" if chunks == 2 else "custom"
    with torch.no_grad():
        loss = equiformer_v2._loss_sharded(
            model, _sharded(cell, ref["eq"]), info, shape, cell.ctx)
        whole = equiformer_v2._loss(model, _torch_batch(b), info, "custom")
    assert cell.ctx.stats["dropped_ids"] == 0
    assert abs(float(loss) - ref["eq"][chunks]) <= LOSS_TOL
    assert abs(float(loss) - float(whole)) <= LOSS_TOL
    assert abs(ref["eq"][chunks] - ref["eq"]["global"]) <= 2e-3


def test_equiformer_sharded_gradients_match_unsharded(ref):
    """The sharded loss's gradients against the unsharded loss's on the
    port, at a capacity that drops nothing (the exchange's backward
    returns each row's gradient to its owner)."""
    b, info = ref["eq"]["batch"], ref["eq"]["info"]
    model = equiformer_from_numpy(ref["eq"]["params"], device="cpu")
    named = dict(model.named_parameters())
    cell = _cell(equiformer_v2.ARCH.adapter, info, "three_groups",
                 info["edges"] // WORLD)
    got = torch.autograd.grad(cell.loss(model, _sharded(cell, ref["eq"])),
                              list(named.values()))
    want = torch.autograd.grad(equiformer_v2._loss(
        model, _torch_batch(b), info, "custom"), list(named.values()))
    for name, g, w in zip(named, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()) + 1e-9,
                                   err_msg=name)


def test_ctx_reductions_follow_shard_order():
    """``all_gather`` returns every shard's rows in shard order from any
    grouping, and ``mean`` is Σ total / max(Σ count, 1)."""
    mesh = Mesh(MESHES["three_groups"])
    ctx = halo.HaloCtx(mesh, rows=2, cap_pp=4)
    x = torch.arange(WORLD * 2 * 3, dtype=torch.float32).view(-1, 3)
    groups = [torch.cat([x[s * 2:(s + 1) * 2] for s in shards])
              for _, shards in ctx.groups]
    assert torch.equal(ctx.all_gather(groups, torch.device("cpu")), x)
    totals = [torch.tensor([float(s) for s in shards])
              for _, shards in ctx.groups]
    zeros = [torch.zeros(len(shards)) for _, shards in ctx.groups]
    assert float(ctx.mean(totals, zeros)) == sum(range(WORLD))
    assert ctx.index(3) == 3 and ctx.offset(3) == 6
    assert (ctx.axes, ctx.sizes, ctx.world) == (("x",), [WORLD], WORLD)
