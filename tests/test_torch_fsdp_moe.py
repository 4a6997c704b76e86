"""The port's MoE training over a ``("data", "model")`` mesh by the
reference's full FSDP (``models/fsdp.py``, ``moe.moe_apply_groups``,
``LM(mesh=, rules=)`` for an MoE arch, ``lm_common.train_step`` on it,
``lm_common.fsdp_working_set``) against the JAX package and against the
port without a mesh, on the CPU.

The reference's side runs once, in one subprocess for the module
(``ref``), on 4 forced host devices: its own ``build_lm_cell(cfg,
"train_4k", mesh)`` step jitted with the cell's shardings on
``make_host_mesh(model=M)`` for M 4, 2 and 1 — meshes (1, 4), (2, 2) and
(4, 1) — with ``SHAPES["train_4k"]`` set to batch 16 and 64 positions
inside that subprocess only, so that its 4 micro-batches of 4 rows split
over data 4; and, for every weight, the blocks
``NamedSharding.devices_indices_map`` gives under the cell's specs (the
layers' with the stacked axis stripped). Both sides run the smoke
reduction in fp32 (attention chunks 32) of deepseek-moe-16b (8 experts,
top-2, shared experts) and phi3.5-moe-42b (8 experts, top-2, its one KV
head of 16 columns split inside the head at M 4) for two steps of
``AdamW(lr=3e-4)`` on the same two batches, from the reference's
``lm_init`` carried by ``lm_from_numpy``.

Tolerances (fp32 both sides, the same sums in other orders): each step's
loss within ``LOSS_TOL`` (1e-5); the gathered AdamW mu and nu after the
second step and the gathered weights, per parameter and as one tree,
within ``REL_TOL`` (1e-5) of the reference's in norm. These hold only
where both sides route every token alike, so the test first asserts that
the batches' routing has no near tie: in every layer and micro-batch, the
gap between a token's k-th and (k+1)-th router probabilities is at least
``MIN_GAP`` (1e-6, as ``test_torch_moe.py`` asks). The batches' seed 7
(``test_torch_tensor_parallel.py``'s) gives 6.8e-6; seed 11 gave 1.5e-8
in deepseek-moe-16b's, and there the reference's own cell routes a token
apart on (1, 4) and on (2, 2), its step 0 losses 5.2e-4 apart.

Held bit for bit: the blocks against ``devices_indices_map``; the port's
init and carry-over on a mesh gathered back; every shard that holds a
block replicated over ``"model"`` (the router, the norm gains) after a
step; a step repeated from the same start; and the pin of the global
plan: the smallest input where per-group capacities drop other
assignments than the micro-batch's one plan."""
import dataclasses
import math
import os
import pickle
import tempfile
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch.configs import LM_ARCHS, lm_common
from repro_torch.launch.mesh import ProductionMesh, make_host_mesh
from repro_torch.models import fsdp, moe, tensor_parallel, transformer
from repro_torch.sharding import device_blocks
from tests.conftest import run_subprocess

LOSS_TOL = 1e-5
REL_TOL = 1e-5
MIN_GAP = 1e-6
ARCHS = ("deepseek-moe-16b", "phi3.5-moe-42b")
MODELS = (4, 2, 1)              # the model axis of a 4-shard mesh
SEQ, BATCH, STEPS = 64, 16, 2
GB = 1e9

_REF_CODE = """
import dataclasses, pickle
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import deepseek_moe_16b, lm_common, phi35_moe_42b
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as rtf
from repro.training.optimizer import AdamW

MODELS, SEQ, BATCH, STEPS = {consts}
lm_common.SHAPES["train_4k"] = dict(kind="train", seq=SEQ, batch=BATCH)
ARCHS = {{"deepseek-moe-16b": deepseek_moe_16b.CONFIG,
          "phi3.5-moe-42b": phi35_moe_42b.CONFIG}}
with open(IN_PATH, "rb") as fh:
    batches = pickle.load(fh)
out = {{"blocks": {{}}, "runs": {{}}, "init": {{}}}}


def smoke(cfg):
    m = dataclasses.replace(cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
                            top_k=min(cfg.moe.top_k, 2), d_ff=64,
                            d_ff_shared=64 if cfg.moe.n_shared else 0)
    return dataclasses.replace(
        cfg, vocab=512, d_model=64, n_layers=2, n_heads=4,
        n_kv=max(1, 4 * cfg.n_kv // cfg.n_heads), head_dim=16, d_ff=0,
        moe=m, dtype="float32", q_chunk=32, kv_chunk=32)


def to_np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def blocks(mesh, params, specs, path, key):
    if isinstance(params, dict):
        for k in params:
            blocks(mesh, params[k], specs[k], path + (k,), key)
        return
    shape, s = tuple(params.shape), tuple(specs)
    if path[0] == "layers":
        shape, s = shape[1:], s[1:]
    idx = NamedSharding(mesh, P(*s)).devices_indices_map(shape)
    out["blocks"][key + (path,)] = [
        tuple(sl.indices(n)[:2] for sl, n in zip(idx[d], shape))
        for d in mesh.devices.flat]


for model in MODELS:
    mesh = make_host_mesh(model=model)
    for name, full in ARCHS.items():
        cfg = smoke(full)
        params = rtf.lm_init(jax.random.key(0), cfg)
        rules = lm_common.lm_rules(mesh, "train_4k", cfg)
        blocks(mesh, params, lm_common.lm_param_specs(cfg, mesh, rules), (),
               (name, model))
        cell = lm_common.build_lm_cell(cfg, "train_4k", mesh)
        step = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                       out_shardings=cell.out_shardings)
        out["init"][name] = to_np(params)
        state = AdamW(lr=3e-4).init(params)
        losses = []
        for t in range(STEPS):
            params, state, loss = step(params, state, {{
                "tokens": jnp.asarray(batches[t, 0]),
                "targets": jnp.asarray(batches[t, 1])}})
            losses.append(float(loss))
        out["runs"][name, model] = dict(
            params=to_np(params), mu=to_np(state.mu), nu=to_np(state.nu),
            losses=losses)

with open(OUT_PATH, "wb") as fh:
    pickle.dump(out, fh)
print("FSDP_REF_OK")
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches() -> np.ndarray:
    """``(STEPS, 2, BATCH, SEQ)``: each step's tokens and targets."""
    return np.random.default_rng(7).integers(
        0, 512, size=(STEPS, 2, BATCH, SEQ)).astype(np.int32)


@pytest.fixture(scope="module")
def ref():
    """The reference's results on 4 forced host devices, from one
    subprocess."""
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "batches.pkl"), os.path.join(d, "ref.pkl")
        with open(src, "wb") as fh:
            pickle.dump(_batches(), fh)
        code = _REF_CODE.format(consts=(MODELS, SEQ, BATCH, STEPS))
        code = code.replace("IN_PATH", repr(src)).replace("OUT_PATH",
                                                          repr(dst))
        r = run_subprocess(code, devices=4, timeout=900)
        assert "FSDP_REF_OK" in r.stdout, r.stderr[-3000:]
        with open(dst, "rb") as fh:   # written by the subprocess above
            return pickle.load(fh)


def _smoke(arch: str):
    return lm_common.smoke_config(LM_ARCHS[arch])


def _mesh(model: int):
    return make_host_mesh(4, model=model, device="cpu")


def _fsdp_lm(cfg, mesh, seed: int = 0):
    return transformer.lm_init(torch.Generator().manual_seed(seed), cfg,
                               mesh=mesh,
                               rules=lm_common.train_rules(mesh, cfg))


def _train(model, cfg, mesh=None, steps: int = STEPS):
    """``steps`` steps of the cell on :func:`_batches` (micro-batches of the
    reference's mesh cell, 4); returns ``(losses, opt_state)``."""
    opt = lm_common.train_optimizer()
    state = opt.init(lm_common.zero1_params(model) if mesh is not None
                     else dict(model.named_parameters()))
    losses = []
    for toks, tgts in _batches()[:steps]:
        state, loss = lm_common.train_step(
            model, opt, state, {"tokens": torch.from_numpy(toks).long(),
                                "targets": torch.from_numpy(tgts).long()},
            cfg, micro=4, chunks=lm_common.SMOKE_CHUNKS)
        losses.append(float(loss))
    return losses, state


@pytest.fixture(scope="module")
def runs(ref):
    """The port's runs from the reference's initial weights: on each mesh
    (gathered weights, mu, nu, losses) and without one."""
    out = {}
    for arch in ARCHS:
        cfg = _smoke(arch)
        one = transformer.lm_from_numpy(ref["init"][arch], cfg, device="cpu")
        gaps = []
        route = moe.route

        def spy(x, router, c):
            probs, top_w, top_e = route(x, router, c)
            top = torch.sort(probs.detach(), -1, descending=True).values
            gaps.append(float((top[:, c.top_k - 1] - top[:, c.top_k]).min()))
            return probs, top_w, top_e

        with mock.patch.object(moe, "route", spy):
            losses, state = _train(one, cfg)
        out[arch, None] = dict(params=one.state_dict(), mu=state.mu,
                               nu=state.nu, losses=losses, gap=min(gaps))
        for m in MODELS:
            mesh = _mesh(m)
            model = transformer.lm_from_numpy(
                ref["init"][arch], cfg, device="cpu", mesh=mesh,
                rules=lm_common.train_rules(mesh, cfg))
            losses, state = _train(model, cfg, mesh)
            gathered = lm_common.gathered_opt_state(model, state)
            out[arch, m] = dict(params=transformer.gathered_state_dict(model),
                                mu=gathered["mu"], nu=gathered["nu"],
                                losses=losses, model=model, state=state)
    return out


def _as_port(tree, cfg) -> dict:
    """A reference parameter tree under the port's names."""
    return transformer.lm_from_numpy(tree, cfg, device="cpu").state_dict()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def _hold(got: dict, want: dict) -> None:
    """The module docstring's tolerances."""
    assert max(abs(a - b) for a, b in zip(got["losses"], want["losses"])) \
        <= LOSS_TOL
    for key in ("mu", "nu", "params"):
        g, w = got[key], want[key]
        assert g.keys() == w.keys()
        for name in w:
            assert _rel(g[name], w[name]) <= REL_TOL, (key, name)
        total = math.sqrt(sum(float(((g[k] - w[k]) ** 2).sum()) for k in w))
        assert total <= REL_TOL * math.sqrt(sum(float((w[k] ** 2).sum())
                                                for k in w)), key


def _path(name: str) -> tuple:
    """The reference's tree path of the port's parameter ``name``."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts = parts[:-1]
    return ("layers", *parts[2:]) if parts[0] == "layers" else tuple(parts)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", MODELS)
def test_device_blocks_are_the_reference_devices_indices_map(ref, model):
    """Every weight's block on every shard under full FSDP — the 4-D
    experts with the layer axis stripped, split over ``"model"`` by
    ``"expert"`` and over data by ``"fsdp"``; the router over data only —
    is the one ``NamedSharding.devices_indices_map`` gives on the
    reference's ``make_host_mesh(model=)``, and the one the port's LM
    holds."""
    for arch in ARCHS:
        cfg = _smoke(arch)
        mesh = _mesh(model)
        lm = transformer.LM(cfg, device="cpu", mesh=mesh,
                            rules=lm_common.train_rules(mesh, cfg))
        specs = lm_common.lm_param_specs(
            cfg, mesh, lm_common.train_rules(mesh, cfg))
        for name, (shape, blocks) in lm.blocks.items():
            want = ref["blocks"][arch, model, _path(name)]
            assert blocks == want, (arch, name)
            spec = lm_common.lm_param_spec_of(name, specs)
            stand_in = ProductionMesh(("data", "model"), (4 // model, model))
            assert device_blocks(stand_in, spec, shape) == want
        w1 = lm.blocks["layers.0.moe.w1"][1]
        assert [b[0] for b in w1] == [
            (s % model * 8 // model, (s % model + 1) * 8 // model)
            for s in range(4)]
        assert [b[1] for b in w1] == [
            (s // model * 64 * model // 4, (s // model + 1) * 64 * model // 4)
            for s in range(4)]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("arch", ARCHS)
def test_shards_hold_the_fsdp_blocks(arch, model):
    """Each shard holds its block of every weight and nothing more, the
    router in fp32; its bytes are ``train_placement``'s; each model
    coordinate runs its experts; the plan is the one of the blocks
    gathered over ``"data"``."""
    cfg = _smoke(arch)
    mesh = _mesh(model)
    lm = transformer.LM(cfg, device="cpu", mesh=mesh,
                        rules=lm_common.train_rules(mesh, cfg))
    place = lm_common.train_placement(cfg, mesh)
    data = 4 // model
    for i, sh in enumerate(lm.shards):
        for name, (_, blocks) in lm.blocks.items():
            assert sh.get_parameter(name).shape == tuple(
                hi - lo for lo, hi in blocks[i]), name
        blk = sh.layers[0]
        assert blk.moe.w1.shape == (8 // model, 64 // data, 64)
        assert blk.moe.w2.shape == (8 // model, 64, 64 // data)
        assert blk.moe.router.shape == (64 // data, 8)
        assert blk.moe.router.dtype == torch.float32
        assert sum(p.numel() * 4 for p in sh.parameters()) == \
            place.weight_bytes[i]
    assert lm.expert_ranges == [(m * 8 // model, (m + 1) * 8 // model)
                                for m in range(model)]
    assert lm.replicas == mesh.axis_groups("data")
    assert [p.heads for p in lm.plan.shards] == [
        (m * 4 // model, (m + 1) * 4 // model) for m in range(model)]
    assert lm.plan.gather_kv == (arch == "phi3.5-moe-42b" and model > 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_from_numpy_and_lm_init_on_a_mesh_gather_back_bitwise(ref, arch):
    """The reference's weights carried onto each mesh, and ``lm_init`` on
    it, gather back to the unsharded model's bits."""
    cfg = _smoke(arch)
    one = transformer.lm_from_numpy(ref["init"][arch], cfg, device="cpu")
    drawn = transformer.lm_init(torch.Generator().manual_seed(3), cfg)
    for m in MODELS:
        mesh = _mesh(m)
        rules = lm_common.train_rules(mesh, cfg)
        for want, got in (
                (one, transformer.lm_from_numpy(ref["init"][arch], cfg,
                                                device="cpu", mesh=mesh,
                                                rules=rules)),
                (drawn, _fsdp_lm(cfg, mesh, 3))):
            g, w = transformer.gathered_state_dict(got), want.state_dict()
            assert list(g) == list(w)
            assert all(torch.equal(g[k], w[k]) for k in w), m


# ---------------------------------------------------------------------------
# the moves
# ---------------------------------------------------------------------------
def test_split_range():
    assert fsdp.split_range(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert fsdp.split_range(5, 2) == [(0, 3), (3, 5)]
    assert fsdp.split_range(1, 3) == [(0, 1), (1, 1), (1, 1)]


def test_gathers_reduce_and_scatter_in_a_fixed_order():
    """``AllGather`` over a weight's ``"fsdp"`` dimension gives each
    replica the whole block and hands each shard the sum of every
    replica's gradient of its slice; ``ExpertGather`` gives each replica
    its experts whole and hands each shard its slice of them, unsummed."""
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(3, 2, 5, generator=gen, requires_grad=True)
             for _ in range(2)]
    whole = torch.cat([p.detach() for p in parts], 1)
    outs = tensor_parallel.AllGather.apply(1, *parts)
    assert all(torch.equal(o, whole) for o in outs)
    cots = [torch.randn(3, 4, 5, generator=gen) for _ in outs]
    torch.autograd.backward(outs, cots)
    total = cots[0] + cots[1]
    assert torch.equal(parts[0].grad, total[:, :2])
    assert torch.equal(parts[1].grad, total[:, 2:])
    for p in parts:
        p.grad = None
    outs = fsdp.ExpertGather.apply(1, ((0, 2), (2, 3)), *parts)
    assert torch.equal(outs[0], whole[:2]) and torch.equal(outs[1],
                                                            whole[2:])
    cots = [torch.randn(o.shape, generator=gen) for o in outs]
    torch.autograd.backward(outs, cots)
    full = torch.cat(cots)
    assert torch.equal(parts[0].grad, full[:, :2])
    assert torch.equal(parts[1].grad, full[:, 2:])


# ---------------------------------------------------------------------------
# the global plan
# ---------------------------------------------------------------------------
PIN = moe.MoEConfig(num_experts=2, top_k=1, d_ff=4)


def _pin_inputs():
    """Two groups of 4 tokens, d 8: group 0's all on expert 0, group 1's
    on experts 0, 1, 0, 1. The micro-batch's capacity is ceil(8 · 1.25 /
    2) = 5, so it drops group 1's second expert-0 token; a group's own
    capacity would be ceil(4 · 1.25 / 2) = 3, dropping group 0's fourth
    token instead."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 8)).astype(np.float32) * 0.1
    x[:, :2] = 0.0
    x[[0, 1, 2, 3, 4, 6], 0] = 1.0
    x[[5, 7], 1] = 1.0
    router = np.zeros((8, 2), np.float32)
    router[0] = (4.0, -4.0)
    router[1] = (-4.0, 4.0)
    return {"x": x, "router": router,
            "w1": rng.normal(size=(2, 8, 4)).astype(np.float32),
            "w3": rng.normal(size=(2, 8, 4)).astype(np.float32),
            "w2": rng.normal(size=(2, 4, 8)).astype(np.float32)}


def test_the_plan_is_the_micro_batchs():
    """The grouped MoE over two groups equals ``moe_apply`` on the
    concatenated tokens (the port's, bit for bit, and the reference's
    within 1e-5): capacity 5, one drop, in group 1; a plan made group by
    group drops group 0's fourth token instead."""
    p = _pin_inputs()
    x = torch.from_numpy(p["x"])
    w = {k: torch.from_numpy(p[k]) for k in ("router", "w1", "w3", "w2")}
    outs, stats = moe.moe_apply_groups(
        [x[:4], x[4:]], [w["router"]] * 2,
        [(0, 2, w["w1"], w["w3"], w["w2"])], PIN, torch.device("cpu"))
    got = torch.cat(outs)
    mod = moe.moe_from_numpy({k: p[k] for k in w}, PIN, device="cpu")
    want, whole = moe.moe_apply(mod, x, PIN)
    assert torch.equal(got, want)
    assert stats["capacity"] == whole["capacity"] == 5
    assert int(stats["dropped"]) == int(whole["dropped"]) == 1
    assert stats["expert_load"].tolist() == whole["expert_load"].tolist() \
        == [5.0, 2.0]
    assert torch.equal(got[6], torch.zeros(8)) and bool(got[3].any())
    assert float(stats["aux_loss"].detach()) == pytest.approx(
        float(whole["aux_loss"].detach()), abs=1e-7)
    ref_out, ref_stats = ref_moe.moe_apply(
        {k: jnp.asarray(p[k]) for k in w}, jnp.asarray(p["x"]),
        ref_moe.MoEConfig(num_experts=2, top_k=1, d_ff=4))
    assert np.abs(got.numpy() - np.asarray(ref_out)).max() <= 1e-5
    assert int(ref_stats["dropped"]) == 1
    assert np.asarray(ref_stats["expert_load"]).tolist() == [5.0, 2.0]
    per_group = [moe.moe_apply(mod, part, PIN) for part in (x[:4], x[4:])]
    assert [s["capacity"] for _, s in per_group] == [3, 3]
    assert [int(s["dropped"]) for _, s in per_group] == [1, 0]
    assert not bool(per_group[0][0][3].any()) and bool(
        per_group[1][0][2].any())


def test_the_mesh_step_plans_the_micro_batch(runs):
    """On (4, 1) each micro-batch's plan is the one of its 256 tokens:
    every layer's capacity is ``capacity(256)``, and kept + dropped is
    ``T·k``."""
    lm = runs["deepseek-moe-16b", 1]["model"]
    cap = moe.capacity(256, lm.cfg.moe)
    for stats in lm.moe_stats.values():
        assert stats["capacity"] == cap == 80
        assert float(stats["expert_load"].sum()) + int(stats["dropped"]) \
            == 256 * 2
        assert float(stats["expert_load"].max()) <= cap


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_on_a_mesh_matches_the_reference(ref, runs, arch, model):
    """Two steps on (4 / model, model) against the reference's cell jitted
    with its shardings on the same mesh shape."""
    assert runs[arch, None]["gap"] >= MIN_GAP   # the module docstring
    cfg = _smoke(arch)
    r = ref["runs"][arch, model]
    want = {"losses": r["losses"], "params": _as_port(r["params"], cfg),
            "mu": _as_port(r["mu"], cfg), "nu": _as_port(r["nu"], cfg)}
    _hold(runs[arch, model], want)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_on_a_mesh_matches_the_port_without_one(runs, arch, model):
    _hold(runs[arch, model], runs[arch, None])


@pytest.mark.parametrize("model", MODELS)
def test_replicas_hold_the_same_bits_and_a_step_repeats(runs, model):
    """After the steps every shard that holds a block (the router over its
    model replicas, the norm gains everywhere) holds the same bits; the
    FSDP layout leaves nothing to gather; two runs from the same start
    give the same bits, losses included."""
    arch = "deepseek-moe-16b"
    lm = runs[arch, model]["model"]
    layout = lm_common.zero1_layout(lm)
    assert not layout.gathers
    for name in layout.shapes:
        for i, holders in enumerate(layout.holders[name]):
            mine = lm.shards[i].get_parameter(name)
            for j in holders:
                assert torch.equal(lm.shards[j].get_parameter(name), mine)
    cfg = _smoke(arch)
    mesh = _mesh(model)
    again, twice = _fsdp_lm(cfg, mesh, 5), _fsdp_lm(cfg, mesh, 5)
    (l1, s1), (l2, s2) = _train(again, cfg, mesh, 1), _train(twice, cfg,
                                                             mesh, 1)
    assert l1 == l2
    g1, g2 = (transformer.gathered_state_dict(again),
              transformer.gathered_state_dict(twice))
    assert all(torch.equal(g1[k], g2[k]) for k in g1)
    assert all(torch.equal(s1.mu[k], s2.mu[k]) for k in s1.mu)


def test_a_shards_gradient_is_its_block():
    """After one micro-batch's backward on (2, 2), each shard's ``.grad``
    has its block's shape; the router's copies off the groups' home
    shards have none (the step counts them as zero)."""
    cfg = _smoke("deepseek-moe-16b")
    mesh = _mesh(2)
    lm = _fsdp_lm(cfg, mesh)
    toks = torch.from_numpy(_batches()[0]).long()
    loss = fsdp.fsdp_loss(lm, [toks[0, :2], toks[0, 2:4]],
                          [toks[1, :2], toks[1, 2:4]], count=4 * SEQ,
                          chunk=transformer.LOSS_CHUNK,
                          **lm_common.SMOKE_CHUNKS)
    loss.backward()
    for i, sh in enumerate(lm.shards):
        for name, p in sh.named_parameters():
            if name.endswith("moe.router") and i % 2:
                assert p.grad is None, name
            else:
                assert p.grad.shape == p.shape, name


def test_mesh_step_refuses_a_batch_that_does_not_split():
    cfg = _smoke("phi3.5-moe-42b")
    mesh = _mesh(1)
    lm = _fsdp_lm(cfg, mesh)
    opt = lm_common.train_optimizer()
    state = opt.init(lm_common.zero1_params(lm))
    toks = torch.zeros((8, SEQ), dtype=torch.long)
    with pytest.raises(ValueError, match="data axis of 4"):
        lm_common.train_step(lm, opt, state, {"tokens": toks,
                                              "targets": toks}, cfg,
                             micro=4)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,state", [((1, 4), 67.56), ((2, 2), 67.53),
                                         ((4, 1), 67.52)])
def test_fsdp_state_and_working_set_a_card(shape, state):
    """deepseek-moe-16b on four cards: its 270.1 GB of fp32 state split by
    full FSDP, and each card's gathered working set in closed form, fp32
    weights and their gradients: at (2, 2) a layer (each replica's 16 of
    its coordinate's 32 experts, its half of attention and of the shared
    experts, the router on the home shards), at (4, 1) the unembedding's
    whole data dimension (above a layer's 1.38 GB); nothing is gathered
    without a data axis."""
    cfg = LM_ARCHS["deepseek-moe-16b"]
    m = cfg.moe
    d = cfg.d_model
    mesh = ProductionMesh(("data", "model"), shape)
    place = lm_common.train_placement(cfg, mesh)
    ws = lm_common.fsdp_working_set(cfg, mesh)
    assert round(max(place.card_bytes) / GB, 2) == state
    layer = (16 * 3 * d * m.d_ff + 4 * d * d // 2
             + 3 * d * m.d_ff_shared // 2)
    want = {(1, 4): [0] * 4,
            (2, 2): [8 * (layer + d * m.num_experts), 8 * layer] * 2,
            (4, 1): [8 * d * cfg.vocab] * 4}[shape]
    assert list(ws) == want
    four = dataclasses.replace(cfg, n_layers=4)
    one_card = lm_common.fsdp_working_set(four, mesh, cards=1)
    assert one_card == (sum(lm_common.fsdp_working_set(four, mesh)),)


def test_profile_train_cells_takes_an_moe_mesh(monkeypatch):
    """``bench/profile_train_cells.py --cell lm --arch deepseek-moe-16b
    --mesh-world 4 --model 1`` builds the launcher's full-FSDP cell at its
    defaults: 16 sequences in 4 micro-batches, one row a data group."""
    from repro_torch.bench import profile_train_cells
    from repro_torch.launch import lm as launcher
    seen = []
    monkeypatch.setattr(launcher, "train_cell", lambda args: (
        seen.append(args), (None, 0, None, None))[1])
    profile_train_cells._cell("lm", arch="deepseek-moe-16b", mesh_world=4,
                              model=1)
    (args,) = seen
    assert (args.arch, args.mesh_world, args.model, args.batch,
            args.micro) == ("deepseek-moe-16b", 4, 1, 16, 4)
