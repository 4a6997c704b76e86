"""The port's dense-LM training over a ``("data", "model")`` mesh
(``launch/mesh.py``'s axes, ``sharding.device_blocks``,
``models/tensor_parallel.py``, ``LM(mesh=, rules=)``,
``lm_common.train_rules``/``train_step``/``train_placement`` and the LM
launcher's ``--shape train_4k --mesh-world/--model``) against the JAX
package and against the port without a mesh, on the CPU.

The reference's side runs once, in one subprocess for the module
(``ref``), on 4 forced host devices: its own ``build_lm_cell(cfg,
"train_4k", mesh)`` step jitted with the cell's shardings on
``make_host_mesh(model=M)`` for M 4, 2 and 1 — meshes (1, 4), (2, 2) and
(4, 1) — with ``SHAPES["train_4k"]`` set to batch 16 and 64 positions
inside that subprocess only, so that its 4 micro-batches of 4 rows split
over data 4; and the blocks ``NamedSharding.devices_indices_map`` gives on
those meshes. Both sides run the smoke reduction in fp32 (attention
chunks 32) of codeqwen1.5-7b (QKV bias; ``wk`` split head by head) and
qwen3-4b (qk-norm; its one KV head of 16 columns split inside the head,
so the port gathers k and v) for two steps of ``AdamW(lr=3e-4)`` on the
same two batches, from the reference's ``lm_init`` carried by
``lm_from_numpy``.

Tolerances (fp32 both sides, the same sums in other orders):

* each step's loss within ``LOSS_TOL`` (1e-5);
* the gathered AdamW mu and nu after the second step, per parameter,
  within ``REL_TOL`` (1e-5) of the reference's in norm: these carry the
  gradient, since the warm-up moves each weight by about 3e-6 a step;
* the gathered weights, per parameter, within ``REL_TOL`` in norm, but for
  ``bk``: its gradient is zero in exact arithmetic (a bias every key
  shares leaves each softmax unchanged), so Adam's step turns rounding
  into ``±lr`` entry by entry (1.6e-3 of its norm here, on either side);
  its mu and nu are held, and the whole tree of weights is within
  ``REL_TOL``.

Held bit for bit: the port's init and carry-over on a mesh gathered back;
every data replica's weights after a step; a step repeated from the same
start."""
import math
import os
import pickle
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs import LM_ARCHS, lm_common
from repro_torch.launch import lm as launcher
from repro_torch.launch.mesh import Mesh, ProductionMesh, make_host_mesh
from repro_torch.models import tensor_parallel as tp
from repro_torch.models import transformer
from repro_torch.sharding import block_ranges, device_blocks
from tests.conftest import run_subprocess

LOSS_TOL = 1e-5
REL_TOL = 1e-5
ARCHS = ("codeqwen1.5-7b", "qwen3-4b")
MODELS = (4, 2, 1)              # the model axis of a 4-shard mesh
SEQ, BATCH, STEPS = 64, 16, 2
CASES = [((8, 12), ("data", "model")), ((8, 12), (("data", "model"), None)),
         ((4, 8, 12), (None, "model", "data")), ((16,), ())]
GB = 1e9

_REF_CODE = """
import dataclasses, pickle
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import codeqwen15_7b, lm_common, qwen3_4b
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as rtf
from repro.training.optimizer import AdamW

MODELS, SEQ, BATCH, STEPS, CASES = {consts}
lm_common.SHAPES["train_4k"] = dict(kind="train", seq=SEQ, batch=BATCH)
ARCHS = {{"codeqwen1.5-7b": codeqwen15_7b.CONFIG,
          "qwen3-4b": qwen3_4b.CONFIG}}
with open(IN_PATH, "rb") as fh:
    batches = pickle.load(fh)
out = {{"blocks": {{}}, "runs": {{}}, "init": {{}}}}


def smoke(cfg):
    return dataclasses.replace(
        cfg, vocab=512, d_model=64, n_layers=2, n_heads=4,
        n_kv=max(1, 4 * cfg.n_kv // cfg.n_heads), head_dim=16, d_ff=128,
        dtype="float32", q_chunk=32, kv_chunk=32)


def to_np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


for model in MODELS:
    mesh = make_host_mesh(model=model)
    for shape, s in CASES:
        idx = NamedSharding(mesh, P(*s)).devices_indices_map(shape)
        out["blocks"][model, s, shape] = [
            tuple(sl.indices(n)[:2] for sl, n in zip(idx[d], shape))
            for d in mesh.devices.flat]
    for name, full in ARCHS.items():
        cfg = smoke(full)
        cell = lm_common.build_lm_cell(cfg, "train_4k", mesh)
        step = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                       out_shardings=cell.out_shardings)
        params = rtf.lm_init(jax.random.key(0), cfg)
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
print("TP_REF_OK")
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
        code = _REF_CODE.format(consts=(MODELS, SEQ, BATCH, STEPS, CASES))
        code = code.replace("IN_PATH", repr(src)).replace("OUT_PATH",
                                                          repr(dst))
        r = run_subprocess(code, devices=4, timeout=900)
        assert "TP_REF_OK" in r.stdout, r.stderr[-3000:]
        with open(dst, "rb") as fh:   # written by the subprocess above
            return pickle.load(fh)


def _smoke(arch: str):
    return lm_common.smoke_config(LM_ARCHS[arch])


def _mesh(model: int):
    return make_host_mesh(4, model=model, device="cpu")


def _train(model, cfg, mesh=None, steps: int = STEPS):
    """``steps`` steps of the cell on :func:`_batches` (micro-batches of the
    reference's mesh cell, 4); returns ``(losses, opt_state)``."""
    opt = lm_common.train_optimizer()
    state = opt.init(lm_common.zero1_params(model) if mesh is not None
                     else dict(model.named_parameters()))
    losses = []
    for t, (toks, tgts) in enumerate(_batches()[:steps]):
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
        losses, state = _train(one, cfg)
        out[arch, None] = dict(params=one.state_dict(), mu=state.mu,
                               nu=state.nu, losses=losses)
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
    """The module docstring's tolerances: losses, mu and nu per parameter,
    weights per parameter (``bk`` apart) and as one tree."""
    assert max(abs(a - b) for a, b in zip(got["losses"], want["losses"])) \
        <= LOSS_TOL
    for key in ("mu", "nu", "params"):
        g, w = got[key], want[key]
        assert g.keys() == w.keys()
        for name in w:
            if key == "params" and name.endswith(".bk"):
                continue
            assert _rel(g[name], w[name]) <= REL_TOL, (key, name)
        total = math.sqrt(sum(float(((g[k] - w[k]) ** 2).sum()) for k in w))
        assert total <= REL_TOL * math.sqrt(sum(float((w[k] ** 2).sum())
                                                for k in w)), key


# ---------------------------------------------------------------------------
# the mesh and the blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", MODELS)
def test_device_blocks_are_the_reference_devices_indices_map(ref, model):
    """Each device's block, in the mesh's row-major order, is the one
    ``NamedSharding.devices_indices_map`` gives on the reference's
    ``make_host_mesh(model=)``: tuple entries (the first axis major),
    replicated dimensions, specs shorter than the array."""
    for shape, s in CASES:
        want = ref["blocks"][model, s, shape]
        assert device_blocks(_mesh(model), s, shape) == want, (s, shape)
        stand_in = ProductionMesh(("data", "model"), (4 // model, model))
        assert device_blocks(stand_in, s, shape) == want


def test_device_blocks_refuse_what_they_cannot_split():
    mesh = ProductionMesh(("data", "model"), (2, 2))
    with pytest.raises(ValueError, match="does not split"):
        device_blocks(mesh, ("model",), (3,))
    with pytest.raises(ValueError, match="outside"):
        device_blocks(mesh, ("expert",), (4,))
    one = ProductionMesh(("model",), (4,))
    assert block_ranges(one, "model", 8) == [
        b[0] for b in device_blocks(one, ("model",), (8,))]


def test_mesh_takes_named_axes():
    """``make_host_mesh(model=)`` is the reference's ``("data", "model")``
    of ``(world // model, model)``; coordinates are row-major; each
    axis' groups; a one-axis mesh is what it was."""
    mesh = make_host_mesh(8, model=2, device="cpu")
    assert mesh.shape == {"data": 4, "model": 2} and mesh.world == 8
    assert mesh.coords(5) == (2, 1)
    assert mesh.device_at(2, 1) == mesh.devices[5]
    assert mesh.axis_groups("model") == [(0, 1), (2, 3), (4, 5), (6, 7)]
    assert mesh.axis_groups("data") == [(0, 2, 4, 6), (1, 3, 5, 7)]
    assert mesh.groups() == [(torch.device("cpu"), tuple(range(8)))]
    one = make_host_mesh(3, device="cpu", axis_name="model")
    assert one.shape == {"model": 3} and one.axis_names == ("model",)
    assert one.axis_groups("model") == [(0, 1, 2)]
    assert Mesh(("cpu",) * 2, "x").shape == {"x": 2}
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(4, model=3, device="cpu")
    with pytest.raises(ValueError, match="do not hold"):
        Mesh(("cpu",) * 4, ("data", "model"), (2, 3))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("arch", ARCHS)
def test_shards_hold_the_zero1_blocks(arch, model):
    """Each shard holds its block of every weight under the ZeRO-1 specs:
    the same blocks on every data replica, query heads and the FFN split
    over ``"model"``, norm gains whole; its bytes are
    ``train_placement``'s."""
    cfg = _smoke(arch)
    mesh = _mesh(model)
    lm = transformer.LM(cfg, device="cpu", mesh=mesh,
                        rules=lm_common.train_rules(mesh, cfg))
    place = lm_common.train_placement(cfg, mesh)
    assert len(lm.shards) == 4 and lm.groups == mesh.axis_groups("model")
    for i, sh in enumerate(lm.shards):
        blk = sh.layers[0]
        assert blk.wq.shape == (64, 64 // model)
        assert blk.w2.shape == (128 // model, 64)
        assert sh.embed.shape == (512 // model, 64)
        assert blk.ln1.weight.shape == (64,)
        assert sum(p.numel() * 4 for p in sh.parameters()) == \
            place.weight_bytes[i]
    plan = lm.plan
    assert plan.gather_kv == (arch == "qwen3-4b" and model > 1)
    assert [p.heads for p in plan.shards] == [
        (m * 4 // model, (m + 1) * 4 // model) for m in range(model)]


# ---------------------------------------------------------------------------
# the weights on a mesh
# ---------------------------------------------------------------------------
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
                (drawn, transformer.lm_init(torch.Generator().manual_seed(3),
                                            cfg, mesh=mesh, rules=rules))):
            g, w = transformer.gathered_state_dict(got), want.state_dict()
            assert list(g) == list(w)
            assert all(torch.equal(g[k], w[k]) for k in w), m


def test_a_tensor_parallel_lm_is_dense():
    """The tensor-parallel plan takes a dense arch's ZeRO-1 blocks; an
    MoE on a train mesh holds its full-FSDP blocks and takes the plan of
    the blocks gathered over ``"data"``; a dense arch under full FSDP is
    refused."""
    mesh = _mesh(2)
    cfg = _smoke("deepseek-moe-16b")
    moe = transformer.LM(cfg, device="cpu", mesh=mesh,
                         rules=lm_common.train_rules(mesh, cfg))
    assert moe.shards[0].layers[0].wq.shape == (32, 32)
    assert moe.plan.shards[1].heads == (2, 4)
    qwen = _smoke("qwen3-4b")
    fsdp = lm_common.lm_rules(mesh, "train_4k", qwen)
    with pytest.raises(ValueError, match="ZeRO-1"):
        transformer.LM(qwen, device="cpu", mesh=mesh, rules=fsdp)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_on_a_mesh_matches_the_reference(ref, runs, arch, model):
    """Two steps on (4 / model, model) against the reference's cell jitted
    with its shardings on the same mesh shape."""
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
    """After the steps every shard that holds a weight block holds the
    same bits (the ZeRO-1 gather), and two runs from the same start give
    the same bits, losses included."""
    arch = "qwen3-4b"
    run = runs[arch, model]
    lm = run["model"]
    layout = lm_common.zero1_layout(lm)
    for name in layout.shapes:
        for i, holders in enumerate(layout.holders[name]):
            mine = lm.shards[i].get_parameter(name)
            for j in holders:
                assert torch.equal(lm.shards[j].get_parameter(name), mine)
    cfg = _smoke(arch)
    mesh = _mesh(model)
    again = transformer.lm_init(torch.Generator().manual_seed(5), cfg,
                                mesh=mesh,
                                rules=lm_common.train_rules(mesh, cfg))
    twice = transformer.lm_init(torch.Generator().manual_seed(5), cfg,
                                mesh=mesh,
                                rules=lm_common.train_rules(mesh, cfg))
    (l1, s1), (l2, s2) = _train(again, cfg, mesh, 1), _train(twice, cfg,
                                                             mesh, 1)
    assert l1 == l2
    g1, g2 = (transformer.gathered_state_dict(again),
              transformer.gathered_state_dict(twice))
    assert all(torch.equal(g1[k], g2[k]) for k in g1)
    assert all(torch.equal(s1.mu[k], s2.mu[k]) for k in s1.mu)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_weight_replicated_over_model_gets_partial_gradients(arch):
    """On a (1, 4) mesh each shard's copy of a norm gain (and, in
    qwen3-4b's smoke reduction, of ``q_norm``/``k_norm``) gets only the
    gradient of its own use: the copies differ, and their sum in shard
    order is the unsharded model's gradient (within fp32 rounding) —
    the sum the train step makes."""
    cfg = _smoke(arch)
    mesh = _mesh(4)
    one = transformer.lm_init(torch.Generator().manual_seed(1), cfg)
    four = transformer.lm_init(torch.Generator().manual_seed(1), cfg,
                               mesh=mesh,
                               rules=lm_common.train_rules(mesh, cfg))
    toks, tgts = (torch.from_numpy(t).long() for t in _batches()[0])
    transformer.lm_loss(one, toks[:4], tgts[:4], cfg,
                        **lm_common.SMOKE_CHUNKS).backward()
    tp.group_loss(four, 0, toks[:4], tgts[:4], cfg, count=4 * SEQ,
                  chunk=transformer.LOSS_CHUNK,
                  **lm_common.SMOKE_CHUNKS).backward()
    names = ["layers.0.ln1.weight", "final_ln.weight"] + (
        ["layers.1.q_norm.weight", "layers.1.k_norm.weight"]
        if cfg.qk_norm else [])
    for name in names:
        parts = [sh.get_parameter(name).grad for sh in four.shards]
        want = one.get_parameter(name).grad
        assert not torch.equal(parts[0], parts[1]), name
        assert _rel(parts[0], want) > 0.1, name
        total = parts[0] + parts[1] + parts[2] + parts[3]
        assert _rel(total, want) <= REL_TOL, name


def test_mesh_step_refuses_a_batch_that_does_not_split():
    cfg = _smoke("codeqwen1.5-7b")
    mesh = _mesh(1)
    lm = transformer.lm_init(torch.Generator().manual_seed(0), cfg,
                             mesh=mesh,
                             rules=lm_common.train_rules(mesh, cfg))
    opt = lm_common.train_optimizer()
    state = opt.init(lm_common.zero1_params(lm))
    toks = torch.zeros((8, SEQ), dtype=torch.long)
    with pytest.raises(ValueError, match="data axis of 4"):
        lm_common.train_step(lm, opt, state, {"tokens": toks,
                                              "targets": toks}, cfg,
                             micro=4)


# ---------------------------------------------------------------------------
# placement and the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,weights,state,total", [
    ((1, 4), 16.38, 16.38, 32.76), ((2, 2), 32.76, 16.38, 49.14),
    ((4, 1), 65.52, 16.38, 81.90), ((1, 1), 65.52, 65.52, 131.04)])
def test_train_placement_in_closed_form(shape, weights, state, total):
    """codeqwen1.5-7b's fp32 state a card at full size: its 8,190,038,016
    parameter elements (QKV biases included: 393,216 above the reference's
    count) split by the ZeRO-1 weight specs and the FSDP state specs."""
    cfg = LM_ARCHS["codeqwen1.5-7b"]
    n = sum(p.numel() for p in transformer.LM(cfg, device="meta")
            .parameters())
    assert n == 8_190_038_016 == transformer.lm_param_count(cfg) + 393_216
    place = lm_common.train_placement(cfg, ProductionMesh(("data", "model"),
                                                          shape))
    for i in range(shape[0] * shape[1]):
        assert round(2 * place.weight_bytes[i] / GB, 2) == weights
        assert round(place.state_bytes[i] / GB, 2) == state
        assert round(place.shard_bytes[i] / GB, 2) == total
    assert place.card_bytes == place.shard_bytes
    one_card = lm_common.train_placement(
        cfg, ProductionMesh(("data", "model"), shape), cards=1)
    assert one_card.card_bytes == (sum(place.shard_bytes),)


def _refused(argv, capsys) -> str:
    with pytest.raises(SystemExit) as exc:
        launcher.parse_args(argv)
    assert exc.value.code == 2
    return capsys.readouterr().err


def test_launcher_checks_each_card_of_a_train_mesh(capsys):
    """codeqwen1.5-7b: ``--mesh-world 4`` (model 4) passes at 32.76 GB a
    card; ``--model 1`` is refused at 81.90 GB, naming ``--model 2``;
    world 1 is refused naming A10b and the smallest mesh; phi3.5-moe-42b
    does not fit four cards and is refused naming the sixteen it needs;
    the micro-batches must split over ``"data"``."""
    base = ["--shape", "train_4k", "--arch", "codeqwen1.5-7b"]
    args = launcher.parse_args(base + ["--mesh-world", "4"])
    assert (args.model, args.batch, args.micro) == (4, 1, 1)
    assert launcher.parse_args(base + ["--mesh-world", "4", "--model",
                                       "2"]).batch == 2
    err = _refused(base + ["--mesh-world", "4", "--model", "1"], capsys)
    assert "81.90 GB of fp32 train state" in err
    assert "the smallest --model that fits is 2" in err
    err = _refused(base, capsys)
    assert "131.0 GB of fp32 train state" in err and "A10b" in err
    assert "--mesh-world 2" in err
    assert "does not divide" in _refused(base + ["--mesh-world", "4",
                                                 "--model", "3"], capsys)
    assert "does not split over the data axis of 2" in _refused(
        base + ["--mesh-world", "4", "--model", "2", "--batch", "2",
                "--micro", "2"], capsys)
    assert "the smallest --mesh-world that fits, one shard a card, is 16" \
        in _refused(["--shape", "train_4k", "--arch", "phi3.5-moe-42b",
                     "--mesh-world", "4"], capsys)
    assert "train_4k mesh" in _refused(["--model", "2"], capsys)
    four = launcher.parse_args(["--shape", "train_4k", "--mesh-world", "4",
                                "--model", "1", "--smoke"])
    assert (four.batch, four.micro) == (16, 4)


def test_launcher_trains_on_a_mesh_on_the_cpu():
    """``--device cpu --smoke --mesh-world 4 --model 2``: each shard holds
    the bytes ``train_placement`` plans; step 0's loss is the one-shard
    run's on the same draws (within ``LOSS_TOL``); the stages add the
    data-axis sum and the gather."""
    argv = ["--shape", "train_4k", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--micro", "1", "--seed", "3"]
    one = launcher.main(argv)
    keep = {}
    four = launcher.train(launcher.parse_args(argv + ["--mesh-world", "4",
                                                      "--model", "2"]),
                          keep=keep)
    assert (four["mesh_world"], four["model"], four["data"]) == (4, 2, 2)
    assert abs(four["losses"][0] - one["losses"][0]) <= LOSS_TOL
    sb = four["shard_bytes"]
    assert sb["weights"] == sb["planned_weights"]
    assert sb["state"] == sb["planned_state"]
    assert set(four["stage_ms"][0]) == {"forward", "backward", "data_sum",
                                        "optimizer", "gather"}
    (card,) = four["cards"]
    assert card["shards"] == [0, 1, 2, 3]
    assert card["planned_bytes"] == sum(2 * w + s for w, s in zip(
        sb["planned_weights"], sb["planned_state"]))
    assert keep["opt_state"].step == 2 and keep["model"].tensor_parallel


def test_profile_train_cells_takes_a_mesh(monkeypatch):
    """``bench/profile_train_cells.py --cell lm --mesh-world W --model M``
    builds the launcher's cell on that mesh."""
    from repro_torch.bench import profile_train_cells
    seen = []
    monkeypatch.setattr(launcher, "train_cell", lambda args: (
        seen.append(args), (None, 0, None, None))[1])
    profile_train_cells._cell("lm", arch="codeqwen1.5-7b", mesh_world=4,
                              model=2)
    (args,) = seen
    assert (args.arch, args.mesh_world, args.model, args.batch,
            args.micro) == ("codeqwen1.5-7b", 4, 2, 2, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        profile_train_cells.main(["--cell", "lm", "--mesh-world", "4"])
