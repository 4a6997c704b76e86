"""Port GIN-TU training against the JAX reference, on the CPU at the
``REDUCED`` shapes: the synthetic batch is the reference's bit for bit;
``gin_full_graph``, ``gin_graph_readout`` and ``gin_tu._loss`` and their
gradients (ε included) agree with ``jax.value_and_grad`` of the reference
on weights carried over with ``gin_from_numpy``; AdamW matches the
reference's update; three ``run_training`` steps match the reference's on
the same batches; the checkpoint manager keeps the reference's semantics
(roundtrip, keep-K, incomplete directories, corruption, resume equal to an
uninterrupted run); and the launcher runs on ``--device cpu``.

Tolerances: the port sums neighbors with the in-order ``segment_spmm``
and the reference with ``segment_sum``, and matrix products differ in
order, so model outputs, losses and gradients agree to fp32 rounding
(rtol/atol 1e-4 on gradients, whose small entries are cancellations;
1e-5 on losses and logits). The training run is held on the change of
each parameter; its test says why."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gin_tu as jax_gin_tu
from repro.configs import gnn_common as jax_common
from repro.models import gnn_basic as jax_gnn
from repro.training import AdamW as JaxAdamW
from repro.training import run_training as jax_run_training
from repro_torch.configs import gin_tu, gnn_common
from repro_torch.launch import train as launcher
from repro_torch.models.gnn_basic import (gin_from_numpy, gin_full_graph,
                                          gin_graph_readout, gin_init)
from repro_torch.training import (AdamW, CheckpointManager, global_norm,
                                  run_training)

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)


def _ref_params(info, seed=1, eps_step=0.1):
    """The reference's ``gin_init`` tree at ``info``'s widths, with a
    distinct nonzero ε per layer (so the ε terms are exercised)."""
    n_out = info["classes"] if info["classes"] is not None else 1
    params = jax_gin_tu._init(jax.random.key(seed), info["d_feat"], n_out,
                              "custom")
    for i, layer in enumerate(params["layers"]):
        layer["eps"] = jnp.asarray(eps_step * (i + 1), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


def _port_names(tree) -> dict:
    """Reference tree → the port's parameter names (weights transposed)."""
    out = {}
    for i, p in enumerate(tree["layers"]):
        for lin in ("mlp1", "mlp2"):
            out[f"layers.{i}.{lin}.weight"] = np.asarray(p[lin]["w"]).T
            out[f"layers.{i}.{lin}.bias"] = np.asarray(p[lin]["b"])
        out[f"layers.{i}.eps"] = np.asarray(p["eps"])
        out[f"layers.{i}.ln.weight"] = np.asarray(p["ln"]["g"])
        out[f"layers.{i}.ln.bias"] = np.asarray(p["ln"]["b"])
    out["readout.weight"] = np.asarray(tree["readout"]["w"]).T
    out["readout.bias"] = np.asarray(tree["readout"]["b"])
    return out


def _batches(info, seed):
    return (jax_common.make_concrete_batch(info, seed=seed),
            gnn_common.make_concrete_batch(info, seed=seed, device="cpu"))


@pytest.mark.parametrize("shape", sorted(gnn_common.REDUCED))
def test_concrete_batch_equals_reference(shape):
    info = gnn_common.REDUCED[shape]
    assert info == jax_common.REDUCED[shape]
    assert gnn_common.SHAPES[shape] == jax_common.SHAPES[shape]
    ref, ours = _batches(info, seed=11)
    assert sorted(ref) == sorted(ours)
    for k in ref:
        assert ours[k].numpy().dtype == np.asarray(ref[k]).dtype, k
        assert np.array_equal(ours[k].numpy(), np.asarray(ref[k])), k


@pytest.mark.parametrize("shape", ["ogb_products", "full_graph_sm"])
def test_gin_full_graph_matches_reference(shape):
    info = gnn_common.REDUCED[shape]
    params = _ref_params(info)
    ref_b, b = _batches(info, seed=3)
    want = jax_gnn.gin_full_graph(params, ref_b["node_feat"], ref_b["src"],
                                  ref_b["dst"], num_nodes=info["nodes"])
    model = gin_from_numpy(params, device="cpu")
    with torch.no_grad():
        got = gin_full_graph(model, b["node_feat"], b["src"], b["dst"],
                             num_nodes=info["nodes"])
    assert got.shape == (info["nodes"], info["classes"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_gin_graph_readout_matches_reference():
    info = gnn_common.REDUCED["molecule"]
    params = _ref_params(info)
    ref_b, b = _batches(info, seed=4)
    want = jax_gnn.gin_graph_readout(
        params, ref_b["node_feat"], ref_b["src"], ref_b["dst"],
        ref_b["mol_id"], num_nodes=info["nodes"], num_graphs=info["graphs"])
    with torch.no_grad():
        got = gin_graph_readout(gin_from_numpy(params, device="cpu"),
                                b["node_feat"], b["src"], b["dst"],
                                b["mol_id"], num_nodes=info["nodes"],
                                num_graphs=info["graphs"])
    assert got.shape == (info["graphs"], 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("shape", ["ogb_products", "full_graph_sm",
                                   "molecule"])
def test_loss_and_gradients_match_reference(shape):
    """``gin_tu._loss`` (both branches) and every parameter's gradient,
    ε included, against ``jax.value_and_grad`` of the reference."""
    info = gnn_common.REDUCED[shape]
    params = _ref_params(info)
    ref_b, b = _batches(info, seed=5)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jax_gin_tu._loss(p, ref_b, info, shape))(
            jax.tree_util.tree_map(jnp.asarray, params))
    model = gin_from_numpy(params, device="cpu")
    named = dict(model.named_parameters())
    loss = gin_tu._loss(model, b, info, shape)
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               **OUT_TOL)
    want = _port_names(ref_grads)
    assert sorted(want) == sorted(named)
    for name, g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD_TOL,
                                   err_msg=name)
    assert any(float(named[f"layers.{i}.eps"].detach()) != 0
               for i in range(5))


def test_gin_init_is_device_independent_and_shaped():
    a = gin_init(torch.Generator().manual_seed(0), 12, 64, 5, 7,
                 device="cpu")
    b = gin_tu._init(torch.Generator().manual_seed(0), 12, 7, "custom",
                     device="cpu")
    assert len(a.layers) == gin_tu.N_LAYERS == 5
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert sa["layers.0.mlp1.weight"].shape == (gin_tu.D_HIDDEN, 12)
    assert sa["readout.weight"].shape == (7, 64)
    assert all(float(sa[f"layers.{i}.eps"]) == 0.0 for i in range(5))


def _fixed_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


def test_adamw_matches_reference():
    """Five updates with warm-up, active clipping and weight decay: the
    same math in fp32, different scalar rounding, so rtol 1e-5."""
    kw = dict(lr=0.05, weight_decay=0.1, clip_norm=0.5, warmup_steps=3)
    ref_opt, opt = JaxAdamW(**kw), AdamW(**kw)
    p_ref = {k: jnp.asarray(v) for k, v in _fixed_tree().items()}
    s_ref = ref_opt.init(p_ref)
    p = {k: torch.from_numpy(v.copy()) for k, v in _fixed_tree().items()}
    s = opt.init(p)
    for i in range(5):
        g = _fixed_tree(seed=10 + i)
        p_ref, s_ref = ref_opt.update({k: jnp.asarray(v) for k, v in
                                       g.items()}, s_ref, p_ref)
        p, s = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, s,
                          p)
    assert s.step == int(s_ref.step) == 5
    for k in p:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(p_ref[k]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(s.mu[k].numpy(), np.asarray(s_ref.mu[k]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(s.nu[k].numpy(), np.asarray(s_ref.nu[k]),
                                   rtol=1e-5, atol=1e-7)


def test_global_norm_and_clipping_bound_the_update():
    t = [torch.tensor([3.0, 4.0]), torch.tensor([[12.0]])]
    assert float(global_norm(t)) == 13.0
    opt = AdamW(lr=1.0, clip_norm=1e-3, weight_decay=0.0, warmup_steps=1)
    p = {"w": torch.zeros(4)}
    opt.update({"w": torch.full((4,), 1e9)}, opt.init(p), p)
    assert float(p["w"].abs().max()) < 10.0


def test_run_training_matches_reference():
    """Three steps on the same per-step batches, at lr 1e-2 with no
    warm-up so that every step moves each parameter by up to 1e-2 (3e-2
    over the three) and the loss by several hundredths. Held: the logged
    losses (4 decimals, so ±1e-4), and each parameter's change over the run
    (final − initial) against the reference's change, within 1e-3 of its
    norm and 1e-4 per entry. Adam divides by sqrt(v), so an entry whose
    gradient is near zero turns a rounding difference into a step of up to
    lr; that is what the per-entry 1e-4 (1% of one step) absorbs. A loop
    that applied no update, or the wrong sign, is off by ~1e-2 per entry."""
    info = gnn_common.REDUCED["ogb_products"]
    params = _ref_params(info, eps_step=0.0)
    opt_kw = dict(lr=1e-2, weight_decay=0.0, warmup_steps=1)
    ref_logs, logs = [], []
    ref_state = jax_run_training(
        loss_fn=lambda p, b: jax_gin_tu._loss(p, b, info, "custom"),
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt=JaxAdamW(**opt_kw),
        batch_fn=lambda s: jax_common.make_concrete_batch(info, seed=s),
        steps=3, log_every=1, log_fn=ref_logs.append)
    model = gin_from_numpy(params, device="cpu")
    state = run_training(
        loss_fn=lambda m, b: gin_tu._loss(m, b, info, "custom"),
        model=model, opt=AdamW(**opt_kw),
        batch_fn=lambda s: gnn_common.make_concrete_batch(info, seed=s,
                                                          device="cpu"),
        steps=3, log_every=1, log_fn=logs.append)

    def losses(lines):
        return [float(x.split("loss=")[1].split()[0]) for x in lines]

    assert len(losses(logs)) == len(losses(ref_logs)) == 3
    np.testing.assert_allclose(losses(logs), losses(ref_logs), rtol=0,
                               atol=1e-4 + 1e-9)
    assert len(set(losses(ref_logs))) == 3
    assert state.step == ref_state.step == 3 and state.opt_state.step == 3
    init = _port_names(params)
    want = _port_names(jax.tree_util.tree_map(np.asarray, ref_state.params))
    got = state.model.state_dict()
    for name in want:
        d_want = want[name] - init[name]
        d_got = got[name].numpy() - init[name]
        assert np.abs(d_want).max() > 1e-2, name  # 100× the entry tolerance
        np.testing.assert_allclose(d_got, d_want, rtol=1e-3, atol=1e-4,
                                   err_msg=name)
        assert (np.linalg.norm(d_got - d_want)
                <= 1e-3 * np.linalg.norm(d_want)), name
    # the caller's model is not trained in place
    assert torch.equal(model.state_dict()["readout.weight"],
                       torch.from_numpy(params["readout"]["w"].T.copy()))


def test_checkpoint_roundtrip_and_gc(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)},
            "step": 7}
    for step in (10, 20, 30):
        mgr.save(step, tree, metadata={"step": step})
    assert mgr.latest_step() == 30
    # keep=2 → step 10 garbage-collected
    assert not os.path.exists(os.path.join(d, "step_000000000010"))
    out = mgr.restore(30, tree, verify=True)
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.int32
    assert torch.equal(out["b"]["c"], tree["b"]["c"]) and out["step"] == 7
    assert mgr.metadata(30)["step"] == 30


def test_checkpoint_ignores_incomplete(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d)
    mgr.save(5, {"x": torch.ones(3)})
    # a crashed writer: a tmp dir and a step dir without manifest
    os.makedirs(os.path.join(d, "tmp_000000000009_123"))
    os.makedirs(os.path.join(d, "step_000000000009"))
    assert mgr.latest_step() == 5
    CheckpointManager(d)  # a new manager removes the stale tmp dir
    assert not any(n.startswith("tmp_") for n in os.listdir(d))


def test_checkpoint_async_writer_copies_at_save(tmp_path):
    """An async save holds the values of the moment of the call, though
    the tensor is then updated in place (as the optimizer does)."""
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    x = torch.ones(128)
    mgr.save(1, {"x": x}, block=False)
    x.mul_(2)
    mgr.save(2, {"x": x}, block=False)
    mgr.wait()
    assert mgr.latest_step() == 2
    assert torch.equal(mgr.restore(1, {"x": x})["x"], torch.ones(128))
    assert torch.equal(mgr.restore(2, {"x": x})["x"], torch.full((128,), 2.))


def test_checkpoint_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"x": torch.arange(16.0)}
    mgr.save(1, tree)
    leaf = os.path.join(str(tmp_path), "step_000000000001", "leaf_00000.npy")
    arr = np.load(leaf)
    arr[0] = 999.0
    np.save(leaf, arr)
    with pytest.raises(ValueError, match="corrupt"):
        mgr.restore(1, tree, verify=True)


def test_resume_mid_run(tmp_path):
    """Kill-and-restart: a second run resumes from the checkpoint and ends
    at the same parameters and optimizer state as an uninterrupted run
    (deterministic batches)."""
    info = gnn_common.REDUCED["ogb_products"]
    model = gin_init(torch.Generator().manual_seed(0), info["d_feat"], 8, 2,
                     info["classes"], device="cpu")
    kw = dict(loss_fn=lambda m, b: gin_tu._loss(m, b, info, "custom"),
              model=model, opt=AdamW(lr=0.05, weight_decay=0.0,
                                     warmup_steps=1),
              batch_fn=lambda s: gnn_common.make_concrete_batch(
                  info, seed=s % 3, device="cpu"),
              log_every=1000)
    ref = run_training(steps=6, **kw)
    d = str(tmp_path)
    run_training(steps=3, ckpt=CheckpointManager(d), ckpt_every=3, **kw)
    logs = []
    resumed = run_training(steps=6, ckpt=CheckpointManager(d), ckpt_every=3,
                           log_fn=logs.append,
                           **{k: v for k, v in kw.items()})
    assert logs == ["[resume] restored step 3"]
    assert resumed.opt_state.step == ref.opt_state.step == 6
    a, b = resumed.model.state_dict(), ref.model.state_dict()
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_launcher_runs_on_cpu(capsys, tmp_path):
    report = launcher.main(["--device", "cpu", "--steps", "2", "--nodes",
                            "300", "--edges", "2000", "--d-feat", "16",
                            "--classes", "4", "--ckpt-dir", str(tmp_path),
                            "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert "[train] gin-tu:" in out and "[train] done at step 2" in out
    assert report["step"] == 2 and len(report["losses"]) == 2
    assert all(np.isfinite(report["losses"]))
    assert CheckpointManager(str(tmp_path)).latest_step() == 2


@pytest.mark.parametrize("argv,needle", [
    (["--arch", "schnet"], "ROADMAP A11"),
    (["--arch", "equiformer-v2"], "ROADMAP A11"),
    (["--arch", "nope"], "unknown --arch"),
    (["--sharded"], "unrecognized")])
def test_launcher_rejects_unported_archs_and_flags(argv, needle, capsys):
    with pytest.raises(SystemExit) as err:
        launcher.parse_args(argv)
    assert err.value.code == 2
    assert needle in capsys.readouterr().err


def test_launcher_defaults_are_the_reference_launchers():
    a = launcher.parse_args([])
    assert (a.arch, a.steps, a.nodes, a.edges, a.d_feat, a.classes,
            a.ckpt_every, a.lr, a.device) == (
        "gin-tu", 100, 4096, 32768, 64, 16, 50, 1e-3, "cuda")
