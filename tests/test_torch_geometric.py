"""The port's geometric GNN training path against the JAX reference on the
CPU: SchNet and MeshGraphNet (``repro_torch.models.schnet``,
``.meshgraphnet`` and their configs), the architecture registry, the
training launcher for all three geometric architectures, and the
MeshGraphNet training script. EquiformerV2 is in
``tests/test_torch_equiformer.py``.

Weights are the reference's ``_init`` trees carried over with
``*_from_numpy``; batches are ``make_concrete_batch`` of the reference's
``REDUCED`` shapes (the same bits in both packages).

Tolerances: losses within 1e-5 (relative; the molecule losses are ~100);
gradients per parameter within ``GRAD_TOL`` = 1e-5 of that parameter's
largest reference entry (measured: ≤ 1.4e-6). One rule for ReLUs: where a
pre-activation lies within fp32 rounding of zero, the port's fp32 and the
reference's may take either side of the kink, and that hidden unit's row
of the gradient moves by one edge's term (MeshGraphNet at
``full_graph_sm``: block 5's edge MLP, one unit at 1.08e-6 in fp64, moves
the port's fp32 gradient 3.9e-3 off). So the port's gradient is also
computed in fp64: it is held to the reference for every parameter; the
fp32 one wherever it agrees with the port's own fp64 one within
``GRAD_TOL`` (no kink moved by the port's fp32 rounding), and all of it
together within ``NORM_TOL`` = 1e-3 of the reference's norm (the flip
above: 3.8e-4, reaching every parameter upstream of that block)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gnn_common as jax_common
from repro.configs import meshgraphnet as jax_mgn
from repro.configs import schnet as jax_schnet
from repro.models import common as jax_model_common
from repro.models import schnet as jax_schnet_model
from repro.models.meshgraphnet import mgn_init as jax_mgn_init
from repro.training import AdamW as JaxAdamW
from repro.training import run_training as jax_run_training
from repro_torch.configs import (ALL_ARCHS, equiformer_v2, get_arch,
                                 gnn_common, list_archs, meshgraphnet,
                                 schnet)
from repro_torch.launch import train as launcher
from repro_torch.launch import train_gnn_100m
from repro_torch.models.common import count_params, dense_init, linspace
from repro_torch.models.meshgraphnet import mgn_from_numpy, mgn_init
from repro_torch.models.schnet import (schnet_from_numpy, schnet_init,
                                       shifted_softplus)
from repro_torch.training import AdamW, CheckpointManager, run_training

GRAD_TOL = 1e-5
NORM_TOL = 1e-3
LOSS_RTOL = 1e-5
MGN_ENTRY_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its shapes are tiny, and the
    suite's parallel workers would otherwise oversubscribe the cores (each
    of torch's small ops spinning up a thread team)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCHS = {"schnet": (jax_schnet, schnet, schnet_from_numpy),
         "meshgraphnet": (jax_mgn, meshgraphnet, mgn_from_numpy)}


def _ref_params(arch, info, seed=1):
    jmod = ARCHS[arch][0]
    n_out = info["classes"] if info["classes"] is not None else 1
    return jax.tree_util.tree_map(
        np.asarray, jmod._init(jax.random.key(seed), info["d_feat"], n_out,
                               "custom"))


def _batches(info, seed):
    return (jax_common.make_concrete_batch(info, seed=seed),
            gnn_common.make_concrete_batch(info, seed=seed, device="cpu"))


def _port_grads(model, loss_fn, batch, dtype):
    model = model.to(dtype)
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
    named = dict(model.named_parameters())
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), {k: g.double() for k, g in zip(named, grads)}


def hold_gradients(got32, got64, want, tol, size_of=lambda k: k):
    """The rule of the module docstring. ``want``: the reference's
    gradients by the port's names; each held over the largest entry of
    ``want[size_of(name)]`` (a gradient that is zero by construction must
    be zero). Returns the names whose fp32 gradient a kink moved."""
    assert sorted(got32) == sorted(got64) == sorted(want)
    moved = []
    flat = [torch.cat([g[k].flatten() for k in want])
            for g in (got32, want)]
    assert float((flat[0] - flat[1]).norm()) <= NORM_TOL * float(
        flat[1].norm())

    def err(a, b, k):
        size = float(want[size_of(k)].abs().max())
        diff = float((a - b).abs().max())
        return diff / size if size else (0.0 if diff == 0 else np.inf)

    for k in want:
        assert err(got64[k], want[k], k) <= tol, (k, err(got64[k], want[k],
                                                         k))
        if err(got32[k], got64[k], k) <= tol:
            assert err(got32[k], want[k], k) <= tol, (
                k, err(got32[k], want[k], k))
        else:
            moved.append(k)
    return moved


@pytest.mark.parametrize("shape", sorted(gnn_common.REDUCED))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_gradients_match_reference(arch, shape):
    """``_loss`` (node classification, or molecule regression through
    ``mol_id`` at ``molecule``) and every parameter's gradient at the
    ``_init`` widths, against ``jax.value_and_grad`` of the reference."""
    jmod, mod, from_numpy = ARCHS[arch]
    info = gnn_common.REDUCED[shape]
    params = _ref_params(arch, info)
    ref_b, b = _batches(info, seed=3)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jmod._loss(p, ref_b, info, shape))(
            jax.tree_util.tree_map(jnp.asarray, params))
    want = {k: v.detach().double() for k, v in from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_grads),
        device="cpu").named_parameters()}

    def loss_fn(m, batch):
        return mod._loss(m, batch, info, shape)

    loss32, g32 = _port_grads(from_numpy(params, device="cpu"), loss_fn, b,
                              torch.float32)
    _, g64 = _port_grads(from_numpy(params, device="cpu"), loss_fn, b,
                         torch.float64)
    np.testing.assert_allclose(loss32, float(ref_loss), rtol=LOSS_RTOL)
    hold_gradients(g32, g64, want, GRAD_TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_reference(arch):
    """Node outputs at ``full_graph_sm`` and per-molecule outputs at
    ``molecule``, within 1e-5."""
    from repro.models.meshgraphnet import mgn_forward as jax_mgn_forward
    from repro_torch.configs.meshgraphnet import _edge_feat
    from repro_torch.models.meshgraphnet import mgn_forward
    from repro_torch.models.schnet import schnet_forward
    for shape in ("full_graph_sm", "molecule"):
        info = gnn_common.REDUCED[shape]
        params = _ref_params(arch, info)
        ref_b, b = _batches(info, seed=4)
        model = ARCHS[arch][2](params, device="cpu")
        if arch == "schnet":
            kw = (dict(mol_id=ref_b["mol_id"], num_graphs=info["graphs"])
                  if info["graphs"] else {})
            want = jax_schnet_model.schnet_forward(
                jax.tree_util.tree_map(jnp.asarray, params),
                ref_b["species"], ref_b["positions"], ref_b["src"],
                ref_b["dst"], num_nodes=info["nodes"],
                node_feat=ref_b["node_feat"], **kw)
            kw = (dict(mol_id=b["mol_id"], num_graphs=info["graphs"])
                  if info["graphs"] else {})
            with torch.no_grad():
                got = schnet_forward(model, b["species"], b["positions"],
                                     b["src"], b["dst"],
                                     num_nodes=info["nodes"],
                                     node_feat=b["node_feat"], **kw)
        else:
            want = jax_mgn_forward(
                jax.tree_util.tree_map(jnp.asarray, params),
                ref_b["node_feat"], jax_mgn._edge_feat(ref_b),
                ref_b["src"], ref_b["dst"], num_nodes=info["nodes"])
            ef = _edge_feat(b)
            np.testing.assert_allclose(ef.numpy(), np.asarray(
                jax_mgn._edge_feat(ref_b)), rtol=1e-6, atol=1e-6)
            with torch.no_grad():
                got = mgn_forward(model, b["node_feat"], ef, b["src"],
                                  b["dst"], num_nodes=info["nodes"])
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_padded_edges_send_nothing():
    """Edges with a -1 end contribute nothing: the outputs equal those of
    the graph without them (SchNet and MeshGraphNet)."""
    from repro_torch.configs.meshgraphnet import _edge_feat
    from repro_torch.models.meshgraphnet import mgn_forward
    from repro_torch.models.schnet import schnet_forward
    info = gnn_common.REDUCED["ogb_products"]
    b = gnn_common.make_concrete_batch(info, seed=6, device="cpu")
    keep = slice(0, 700)
    padded = dict(b, src=b["src"].clone(), dst=b["dst"].clone())
    padded["src"][700:800] = -1
    padded["dst"][800:] = -1
    sch = schnet_init(torch.Generator().manual_seed(0), d_out=3,
                      d_feat_in=info["d_feat"], device="cpu")
    mgn = mgn_init(torch.Generator().manual_seed(0), d_node_in=info["d_feat"],
                   d_edge_in=4, d_hidden=32, n_layers=3, device="cpu")
    trimmed = {k: (v[keep] if k in ("src", "dst") else v)
               for k, v in b.items()}
    outs = []
    with torch.no_grad():
        for batch in (padded, trimmed):
            outs.append((
                schnet_forward(sch, batch["species"], batch["positions"],
                               batch["src"], batch["dst"],
                               num_nodes=info["nodes"],
                               node_feat=batch["node_feat"]),
                mgn_forward(mgn, batch["node_feat"], _edge_feat(batch),
                            batch["src"], batch["dst"],
                            num_nodes=info["nodes"])))
    for x, y in zip(*outs):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_shifted_softplus_and_rbf_grid_match_reference():
    """``shifted_softplus`` over [-60, 60] within 2 fp32 ulps of the
    softplus before ``- log 2`` (near 0 that subtraction cancels), bit for
    bit above 20 (``F.softplus`` returns x there, which is what
    ``jax.nn.softplus`` rounds to); and the radial grid (``linspace``) bit
    for bit, so both RBF expansions see the same centers."""
    x = np.linspace(-60, 60, 24001, dtype=np.float32)
    got = shifted_softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_schnet_model.shifted_softplus(jnp.asarray(x)))
    ulp = np.spacing(np.maximum(np.asarray(jax.nn.softplus(jnp.asarray(x))),
                                np.float32(np.log(2.0))))
    assert np.all(np.abs(got - want) <= 2 * ulp)
    big = x > 20
    assert np.array_equal(got[big], want[big])
    for stop, n in ((10.0, 300), (5.0, 32), (5.0, 8), (10.0, 64)):
        a = linspace(0.0, stop, n).numpy()
        b = np.asarray(jnp.linspace(0.0, stop, n))
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), (stop, n)


@pytest.mark.parametrize("arch,d_feat,n_out", [
    ("schnet", 64, 16), ("schnet", 0, 1), ("meshgraphnet", 64, 16),
    ("meshgraphnet", 8, 1)])
def test_init_widths_and_counts_match_reference(arch, d_feat, n_out):
    """``_init`` at the published widths has the reference's parameter
    count (SchNet 103,856 and MeshGraphNet 1,796,752 at d_feat 64 / 16
    classes), one seed gives the same weights on any call, and the
    weights follow the reference's distributions (zero biases, unit
    LayerNorm gains, SchNet's in_proj without a bias)."""
    jmod, mod, _ = ARCHS[arch]
    ref = jmod._init(jax.random.key(0), d_feat, n_out, "custom")
    a = mod._init(torch.Generator().manual_seed(0), d_feat, n_out, "custom",
                  device="cpu")
    b = mod._init(torch.Generator().manual_seed(0), d_feat, n_out, "custom",
                  device="cpu")
    assert count_params(a) == jax_model_common.count_params(ref)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for k, v in sa.items():
        if k.endswith(".bias"):
            assert not v.any(), k
        if k.endswith("ln.weight"):
            assert torch.equal(v, torch.ones_like(v)), k
    if arch == "schnet":
        assert a.interactions[0].in_proj.bias is None
        assert (a.feat_proj is None) == (d_feat == 0)
        assert len(a.interactions) == schnet.N_INTER == 3
        assert a.n_rbf == schnet.N_RBF == 300
        assert abs(float(a.embed.std()) - 0.1) < 0.02
    else:
        assert len(a.blocks) == meshgraphnet.N_LAYERS == 15
    w = sa["interactions.0.filter1.weight" if arch == "schnet"
           else "blocks.0.edge.mlp.layers.0.weight"]
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.05


def test_dense_init_without_bias():
    lin = dense_init(torch.Generator().manual_seed(0), 8, 4, bias=False)
    assert lin.bias is None and lin.weight.shape == (4, 8)
    with_bias = dense_init(torch.Generator().manual_seed(0), 8, 4)
    assert torch.equal(lin.weight, with_bias.weight)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_run_training_matches_reference(arch):
    """Three steps on the same per-step batches at lr 1e-2 with no
    warm-up, held as ``tests/test_torch_train.py::
    test_run_training_matches_reference`` holds GIN-TU: the logged losses
    within ±1e-4, and each parameter's change over the run within 1e-3 of
    its norm and 1e-4 (plus 1e-3 relative) per entry of the reference's
    change. MeshGraphNet's 30 ReLU MLPs break the per-entry bound: as the
    weights move, pre-activations cross zero within fp32 rounding, and
    either package's fp32 takes its own side of the kink (measured: 90
    entries of ``blocks.9.node.mlp.layers.0.weight`` up to 1.03e-3 off,
    and the port's fp64 run off in the same rows, so the reference's
    rounding flips too). For it each entry is held within
    ``MGN_ENTRY_TOL`` = 2e-3 instead, a fifteenth of the 3e-2 an
    unapplied or wrong-signed run moves every entry; the norm bound is
    GIN-TU's (measured 7.5e-4)."""
    jmod, mod, from_numpy = ARCHS[arch]
    info = gnn_common.REDUCED["ogb_products"]
    params = _ref_params(arch, info)
    opt_kw = dict(lr=1e-2, weight_decay=0.0, warmup_steps=1)
    ref_logs, logs = [], []
    ref_state = jax_run_training(
        loss_fn=lambda p, b: jmod._loss(p, b, info, "custom"),
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt=JaxAdamW(**opt_kw),
        batch_fn=lambda s: jax_common.make_concrete_batch(info, seed=s),
        steps=3, log_every=1, log_fn=ref_logs.append)
    model = from_numpy(params, device="cpu")
    state = run_training(
        loss_fn=lambda m, b: mod._loss(m, b, info, "custom"),
        model=model, opt=AdamW(**opt_kw),
        batch_fn=lambda s: gnn_common.make_concrete_batch(info, seed=s,
                                                          device="cpu"),
        steps=3, log_every=1, log_fn=logs.append)

    def losses(lines):
        return [float(x.split("loss=")[1].split()[0]) for x in lines]

    assert len(losses(logs)) == len(losses(ref_logs)) == 3
    np.testing.assert_allclose(losses(logs), losses(ref_logs), rtol=0,
                               atol=1e-4 + 1e-9)
    assert state.step == ref_state.step == 3
    init = dict(from_numpy(params, device="cpu").state_dict())
    want = from_numpy(jax.tree_util.tree_map(np.asarray, ref_state.params),
                      device="cpu").state_dict()
    got = state.model.state_dict()
    for name in want:
        d_want = (want[name] - init[name]).numpy()
        d_got = (got[name] - init[name]).numpy()
        assert np.abs(d_want).max() > 1e-2, name
        np.testing.assert_allclose(
            d_got, d_want, err_msg=name,
            **(dict(rtol=0, atol=MGN_ENTRY_TOL) if arch == "meshgraphnet"
               else dict(rtol=1e-3, atol=1e-4)))
        assert (np.linalg.norm(d_got - d_want)
                <= 1e-3 * np.linalg.norm(d_want)), name


def test_registry_matches_reference():
    """Every reference architecture is registered with its family and
    description; the GNNs carry their adapter."""
    import repro.configs as jax_configs
    assert list_archs() == ALL_ARCHS == jax_configs.ALL_ARCHS
    for name in ALL_ARCHS:
        a, r = get_arch(name), jax_configs.get_arch(name)
        assert (a.name, a.family, a.description) == (r.name, r.family,
                                                     r.description)
        assert (a.adapter is not None) == (a.family == "gnn")
    assert get_arch("schnet").adapter.loss is schnet._loss
    assert get_arch("equiformer-v2").adapter.init is equiformer_v2._init
    with pytest.raises(KeyError):
        get_arch("nope")


def _reference_param_count(arch, d_feat, classes):
    from repro.configs import equiformer_v2 as jax_eq
    from repro.configs import gin_tu as jax_gin
    mod = {"gin-tu": jax_gin, "schnet": jax_schnet,
           "meshgraphnet": jax_mgn, "equiformer-v2": jax_eq}[arch]
    init = getattr(mod, "_reduced_init", None) or mod._init
    return jax_model_common.count_params(
        init(jax.random.key(0), d_feat, classes, "custom"))


LAUNCH = ["--device", "cpu", "--nodes", "96", "--edges", "400", "--d-feat",
          "12", "--classes", "4"]


@pytest.mark.parametrize("arch", ["schnet", "meshgraphnet", "equiformer-v2"])
def test_launcher_trains_resumes_and_counts_like_reference(arch, capsys,
                                                           tmp_path):
    """``--arch A`` trains on the CPU (finite losses), prints the
    reference launcher's parameter count (EquiformerV2 at
    ``_reduced_init``, as the reference builds it), and a run resumed
    from its step-2 checkpoint ends with the uninterrupted run's step-3
    loss."""
    whole = launcher.main(LAUNCH + ["--arch", arch, "--steps", "3"])
    out = capsys.readouterr().out
    n = _reference_param_count(arch, 12, 4)
    assert f"[train] {arch}: {n:,} params" in out
    assert whole["params"] == n and whole["step"] == 3
    assert len(whole["losses"]) == 3 and all(np.isfinite(whole["losses"]))
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    launcher.main(LAUNCH + ["--arch", arch, "--steps", "2"] + ck)
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    capsys.readouterr()
    resumed = launcher.main(LAUNCH + ["--arch", arch, "--steps", "3"] + ck)
    assert "[resume] restored step 2" in capsys.readouterr().out
    assert resumed["step"] == 3 and len(resumed["losses"]) == 1
    np.testing.assert_allclose(resumed["losses"][0], whole["losses"][2],
                               rtol=1e-6)


def test_train_gnn_100m_small_runs_on_cpu(capsys, tmp_path):
    """The MeshGraphNet script at ``small`` for 2 steps: the reference's
    parameter count at both scales, finite losses, a checkpoint at the
    last step, and the reference example's flags and defaults."""
    for scale, (h, n) in train_gnn_100m.SCALES.items():
        ref = jax_mgn_init(jax.random.key(0), d_node_in=64, d_edge_in=4,
                           d_hidden=h, n_layers=n, d_out=3)
        want = {"small": 985_091, "full": 37_609_475}[scale]
        assert jax_model_common.count_params(ref) == want
    a = train_gnn_100m.parse_args([])
    assert (a.steps, a.params_scale, a.nodes, a.ckpt_dir, a.device) == (
        300, "small", 2048, None, "cuda")
    report = train_gnn_100m.main(["--device", "cpu", "--steps", "2",
                                  "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] MeshGraphNet 985,091 params (128h x 8L)" in out
    assert report["params"] == 985_091 and report["step"] == 2
    assert len(report["losses"]) == 2 and all(np.isfinite(report["losses"]))
    assert len(report["step_ms"]) == 1
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
