"""The port's EquiformerV2 (``repro_torch.models.equiformer_v2`` and
``repro_torch.configs.equiformer_v2``) against the JAX reference on the
CPU.

Two reduced configurations, each at the four ``REDUCED`` shapes: the
reference launcher's ``_reduced_init`` (2 layers, 16 channels, l_max 2,
m_max 1) and l_max 3 / m_max 2 (the reference's own equivariance test).
``minibatch_lg`` takes the 8-chunk edge path (``EDGE_CHUNKS``) and
``molecule`` the ``mol_id`` readout. Weights are reference trees carried
over with ``equiformer_from_numpy``.

Tolerances, as the reference's own tests hold EquiformerV2: outputs and
losses within 1e-5 (the molecule losses, ~40, within 1e-5 relative);
gradients per parameter within ``GRAD_TOL`` = 1e-4 of that parameter's
largest reference entry (measured: ≤ 5.5e-5), by the rule of
``tests/test_torch_geometric.py::hold_gradients``. Each layer's logit bias
(``alpha.layers.1.bias``) shifts a head's logits, which cancels between
the attention's numerator and denominator but for the tanh cap: its
gradient is 1e-4–8e-4 of the logit weight's, so it is held over that
weight's size. A gradient that is zero by construction (the first layer's
m > 0 SO(2) weights see no l > 0 input; the last layer's l > 0 outputs
reach no output) must be zero."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import equiformer_v2 as jax_eq_config
from repro.configs import gnn_common as jax_common
from repro.graph import molecule_batch
from repro.models import common as jax_model_common
from repro.models import equiformer_v2 as jax_eq
from repro.models.so3 import rotation_matrix_zyz
from repro.training import AdamW as JaxAdamW
from repro.training import run_training as jax_run_training
from repro_torch.configs import equiformer_v2, gnn_common
from repro_torch.models import equiformer_v2 as eq
from repro_torch.models.common import count_params
from repro_torch.training import AdamW, run_training
from test_torch_geometric import _port_grads, hold_gradients

GRAD_TOL = 1e-4
LOGIT_BIAS_STEP_TOL = 3e-3
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
L3M2 = dict(n_layers=2, channels=16, l_max=3, m_max=2, n_heads=4, n_rbf=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its shapes are tiny, and the
    suite's parallel workers would otherwise oversubscribe the cores (each
    of torch's small ops spinning up a thread team)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def logit_weight(name: str) -> str:
    """The parameter whose gradient size a logit bias is held over."""
    if name.endswith("alpha.layers.1.bias"):
        return name[:-len("bias")] + "weight"
    return name


def _ref_params(config, info, seed=1):
    n_out = info["classes"] if info["classes"] is not None else 1
    key = jax.random.key(seed)
    if config == "reduced":
        tree = jax_eq_config._reduced_init(key, info["d_feat"], n_out,
                                           "custom")
    else:
        tree = jax_eq.equiformer_init(key, d_feat_in=info["d_feat"],
                                      d_out=n_out, **L3M2)
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(info, seed):
    return (jax_common.make_concrete_batch(info, seed=seed),
            gnn_common.make_concrete_batch(info, seed=seed, device="cpu"))


@pytest.mark.parametrize("shape", sorted(gnn_common.REDUCED))
@pytest.mark.parametrize("config", ["reduced", "l3m2"])
def test_loss_and_gradients_match_reference(config, shape):
    info = gnn_common.REDUCED[shape]
    params = _ref_params(config, info)
    ref_b, b = _batches(info, seed=3)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jax_eq_config._loss(p, ref_b, info, shape))(
            jax.tree_util.tree_map(jnp.asarray, params))
    want = {k: v.detach().double() for k, v in eq.equiformer_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_grads),
        device="cpu").named_parameters()}

    def loss_fn(m, batch):
        return equiformer_v2._loss(m, batch, info, shape)

    loss32, g32 = _port_grads(eq.equiformer_from_numpy(params, device="cpu"),
                              loss_fn, b, torch.float32)
    _, g64 = _port_grads(eq.equiformer_from_numpy(params, device="cpu"),
                         loss_fn, b, torch.float64)
    np.testing.assert_allclose(loss32, float(ref_loss), **OUT_TOL)
    hold_gradients(g32, g64, want, GRAD_TOL, size_of=logit_weight)


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "molecule"])
def test_forward_matches_reference(shape):
    """Node logits (``minibatch_lg``: 8 edge chunks) and per-molecule
    outputs at l_max 3 / m_max 2, within 1e-5."""
    info = gnn_common.REDUCED[shape]
    params = _ref_params("l3m2", info)
    ref_b, b = _batches(info, seed=4)
    chunks = jax_eq_config.EDGE_CHUNKS[shape]
    assert chunks == equiformer_v2.EDGE_CHUNKS[shape]
    kw = (dict(num_graphs=info["graphs"]) if info["graphs"] else {})
    want = jax_eq.equiformer_forward(
        jax.tree_util.tree_map(jnp.asarray, params), ref_b["species"],
        ref_b["positions"], ref_b["src"], ref_b["dst"],
        num_nodes=info["nodes"], node_feat=ref_b["node_feat"],
        mol_id=ref_b.get("mol_id"), edge_chunks=chunks, **kw)
    with torch.no_grad():
        got = eq.equiformer_forward(
            eq.equiformer_from_numpy(params, device="cpu"), b["species"],
            b["positions"], b["src"], b["dst"], num_nodes=info["nodes"],
            node_feat=b["node_feat"], mol_id=b.get("mol_id"),
            edge_chunks=chunks, **kw)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_so2_layer_norm_and_chunks_match_reference():
    """``so2_apply``, ``_eq_layer_norm``, ``_rbf`` and ``_chunk_edges``
    on their own: outputs within 1e-5, chunks bit for bit."""
    rng = np.random.default_rng(7)
    l_max, m_max, c = 4, 2, 8
    S = (l_max + 1) ** 2
    p = jax.tree_util.tree_map(np.asarray, jax_eq.so2_init(
        jax.random.key(2), l_max, m_max, c, c))
    x = rng.normal(size=(50, S, c)).astype(np.float32)
    rad = rng.normal(size=(50, l_max + 1)).astype(np.float32)
    want = jax_eq.so2_apply(jax.tree_util.tree_map(jnp.asarray, p),
                            jnp.asarray(x), l_max, m_max, c,
                            jnp.asarray(rad))
    so2 = eq.SO2Linear(l_max, m_max, c, {k: torch.tensor(v)
                                         for k, v in p.items()})
    got = eq.so2_apply(so2, torch.from_numpy(x), torch.from_numpy(rad))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OUT_TOL)
    zero_rows = [eq.lm_index(l, m) for l in range(l_max + 1)
                 for m in range(-l, l + 1) if abs(m) > m_max]
    assert not got[:, zero_rows].any()
    g = rng.normal(size=(l_max + 1, c)).astype(np.float32)
    np.testing.assert_allclose(
        eq._eq_layer_norm(torch.from_numpy(g), torch.from_numpy(x),
                          l_max).numpy(),
        np.asarray(jax_eq._eq_layer_norm(jnp.asarray(g), jnp.asarray(x),
                                         l_max)), **OUT_TOL)
    dist = rng.uniform(0, 6, size=40).astype(np.float32)
    np.testing.assert_allclose(
        eq._rbf(torch.from_numpy(dist), 32, 5.0).numpy(),
        np.asarray(jax_eq._rbf(jnp.asarray(dist), 32, 5.0)), rtol=1e-6,
        atol=1e-7)
    ids = rng.integers(-1, 9, 37).astype(np.int32)
    for chunks, fill in ((8, -1), (5, 0)):
        a = eq._chunk_edges(torch.from_numpy(ids), chunks, fill).numpy()
        b = np.asarray(jax_eq._chunk_edges(jnp.asarray(ids), chunks, fill))
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_run_training_matches_reference():
    """Three steps at ``_reduced_init``, held as ``tests/test_torch_train.py
    ::test_run_training_matches_reference`` holds GIN-TU: the logged
    losses within ±1e-4, and each parameter's change over the run within
    1e-3 of its norm and 1e-4 (plus 1e-3 relative) per entry of the
    reference's change; a parameter whose gradient is zero by construction
    does not move on either side. The logit biases are held per entry
    within ``LOGIT_BIAS_STEP_TOL`` = 3e-3 instead: their gradient is a
    cancellation (module docstring), so Adam's division by sqrt(v) turns
    gradients that agree within 1e-4 of the logit weight's size into steps
    that differ by up to 10% (measured: 2.7e-4 of a 2.9e-3 change); a
    tenth of the 3e-2 that an unapplied or wrong-signed run moves an
    entry."""
    info = gnn_common.REDUCED["ogb_products"]
    params = _ref_params("reduced", info)
    opt_kw = dict(lr=1e-2, weight_decay=0.0, warmup_steps=1)
    ref_logs, logs = [], []
    ref_state = jax_run_training(
        loss_fn=lambda p, b: jax_eq_config._loss(p, b, info, "custom"),
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt=JaxAdamW(**opt_kw),
        batch_fn=lambda s: jax_common.make_concrete_batch(info, seed=s),
        steps=3, log_every=1, log_fn=ref_logs.append)
    state = run_training(
        loss_fn=lambda m, b: equiformer_v2._loss(m, b, info, "custom"),
        model=eq.equiformer_from_numpy(params, device="cpu"),
        opt=AdamW(**opt_kw),
        batch_fn=lambda s: gnn_common.make_concrete_batch(info, seed=s,
                                                          device="cpu"),
        steps=3, log_every=1, log_fn=logs.append)

    def losses(lines):
        return [float(x.split("loss=")[1].split()[0]) for x in lines]

    assert len(losses(logs)) == len(losses(ref_logs)) == 3
    np.testing.assert_allclose(losses(logs), losses(ref_logs), rtol=0,
                               atol=1e-4 + 1e-9)
    init = eq.equiformer_from_numpy(params, device="cpu").state_dict()
    want = eq.equiformer_from_numpy(jax.tree_util.tree_map(
        np.asarray, ref_state.params), device="cpu").state_dict()
    got = state.model.state_dict()
    still = 0
    for name in want:
        d_want = (want[name] - init[name]).numpy()
        d_got = (got[name] - init[name]).numpy()
        if not d_want.any():
            still += 1
            assert not d_got.any(), name
            continue
        if logit_weight(name) != name:
            np.testing.assert_allclose(d_got, d_want, rtol=0,
                                       atol=LOGIT_BIAS_STEP_TOL,
                                       err_msg=name)
            continue
        assert np.abs(d_want).max() > 1e-2, name
        np.testing.assert_allclose(d_got, d_want, rtol=1e-3, atol=1e-4,
                                   err_msg=name)
        assert (np.linalg.norm(d_got - d_want)
                <= 1e-3 * np.linalg.norm(d_want)), name
    assert still == 4  # wr1/wi1 of the first and the last layer


def _molecules(n_mol, atoms, seed):
    g, pos, mol_id = molecule_batch(n_mol, atoms, seed=seed, cutoff=2.5)
    src, dst = g.to_coo()
    species = np.random.default_rng(seed).integers(0, 5, size=g.num_nodes)
    return g.num_nodes, species, pos, src, dst, mol_id


def test_rotation_invariance_and_reference():
    """``tests/test_models.py::test_equiformer_rotation_invariance`` on the
    port (l_max 3, m_max 2): per-molecule outputs unchanged under a
    rotation of the positions within 1e-4, and within 1e-5 of the
    reference's on the same weights."""
    n, species, pos, src, dst, mol_id = _molecules(4, 8, seed=0)
    params = jax.tree_util.tree_map(np.asarray, jax_eq.equiformer_init(
        jax.random.key(0), d_out=2, **L3M2))
    model = eq.equiformer_from_numpy(params, device="cpu")
    R = rotation_matrix_zyz(0.4, 1.0, -0.3).astype(np.float32)
    kw = dict(num_nodes=n, mol_id=torch.from_numpy(mol_id), num_graphs=4)
    t = [torch.from_numpy(np.asarray(a)) for a in (species, src, dst)]
    with torch.no_grad():
        out = eq.equiformer_forward(model, t[0], torch.from_numpy(pos),
                                    t[1], t[2], **kw)
        out_r = eq.equiformer_forward(model, t[0],
                                      torch.from_numpy(pos @ R.T), t[1],
                                      t[2], **kw)
    np.testing.assert_allclose(out.numpy(), out_r.numpy(), atol=1e-4)
    want = jax_eq.equiformer_forward(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(species),
        jnp.asarray(pos, jnp.float32), jnp.asarray(src), jnp.asarray(dst),
        num_nodes=n, mol_id=jnp.asarray(mol_id), num_graphs=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **OUT_TOL)


def test_edge_chunking_exact_and_reference():
    """``tests/test_models.py::test_equiformer_edge_chunking_exact`` on the
    port: 4 edge chunks give the one-chunk outputs within 1e-5, and both
    agree with the reference's within 1e-5."""
    n, species, pos, src, dst, _ = _molecules(3, 10, seed=1)
    params = jax.tree_util.tree_map(np.asarray, jax_eq.equiformer_init(
        jax.random.key(1), n_layers=2, channels=16, l_max=2, m_max=1,
        n_heads=4, n_rbf=8))
    model = eq.equiformer_from_numpy(params, device="cpu")
    t = [torch.from_numpy(np.asarray(a)) for a in (species, pos, src, dst)]
    with torch.no_grad():
        a = eq.equiformer_forward(model, *t, num_nodes=n)
        b = eq.equiformer_forward(model, *t, num_nodes=n, edge_chunks=4)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    want = jax_eq.equiformer_forward(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(species),
        jnp.asarray(pos), jnp.asarray(src), jnp.asarray(dst), num_nodes=n,
        edge_chunks=4)
    np.testing.assert_allclose(b.numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("d_feat,n_out", [(64, 16), (16, 1), (0, 1)])
def test_published_widths_and_count_match_reference(d_feat, n_out):
    """``_init`` keeps the published widths (12 layers, 128 channels,
    l_max 6, m_max 2, 8 heads, 32 RBF): the reference's parameter count
    (40,054,724 at d_feat 64 / 16 classes), the reference's
    ``infer_cfg``, and its distributions (unit layer-norm gains, SO(2)
    weights of variance 1/(Lm·C))."""
    ref = jax_eq_config._init(jax.random.key(0), d_feat, n_out, "custom")
    model = equiformer_v2._init(torch.Generator().manual_seed(0), d_feat,
                                n_out, "custom", device="cpu")
    assert count_params(model) == jax_model_common.count_params(ref)
    if (d_feat, n_out) == (64, 16):
        assert count_params(model) == 40_054_724
    want_cfg = jax_eq.infer_cfg(ref)
    assert eq.infer_cfg(model) == want_cfg
    assert (want_cfg["n_layers"], want_cfg["channels"], want_cfg["l_max"],
            want_cfg["m_max"], want_cfg["n_heads"], want_cfg["n_rbf"]) == (
        12, 128, 6, 2, 8, 32)
    layer = model.layers[0]
    assert torch.equal(layer.ln1_g, torch.ones_like(layer.ln1_g))
    for name, fan in (("w0", 7 * 128), ("wr1", 6 * 128), ("wi2", 5 * 128)):
        w = getattr(layer.so2, name)
        assert abs(float(w.detach().std()) * np.sqrt(fan) - 1.0) < 0.02, name
    assert (model.feat_proj is None) == (d_feat == 0)


class _NamedStages:
    """``profile_lm._Stages`` without CUDA events: counts stage names."""

    def __init__(self):
        self.names = []

    def start(self, name):
        self.names.append(name)

    def stop(self):
        pass

    def totals(self):
        return {n: self.names.count(n) for n in dict.fromkeys(self.names)}


def test_profile_split_equals_forward_bitwise():
    """``bench/profile_train.py``'s stage-by-stage EquiformerV2 forward
    computes what ``equiformer_forward`` computes, bit for bit on the CPU,
    with every stage of ``EQ_STAGES`` timed (the rotations twice a layer,
    the geometry and the head once)."""
    from repro_torch.bench import profile_train
    info = gnn_common.REDUCED["ogb_products"]
    model = equiformer_v2._reduced_init(torch.Generator().manual_seed(0),
                                        info["d_feat"], info["classes"],
                                        "custom", device="cpu")
    b = gnn_common.make_concrete_batch(info, seed=1, device="cpu")
    out, stages = profile_train.staged_equiformer(model, b, info,
                                                  _NamedStages())
    with torch.no_grad():
        want = eq.equiformer_forward(
            model, b["species"], b["positions"], b["src"], b["dst"],
            num_nodes=info["nodes"], node_feat=b["node_feat"])
    assert torch.equal(out, want)
    n = len(model.layers)
    assert stages == {"geometry": 1, "norm_gather": n, "rotate": 2 * n,
                      "so2": n, "attention": n, "message_sum": n,
                      "finalize": n, "ffn": n, "head": 1}
    assert tuple(stages) == profile_train.EQ_STAGES
