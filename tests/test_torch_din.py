"""Port DIN serving against the JAX reference, with the reference's
weights carried in through ``din_from_numpy`` at ``din_smoke`` sizes
(``src/repro/configs/din.py``: 2,000 items, 64 categories, history 20,
history ids drawn from -1): the MLP, ``din_forward`` and
``din_score_candidates`` within 2e-5 (fp32, other sum order), the
model-level ``embedding_bag`` (its weighted mean divides by Σw), the
store path bitwise equal to the direct-table path, ``tier_histogram``, and
the ``recsys_din`` launcher at the example script's settings."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import TieredFeatureStore as JaxStore
from repro.core import TopologySpec as JaxTopo
from repro.core import quiver_placement as jax_placement
from repro.models import din as jdin
from repro.models.common import mlp as jax_mlp
from repro.models.common import mlp_init as jax_mlp_init
from repro_torch.core import TieredFeatureStore, TopologySpec, quiver_placement
from repro_torch.kernels import embedding_bag as eb_pkg
from repro_torch.launch import recsys_din
from repro_torch.models import din as tdin
from repro_torch.models.common import mlp_from_numpy

TOL = dict(rtol=2e-5, atol=2e-5)  # fp32, sums in another order
CFG = dict(n_items=2000, n_cates=64, embed_dim=18, hist_len=20,
           n_dense_feat=8)
B = 32


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """The reference's weights, and the port's copy of them."""
    cfg_j = jdin.DINConfig(**CFG)
    params = jdin.din_init(jax.random.key(0), cfg_j)
    return cfg_j, params, tdin.DINConfig(**CFG), tdin.din_from_numpy(
        _np_tree(params), device="cpu")


def _batch(seed=0, b=B):
    """``din_smoke``'s draws: history ids from -1 (padding mixed in)."""
    rng = np.random.default_rng(seed)
    n, c, t = CFG["n_items"], CFG["n_cates"], CFG["hist_len"]
    return {"target_item": rng.integers(0, n, b).astype(np.int32),
            "target_cate": rng.integers(0, c, b).astype(np.int32),
            "hist_items": rng.integers(-1, n, (b, t)).astype(np.int32),
            "hist_cates": rng.integers(0, c, (b, t)).astype(np.int32),
            "dense_feat": rng.normal(size=(b, 8)).astype(np.float32)}


KEYS = ("target_item", "target_cate", "hist_items", "hist_cates",
        "dense_feat")


def _jax_forward(cfg_j, params, batch, item_lookup=None):
    return np.asarray(jdin.din_forward(
        params, cfg_j, *(jnp.asarray(batch[k]) for k in KEYS),
        item_lookup=item_lookup))


def _port_forward(cfg_t, model, batch, item_lookup=None):
    return tdin.din_forward(model, cfg_t,
                            *(torch.from_numpy(batch[k]) for k in KEYS),
                            item_lookup=item_lookup)


@pytest.mark.parametrize("act", ["sigmoid", "silu"])
def test_mlp_matches_reference(act):
    dims = [144, 80, 40, 1]
    params = jax_mlp_init(jax.random.key(3), dims)
    x = np.random.default_rng(0).normal(size=(7, 5, 144)).astype(np.float32)
    jact, tact = {"sigmoid": (jax.nn.sigmoid, torch.sigmoid),
                  "silu": (jax.nn.silu, F.silu)}[act]
    want = np.asarray(jax_mlp(params, jnp.asarray(x), act=jact))
    got = mlp_from_numpy(_np_tree(params), act=tact)(torch.from_numpy(x))
    assert got.shape == want.shape == (7, 5, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_din_forward_matches_reference(models, seed):
    cfg_j, params, cfg_t, model = models
    batch = _batch(seed)
    batch["hist_items"][1] = -1          # a user with no history at all
    want = _jax_forward(cfg_j, params, batch)
    before = eb_pkg.LAUNCHES.value
    got = _port_forward(cfg_t, model, batch)
    assert got.shape == want.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert eb_pkg.LAUNCHES.value == before  # CPU: the plain version


def test_din_init_shapes_and_determinism():
    cfg = tdin.DINConfig(**CFG)
    a = tdin.din_init(torch.Generator().manual_seed(4), cfg, device="cpu")
    b = tdin.din_init(torch.Generator().manual_seed(4), cfg, device="cpu")
    assert a.item_embed.shape == (2000, 18) and a.cate_embed.shape == (64, 18)
    assert [lin.in_features for lin in a.attn.layers] == [144, 80, 40]
    assert [lin.in_features for lin in a.mlp.layers] == [116, 200, 80]
    for (_, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y)
    if not torch.cuda.is_available():     # the default device is cuda
        with pytest.raises(RuntimeError, match="cuda"):
            tdin.din_init(torch.Generator().manual_seed(4), cfg)


@pytest.mark.parametrize("n,chunk", [(1000, 256), (300, 300), (0, 64)])
def test_score_candidates_matches_reference(models, n, chunk):
    """Chunks padded with id 0 and the tail dropped, as the reference."""
    cfg_j, params, cfg_t, model = models
    rng = np.random.default_rng(n + chunk)
    user = _batch(9, b=1)
    ci = rng.integers(0, CFG["n_items"], n).astype(np.int32)
    cc = rng.integers(0, CFG["n_cates"], n).astype(np.int32)
    want = np.asarray(jdin.din_score_candidates(
        params, cfg_j, jnp.asarray(user["hist_items"][0]),
        jnp.asarray(user["hist_cates"][0]), jnp.asarray(user["dense_feat"][0]),
        jnp.asarray(ci), jnp.asarray(cc), chunk=chunk))
    got = tdin.din_score_candidates(
        model, cfg_t, torch.from_numpy(user["hist_items"][0]),
        torch.from_numpy(user["hist_cates"][0]),
        torch.from_numpy(user["dense_feat"][0]), torch.from_numpy(ci),
        torch.from_numpy(cc), chunk=chunk)
    assert got.shape == want.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_model_embedding_bag_matches_reference(mode, weighted):
    """The model's own EmbeddingBag, leading dims kept; its weighted mean
    divides by Σ valid·w (unlike the kernel's ÷ valid count)."""
    rng = np.random.default_rng(7)
    table = rng.normal(size=(30, 6)).astype(np.float32)
    ids = rng.integers(-1, 30, size=(2, 3, 5)).astype(np.int32)
    ids[0, 0] = -1
    w = rng.uniform(0.1, 2.0, size=(2, 3, 5)).astype(np.float32)
    want = np.asarray(jdin.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids),
        jnp.asarray(w) if weighted else None, mode=mode))
    got = tdin.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                             torch.from_numpy(w) if weighted else None,
                             mode=mode)
    assert got.shape == want.shape == (2, 3, 6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_model_weighted_mean_divides_by_weight_sum():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([[0, 1, -1]], dtype=torch.int32)
    w = torch.tensor([[2.0, 0.5, 7.0]])
    got = tdin.embedding_bag(table, ids, w, mode="mean")
    np.testing.assert_allclose(got.numpy(), [[0.6, 1.6, 2.6]], rtol=1e-6)


def _placed_table(model, seed=0):
    rng = np.random.default_rng(seed)
    pop = (1.0 / np.arange(1, CFG["n_items"] + 1) ** 1.2)[
        rng.permutation(CFG["n_items"])].astype(np.float32)
    topo = dict(num_pods=1, devices_per_pod=2, rows_per_device=300,
                rows_host=500, hot_replicate_fraction=0.4)
    table = model.item_embed.detach().numpy()
    port = TieredFeatureStore.build(
        table, quiver_placement(pop, TopologySpec(**topo)), device="cpu")
    ref = JaxStore.build(table, jax_placement(pop, JaxTopo(**topo)))
    return port, ref


def test_store_path_equals_direct_table_bitwise(models):
    """The store returns bit-identical rows (every tier, -1 → zeros), so
    the logits through it equal the direct-table logits bit for bit."""
    _, _, cfg_t, model = models
    port, _ = _placed_table(model)
    batch = _batch(3)
    hist = batch["hist_items"]
    assert {k for k, v in port.tier_histogram(hist.ravel()).items()
            if v} == {"hot", "warm", "host", "disk"}
    direct = _port_forward(cfg_t, model, batch)
    stored = _port_forward(cfg_t, model, batch,
                           recsys_din.item_lookup(port))
    assert torch.equal(direct, stored)


def test_tier_histogram_matches_reference(models):
    port, ref = _placed_table(models[3])
    ids = np.random.default_rng(2).integers(-1, CFG["n_items"], 4000)
    assert port.tier_histogram(ids) == ref.tier_histogram(ids)
    assert sum(port.tier_histogram(ids).values()) == int((ids >= 0).sum())


def _reference_example(params_np):
    """``examples/recsys_din.py``'s run, with the given weights: its tier
    mix counts and its scores."""
    cfg = jdin.DINConfig(n_items=50_000, n_cates=500, embed_dim=18,
                         hist_len=50, n_dense_feat=8)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    rng = np.random.default_rng(0)
    pop = 1.0 / np.power(np.arange(1, cfg.n_items + 1), 1.2)
    pop = pop[rng.permutation(cfg.n_items)].astype(np.float32)
    topo = JaxTopo(num_pods=1, devices_per_pod=4, rows_per_device=4000,
                   rows_host=20000, hot_replicate_fraction=0.4)
    plan = jax_placement(pop, topo)
    store = JaxStore.build(np.asarray(params["item_embed"]), plan)

    def item_lookup(ids):
        rows = store.lookup(jnp.asarray(ids.reshape(-1), jnp.int32))
        return rows.reshape(ids.shape + (cfg.embed_dim,))

    b = 256
    items = rng.choice(cfg.n_items, size=b, p=pop / pop.sum())
    batch = dict(
        target_item=jnp.asarray(items, jnp.int32),
        target_cate=jnp.asarray(rng.integers(0, 500, b), jnp.int32),
        hist_items=jnp.asarray(
            rng.choice(cfg.n_items, size=(b, 50), p=pop / pop.sum()),
            jnp.int32),
        hist_cates=jnp.asarray(rng.integers(0, 500, (b, 50)), jnp.int32),
        dense_feat=jnp.asarray(rng.normal(size=(b, 8)), jnp.float32))
    scores = jdin.din_forward(params, cfg, *(batch[k] for k in KEYS),
                              item_lookup=item_lookup)
    hist = store.tier_histogram(np.asarray(batch["hist_items"]).ravel())
    return hist, np.asarray(scores), plan.tier_counts()


def test_launcher_example_matches_reference_script():
    """``recsys_din --device cpu --config example`` with the reference's
    weights: the same placement and tier mix as the example script's store
    on the same draws, and scores within 2e-5 of its ``din_forward``."""
    cfg = recsys_din.SETTINGS["example"][0]
    params_np = _np_tree(jdin.din_init(jax.random.key(0), jdin.DINConfig(
        **{f: getattr(cfg, f) for f in ("n_items", "n_cates", "embed_dim",
                                         "hist_len", "n_dense_feat")})))
    hist, scores, placement = _reference_example(params_np)
    stack = recsys_din.build_stack(
        "example", device="cpu",
        model=tdin.din_from_numpy(params_np, device="cpu"))
    report, served, logits = recsys_din.serve(stack, 1)
    assert report["placement"] == placement
    assert report["tier_counts"] == hist
    assert report["store"]["lookup_calls"] == 2     # target + history
    assert served[0]["hist_items"].shape == (256, 50)
    np.testing.assert_allclose(logits[0].numpy(), scores, **TOL)


def test_launcher_cli_runs_on_cpu(capsys):
    report = recsys_din.main(["--device", "cpu", "--config", "example",
                              "--batches", "2", "--candidates", "700"])
    assert report["batches"] == 2 and len(report["batch_ms"]) == 2
    assert sum(report["tier_counts"].values()) == 2 * 256 * 50
    assert report["retrieval"]["finite"]
    assert capsys.readouterr().out.strip().startswith("{")
    with pytest.raises(SystemExit):
        recsys_din.parse_args(["--config", "train_batch"])
