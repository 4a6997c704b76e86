"""Port model and serving path against the JAX reference: ``sage_layered``
on converted weights, the end-to-end ``HostExecutor`` output for the same
seed, a port ``ServingEngine`` over host + device executors on the CPU,
and the launcher's flag surface (the flags of the distributed store stay
rejected; the ported ones are in ``test_torch_launch_serve.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TieredFeatureStore as JaxStore
from repro.core import TopologySpec as JaxTopo
from repro.core import compute_fap as jax_fap
from repro.core import quiver_placement as jax_placement
from repro.graph import power_law_graph as jax_power_law
from repro.launch.serve import make_infer_fn as jax_make_infer_fn
from repro.models.gnn_basic import sage_init as jax_sage_init
from repro.models.gnn_basic import sage_layered as jax_sage_layered
from repro.serving import HostExecutor as JaxHostExecutor
from repro_torch.core import (Request, TieredFeatureStore, TopologySpec,
                              quiver_placement)
from repro_torch.graph import power_law_graph
from repro_torch.launch import serve as launcher
from repro_torch.models.gnn_basic import (sage_from_numpy, sage_init,
                                          sage_layered)
from repro_torch.serving import (CostModelRouter, DeviceExecutor,
                                 HostExecutor, ServingEngine,
                                 calibrate_executors)

# fp32 model outputs: matmuls and layer norms reduce in another order
TOL = dict(rtol=2e-5, atol=2e-5)
N, D, FAN, HIDDEN = 900, 12, (4, 3), (16, 8)


def _params(seed=0):
    tree = jax_sage_init(jax.random.key(seed), [D, *HIDDEN])
    return tree, jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_sage_layered_matches_jax(fused, masked):
    tree, tree_np = _params()
    model = sage_from_numpy(tree_np, device="cpu")
    rng = np.random.default_rng(3)
    b = 6
    ids = [rng.integers(-1, N, b * k).astype(np.int32)
           for k in (1, FAN[0], FAN[0] * FAN[1])]
    feats = [rng.normal(size=(h.shape[0], D)).astype(np.float32)
             * (h >= 0)[:, None] for h in ids]
    masks = [(h >= 0).astype(np.float32)[:, None] for h in ids]
    deep = None
    hop_np = feats
    if fused:
        p = ids[1].shape[0]
        child = feats[2].reshape(p, FAN[1], D)
        deep = (child * masks[2].reshape(p, FAN[1], 1)).sum(1)
        hop_np = feats[:2]
    ref = jax_sage_layered(
        tree, [jnp.asarray(f) for f in hop_np], FAN,
        hop_masks=[jnp.asarray(m) for m in masks] if masked else None,
        deep_agg=None if deep is None else jnp.asarray(deep))
    with torch.inference_mode():
        out = sage_layered(
            model, [torch.from_numpy(f) for f in hop_np], FAN,
            hop_masks=[torch.from_numpy(m) for m in masks] if masked
            else None,
            deep_agg=None if deep is None else torch.from_numpy(deep))
    assert out.shape == (b, HIDDEN[-1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_sage_init_is_device_independent_and_scaled():
    a = sage_init(torch.Generator().manual_seed(4), [D, *HIDDEN],
                  device="cpu")
    b = sage_init(torch.Generator().manual_seed(4), [D, *HIDDEN],
                  device="cpu")
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    w = a.layers[0].self_lin.weight.detach()
    assert w.shape == (HIDDEN[0], D)
    assert abs(float(w.std()) - D ** -0.5) < 0.1


@pytest.fixture(scope="module")
def stacks():
    """Port and JAX stacks over the same graph, features and plan."""
    g = power_law_graph(N, 6.0, seed=0)
    gj = jax_power_law(N, 6.0, seed=0)
    feats = np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)
    fap = jax_fap(gj, FAN)
    topo = dict(num_pods=1, devices_per_pod=1, rows_per_device=220,
                rows_host=330, hot_replicate_fraction=0.3)
    store = TieredFeatureStore.build(
        feats, quiver_placement(fap, TopologySpec(**topo)), device="cpu")
    jstore = JaxStore.build(feats, jax_placement(fap, JaxTopo(**topo)))
    return g, gj, store, jstore


@pytest.mark.parametrize("fused,fuse_aggregate", [(True, False),
                                                  (False, False),
                                                  (True, True)])
def test_host_executor_matches_jax(stacks, fused, fuse_aggregate):
    """Same rng_seed → same host-sampled hops → outputs within model
    tolerance of the reference's HostExecutor + make_infer_fn."""
    g, gj, store, jstore = stacks
    _, tree_np = _params(seed=0)
    infer = launcher.make_infer_fn(sage_from_numpy(tree_np, device="cpu"),
                                   FAN)
    jinfer = jax_make_infer_fn(D, HIDDEN, FAN, seed=0)
    kw = dict(rng_seed=5, fused=fused, fuse_aggregate=fuse_aggregate)
    ex = HostExecutor(g, store, FAN, infer, **kw)
    jex = JaxHostExecutor(gj, jstore, FAN, jinfer, **kw)
    try:
        for seeds in (np.arange(20), np.array([3, -1, 899, 3, 17])):
            out = ex.run(seeds)
            ref = jex.run(seeds)
            assert out.shape == (seeds.shape[0], HIDDEN[-1])
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    finally:
        ex.close()
        jex.close()


def test_fused_and_fuse_aggregate_outputs_bitwise(stacks):
    """One seed, the same hops: the fused and fuse-aggregate executors give
    the same output bits (the model's fan sum is the kernel's order)."""
    g, _, store, _ = stacks
    infer = launcher.make_infer_fn(
        sage_init(torch.Generator().manual_seed(0), [D, *HIDDEN],
                  device="cpu"), FAN)
    outs = []
    for fa in (False, True):
        ex = HostExecutor(g, store, FAN, infer, rng_seed=9,
                          fuse_aggregate=fa)
        outs.append(ex.run(np.arange(40, 72)))
        ex.close()
    assert torch.equal(outs[0], outs[1])


def test_engine_serves_on_cpu(stacks):
    g, _, store, _ = stacks
    psgs = np.ones(N, np.float32)
    infer = launcher.make_infer_fn(
        sage_init(torch.Generator().manual_seed(0), [D, *HIDDEN],
                  device="cpu"), FAN)
    executors = {
        "host": HostExecutor(g, store, FAN, infer, capacity=2,
                             psgs_table=psgs),
        "device": DeviceExecutor(g.device_arrays("cpu"), store, FAN, infer,
                                 max_batch=8, capacity=2, psgs_table=psgs,
                                 fuse_aggregate=True),
    }
    batches = [np.arange(i, i + 8) for i in range(0, 48, 8)]
    curves = calibrate_executors(executors, batches, psgs, repeats=1)
    router = CostModelRouter.from_curves(psgs, curves, executors=executors)
    engine = ServingEngine(executors, router, max_inflight=4)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, N, 8), 0.0) for i in range(20)]
    try:
        metrics = engine.run([[r] for r in reqs])
    finally:
        engine.close()
    summary = metrics.summary()
    assert summary["requests"] == 20 and summary["shed"] == 0
    assert set(summary["routed"]) <= {"host", "device"}
    assert sum(summary["routed"].values()) == 20
    stats = summary["store"]["TieredFeatureStore"]
    assert stats["collect_mode"] == "fuse_aggregate+fused"
    assert all(r.outcome == "completed" for r in reqs)
    # a device-executor batch bigger than max_batch is chunked, not cut
    assert executors["device"].run(np.arange(20)).shape == (20, HIDDEN[-1])


def test_launcher_main_on_cpu(capsys):
    summary = launcher.main(["--device", "cpu", "--nodes", "1500",
                             "--requests", "12", "--batch", "8",
                             "--fuse-aggregate"])
    assert summary["requests"] == 12
    assert summary["store"]["TieredFeatureStore"]["fused_aggregates"] > 0
    assert '"throughput_rps"' in capsys.readouterr().out


@pytest.mark.parametrize("flag", [
    "--sharded", "--sharded-spill-dir=d", "--no-such-flag"])
def test_launcher_rejects_unported_flags(flag, capsys):
    with pytest.raises(SystemExit) as err:
        launcher.parse_args([flag])
    assert err.value.code != 0
    assert "unrecognized arguments" in capsys.readouterr().err


def test_launcher_defaults_are_the_served_model():
    args = launcher.parse_args([])
    assert (args.device, args.nodes, args.d_feat, args.fanouts, args.batch,
            args.policy) == ("cuda", 20000, 128, "10,5", 32,
                             "latency_preferred")
    assert launcher.HIDDEN == (128, 128)
