"""The port's distributed-training pieces on the CPU: the int8
error-feedback gradient compression against the JAX package, the
checkpoint's elastic restore onto a mesh, and the training launcher's
``--mesh-world`` (the halo-sharded step).

Bitwise: ``compress_int8`` (q, scale and the carried residual) over a
sweep of gradient scales, with and without a residual carried in, and
the tree functions over a model's named gradients; a checkpoint written
at world 1 and restored onto a world-8 mesh gives the saved leaves back
bit for bit when its shards are concatenated. The launcher: with nothing
dropped, ``--mesh-world 4`` gives the unsharded launcher's first loss
(GIN-TU: the same per-node sums in the same order; EquiformerV2's
message sums go through another ``segment_sum`` call order, so within
1e-6), reports its counters, resumes from a checkpoint like an
uninterrupted run, and exits 2 on an architecture without a sharded
loss."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compress_int8 as jax_compress_int8
from repro.training import optimizer as jax_optimizer
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import Mesh
from repro_torch.training import (CheckpointManager, compress_int8,
                                  compressed_grad_tree, decompress_grad_tree,
                                  decompress_int8)

SMALL = ["--device", "cpu", "--nodes", "256", "--edges", "2048",
         "--d-feat", "16", "--classes", "4"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its shapes are tiny, and the
    suite's parallel workers would otherwise oversubscribe the cores (each
    of torch's small ops spinning up a thread team)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("scale", [1e-6, 3.7e-4, 1e-2, 1.0, 57.0, 1e3])
@pytest.mark.parametrize("carried", [False, True])
def test_compress_int8_bitwise_reference(scale, carried):
    rng = np.random.default_rng(int(scale * 1e6) % 9973)
    g = (rng.normal(size=257) * scale).astype(np.float32)
    err = ((rng.normal(size=257) * scale * 0.01).astype(np.float32)
           if carried else np.zeros(257, np.float32))
    got = compress_int8(torch.from_numpy(g), torch.from_numpy(err))
    want = jax_compress_int8(jnp.asarray(g), jnp.asarray(err))
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
    for a, b in zip(got, want):
        assert np.array_equal(_bits(a), _bits(b))
    assert np.array_equal(_bits(decompress_int8(got[0], got[1])),
                          _bits(jax_optimizer.decompress_int8(*want[:2])))


def test_int8_error_feedback_carries_the_residual():
    """The reference's own properties: a step's error is at most half a
    bin, and the residual carried over 100 steps keeps the sum of the
    dequantized gradients within 1e-3 of the true sum."""
    g = torch.from_numpy(np.random.default_rng(1).normal(size=512)
                         .astype(np.float32) * 1e-4)
    q, s, err = compress_int8(g, torch.zeros_like(g))
    assert float((decompress_int8(q, s) - g).abs().max()) <= float(s) * 0.5
    acc, err = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(100):
        q, s, err = compress_int8(g, err)
        acc = acc + decompress_int8(q, s)
    assert float((acc - 100 * g).abs().max() / (100 * g).abs().max()) < 1e-3


def test_compressed_grad_tree_matches_reference():
    """Over a model's named gradients: ``(q, scales, errors)`` keyed by
    name, each bitwise the reference's tree function's on the same dict;
    decompression too."""
    from repro_torch.models.gnn_basic import gin_init
    model = gin_init(torch.Generator().manual_seed(0), 8, 16, 2, 3,
                     device="cpu")
    rng = np.random.default_rng(2)

    def draw(shape, size):
        return torch.from_numpy(np.asarray(rng.normal(size=shape) * size,
                                           np.float32))

    grads = {k: draw(tuple(p.shape), 1.0)
             for k, p in model.named_parameters()}
    errs = {k: draw(tuple(p.shape), 1e-3)
            for k, p in model.named_parameters()}
    got = compressed_grad_tree(grads, errs)
    want = jax_optimizer.compressed_grad_tree(
        {k: jnp.asarray(v.numpy()) for k, v in grads.items()},
        {k: jnp.asarray(v.numpy()) for k, v in errs.items()})
    for got_tree, want_tree in zip(got, want):
        assert sorted(got_tree) == sorted(grads)
        for k in grads:
            assert np.array_equal(_bits(got_tree[k]), _bits(want_tree[k])), k
    deq = decompress_grad_tree(got[0], got[1])
    want_deq = jax_optimizer.decompress_grad_tree(want[0], want[1])
    for k in grads:
        assert np.array_equal(_bits(deq[k]), _bits(want_deq[k])), k


def test_elastic_restore_world1_to_world8(tmp_path):
    """Leaves saved whole at world 1 split over a world-8 mesh (dim 0 and
    dim 1), its shards on their devices; concatenated they are the saved
    leaves bit for bit. A device places a leaf whole; unlisted leaves keep
    the template's device; a leaf that does not split raises."""
    w = torch.arange(64.0).reshape(8, 8) * 0.1
    v = torch.randn((3, 16), generator=torch.Generator().manual_seed(0))
    tree = {"params": {"w": w, "v": v}, "opt": {"step": 4, "b": w[0]}}
    CheckpointManager(str(tmp_path)).save(1, tree)
    mesh = Mesh(("cpu:0", "cpu:1") * 4)
    out = CheckpointManager(str(tmp_path)).restore(
        1, tree, placements={"params": {"w": (mesh, 0), "v": (mesh, 1)},
                             "opt": {"b": "cpu"}})
    for name, dim, leaf in (("w", 0, w), ("v", 1, v)):
        shards = out["params"][name]
        assert len(shards) == mesh.world
        assert all(s.shape[dim] == leaf.shape[dim] // mesh.world
                   for s in shards)
        assert np.array_equal(_bits(torch.cat(shards, dim)), _bits(leaf))
    assert np.array_equal(_bits(out["opt"]["b"]), _bits(w[0]))
    assert out["opt"]["step"] == 4
    with pytest.raises(ValueError, match="does not split"):
        CheckpointManager(str(tmp_path)).restore(
            1, tree, placements={"params": {"v": (mesh, 0)}})


@pytest.mark.parametrize("arch", ["gin-tu", "equiformer-v2"])
def test_launcher_mesh_world_matches_unsharded(arch):
    """``--mesh-world 4`` at a capacity that drops nothing: the same first
    loss as the unsharded launcher (same batch, same weights), the halo
    report, and the second step within the gradients' fp32 rounding."""
    base = launcher.main(SMALL + ["--arch", arch, "--steps", "2"])
    halo = launcher.main(SMALL + ["--arch", arch, "--steps", "2",
                                  "--mesh-world", "4", "--cap-pp", "2048"])
    tol = 0.0 if arch == "gin-tu" else 1e-6
    assert abs(halo["losses"][0] - base["losses"][0]) <= tol
    np.testing.assert_allclose(halo["losses"], base["losses"], rtol=1e-5)
    assert (halo["mesh_world"], halo["cards"], halo["cap_pp"]) == (4, 1,
                                                                   2048)
    assert halo["halo"]["dropped_ids"] == 0
    assert halo["halo"]["exchanges"] > 0 and halo["halo"]["remote_ids"] > 0
    assert 0.7 < halo["remote_fraction"] < 0.8        # (W-1)/W, uniform
    assert "mesh_world" not in base


def test_launcher_mesh_world_reference_cap_drops_and_reports(capsys):
    """At the reference's ``cap_pp`` (max(16, E/W·0.4/W) = 51 here) a
    uniform graph's remote fraction of ~0.75 overflows it: ids are
    dropped and counted, and training goes on."""
    report = launcher.main(SMALL + ["--steps", "1", "--mesh-world", "4"])
    assert report["cap_pp"] == max(16, int(2048 // 4 * 0.4 / 4))
    assert report["halo"]["dropped_ids"] > 0
    assert np.isfinite(report["losses"]).all()
    assert "halo-sharded: 4 shards on 1 card(s), cap_pp 51" in (
        capsys.readouterr().out)


def test_launcher_mesh_world_resumes_like_an_uninterrupted_run(tmp_path):
    args = SMALL + ["--mesh-world", "4", "--cap-pp", "2048"]
    whole = launcher.main(args + ["--steps", "4"])
    launcher.main(args + ["--steps", "2", "--ckpt-dir", str(tmp_path),
                          "--ckpt-every", "1"])
    resumed = launcher.main(args + ["--steps", "4", "--ckpt-dir",
                                    str(tmp_path), "--ckpt-every", "1"])
    assert resumed["step"] == 4 and len(resumed["losses"]) == 2
    np.testing.assert_allclose(resumed["losses"], whole["losses"][2:],
                               rtol=1e-6)


@pytest.mark.parametrize("argv,needle", [
    (["--arch", "schnet", "--mesh-world", "4"],
     "--arch schnet has no halo-sharded loss"),
    (["--arch", "meshgraphnet", "--mesh-world", "4"],
     "--arch meshgraphnet has no halo-sharded loss"),
    (["--mesh-world", "3"], "must be at least 1 and divide"),
    (["--mesh-world", "0"], "must be at least 1 and divide"),
    (["--cap-pp", "64"], "--cap-pp needs --mesh-world")])
def test_launcher_mesh_world_rejections(argv, needle, capsys):
    with pytest.raises(SystemExit) as err:
        launcher.parse_args(argv)
    assert err.value.code == 2
    assert needle in capsys.readouterr().err


def test_launcher_mesh_world_needs_the_card_unless_cpu_is_asked():
    """Without ``--device cpu`` the sharded launcher asks for the card;
    with no card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        launcher.main(["--steps", "1", "--mesh-world", "4", "--nodes", "64",
                       "--edges", "256"])
