"""The port's expert-parallel MoE (``models/moe.py`` on a mesh,
``models/transformer.py``'s ``mesh=``, ``sharding.block_ranges``,
``configs/lm_common.py::serve_placement`` and the LM launcher's
``--mesh-world``) against the JAX package and against the port's own
one-card path, on the CPU.

The reference splits the experts by ``shard(dispatch, "expert", None,
None)`` under ``lm_rules``, which binds ``"expert"`` to the ``"model"``
axis; its side runs once, in one subprocess for the module (``ref``), on
8 forced host devices: the devices' blocks of the dispatch buffer under
the reference's ``spec`` on ``("model",)`` meshes of 1, 2, 3, 4 and 8
devices, and ``moe_apply``, ``lm_prefill`` and ``lm_decode_step`` jitted
with that shard function on a 4-device ``("model",)`` mesh. The port runs
its shards as logical shards of the CPU (``make_host_mesh(W,
device="cpu", axis_name="model")``), which run the code that W cards run,
minus the peer copies.

Held bit for bit: each shard's expert range; the port's MoE layer and LM
(prefill and decode) at W 1, 2 and 4 against the port without a mesh, in
fp32 and bf16 (a ``torch.bmm`` over a block of experts computes each
expert as the whole batch does on the CPU), its router stats included;
``lm_init`` on a mesh gathered back against ``lm_init`` without one.
Against the reference under its mesh: one MoE layer within ``FP32_TOL``
(1e-5), the LM's logits within ``LM_FP32_TOL`` (1e-4) with equal argmax
ids (the matrix products sum in other orders on the two sides)."""
import dataclasses
import os
import pickle
import tempfile
import types

import numpy as np
import pytest
import torch

from repro.configs import deepseek_moe_16b as ref_deepseek
from repro.configs import lm_common as ref_lm
from repro.configs import phi35_moe_42b as ref_phi
from repro.sharding import spec as ref_spec
from repro_torch.configs import LM_ARCHS, lm_common
from repro_torch.launch import lm as launcher
from repro_torch.launch.mesh import Mesh, ProductionMesh, make_host_mesh
from repro_torch.models import moe, transformer
from repro_torch.sharding import block_ranges
from tests.conftest import run_subprocess

FP32_TOL = 1e-5
LM_FP32_TOL = 1e-4
REF_WORLD = 4          # the reference's jitted mesh
EXPERTS = (8, 16, 64)
WORLDS = (1, 2, 3, 4, 8)
TOKENS = 96            # one MoE layer's tokens
PROMPT = 40
DECODE_STEPS = 4
PAIRS = {"deepseek-moe-16b": ref_deepseek.CONFIG,
         "phi3.5-moe-42b": ref_phi.CONFIG}
GB = 1e9

_REF_CODE = """
import dataclasses, pickle
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import deepseek_moe_16b, phi35_moe_42b
from repro.configs.lm_common import lm_rules
from repro.models import moe as rmoe, transformer as rtf
from repro.sharding import make_shard_fn, spec

EXPERTS, WORLDS, REF_WORLD, TOKENS, PROMPT, STEPS = {consts}
ARCHS = {{"deepseek-moe-16b": deepseek_moe_16b.CONFIG,
          "phi3.5-moe-42b": phi35_moe_42b.CONFIG}}
out = {{"ranges": {{}}, "moe": {{}}, "lm": {{}}}}
devs = jax.devices()


def smoke(cfg):
    m = cfg.moe
    m = dataclasses.replace(m, num_experts=min(m.num_experts, 8),
                            top_k=min(m.top_k, 2), d_ff=64,
                            d_ff_shared=64 if m.n_shared else 0)
    return dataclasses.replace(
        cfg, vocab=512, d_model=64, n_layers=2, n_heads=4,
        n_kv=max(1, 4 * cfg.n_kv // cfg.n_heads), head_dim=16, d_ff=0,
        moe=m, dtype="float32", q_chunk=32, kv_chunk=32)


def to_np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


phi = phi35_moe_42b.CONFIG
for w in WORLDS:
    mesh = Mesh(np.array(devs[:w]), ("model",))
    for e in EXPERTS:
        cfg = dataclasses.replace(phi, moe=dataclasses.replace(
            phi.moe, num_experts=e))
        s = spec(mesh, lm_rules(mesh, "prefill_32k", cfg), (e, 5, 3),
                 "expert", None, None)
        idx = NamedSharding(mesh, s).devices_indices_map((e, 5, 3))
        out["ranges"][w, e] = (s[0], [idx[d][0].indices(e)[:2]
                                      for d in mesh.devices.flat])

mesh = Mesh(np.array(devs[:REF_WORLD]), ("model",))
for name, full in ARCHS.items():
    cfg = smoke(full)
    shard = make_shard_fn(mesh, lm_rules(mesh, "prefill_32k", cfg))
    p = rmoe.moe_init(jax.random.key(5), cfg.d_model, cfg.moe)
    x = np.random.default_rng(6).normal(
        size=(TOKENS, cfg.d_model)).astype(np.float32)
    f = jax.jit(lambda p, x: rmoe.moe_apply(p, x, cfg.moe, shard=shard))
    y, st = f(p, jnp.asarray(x))
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1)
    top = -np.sort(-np.asarray(probs), axis=-1)[:, :cfg.moe.top_k + 1]
    out["moe"][name] = dict(params=to_np(p), x=x, out=np.asarray(y),
                            load=np.asarray(st["expert_load"]),
                            dropped=int(st["dropped"]),
                            min_gap=float((top[:, :-1] - top[:, 1:]).min()))

    params = rtf.lm_init(jax.random.key(0), cfg)
    toks = np.random.default_rng(0).integers(
        0, 512, size=(2, PROMPT)).astype(np.int32)
    prefill = jax.jit(lambda p, t: rtf.lm_prefill(p, t, cfg, shard=shard))
    decode = jax.jit(lambda p, t, c, n: rtf.lm_decode_step(
        p, t, c, n, cfg, shard=shard))
    logits, _ = prefill(params, jnp.asarray(toks))
    steps = [np.asarray(logits)]
    cache = rtf.init_decode_cache(cfg, 2, STEPS, jnp.float32)
    token = jnp.asarray(toks[:, :1])
    for t in range(STEPS):
        logits, cache = decode(params, token, cache,
                               jnp.asarray(t + 1, jnp.int32))
        steps.append(np.asarray(logits))
        token = jnp.asarray(steps[-1].argmax(-1).astype(np.int32))[:, None]
    out["lm"][name] = dict(params=to_np(params), tokens=toks, logits=steps)

with open(OUT_PATH, "wb") as fh:
    pickle.dump(out, fh)
print("EP_REF_OK")
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    """The reference's results on 8 forced host devices, from one
    subprocess."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ref.pkl")
        code = _REF_CODE.format(consts=(EXPERTS, WORLDS, REF_WORLD, TOKENS,
                                        PROMPT, DECODE_STEPS))
        code = code.replace("OUT_PATH", repr(path))
        r = run_subprocess(code, devices=8, timeout=600)
        assert "EP_REF_OK" in r.stdout, r.stderr[-3000:]
        with open(path, "rb") as fh:   # written by the subprocess above
            return pickle.load(fh)


def _mesh(world: int):
    return make_host_mesh(world, device="cpu", axis_name="model")


def _smoke(arch: str):
    return lm_common.smoke_config(LM_ARCHS[arch])


def _with_experts(cfg, e: int):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            num_experts=e))


def _port_ranges(cfg, world: int) -> list:
    mesh = ProductionMesh(("model",), (world,))
    return moe.expert_ranges(mesh, lm_common.lm_rules(mesh, "prefill_32k",
                                                      cfg), cfg.moe)


# ---------------------------------------------------------------------------
# expert ranges
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("experts", EXPERTS)
def test_expert_ranges_follow_the_reference_spec(experts, world):
    """Each shard's range is the block the reference's divisibility-aware
    spec of the ``(E, cap, d)`` buffer gives it under ``lm_rules`` (a
    shape-only stand-in mesh, as ``tests/test_torch_dryrun.py``); an
    unsharded axis puts every expert on the home shard."""
    cfg = _with_experts(LM_ARCHS["phi3.5-moe-42b"], experts)
    stand_in = types.SimpleNamespace(shape={"model": world})
    rcfg = dataclasses.replace(ref_phi.CONFIG, moe=dataclasses.replace(
        ref_phi.CONFIG.moe, num_experts=experts))
    entry = ref_spec(stand_in, ref_lm.lm_rules(stand_in, "prefill_32k",
                                               rcfg),
                     (experts, 5120, 4096), "expert", None, None)[0]
    got = _port_ranges(cfg, world)
    if entry is None:
        assert experts % world
        assert got == [(0, experts)] + [(experts, experts)] * (world - 1)
    else:
        step = experts // world
        assert entry == "model"
        assert got == [(i * step, (i + 1) * step) for i in range(world)]
    mesh = _mesh(world)
    assert moe.expert_ranges(mesh, lm_common.lm_rules(mesh, "prefill_32k",
                                                      cfg), cfg.moe) == got
    if (experts, world) == (16, 3):
        assert entry is None and got[0] == (0, 16)


def test_expert_ranges_equal_the_reference_device_blocks(ref):
    """Against the reference's ``NamedSharding`` on real ``("model",)``
    meshes: a sharded axis gives device i the port's shard i block; an
    unsharded one replicates every expert on every device, which the port
    keeps on the home shard alone."""
    for (world, experts), (entry, blocks) in ref["ranges"].items():
        got = _port_ranges(_with_experts(LM_ARCHS["phi3.5-moe-42b"],
                                         experts), world)
        if entry is None:
            assert blocks == [(0, experts)] * world
            assert got[0] == (0, experts)
            assert all(lo == hi for lo, hi in got[1:])
        else:
            assert [tuple(b) for b in blocks] == got, (world, experts)


def test_block_ranges_refuses_a_split_it_cannot_make():
    mesh = ProductionMesh(("model",), (4,))
    assert block_ranges(mesh, None, 6) == [(0, 6), (6, 6), (6, 6), (6, 6)]
    with pytest.raises(ValueError, match="does not split"):
        block_ranges(mesh, "model", 6)
    assert make_host_mesh(2, device="cpu", axis_name="model").shape == \
        {"model": 2}
    assert make_host_mesh(2, device="cpu").shape == {"x": 2}


# ---------------------------------------------------------------------------
# one MoE layer
# ---------------------------------------------------------------------------
def _moe_pair(arch: str, ref_params: dict, dtype, world: int):
    cfg = _smoke(arch)
    mesh = _mesh(world)
    rules = lm_common.lm_rules(mesh, "prefill_32k", cfg)
    whole = moe.moe_from_numpy(ref_params, cfg.moe, dtype=dtype,
                               device="cpu")
    split = moe.moe_from_numpy(ref_params, cfg.moe, dtype=dtype,
                               device="cpu", mesh=mesh, rules=rules)
    return cfg, whole, split


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_moe_layer_on_shards_is_the_one_card_layer(ref, arch, dtype, world):
    """Phi's top-2 and deepseek's shared experts at smoke widths: the
    output, ``expert_load``, ``dropped`` and ``capacity`` bit for bit the
    one-card ``moe_apply``; each shard holds only its experts, on its
    device, and runs three products a call."""
    r = ref["moe"][arch]
    cfg, whole, split = _moe_pair(arch, r["params"], dtype, world)
    assert not hasattr(split, "w1") and len(split.shards) == world
    for s, (lo, hi) in zip(split.shards, _port_ranges(cfg, world)):
        assert (s.lo, s.hi) == (lo, hi) and s.w1.shape[0] == hi - lo
        assert torch.equal(s.w2, whole.w2[lo:hi])
    x = torch.from_numpy(r["x"]).to(dtype)
    with torch.no_grad():
        want, want_st = moe.moe_apply(whole, x, cfg.moe)
        moe.PRODUCTS.reset()
        got, st = moe.moe_apply(split, x, cfg.moe)
    assert moe.PRODUCTS.value == 3 * world
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(st["expert_load"], want_st["expert_load"])
    assert int(st["dropped"]) == int(want_st["dropped"])
    assert st["capacity"] == want_st["capacity"] == moe.capacity(TOKENS,
                                                                 cfg.moe)
    assert torch.equal(moe.gather_experts(split)["w1"], whole.w1)


@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_moe_layer_on_shards_matches_the_reference_on_a_mesh(ref, arch):
    """The port at W 4 against the reference's ``moe_apply`` jitted with
    the ``"expert"`` constraint on a 4-device ``("model",)`` mesh."""
    r = ref["moe"][arch]
    assert r["min_gap"] > 1e-6     # routing cannot flip on last bits
    cfg, _, split = _moe_pair(arch, r["params"], torch.float32, REF_WORLD)
    with torch.no_grad():
        got, st = moe.moe_apply(split, torch.from_numpy(r["x"]), cfg.moe)
    np.testing.assert_allclose(got.numpy(), r["out"], rtol=FP32_TOL,
                               atol=FP32_TOL)
    assert np.array_equal(st["expert_load"].numpy(), r["load"])
    assert int(st["dropped"]) == r["dropped"]


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------
def _serve(model, cfg, toks: np.ndarray) -> list[torch.Tensor]:
    """The prefill's logits, then ``DECODE_STEPS`` greedy steps' from an
    empty fp32 cache and the prompt's first token (as
    ``tests/test_torch_moe.py`` holds decode against the reference)."""
    tokens = torch.from_numpy(toks).long()
    steps = [transformer.lm_prefill(model, tokens, cfg)[0]]
    cache = transformer.init_decode_cache(cfg, 2, DECODE_STEPS,
                                          dtype=torch.float32, device="cpu")
    token = tokens[:, :1]
    for t in range(DECODE_STEPS):
        logits, cache = transformer.lm_decode_step(model, token, cache,
                                                   t + 1, cfg)
        steps.append(logits)
        token = logits.argmax(-1)[:, None]
    return steps


@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_lm_on_shards_is_the_one_card_lm_and_matches_the_reference(ref,
                                                                   arch):
    """phi3.5 and deepseek at the smoke reduction, the reference's weights
    carried by ``lm_from_numpy``: a prefill and four decode steps at W 4
    bit for bit W 1's, and within 1e-4 of the reference's ``lm_prefill`` /
    ``lm_decode_step`` jitted on its 4-device mesh, with equal argmax."""
    r = ref["lm"][arch]
    cfg = _smoke(arch)
    one = transformer.lm_from_numpy(r["params"], cfg, device="cpu")
    four = transformer.lm_from_numpy(r["params"], cfg, device="cpu",
                                     mesh=_mesh(REF_WORLD))
    want, got = _serve(one, cfg, r["tokens"]), _serve(four, cfg,
                                                      r["tokens"])
    for a, b, jx in zip(want, got, r["logits"]):
        assert torch.equal(a, b)
        np.testing.assert_allclose(b.numpy(), jx, rtol=LM_FP32_TOL,
                                   atol=LM_FP32_TOL)
        assert np.array_equal(b.argmax(-1).numpy(), jx.argmax(-1))
    for blk_one, blk_four in zip(one.layers, four.layers):
        assert torch.equal(blk_one.moe.last_stats["expert_load"],
                           blk_four.moe.last_stats["expert_load"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_lm_init_on_a_mesh_gathers_back_bitwise(arch, dtype):
    """``lm_init(mesh=)`` at W 4 draws what ``lm_init`` draws at W 1, bit
    for bit; its state holds no whole expert tensor, and every shard only
    its experts' rows."""
    cfg = _smoke(arch)
    whole = transformer.lm_init(torch.Generator().manual_seed(2), cfg, dtype)
    split = transformer.lm_init(torch.Generator().manual_seed(2), cfg, dtype,
                                mesh=_mesh(4))
    got, want = transformer.gathered_state_dict(split), whole.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not any(k.endswith((".moe.w1", ".moe.w3", ".moe.w2"))
                   for k in split.state_dict())
    for blk_w, blk_s in zip(whole.layers, split.layers):
        for s in blk_s.moe.shards:
            for name in moe.EXPERT_WEIGHTS:
                assert torch.equal(getattr(s, name),
                                   getattr(blk_w.moe, name)[s.lo:s.hi])
    with pytest.raises(ValueError, match="home device"):
        transformer.lm_init(torch.Generator().manual_seed(2), cfg,
                            mesh=Mesh(("meta", "meta"), "model"))


def test_lm_needs_a_model_axis():
    with pytest.raises(ValueError, match="'model'"):
        transformer.LM(_smoke("phi3.5-moe-42b"), device="cpu",
                       mesh=make_host_mesh(2, device="cpu"))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_serve_placement_bytes_in_closed_form():
    """phi3.5's bytes a card at W 4, before the cache: the home card
    23.35 GB (attention, embeddings, norms and fp32 routers, 3.22 GB, and
    four experts a layer), every other card 20.13 GB (four experts a
    layer)."""
    cfg = LM_ARCHS["phi3.5-moe-42b"]
    m = cfg.moe
    place = lm_common.serve_placement(cfg, 4)
    experts = cfg.n_layers * 4 * 3 * cfg.d_model * m.d_ff * 2
    routers = cfg.n_layers * cfg.d_model * m.num_experts
    rest = (transformer.lm_param_count(cfg)
            - cfg.n_layers * m.num_experts * 3 * cfg.d_model * m.d_ff
            - routers) * 2 + routers * 4
    assert place.weight_bytes == (rest + experts,) + (experts,) * 3
    assert round(place.weight_bytes[0] / GB, 2) == 23.35
    assert round(place.weight_bytes[1] / GB, 2) == 20.13
    assert round(rest / GB, 2) == 3.22
    assert place.expert_ranges == ((0, 4), (4, 8), (8, 12), (12, 16))
    assert place.card_bytes == place.weight_bytes and place.cache_bytes == 0
    one_card = lm_common.serve_placement(cfg, 4, cards=1,
                                         cache_positions=100, batch=2)
    assert one_card.shard_cards == (0, 0, 0, 0)
    assert one_card.cache_bytes == 2 * 32 * 2 * 100 * 8 * 128 * 2
    assert one_card.card_bytes == (sum(place.weight_bytes)
                                   + one_card.cache_bytes,)
    assert lm_common.serve_placement(cfg, 3).weight_bytes[1:] == (0, 0)


def test_launcher_checks_each_card(capsys):
    """phi3.5 at W 1 keeps its refusal and names the smallest world; at W 3
    its experts do not divide, so all land on the home card, refused; W 2
    and W 4 serve. Serving, ``--mesh-world`` splits only an MoE; with
    ``--shape train_4k`` it lays out the train mesh, an MoE's too."""
    def refused(argv):
        with pytest.raises(SystemExit) as exc:
            launcher.parse_args(argv)
        assert exc.value.code == 2
        return capsys.readouterr().err

    err = refused(["--arch", "phi3.5-moe-42b"])
    assert "83.75 GB of bf16 weights against one 80 GB card" in err
    assert "ROADMAP A13" in err and "--mesh-world 2" in err
    err = refused(["--arch", "phi3.5-moe-42b", "--mesh-world", "3"])
    assert "16 experts do not divide 3 shards" in err
    assert "83.75 GB of bf16 weights" in err
    for world in (2, 4):
        args = launcher.parse_args(["--arch", "phi3.5-moe-42b",
                                    "--mesh-world", str(world)])
        assert args.mesh_world == world
    assert "has none" in refused(["--mesh-world", "2"])
    train = launcher.parse_args(["--shape", "train_4k", "--arch",
                                 "deepseek-moe-16b", "--mesh-world", "2",
                                 "--smoke"])
    assert (train.mesh_world, train.model) == (2, 2)
    assert "--layers 0 outside 1..32" in refused(
        ["--arch", "phi3.5-moe-42b", "--layers", "0", "--mesh-world", "4"])
    assert launcher.parse_args(["--arch", "phi3.5-moe-42b", "--layers",
                                "16"]).layers == 16


@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_launcher_world_4_generates_world_1s_ids(arch):
    """``--smoke --device cpu --mesh-world 4`` serves what ``--mesh-world
    1`` serves: the same ids and router stats; the report names each
    shard's experts and counts three products a shard and MoE call."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--prompt-len",
            "24", "--new-tokens", "3", "--seed", "4"]
    one = launcher.serve(launcher.parse_args(argv))
    four = launcher.serve(launcher.parse_args(argv + ["--mesh-world", "4"]))
    assert one["requests"][0]["generated"] == \
        four["requests"][0]["generated"]
    assert one["requests"][0]["moe_prefill"] == \
        four["requests"][0]["moe_prefill"]
    calls = 2 * (1 + 3)          # layers × (prefill + decode steps)
    assert (one["expert_products"], four["expert_products"]) == (
        3 * calls, 3 * 4 * calls)
    (card,) = four["cards"]
    assert card["device"] == "cpu" and card["shards"] == [0, 1, 2, 3]
    assert card["experts"] == [[0, 2], [2, 4], [4, 6], [6, 8]]
    assert four["mesh_world"] == 4 and four["layers"] == 2
    assert one["cards"][0]["experts"] == [[0, 8]]


def test_profile_split_on_a_mesh_equals_prefill_bitwise(monkeypatch):
    """``bench/profile_lm.py``'s stage-by-stage prefill at W 4 splits the
    expert products from the two exchanges and computes what
    ``lm_prefill`` computes, bit for bit."""
    from repro_torch.bench import profile_lm
    names = []

    class Named:
        def start(self, name):
            names.append(name)

        def stop(self):
            pass

        def totals(self):
            return {}

    monkeypatch.setattr(profile_lm, "_Stages", Named)
    cfg = _smoke("phi3.5-moe-42b")
    model = transformer.lm_init(torch.Generator().manual_seed(0), cfg,
                                dtype=torch.bfloat16, mesh=_mesh(4))
    toks = torch.randint(0, cfg.vocab, (1, 64),
                         generator=torch.Generator().manual_seed(1))
    staged, _ = profile_lm.staged_prefill(model, toks, cfg)
    want, _ = transformer.lm_prefill(model, toks, cfg)
    assert torch.equal(staged, want)
    assert {"exchange_out", "experts", "exchange_back"} <= set(names)
    assert set(names) <= set(profile_lm.STAGES)
