"""The port's dry-run machinery against the reference on the CPU: the
registry and shape matrix, every (arch × shape) cell built on fake tensors
at full dims with the reference's rule tables and spec tuples on both
production meshes (a stand-in mesh of shape only: the reference's rule
and spec functions read ``mesh.shape`` alone, so no 512 host devices and
no ``repro.launch.dryrun``, which sets ``XLA_FLAGS`` on import), the
smokes (three against the reference's on the same weights), the kernels'
fake branches and their ``ref.cost``, the roofline and collective model
in closed form, counted FLOPs of reduced cells, the CLI's records, and
the reports over a small dry-run JSON. No full-size LM step is counted
here (a ``train_4k`` count takes minutes): that is the CLI's."""
import dataclasses
import json
import math
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

import repro.configs as RC
from repro.configs import din as ref_din
from repro.configs import gnn_common as ref_gnn
from repro.configs import lm_common as ref_lm
from repro.sharding import Rules as RefRules
from repro.sharding import spec as ref_spec

import repro_torch.configs as PC
from repro_torch.configs import din as port_din
from repro_torch.configs import gnn_common, lm_common
from repro_torch.kernels import fake
from repro_torch.kernels.embedding_bag import kernel as eb_kernel
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.gather_aggregate import kernel as ga_kernel
from repro_torch.kernels.gather_aggregate import ops as ga_ops
from repro_torch.kernels.gather_aggregate import ref as ga_ref
from repro_torch.kernels.segment_spmm import kernel as sp_kernel
from repro_torch.kernels.segment_spmm import ops as sp_ops
from repro_torch.kernels.segment_spmm import ref as sp_ref
from repro_torch.kernels.tiered_gather import kernel as tg_kernel
from repro_torch.kernels.tiered_gather import ops as tg_ops
from repro_torch.kernels.tiered_gather import ref as tg_ref
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_production_mesh

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
HBM = 3.35e12
SMOKE_TOL = 1e-4   # fp32 losses, sums in other orders on the two sides


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The smokes are many small ops: one intra-op thread runs them ~10×
    faster than eight on a loaded host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def stand_in(which: str):
    """A mesh of shape only, for the reference's rule and spec functions."""
    return types.SimpleNamespace(shape=dict(MESHES[which]))


def port_mesh(which: str):
    return make_production_mesh(multi_pod=which == "multi")


def ref_tuple(s: P) -> tuple:
    return tuple(s)


def assert_same_tree(ref, port, where=""):
    """A reference tree of ``PartitionSpec`` equals a port tree of tuples."""
    if isinstance(ref, P):
        assert tuple(ref) == port, (where, ref, port)
    elif isinstance(ref, dict):
        assert set(ref) == set(port), (where, set(ref), set(port))
        for k in ref:
            assert_same_tree(ref[k], port[k], f"{where}.{k}")
    else:
        raise AssertionError(f"{where}: unexpected {type(ref)}")


def specs_of(shardings: dict) -> dict:
    return {k: v.spec for k, v in shardings.items()}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_registry_and_shape_matrix_match_reference():
    assert PC.list_archs() == RC.list_archs()
    assert len(PC.list_archs()) == 10
    for name in RC.list_archs():
        ref, port = RC.get_arch(name), PC.get_arch(name)
        assert port.family == ref.family
        assert tuple(port.shape_names) == tuple(ref.shape_names)
        assert port.build_cell is not None and port.smoke is not None


# ---------------------------------------------------------------------------
# cells: fake at full dims, rules and specs equal the reference's
# ---------------------------------------------------------------------------
def _check_lm(name, shape, which, cell):
    mesh = stand_in(which)
    ref_cfg = _ref_lm_config(name)
    port_cfg = PC.LM_ARCHS[name]
    ref_rules = ref_lm.lm_rules(mesh, shape, ref_cfg)
    port_rules = lm_common.lm_rules(mesh, shape, port_cfg)
    assert port_rules.table == ref_rules.table
    ref_specs = ref_lm.lm_param_specs(ref_cfg, mesh, ref_rules)
    port_specs = lm_common.lm_param_specs(port_cfg, mesh, port_rules)
    assert_same_tree(ref_specs, port_specs)
    info = ref_lm.SHAPES[shape]
    B, S = info["batch"], info["seq"]
    weights = ref_specs
    if info["kind"] == "train" and ref_cfg.moe is None:     # ZeRO-1
        weights = ref_lm.lm_param_specs(
            ref_cfg, mesh, RefRules({**ref_rules.table, "fsdp": None}))
    as_tuples = jax.tree_util.tree_map(
        ref_tuple, weights, is_leaf=lambda s: isinstance(s, P))
    got = specs_of(cell.in_shardings[0])
    assert got == {n: lm_common.lm_param_spec_of(n, as_tuples)
                   for n in got}
    batch_spec = ref_tuple(ref_spec(mesh, ref_rules, (B, S), "batch", None))
    if info["kind"] == "train":
        full = jax.tree_util.tree_map(ref_tuple, ref_specs,
                                      is_leaf=lambda s: isinstance(s, P))
        assert specs_of(cell.in_shardings[1].mu) == {
            n: lm_common.lm_param_spec_of(n, full) for n in got}
        assert specs_of(cell.in_shardings[2]) == {"tokens": batch_spec,
                                                  "targets": batch_spec}
        return
    cache = ref_tuple(ref_spec(
        mesh, ref_rules, (ref_cfg.n_layers, B, S, ref_cfg.n_kv,
                          ref_cfg.head_dim),
        None, "batch", "seq", "tp_kv", None))
    logits = ref_tuple(ref_spec(mesh, ref_rules, (B, ref_cfg.vocab),
                                "batch", "vocab_tp"))
    assert cell.out_shardings[0].spec == logits
    if info["kind"] == "prefill":
        assert cell.in_shardings[1].spec == batch_spec
        assert specs_of(cell.out_shardings[1]) == {"k": cache, "v": cache}
    else:
        assert specs_of(cell.in_shardings[1]) == {"k": cache, "v": cache}
        assert cell.in_shardings[2].spec == ref_tuple(
            ref_spec(mesh, ref_rules, (B, 1), "batch", None))


def _ref_lm_config(name):
    mod = {"qwen3-4b": "qwen3_4b", "qwen1.5-4b": "qwen15_4b",
           "codeqwen1.5-7b": "codeqwen15_7b",
           "deepseek-moe-16b": "deepseek_moe_16b",
           "phi3.5-moe-42b": "phi35_moe_42b"}[name]
    return __import__(f"repro.configs.{mod}", fromlist=["CONFIG"]).CONFIG


def _check_gnn(name, shape, which, cell):
    mesh = stand_in(which)
    ref_rules = ref_gnn.gnn_rules(mesh)
    assert gnn_common.gnn_rules(mesh).table == ref_rules.table
    info = ref_gnn.SHAPES[shape]
    want = {k: ref_tuple(v) for k, v in
            ref_gnn._batch_specs(mesh, ref_rules, info).items()}
    got = specs_of(cell.in_shardings[2])
    extra = {"ell_ids", "ell_ids_t"} if name == "gin-tu" else set()
    assert set(got) == set(want) | extra
    assert {k: got[k] for k in want} == want
    assert set(specs_of(cell.in_shardings[0]).values()) == {()}
    halo = name in ("gin-tu", "equiformer-v2") and shape == "ogb_products"
    assert ("halo-sharded" in cell.notes) == halo


def _check_din(shape, which, cell):
    mesh = stand_in(which)
    ref_rules = ref_din.din_rules(mesh)
    assert port_din.din_rules(mesh).table == ref_rules.table
    _, ref_params = ref_din._param_specs(ref_din.CONFIG, mesh, ref_rules)
    got = specs_of(cell.in_shardings[0])
    for table in ("item_embed", "cate_embed"):
        assert got[table] == ref_tuple(ref_params[table])
    rest = jax.tree_util.tree_leaves(
        {k: v for k, v in ref_params.items() if not k.endswith("_embed")},
        is_leaf=lambda s: isinstance(s, P))
    assert {ref_tuple(s) for s in rest} == {()}
    assert {v for k, v in got.items() if not k.endswith("_embed")} == {()}
    info = ref_din.SHAPES[shape]
    if info["kind"] == "retrieval":
        cand = ref_tuple(ref_spec(mesh, ref_rules, (info["candidates"],),
                                  "cand"))
        assert cell.in_shardings[4].spec == cand
        assert cell.in_shardings[5].spec == cand
        return
    want = {k: ref_tuple(v) for k, v in ref_din._batch_specs(
        ref_din.CONFIG, info["batch"], mesh, ref_rules).items()}
    if info["kind"] == "serve":
        want.pop("label")
        assert specs_of(cell.in_shardings[1]) == want
    else:
        assert specs_of(cell.in_shardings[2]) == want


@pytest.mark.parametrize("name", sorted(RC.list_archs()))
def test_cells_build_fake_with_the_reference_specs(name):
    """Each shape on both meshes: every argument a fake tensor (nothing
    allocated), every sharded path an argument, and the rule tables and
    spec tuples of every parameter and batch leaf equal to the
    reference's ``PartitionSpec``s."""
    arch = PC.get_arch(name)
    for shape in arch.shape_names:
        for which in MESHES:
            cell = arch.build_cell(shape, stand_in(which), device="cpu")
            leaves = dryrun._leaves(tuple(cell.args))
            tensors = {k: v for k, v in leaves.items()
                       if isinstance(v, torch.Tensor)}
            assert tensors and all(isinstance(t, FakeTensor)
                                   for t in tensors.values()), (name, shape)
            assert set(dryrun._shardings(cell)) <= set(tensors)
            if arch.family in ("lm", "moe_lm"):
                _check_lm(name, shape, which, cell)
            elif arch.family == "gnn":
                _check_gnn(name, shape, which, cell)
            else:
                _check_din(shape, which, cell)


def test_lm_param_spec_of_covers_every_parameter():
    """Every port parameter maps to its reference leaf, without the
    stacked layer axis (phi3.5-moe-42b: 41,872,527,360 parameters, fake)."""
    cfg = PC.LM_ARCHS["phi3.5-moe-42b"]
    cell = lm_common.build_lm_cell(cfg, "prefill_32k", port_mesh("single"),
                                   device="cpu")
    model = cell.args[0]
    assert sum(p.numel() for p in model.parameters()) == 41_872_527_360
    specs = lm_common.lm_param_specs(cfg, port_mesh("single"),
                                     cell.meta["rules"])
    for n, p in model.named_parameters():
        assert len(lm_common.lm_param_spec_of(n, specs)) in (0, p.dim())


# ---------------------------------------------------------------------------
# smokes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(RC.list_archs()))
def test_smoke_runs(name):
    out = PC.get_arch(name).smoke()
    assert isinstance(out, dict) and out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_gin_smoke_matches_reference():
    """The reference smoke's loss a shape (its ``gnn_smoke`` takes the
    loss before the update: ``gin_tu._loss`` at ``gin_init`` key 1 on
    ``make_concrete_batch`` at ``hash(shape) % 2**16``, here under
    ``jax.jit``) against the port's ``gnn_smoke`` on those weights,
    carried over, and those seeds: within ``SMOKE_TOL``."""
    from repro.configs import gin_tu as ref_gin
    from repro_torch.configs import gin_tu
    from repro_torch.models.gnn_basic import gin_from_numpy
    models, seeds, want = {}, {}, {}
    for shape, info in ref_gnn.REDUCED.items():
        n_out = info["classes"] if info["classes"] is not None else 1
        params = ref_gin._init(jax.random.key(1), info["d_feat"], n_out,
                               shape)
        seeds[shape] = hash(shape) % 2 ** 16
        batch = ref_gnn.make_concrete_batch(info, seed=seeds[shape])
        want[shape] = float(jax.jit(
            lambda p, b, info=info, shape=shape: ref_gin._loss(
                p, b, info, shape))(params, batch))
        models[shape] = gin_from_numpy(_np(params), device="cpu")
    got = gnn_common.gnn_smoke(PC.get_arch("gin-tu").adapter, gin_tu._init,
                               models=models, seeds=seeds)
    assert set(got) == set(want)
    for shape in want:
        assert abs(got[shape] - want[shape]) <= SMOKE_TOL, (shape, got,
                                                            want)


def test_din_smoke_matches_reference():
    """``din_smoke``'s loss (before its update): the reference's
    ``din_loss`` under ``jax.jit`` at its smoke weights (key 0) and
    batch (``default_rng(0)``), against the port's on the weights carried
    over."""
    from repro.models.din import din_init as ref_din_init
    from repro.models.din import din_loss as ref_din_loss
    from repro_torch.models.din import din_from_numpy
    cfg = port_din.SMOKE_CONFIG
    ref_cfg = ref_din.DINConfig(n_items=2000, n_cates=64, embed_dim=18,
                                hist_len=20, n_dense_feat=8)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    params = ref_din_init(jax.random.key(0), ref_cfg)
    rng = np.random.default_rng(0)
    b = 32
    batch = {
        "target_item": rng.integers(0, 2000, b).astype(np.int32),
        "target_cate": rng.integers(0, 64, b).astype(np.int32),
        "hist_items": rng.integers(-1, 2000, (b, 20)).astype(np.int32),
        "hist_cates": rng.integers(0, 64, (b, 20)).astype(np.int32),
        "dense_feat": rng.normal(size=(b, 8)).astype(np.float32),
        "label": rng.integers(0, 2, b).astype(np.int32),
    }
    want = float(jax.jit(lambda p, bt: ref_din_loss(p, ref_cfg, bt))(
        params, batch))
    got = port_din.din_smoke(model=din_from_numpy(_np(params), device="cpu"))
    assert got["n_scores"] == 1000
    assert abs(got["loss"] - want) <= SMOKE_TOL, (got, want)


def test_dense_lm_smoke_matches_reference():
    """qwen3-4b at the smoke reduction: ``lm_smoke``'s loss (the
    reference's ``lm_loss`` under ``jax.jit`` at key 0's weights and
    tokens) against the port's on those weights and tokens, carried over;
    the reduced configs agree field by field."""
    from repro.models.transformer import lm_init as ref_lm_init
    from repro.models.transformer import lm_loss as ref_lm_loss
    from repro_torch.models.transformer import lm_from_numpy
    ref_full = _ref_lm_config("qwen3-4b")
    ref_cfg = dataclasses.replace(
        ref_full, vocab=512, d_model=64, n_layers=2, n_heads=4,
        n_kv=max(1, 4 * ref_full.n_kv // ref_full.n_heads), head_dim=16,
        d_ff=128, dtype="float32", q_chunk=32, kv_chunk=32)
    cfg = lm_common.smoke_config(PC.LM_ARCHS["qwen3-4b"])
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    key = jax.random.key(0)
    params = ref_lm_init(key, ref_cfg)
    toks = jax.random.randint(key, (2, 64), 0, ref_cfg.vocab)
    want = float(jax.jit(lambda p, t: ref_lm_loss(p, t, t, ref_cfg))(
        params, toks))
    got = lm_common.lm_smoke(
        PC.LM_ARCHS["qwen3-4b"],
        model=lm_from_numpy(_np(params), cfg, device="cpu"),
        tokens=torch.tensor(np.asarray(toks)).long())
    assert got["logits_shape"] == (2, 512)
    assert got["prefill_cache_k"] == (2, 2, 16, cfg.n_kv, 16)
    assert abs(got["loss"] - want) <= SMOKE_TOL, (got, want)


# ---------------------------------------------------------------------------
# kernels: the fake branch and ref.cost
# ---------------------------------------------------------------------------
def _kernel_calls(dev: str):
    """``(name, call, plain module+function, out shape, out dtype, cost)``
    for each kernel on small fake tensors of ``dev`` (under the caller's
    mode)."""
    def e(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    i32 = torch.int32
    return [
        ("segment_spmm",
         lambda: sp_ops.segment_spmm(e(6, 3, dtype=i32), e(9, 8)),
         (6, 8), torch.float32, sp_ref.cost(6, 3, 8, 4, rows_read=9)),
        ("embedding_bag",
         lambda: eb_ops.embedding_bag(e(20, 8), e(5, 4, dtype=i32),
                                      e(5, 4), mode="sum"),
         (5, 8), torch.float32, eb_ref.cost(5, 4, 8, 4, weighted=True)),
        ("flash_attention",
         lambda: fa_ops.flash_attention(
             e(2, 16, 4, 16, dtype=torch.bfloat16),
             e(2, 16, 2, 16, dtype=torch.bfloat16),
             e(2, 16, 2, 16, dtype=torch.bfloat16)),
         (2, 16, 4, 16), torch.bfloat16,
         fa_ref.cost(2, 16, 16, 4, 2, 16, 2)),
        ("tiered_gather",
         lambda: tg_ops.tiered_gather(e(7, dtype=i32), e(7, dtype=i32),
                                      e(5, 8), e(6, 8)),
         (7, 8), torch.float32, tg_ref.cost(7, 8, 4)),
        ("gather_aggregate",
         lambda: ga_ops.gather_aggregate(
             e(3, 4, dtype=i32), e(3, 4, dtype=i32), e(5, 8), e(6, 8),
             e(2, 8)),
         (3, 8), torch.float32, ga_ref.cost(3, 4, 8, 4)),
    ]


CUDA_WRAPPERS = [(sp_kernel, "segment_spmm_cuda"),
                 (eb_kernel, "embedding_bag_cuda"),
                 (fa_kernel, "flash_attention_cuda"),
                 (tg_kernel, "tiered_gather_cuda"),
                 (ga_kernel, "gather_aggregate_cuda")]
PLAIN = [(sp_ref, "segment_spmm_plain"), (eb_ref, "embedding_bag_ref"),
         (fa_ref, "flash_attention_plain"), (tg_ref, "tiered_gather_ref"),
         (__import__("repro_torch.kernels.gather_aggregate.ref",
                     fromlist=["x"]), "gather_aggregate_ref")]


def _refuse(monkeypatch, targets):
    def boom(*a, **k):
        raise AssertionError("a fake tensor reached a kernel or plain "
                             "version")
    for mod, fn in targets:
        monkeypatch.setattr(mod, fn, boom)


@pytest.mark.parametrize("dev", ["cpu", "cuda"])
def test_fake_branch_returns_shape_and_records_cost(monkeypatch, dev):
    """On fake tensors of either device each kernel's wrapper returns an
    empty output of the kernel's shape and dtype and records its
    ``ref.cost``; neither the CUDA wrapper (``ctypes``, which would read a
    fake pointer) nor the plain version runs."""
    _refuse(monkeypatch, CUDA_WRAPPERS + PLAIN)
    counter = fake.KernelCounter()
    with FakeTensorMode(), fake.counting(counter):
        for name, call, shape, dtype, cost in _kernel_calls(dev):
            out = call()
            assert isinstance(out, FakeTensor), name
            assert tuple(out.shape) == shape and out.dtype == dtype, name
            assert out.device.type == dev, name
            assert counter.flops[name] == cost["flops"], name
            assert counter.bytes[name] == cost["bytes"], name
            assert counter.calls[name] == 1, name


def test_a_call_from_another_thread_is_counted():
    """On the card a backward runs on the autograd engine's own thread: a
    kernel call there records into the counter the step opened."""
    import threading
    counter = fake.KernelCounter()
    with FakeTensorMode() as mode, fake.counting(counter):
        ids = torch.empty((6, 3), dtype=torch.int32)
        feat = torch.empty((9, 8))

        def backward_thread():
            with mode:
                sp_ops.segment_spmm(ids, feat)
        t = threading.Thread(target=backward_thread)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert counter.calls == {"segment_spmm": 1}
    with FakeTensorMode():
        sp_ops.segment_spmm(torch.empty((6, 3), dtype=torch.int32),
                            torch.empty((9, 8)))
    assert counter.calls == {"segment_spmm": 1}      # closed: no record


def test_real_cpu_tensors_take_the_plain_version(monkeypatch):
    """A real CPU tensor goes to the plain version exactly as before: the
    spies see one call each, and nothing is recorded."""
    calls = []
    for mod, fn in PLAIN:
        real = getattr(mod, fn)

        def spy(*a, _real=real, _fn=fn, **k):
            calls.append(_fn)
            return _real(*a, **k)
        monkeypatch.setattr(mod, fn, spy)
    _refuse(monkeypatch, CUDA_WRAPPERS)
    counter = fake.KernelCounter()
    g = torch.Generator().manual_seed(0)
    with fake.counting(counter):
        ids = torch.randint(-1, 9, (6, 3), generator=g, dtype=torch.int32)
        sp_ops.segment_spmm(ids, torch.randn(9, 8, generator=g))
        eb_ops.embedding_bag(torch.randn(20, 8, generator=g),
                             torch.randint(-1, 20, (5, 4), generator=g,
                                           dtype=torch.int32))
        q = torch.randn(1, 16, 2, 16, generator=g)
        fa_ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
        tier = torch.randint(0, 3, (7,), generator=g, dtype=torch.int32)
        tg_ops.tiered_gather(tier, tier, torch.randn(5, 8, generator=g),
                             torch.randn(6, 8, generator=g))
        t2 = torch.randint(0, 3, (3, 4), generator=g, dtype=torch.int32)
        ga_ops.gather_aggregate(t2, t2, torch.randn(5, 8, generator=g),
                                torch.randn(6, 8, generator=g),
                                torch.randn(2, 8, generator=g))
    assert calls == [fn for _, fn in PLAIN]
    assert counter.calls == {}


def test_cost_holds_the_perf_bounds():
    """One input per kernel from PERF.md: flash at qwen3-4b's layer (1,
    32,768, 32|8, 128) bf16 causal is 8.80e12 operations (8.894 ms);
    ``segment_spmm`` on SAGE's 20,000 × 5,003 table at d 128 with 2,827
    distinct rows is a 0.1230 ms bound; ``embedding_bag`` on the DIN
    train history, (65,536, 100) ids all valid over 36-wide fp32 rows, is
    0.2923 ms in mean mode and 0.3002 weighted. The two serve kernels
    hold the closed forms of ``chip_smoke.py``'s bound column."""
    flash = fa_ref.cost(1, 32768, 32768, 32, 8, 128, 2)
    assert flash["flops"] == 4 * 32 * 128 * 32768 * 32769 // 2
    assert round(flash["flops"] / 1e12, 2) == 8.80
    assert round(flash["flops"] / 989e12 * 1e3, 3) == 8.894
    assert fa_ref.cost(1, 8, 8, 1, 1, 4, 4, causal=False)["flops"] == \
        4 * 4 * 64
    spmm = sp_ref.cost(20000, 5003, 128, 4, nnz=239991, rows_read=2827)
    assert round(spmm["bytes"] / HBM * 1e3, 4) == 0.1230
    assert spmm["flops"] == 239991 * 128
    mean = eb_ref.cost(65536, 100, 36, 4, weighted=False)
    weighted = eb_ref.cost(65536, 100, 36, 4, weighted=True)
    assert round(mean["bytes"] / HBM * 1e3, 4) == 0.2923
    assert round(weighted["bytes"] / HBM * 1e3, 4) == 0.3002
    assert weighted["flops"] == 2 * mean["flops"] == 2 * 6553600 * 36
    assert tg_ref.cost(27989, 100, 4, read_rows=1000) == {
        "flops": 0, "bytes": 8 * 27989 + 1000 * 400 + 27989 * 400}
    assert ga_ref.cost(2272, 5, 64, 4, read_rows=3000, valid=9000) == {
        "flops": 9000 * 64,
        "bytes": 8 * 2272 * 5 + 3000 * 256 + 2272 * 256}


# ---------------------------------------------------------------------------
# roofline and collectives
# ---------------------------------------------------------------------------
def test_roofline_terms_closed_form():
    r = hlo_analysis.roofline_terms(flops=989e12, bytes_accessed=3.35e12,
                                    collective_bytes=25e9,
                                    collective_bw=50e9,
                                    dtype=torch.bfloat16)
    assert r["compute_s"] == pytest.approx(1.0)
    assert r["memory_s"] == pytest.approx(1.0)
    assert r["collective_s"] == pytest.approx(0.5)
    assert r["step_lower_bound_s"] == pytest.approx(1.0)
    assert r["roofline_fraction"] == pytest.approx(1.0 / 2.5)
    f = hlo_analysis.roofline_terms(flops=67e12, bytes_accessed=0.0,
                                    collective_bytes=0.0)
    assert f["dominant"] == "compute_s" and f["compute_s"] == \
        pytest.approx(1.0)
    assert hlo_analysis.collective_bw(8) == hlo_analysis.NVLINK_BW
    assert hlo_analysis.collective_bw(16) == hlo_analysis.NET_BW


def test_collectives_world_one_and_replicated_are_zero():
    """A world of one moves nothing; a replicated batch (molecule's 3,840
    nodes do not split 512 ways) moves nothing."""
    one = types.SimpleNamespace(shape={"data": 1, "model": 1})
    for name, shape in (("din", "serve_p99"), ("gin-tu", "ogb_products"),
                        ("qwen3-4b", "decode_32k")):
        cell = PC.get_arch(name).build_cell(shape, one, device="cpu")
        assert hlo_analysis.model_collectives(
            cell, one, cell.meta["rules"]).total_bytes == 0.0
    multi = stand_in("multi")
    cell = PC.get_arch("schnet").build_cell("molecule", multi, device="cpu")
    assert hlo_analysis.model_collectives(
        cell, multi, cell.meta["rules"]).total_bytes == 0.0


def test_din_all_to_all_and_halo_exchange_by_hand():
    """DIN ``serve_p99`` on 16 × 16: 512 / 16 examples a device look up
    101 item and 101 category rows each (18 fp32 and an int32 id) over the
    16-way model group; GIN-TU ``ogb_products`` on the halo cell: 5 layers
    forward and backward of 256 · cap_pp rows of 64 fp32 plus the id, and
    the replicated parameters' gradient all-reduce over 256."""
    mesh = stand_in("single")
    cell = PC.get_arch("din").build_cell("serve_p99", mesh, device="cpu")
    st = hlo_analysis.model_collectives(cell, mesh, cell.meta["rules"])
    assert st.counts["all-to-all"] == 1
    assert st.bytes_by_kind["all-to-all"] == pytest.approx(
        32 * 101 * 2 * (18 * 4 + 4) * 15 / 16)
    assert st.total_bytes == st.bytes_by_kind["all-to-all"]
    cell = PC.get_arch("gin-tu").build_cell("ogb_products", mesh,
                                            device="cpu")
    cap_pp = max(16, int(61859840 // 256 * 0.4 / 256))
    assert cell.meta["halo"] and cell.meta["cap_pp"] == cap_pp
    st = hlo_analysis.model_collectives(cell, mesh, cell.meta["rules"])
    grads = sum(p.nbytes for p in cell.args[0].parameters())
    assert st.counts == {"all-gather": 0, "all-reduce": 1,
                         "reduce-scatter": 0, "all-to-all": 10,
                         "collective-permute": 0}
    assert st.bytes_by_kind["all-to-all"] == pytest.approx(
        10 * 256 * cap_pp * (64 * 4 + 4) * 255 / 256)
    assert st.bytes_by_kind["all-reduce"] == pytest.approx(
        2 * grads * 255 / 256)
    assert st.bw == hlo_analysis.NET_BW


# ---------------------------------------------------------------------------
# counted FLOPs of reduced cells
# ---------------------------------------------------------------------------
def test_counted_flops_of_a_reduced_lm_prefill(monkeypatch):
    """qwen3-4b at the smoke reduction, a (2, 64) prefill: every layer's
    q/k/v/o and SwiGLU products, the flash kernel's causal pairs (its
    ``ref.cost``, not the plain version's square), and the last
    position's unembedding."""
    monkeypatch.setitem(lm_common.SHAPES, "prefill_32k",
                        dict(kind="prefill", seq=64, batch=2))
    cfg = lm_common.smoke_config(PC.LM_ARCHS["qwen3-4b"])
    cell = lm_common.build_lm_cell(cfg, "prefill_32k", None, device="cpu")
    counts = dryrun.count_cell(cell)
    b, s, d, h, kv, dh = 2, 64, cfg.d_model, cfg.n_heads, cfg.n_kv, \
        cfg.head_dim
    per_layer = 2 * b * s * (d * h * dh + 2 * d * kv * dh + h * dh * d
                             + 3 * d * cfg.d_ff)
    flash = fa_ref.cost(b, s, s, h, kv, dh, 4)["flops"]
    assert flash == 4 * b * h * dh * s * (s + 1) // 2
    want = cfg.n_layers * (per_layer + flash) + 2 * b * d * cfg.vocab
    assert counts["flops"] == want
    assert counts["kernels"]["flash_attention"]["calls"] == cfg.n_layers


def test_counted_flops_of_a_reduced_din_serve(monkeypatch):
    """DIN at the smoke config, a batch of 64: the attention MLP on every
    history slot, the main MLP on every example, and the two bags'
    ``ref.cost`` (weighted: a multiply-add a slot and column)."""
    monkeypatch.setitem(port_din.SHAPES, "serve_p99",
                        dict(kind="serve", batch=64))
    cfg = port_din.SMOKE_CONFIG
    cell = port_din.build_din_cell(cfg, "serve_p99", None, device="cpu")
    counts = dryrun.count_cell(cell)
    b, t, de = 64, cfg.hist_len, 2 * cfg.embed_dim
    attn = [4 * de, *cfg.attn_mlp, 1]
    main = [3 * de + cfg.n_dense_feat, *cfg.mlp, 1]

    def macs(dims):
        return sum(a * c for a, c in zip(dims[:-1], dims[1:]))

    want = (2 * b * t * macs(attn) + 2 * b * macs(main)
            + b * t * de * 2 + b * t * de)
    assert counts["flops"] == want
    assert counts["kernels"]["embedding_bag"]["calls"] == 2


# ---------------------------------------------------------------------------
# records, the CLI and the reports
# ---------------------------------------------------------------------------
REF_KEYS = {"arch", "shape", "mesh", "world", "ok", "memory", "cost",
            "collectives", "roofline", "loop_factor", "roofline_corrected",
            "kind"}


def test_run_cell_records():
    recs = dryrun.run_cell("din", "serve_p99", device="cpu", verbose=False)
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert [r["world"] for r in recs] == [256, 512]
    for r in recs:
        assert r["ok"] and REF_KEYS <= set(r)
        assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                    "temp_bytes", "alias_bytes",
                                    "peak_hbm_bytes"}
        assert r["roofline_corrected"] == r["roofline"]
        assert r["cost"]["counted"] == "every execution"
        assert r["cost"]["flops"] == r["global"]["flops"] / r["world"]
        assert "measured" not in r
    # the arguments a device: the tables split 16 ways over "model", the
    # batch 16 ways over "data", the MLPs whole
    table = 10_000_000 * 18 * 4 + 10_000 * 18 * 4
    batch = 512 * (2 + 2 * 100 + 8) * 4
    whole = recs[0]["global"]["argument_bytes"]
    assert recs[0]["memory"]["argument_bytes"] == \
        whole - table - batch + table // 16 + batch // 16
    assert dryrun.loop_factor("qwen3-4b", "train_4k") == 144
    assert dryrun.loop_factor("phi3.5-moe-42b", "train_4k") == 256
    assert dryrun.loop_factor("din", "retrieval_cand") == 32
    assert dryrun.loop_factor("gin-tu", "ogb_products") == 1


def test_a_failing_cell_ends_not_ok(monkeypatch):
    def broken(*a, **k):
        raise ValueError("no such shape")
    monkeypatch.setattr(dryrun, "get_arch",
                        lambda name: types.SimpleNamespace(build_cell=broken))
    recs = dryrun.run_cell("din", "serve_p99", device="cpu", verbose=False)
    assert [r["ok"] for r in recs] == [False, False]
    assert recs[0]["error"] == "ValueError: no such shape"


def test_cli_writes_json(tmp_path):
    out = tmp_path / "dryrun_torch.json"
    dryrun.main(["--device", "cpu", "--arch", "din", "--shape", "serve_p99",
                 "--out", str(out)])
    dryrun.main(["--device", "cpu", "--arch", "gin-tu", "--shape",
                 "molecule", "--mesh", "single", "--out", str(out),
                 "--append"])
    recs = json.loads(out.read_text())
    assert [(r["arch"], r["mesh"]) for r in recs] == [
        ("din", "16x16"), ("din", "2x16x16"), ("gin-tu", "16x16")]
    assert all(r["ok"] for r in recs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            dryrun.main(["--arch", "din", "--out", str(out)])


def test_reports_read_a_small_dryrun_json(tmp_path, monkeypatch, capsys):
    """``roofline``, ``scalability`` and ``report`` over two cells' records
    (DIN ``serve_p99``, GIN-TU ``ogb_products``), through the runner as
    well; a missing file gives each runner module's ``skipped`` row."""
    from repro_torch.bench import report, roofline, run, scalability
    monkeypatch.chdir(tmp_path)
    assert roofline.run() == {"skipped": True}
    assert scalability.run() == {"skipped": True}
    assert "roofline/skipped" in capsys.readouterr().out
    recs = (dryrun.run_cell("din", "serve_p99", device="cpu", verbose=False)
            + dryrun.run_cell("gin-tu", "ogb_products", device="cpu",
                              verbose=False))
    (tmp_path / "artifacts").mkdir()
    (tmp_path / "artifacts" / "dryrun_torch.json").write_text(
        json.dumps(recs))
    status = run.run_modules(["roofline", "scalability"], device="cpu")
    assert status["roofline"]["status"] == "ok"
    assert status["roofline"]["records"] == 4
    assert status["scalability"]["rows"] == len(scalability.CHIPS)
    lines = capsys.readouterr().out.splitlines()
    rows = [ln for ln in lines if ln.startswith("roofline/")]
    assert len(rows) == 4 and all("model/counted_flops=" in ln
                                  for ln in rows)
    assert sum(ln.startswith("scalability/gin-tu_ogb_products_c")
               for ln in lines) == 5
    table = report.dryrun_table()
    assert table.count("| din | serve_p99 |") == 2
    assert report.roofline_table().count("| gin-tu | ogb_products |") == 2
    ratio = roofline.flops_ratio(recs[0])
    assert math.isfinite(ratio) and ratio > 0
