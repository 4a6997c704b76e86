"""The port's DIN training path against the reference on the CPU: the
``embedding_bag`` autograd Function (``kernels/embedding_bag/ops.py``)
against torch autograd of its plain version; ``models/din.py::din_loss``;
``configs/din.py::train_step`` against the reference's own cell step,
``build_din_cell(cfg, "train_batch", None).step_fn``; and the
``recsys_din`` launcher's ``--train-steps``.

The reference's weights are carried in by ``din_from_numpy`` at
``din_smoke``'s sizes (2,000 items, 64 categories, history 20, history ids
drawn from -1). The cell's ``AdamW(lr=1e-3, weight_decay=0.0)`` is built at
lr 1e-2 with no warm-up, so the step moves each entry by about 1e-2.
Tolerances, fp32: loss within 1e-6; the first moment after the step
(``0.1·`` the clipped gradient) per parameter within 1e-5 of its largest
entry; each parameter's change within 1e-4 per entry and 1e-3 of its norm
over the entries whose gradient is 0 or above 1e-5 of the largest (Adam's
first step turns a gradient within rounding of zero into a move that
rounding decides; every entry's gradient is still held by the first-moment
check). At most 1 in 100 entries may be left out: 156 of 91,594 here,
mostly weights of the main MLP's input columns that see near-zero
features.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.din as ref_din_config
from repro.models import din as jdin
from repro.training.optimizer import AdamW as JaxAdamW
from repro_torch.configs import din as din_config
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag import ref as bag_ref
from repro_torch.launch import recsys_din
from repro_torch.models import din as tdin
from repro_torch.training import StageTimer
from repro_torch.training.optimizer import AdamW

CFG = dict(n_items=2000, n_cates=64, embed_dim=18, hist_len=20,
           n_dense_feat=8)
B = 32
OPT = dict(lr=1e-2, warmup_steps=1, weight_decay=0.0)
GRAD_TOL, STEP_ATOL, STEP_NORM = 1e-5, 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its shapes are tiny, and the
    suite's parallel workers would otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0):
    """``din_smoke``'s draws, labels included."""
    rng = np.random.default_rng(seed)
    n, c, t = CFG["n_items"], CFG["n_cates"], CFG["hist_len"]
    return {"target_item": rng.integers(0, n, B).astype(np.int32),
            "target_cate": rng.integers(0, c, B).astype(np.int32),
            "hist_items": rng.integers(-1, n, (B, t)).astype(np.int32),
            "hist_cates": rng.integers(0, c, (B, t)).astype(np.int32),
            "dense_feat": rng.normal(size=(B, 8)).astype(np.float32),
            "label": rng.integers(0, 2, B).astype(np.int32)}


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _as_port(tree):
    return tdin.din_from_numpy(_np(tree), device="cpu").state_dict()


def test_train_step_matches_reference_cell():
    cfg_j = jdin.DINConfig(**CFG)
    params = jdin.din_init(jax.random.key(0), cfg_j)
    batch = _batch()
    saved = ref_din_config.AdamW
    ref_din_config.AdamW = lambda **kw: JaxAdamW(**OPT)
    try:
        cell = ref_din_config.build_din_cell(cfg_j, "train_batch", None)
    finally:
        ref_din_config.AdamW = saved
    new_ref, state_ref, loss_ref = cell.step_fn(
        params, JaxAdamW(**OPT).init(params),
        {k: jnp.asarray(v) for k, v in batch.items()})

    cfg_t = tdin.DINConfig(**CFG)
    model = tdin.din_from_numpy(_np(params), device="cpu")
    old = {k: v.clone() for k, v in model.state_dict().items()}
    opt = AdamW(**OPT)
    state = opt.init(dict(model.named_parameters()))
    state, loss = din_config.train_step(
        model, opt, state, {k: torch.from_numpy(v) for k, v in batch.items()},
        cfg_t)
    assert state.step == 1
    assert abs(float(loss) - float(loss_ref)) <= 1e-6
    new_ref, mu_ref, got = (_as_port(new_ref), _as_port(state_ref.mu),
                            model.state_dict())
    left_out = 0
    for k in old:
        size = float(mu_ref[k].abs().max())
        assert float((state.mu[k] - mu_ref[k]).abs().max()) <= \
            GRAD_TOL * size, k
        keep = (mu_ref[k].abs() > GRAD_TOL * size) | (mu_ref[k] == 0)
        left_out += int((~keep).sum())
        d_ref, d_got = new_ref[k] - old[k], got[k] - old[k]
        assert float(d_ref.abs().max()) > 5e-3, k
        diff = (d_got - d_ref)[keep]
        assert float(diff.abs().max()) <= STEP_ATOL, k
        assert float(diff.norm()) <= STEP_NORM * float(d_ref.norm()), k
    assert left_out <= sum(v.numel() for v in old.values()) // 100


def test_din_loss_matches_reference_and_forward_is_unchanged():
    cfg_j = jdin.DINConfig(**CFG)
    params = jdin.din_init(jax.random.key(3), cfg_j)
    batch = _batch(seed=5)
    want = float(jdin.din_loss(params, cfg_j,
                               {k: jnp.asarray(v) for k, v in batch.items()}))
    model = tdin.din_from_numpy(_np(params), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tdin.din_loss(model, tdin.DINConfig(**CFG), tb)
    assert got.requires_grad and abs(float(got.detach()) - want) <= 1e-6
    keys = ("target_item", "target_cate", "hist_items", "hist_cates",
            "dense_feat")
    served = tdin.din_forward(model, tdin.DINConfig(**CFG),
                              *(tb[k] for k in keys))
    assert not served.requires_grad
    assert torch.equal(served, tdin.din_logits(
        model, tdin.DINConfig(**CFG), *(tb[k] for k in keys)).detach())


def _plain_autograd(table, ids, weights, mode):
    """The bag by differentiable torch ops: valid rows gathered (an id ≥ V
    clamped to V-1), weighted, summed, over the valid count in mean
    mode."""
    valid = ids >= 0
    rows = table[ids.long().clamp(0, table.shape[0] - 1)]
    w = valid.to(table.dtype)
    if weights is not None:
        w = w * weights
    out = (rows * w[..., None]).sum(1)
    if mode == "mean":
        out = out / valid.sum(1, keepdim=True).clamp_min(1).to(table.dtype)
    return out


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_autograd_matches_plain_autograd(mode, weighted):
    """Forward and both gradients against autograd of the plain bag, with
    repeated ids (in one bag and across bags), padding, an all-padding bag
    and an id past the table; fp64 so the sums' order does not show."""
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(9, 5, generator=gen, dtype=torch.float64)
    ids = torch.tensor([[0, 3, 3, -1, 8], [3, -1, -1, -1, 12],
                        [-1, -1, -1, -1, -1], [7, 7, 7, 0, 3]],
                       dtype=torch.int32)
    weights = (torch.randn(4, 5, generator=gen, dtype=torch.float64)
               if weighted else None)
    g = torch.randn(4, 5, generator=gen, dtype=torch.float64)
    ins = [table.clone().requires_grad_()]
    if weighted:
        ins.append(weights.clone().requires_grad_())
    out = bag_ops.embedding_bag_autograd(ins[0], ids,
                                         ins[1] if weighted else None,
                                         mode=mode)
    got = torch.autograd.grad(out, ins, g)
    ref_ins = [x.clone().requires_grad_() for x in ins]
    want_out = _plain_autograd(ref_ins[0], ids,
                               ref_ins[1] if weighted else None, mode)
    want = torch.autograd.grad(want_out, ref_ins, g)
    torch.testing.assert_close(out, want_out, rtol=1e-6, atol=1e-6)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    # the forward is the dispatch, bit for bit
    assert torch.equal(out.detach(), bag_ref.embedding_bag_ref(
        table, ids, weights, mode=mode))


def test_launcher_trains_example_on_cpu(capsys):
    report = recsys_din.main(["--device", "cpu", "--config", "example",
                              "--train-steps", "2"])
    assert report["batch"] == 256 and report["steps"] == 2
    assert len(report["losses"]) == 2 and all(
        0.5 < x < 0.9 for x in report["losses"])     # near ln 2
    assert set(report["stage_ms"][0]) == {"forward", "backward",
                                          "optimizer"}
    assert report["embedding_bag_launches"] == 0     # the CPU runs plain
    assert '"steps": 2' in capsys.readouterr().out


def test_train_cell_is_what_the_launcher_trains():
    """``train`` runs ``train_cell``'s draw and step (what the train
    cells' profiler wraps): a fresh cell gives the same losses."""
    report = recsys_din.train("example", 2, device="cpu")
    _, draw, step = recsys_din.train_cell("example", device="cpu")
    assert [float(step(draw(), StageTimer("cpu"))) for _ in range(2)] == \
        report["losses"]


def test_train_batch_is_ported_at_the_reference_shape():
    assert din_config.SHAPES["train_batch"] == dict(kind="train",
                                                     batch=65536)
    assert recsys_din.TRAIN_BATCH["din"] == 65536
    assert not hasattr(din_config, "NOT_PORTED")
    opt = din_config.train_optimizer()
    assert (opt.lr, opt.weight_decay) == (1e-3, 0.0)
