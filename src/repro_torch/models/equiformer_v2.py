"""EquiformerV2 (12 layers, 128 channels, l_max 6, m_max 2, 8 heads,
SO(2)-eSCN convolutions; arXiv:2306.12059), ported from
``src/repro/models/equiformer_v2.py``.

Graph attention over irrep features ``x: (N, (l_max+1)², C)``:

  per edge:  x̃ = D_align(r̂) · x[src]          (per-l block rotations)
             ỹ = SO2Linear(x̃)                  (m-blockwise, m ≤ m_max)
             α = capped-exp attention           (normalized per dst)
             m = D_align⁻¹ · (α ⊙ ỹ)
  per node:  h' = h + W_out · Σ_dst m ;  FFN = scalar MLP + sigmoid gates
             on the l>0 irreps, equivariant RMS layer norm per l.

As in the reference:
  * the Wigner rotation blocks and the radial basis depend only on the
    edges, so they are computed once a forward and shared by all layers;
  * every layer is recomputed in the backward
    (``torch.utils.checkpoint``), and with ``edge_chunks > 1`` the edges
    are processed in chunks, each recomputed in its layer's backward too,
    with the attention's numerator and denominator summed across chunks
    (tanh-capped logits make the softmax exact without a max pass), so
    the ``(E, (l_max+1)², C)`` message tensors exist one chunk at a time.

The message sums are ``segment_sum`` (``index_add_``: atomics on the
card, so the order of a node's terms varies from run to run there). The
``.at[...].set`` scatters of the reference are writes into fresh zero
tensors and a concatenation, which autograd differentiates.

Not ported: ``equiformer_forward_local`` (the halo-exchange path; ROADMAP
A10b).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.graph.segment import segment_sum
from repro_torch.models.common import (MLP, dense_from_numpy, dense_init,
                                       linspace, mlp_from_numpy, mlp_init)
from repro_torch.models.so3 import edge_rotation_blocks, lm_index, num_coeffs


def _m0_rows(l_max: int) -> np.ndarray:
    return np.asarray([lm_index(l, 0) for l in range(l_max + 1)])


def _m_rows(l_max: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    ls = np.arange(m, l_max + 1)
    return (np.asarray([lm_index(l, m) for l in ls]),
            np.asarray([lm_index(l, -m) for l in ls]))


class SO2Linear(nn.Module):
    """SO(2) linear layer: full (l, channel) mixing within each |m| block.
    ``w0: (L1·c_in, L1·c_out)``; for m = 1..m_max, ``wr{m}``/``wi{m}``:
    ``(Lm·c_in, Lm·c_out)`` with ``Lm = l_max + 1 - m``, acting on the
    (+m, -m) pair as a complex product."""

    def __init__(self, l_max: int, m_max: int, c_out: int,
                 weights: dict[str, torch.Tensor]):
        super().__init__()
        self.l_max, self.m_max, self.c_out = l_max, m_max, c_out
        for name in ["w0"] + [f"w{p}{m}" for m in range(1, m_max + 1)
                              for p in "ri"]:
            self.register_parameter(name, nn.Parameter(weights[name]))
        # row indices of each |m| block (device buffers, so indexing
        # copies nothing from the host): m = 0, then (+m, -m) pairs
        self.register_buffer("r0", torch.as_tensor(_m0_rows(l_max)),
                             persistent=False)
        for m in range(1, m_max + 1):
            rp, rn = _m_rows(l_max, m)
            self.register_buffer(f"rp{m}", torch.as_tensor(rp),
                                 persistent=False)
            self.register_buffer(f"rn{m}", torch.as_tensor(rn),
                                 persistent=False)
        # the output rows the blocks fill, in their concatenation order;
        # rows with |m| > m_max stay zero
        self.register_buffer("rows", torch.cat(
            [self.r0] + [getattr(self, f"r{p}{m}")
                         for m in range(1, m_max + 1) for p in "pn"]),
            persistent=False)
        self.sizes = [l_max + 1] + [l_max + 1 - m for m in range(1, m_max + 1)
                                    for _ in "pn"]

    def blocks(self, x_rot: torch.Tensor,
               rad_scale: torch.Tensor) -> list[torch.Tensor]:
        """The output's nonzero rows by block, in the order of ``rows``:
        the m = 0 rows ``(E, L1, c_out)``, then for each m the +m and -m
        rows ``(E, Lm, c_out)``. The input rows are gathered in one
        ``index_select`` and split, so the backward adds into one buffer."""
        E = x_rot.shape[0]
        L1, C = self.l_max + 1, self.c_out
        x0, *xm = torch.split(x_rot.index_select(1, self.rows), self.sizes,
                              dim=1)
        out = [(x0.reshape(E, -1) @ self.w0).reshape(E, L1, C)
               * rad_scale[:, :, None]]
        for m in range(1, self.m_max + 1):
            wr, wi = getattr(self, f"wr{m}"), getattr(self, f"wi{m}")
            xp = xm[2 * m - 2].reshape(E, -1)
            xn = xm[2 * m - 1].reshape(E, -1)
            sc = rad_scale[:, m:, None]
            out += [(xp @ wr - xn @ wi).reshape(E, L1 - m, C) * sc,
                    (xp @ wi + xn @ wr).reshape(E, L1 - m, C) * sc]
        return out

    def assemble(self, blocks: list[torch.Tensor]) -> torch.Tensor:
        """``(E, S, c_out)`` with each block in its rows, zero elsewhere."""
        E, _, C = blocks[0].shape
        out = blocks[0].new_zeros((E, num_coeffs(self.l_max), C))
        out[:, self.rows] = torch.cat(blocks, dim=1)
        return out

    def forward(self, x_rot: torch.Tensor,
                rad_scale: torch.Tensor) -> torch.Tensor:
        """x_rot: (E, S, C) edge-frame features; rad_scale: (E, L1)
        per-l_out radial gate. Returns (E, S, c_out), zero where
        |m| > m_max."""
        return self.assemble(self.blocks(x_rot, rad_scale))


def so2_init(generator: torch.Generator, l_max: int, m_max: int, c_in: int,
             c_out: int) -> SO2Linear:
    """The reference's ``so2_init`` distributions: ``w0 ~ N(0,
    1/(L1·c_in))``, ``wr``/``wi ~ N(0, 1/(Lm·c_in))``."""
    L1 = l_max + 1
    w = {"w0": torch.randn((L1 * c_in, L1 * c_out), generator=generator)
         / math.sqrt(L1 * c_in)}
    for m in range(1, m_max + 1):
        Lm = l_max + 1 - m
        for p in "ri":
            w[f"w{p}{m}"] = (torch.randn((Lm * c_in, Lm * c_out),
                                         generator=generator)
                             / math.sqrt(Lm * c_in))
    return SO2Linear(l_max, m_max, c_out, w)


def so2_apply(so2: SO2Linear, x_rot: torch.Tensor,
              rad_scale: torch.Tensor) -> torch.Tensor:
    """The reference's ``so2_apply``: ``so2(x_rot, rad_scale)``."""
    return so2(x_rot, rad_scale)


def _split_l(x: torch.Tensor, l_max: int) -> tuple[torch.Tensor, ...]:
    """The l blocks ``x[:, l²:(l+1)², :]`` of x, as views. Taken by
    ``torch.split``, whose backward concatenates the blocks' gradients;
    slicing each would give each its own full-size zero gradient to add."""
    return torch.split(x, [2 * l + 1 for l in range(l_max + 1)], dim=1)


def _eq_layer_norm(g: torch.Tensor, x: torch.Tensor,
                   l_max: int) -> torch.Tensor:
    """Equivariant RMS norm: per (node, l) normalize over (m, channel);
    g: (L1, C) learned scale."""
    outs = []
    for l, blk in enumerate(_split_l(x, l_max)):
        rms = torch.sqrt((blk ** 2).mean(dim=(1, 2), keepdim=True) + 1e-6)
        outs.append(blk / rms * g[l][None, None, :])
    return torch.cat(outs, dim=1)


def _per_l(x: torch.Tensor, w: torch.Tensor, l_max: int) -> torch.Tensor:
    """``einsum("nic,co->nio")`` of each l block of x with ``w[l]``."""
    return torch.cat([blk @ w[l] for l, blk in enumerate(_split_l(x, l_max))],
                     dim=1)


def _rotate(blocks: list[torch.Tensor], x: torch.Tensor,
            l_max: int) -> torch.Tensor:
    """Each l block of x (E, 2l+1, C) by its per-edge rotation block."""
    return torch.cat([torch.bmm(d, blk)
                      for d, blk in zip(blocks, _split_l(x, l_max))], dim=1)


class EquiformerLayer(nn.Module):
    """One attention + FFN layer; parameter names as the reference's
    ``_layer_init``."""

    def __init__(self, *, ln1_g: torch.Tensor, so2: SO2Linear, rad: MLP,
                 alpha: MLP, out_proj: torch.Tensor, ln2_g: torch.Tensor,
                 ffn_scalar: MLP, ffn_gate: MLP, ffn_mix: torch.Tensor):
        super().__init__()
        self.ln1_g = nn.Parameter(ln1_g)
        self.so2 = so2
        self.rad = rad
        self.alpha = alpha
        self.out_proj = nn.Parameter(out_proj)
        self.ln2_g = nn.Parameter(ln2_g)
        self.ffn_scalar = ffn_scalar
        self.ffn_gate = ffn_gate
        self.ffn_mix = nn.Parameter(ffn_mix)


def _layer_init(generator: torch.Generator, channels: int, l_max: int,
                m_max: int, n_heads: int, n_rbf: int) -> EquiformerLayer:
    L1 = l_max + 1
    so2 = so2_init(generator, l_max, m_max, channels, channels)
    rad = mlp_init(generator, [n_rbf, channels, L1])
    alpha = mlp_init(generator, [L1 * channels, channels, n_heads])
    out_proj = (torch.randn((L1, channels, channels), generator=generator)
                / math.sqrt(channels))
    ffn_scalar = mlp_init(generator, [channels, 2 * channels, channels])
    ffn_gate = mlp_init(generator, [channels, L1 * channels])
    ffn_mix = (torch.randn((L1, channels, channels), generator=generator)
               / math.sqrt(channels))
    return EquiformerLayer(
        ln1_g=torch.ones((L1, channels)), so2=so2, rad=rad, alpha=alpha,
        out_proj=out_proj, ln2_g=torch.ones((L1, channels)),
        ffn_scalar=ffn_scalar, ffn_gate=ffn_gate, ffn_mix=ffn_mix)


class EquiformerV2(nn.Module):
    """Embedding (plus ``feat_proj`` of node features when built with
    ``d_feat_in``), the layers, and the output head on the l=0 channels.
    The architecture's sizes are attributes (the reference's
    ``infer_cfg``)."""

    def __init__(self, embed: torch.Tensor, layers: list[EquiformerLayer],
                 out1: nn.Linear, out2: nn.Linear,
                 feat_proj: Optional[nn.Linear] = None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.layers = nn.ModuleList(layers)
        self.out1 = out1
        self.out2 = out2
        self.feat_proj = feat_proj
        first = layers[0]
        self.l_max = first.ln1_g.shape[0] - 1
        self.channels = first.ln1_g.shape[1]
        self.m_max = first.so2.m_max
        self.n_heads = first.alpha.layers[-1].out_features
        self.n_rbf = first.rad.layers[0].in_features

    @property
    def n_layers(self) -> int:
        return len(self.layers)


def equiformer_init(generator: torch.Generator, *, n_layers: int = 12,
                    channels: int = 128, l_max: int = 6, m_max: int = 2,
                    n_heads: int = 8, n_rbf: int = 32, n_species: int = 32,
                    d_feat_in: int = 0, d_out: int = 1,
                    device: str | torch.device = "cuda") -> EquiformerV2:
    """The reference's ``equiformer_init`` widths and distributions
    (embedding ``N(0, 0.25)``, layer norms at unit gain), drawn on the CPU
    from ``generator`` in the order embed, feat_proj, out1, out2, then the
    layers; then moved to ``device``. The cutoff is a forward argument."""
    dev = resolve_device(device)
    embed = torch.randn((n_species, channels), generator=generator) * 0.5
    feat_proj = (dense_init(generator, d_feat_in, channels)
                 if d_feat_in else None)
    out1 = dense_init(generator, channels, channels)
    out2 = dense_init(generator, channels, d_out)
    layers = [_layer_init(generator, channels, l_max, m_max, n_heads, n_rbf)
              for _ in range(n_layers)]
    return EquiformerV2(embed, layers, out1, out2, feat_proj).to(dev)


def equiformer_from_numpy(params: dict, device: str | torch.device = "cuda"
                          ) -> EquiformerV2:
    """Carry the reference's ``equiformer_init`` tree (numpy arrays;
    ``layers`` stacked on a leading axis) into an :class:`EquiformerV2` on
    ``device``."""
    lay = params["layers"]
    n_layers, L1, channels = np.shape(lay["ln1_g"])
    m_max = max([m for m in range(1, L1) if f"wr{m}" in lay["so2"]] or [0])

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def mlp(stacked, i):
        return mlp_from_numpy([{k: v[i] for k, v in p.items()}
                               for p in stacked])

    layers = [EquiformerLayer(
        ln1_g=t(lay["ln1_g"][i]),
        so2=SO2Linear(L1 - 1, m_max, channels,
                      {k: t(v[i]) for k, v in lay["so2"].items()}),
        rad=mlp(lay["rad"], i), alpha=mlp(lay["alpha"], i),
        out_proj=t(lay["out_proj"][i]), ln2_g=t(lay["ln2_g"][i]),
        ffn_scalar=mlp(lay["ffn_scalar"], i),
        ffn_gate=mlp(lay["ffn_gate"], i), ffn_mix=t(lay["ffn_mix"][i]))
        for i in range(n_layers)]
    feat_proj = (dense_from_numpy(params["feat_proj"])
                 if "feat_proj" in params else None)
    model = EquiformerV2(t(params["embed"]), layers,
                         dense_from_numpy(params["out1"]),
                         dense_from_numpy(params["out2"]), feat_proj)
    return model.to(resolve_device(device))


def infer_cfg(model: EquiformerV2, *, cutoff: float = 5.0) -> dict:
    """The reference's ``infer_cfg``: the architecture's sizes."""
    return {"n_layers": model.n_layers, "channels": model.channels,
            "l_max": model.l_max, "m_max": model.m_max,
            "n_heads": model.n_heads, "n_rbf": model.n_rbf,
            "cutoff": cutoff}


def _rbf(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    mu = linspace(0.0, cutoff, n_rbf, device=dist.device)
    return torch.exp(-((dist[:, None] - mu[None, :]) ** 2)
                     * (n_rbf / max(cutoff, 1e-6)))


def _attention_edges(p: EquiformerLayer, cfg: dict, h_src: torch.Tensor,
                     valid: torch.Tensor, d: torch.Tensor, D, Dinv,
                     rbf: torch.Tensor, num_nodes: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """One pass over (a chunk of) edges: the attention's numerator
    ``(N, S, C)`` and denominator ``(N, H)`` sums. ``h_src``: gathered
    (normed) source rows ``(E, S, C)``; ``d``: destination rows in
    ``[0, num_nodes)``. Logits are tanh-capped so the sums of chunks add
    up to the whole softmax."""
    l_max, C, H = cfg["l_max"], cfg["channels"], cfg["n_heads"]
    x_rot = _rotate(D, h_src, l_max)                       # (E, S, C)
    rad = p.rad(rbf)                                       # (E, L1)
    blocks = p.so2.blocks(x_rot, F.silu(rad))
    y = p.so2.assemble(blocks)

    E, S = y.shape[:2]
    inv = blocks[0].reshape(E, -1)                         # invariant part
    logits = p.alpha(inv)                                  # (E, H)
    logits = 10.0 * torch.tanh(logits / 10.0)              # cap for exp
    w = torch.where(valid[:, None], torch.exp(logits), 0.0)

    y = (y.reshape(E, S, H, C // H) * w[:, None, :, None]).reshape(E, S, C)
    msg = _rotate(Dinv, y, l_max)
    msg = torch.where(valid[:, None, None], msg, 0.0)
    num = segment_sum(msg, d, num_nodes)                   # (N, S, C)
    den = segment_sum(w, d, num_nodes)                     # (N, H)
    return num, den


def _attention_finalize(p: EquiformerLayer, cfg: dict, num: torch.Tensor,
                        den: torch.Tensor) -> torch.Tensor:
    l_max, C, H = cfg["l_max"], cfg["channels"], cfg["n_heads"]
    n, S = num.shape[:2]
    agg = (num.reshape(n, S, H, C // H)
           / torch.clamp(den, min=1e-9)[:, None, :, None]).reshape(n, S, C)
    return _per_l(agg, p.out_proj, l_max)


def _ffn_block(p: EquiformerLayer, cfg: dict, x: torch.Tensor
               ) -> torch.Tensor:
    l_max, C = cfg["l_max"], cfg["channels"]
    h = _eq_layer_norm(p.ln2_g, x, l_max)
    scal = h[:, 0, :]
    gates = torch.sigmoid(p.ffn_gate(scal)).reshape(-1, l_max + 1, C)
    outs = [(blk @ p.ffn_mix[l]) * gates[:, l, :][:, None, :]
            for l, blk in enumerate(_split_l(h, l_max))]
    # the reference's out.at[:, 0, :].add(...): row 0 is the l=0 block
    outs[0] = outs[0] + p.ffn_scalar(scal)[:, None, :]
    return torch.cat(outs, dim=1)


def _chunk_edges(arr: torch.Tensor, chunks: int, fill) -> torch.Tensor:
    """``(chunks, ceil(E / chunks), ...)``: ``arr`` padded with ``fill``."""
    e = arr.shape[0]
    chunk = -(-e // chunks)
    pad = arr.new_full((chunk * chunks - e,) + tuple(arr.shape[1:]), fill)
    return torch.cat([arr, pad]).reshape((chunks, chunk)
                                         + tuple(arr.shape[1:]))


def _edges_pass(p, cfg, x, sc, dc, rc, *blocks):
    """Layer norm, source gather and the attention sums over one set of
    edges; ``blocks`` are the l_max+1 ``D`` blocks, then the ``Dinv``
    blocks."""
    L1 = cfg["l_max"] + 1
    h = _eq_layer_norm(p.ln1_g, x, cfg["l_max"])
    valid = (sc >= 0) & (dc >= 0)
    h_src = h[sc.clamp_min(0)]
    return _attention_edges(p, cfg, h_src, valid, dc.clamp_min(0),
                            list(blocks[:L1]), list(blocks[L1:]), rc,
                            x.shape[0])


def _layer_step(p, cfg, edge_chunks, x, src, dst, rbf, *blocks):
    if edge_chunks > 1:
        num = torch.zeros_like(x)
        den = x.new_zeros((x.shape[0], cfg["n_heads"]))
        for k in range(edge_chunks):
            # each chunk is recomputed in the backward too: otherwise the
            # layer's recompute would keep every chunk's message tensors
            n_, d_ = checkpoint(_edges_pass, p, cfg, x, src[k], dst[k],
                                rbf[k], *(b[k] for b in blocks),
                                use_reentrant=False)
            num, den = num + n_, den + d_
    else:
        num, den = _edges_pass(p, cfg, x, src, dst, rbf, *blocks)
    x = x + _attention_finalize(p, cfg, num, den)
    return x + _ffn_block(p, cfg, x)


def equiformer_forward(model: EquiformerV2, species: torch.Tensor,
                       positions: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor, *, num_nodes: int,
                       node_feat: Optional[torch.Tensor] = None,
                       mol_id: Optional[torch.Tensor] = None,
                       num_graphs: Optional[int] = None,
                       edge_chunks: int = 1,
                       cutoff: float = 5.0) -> torch.Tensor:
    """Per-node outputs ``(N, d_out)``, or per-graph sums
    ``(num_graphs, d_out)`` when ``mol_id`` is given. Edges ``src → dst``,
    -1 padded; ``edge_chunks`` splits them into that many chunks (padded
    with -1 edges)."""
    cfg = infer_cfg(model, cutoff=cutoff)
    l_max, C = cfg["l_max"], cfg["channels"]
    S = num_coeffs(l_max)

    h0 = model.embed[species.long().clamp(0, model.embed.shape[0] - 1)]
    if node_feat is not None and model.feat_proj is not None:
        h0 = h0 + model.feat_proj(node_feat)
    if h0.shape[0] != num_nodes:
        raise ValueError(f"{h0.shape[0]} node rows, num_nodes={num_nodes}")
    x = torch.cat([h0[:, None, :], h0.new_zeros((num_nodes, S - 1, C))],
                  dim=1)

    src, dst = src.long(), dst.long()
    rij = positions[dst.clamp_min(0)] - positions[src.clamp_min(0)]
    dist = torch.sqrt((rij ** 2).sum(-1) + 1e-12)
    rhat = rij / torch.clamp(dist, min=1e-6)[:, None]
    # edge geometry is depth-independent: computed once, used by all layers
    D, Dinv = edge_rotation_blocks(rhat, l_max)
    rbf = _rbf(dist, cfg["n_rbf"], cfg["cutoff"])
    blocks = D + Dinv
    if edge_chunks > 1:
        src = _chunk_edges(src, edge_chunks, -1)
        dst = _chunk_edges(dst, edge_chunks, -1)
        rbf = _chunk_edges(rbf, edge_chunks, 0.0)
        blocks = [_chunk_edges(b, edge_chunks, 0.0) for b in blocks]

    for p in model.layers:
        x = checkpoint(_layer_step, p, cfg, edge_chunks, x, src, dst, rbf,
                       *blocks, use_reentrant=False)

    out = model.out2(F.silu(model.out1(x[:, 0, :])))
    if mol_id is not None:
        if num_graphs is None:
            raise ValueError("mol_id needs num_graphs")
        return segment_sum(out, mol_id.long().clamp_min(0), num_graphs)
    return out
