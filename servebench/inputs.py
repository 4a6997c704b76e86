"""Inputs of a cell, all drawn from ``--seed``: the graph, the feature
table, the model's weights and the request schedule.

The graph follows the port's power-law law (``graph/generators.py::
power_law_graph``): zipf(2) out-degrees scaled to the edge count and capped
at a quarter of the nodes, destinations drawn by a zipf law over ranks
with the configuration's exponent, self loops dropped. It is a vectorised
copy of the law, not of its draws: out-degrees come from numpy, the
destinations from an inverse CDF on the card, so 10^8 edges draw in about
a second. The out-degrees are the zipf law's stratified quantiles and one
fixed draw of the rounding's deficit, the same multiset for every
``--seed``, given to the nodes in an order drawn from it: a seed's own
zipf draws would change the number of hubs and the typical degree, and so
the work of every request. Features are N(0, 1) and weights N(0, 1/d_in), both drawn on
the device by a ``torch.Generator`` in a few large calls.

Request seeds follow the serving workload's law (``core/serving.py::
WorkloadGenerator``): a node is drawn with probability proportional to its
out-degree (+1e-6). The schedule gives every ``--seed`` the same multiset
of request sizes and inter-arrival gaps (stratified quantiles of each
law), in another order, so the seed changes which nodes and in which
order, never how much work.
"""
from __future__ import annotations

import dataclasses
import math
import numpy as np
import torch

# seed streams, so that one --seed gives independent draws per input
_GRAPH, _FEATS, _WEIGHTS, _TRAFFIC, _CHECK, _CAL = range(6)


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one input stream of ``--seed``."""
    state = np.random.SeedSequence([int(seed) % 2**64, stream])
    return int(state.generate_state(1, np.uint64)[0]) >> 1


@dataclasses.dataclass
class Graph:
    """CSR on the host (``indptr`` int64, ``indices`` int32), as the port's
    ``CSRGraph`` holds it."""

    indptr: np.ndarray
    indices: np.ndarray
    num_nodes: int

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr)


def out_degrees(num_nodes: int, num_edges: int) -> np.ndarray:
    """The power-law law's out-degrees, the same for every seed: zipf(2)
    at the stratified levels ``(i + 1/2)/n``, capped at a quarter of the
    nodes, scaled to ``num_edges``, and the rounding's deficit spread over
    the nodes by one draw from a fixed stream."""
    cap = max(num_nodes // 4, 8)
    k = np.arange(1, cap + 1, dtype=np.float64)
    cdf = np.cumsum(k ** -2.0) / (math.pi ** 2 / 6)
    levels = (np.arange(num_nodes) + 0.5) / num_nodes
    base = np.minimum(np.searchsorted(cdf, levels) + 1,
                      cap).astype(np.float64)
    out_deg = np.maximum(np.round(base * (num_edges / num_nodes
                                          / base.mean())), 1).astype(np.int64)
    out_deg = np.minimum(out_deg, cap)
    deficit = num_edges - int(out_deg.sum())
    if deficit > 0:
        fixed = np.random.default_rng(sub_seed(0, _GRAPH))
        out_deg += np.bincount(fixed.integers(0, num_nodes, size=deficit),
                               minlength=num_nodes)
    return out_deg


def power_law_graph(num_nodes: int, num_edges: int, exponent: float,
                    seed: int, device: torch.device) -> Graph:
    """The port's power-law law at ``num_nodes`` and about ``num_edges``
    edges (self loops dropped), drawn from ``seed``."""
    rng = np.random.default_rng(sub_seed(seed, _GRAPH))
    out_deg = out_degrees(num_nodes, num_edges)[rng.permutation(num_nodes)]
    ranks = torch.as_tensor(rng.permutation(num_nodes), device=device)
    weights = 1.0 / np.power(np.arange(1, num_nodes + 1, dtype=np.float64),
                             exponent)
    cdf = torch.as_tensor(np.cumsum(weights / weights.sum()), device=device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, _GRAPH))
    total = int(out_deg.sum())
    deg_t = torch.as_tensor(out_deg, device=device)
    src = torch.repeat_interleave(torch.arange(num_nodes, device=device),
                                  deg_t, output_size=total)
    # draw in chunks of 2^25 so the float64 uniforms stay small
    dst = torch.empty(total, dtype=torch.int64, device=device)
    step = 1 << 25
    for lo in range(0, total, step):
        n = min(step, total - lo)
        u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
        r = torch.searchsorted(cdf, u, right=True).clamp_max(num_nodes - 1)
        dst[lo:lo + n] = ranks[r]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    counts = torch.bincount(src, minlength=num_nodes)
    indptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return Graph(indptr=indptr.cpu().numpy(),
                 indices=dst.to(torch.int32).cpu().numpy(),
                 num_nodes=int(num_nodes))


def features(num_nodes: int, dim: int, seed: int,
             device: torch.device) -> np.ndarray:
    """The ``(N, d)`` fp32 N(0, 1) feature table, on the host."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, _FEATS))
    return torch.randn((num_nodes, dim), generator=gen,
                       device=device).cpu().numpy()


def sage_weights(dims: list[int], seed: int,
                 device: torch.device) -> dict:
    """GraphSAGE weights for ``dims = [d_in, h_1, ..., d_out]`` in the
    layout ``sage_from_numpy`` takes (``w`` is ``(d_in, d_out)``):
    ``w ~ N(0, 1/d_in)``, biases and LayerNorm shifts ``N(0, 0.1^2)``,
    LayerNorm gains ``1 + N(0, 0.1^2)``, so every parameter takes part."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, _WEIGHTS))
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((2, a, b), generator=gen, device=device) / math.sqrt(a)
        v = torch.randn((4, b), generator=gen, device=device) * 0.1
        w, v = w.cpu().numpy(), v.cpu().numpy()
        layers.append({"self": {"w": w[0], "b": v[0]},
                       "neigh": {"w": w[1], "b": v[1]},
                       "ln": {"g": 1.0 + v[2], "b": v[3]}})
    return {"layers": layers}


class SeedLaw:
    """Seed nodes by the serving workload's law: proportional to
    out-degree (+1e-6)."""

    def __init__(self, out_degree: np.ndarray, law: str):
        if law != "out_degree":
            raise ValueError(f"unknown seed law {law!r}")
        w = out_degree.astype(np.float64) + 1e-6
        self.cdf = np.cumsum(w / w.sum())
        self.n = int(out_degree.shape[0])

    def draw(self, rng: np.random.Generator, size: int) -> np.ndarray:
        idx = np.searchsorted(self.cdf, rng.random(size), side="right")
        return np.minimum(idx, self.n - 1).astype(np.int64)


def stratified(n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` stratified quantile levels ``(i + 1/2)/n``, in an order drawn
    from ``rng``."""
    return rng.permutation((np.arange(n) + 0.5) / n)


def request_sizes(law: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """Seeds a request for ``n`` requests: the size law's stratified
    quantiles in a drawn order. Laws: ``fixed`` (``n``), ``log_uniform_int``
    (``lo``..``hi``)."""
    kind = law["law"]
    if kind == "fixed":
        return np.full(n, int(law["n"]), dtype=np.int64)
    if kind != "log_uniform_int":
        raise ValueError(f"unknown size law {kind!r}")
    q = stratified(n, rng)
    lo, hi = int(law["lo"]), int(law["hi"])
    s = np.floor(np.exp(np.log(lo) + q * (np.log(hi + 1) - np.log(lo))))
    return np.clip(s, lo, hi).astype(np.int64)


def arrival_offsets(traffic: dict, n: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Due times (seconds from the window's start) of ``n`` open-loop
    requests: Poisson arrivals at ``rate_rps``, their exponential gaps as
    stratified quantiles in a drawn order."""
    kind = traffic.get("arrivals", "poisson")
    if kind != "poisson":
        raise ValueError(f"unknown arrival law {kind!r}")
    gaps = -np.log1p(-stratified(n, rng)) / float(traffic["rate_rps"])
    return np.cumsum(gaps) - gaps[0]


@dataclasses.dataclass
class OpenSchedule:
    """An open loop's requests: due offsets, seed arrays, and which are
    checked for correctness."""

    due: np.ndarray
    seeds: list
    checked: list


def open_schedule(traffic: dict, law: SeedLaw, seconds: float, seed: int,
                  n_check: int) -> OpenSchedule:
    """Every request due in a window of ``seconds`` at the mix's rate, and
    a sample of ``n_check`` of them for the check, drawn from ``seed``,
    with the largest request in it."""
    rng = np.random.default_rng(sub_seed(seed, _TRAFFIC))
    n = max(int(round(float(traffic["rate_rps"]) * seconds)), 1)
    due = arrival_offsets(traffic, n, rng)
    sizes = request_sizes(traffic["sizes"], n, rng)
    flat = law.draw(rng, int(sizes.sum()))
    seeds = np.split(flat, np.cumsum(sizes)[:-1])
    crng = np.random.default_rng(sub_seed(seed, _CHECK))
    k = min(n_check, n)
    checked = set(crng.choice(n, size=max(k - 1, 0), replace=False).tolist())
    checked.add(int(np.argmax(sizes)))
    return OpenSchedule(due=due, seeds=seeds, checked=sorted(checked))


class ClosedRequests:
    """A closed loop's requests in submission order: request ``i``'s seeds
    are the ``i``-th draw of a generator seeded from ``--seed``; the
    checked ones are a sample of the first ``horizon`` indices."""

    def __init__(self, traffic: dict, law: SeedLaw, seed: int, n_check: int,
                 horizon: int):
        self.rng = np.random.default_rng(sub_seed(seed, _TRAFFIC))
        self.law = law
        # sizes cycle through one stratified block of the size law
        self.sizes = request_sizes(traffic["sizes"], 256, self.rng)
        self.count = 0
        crng = np.random.default_rng(sub_seed(seed, _CHECK))
        self.checked = sorted(crng.choice(
            horizon, size=min(n_check, horizon), replace=False).tolist())

    def next(self) -> np.ndarray:
        size = int(self.sizes[self.count % self.sizes.shape[0]])
        self.count += 1
        return self.law.draw(self.rng, size)


def calibration_batches(traffic: dict, law: SeedLaw, seed: int) -> list:
    """Seed batches for the router's calibration at the sizes the mix
    sends: for each power-of-two bucket the host executor pads to (16 and
    up) that the size law reaches, one batch of its largest size in
    range, two at a fixed size."""
    rng = np.random.default_rng(sub_seed(seed, _CAL))
    sl = traffic["sizes"]
    if sl["law"] == "fixed":
        sizes = [int(sl["n"])] * 2
    else:
        lo, hi = int(sl["lo"]), int(sl["hi"])
        sizes, b = [], 16
        while True:
            sizes.append(max(min(b, hi), lo))
            if b >= hi:
                break
            b *= 2
        if lo < 16:
            sizes.insert(0, lo)
    return [law.draw(rng, s) for s in sizes]

