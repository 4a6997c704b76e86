"""Halo exchange for locality-partitioned message passing, on the
single-controller mesh (``src/repro/core/halo.py``).

Partition the edges by *destination owner* once (the data pipeline's
:func:`partition_edges_by_dst`); then every scatter of a message-passing
layer is local to its shard, and the only communication is gathering the
*remote source rows* each shard needs: a capacity-bounded exchange whose
volume is the remote fraction, not O(N·F). Each exchange runs the
reference's four steps in its order:

  1. dedup each shard's wanted ids (``fixed_size_unique``);
  2. bucket the unique ids by owner, ``cap_pp`` a peer
     (:func:`bucket_by_owner`; ids over capacity are dropped and read as
     zero rows, like a cache miss);
  3. send the requests to their owners and answer with local rows
     (invalid requests answer zero rows);
  4. scatter the answered rows back to the wanted (duplicated) order;
     dropped and ``-1`` ids give zero rows.

The mesh (:class:`~repro_torch.launch.mesh.Mesh`) is single-controller:
one process sees every shard. Shards placed on one card form a *group*
(``mesh.groups()``), and a sharded tensor is held as one tensor a group,
the rows of its shards concatenated in shard order, so the work of the
shards of one card is one op. Steps 1–2 depend only on the ids, so they
are planned once (:meth:`HaloCtx.plan`) and every exchange of those ids
reuses the plan (GIN's five layers, EquiformerV2's twelve). Step 3's
all-to-all is a transposition of the request blocks: each owner group
answers the valid requests of each requester group with one
``index_select``, the answer moves with ``.to(device)`` (a peer copy
between cards, no copy between the shards of one card) and lands in the
requester's zeroed answer buffer (a write whose backward is a gather). A
group's answer buffer holds ``(shards, world·cap_pp)`` rows with owners
in group order; a wanted id's position in it is :attr:`HaloPlan.pos`. Everything is
differentiable (``index_select``, ``.to`` and that write), so gradients
of the gathered rows flow back to the owners' rows, as the reference's
``value_and_grad`` does through its ``all_to_all``.

Counters (:data:`HALO_STATS_SCHEMA`, on :attr:`HaloCtx.stats`) add up
every exchange.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.graph.sampler import fixed_size_unique
from repro_torch.launch.mesh import Mesh

# Counters of the exchanges of one HaloCtx, added up over every exchange.
HALO_STATS_SCHEMA: tuple = (
    "exchanges", "unique_ids", "remote_ids", "dropped_ids",
    "rows_between_cards", "rows_within_card")


def _new_halo_stats() -> dict[str, int]:
    """Zeroed exchange counters:

      exchanges           exchanges run (one a layer, and again in a
                          recomputing backward)
      unique_ids          valid distinct ids wanted, summed over shards
      remote_ids          those owned by another shard
      dropped_ids         those over their owner's ``cap_pp`` (zero rows)
      rows_between_cards  answer rows (valid requests) moved from one
                          card to another
      rows_within_card    answer rows whose owner and requester share a
                          card (no copy)
    """
    return dict.fromkeys(HALO_STATS_SCHEMA, 0)


def bucket_by_owner(ids: torch.Tensor, num_owners: int,
                    rows_per_owner: int, cap_pp: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucket global ids by their owner, ``cap_pp`` a peer.

    Args:
        ids: ``(U,)`` global ids, ``-1`` padded.

    Returns:
        ``(req (num_owners, cap_pp) int32, -1 padded; slot (U,) int32)``:
        each id's position ``owner·cap_pp + rank`` in ``req``, its rank
        among the ids of its owner in input order (a stable sort by
        owner); ``-1`` for a ``-1`` id or one over capacity. The
        reference's layout bit for bit.
    """
    u = ids.shape[0]
    dev = ids.device
    owner = torch.where(ids >= 0, ids // rows_per_owner, num_owners).long()
    sorted_owner, order = torch.sort(owner, stable=True)
    # rank within an owner block = position - first position of the owner
    rank = (torch.arange(u, device=dev)
            - torch.searchsorted(sorted_owner, sorted_owner))
    keep = (sorted_owner < num_owners) & (rank < cap_pp)
    flat_pos = sorted_owner * cap_pp + rank
    req = torch.full((num_owners * cap_pp,), -1, dtype=torch.int32,
                     device=dev)
    req[flat_pos[keep]] = ids[order][keep].to(torch.int32)
    slot = torch.full((u,), -1, dtype=torch.int32, device=dev)
    slot[order] = torch.where(keep, flat_pos, -1).to(torch.int32)
    return req.view(num_owners, cap_pp), slot


class _Place(torch.autograd.Function):
    """Rows written into a zeroed ``(n, *f)`` tensor at given positions;
    the backward gathers the gradient at those positions. (``index_copy_``
    would do the same, but its autograd keeps the copied rows alive until
    the backward.)"""

    @staticmethod
    def forward(ctx, n: int, count: int, *tensors):
        puts, parts = tensors[:count], tensors[count:]
        ctx.save_for_backward(*puts)
        out = parts[0].new_zeros((n,) + tuple(parts[0].shape[1:]))
        for put, rows in zip(puts, parts):
            out.index_copy_(0, put, rows)
        return out

    @staticmethod
    def backward(ctx, grad):
        puts = ctx.saved_tensors
        return (None, None, *(None for _ in puts),
                *(grad.index_select(0, put) for put in puts))


def _place(n: int, puts: Sequence[torch.Tensor],
           parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``out = zeros((n, *f))``; ``out[puts[i]] = parts[i]`` for each
    ``i``; differentiable in ``parts``."""
    return _Place.apply(n, len(puts), *puts, *parts)


@dataclasses.dataclass(eq=False)
class HaloPlan:
    """Steps 1–2 of one exchange for every shard, and the addresses steps
    3–4 use; index tensors only, so any number of exchanges of the same
    ids reuse it.

    Attributes:
        take: ``take[g][h]``: int64 rows of owner group ``h``'s rows that
            answer requester group ``g``'s valid requests, on ``h``'s
            device.
        put: ``put[g][h]``: where those rows go in ``g``'s answer buffer,
            on ``g``'s device (the buffer's other rows stay zero).
        pos: ``pos[g]``: ``(k_g·E,)`` int64 position of each wanted id in
            group ``g``'s answer buffer, ``-1`` for a dropped or ``-1``
            id.
        counts: the plan's ``unique_ids``, ``remote_ids`` and
            ``dropped_ids``.
    """

    take: list[list[torch.Tensor]]
    put: list[list[torch.Tensor]]
    pos: list[torch.Tensor]
    counts: dict[str, int]


class HaloCtx:
    """The sharding context handed to locality-sharded model code.

    The reference's ``HaloCtx`` runs inside ``shard_map`` and sees one
    shard; this one sees every shard, so its methods take lists with one
    tensor a group of ``mesh.groups()`` (the rows of the group's shards
    in shard order) or a shard index.

    Attributes:
        axes, sizes, world: the mesh's axis names, their sizes and their
            product.
        rows: node rows a shard owns (shard ``s`` owns ``[s·rows,
            (s+1)·rows)``).
        cap_pp: ids a shard may request from each peer in one exchange.
        groups: ``mesh.groups()``: ``(device, shards)`` a card.
        stats: the exchange counters (:data:`HALO_STATS_SCHEMA`).
    """

    def __init__(self, mesh: Mesh, rows: int, cap_pp: int):
        self.mesh = mesh
        self.axes = tuple(mesh.shape)
        self.sizes = [mesh.shape[a] for a in self.axes]
        self.world = int(np.prod(self.sizes))
        self.rows = int(rows)
        self.cap_pp = int(cap_pp)
        self.groups = mesh.groups()
        self.stats = _new_halo_stats()
        # a buffer's owner order: the groups' shards, group after group
        order = [s for _, shards in self.groups for s in shards]
        self._opos = np.empty(self.world, np.int64)
        self._opos[order] = np.arange(self.world)

    def index(self, shard: int) -> int:
        return shard

    def offset(self, shard: int) -> int:
        """The first global row of ``shard``."""
        return shard * self.rows

    def local_rows(self, group: int, ids: torch.Tensor) -> torch.Tensor:
        """Group-local rows of global node ids laid out like the group's
        edges (``k_g`` equal shard slices): the id's row within its
        shard, ``clip(id − offset, 0, rows−1)`` as the reference's
        ``d_loc``, plus the shard's first row in the group; ``-1`` where
        ``ids < 0``."""
        shards = self.groups[group][1]
        e = ids.shape[0] // len(shards)
        pos = torch.arange(len(shards), device=ids.device).repeat_interleave(e)
        first = torch.as_tensor(shards, device=ids.device)[pos] * self.rows
        loc = (ids.long() - first).clamp(0, self.rows - 1) + pos * self.rows
        return torch.where(ids >= 0, loc, -1)

    @torch.no_grad()
    def plan(self, ids: Sequence[torch.Tensor]) -> HaloPlan:
        """Steps 1–2 for every shard.

        Args:
            ids: one ``(k_g·E,)`` tensor a group: the global ids each of
                its shards wants (``E`` each, in shard order), ``-1``
                padded.
        """
        W, cap, R = self.world, self.cap_pp, self.rows
        reqs, pos = [], []
        counts = []
        for (dev, shards), want_g in zip(self.groups, ids):
            want_g = want_g.to(dev, torch.int32).view(len(shards), -1)
            e = want_g.shape[1]
            opos = torch.as_tensor(self._opos, device=dev)
            req_g, pos_g = [], []
            for k, s in enumerate(shards):
                want = want_g[k]
                uniq, inv = fixed_size_unique(want, e)
                req, slot = bucket_by_owner(uniq, W, R, cap)
                owner = (slot // cap).long().clamp_min(0)
                upos = torch.where(slot >= 0, opos[owner] * cap + slot % cap,
                                   -1)
                p = torch.where(want >= 0, upos[inv.long()], -1)
                pos_g.append(torch.where(p >= 0, p + k * W * cap, -1))
                req_g.append(req)
                valid = uniq >= 0
                counts.append(torch.stack([
                    valid.sum(), (valid & (uniq // R != s)).sum(),
                    (valid & (slot < 0)).sum()]).cpu())
            reqs.append(torch.stack(req_g))               # (k_g, W, cap)
            pos.append(torch.cat(pos_g))
        take, put = [], []
        for (dev, shards), req in zip(self.groups, reqs):
            pairs = [self._route(req, dev, dev_h, shards_h)
                     for dev_h, shards_h in self.groups]
            take.append([t for t, _ in pairs])
            put.append([p for _, p in pairs])
        total = torch.stack(counts).sum(0).tolist()
        return HaloPlan(take, put, pos, dict(zip(
            ("unique_ids", "remote_ids", "dropped_ids"), total)))

    def _route(self, req: torch.Tensor, dev: torch.device,
               dev_h: torch.device, shards_h: tuple
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """The valid requests of one requester group (``req`` ``(k_g, W,
        cap)`` on ``dev``) to the owner group ``shards_h`` on ``dev_h``:
        the owners' group-local rows that answer them, sent to ``dev_h``,
        and the answers' positions in the requester's buffer (owners in
        the buffer's owner order)."""
        W, cap, R = self.world, self.cap_pp, self.rows
        owners = torch.as_tensor(shards_h, device=dev)
        block = req[:, owners, :].long()                   # (k_g, k_h, cap)
        shift = ((owners - torch.arange(len(shards_h), device=dev))
                 * R)[None, :, None]
        col = torch.as_tensor(self._opos, device=dev)[owners] * cap
        where = (torch.arange(req.shape[0], device=dev)[:, None, None]
                 * (W * cap) + col[None, :, None]
                 + torch.arange(cap, device=dev)[None, None, :])
        valid = block >= 0
        return (block - shift)[valid].to(dev_h), where[valid]

    def exchange(self, plan: HaloPlan, xs: Sequence[torch.Tensor]
                 ) -> list[torch.Tensor]:
        """Step 3: every group's answer buffer, ``(k_g·world·cap_pp, *f)``
        on its device, for the rows ``xs`` (one ``(k_g·rows, *f)`` tensor
        a group). Only valid requests are answered; the buffer's other
        rows are zero. Each answered row is one ``index_select`` read and
        one write, so the backward adds at most ``world`` gradient rows
        into an owner's row (one a requester) and none into a shared
        row."""
        out = []
        for gi, (dev, shards) in enumerate(self.groups):
            parts = []
            for hi, (dev_h, _) in enumerate(self.groups):
                take = plan.take[gi][hi]
                key = ("rows_within_card" if dev_h == dev
                       else "rows_between_cards")
                self.stats[key] += take.numel()
                parts.append(xs[hi].index_select(0, take).to(dev))
            out.append(_place(len(shards) * self.world * self.cap_pp,
                              plan.put[gi], parts))
        self.stats["exchanges"] += 1
        for k, v in plan.counts.items():
            self.stats[k] += v
        return out

    def gather(self, xs: Sequence[torch.Tensor], plan: HaloPlan
               ) -> list[torch.Tensor]:
        """Steps 3–4: for each group, the rows of the ids ``plan`` was
        made for, in their order (zero rows for dropped and ``-1``
        ids)."""
        out = []
        for buf, p in zip(self.exchange(plan, xs), plan.pos):
            hit = (p >= 0).nonzero().squeeze(1)
            out.append(_place(p.shape[0], [hit],
                              [buf.index_select(0, p[hit])]))
        return out

    def ell(self, plan: HaloPlan, group: int, dst_rows: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
        """The ELL pair of one group's local sums straight from its answer
        buffer (the edge-ordered copy of the rows is never built).

        Args:
            dst_rows: ``(k_g·E,)`` group-local destination row of each
                wanted id's edge (:meth:`local_rows`), ``-1`` for none.

        Returns:
            ``(ids, ids_t)``: row ``d`` of ``ids`` ``(k_g·rows, Dmax)``
            lists the buffer positions of the edges into ``d`` in edge
            order (dropped and invalid edges left out: their rows are
            zero); ``ids_t`` ``(k_g·world·cap_pp, Dmax')`` is its
            transposed table, each buffer row's destinations in edge
            order (the order of the reference's scatter of the gradient),
            for the backward.
        """
        from repro_torch.kernels.segment_spmm.ref import ell_table
        shards = self.groups[group][1]
        p = plan.pos[group]
        return (ell_table(p, dst_rows, len(shards) * self.rows),
                ell_table(dst_rows, p,
                          len(shards) * self.world * self.cap_pp))

    def all_gather(self, xs: Sequence[torch.Tensor],
                   device: torch.device) -> torch.Tensor:
        """Every shard's rows in shard order, on ``device``."""
        if len(self.groups) == 1:
            return xs[0].to(device)
        chunks = {}
        for (_, shards), x in zip(self.groups, xs):
            for k, piece in zip(shards, x.chunk(len(shards))):
                chunks[k] = piece
        return torch.cat([chunks[s].to(device) for s in range(self.world)])

    def mean(self, totals: Sequence[torch.Tensor],
             counts: Sequence[torch.Tensor]) -> torch.Tensor:
        """``Σ total / max(Σ count, 1)`` over the shards, summed in shard
        order in fp32 on the first shard's device; ``totals`` and
        ``counts``: one ``(k_g,)`` tensor a group, a value a shard."""
        dev = self.mesh.devices[0]
        per = {}
        for (_, shards), t, c in zip(self.groups, totals, counts):
            for k, s in enumerate(shards):
                per[s] = (t[k].float().to(dev), c[k].float().to(dev))
        total, count = per[0]
        for s in range(1, self.world):
            total, count = total + per[s][0], count + per[s][1]
        return total / count.clamp_min(1.0)

    def replicas(self, module: nn.Module) -> list[nn.Module]:
        """``module`` for each group: itself where the group's card holds
        its parameters, else a replica whose parameters are
        differentiable copies (``torch.nn.parallel.replicate``), so the
        replicas' gradients add up in ``module``'s."""
        home = next(module.parameters()).device
        out, made = [], {}
        for dev, _ in self.groups:
            if torch.empty(0, device=dev).device == home:
                out.append(module)
                continue
            if dev not in made:
                made[dev] = nn.parallel.replicate(module, [home, dev],
                                                  detach=False)[1]
            out.append(made[dev])
        return out


def halo_gather(xs: Sequence[torch.Tensor],
                want_ids: Sequence[torch.Tensor], *, mesh: Mesh,
                rows_per_shard: int, cap_pp: int) -> list[torch.Tensor]:
    """The reference's ``halo_gather`` for every shard at once: shard
    ``s`` holds ``xs[s]`` (rows ``[s·R, (s+1)·R)`` of the sharded array,
    on ``mesh.devices[s]``) and wants the global rows ``want_ids[s]``
    (``-1`` padded, equal lengths). Returns each shard's
    ``(len(want_ids[s]), *f)`` rows; over-capacity and ``-1`` ids give
    zero rows."""
    ctx = HaloCtx(mesh, rows_per_shard, cap_pp)
    xg = [torch.cat([xs[s].to(dev) for s in shards])
          for dev, shards in ctx.groups]
    wg = [torch.cat([want_ids[s].to(dev) for s in shards])
          for dev, shards in ctx.groups]
    out = {}
    for (_, shards), rows in zip(ctx.groups, ctx.gather(xg, ctx.plan(wg))):
        for s, piece in zip(shards, rows.chunk(len(shards))):
            out[s] = piece
    return [out[s] for s in range(ctx.world)]


def partition_edges_by_dst(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                           num_shards: int) -> tuple[np.ndarray, np.ndarray]:
    """Data-pipeline step: sort the edge list so shard d's slice only
    contains edges whose dst lives on shard d (dst-aligned partitioning).
    Pads each shard's slice to the common max with -1. The reference's
    numpy, bit for bit (a stable sort by owner)."""
    rows = -(-num_nodes // num_shards)
    owner = dst // rows
    order = np.argsort(owner, kind="stable")
    src_s, dst_s = src[order], dst[order]
    counts = np.bincount(owner, minlength=num_shards)
    cap = int(counts.max())
    out_src = np.full((num_shards, cap), -1, np.int32)
    out_dst = np.full((num_shards, cap), -1, np.int32)
    off = 0
    for d in range(num_shards):
        c = counts[d]
        out_src[d, :c] = src_s[off:off + c]
        out_dst[d, :c] = dst_s[off:off + c]
        off += c
    return out_src.reshape(-1), out_dst.reshape(-1)


def remote_fraction(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                    num_shards: int) -> float:
    """Partitioner statistic that sizes ``cap_pp``: fraction of edges whose
    src lives on a different shard than dst."""
    rows = -(-num_nodes // num_shards)
    return float(np.mean((src // rows) != (dst // rows)))
