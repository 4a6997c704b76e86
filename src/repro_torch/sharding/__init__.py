"""Logical → physical sharding rules, ported from
``src/repro/sharding/__init__.py``.

Model code names the axes of its arrays with *logical* names ("batch",
"tp", "expert", ...); each arch config binds those names to mesh axes for
a given mesh. Binding is divisibility-aware: a logical axis whose
dimension does not divide the mesh axis stays unsharded.

A spec is a plain ``tuple`` with the entries of the reference's
``PartitionSpec``: ``None``, a mesh axis name, or a tuple of two or more
names, one entry an array dimension (``()`` is replicated). As
``PartitionSpec`` does, an entry of one name is that name and an empty
one is None. The port has no GSPMD:
the dry-run (:mod:`repro_torch.launch.dryrun`) reads these specs to size
each device's share of a cell and its collectives, and two runtimes lay
arrays out by them, each device's block given by :func:`device_blocks`
(the blocks ``NamedSharding.devices_indices_map`` gives in the
reference): an LM's MoE on a mesh holds each shard's block of the expert
axis (:func:`block_ranges` of the dispatch buffer's spec;
:mod:`repro_torch.models.moe`), and an LM trained over a ``("data",
"model")`` mesh holds each device's block of every weight and of its
optimizer state (:mod:`repro_torch.models.tensor_parallel` for a dense
one, :mod:`repro_torch.models.fsdp` for an MoE, whose 4-D expert weights
and router take their blocks the same way).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

__all__ = ["Rules", "NamedSharding", "make_shard_fn", "named", "spec",
           "tree_shardings", "mesh_axis_size", "is_spec", "shard_factor",
           "spec_entry", "block_ranges", "device_blocks", "block_slices"]


@dataclasses.dataclass(frozen=True)
class Rules:
    """Map logical names → mesh axis (or tuple of axes) or None."""

    table: dict

    def axis(self, name: Optional[str]):
        if name is None:
            return None
        return self.table.get(name)

    def spec(self, *names) -> tuple:
        return tuple(spec_entry(self.axis(n)) for n in names)


def spec_entry(ax):
    """``PartitionSpec``'s form of one entry: ``("data",)`` is
    ``"data"``, ``()`` is None."""
    if isinstance(ax, tuple) and len(ax) <= 1:
        return ax[0] if ax else None
    return ax


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh: the record ``jax.sharding.NamedSharding``
    is in the reference."""

    mesh: Any
    spec: tuple


def is_spec(x) -> bool:
    """A spec leaf: a plain tuple (a ``NamedTuple`` is a container)."""
    return type(x) is tuple


def mesh_axis_size(mesh, axes) -> int:
    """The product of the sizes of mesh axes ``axes`` (a name, a tuple of
    names, or None for 1); reads only ``mesh.shape``."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        return int(mesh.shape[axes])
    size = 1
    for a in axes:
        size *= int(mesh.shape[a])
    return size


def shard_factor(mesh, s: tuple) -> int:
    """How many ways spec ``s`` splits an array over ``mesh``: the product
    of the sizes of the axes its entries name (1 without a mesh)."""
    if mesh is None:
        return 1
    factor = 1
    for entry in s:
        factor *= mesh_axis_size(mesh, entry)
    return factor


def make_shard_fn(mesh, rules: Rules):
    """``shard(x, *logical_names)``: the identity, with a mesh or without.

    In the reference this is ``with_sharding_constraint`` under a mesh,
    and the identity ``_noshard`` without one (one device). The port has
    no GSPMD to constrain, so both cases are the identity here. Where the
    port does split an array over a mesh, the split is explicit: an MoE
    on a mesh holds each shard's experts on that shard's device and moves
    the dispatch buffer's rows to them and back
    (:func:`repro_torch.models.moe.moe_experts`), by the ranges that
    :func:`block_ranges` gives for the constraint's spec; an LM on a
    train mesh holds each device's :func:`device_blocks` and moves
    activations (and, under full FSDP, weights) between them itself
    (:mod:`repro_torch.models.tensor_parallel`,
    :mod:`repro_torch.models.fsdp`)."""
    return lambda x, *names: x


def _axes(entry) -> tuple:
    """The mesh axes a spec entry names, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def device_blocks(mesh, s: tuple, shape) -> list[tuple[tuple[int, int], ...]]:
    """Each shard's block of an array of ``shape`` laid out by spec ``s``
    on ``mesh``: one ``[lo, hi)`` a dimension, shards in the mesh's
    row-major order (``mesh.devices.flat`` in the reference).

    A dimension whose entry is None is whole on every shard (replicated);
    one that names an axis, or a tuple of axes (the first major), is split
    into equal blocks in the order of those axes' coordinates. Entries
    past the end of ``s`` are None. These are the blocks that
    ``NamedSharding(mesh, s).devices_indices_map(shape)`` gives. Reads only
    ``mesh.shape``.

    Raises:
        ValueError: an entry names an axis the mesh lacks, or its size
            does not divide its dimension.
    """
    sizes = {a: int(n) for a, n in mesh.shape.items()}
    entries = tuple(s) + (None,) * (len(shape) - len(s))
    for entry, dim in zip(entries, shape):
        axes = _axes(entry)
        if any(a not in sizes for a in axes):
            raise ValueError(f"entry {entry!r} names an axis outside "
                             f"{tuple(sizes)}")
        if dim % math.prod(sizes[a] for a in axes):
            raise ValueError(f"entry {entry!r} does not split a dimension "
                             f"of {dim} over {sizes}")
    names = tuple(sizes)
    out = []
    for shard in range(math.prod(sizes.values())):
        coord, rest = {}, shard
        for a in reversed(names):
            rest, coord[a] = divmod(rest, sizes[a])
        block = []
        for entry, dim in zip(entries, shape):
            idx, ways = 0, 1
            for a in _axes(entry):
                idx = idx * sizes[a] + coord[a]
                ways *= sizes[a]
            step = dim // ways
            block.append((idx * step, (idx + 1) * step))
        out.append(tuple(block))
    return out


def block_slices(block, within=None) -> tuple[slice, ...]:
    """``block``'s slices, absolute, or relative to the block ``within``
    that contains it."""
    if within is None:
        return tuple(slice(lo, hi) for lo, hi in block)
    return tuple(slice(lo - wlo, hi - wlo)
                 for (lo, hi), (wlo, _) in zip(block, within))


def block_ranges(mesh, entry, dim: int) -> list[tuple[int, int]]:
    """Each shard's contiguous ``[lo, hi)`` of one array dimension of size
    ``dim`` whose spec entry is ``entry``, on a one-axis ``mesh``.

    A sharded entry splits the dimension into equal blocks in shard order,
    :func:`device_blocks` over one mesh axis. An unsharded one (None, as
    :func:`spec` leaves an entry whose dimension does not divide its axis)
    puts the whole dimension on the home shard, shard 0; the others hold
    an empty range at ``dim``.

    Raises:
        ValueError: ``entry`` names other axes than the mesh's one, or its
            size does not divide ``dim``.
    """
    world = math.prod(int(s) for s in mesh.shape.values())
    ways = mesh_axis_size(mesh, entry)
    if ways == 1:
        return [(0, dim)] + [(dim, dim)] * (world - 1)
    if ways != world or dim % ways:
        raise ValueError(f"entry {entry!r} of a dimension of {dim} does "
                         f"not split it over a one-axis mesh of {world}")
    return [b[0] for b in device_blocks(mesh, (entry,), (dim,))]


def named(mesh, s: tuple) -> Optional[NamedSharding]:
    return NamedSharding(mesh, s) if mesh is not None else None


def spec(mesh, rules: Rules, dims, *names) -> tuple:
    """Divisibility-aware spec for an array of shape ``dims``."""
    out = []
    for d, n in zip(dims, names):
        ax = rules.axis(n)
        if mesh is not None and ax is not None \
                and d % mesh_axis_size(mesh, ax) != 0:
            ax = None
        out.append(spec_entry(ax))
    return tuple(out)


def _map_specs(fn, tree):
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    return tree


def tree_shardings(mesh, spec_tree):
    """Map a tree of specs (dicts, lists and named tuples of spec leaves)
    to :class:`NamedSharding` records; None without a mesh."""
    if mesh is None:
        return None
    return _map_specs(lambda s: NamedSharding(mesh, s), spec_tree)
