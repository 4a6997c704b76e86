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
each device's share of a cell and its collectives, and one runtime lays
an array out by them: an LM's MoE on a mesh holds each shard's block of
the expert axis (:func:`block_ranges` of the dispatch buffer's spec;
:mod:`repro_torch.models.moe`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

__all__ = ["Rules", "NamedSharding", "make_shard_fn", "named", "spec",
           "tree_shardings", "mesh_axis_size", "is_spec", "shard_factor",
           "spec_entry", "block_ranges"]


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
    :func:`block_ranges` gives for the constraint's spec."""
    return lambda x, *names: x


def block_ranges(mesh, entry, dim: int) -> list[tuple[int, int]]:
    """Each shard's contiguous ``[lo, hi)`` of one array dimension of size
    ``dim`` whose spec entry is ``entry``, on a one-axis ``mesh``.

    A sharded entry splits the dimension into equal blocks in shard order,
    the layout of a ``NamedSharding`` over one mesh axis. An unsharded one
    (None, as :func:`spec` leaves an entry whose dimension does not divide
    its axis) puts the whole dimension on the home shard, shard 0; the
    others hold an empty range at ``dim``.

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
    step = dim // ways
    return [(i * step, (i + 1) * step) for i in range(world)]


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
