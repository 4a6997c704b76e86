"""The device mesh of the distributed paths: single-controller, as the
reference's ``jax.sharding.Mesh`` is.

One process holds an ordered tuple of devices with one or more named
axes; shard ``i`` of a sharded tensor lives on ``devices[i]``. Asking
for more shards than there are cards places them round-robin, so several
logical shards share one card (the counterpart of running the reference
on one host with ``--xla_force_host_platform_device_count``): the
sharded store batches
the work for the shards of one card into one op, and a move between two
shards of one card is no copy at all. An LM's expert shards
(:mod:`repro_torch.models.moe`) run each shard's products on their own,
so one card runs the code that W cards run, minus the peer copies. An
LM trains over a ``("data", "model")`` mesh (:func:`make_host_mesh` with
``model``): a dense one's weights split over ``"model"`` and replicated
over ``"data"`` (:mod:`repro_torch.models.tensor_parallel`), an MoE's
split over both (:mod:`repro_torch.models.fsdp`), each shard's blocks on
its own device.

:func:`make_production_mesh` gives the reference's production meshes by
shape alone (:class:`ProductionMesh`, no devices): the dry-run
(:mod:`repro_torch.launch.dryrun`) sizes each device's share of a cell
on them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices over one or more named axes.

    Attributes:
        devices: shard ``i`` lives on ``devices[i]``; a device may repeat.
            Over several axes the shards are in row-major order of their
            coordinates (the last axis fastest), as the devices of a
            ``jax.sharding.Mesh`` are in ``mesh.devices.flat``.
        axis_name: the axis' name (the serve launcher's is ``"x"``, an
            LM's ``"model"``), or the names of several axes in order (a
            train mesh's ``("data", "model")``).
        sizes: each axis' size, in the order of ``axis_name``; one axis
            defaults to every device.
    """

    devices: tuple
    axis_name: str | tuple = "x"
    sizes: tuple = ()

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        names = self.axis_names
        sizes = tuple(int(s) for s in self.sizes) or (len(self.devices),)
        if len(sizes) != len(names) or math.prod(sizes) != len(self.devices):
            raise ValueError(f"axes {names} of sizes {sizes} do not hold "
                             f"{len(self.devices)} devices")
        object.__setattr__(self, "sizes", sizes)

    @property
    def axis_names(self) -> tuple:
        return ((self.axis_name,) if isinstance(self.axis_name, str)
                else tuple(self.axis_name))

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}`` in axis order, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def world(self) -> int:
        return len(self.devices)

    def coords(self, shard: int) -> tuple[int, ...]:
        """Shard ``shard``'s coordinate, one index an axis."""
        out = []
        for size in reversed(self.sizes):
            shard, c = divmod(shard, size)
            out.append(c)
        return tuple(reversed(out))

    def device_at(self, *coord: int) -> torch.device:
        """The device at ``coord``, one index an axis."""
        shard = 0
        for c, size in zip(coord, self.sizes):
            shard = shard * size + c
        return self.devices[shard]

    def axis_groups(self, axis: str) -> list[tuple[int, ...]]:
        """The shards that differ only along ``axis``, one tuple for each
        coordinate of the other axes (in row-major order), each tuple in
        ``axis`` order: a ``("data", "model")`` mesh's ``"model"`` groups
        are its data replicas' model shards."""
        k = self.axis_names.index(axis)
        groups: dict[tuple, list[int]] = {}
        for shard in range(self.world):
            c = self.coords(shard)
            groups.setdefault(c[:k] + c[k + 1:], []).append(shard)
        return [tuple(g) for g in groups.values()]

    def groups(self) -> list[tuple[torch.device, tuple[int, ...]]]:
        """``(device, shard indices)`` for each distinct device, in the
        order of its first shard."""
        out: dict[str, tuple[torch.device, list[int]]] = {}
        for i, dev in enumerate(self.devices):
            out.setdefault(str(dev), (dev, []))[1].append(i)
        return [(dev, tuple(shards)) for dev, shards in out.values()]


@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    """A mesh of shape only: named axes and their sizes, no devices.

    Attributes:
        axis_names: the axes in order.
        sizes: each axis' size, in the same order.
    """

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}`` in axis order, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def world(self) -> int:
        return mesh_world(self)


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """The reference's production mesh (``src/repro/launch/mesh.py:16``):
    ``(16, 16)`` over ``("data", "model")``, or with ``multi_pod``
    ``(2, 16, 16)`` over ``("pod", "data", "model")``."""
    if multi_pod:
        return ProductionMesh(("pod", "data", "model"), (2, 16, 16))
    return ProductionMesh(("data", "model"), (16, 16))


def make_host_mesh(world: Optional[int] = None, *,
                   model: Optional[int] = None,
                   device: str | torch.device = "cuda",
                   axis_name: str = "x") -> Mesh:
    """A mesh of ``world`` shards over the cards of this host: one axis,
    or with ``model`` the reference's ``make_host_mesh(model=)`` layout,
    ``("data", "model")`` of sizes ``(world // model, model)``.

    Args:
        world: shards; defaults to the number of cards (1 on the CPU).
            Shards beyond the cards are placed round-robin: shard ``i``
            (in row-major order) on card ``i % cards``.
        model: the ``"model"`` axis' size; it must divide ``world``.
        device: ``"cuda"`` (every card, from card 0) or ``"cpu"`` (every
            shard on the CPU).
        axis_name: the one axis' name, without ``model``: ``"x"`` for the
            serve and train launchers' meshes, ``"model"`` for an LM's
            (the axis that the reference's ``lm_rules`` binds ``"expert"``
            to).

    Raises:
        RuntimeError: ``cuda`` was asked for and no card exists.
        ValueError: ``world`` or ``model`` below 1, or ``model`` does not
            divide ``world``.
    """
    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    world = cards if world is None else int(world)
    if world < 1:
        raise ValueError(f"a mesh needs at least one shard, got {world}")
    names, sizes = axis_name, ()
    if model is not None:
        if model < 1 or world % model:
            raise ValueError(f"a model axis of {model} does not divide "
                             f"{world} shards")
        names, sizes = ("data", "model"), (world // model, model)
    if dev.type == "cpu":
        return Mesh((dev,) * world, names, sizes)
    return Mesh(tuple(torch.device("cuda", i % cards) for i in range(world)),
                names, sizes)


def mesh_world(mesh: Mesh) -> int:
    """Shards in ``mesh`` (the product of its axis sizes)."""
    world = 1
    for size in mesh.shape.values():
        world *= int(size)
    return world
