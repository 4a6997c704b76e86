"""The device mesh of the distributed serve path: single-controller, as the
reference's ``jax.sharding.Mesh`` is.

One process holds an ordered tuple of devices with one axis name; shard
``i`` of a sharded tensor lives on ``devices[i]``. Asking for more shards
than there are cards places them round-robin, so several logical shards
share one card (the counterpart of running the reference on one host with
``--xla_force_host_platform_device_count``): the sharded store batches
the work for the shards of one card into one op, and a move between two
shards of one card is no copy at all. An LM's expert shards
(:mod:`repro_torch.models.moe`) run each shard's products on their own,
so one card runs the code that W cards run, minus the peer copies.

:func:`make_production_mesh` gives the reference's production meshes by
shape alone (:class:`ProductionMesh`, no devices): the dry-run
(:mod:`repro_torch.launch.dryrun`) sizes each device's share of a cell
on them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along one named axis.

    Attributes:
        devices: shard ``i`` lives on ``devices[i]``; a device may repeat.
        axis_name: the axis' name (the serve launcher's is ``"x"``, an
            LM's ``"model"``).
    """

    devices: tuple
    axis_name: str = "x"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def shape(self) -> dict[str, int]:
        """``{axis_name: world}``, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_name: len(self.devices)}

    @property
    def world(self) -> int:
        return len(self.devices)

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
                   device: str | torch.device = "cuda",
                   axis_name: str = "x") -> Mesh:
    """A one-axis mesh of ``world`` shards over the cards of this host.

    Args:
        world: shards; defaults to the number of cards (1 on the CPU).
            Shards beyond the cards are placed round-robin.
        device: ``"cuda"`` (every card, from card 0) or ``"cpu"`` (every
            shard on the CPU).
        axis_name: the axis' name: ``"x"`` for the serve and train
            launchers' meshes, ``"model"`` for an LM's (the axis that the
            reference's ``lm_rules`` binds ``"expert"`` to).

    Raises:
        RuntimeError: ``cuda`` was asked for and no card exists.
        ValueError: ``world`` below 1.
    """
    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    world = cards if world is None else int(world)
    if world < 1:
        raise ValueError(f"a mesh needs at least one shard, got {world}")
    if dev.type == "cpu":
        return Mesh((dev,) * world, axis_name)
    return Mesh(tuple(torch.device("cuda", i % cards) for i in range(world)),
                axis_name)


def mesh_world(mesh: Mesh) -> int:
    """Shards in ``mesh`` (the product of its axis sizes)."""
    world = 1
    for size in mesh.shape.values():
        world *= int(size)
    return world
