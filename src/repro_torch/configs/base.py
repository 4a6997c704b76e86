"""Architecture registry — the ``--arch <id>`` surface of the launchers and
the dry-run, ported from ``src/repro/configs/base.py``.

Each architecture module registers an :class:`Arch`; its ``build_cell``
returns everything the dry-run (:mod:`repro_torch.launch.dryrun`) needs to
count one (arch × shape) cell: the step function, its arguments as fake
tensors (``torch._subclasses.fake_tensor.FakeTensor``: shapes and dtypes,
nothing allocated), their shardings on the given mesh, and a builder of
the same arguments with data for a run on the card. ``smoke`` runs a
reduced step on concrete tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass
class CellSpec:
    """One (arch × shape × mesh) cell.

    ``args`` are the step's arguments as fake tensors of ``fake_mode`` (a
    model's parameters, an optimizer state, a batch); ``in_shardings``
    matches them with :class:`~repro_torch.sharding.NamedSharding`
    records, a model as ``{parameter name: record}`` (None without a
    mesh). ``make_args(seed, device)`` builds the same arguments with
    data. ``dtype`` is the dtype of the cell's products (the peak the
    roofline divides by); ``meta`` what the dry-run and its collective
    model read (:func:`repro_torch.launch.hlo_analysis.model_collectives`):
    the family, config and shape, the ``rules``, the ``batch_spec`` of
    the batch's leading axis, and per family what the model needs."""

    step_fn: Callable
    args: tuple
    in_shardings: Optional[tuple]
    out_shardings: Any = None
    donate_argnums: tuple = ()
    kind: str = "train"                # "train" | "serve"
    notes: str = ""
    dtype: torch.dtype = torch.float32
    fake_mode: Any = None
    make_args: Optional[Callable] = None
    meta: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str                        # lm | moe_lm | gnn | recsys
    description: str = ""
    # the per-arch bridge the launcher trains through: a GNNAdapter for
    # the gnn family; None where the port has no training path
    adapter: Optional[Any] = None
    shape_names: tuple = ()
    # (shape, mesh, *, device) -> CellSpec
    build_cell: Optional[Callable] = None
    # runs a reduced step on the CPU, returns its outputs
    smoke: Optional[Callable] = None


def fake_to(module: torch.nn.Module, device: torch.device
            ) -> torch.nn.Module:
    """Re-register ``module``'s fake parameters and buffers as fresh fake
    tensors of the same shapes and dtypes on ``device``, in place (a fake
    module cannot be moved by ``.to``, which swaps each tensor; the
    values are not data, so nothing is copied). Call under the fake
    tensors' mode."""
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None and p.device != device:
                mod._parameters[name] = torch.nn.Parameter(
                    torch.empty_like(p, device=device),
                    requires_grad=p.requires_grad)
        for name, b in list(mod._buffers.items()):
            if b is not None and b.device != device:
                mod._buffers[name] = torch.empty_like(b, device=device)
    return module


_REGISTRY: dict[str, Arch] = {}


def register(arch: Arch) -> Arch:
    _REGISTRY[arch.name] = arch
    return arch


def get_arch(name: str) -> Arch:
    """The registered architecture ``name``. Raises ``KeyError``."""
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (trigger registration)
    return _REGISTRY[name]


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
