"""Architecture registry — the ``--arch <id>`` surface of the launchers,
ported from ``src/repro/configs/base.py`` as far as the training launcher
needs it: :class:`Arch`, :func:`register`, :func:`get_arch` and
:func:`list_archs`. The reference's ``CellSpec``, ``build_cell`` and
``smoke`` are dry-run machinery and are not ported (ROADMAP A12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str                        # lm | moe_lm | gnn | recsys
    description: str = ""
    # the per-arch bridge the launcher trains through: a GNNAdapter for
    # the gnn family; None where the port has no training path
    adapter: Optional[Any] = None


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
