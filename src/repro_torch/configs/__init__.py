"""Model configurations of the port: the reference's published settings
(``src/repro/configs``), without the JAX-only cell/sharding machinery.
Ported so far: :mod:`repro_torch.configs.din`."""
from repro_torch.configs import din

__all__ = ["din"]
