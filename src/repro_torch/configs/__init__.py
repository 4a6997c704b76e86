"""Model configurations of the port: the reference's published settings
(``src/repro/configs``), without the JAX-only cell/sharding machinery.
Ported so far: :mod:`repro_torch.configs.din`,
:mod:`repro_torch.configs.gin_tu` and the GNN shapes and batch of
:mod:`repro_torch.configs.gnn_common`."""
from repro_torch.configs import din, gin_tu, gnn_common

__all__ = ["din", "gin_tu", "gnn_common"]
