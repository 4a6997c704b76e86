"""Workload metrics (PSGS/FAP), placement, the tiered feature store, and
request batching/workload generation."""
from repro_torch.core.fap import compute_fap
from repro_torch.core.feature_store import (STATS_SCHEMA, DiskSpillTier,
                                            TieredFeatureStore)
from repro_torch.core.placement import (PlacementPlan, TopologySpec,
                                        quiver_placement)
from repro_torch.core.psgs import compute_psgs
from repro_torch.core.serving import (PRIORITIES, DynamicBatcher, Request,
                                      WorkloadGenerator, batch_seeds)

__all__ = [
    "compute_psgs", "compute_fap", "TopologySpec",
    "PlacementPlan", "quiver_placement", "TieredFeatureStore",
    "DiskSpillTier", "STATS_SCHEMA", "Request", "WorkloadGenerator",
    "DynamicBatcher", "batch_seeds", "PRIORITIES",
]
