"""Workload metrics (PSGS/FAP), placement and online re-placement, the
tiered feature store with its device cache and prefetcher, the sharded
store over a device mesh, and request batching/workload generation."""
from repro_torch.core.fap import compute_fap
from repro_torch.core.feature_store import (SHARDED_STATS_SCHEMA,
                                            STATS_SCHEMA, DiskSpillTier,
                                            ShardedFeatureStore,
                                            TieredFeatureStore)
from repro_torch.core.gpu_cache import GPUFeatureCache
from repro_torch.core.placement import (PlacementPlan, TopologySpec,
                                        migration_pairs, quiver_placement)
from repro_torch.core.prefetch import Prefetcher
from repro_torch.core.psgs import compute_psgs
from repro_torch.core.serving import (PRIORITIES, DynamicBatcher, Request,
                                      WorkloadGenerator, batch_seeds)

__all__ = [
    "compute_psgs", "compute_fap", "TopologySpec",
    "PlacementPlan", "quiver_placement", "migration_pairs",
    "TieredFeatureStore", "ShardedFeatureStore", "DiskSpillTier",
    "STATS_SCHEMA", "SHARDED_STATS_SCHEMA",
    "GPUFeatureCache", "Prefetcher", "Request", "WorkloadGenerator",
    "DynamicBatcher", "batch_seeds", "PRIORITIES",
]
