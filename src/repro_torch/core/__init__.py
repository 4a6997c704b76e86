"""Workload metrics (PSGS/FAP) and their Monte Carlo oracles, placement
(Quiver's and the Fig. 15 baselines) and online re-placement, the
tiered feature store with its device cache and prefetcher, the sharded
store over a device mesh, and request batching/workload generation."""
from repro_torch.core.fap import compute_fap, monte_carlo_fap
from repro_torch.core.feature_store import (SHARDED_STATS_SCHEMA,
                                            STATS_SCHEMA, DiskSpillTier,
                                            ShardedFeatureStore,
                                            TieredFeatureStore)
from repro_torch.core.gpu_cache import GPUFeatureCache
from repro_torch.core.placement import (PlacementPlan, TopologySpec,
                                        degree_placement, expert_placement,
                                        freq_placement, hash_placement,
                                        migration_pairs, p3_placement,
                                        quiver_placement)
from repro_torch.core.prefetch import Prefetcher
from repro_torch.core.psgs import batch_psgs, compute_psgs, monte_carlo_psgs
from repro_torch.core.serving import (PRIORITIES, DynamicBatcher, Request,
                                      WorkloadGenerator, batch_seeds)

__all__ = [
    "compute_psgs", "monte_carlo_psgs", "batch_psgs", "compute_fap",
    "monte_carlo_fap", "TopologySpec", "PlacementPlan", "quiver_placement",
    "hash_placement", "degree_placement", "freq_placement", "p3_placement",
    "migration_pairs", "expert_placement",
    "TieredFeatureStore", "ShardedFeatureStore", "DiskSpillTier",
    "STATS_SCHEMA", "SHARDED_STATS_SCHEMA",
    "GPUFeatureCache", "Prefetcher", "Request", "WorkloadGenerator",
    "DynamicBatcher", "batch_seeds", "PRIORITIES",
]
