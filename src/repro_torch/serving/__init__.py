"""Serving stack: executors, cost-model routing, the model registry and the
futures-based engine (single host)."""
from repro_torch.serving.executors import (BaseExecutor, DeviceExecutor,
                                           Executor, HostExecutor,
                                           pad_to_bucket)
from repro_torch.serving.router import (POLICIES, CostModelRouter,
                                        LatencyCurve, StaticScheduler,
                                        calibrate_executors)
from repro_torch.serving.registry import (DEFAULT_MODEL, ModelEntry,
                                          ModelRegistry)
from repro_torch.serving.engine import (ClassStats, MicroBatcher, ModelStats,
                                        ServeMetrics, ServingEngine)

__all__ = [
    "Executor", "BaseExecutor", "HostExecutor", "DeviceExecutor",
    "pad_to_bucket", "POLICIES", "LatencyCurve", "calibrate_executors",
    "CostModelRouter", "StaticScheduler", "DEFAULT_MODEL", "ModelEntry",
    "ModelRegistry", "ServingEngine", "ServeMetrics", "ModelStats",
    "ClassStats", "MicroBatcher",
]
