"""Serving stack: executors, cost-model routing, the model registry, the
futures-based engine, the SLO gateway in front of it and the online
adaptation loop.

    executors.py  Host/Device executors over the tiered store, the
                  Sharded executor over the sharded store
    router.py     LatencyCurve calibration, CostModelRouter (N-way), the
                  binary HybridScheduler and StaticScheduler
    registry.py   ModelRegistry/ModelEntry: N models sharing the store,
                  each with its own executors and calibrated router
    engine.py     ServingEngine: admission, per-batch futures, per-model and
                  per-class metrics, telemetry hooks
    gateway.py    ServingGateway: priority classes, deadline-slack ordering
                  with aging, shed-before-dispatch, streaming telemetry
    adaptive.py   FrequencySketch and AdaptiveController: live FAP
                  re-placement, router refit, micro-batch, cold-path and
                  admission tuning
"""
from repro_torch.serving.executors import (BaseExecutor, DeviceExecutor,
                                           Executor, HostExecutor,
                                           ShardedExecutor, pad_to_bucket)
from repro_torch.serving.router import (POLICIES, CalibrationResult,
                                        CostModelRouter, HybridScheduler,
                                        LatencyCurve, StaticScheduler,
                                        calibrate, calibrate_executors)
from repro_torch.serving.registry import (DEFAULT_MODEL, ModelEntry,
                                          ModelRegistry, build_model_entry)
from repro_torch.serving.engine import (CLASS_SAMPLE_SCHEMA, ClassStats,
                                        MicroBatcher, ModelStats,
                                        ServeMetrics, ServingEngine)
from repro_torch.serving.gateway import (GATEWAY_SCHEMA,
                                         TELEMETRY_SAMPLE_SCHEMA,
                                         GatewayConfig, ServingGateway)
from repro_torch.serving.adaptive import (AdaptiveConfig, AdaptiveController,
                                          FrequencySketch, curve_drift)

__all__ = [
    "Executor", "BaseExecutor", "HostExecutor", "DeviceExecutor",
    "ShardedExecutor", "pad_to_bucket", "POLICIES", "LatencyCurve", "CalibrationResult",
    "calibrate", "calibrate_executors", "CostModelRouter",
    "HybridScheduler", "StaticScheduler", "DEFAULT_MODEL", "ModelEntry",
    "ModelRegistry", "build_model_entry", "ServingEngine", "ServeMetrics",
    "ModelStats", "ClassStats", "CLASS_SAMPLE_SCHEMA", "MicroBatcher",
    "ServingGateway", "GatewayConfig", "GATEWAY_SCHEMA",
    "TELEMETRY_SAMPLE_SCHEMA", "AdaptiveConfig", "AdaptiveController",
    "FrequencySketch", "curve_drift",
]
