"""Serving registry: one engine, N models over shared state (numpy port of
the reference's ``serving/registry.py``). The single-model engine API is
the 1-entry special case (:meth:`ModelRegistry.single`);
:func:`build_model_entry` builds and calibrates one model's host + device
executors over the shared store (the launcher's ``--models`` path).

Shared across models: the graph, the ``TieredFeatureStore`` (one copy of
every feature row), the admission window and the ``FrequencySketch``.
Per model: ``infer_fn``, executors, calibrated ``LatencyCurve``s, the
``CostModelRouter`` and the metrics breakdown.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Iterable, Iterator, Mapping, Optional,
                    Sequence)

import numpy as np

from repro_torch.serving.executors import DeviceExecutor, Executor, HostExecutor
from repro_torch.serving.router import CostModelRouter, calibrate_executors

#: Model tag used when the caller never mentions models (single-model API).
DEFAULT_MODEL = "default"


@dataclasses.dataclass
class ModelEntry:
    """One served model inside a :class:`ModelRegistry`.

    The entry owns only what is model-specific — executors wrapping the
    model's ``infer_fn`` and the router holding its calibrated curves; the
    feature stores and graph those executors read are shared across entries.

    Attributes:
        name: model tag carried by requests (``Request.model``).
        executors: executor-name → :class:`Executor` registry for this model.
        router: anything with ``route(seeds) -> executor name`` over this
            model's executor names (usually a ``CostModelRouter`` fit from
            this model's calibration).
        infer_fn: the model's inference callable, kept for rebuilds and
            introspection (executors already close over it).
    """

    name: str
    executors: dict[str, Executor]
    router: Any
    infer_fn: Optional[Callable] = None


class ModelRegistry:
    """Name → :class:`ModelEntry` registry the serving engine serves from.

    Insertion order is preserved (it decides warmup/close order and the
    order of per-model report sections). The single-model engine API is the
    1-entry special case built by :meth:`single`.
    """

    def __init__(self, entries: Iterable[ModelEntry] = ()):
        """Args:
            entries: optional initial :class:`ModelEntry` objects; later
                entries with a repeated name replace earlier ones.
        """
        self._entries: dict[str, ModelEntry] = {}
        for e in entries:
            self.add(e)

    # -- registration --------------------------------------------------------
    def add(self, entry: ModelEntry) -> "ModelRegistry":
        """Add (or replace) a model entry under ``entry.name``; returns the
        registry for chaining."""
        if not entry.executors:
            raise ValueError(
                f"model {entry.name!r} needs at least one executor")
        self._entries[entry.name] = entry
        return self

    def register(self, name: str,
                 executors: Mapping[str, Executor] | Iterable[Executor],
                 router, *, infer_fn: Optional[Callable] = None
                 ) -> "ModelRegistry":
        """Register a model from its parts (see :class:`ModelEntry`).

        Args:
            name: model tag requests will carry.
            executors: executor-name → executor mapping, or an iterable of
                executors keyed by their ``name`` attribute.
            router: ``route(seeds) -> executor name`` over those executors.
            infer_fn: optional inference callable, kept for introspection.

        Returns:
            The registry, for chaining.
        """
        if not isinstance(executors, Mapping):
            executors = {e.name: e for e in executors}
        return self.add(ModelEntry(name=name, executors=dict(executors),
                                   router=router, infer_fn=infer_fn))

    @staticmethod
    def single(executors: Mapping[str, Executor] | Iterable[Executor],
               router) -> "ModelRegistry":
        """The single-model special case: one entry under
        :data:`DEFAULT_MODEL` — what ``ServingEngine(executors, router)``
        builds under the hood."""
        return ModelRegistry().register(DEFAULT_MODEL, executors, router)

    # -- lookup --------------------------------------------------------------
    def get(self, name: str) -> ModelEntry:
        """Entry for model ``name``.

        Raises:
            KeyError: naming the registered models, so a typo'd request tag
                is diagnosable from the exception alone.
        """
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(f"unknown model {name!r}; registered: "
                           f"{list(self._entries)}") from None

    def router_for(self, name: str = DEFAULT_MODEL):
        """The router serving ``name`` — the gateway's slack-estimation
        handle (``router.estimate_seconds`` when the router offers it)."""
        return self.get(name).router

    @property
    def names(self) -> list[str]:
        """Registered model names, in registration order."""
        return list(self._entries)

    def entries(self) -> list[ModelEntry]:
        """Registered entries, in registration order."""
        return list(self._entries.values())

    def routers(self) -> dict[str, Any]:
        """Model name → router mapping (what the adaptive controller refits
        per model)."""
        return {n: e.router for n, e in self._entries.items()}

    def all_executors(self) -> Iterator[tuple[str, str, Executor]]:
        """Yield ``(model, executor_name, executor)`` over every entry."""
        for model, entry in self._entries.items():
            for name, ex in entry.executors.items():
                yield model, name, ex

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name: object) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __repr__(self) -> str:
        return f"ModelRegistry({self.names})"


def build_model_entry(name: str, *, graph, store, fanouts: Sequence[int],
                      infer_fn: Callable, psgs_table: np.ndarray,
                      policy: str = "latency_preferred", capacity: int = 2,
                      max_batch: int = 128, fused: bool = True,
                      rng_seed: int = 0,
                      calibration_batches: Optional[Sequence[np.ndarray]] = None,
                      calibration_repeats: int = 2,
                      load_aware: bool = False) -> ModelEntry:
    """Build one model's host+device executor pair against a *shared* store,
    calibrate it, and wrap the result in a :class:`ModelEntry`.

    This is the recipe ``launch/serve.py --models`` uses; callers with
    extra executors or pre-fit curves assemble the entry by hand instead.
    The executors run on the store's device.

    Args:
        name: model tag (``ModelEntry.name``).
        graph: CSR topology shared by every model.
        store: shared ``TieredFeatureStore`` the executors read.
        fanouts: per-layer sampling fanouts for this model.
        infer_fn: this model's inference callable
            (``infer_fn(hop_feats, hop_ids) -> (B, d_out)``).
        psgs_table: ``(N,)`` per-seed PSGS table (routing x-coordinate).
        policy: routing policy for the model's ``CostModelRouter``.
        capacity: worker lanes per executor.
        max_batch: device executor static shape (chunking bound).
        fused: fused feature-collection path flag for both executors.
        rng_seed: sampling RNG seed for the executors.
        calibration_batches: probe batches for ``calibrate_executors``;
            defaults to 6 PSGS-spread slices of the node set.
        calibration_repeats: steady-state repeats per probe batch.
        load_aware: forwarded to the model's router.

    Returns:
        A fully calibrated :class:`ModelEntry` ready for
        ``ModelRegistry.add``.
    """
    executors: dict[str, Executor] = {
        "host": HostExecutor(graph, store, fanouts, infer_fn,
                             capacity=capacity, psgs_table=psgs_table,
                             rng_seed=rng_seed, fused=fused),
        "device": DeviceExecutor(graph.device_arrays(store.device), store,
                                 fanouts, infer_fn, max_batch=max_batch,
                                 capacity=capacity, psgs_table=psgs_table,
                                 rng_seed=rng_seed, fused=fused),
    }
    if calibration_batches is None:
        order = np.argsort(psgs_table)
        n = order.size
        calibration_batches = [
            order[int(q * n):][:max(min(max_batch, 32), 4)].astype(np.int64)
            for q in np.linspace(0.05, 0.95, 6)]
    curves = calibrate_executors(executors, calibration_batches, psgs_table,
                                 repeats=calibration_repeats)
    router = CostModelRouter.from_curves(psgs_table, curves, policy,
                                         executors=executors,
                                         load_aware=load_aware)
    return ModelEntry(name=name, executors=executors, router=router,
                      infer_fn=infer_fn)
