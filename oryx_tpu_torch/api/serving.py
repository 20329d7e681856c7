"""Serving-tier SPI.

A copy of the JAX package's ``oryx_tpu/api/serving.py`` (host code, no
JAX). Below, "the reference" is the original Oryx it was modelled on.

Equivalent of the reference's ServingModelManager / ServingModel /
OryxServingException (framework/oryx-api/.../serving/ServingModelManager.java:48-66,
ServingModel.java, OryxServingException.java) plus the dispatch base
AbstractServingModelManager, whose ``consume`` counts each model
generation, records it in the flight recorder and feeds the lineage
tracker's adoption timeline.
"""

from __future__ import annotations

import abc
from typing import Iterator

from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import metrics as metrics_mod

_MODEL_GENERATIONS = metrics_mod.default_registry().counter(
    "oryx_serving_model_generation_total",
    "MODEL/MODEL-REF handoffs consumed by the serving model manager",
)


class ServingModel(abc.ABC):
    @abc.abstractmethod
    def get_fraction_loaded(self) -> float:
        """Readiness gate in [0,1]; requests 503 until this passes the
        configured min-model-load-fraction."""


class OryxServingException(Exception):
    """Status + message carrier mapped to HTTP error responses."""

    def __init__(self, status: int, message: str = ""):
        super().__init__(message or str(status))
        self.status = status
        self.message = message or str(status)


class OverloadedException(OryxServingException):
    """Load shed: the serving tier refused the request up front (503 with a
    Retry-After hint) because its coalescer queue is past the configured
    depth — fail fast and cheap instead of queueing into timeout."""

    def __init__(self, message: str = "overloaded; retry later",
                 retry_after_sec: float = 1.0):
        super().__init__(503, message)
        self.retry_after_sec = retry_after_sec


class ServingModelManager(abc.ABC):
    """Maintains the in-memory serving model from the update topic."""

    def __init__(self, config=None):
        self._config = config

    @abc.abstractmethod
    def consume(self, updates: Iterator[KeyMessage]) -> None:
        ...

    def get_config(self):
        return self._config

    @abc.abstractmethod
    def get_model(self) -> ServingModel | None:
        ...

    def get_staged_model(self) -> ServingModel | None:
        """The incoming model generation being double-buffered for a
        prewarmed swap, if any. Managers that swap in place return None;
        the serving batch warmer warms whatever this returns FIRST, then
        calls :meth:`promote_staged` to flip it into service."""
        return None

    def promote_staged(self, expected=None) -> bool:
        """Atomically promote the staged generation into service after its
        off-path warmup completed. ``expected`` (when given) must still BE
        the staged model — a later push may have replaced it mid-warm, and
        flipping an unwarmed replacement would defeat the prewarm. Returns
        True when a flip happened."""
        return False

    def is_read_only(self) -> bool:
        cfg = self.get_config()
        return bool(cfg and cfg.get_bool("oryx.serving.api.read-only", False))

    def close(self) -> None:
        pass


class AbstractServingModelManager(ServingModelManager):
    """Dispatches each consumed message to consume_key_message
    (AbstractServingModelManager.java:88)."""

    def consume(self, updates: Iterator[KeyMessage]) -> None:
        from oryx_tpu_torch.common import blackbox, lineage

        for km in updates:
            is_model = km.key in ("MODEL", "MODEL-REF")
            if is_model:
                # counted before dispatch so every app family (ALS, k-means,
                # RDF, examples) reports generations uniformly
                _MODEL_GENERATIONS.inc()
                # flight-recorder edge: a postmortem's first question about
                # a misbehaving replica is "when did its model last change"
                blackbox.record_event(
                    "model.generation", key=km.key,
                    message_bytes=len(km.message)
                    if isinstance(km.message, (str, bytes)) else None,
                )
                # adoption timeline opens at consume (headers carry the
                # batch tier's provenance stamp when lineage is on)
                lineage.tracker().model_consumed(km.key, km.headers)
            elif km.headers:
                # speed-tier fold-in deltas advance the freshness watermark
                lineage.tracker().delta_consumed(km.headers)
            self.consume_key_message(km.key, km.message)
            if is_model:
                # in-place managers serve the new generation as soon as the
                # dispatch returns; double-buffering managers hold it staged
                # until the warmer (or the swap deadline) promotes it
                try:
                    staged = self.get_staged_model()
                except Exception:  # noqa: BLE001 — tracker must never kill consume
                    staged = None
                if staged is None:
                    lineage.tracker().mark_live()
                else:
                    lineage.tracker().mark_staged()

    @abc.abstractmethod
    def consume_key_message(self, key: str, message: str) -> None:
        ...
