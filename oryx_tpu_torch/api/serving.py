"""Serving-tier SPI, the part the port's model managers need.

A copy of the JAX package's ``oryx_tpu/api/serving.py`` without its
flight-recorder, lineage and metrics hooks (they come with the port's
tooling): ``ServingModel``, the manager base, and the dispatch base whose
``consume`` hands each update-topic message to ``consume_key_message``
(ServingModelManager.java:48-66, AbstractServingModelManager.java:88 in the
original Oryx).
"""

from __future__ import annotations

import abc
from typing import Iterator

from oryx_tpu_torch.api.keymessage import KeyMessage


class ServingModel(abc.ABC):
    @abc.abstractmethod
    def get_fraction_loaded(self) -> float:
        """Readiness gate in [0,1]; requests 503 until this passes the
        configured min-model-load-fraction."""


class ServingModelManager(abc.ABC):
    """Maintains the in-memory serving model from the update topic."""

    def __init__(self, config=None):
        self._config = config

    @abc.abstractmethod
    def consume(self, updates: Iterator[KeyMessage]) -> None:
        ...

    @abc.abstractmethod
    def get_model(self) -> ServingModel | None:
        ...


class AbstractServingModelManager(ServingModelManager):
    """Dispatches each consumed message to consume_key_message."""

    def consume(self, updates: Iterator[KeyMessage]) -> None:
        for km in updates:
            self.consume_key_message(km.key, km.message)

    @abc.abstractmethod
    def consume_key_message(self, key: str, message: str) -> None:
        ...
