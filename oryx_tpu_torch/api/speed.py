"""Speed-tier SPI.

A copy of the JAX package's
``oryx_tpu/api/speed.py`` (host code, no JAX), held equal to it by
``tests/test_torch_kmeans.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's SpeedModelManager / SpeedModel
(framework/oryx-api/.../speed/SpeedModelManager.java:50-98, SpeedModel.java)
plus the key/message-dispatch convenience base AbstractSpeedModelManager.
"""

from __future__ import annotations

import abc
from typing import Iterable, Iterator, Sequence

from oryx_tpu_torch.api.keymessage import KeyMessage


class SpeedModel(abc.ABC):
    @abc.abstractmethod
    def get_fraction_loaded(self) -> float:
        """Readiness gate in [0,1] (SpeedModel.java)."""


class SpeedModelManager(abc.ABC):
    """Consumes the update topic to maintain an in-memory reference model, and
    turns each input microbatch into incremental model updates."""

    @abc.abstractmethod
    def consume(self, updates: Iterator[KeyMessage]) -> None:
        """Blocking loop over update-topic messages (MODEL/MODEL-REF/UP)."""

    @abc.abstractmethod
    def build_updates(self, new_data: Sequence[KeyMessage]) -> Iterable[str]:
        """Incremental updates for one microbatch, published with key "UP"."""

    def close(self) -> None:
        pass


class AbstractSpeedModelManager(SpeedModelManager):
    """Dispatches each consumed message to consume_key_message
    (AbstractSpeedModelManager.java:48-67)."""

    def consume(self, updates: Iterator[KeyMessage]) -> None:
        for km in updates:
            self.consume_key_message(km.key, km.message)

    @abc.abstractmethod
    def consume_key_message(self, key: str, message: str) -> None:
        ...
