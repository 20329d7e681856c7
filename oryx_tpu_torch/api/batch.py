"""Batch-tier SPI.

A copy of the JAX package's ``oryx_tpu/api/batch.py`` (host code, no JAX).
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's BatchLayerUpdate
(framework/oryx-api/.../batch/BatchLayerUpdate.java:38-59): new/past data
arrive as lists of KeyMessage (host side; implementations move them onto the
card), the Spark context becomes a ComputeContext.
"""

from __future__ import annotations

import abc
from typing import Sequence

from oryx_tpu_torch.api.keymessage import KeyMessage


class BatchLayerUpdate(abc.ABC):
    """Implementations define one batch generation: read new+past data, build
    and publish a model."""

    @abc.abstractmethod
    def run_update(
        self,
        context,  # ComputeContext
        timestamp_ms: int,
        new_data: Sequence[KeyMessage],
        past_data: Sequence[KeyMessage],
        model_dir: str,
        model_update_topic,  # a producer with send(key, message), or None
    ) -> None:
        ...
