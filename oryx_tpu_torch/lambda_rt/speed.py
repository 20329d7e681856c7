"""Speed layer: incremental model updates on a short interval.

A copy of the JAX package's ``oryx_tpu/lambda_rt/speed.py`` (host code, no
JAX), held to it by ``tests/test_torch_lambda.py``. The model manager is
built in ``start()`` on the compute context's device where its constructor
takes one (:meth:`AbstractLayer.load_manager_instance`).

Equivalent of the reference's SpeedLayer + SpeedLayerUpdate
(framework/oryx-lambda/.../speed/SpeedLayer.java:52-194,
SpeedLayerUpdate.java:51-63). Two concurrent activities:

  * an update-consumer thread replaying the update topic from ``earliest``
    into the SpeedModelManager (MODEL/MODEL-REF refresh + its own and the
    batch layer's "UP" messages — the speed layer hears its own updates,
    ALSSpeedModelManager.java:74-81);
  * a microbatch pump that calls build_updates on each input slice and
    publishes each update with key "UP" (async producer semantics).
"""

from __future__ import annotations

import json
from typing import Sequence

from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.api.speed import SpeedModelManager
from oryx_tpu_torch.common import lineage
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import spans
from oryx_tpu_torch.lambda_rt.layer import AbstractLayer
from oryx_tpu_torch.transport.topic import ConsumeDataIterator, TopicProducerImpl, get_broker

log = spans.get_logger(__name__)

# microbatch duration/items ride the StepTracer→registry bridge (oryx_step_*
# with tier="speed"); this counts the layer's OUTPUT — "UP" updates published
_UPDATES_PUBLISHED = metrics_mod.default_registry().counter(
    "oryx_speed_updates_published_total",
    "Incremental model updates published by the speed layer",
)


class SpeedLayer(AbstractLayer):
    def __init__(self, config):
        super().__init__(config, "speed")
        self.model_manager: SpeedModelManager | None = None
        self._update_iterator: ConsumeDataIterator | None = None
        self._producer: TopicProducerImpl | None = None

    def start(self, interval_sec: float | None = None) -> None:
        # the device first: without the card this raises before any topic,
        # thread or socket exists
        self.get_context()
        self.assert_topics()
        self.model_manager = self.load_manager_instance(
            "oryx.speed.model-manager-class", SpeedModelManager
        )
        self._update_iterator = ConsumeDataIterator(
            get_broker(self.update_broker), self.update_topic, "earliest"
        )
        self._producer = TopicProducerImpl(self.update_broker, self.update_topic)
        log.info("starting speed layer; interval=%ss", interval_sec or self.generation_interval_sec)
        # update-consumer thread (SpeedLayer.java:116-123); messages bearing
        # a traceparent header (e.g. a batch-tier publish traced back to an
        # ingress request) are processed under a span continuing that trace
        traced_updates = spans.trace_consumed(
            self._update_iterator, "speed.consume_update",
            route="update-topic", attributes={"topic": self.update_topic},
        )
        self.spawn(
            "OryxSpeedLayerUpdateConsumerThread",
            lambda: self.model_manager.consume(traced_updates),
        )
        # per-microbatch updates (SpeedLayerUpdate)
        start_offset = self.input_start_offset()
        self.spawn(
            "OryxSpeedLayer",
            lambda: self.run_microbatches(self._on_microbatch, interval_sec, start_offset),
        )

    def _on_microbatch(self, timestamp_ms: int, new_data: Sequence[KeyMessage]) -> None:
        if not new_data:
            return
        updates = self.model_manager.build_updates(new_data)
        # fold-in provenance: each delta carries the input offsets/watermark
        # it incorporated, so the serving-side freshness watermark advances
        # BETWEEN batch generations (lineage.delta_consumed reads this)
        headers = None
        if self.config.get_bool("oryx.lineage.enabled", True):
            headers = {lineage.WATERMARK_HEADER: json.dumps({
                "offsets": {str(p): int(o) for p, o in
                            (self.current_input_offsets or {}).items()},
                "watermark_ms": self.current_input_watermark_ms,
            }, separators=(",", ":"))}
        for update in updates:
            self._producer.send("UP", update, headers=headers)
            _UPDATES_PUBLISHED.inc()

    def close(self) -> None:
        if self._update_iterator is not None:
            self._update_iterator.close()
        if self.model_manager is not None:
            self.model_manager.close()
        super().close()
