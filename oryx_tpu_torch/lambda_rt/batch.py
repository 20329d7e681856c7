"""Batch layer: persist data, retrain, publish models on a long interval.

A copy of the JAX package's ``oryx_tpu/lambda_rt/batch.py`` over the port's
``DataStore`` / ``ModelStore`` (host code, no JAX), held to it by
``tests/test_torch_lambda.py``. The update class is built in ``start()`` on
the compute context's device (:meth:`AbstractLayer.load_manager_instance`).

Equivalent of the reference's BatchLayer + BatchUpdateFunction +
SaveToHDFSFunction + UpdateOffsetsFn + DeleteOldDataFn
(framework/oryx-lambda/.../batch/BatchLayer.java:48-206,
BatchUpdateFunction.java:86-153, SaveToHDFSFunction.java, DeleteOldDataFn.java).

Per generation interval the layer: (1) calls the user BatchLayerUpdate with
the new-data slice and all past data (re-read from the DataStore, the
always-recomputable checkpoint), handing it a sync model producer on the
update topic; (2) persists the new slice as a timestamped segment; (3) writes
back consumed offsets; (4) TTL-GCs old data and model dirs.
"""

from __future__ import annotations

from typing import Sequence

from oryx_tpu_torch.api.batch import BatchLayerUpdate
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import spans
from oryx_tpu_torch.lambda_rt.layer import AbstractLayer
from oryx_tpu_torch.store.datastore import DataStore, ModelStore
from oryx_tpu_torch.transport.topic import TopicProducerImpl

log = spans.get_logger(__name__)

# step duration/items ride the StepTracer→registry bridge (oryx_step_* with
# tier="batch"); these add what the tracer cannot see — generations run and
# input volume handed to the user update
_GENERATIONS = metrics_mod.default_registry().counter(
    "oryx_batch_generations_total",
    "Batch generations run (empty-input generations included)",
)
_GENERATION_ITEMS = metrics_mod.default_registry().counter(
    "oryx_batch_generation_items_total",
    "Input items handed to the batch update across generations",
)


class BatchLayer(AbstractLayer):
    def __init__(self, config):
        super().__init__(config, "batch")
        storage = config.get_config("oryx.batch.storage")
        self.data_store = DataStore(storage.get_string("data-dir"))
        self.model_store = ModelStore(storage.get_string("model-dir"))
        self.max_age_data_hours = storage.get_int("max-age-data-hours", -1)
        self.max_age_model_hours = storage.get_int("max-age-model-hours", -1)
        self._update_instance: BatchLayerUpdate | None = None

    def start(self, interval_sec: float | None = None) -> None:
        # the device first: without the card this raises before any topic,
        # thread or socket exists
        self.get_context()
        self.assert_topics()
        self._update_instance = self.load_update_instance()
        log.info("starting batch layer; interval=%ss", interval_sec or self.generation_interval_sec)
        start_offset = self.input_start_offset()
        self.spawn(
            "OryxBatchLayer",
            lambda: self.run_microbatches(self._on_generation, interval_sec, start_offset),
        )

    def load_update_instance(self) -> BatchLayerUpdate:
        return self.load_manager_instance("oryx.batch.update-class", BatchLayerUpdate)

    def _on_generation(self, timestamp_ms: int, new_data: Sequence[KeyMessage]) -> None:
        _GENERATIONS.inc()
        if not new_data:
            log.info("no new data at generation %d", timestamp_ms)
        else:
            _GENERATION_ITEMS.inc(len(new_data))
            # 1. user update with past data + sync model producer
            past_data = list(self.data_store.read_all())
            context = self.get_context()
            # data identity for preemption-tolerant checkpoints: the input
            # positions this generation read through (checkpoint.fingerprint
            # folds them in, so a restarted generation — same uncommitted
            # offsets, same slice — resumes its own state and nothing else)
            context.input_offsets = self.current_input_offsets
            # freshness identity for the published model's provenance stamp
            # (lineage.make_stamp reads these off the context)
            context.input_watermark_ms = self.current_input_watermark_ms
            context.input_max_event_ms = self.current_input_max_event_ms
            producer = TopicProducerImpl(self.update_broker, self.update_topic)
            try:
                self._update_instance.run_update(
                    context,
                    timestamp_ms,
                    new_data,
                    past_data,
                    str(self.model_store.path),
                    producer,
                )
            finally:
                producer.close()
            # 2. persist the interval's data (skip empty, SaveToHDFSFunction)
            self.data_store.write_segment(timestamp_ms, list(new_data))
        # 3. offsets are stored by run_microbatches after return
        # 4. TTL GC (DeleteOldDataFn ×2, BatchLayer.java:135-146)
        self.data_store.delete_older_than(self.max_age_data_hours)
        self.model_store.delete_older_than(self.max_age_model_hours)
