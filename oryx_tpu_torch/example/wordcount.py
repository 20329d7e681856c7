"""Tutorial word-count app: the three-tier example in miniature.

A copy of the JAX package's ``oryx_tpu/example/wordcount.py`` on the port's
``api`` (host code: it takes no device), held equal to it by
``tests/test_torch_example.py``. Equivalent of the reference's example app (app/example/.../batch/
ExampleBatchLayerUpdate.java:39-66, speed/ExampleSpeedModelManager.java:37-74,
serving/ExampleServingModelManager.java:35-67, serving/ExampleServingModel):
the batch tier counts, for each word, the number of distinct other words
co-occurring on some input line and publishes the whole map as a JSON
``MODEL``; the speed tier applies the same count to each microbatch and emits
approximate ``word,count`` ``UP`` messages; the serving tier merges both into
the queryable map.
"""

from __future__ import annotations

import json
import logging
import threading
from collections import defaultdict

from oryx_tpu_torch.api.batch import BatchLayerUpdate
from oryx_tpu_torch.api.serving import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.api.speed import AbstractSpeedModelManager, SpeedModel

log = logging.getLogger(__name__)


def count_distinct_other_words(lines) -> dict[str, int]:
    """For each word, the number of distinct other words that co-occur on
    some line (ExampleBatchLayerUpdate.countDistinctOtherWords:58-66)."""
    cooccur: dict[str, set] = defaultdict(set)
    for line in lines:
        tokens = set(line.split(" "))
        for a in tokens:
            cooccur[a].update(t for t in tokens if t != a)
    return {w: len(others) for w, others in cooccur.items()}


class ExampleBatchLayerUpdate(BatchLayerUpdate):
    """Counts over new ∪ past data, publishes the map as a JSON MODEL."""

    def __init__(self, config=None):
        pass

    def run_update(self, context, timestamp_ms, new_data, past_data, model_dir, producer):
        lines = [km.message for km in new_data] + [km.message for km in past_data]
        producer.send("MODEL", json.dumps(count_distinct_other_words(lines)))


class ExampleSpeedModel(SpeedModel):
    def __init__(self, words: dict):
        self.words = words

    def get_fraction_loaded(self) -> float:
        return 1.0


class ExampleSpeedModelManager(AbstractSpeedModelManager):
    """Approximate incremental counts; emits ``word,count`` updates
    (ExampleSpeedModelManager.java:37-74)."""

    def __init__(self, config=None):
        self._lock = threading.Lock()
        self._words: dict[str, int] = {}

    def consume_key_message(self, key: str, message: str) -> None:
        if key == "MODEL":
            model = json.loads(message)
            with self._lock:
                self._words.clear()
                self._words.update(model)
        elif key == "UP":
            pass  # hearing our own updates
        else:
            raise ValueError(f"Bad key {key}")

    def build_updates(self, new_data):
        counts = count_distinct_other_words([km.message for km in new_data])
        updates = []
        with self._lock:
            for word, count in counts.items():
                new_count = self._words.get(word, 0) + count if word in self._words else count
                self._words[word] = new_count
                updates.append(f"{word},{new_count}")
        return updates


class ExampleServingModel(ServingModel):
    def __init__(self, words: dict):
        self._words = words

    def get_words(self) -> dict[str, int]:
        return self._words

    def get_fraction_loaded(self) -> float:
        return 1.0


class ExampleServingModelManager(AbstractServingModelManager):
    """Merges MODEL maps and ``word,count`` UPs
    (ExampleServingModelManager.java:35-67)."""

    def __init__(self, config):
        super().__init__(config)
        self._lock = threading.Lock()
        self._words: dict[str, int] = {}
        self._loaded = False

    def consume_key_message(self, key: str, message: str) -> None:
        if key == "MODEL":
            model = json.loads(message)
            with self._lock:
                self._words.clear()
                self._words.update(model)
                self._loaded = True
        elif key == "UP":
            # words may themselves contain commas; count is the last field
            word, count = message.rsplit(",", 1)
            with self._lock:
                self._words[word] = int(count)
                self._loaded = True
        else:
            raise ValueError(f"Bad key {key}")

    def get_model(self):
        with self._lock:
            if not self._loaded:
                return None
            return ExampleServingModel(dict(self._words))
