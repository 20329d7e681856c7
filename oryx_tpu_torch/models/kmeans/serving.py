"""k-means serving tier: in-memory cluster model behind the REST endpoints.

A copy of the JAX package's
``oryx_tpu/models/kmeans/serving.py``
(host code, no JAX), held equal to it by ``tests/test_torch_kmeans.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's KMeansServingModel / KMeansServingModelManager
(app/oryx-app-serving/.../kmeans/model/KMeansServingModel.java:34-87,
KMeansServingModelManager.java:40-89): the model is the cluster list guarded
by a lock; ``UP [id, center, count]`` replaces one cluster's center/count;
``MODEL``/``MODEL-REF`` swaps in a new validated cluster list. Assignment
queries run vectorized against the stacked centroid matrix.
"""

from __future__ import annotations

import logging
import threading

import numpy as np

from oryx_tpu_torch.api.serving import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.common import textutils
from oryx_tpu_torch.ml.mlupdate import read_pmml_from_update_key_message
from oryx_tpu_torch.models.kmeans import pmml_codec
from oryx_tpu_torch.models.kmeans.model import ClusterInfo, assign
from oryx_tpu_torch.models.schema import InputSchema

log = logging.getLogger(__name__)


class KMeansServingModel(ServingModel):
    def __init__(self, clusters, input_schema: InputSchema):
        self._lock = threading.RLock()
        self._clusters: list[ClusterInfo] = list(clusters)
        self.input_schema = input_schema

    def nearest_cluster(self, vector: np.ndarray) -> tuple[int, float]:
        """(cluster ID, distance) of the closest cluster
        (KMeansServingModel.nearestClusterID:50)."""
        with self._lock:
            centers = np.stack([c.center for c in self._clusters])
            ids = [c.id for c in self._clusters]
        idx, dist = assign(np.atleast_2d(vector), centers)
        return ids[int(idx[0])], float(dist[0])

    def update(self, cluster_id: int, center: np.ndarray, count: int) -> None:
        """Replace one cluster's center and count (update:74)."""
        with self._lock:
            for i, c in enumerate(self._clusters):
                if c.id == cluster_id:
                    self._clusters[i] = ClusterInfo(cluster_id, center, count)
                    return
        log.warning("no cluster with ID %s to update", cluster_id)

    @property
    def clusters(self) -> list[ClusterInfo]:
        with self._lock:
            return list(self._clusters)

    def get_fraction_loaded(self) -> float:
        return 1.0


class KMeansServingModelManager(AbstractServingModelManager):
    def __init__(self, config):
        super().__init__(config)
        self.input_schema = InputSchema(config)
        self.model: KMeansServingModel | None = None

    # -- update-topic consumption (consumeKeyMessage:51-83) ------------------
    def consume_key_message(self, key: str, message: str) -> None:
        if key == "UP":
            if self.model is None:
                return  # no model to interpret with yet
            update = textutils.read_json(message)
            self.model.update(
                int(update[0]),
                np.asarray(update[1], dtype=np.float64),
                int(update[2]),
            )
        elif key in ("MODEL", "MODEL-REF"):
            pmml = read_pmml_from_update_key_message(key, message)
            pmml_codec.validate_pmml_vs_schema(pmml, self.input_schema)
            self.model = KMeansServingModel(pmml_codec.read(pmml), self.input_schema)
            log.info("new model loaded (%d clusters)", len(self.model.clusters))
        else:
            raise ValueError(f"bad key: {key}")

    def get_model(self):
        return self.model
