"""k-means speed tier: centroid drift from the microbatch stream.

A copy of the JAX package's
``oryx_tpu/models/kmeans/speed.py``
(host code, no JAX), held equal to it by ``tests/test_torch_kmeans.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's KMeansSpeedModel / KMeansSpeedModelManager
(app/oryx-app/.../kmeans/KMeansSpeedModel.java,
KMeansSpeedModelManager.java:50-121): ``MODEL``/``MODEL-REF`` replaces the
cluster list (validated against the schema); its own ``UP`` messages are
ignored; ``build_updates`` assigns every microbatch point to its nearest
cluster in one vectorized pass, reduces per-cluster (sum, count), folds the
per-cluster mean into the local running centroid, and emits
``[clusterID, center, count]`` JSON updates.
"""

from __future__ import annotations

import logging

import numpy as np

from oryx_tpu_torch.api.speed import AbstractSpeedModelManager, SpeedModel
from oryx_tpu_torch.common import textutils
from oryx_tpu_torch.ml.mlupdate import read_pmml_from_update_key_message
from oryx_tpu_torch.models import pmml_common
from oryx_tpu_torch.models.kmeans import pmml_codec
from oryx_tpu_torch.models.kmeans.model import ClusterInfo, assign
from oryx_tpu_torch.models.schema import InputSchema

log = logging.getLogger(__name__)


class KMeansSpeedModel(SpeedModel):
    """Cluster list by ID (KMeansSpeedModel.java)."""

    def __init__(self, clusters):
        self._clusters: dict[int, ClusterInfo] = {c.id: c for c in clusters}

    def get_cluster(self, cluster_id: int) -> ClusterInfo:
        return self._clusters[cluster_id]

    def set_cluster(self, cluster_id: int, cluster: ClusterInfo) -> None:
        self._clusters[cluster_id] = cluster

    @property
    def clusters(self) -> list[ClusterInfo]:
        return list(self._clusters.values())

    def get_fraction_loaded(self) -> float:
        return 1.0


class KMeansSpeedModelManager(AbstractSpeedModelManager):
    def __init__(self, config):
        self.config = config
        self.input_schema = InputSchema(config)
        self.model: KMeansSpeedModel | None = None

    # -- update-topic consumption (consumeKeyMessage:55-75) ------------------
    def consume_key_message(self, key: str, message: str) -> None:
        if key == "UP":
            return  # hearing our own updates
        if key in ("MODEL", "MODEL-REF"):
            pmml = read_pmml_from_update_key_message(key, message)
            pmml_codec.validate_pmml_vs_schema(pmml, self.input_schema)
            self.model = KMeansSpeedModel(pmml_codec.read(pmml))
            log.info("new model loaded (%d clusters)", len(self.model.clusters))
        else:
            raise ValueError(f"bad key: {key}")

    # -- microbatch centroid updates (buildUpdates:77-119) -------------------
    def build_updates(self, new_data):
        model = self.model
        if model is None:
            return []
        vectors = []
        for km in new_data:
            tokens = textutils.parse_possibly_json(km.message)
            try:
                vectors.append(
                    pmml_common.features_from_tokens(tokens, self.input_schema)
                )
            except (ValueError, IndexError):
                log.warning("Bad input: %s", km.message)
        if not vectors:
            return []
        points = np.stack(vectors)
        clusters = model.clusters
        centers = np.stack([c.center for c in clusters])
        idx, _ = assign(points, centers)
        updates = []
        for pos in np.unique(idx):
            members = points[idx == pos]
            cluster = clusters[int(pos)]
            cluster.update(members.mean(axis=0), len(members))
            model.set_cluster(cluster.id, cluster)
            updates.append(
                textutils.join_json(
                    [cluster.id, [float(v) for v in cluster.center], cluster.count]
                )
            )
        return updates
