"""k-means PMML ClusteringModel codec.

A copy of the JAX package's
``oryx_tpu/models/kmeans/pmml_codec.py``
(host code, no JAX), held equal to it by ``tests/test_torch_kmeans.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's KMeansPMMLUtils + KMeansUpdate.pmmlClusteringModel
(app/oryx-app-common/.../kmeans/KMeansPMMLUtils.java:47-82,
app/oryx-app-mllib/.../kmeans/KMeansUpdate.java:184-221): a PMML 4.3
ClusteringModel (center-based, squaredEuclidean ComparisonMeasure), one
ClusteringField per active feature, one Cluster per centroid with id, size,
and a REAL Array center. Round-trips models written by the reference.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from oryx_tpu_torch.models import pmml_common
from oryx_tpu_torch.models.kmeans.model import ClusterInfo, check_unique_ids
from oryx_tpu_torch.models.schema import InputSchema
from oryx_tpu_torch.pmml import pmmlutils


def clustering_model_to_pmml(
    clusters: Sequence[ClusterInfo], schema: InputSchema
):
    """Build the full PMML document (kMeansModelToPMML:184-221)."""
    pmml = pmmlutils.build_skeleton_pmml()
    pmml_common.build_data_dictionary(pmml, schema)
    model = pmmlutils.subelement(
        pmml,
        "ClusteringModel",
        {
            "functionName": "clustering",
            "modelClass": "centerBased",
            "numberOfClusters": len(clusters),
        },
    )
    pmml_common.build_mining_schema(model, schema)
    cm = pmmlutils.subelement(
        model, "ComparisonMeasure", {"kind": "distance"}
    )
    pmmlutils.subelement(cm, "squaredEuclidean")
    for i in range(schema.num_features):
        if schema.is_active(i):
            pmmlutils.subelement(
                model,
                "ClusteringField",
                {"field": schema.feature_names[i], "isCenterField": "true"},
            )
    for c in clusters:
        cl = pmmlutils.subelement(
            model, "Cluster", {"id": str(c.id), "size": int(c.count)}
        )
        pmml_common.to_pmml_array(cl, c.center)
    return pmml


def read(pmml) -> list[ClusterInfo]:
    """PMML → clusters (KMeansPMMLUtils.read:71-82)."""
    model = pmmlutils.find(pmml, "ClusteringModel")
    if model is None:
        raise ValueError("PMML does not contain a ClusteringModel")
    clusters = []
    for cl in pmmlutils.find_all(model, "Cluster"):
        arr = pmmlutils.find(cl, "Array")
        center = pmml_common.parse_array(arr) if arr is not None else np.zeros(0)
        clusters.append(
            ClusterInfo(int(cl.get("id")), center, int(cl.get("size", "0")))
        )
    check_unique_ids(clusters)
    return clusters


def validate_pmml_vs_schema(pmml, schema: InputSchema) -> None:
    """(KMeansPMMLUtils.validatePMMLVsSchema:47-65)"""
    model = pmmlutils.find(pmml, "ClusteringModel")
    if model is None:
        raise ValueError("PMML does not contain a ClusteringModel")
    if model.get("functionName") != "clustering":
        raise ValueError("model function must be clustering")
    pmml_common.validate_feature_names(pmml, schema, "k-means")
