"""k-means batch update: build and score a clustering model.

The port of the JAX package's ``oryx_tpu/models/kmeans/update.py``
(KMeansUpdate.java:60-234 in the original Oryx), the :class:`MLUpdate`
implementation for clustering (``run_update`` picks, promotes and publishes
the candidates):

  * hyperparameter k from ``oryx.kmeans.hyperparams.k``;
  * datum lines parsed through :class:`InputSchema` into dense numeric
    vectors (host numpy);
  * :meth:`KMeansUpdate.build_model` trains on the card
    (:func:`~oryx_tpu_torch.models.kmeans.train.kmeans_train`) and returns a
    PMML ClusteringModel with each cluster's size from the training
    assignment;
  * :meth:`KMeansUpdate.evaluate` scores a model over train ∪ test with the
    strategy of ``oryx.kmeans.evaluation-strategy`` (host float64);
    Davies-Bouldin and SSE, lower-better, are negated.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from oryx_tpu_torch.common import rand, textutils
from oryx_tpu_torch.ml import param as hp
from oryx_tpu_torch.ml.mlupdate import MLUpdate
from oryx_tpu_torch.models import pmml_common
from oryx_tpu_torch.models.kmeans import evaluate as kmeval
from oryx_tpu_torch.models.kmeans import pmml_codec
from oryx_tpu_torch.models.kmeans import train as kmtrain
from oryx_tpu_torch.models.kmeans.model import ClusterInfo
from oryx_tpu_torch.models.schema import InputSchema

log = logging.getLogger(__name__)

EVAL_STRATEGIES = ("SILHOUETTE", "DAVIES_BOULDIN", "DUNN", "SSE")


class KMeansUpdate(MLUpdate):
    """Trains on ``device`` (``None``: the CUDA card)."""

    def __init__(self, config, device=None):
        super().__init__(config, device=device)
        self.initialization_strategy = config.get_string(
            "oryx.kmeans.initialization-strategy"
        )
        self.evaluation_strategy = config.get_string("oryx.kmeans.evaluation-strategy")
        self.runs = config.get_int("oryx.kmeans.runs")
        self.iterations = config.get_int("oryx.kmeans.iterations")
        self.hyper_params = [hp.from_config(config, "oryx.kmeans.hyperparams.k")]
        self.input_schema = InputSchema(config)
        if self.iterations <= 0 or self.runs <= 0:
            raise ValueError("iterations and runs must be positive")
        if self.initialization_strategy not in (
            kmtrain.INIT_RANDOM,
            kmtrain.INIT_KMEANS_PARALLEL,
        ):
            raise ValueError(f"bad init strategy: {self.initialization_strategy}")
        if self.evaluation_strategy not in EVAL_STRATEGIES:
            raise ValueError(f"bad eval strategy: {self.evaluation_strategy}")
        # unsupervised, numeric-only (KMeansUpdate.java:83-87)
        if self.input_schema.has_target():
            raise ValueError("k-means is unsupervised; remove target-feature")
        if self.input_schema.categorical_features:
            raise ValueError("k-means supports only numeric features")

    def get_hyper_parameter_values(self):
        return list(self.hyper_params)

    def _to_points(self, data) -> np.ndarray:
        vectors = []
        for km in data:
            tokens = textutils.parse_possibly_json(km.message)
            try:
                vectors.append(
                    pmml_common.features_from_tokens(tokens, self.input_schema)
                )
            except (ValueError, IndexError):
                log.warning("Bad input: %s", km.message)
        if not vectors:
            return np.zeros((0, self.input_schema.num_predictors))
        return np.stack(vectors)

    # -- train (buildModel:107-122) -----------------------------------------
    def build_model(self, context, train_data, hyper_parameters,
                    candidate_path: Path, device=None):
        k = int(hyper_parameters[0])
        if k <= 0:
            raise ValueError(f"k must be positive: {k}")
        points = self._to_points(train_data)
        if len(points) == 0:
            return None
        centers, counts = kmtrain.kmeans_train(
            points,
            k,
            iterations=self.iterations,
            runs=self.runs,
            init=self.initialization_strategy,
            generator=rand.torch_generator(),
            device=self.device if device is None else device,
        )
        clusters = [
            ClusterInfo(i, centers[i], int(counts[i])) for i in range(len(centers))
        ]
        return pmml_codec.clustering_model_to_pmml(clusters, self.input_schema)

    # -- eval (evaluate:139-177) --------------------------------------------
    def evaluate(self, context, model, model_parent_path, test_data, train_data):
        pmml_codec.validate_pmml_vs_schema(model, self.input_schema)
        clusters = pmml_codec.read(model)
        # evaluated on train ∪ test (KMeansUpdate.evaluate:146-147)
        points = self._to_points(list(train_data) + list(test_data))
        if len(points) == 0:
            return None
        strategy = self.evaluation_strategy
        if strategy == "DAVIES_BOULDIN":
            val = -kmeval.davies_bouldin_index(clusters, points)
        elif strategy == "DUNN":
            val = kmeval.dunn_index(clusters, points)
        elif strategy == "SILHOUETTE":
            val = kmeval.silhouette_coefficient(clusters, points)
        else:  # SSE
            val = -kmeval.sum_squared_error(clusters, points)
        log.info("%s = %s", strategy, val)
        return val
