"""RDF batch update: the MLUpdate implementation for decision forests.

The port of the JAX package's ``oryx_tpu/models/rdf/update.py``, held to it
by ``tests/test_torch_rdf.py``. :meth:`RDFUpdate.build_model` trains on the
card (:func:`~oryx_tpu_torch.models.rdf.train.forest_train` on the updater's
device, or the one ``run_update`` hands it); parsing and
:meth:`RDFUpdate.evaluate` stay host code, as in the reference. Below,
"the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's RDFUpdate (app/oryx-app-mllib/.../rdf/
RDFUpdate.java:91-558): num-trees from ``oryx.rdf.num-trees``; hyperparams
max-split-candidates / max-depth / impurity / min-node-size /
min-info-gain-nats from ``oryx.rdf.hyperparams.*``;
categorical value encodings built from the distinct values in the training
data (getDistinctValues:208-227, sorted here for determinism); training via
the histogram forest trainer (train.forest_train); per-node record counts
and per-predictor importances from an unbagged re-walk
(treeNodeExampleCounts:267, predictorExampleCounts:310); evaluation =
accuracy for classification, −RMSE for regression (Evaluation.java:31-52).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from oryx_tpu_torch.common import rand, textutils
from oryx_tpu_torch.ml import param as hp
from oryx_tpu_torch.ml.mlupdate import MLUpdate
from oryx_tpu_torch.models.classreg import example_from_tokens
from oryx_tpu_torch.models.rdf import pmml_codec
from oryx_tpu_torch.models.rdf import train as rdftrain
from oryx_tpu_torch.models.schema import CategoricalValueEncodings, InputSchema

log = logging.getLogger(__name__)


class RDFUpdate(MLUpdate):
    """Trains on ``device`` (``None``: the CUDA card)."""

    def __init__(self, config, device=None):
        super().__init__(config, device=device)
        self.num_trees = config.get_int("oryx.rdf.num-trees")
        if self.num_trees < 1:
            raise ValueError("num-trees must be at least 1")
        self.hyper_params = [
            hp.from_config(config, "oryx.rdf.hyperparams.max-split-candidates"),
            hp.from_config(config, "oryx.rdf.hyperparams.max-depth"),
            hp.from_config(config, "oryx.rdf.hyperparams.impurity"),
            hp.from_config(config, "oryx.rdf.hyperparams.min-node-size"),
            hp.from_config(config, "oryx.rdf.hyperparams.min-info-gain-nats"),
        ]
        self.input_schema = InputSchema(config)
        if not self.input_schema.has_target():
            raise ValueError("RDF requires a target-feature")

    def get_hyper_parameter_values(self):
        return list(self.hyper_params)

    # -- parsing helpers ----------------------------------------------------
    def _parse(self, data) -> list[list[str]]:
        rows = []
        for km in data:
            try:
                rows.append(textutils.parse_possibly_json(km.message))
            except ValueError:
                log.warning("Bad input: %s", km.message)
        return rows

    def _distinct_values(self, rows) -> CategoricalValueEncodings:
        """(getDistinctValues:208-227) — sorted for deterministic encodings."""
        schema = self.input_schema
        distinct: dict[int, set] = {
            i: set() for i in range(schema.num_features) if schema.is_categorical(i)
        }
        for row in rows:
            for i, values in distinct.items():
                values.add(row[i])
        return CategoricalValueEncodings(
            {i: sorted(v) for i, v in distinct.items()}
        )

    def _to_matrix(self, rows, encodings) -> tuple[np.ndarray, np.ndarray]:
        """Rows → dense (X, y) with categorical values encoded
        (parseToLabeledPointRDD:230-264)."""
        schema = self.input_schema
        X = np.zeros((len(rows), schema.num_predictors), dtype=np.float64)
        y = np.zeros(len(rows), dtype=np.float64)
        keep = np.ones(len(rows), dtype=bool)
        for r, row in enumerate(rows):
            try:
                for i in range(schema.num_features):
                    if schema.is_numeric(i):
                        encoded = float(row[i])
                    elif schema.is_categorical(i):
                        encoded = encodings.get_value_encoding_map(i)[row[i]]
                    else:
                        continue
                    if schema.is_target(i):
                        y[r] = encoded
                    else:
                        X[r, schema.feature_to_predictor_index(i)] = encoded
            except (ValueError, KeyError, IndexError):
                log.warning("Bad input: %s", row)
                keep[r] = False
        return X[keep], y[keep]

    def _predictor_layout(self, encodings):
        schema = self.input_schema
        is_cat = np.zeros(schema.num_predictors, dtype=bool)
        n_cat = np.zeros(schema.num_predictors, dtype=np.int64)
        for i in range(schema.num_features):
            if schema.is_active(i) and not schema.is_target(i):
                p = schema.feature_to_predictor_index(i)
                if schema.is_categorical(i):
                    is_cat[p] = True
                    n_cat[p] = encodings.get_value_count(i)
        return is_cat, n_cat

    # -- train (buildModel:113-176) -----------------------------------------
    def build_model(self, context, train_data, hyper_parameters,
                    candidate_path: Path, device=None):
        max_split_candidates = int(hyper_parameters[0])
        max_depth = int(hyper_parameters[1])
        impurity = str(hyper_parameters[2])
        # pre-prune knobs ride the hyperparam vector like the reference's
        # (RDFUpdate.java minNodeSize/minInfoGainNats); absent entries (older
        # 3-element callers) keep the trainer's permissive defaults
        min_node_size = int(hyper_parameters[3]) if len(hyper_parameters) > 3 else 1
        min_info_gain = float(hyper_parameters[4]) if len(hyper_parameters) > 4 else 0.0
        if max_split_candidates < 2:
            raise ValueError("max-split-candidates must be at least 2")
        if max_depth <= 0:
            raise ValueError("max-depth must be at least 1")

        rows = self._parse(train_data)
        if not rows:
            return None
        encodings = self._distinct_values(rows)
        X, y = self._to_matrix(rows, encodings)
        if len(X) == 0:
            return None
        is_cat, n_cat = self._predictor_layout(encodings)

        schema = self.input_schema
        if schema.is_classification():
            task = rdftrain.CLASSIFICATION
            n_classes = encodings.get_value_count(schema.target_feature_index)
        else:
            task = rdftrain.REGRESSION
            n_classes = 0
            impurity = "variance"

        trees, importances = rdftrain.forest_train(
            X,
            y,
            is_cat,
            n_cat,
            task=task,
            n_classes=n_classes,
            num_trees=self.num_trees,
            max_depth=max_depth,
            max_split_candidates=max_split_candidates,
            impurity=impurity,
            min_node_size=min_node_size,
            min_info_gain_nats=min_info_gain,
            rng=rand.get_random(),
            device=self.device if device is None else device,
        )
        return pmml_codec.forest_to_pmml(
            trees,
            importances,
            schema,
            encodings,
            max_depth=max_depth,
            max_split_candidates=max_split_candidates,
            impurity=impurity,
        )

    # -- eval (evaluate:178-205) --------------------------------------------
    def evaluate(self, context, model, model_parent_path, test_data, train_data):
        pmml_codec.validate_pmml_vs_schema(model, self.input_schema)
        forest, encodings = pmml_codec.read(model)
        examples = []
        for row in self._parse(test_data):
            try:
                examples.append(example_from_tokens(row, self.input_schema, encodings))
            except (ValueError, KeyError, IndexError):
                log.warning("Bad test input: %s", row)
        if not examples:
            return 0.0
        if self.input_schema.is_classification():
            correct = sum(
                1
                for ex in examples
                if forest.predict(ex).most_probable_category_encoding
                == ex.target.encoding
            )
            accuracy = correct / len(examples)
            log.info("Accuracy: %s", accuracy)
            return accuracy
        mse = float(
            np.mean(
                [
                    (forest.predict(ex).prediction - ex.target.value) ** 2
                    for ex in examples
                ]
            )
        )
        rmse = float(np.sqrt(mse))
        log.info("RMSE: %s", rmse)
        return -rmse
