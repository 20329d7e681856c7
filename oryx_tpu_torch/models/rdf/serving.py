"""RDF serving tier: in-memory forest behind the REST endpoints.

A copy of the JAX package's ``oryx_tpu/models/rdf/serving.py``
(host code, no JAX), held equal to it by ``tests/test_torch_rdf.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's RDFServingModel / RDFServingModelManager
(app/oryx-app-serving/.../rdf/model/RDFServingModel.java:34-94,
RDFServingModelManager.java:55-113): the model is a forest + encodings +
schema; ``UP [treeID, nodeID, ...]`` updates one terminal node's prediction
in place (per-class counts for classification, running mean+count for
regression); ``MODEL``/``MODEL-REF`` swaps in a new validated forest.
``predict`` renders the vote as the most probable category value or the
numeric score string.
"""

from __future__ import annotations

import logging

from oryx_tpu_torch.api.serving import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.common import textutils
from oryx_tpu_torch.ml.mlupdate import read_pmml_from_update_key_message
from oryx_tpu_torch.models.classreg import example_from_tokens
from oryx_tpu_torch.models.rdf import pmml_codec
from oryx_tpu_torch.models.rdf.tree import DecisionForest, TerminalNode
from oryx_tpu_torch.models.schema import CategoricalValueEncodings, InputSchema

log = logging.getLogger(__name__)


class RDFServingModel(ServingModel):
    def __init__(
        self,
        forest: DecisionForest,
        encodings: CategoricalValueEncodings,
        input_schema: InputSchema,
    ):
        self.forest = forest
        self.encodings = encodings
        self.input_schema = input_schema

    def make_prediction(self, tokens):
        """Parsed datum → merged forest Prediction (makePrediction:65-70)."""
        if len(tokens) != self.input_schema.num_features:
            raise ValueError("Wrong number of features")
        example = example_from_tokens(tokens, self.input_schema, self.encodings)
        return self.forest.predict(example)

    def predict(self, tokens) -> str:
        """Most-probable category value, or numeric score (predict:52-63)."""
        prediction = self.make_prediction(tokens)
        if self.input_schema.is_classification():
            e2v = self.encodings.get_encoding_value_map(
                self.input_schema.target_feature_index
            )
            return e2v[prediction.most_probable_category_encoding]
        return str(prediction.prediction)

    def get_fraction_loaded(self) -> float:
        return 1.0

    def __repr__(self) -> str:  # pragma: no cover
        return f"RDFServingModel[numTrees:{len(self.forest.trees)}]"


class RDFServingModelManager(AbstractServingModelManager):
    def __init__(self, config):
        super().__init__(config)
        self.input_schema = InputSchema(config)
        self.model: RDFServingModel | None = None

    # -- update-topic consumption (consumeKeyMessage:56-106) -----------------
    def consume_key_message(self, key: str, message: str) -> None:
        if key == "UP":
            model = self.model
            if model is None:
                return  # no model to interpret with yet
            update = textutils.read_json(message)
            tree_id = int(update[0])
            node_id = str(update[1])
            node = model.forest.trees[tree_id].find_by_id(node_id)
            if node is None or not isinstance(node, TerminalNode):
                log.warning("no terminal node %s in tree %d", node_id, tree_id)
                return
            if self.input_schema.is_classification():
                # JSON map keys are always strings
                for encoding, count in update[2].items():
                    node.prediction.update(int(encoding), int(count))
            else:
                node.prediction.update(float(update[2]), int(update[3]))
        elif key in ("MODEL", "MODEL-REF"):
            pmml = read_pmml_from_update_key_message(key, message)
            pmml_codec.validate_pmml_vs_schema(pmml, self.input_schema)
            forest, encodings = pmml_codec.read(pmml)
            self.model = RDFServingModel(forest, encodings, self.input_schema)
            log.info("new model loaded (%d trees)", len(forest.trees))
        else:
            raise ValueError(f"bad key: {key}")

    def get_model(self):
        return self.model
