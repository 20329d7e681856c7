"""RDF speed tier: per-leaf target statistics from the microbatch stream.

A copy of the JAX package's ``oryx_tpu/models/rdf/speed.py``
(host code, no JAX), held equal to it by ``tests/test_torch_rdf.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's RDFSpeedModel / RDFSpeedModelManager
(app/oryx-app/.../rdf/RDFSpeedModel.java, RDFSpeedModelManager.java:57-148):
``MODEL``/``MODEL-REF`` replaces the forest (validated against the schema);
its own ``UP`` messages are ignored; ``build_updates`` routes every new
example to its terminal node in each tree and emits one aggregate update per
(tree, node): ``[treeID, nodeID, {encoding: count}]`` JSON for
classification, ``[treeID, nodeID, mean, count]`` for regression.
"""

from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

from oryx_tpu_torch.api.speed import AbstractSpeedModelManager, SpeedModel
from oryx_tpu_torch.common import textutils
from oryx_tpu_torch.ml.mlupdate import read_pmml_from_update_key_message
from oryx_tpu_torch.models.classreg import example_from_tokens
from oryx_tpu_torch.models.rdf import pmml_codec
from oryx_tpu_torch.models.rdf.tree import DecisionForest
from oryx_tpu_torch.models.schema import CategoricalValueEncodings, InputSchema

log = logging.getLogger(__name__)


class RDFSpeedModel(SpeedModel):
    """Forest + encodings (RDFSpeedModel.java)."""

    def __init__(self, forest: DecisionForest, encodings: CategoricalValueEncodings):
        self.forest = forest
        self.encodings = encodings

    def get_fraction_loaded(self) -> float:
        return 1.0


class RDFSpeedModelManager(AbstractSpeedModelManager):
    def __init__(self, config):
        self.config = config
        self.input_schema = InputSchema(config)
        self.model: RDFSpeedModel | None = None

    # -- update-topic consumption (consumeKeyMessage:68-91) ------------------
    def consume_key_message(self, key: str, message: str) -> None:
        if key == "UP":
            return  # hearing our own updates
        if key in ("MODEL", "MODEL-REF"):
            pmml = read_pmml_from_update_key_message(key, message)
            pmml_codec.validate_pmml_vs_schema(pmml, self.input_schema)
            forest, encodings = pmml_codec.read(pmml)
            self.model = RDFSpeedModel(forest, encodings)
            log.info("new model loaded (%d trees)", len(forest.trees))
        else:
            raise ValueError(f"bad key: {key}")

    # -- microbatch leaf statistics (buildUpdates:93-148) --------------------
    def build_updates(self, new_data):
        model = self.model
        if model is None:
            return []
        schema = self.input_schema
        examples = []
        for km in new_data:
            try:
                tokens = textutils.parse_possibly_json(km.message)
                examples.append(
                    example_from_tokens(tokens, schema, model.encodings)
                )
            except (ValueError, KeyError, IndexError):
                log.warning("Bad input: %s", km.message)
        if not examples:
            return []

        # (treeID, nodeID) → list of targets
        targets = defaultdict(list)
        for example in examples:
            if example.target is None:
                continue
            for tree_id, tree in enumerate(model.forest.trees):
                terminal = tree.find_terminal(example)
                targets[(tree_id, terminal.id)].append(example.target)

        updates = []
        if schema.is_classification():
            for (tree_id, node_id), feats in targets.items():
                counts: dict[int, int] = defaultdict(int)
                for f in feats:
                    counts[f.encoding] += 1
                updates.append(
                    textutils.join_json([tree_id, node_id, dict(counts)])
                )
        else:
            for (tree_id, node_id), feats in targets.items():
                values = np.asarray([f.value for f in feats])
                updates.append(
                    textutils.join_json(
                        [tree_id, node_id, float(values.mean()), len(values)]
                    )
                )
        return updates
