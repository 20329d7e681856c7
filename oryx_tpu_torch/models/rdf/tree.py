"""Decision tree & forest structures for serving and speed tiers.

A copy of the JAX package's ``oryx_tpu/models/rdf/tree.py``
(host code, no JAX), held equal to it by ``tests/test_torch_rdf.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's rdf trees and decisions
(app/oryx-app-common/.../rdf/tree/{DecisionTree,DecisionForest,DecisionNode,
TerminalNode,TreeNode}.java, rdf/decision/{NumericDecision,
CategoricalDecision}.java): node IDs are root-path strings of ``+``/``-``
("r", "r+", "r-+", ... DecisionTree.findByID:66-85); a NumericDecision sends
an example right when ``value >= threshold`` (NumericDecision.java:104), a
CategoricalDecision when the category's bit is in the active set
(CategoricalDecision.java:82); missing features follow the decision's
``default_decision`` (the more-populated child, RDFUpdate defaultChild logic);
forest prediction is a weighted vote over per-tree terminal predictions.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from oryx_tpu_torch.models.classreg import (
    CATEGORICAL,
    NUMERIC,
    Example,
    vote_on_feature,
)


class NumericDecision:
    """Example goes right ("positive") iff feature >= threshold."""

    feature_type = NUMERIC

    def __init__(self, feature_number: int, threshold: float, default_decision: bool):
        self.feature_number = feature_number
        self.threshold = float(threshold)
        self.default_decision = bool(default_decision)

    def is_positive(self, example: Example) -> bool:
        feature = example.get_feature(self.feature_number)
        if feature is None:
            return self.default_decision
        return feature.value >= self.threshold

    def __repr__(self) -> str:  # pragma: no cover
        return f"(#{self.feature_number} >= {self.threshold})"


class CategoricalDecision:
    """Example goes right iff its category encoding is in the active set."""

    feature_type = CATEGORICAL

    def __init__(
        self,
        feature_number: int,
        active_categories: Sequence[int],
        default_decision: bool,
    ):
        self.feature_number = feature_number
        self.active_categories = frozenset(int(c) for c in active_categories)
        self.default_decision = bool(default_decision)

    def is_positive(self, example: Example) -> bool:
        feature = example.get_feature(self.feature_number)
        if feature is None:
            return self.default_decision
        return feature.encoding in self.active_categories

    def __repr__(self) -> str:  # pragma: no cover
        return f"(#{self.feature_number} in {sorted(self.active_categories)})"


class TerminalNode:
    """Leaf carrying a mutable prediction (TerminalNode.java)."""

    def __init__(self, node_id: str, prediction):
        self.id = node_id
        self.prediction = prediction

    @property
    def is_terminal(self) -> bool:
        return True

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.id}={self.prediction!r}"


class DecisionNode:
    """Internal node: decision + negative(left)/positive(right) children."""

    def __init__(self, node_id: str, decision, negative, positive):
        self.id = node_id
        self.decision = decision
        self.negative = negative
        self.positive = positive

    @property
    def is_terminal(self) -> bool:
        return False

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.id}:{self.decision!r}"


class DecisionTree:
    """One tree; prediction = walk to terminal (DecisionTree.java:39-85)."""

    def __init__(self, root):
        self.root = root

    def find_terminal(self, example: Example) -> TerminalNode:
        node = self.root
        while not node.is_terminal:
            node = node.positive if node.decision.is_positive(example) else node.negative
        return node

    def predict(self, example: Example):
        return self.find_terminal(example).prediction

    def find_by_id(self, node_id: str) -> "Optional[object]":
        """Walk the +/- path encoded in the ID itself (findByID:66-85)."""
        if not node_id.startswith("r"):
            raise ValueError(f"bad node ID: {node_id}")
        node = self.root
        for c in node_id[1:]:
            if node.is_terminal:
                return None
            if c == "+":
                node = node.positive
            elif c == "-":
                node = node.negative
            else:
                raise ValueError(f"bad node ID: {node_id}")
        return node

    def __repr__(self) -> str:  # pragma: no cover
        return f"DecisionTree({self.root!r})"


class DecisionForest:
    """Weighted trees + per-feature importances (DecisionForest.java:34-88)."""

    def __init__(
        self,
        trees: Sequence[DecisionTree],
        weights: Sequence[float],
        feature_importances: Sequence[float],
    ):
        if not trees:
            raise ValueError("empty forest")
        if len(trees) != len(weights):
            raise ValueError("trees and weights differ in length")
        self.trees = list(trees)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.feature_importances = np.asarray(feature_importances, dtype=np.float64)

    def predict(self, example: Example):
        votes = [tree.predict(example) for tree in self.trees]
        return vote_on_feature(votes, self.weights)

    def __repr__(self) -> str:  # pragma: no cover
        return f"DecisionForest[numTrees:{len(self.trees)}]"
