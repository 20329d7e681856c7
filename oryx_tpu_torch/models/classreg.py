"""Classification/regression data model: features, examples, predictions.

A copy of the JAX package's ``oryx_tpu/models/classreg.py``
(host code, no JAX), held equal to it by ``tests/test_torch_rdf.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's classreg package (app/oryx-app-common/.../
classreg/example/{Example,Feature,NumericFeature,CategoricalFeature,
ExampleUtils}.java and classreg/predict/{NumericPrediction,
CategoricalPrediction,WeightedPrediction}.java): a datum line becomes an
``Example`` of typed features plus an optional target; terminal-node
predictions keep online statistics (running weighted mean for numeric
targets, per-category counts for categorical ones) so the speed tier can
update them in place; forest votes merge per-tree predictions weighted by
tree weight.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

NUMERIC = "N"
CATEGORICAL = "C"


@dataclass(frozen=True)
class NumericFeature:
    """(NumericFeature.java) a real-valued feature."""

    value: float
    feature_type = NUMERIC


@dataclass(frozen=True)
class CategoricalFeature:
    """(CategoricalFeature.java) a categorical feature as its int encoding."""

    encoding: int
    feature_type = CATEGORICAL


Feature = "NumericFeature | CategoricalFeature | None"


class Example:
    """Typed features + optional target (Example.java)."""

    __slots__ = ("features", "target")

    def __init__(self, target, features: Sequence):
        self.target = target
        self.features = tuple(features)

    def get_feature(self, i: int):
        return self.features[i]

    def __repr__(self) -> str:  # pragma: no cover
        return f"Example({self.features} -> {self.target})"


def example_from_tokens(tokens, schema, encodings) -> Example:
    """Tokenized datum → Example (ExampleUtils.dataToExample:41-71).

    The target slot is None when the token is empty (prediction inputs);
    unknown categorical values or bad numbers raise ValueError/KeyError like
    the reference's NumberFormatException path.
    """
    features: "list[Optional[object]]" = [None] * len(tokens)
    target = None
    for i, token in enumerate(tokens):
        feature = None
        is_target = schema.is_target(i)
        if is_target and token == "":
            feature = None
        elif schema.is_numeric(i):
            feature = NumericFeature(float(token))
        elif schema.is_categorical(i):
            feature = CategoricalFeature(
                encodings.get_value_encoding_map(i)[token]
            )
        if is_target:
            target = feature
        else:
            features[i] = feature
    return Example(target, features)


class NumericPrediction:
    """Running weighted mean over a leaf (NumericPrediction.java:30-90)."""

    feature_type = NUMERIC

    def __init__(self, prediction: float, initial_count: int):
        self._lock = threading.Lock()
        self.prediction = float(prediction)
        self.count = int(initial_count)

    def update(self, new_prediction: float, new_count: int = 1) -> None:
        with self._lock:
            new_total = self.count + new_count
            self.count = new_total
            self.prediction += (new_count / new_total) * (
                new_prediction - self.prediction
            )

    def update_example(self, example: Example) -> None:
        self.update(example.target.value, 1)

    def __eq__(self, other) -> bool:
        if not isinstance(other, NumericPrediction):
            return False
        # sequential (never nested) acquisition: no lock-order deadlock
        with self._lock:
            mine = self.prediction
        with other._lock:
            theirs = other.prediction
        return mine == theirs

    def __repr__(self) -> str:  # pragma: no cover
        return f"NumericPrediction({self.prediction}, n={self.count})"


class CategoricalPrediction:
    """Per-category counts, possibly fractional (CategoricalPrediction.java:32-135)."""

    feature_type = CATEGORICAL

    def __init__(self, category_counts: Sequence[float]):
        self._lock = threading.Lock()
        self.category_counts = np.asarray(category_counts, dtype=np.float64).copy()
        if self.category_counts.size == 0:
            raise ValueError("empty category counts")
        self.count = int(round(float(self.category_counts.sum())))

    @property
    def category_probabilities(self) -> np.ndarray:
        # snapshot under the lock: a concurrent update() mutates counts in
        # place, and sum + divide over a moving array skews the distribution
        with self._lock:
            counts = self.category_counts.copy()
        total = float(counts.sum())
        return counts / total

    @property
    def most_probable_category_encoding(self) -> int:
        with self._lock:
            return int(np.argmax(self.category_counts))

    def update(self, encoding: int, count: int = 1) -> None:
        with self._lock:
            self.category_counts[encoding] += count
            self.count += count

    def update_example(self, example: Example) -> None:
        self.update(example.target.encoding, 1)

    def __eq__(self, other) -> bool:
        if not isinstance(other, CategoricalPrediction):
            return False
        # sequential (never nested) acquisition: no lock-order deadlock
        with self._lock:
            mine = self.category_counts.copy()
        with other._lock:
            theirs = other.category_counts.copy()
        return np.array_equal(mine, theirs)

    def __repr__(self) -> str:  # pragma: no cover
        return f"CategoricalPrediction({self.category_counts})"


def vote_on_feature(predictions: Sequence, weights: Sequence[float]):
    """Merge per-tree predictions into one (WeightedPrediction.voteOnFeature:44-95):
    categorical = weight-averaged probability distributions; numeric = weighted
    mean of tree means."""
    if not predictions:
        raise ValueError("No predictions")
    if len(predictions) != len(weights):
        raise ValueError(f"{len(predictions)} predictions but {len(weights)} weights")
    if predictions[0].feature_type == CATEGORICAL:
        w = np.asarray(weights, dtype=np.float64)
        probs = np.stack([p.category_probabilities for p in predictions])
        merged = (probs * w[:, None]).sum(axis=0) / w.sum()
        return CategoricalPrediction(merged)
    w = np.asarray(weights, dtype=np.float64)
    means = np.asarray([p.prediction for p in predictions])
    counts = sum(p.count for p in predictions)
    return NumericPrediction(float((means * w).sum() / w.sum()), counts)
