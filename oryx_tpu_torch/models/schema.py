"""Input schema: which CSV columns are IDs / numeric / categorical / target.

A copy of the JAX package's
``oryx_tpu/models/schema.py``
(host code, no JAX), held equal to it by ``tests/test_torch_kmeans.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's InputSchema + CategoricalValueEncodings
(app/oryx-app-common/.../schema/InputSchema.java:37-100,
CategoricalValueEncodings.java:33-100): feature names come from
``oryx.input-schema.feature-names`` or are generated ``"0".."n-1"`` from
``num-features``; id/ignored features are subtracted to get active features;
exactly one of numeric-features / categorical-features is given and the other
is the active remainder; the optional target must be active. Both k-means and
RDF parse datum lines through this.
"""

from __future__ import annotations

from typing import Mapping, Sequence


class InputSchema:
    def __init__(self, config):
        feature_names = list(config.get_list("oryx.input-schema.feature-names", []))
        if not feature_names:
            num_features = config.get_int("oryx.input-schema.num-features", 0)
            if num_features <= 0:
                raise ValueError("Neither feature-names nor num-features is set")
            feature_names = [str(i) for i in range(num_features)]
        if len(set(feature_names)) != len(feature_names):
            raise ValueError(f"Feature names must be unique: {feature_names}")
        self.feature_names: list[str] = feature_names

        id_features = set(config.get_list("oryx.input-schema.id-features", []))
        ignored = set(config.get_list("oryx.input-schema.ignored-features", []))
        for col, what in ((id_features, "id"), (ignored, "ignored")):
            unknown = col - set(feature_names)
            if unknown:
                raise ValueError(f"unknown {what} features: {sorted(unknown)}")
        self.id_features = id_features
        active = set(feature_names) - id_features - ignored
        self.active_features = active

        numeric = config.get_list("oryx.input-schema.numeric-features", None)
        categorical = config.get_list("oryx.input-schema.categorical-features", None)
        if numeric is None:
            if categorical is None:
                raise ValueError("Neither numeric-features nor categorical-features was set")
            categorical = set(categorical)
            if not categorical <= active:
                raise ValueError(f"categorical features {sorted(categorical)} not all active")
            numeric = active - categorical
        else:
            numeric = set(numeric)
            if not numeric <= active:
                raise ValueError(f"numeric features {sorted(numeric)} not all active")
            categorical = active - numeric
        self.numeric_features = set(numeric)
        self.categorical_features = set(categorical)

        self.target_feature: "str | None" = config.get(
            "oryx.input-schema.target-feature", None
        )
        if self.target_feature is not None and self.target_feature not in active:
            raise ValueError(
                f"Target feature is not known, an ID, or ignored: {self.target_feature}"
            )
        self.target_feature_index = (
            feature_names.index(self.target_feature) if self.target_feature else -1
        )

        # feature index ↔ predictor index (active non-target features, in order)
        self._all_to_predictor: dict[int, int] = {}
        self._predictor_to_all: dict[int, int] = {}
        predictor = 0
        for i, name in enumerate(feature_names):
            if name in active and i != self.target_feature_index:
                self._all_to_predictor[i] = predictor
                self._predictor_to_all[predictor] = i
                predictor += 1

    # -- accessors (InputSchema.java getters) --------------------------------
    @property
    def num_features(self) -> int:
        return len(self.feature_names)

    @property
    def num_predictors(self) -> int:
        return len(self._all_to_predictor)

    def is_active(self, index: int) -> bool:
        return self.feature_names[index] in self.active_features

    def is_id(self, name_or_index) -> bool:
        return self._name(name_or_index) in self.id_features

    def is_numeric(self, name_or_index) -> bool:
        return self._name(name_or_index) in self.numeric_features

    def is_categorical(self, name_or_index) -> bool:
        return self._name(name_or_index) in self.categorical_features

    def is_target(self, name_or_index) -> bool:
        return (
            self.target_feature is not None
            and self._name(name_or_index) == self.target_feature
        )

    def has_target(self) -> bool:
        return self.target_feature is not None

    def is_classification(self) -> bool:
        """Categorical target = classification (InputSchema.isClassification)."""
        return self.has_target() and self.is_categorical(self.target_feature)

    def feature_to_predictor_index(self, feature_index: int) -> int:
        return self._all_to_predictor[feature_index]

    def predictor_to_feature_index(self, predictor_index: int) -> int:
        return self._predictor_to_all[predictor_index]

    def _name(self, name_or_index) -> str:
        if isinstance(name_or_index, int):
            return self.feature_names[name_or_index]
        return name_or_index


class CategoricalValueEncodings:
    """Two-way value↔int mapping per categorical feature index
    (CategoricalValueEncodings.java:33-100). Order of distinct values matters —
    it defines the encoding."""

    def __init__(self, distinct_values: Mapping[int, Sequence[str]]):
        self._value_to_encoding: dict[int, dict[str, int]] = {}
        self._encoding_to_value: dict[int, dict[int, str]] = {}
        for index, values in distinct_values.items():
            v2e = {v: i for i, v in enumerate(values)}
            if len(v2e) != len(list(values)):
                raise ValueError(f"duplicate values for feature {index}")
            self._value_to_encoding[index] = v2e
            self._encoding_to_value[index] = {i: v for v, i in v2e.items()}

    def get_value_encoding_map(self, index: int) -> dict[str, int]:
        return self._value_to_encoding[index]

    def get_encoding_value_map(self, index: int) -> dict[int, str]:
        return self._encoding_to_value[index]

    def get_value_count(self, index: int) -> int:
        return len(self._value_to_encoding[index])

    def get_category_counts(self) -> dict[int, int]:
        return {k: len(v) for k, v in self._value_to_encoding.items()}

    def __repr__(self) -> str:  # pragma: no cover
        return repr(self._value_to_encoding)
