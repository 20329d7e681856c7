"""App-level PMML glue shared by k-means and RDF models.

A copy of the JAX package's
``oryx_tpu/models/pmml_common.py``
(host code, no JAX), held equal to it by ``tests/test_torch_kmeans.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's AppPMMLUtils schema helpers
(app/oryx-app-common/.../pmml/AppPMMLUtils.java:131-259): MiningSchema with
active/supplementary/predicted usage and optional importances, DataDictionary
with per-categorical-feature Value lists ordered by encoding, PMML REAL Array
encoding, and the reverse readers used to validate a received model against
the configured InputSchema.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import xml.etree.ElementTree as ET

from oryx_tpu_torch.models.schema import CategoricalValueEncodings, InputSchema
from oryx_tpu_torch.pmml import pmmlutils


def format_number(v: float) -> str:
    """Render like Java's Double.toString for round values (1.0 not 1)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e16:
        return f"{int(f)}.0"
    return repr(f)


def to_pmml_array(parent: ET.Element, values: Sequence[float]) -> ET.Element:
    """<Array type="REAL" n="..."> space-joined numbers (AppPMMLUtils.toArray)."""
    arr = pmmlutils.subelement(parent, "Array", {"type": "REAL", "n": len(values)})
    arr.text = pmmlutils.join_pmml_delimited([format_number(v) for v in values])
    return arr


def parse_array(el: ET.Element) -> np.ndarray:
    return np.asarray(
        [float(t) for t in pmmlutils.parse_pmml_delimited(el.text or "")],
        dtype=np.float64,
    )


def build_mining_schema(
    parent: ET.Element,
    schema: InputSchema,
    importances: "np.ndarray | None" = None,
) -> ET.Element:
    """(AppPMMLUtils.buildMiningSchema:131-176)"""
    if importances is not None and len(importances) != schema.num_predictors:
        raise ValueError("importances size must match number of predictors")
    ms = pmmlutils.subelement(parent, "MiningSchema")
    for i, name in enumerate(schema.feature_names):
        attrib: dict = {"name": name}
        if schema.is_target(name):
            attrib["usageType"] = "predicted"
            attrib["optype"] = (
                "continuous" if schema.is_numeric(name) else "categorical"
            )
        elif schema.is_numeric(name):
            attrib["usageType"] = "active"
            attrib["optype"] = "continuous"
        elif schema.is_categorical(name):
            attrib["usageType"] = "active"
            attrib["optype"] = "categorical"
        else:
            attrib["usageType"] = "supplementary"
        if attrib.get("usageType") == "active" and importances is not None:
            attrib["importance"] = format_number(
                importances[schema.feature_to_predictor_index(i)]
            )
        pmmlutils.subelement(ms, "MiningField", attrib)
    return ms


def build_data_dictionary(
    parent: ET.Element,
    schema: InputSchema,
    encodings: "CategoricalValueEncodings | None" = None,
) -> ET.Element:
    """(AppPMMLUtils.buildDataDictionary:198-230)"""
    dd = pmmlutils.subelement(
        parent, "DataDictionary", {"numberOfFields": schema.num_features}
    )
    for i, name in enumerate(schema.feature_names):
        attrib: dict = {"name": name}
        if schema.is_numeric(name):
            attrib.update(optype="continuous", dataType="double")
        elif schema.is_categorical(name):
            attrib.update(optype="categorical", dataType="string")
        field = pmmlutils.subelement(dd, "DataField", attrib)
        if schema.is_categorical(name) and encodings is not None:
            e2v = encodings.get_encoding_value_map(i)
            for enc in sorted(e2v):
                pmmlutils.subelement(field, "Value", {"value": e2v[enc]})
    return dd


def get_feature_names(container: ET.Element, child_tag: str) -> list[str]:
    """Feature names in order from a DataDictionary (DataField) or MiningSchema
    (MiningField) (AppPMMLUtils.getFeatureNames:237-258)."""
    return [
        el.get("name")
        for el in pmmlutils.find_all(container, child_tag)
    ]


def read_data_dictionary_encodings(dd: ET.Element) -> CategoricalValueEncodings:
    """DataDictionary Value lists → encodings (AppPMMLUtils.buildCategoricalValueEncodings)."""
    distinct: dict[int, list[str]] = {}
    for i, field in enumerate(pmmlutils.find_all(dd, "DataField")):
        values = [v.get("value") for v in pmmlutils.find_all(field, "Value")]
        if values:
            distinct[i] = values
    return CategoricalValueEncodings(distinct)


def validate_feature_names(pmml: ET.Element, schema: InputSchema, what: str) -> None:
    """Common part of validatePMMLVsSchema (KMeansPMMLUtils.java:47-65)."""
    dd = pmmlutils.find(pmml, "DataDictionary")
    if dd is None:
        raise ValueError(f"{what}: PMML has no DataDictionary")
    names = get_feature_names(dd, "DataField")
    if names != schema.feature_names:
        raise ValueError(
            f"{what}: feature names in schema don't match names in PMML: "
            f"{schema.feature_names} vs {names}"
        )
    ms = pmmlutils.find(pmml, "MiningSchema")
    if ms is None:
        raise ValueError(f"{what}: PMML has no MiningSchema")
    ms_names = get_feature_names(ms, "MiningField")
    if ms_names != schema.feature_names:
        raise ValueError(f"{what}: MiningSchema names don't match schema")


def features_from_tokens(tokens: Sequence[str], schema: InputSchema) -> np.ndarray:
    """Datum tokens → dense numeric predictor vector (KMeansUtils.featuresFromTokens:62-71).

    Rows with more tokens than the schema has features are rejected, like the
    reference's ArrayIndexOutOfBoundsException → bad-input path."""
    if len(tokens) > schema.num_features:
        raise IndexError(
            f"{len(tokens)} tokens but schema has {schema.num_features} features"
        )
    features = np.zeros(schema.num_predictors, dtype=np.float64)
    for i in range(len(tokens)):
        if schema.is_active(i) and not schema.is_target(i):
            features[schema.feature_to_predictor_index(i)] = float(tokens[i])
    return features
