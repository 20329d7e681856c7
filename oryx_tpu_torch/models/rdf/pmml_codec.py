"""RDF PMML codec: TreeModel / MiningModel+Segmentation round trip.

A copy of the JAX package's ``oryx_tpu/models/rdf/pmml_codec.py``
(host code, no JAX), held equal to it by ``tests/test_torch_rdf.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's RDFPMMLUtils + RDFUpdate.rdfModelToPMML
(app/oryx-app-common/.../rdf/RDFPMMLUtils.java:73-279,
app/oryx-app-mllib/.../rdf/RDFUpdate.java:368-553). Wire conventions kept
byte-compatible with the reference:

  - one tree → a bare ``TreeModel``; many → ``MiningModel`` with a
    ``Segmentation`` of weight-1 segments (weightedMajorityVote for
    classification, weightedAverage for regression);
  - node IDs are root-path strings ("r", "r+", "r-", ...); the positive/right
    child carries the predicate and comes first, the negative/left child is
    ``<True/>``;
  - numeric split → ``SimplePredicate greaterThan threshold`` (the reader
    converts to the ≥-convention by adding one ulp); categorical split →
    ``SimpleSetPredicate isNotIn`` over the left/negative value set;
  - ``defaultChild`` points at the more-populated child and drives
    missing-value routing; ``recordCount`` carries the training example count;
  - classification leaves carry ``ScoreDistribution`` (recordCount +
    confidence); regression leaves carry ``score`` + recordCount;
  - model extensions: maxDepth, maxSplitCandidates, impurity.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import xml.etree.ElementTree as ET

from oryx_tpu_torch.models import pmml_common
from oryx_tpu_torch.models.classreg import CategoricalPrediction, NumericPrediction
from oryx_tpu_torch.models.rdf import train as rdftrain
from oryx_tpu_torch.models.rdf.tree import (
    CategoricalDecision,
    DecisionForest,
    DecisionNode,
    DecisionTree,
    NumericDecision,
    TerminalNode,
)
from oryx_tpu_torch.models.schema import CategoricalValueEncodings, InputSchema
from oryx_tpu_torch.pmml import pmmlutils


# ---------------------------------------------------------------------------
# Write: trained trees → PMML
# ---------------------------------------------------------------------------


def forest_to_pmml(
    trees: Sequence[rdftrain.TrainedNode],
    importances: np.ndarray,
    schema: InputSchema,
    encodings: CategoricalValueEncodings,
    *,
    max_depth: int,
    max_split_candidates: int,
    impurity: str,
) -> ET.Element:
    """(RDFUpdate.rdfModelToPMML:368-421)"""
    classification = schema.is_classification()
    pmml = pmmlutils.build_skeleton_pmml()
    pmml_common.build_data_dictionary(pmml, schema, encodings)
    function = "classification" if classification else "regression"
    if len(trees) == 1:
        model = pmmlutils.subelement(pmml, "TreeModel", _tree_model_attrs(function))
        pmml_common.build_mining_schema(model, schema, importances)
        _write_tree(model, trees[0], schema, encodings, classification)
    else:
        model = pmmlutils.subelement(pmml, "MiningModel", {"functionName": function})
        pmml_common.build_mining_schema(model, schema, importances)
        method = "weightedMajorityVote" if classification else "weightedAverage"
        seg = pmmlutils.subelement(model, "Segmentation", {"multipleModelMethod": method})
        for tree_id, root in enumerate(trees):
            segment = pmmlutils.subelement(seg, "Segment", {"id": tree_id, "weight": "1.0"})
            pmmlutils.subelement(segment, "True")
            tm = pmmlutils.subelement(segment, "TreeModel", _tree_model_attrs(function))
            pmml_common.build_mining_schema(tm, schema, importances)
            _write_tree(tm, root, schema, encodings, classification)
    pmmlutils.add_extension(pmml, "maxDepth", max_depth)
    pmmlutils.add_extension(pmml, "maxSplitCandidates", max_split_candidates)
    pmmlutils.add_extension(pmml, "impurity", impurity)
    return pmml


def _tree_model_attrs(function: str) -> dict:
    return {
        "functionName": function,
        "splitCharacteristic": "binarySplit",
        "missingValueStrategy": "defaultChild",
    }


def _write_tree(parent, root: rdftrain.TrainedNode, schema, encodings, classification):
    _write_node(parent, root, None, schema, encodings, classification)


def _write_node(parent, node: rdftrain.TrainedNode, arriving_split, schema, encodings, classification):
    """arriving_split = (TrainedSplit, is_positive) decision that led here;
    the predicate belongs to the child, not the node's own split
    (RDFUpdate.toTreeModel:426-500)."""
    el = pmmlutils.subelement(
        parent, "Node", {"id": node.id, "recordCount": pmml_common.format_number(node.count)}
    )
    _write_predicate(el, arriving_split, schema, encodings)
    if node.is_leaf:
        if classification:
            target_idx = schema.target_feature_index
            e2v = encodings.get_encoding_value_map(target_idx)
            counts = node.class_counts
            for enc in sorted(e2v):
                record_count = float(counts[enc]) if enc < len(counts) else 0.0
                if record_count > 0.0:
                    total = float(counts.sum())
                    dist = pmmlutils.subelement(
                        el,
                        "ScoreDistribution",
                        {
                            "value": e2v[enc],
                            "recordCount": pmml_common.format_number(record_count),
                        },
                    )
                    dist.set("confidence", pmml_common.format_number(record_count / total))
        else:
            el.set("score", pmml_common.format_number(node.mean))
    else:
        default_child = node.id + ("+" if node.split.default_right else "-")
        el.set("defaultChild", default_child)
        # positive/right first — it carries the predicate and evaluates first
        _write_node(el, node.positive, (node.split, True), schema, encodings, classification)
        _write_node(el, node.negative, (node.split, False), schema, encodings, classification)


def _write_predicate(el, arriving_split, schema, encodings):
    """(RDFUpdate.buildPredicate:505-545)"""
    if arriving_split is None or not arriving_split[1]:
        pmmlutils.subelement(el, "True")
        return
    split = arriving_split[0]
    feature_index = schema.predictor_to_feature_index(split.predictor_index)
    field = schema.feature_names[feature_index]
    if split.left_categories is not None:
        e2v = encodings.get_encoding_value_map(feature_index)
        negative_values = [e2v[c] for c in split.left_categories]
        pred = pmmlutils.subelement(
            el,
            "SimpleSetPredicate",
            {"field": field, "booleanOperator": "isNotIn"},
        )
        arr = pmmlutils.subelement(
            pred, "Array", {"type": "string", "n": len(negative_values)}
        )
        arr.text = pmmlutils.join_pmml_delimited(negative_values)
    else:
        pmmlutils.subelement(
            el,
            "SimplePredicate",
            {
                "field": field,
                "operator": "greaterThan",
                "value": pmml_common.format_number(split.threshold),
            },
        )


# ---------------------------------------------------------------------------
# Read: PMML → DecisionForest (RDFPMMLUtils.read:112-160)
# ---------------------------------------------------------------------------


def read(pmml: ET.Element) -> tuple[DecisionForest, CategoricalValueEncodings]:
    dd = pmmlutils.find(pmml, "DataDictionary")
    if dd is None:
        raise ValueError("PMML has no DataDictionary")
    feature_names = pmml_common.get_feature_names(dd, "DataField")
    encodings = pmml_common.read_data_dictionary_encodings(dd)

    mining_model = _direct_child(pmml, "MiningModel")
    tree_model = _direct_child(pmml, "TreeModel")
    model = mining_model if mining_model is not None else tree_model
    if model is None:
        raise ValueError("PMML has neither MiningModel nor TreeModel")
    ms = pmmlutils.find(model, "MiningSchema")
    target_index = _find_target_index(ms, feature_names)
    if target_index is None:
        raise ValueError("no predicted MiningField")

    if mining_model is not None:
        segmentation = pmmlutils.find(mining_model, "Segmentation")
        method = segmentation.get("multipleModelMethod")
        if method not in ("weightedAverage", "weightedMajorityVote"):
            raise ValueError(f"bad multipleModelMethod: {method}")
        segments = pmmlutils.find_all(segmentation, "Segment")
        if not segments:
            raise ValueError("no segments")
        trees, weights = [], []
        for segment in segments:
            weights.append(float(segment.get("weight", "1")))
            root_el = _root_node(pmmlutils.find(segment, "TreeModel"))
            trees.append(
                DecisionTree(_translate(root_el, encodings, feature_names, target_index))
            )
    else:
        trees = [
            DecisionTree(_translate(_root_node(model), encodings, feature_names, target_index))
        ]
        weights = [1.0]

    importances = np.zeros(len(feature_names))
    for i, field in enumerate(pmmlutils.find_all(ms, "MiningField")):
        imp = field.get("importance")
        if imp is not None:
            importances[i] = float(imp)
    return DecisionForest(trees, weights, importances), encodings


def _direct_child(pmml, tag):
    for el in pmml:
        if el.tag.rsplit("}", 1)[-1] == tag:
            return el
    return None


def _root_node(tree_model):
    for el in tree_model:
        if el.tag.rsplit("}", 1)[-1] == "Node":
            return el
    raise ValueError("TreeModel has no root Node")


def _find_target_index(ms, feature_names):
    for i, field in enumerate(pmmlutils.find_all(ms, "MiningField")):
        if field.get("usageType") == "predicted":
            return feature_names.index(field.get("name"))
    return None


def _children(el, tag):
    return [c for c in el if c.tag.rsplit("}", 1)[-1] == tag]


def _node_predicate(el):
    for c in el:
        tag = c.tag.rsplit("}", 1)[-1]
        if tag in ("True", "False", "SimplePredicate", "SimpleSetPredicate"):
            return tag, c
    return None, None


def _translate(el, encodings, feature_names, target_index):
    """(RDFPMMLUtils.translateFromPMML:176-279)"""
    node_id = el.get("id")
    children = _children(el, "Node")
    if not children:
        dists = _children(el, "ScoreDistribution")
        if dists:
            v2e = encodings.get_value_encoding_map(target_index)
            counts = np.zeros(len(v2e))
            for dist in dists:
                counts[v2e[dist.get("value")]] = float(dist.get("recordCount"))
            prediction = CategoricalPrediction(counts)
        else:
            prediction = NumericPrediction(
                float(el.get("score")), int(round(float(el.get("recordCount", "0"))))
            )
        return TerminalNode(node_id, prediction)

    if len(children) != 2:
        raise ValueError(f"node {node_id} must have exactly 2 children")
    tag1, _ = _node_predicate(children[0])
    if tag1 == "True":
        negative, positive = children[0], children[1]
    else:
        negative, positive = children[1], children[0]
    neg_tag, _ = _node_predicate(negative)
    if neg_tag != "True":
        raise ValueError("one child must carry a True predicate")

    pred_tag, pred = _node_predicate(positive)
    default_decision = positive.get("id") == el.get("defaultChild")

    if pred_tag == "SimplePredicate":
        operator = pred.get("operator")
        if operator not in ("greaterOrEqual", "greaterThan"):
            raise ValueError(f"bad operator: {operator}")
        threshold = float(pred.get("value"))
        if operator == "greaterThan":
            # NumericDecision is >=; implement "> t" as ">= t + ulp"
            threshold = threshold + math.ulp(threshold)
        feature_number = feature_names.index(pred.get("field"))
        decision = NumericDecision(feature_number, threshold, default_decision)
    elif pred_tag == "SimpleSetPredicate":
        operator = pred.get("booleanOperator")
        if operator not in ("isIn", "isNotIn"):
            raise ValueError(f"bad operator: {operator}")
        feature_number = feature_names.index(pred.get("field"))
        v2e = encodings.get_value_encoding_map(feature_number)
        arr = pmmlutils.find(pred, "Array")
        categories = pmmlutils.parse_pmml_delimited(arr.text or "")
        listed = {v2e[c] for c in categories}
        if operator == "isIn":
            active = listed
        else:
            active = set(v2e.values()) - listed
        decision = CategoricalDecision(feature_number, active, default_decision)
    else:
        raise ValueError(f"bad predicate on positive child of {node_id}")

    return DecisionNode(
        node_id,
        decision,
        _translate(negative, encodings, feature_names, target_index),
        _translate(positive, encodings, feature_names, target_index),
    )


# ---------------------------------------------------------------------------
# Validation (RDFPMMLUtils.validatePMMLVsSchema:52-89)
# ---------------------------------------------------------------------------


def validate_pmml_vs_schema(pmml: ET.Element, schema: InputSchema) -> None:
    model = _direct_child(pmml, "MiningModel")
    if model is None:
        model = _direct_child(pmml, "TreeModel")
    if model is None:
        raise ValueError("PMML has neither MiningModel nor TreeModel")
    function = model.get("functionName")
    expected = "classification" if schema.is_classification() else "regression"
    if function != expected:
        raise ValueError(f"expected {expected} function type but got {function}")
    pmml_common.validate_feature_names(pmml, schema, "rdf")
    ms = pmmlutils.find(model, "MiningSchema")
    names = pmml_common.get_feature_names(ms, "MiningField")
    target_index = _find_target_index(ms, names)
    if schema.has_target():
        if target_index is None or target_index != schema.target_feature_index:
            raise ValueError(
                f"schema expects target at index {schema.target_feature_index}, "
                f"PMML has it at {target_index}"
            )
    elif target_index is not None:
        raise ValueError("PMML has a target but schema does not")
