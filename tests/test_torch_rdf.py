"""The port's random decision forest, held against the reference's.

The 25 cases of ``tests/test_rdf.py`` run with their bodies rebound to the
port's modules (``_mirror``): the trainer and ``RDFUpdate`` on the CPU
(``device="cpu"``), the HTTP cases against the port's ``ServingLayer``
through a stdlib ``http.client`` adapter. Then parity on numpy-seeded
inputs, the reference in float32: ``forest_train`` from one generator seed
grows the same trees node for node (classification with numeric and
categorical predictors, regression with integer targets; with float
targets the same structure and leaf means within 1e-5 relative), equal
importances, the same PMML apart from its ``Timestamp``, the same
``RDFUpdate`` model and evaluation, byte-equal speed ``UP``s, and either
package's ``MODEL`` + ``UP`` stream answering the same in both packages'
serving managers and over both packages' ``ServingLayer``s. Last, the
CPU rehearsal of ``chip_smoke.py``'s ``rdf`` phase at a small size.
"""

from __future__ import annotations

import dataclasses
import functools
import http.client
import json
import re
import time
import types

import numpy as np
import pytest
import torch

from oryx_tpu.api.keymessage import KeyMessage as RefKeyMessage
from oryx_tpu.common import config as ref_cfg
from oryx_tpu.common import rand as ref_rand
from oryx_tpu.models.rdf import pmml_codec as ref_codec
from oryx_tpu.models.rdf import train as ref_train
from oryx_tpu.models.rdf.serving import RDFServingModelManager as RefServingManager
from oryx_tpu.models.rdf.speed import RDFSpeedModelManager as RefSpeedManager
from oryx_tpu.models.rdf.update import RDFUpdate as RefRDFUpdate
from oryx_tpu.models.schema import CategoricalValueEncodings as RefEncodings
from oryx_tpu.models.schema import InputSchema as RefInputSchema
from oryx_tpu.pmml import pmmlutils as ref_pmmlutils
from oryx_tpu.serving.app import ServingLayer as RefServingLayer
from oryx_tpu.transport import topic as ref_tp
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import ioutils, rand
from oryx_tpu_torch.models import classreg
from oryx_tpu_torch.models.rdf import pmml_codec
from oryx_tpu_torch.models.rdf import train as rdftrain
from oryx_tpu_torch.models.rdf import tree
from oryx_tpu_torch.models.rdf.serving import RDFServingModelManager
from oryx_tpu_torch.models.rdf.speed import RDFSpeedModelManager
from oryx_tpu_torch.models.rdf.update import RDFUpdate
from oryx_tpu_torch.models.schema import CategoricalValueEncodings, InputSchema
from oryx_tpu_torch.pmml import pmmlutils
from oryx_tpu_torch.serving.app import ServingLayer
from oryx_tpu_torch.transport import topic as tp
from test_torch_observability import _mirror

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

RDF_MANAGER = "oryx_tpu_torch.models.rdf.serving.RDFServingModelManager"
RDF_RESOURCES = "oryx_tpu_torch.serving.resources.classreg"
REF_RDF_MANAGER = "oryx_tpu.models.rdf.serving.RDFServingModelManager"
REF_RDF_RESOURCES = "oryx_tpu.serving.resources.classreg"


class _Response:
    def __init__(self, status: int, body: bytes):
        self.status_code = status
        self.content = body

    @property
    def text(self) -> str:
        return self.content.decode()

    def json(self):
        return json.loads(self.content)


class _Client:
    """The calls the reference's HTTP cases make (``get``, ``post`` with
    ``content``) over stdlib ``http.client``, one connection per call."""

    def __init__(self, port: int):
        self.port = port

    def request(self, method: str, path: str, content=None) -> _Response:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=30)
        try:
            body = content.encode() if isinstance(content, str) else content
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            return _Response(resp.status, resp.read())
        finally:
            conn.close()

    def get(self, path: str) -> _Response:
        return self.request("GET", path)

    def post(self, path: str, content=None) -> _Response:
        return self.request("POST", path, content)


def _wait_ready(client: _Client, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while client.get("/ready").status_code != 200:
        assert time.monotonic() < deadline, "serving layer never became ready"
        time.sleep(0.05)


# -- the reference's cases on the port ----------------------------------------

_ON_CPU = types.SimpleNamespace(
    CLASSIFICATION=rdftrain.CLASSIFICATION, REGRESSION=rdftrain.REGRESSION,
    forest_train=functools.partial(rdftrain.forest_train, device="cpu"))

_RDF = _mirror("test_rdf.py", {
    "KeyMessage": KeyMessage, "cfg": cfg, "ioutils": ioutils, "rand": rand,
    **{name: getattr(classreg, name) for name in (
        "CategoricalFeature", "CategoricalPrediction", "Example",
        "NumericFeature", "NumericPrediction", "example_from_tokens",
        "vote_on_feature")},
    **{name: getattr(tree, name) for name in (
        "CategoricalDecision", "DecisionForest", "DecisionNode",
        "DecisionTree", "NumericDecision", "TerminalNode")},
    "pmml_codec": pmml_codec, "rdftrain": _ON_CPU,
    "RDFServingModelManager": RDFServingModelManager,
    "RDFSpeedModelManager": RDFSpeedModelManager,
    "RDFUpdate": functools.partial(RDFUpdate, device="cpu"),
    "CategoricalValueEncodings": CategoricalValueEncodings,
    "InputSchema": InputSchema, "pmmlutils": pmmlutils,
    "ServingLayer": functools.partial(ServingLayer, device="cpu"), "tp": tp,
})

_HTTP_CASES = [
    "test_predict_endpoint",
    "test_classification_distribution_endpoint",
    "test_feature_importance_endpoint",
    "test_train_endpoint_writes_input",
    "test_bad_datum_is_400",
]
_CASES = [
    "test_tree_navigation_and_prediction",
    "test_tree_missing_feature_follows_default",
    "test_find_by_id",
    "test_numeric_prediction_running_mean",
    "test_categorical_prediction_counts",
    "test_weighted_vote",
    "test_forest_train_classification_separable",
    "test_forest_train_integer_threshold_tie_routing",
    "test_forest_train_regression",
    "test_forest_train_categorical_feature",
    "test_pmml_round_trip_classification",
    "test_pmml_single_tree_is_bare_treemodel",
    "test_validate_rejects_wrong_schema",
    "test_rdf_update_build_and_evaluate_classification",
    "test_rdf_update_regression",
    "test_rdf_update_hyperparams_from_config",
    "test_speed_manager_emits_leaf_stats",
    "test_speed_manager_regression_update_format",
    "test_serving_manager_up_updates_leaf",
    "test_rdf_categorical_predictor_end_to_end",
]


def test_every_reference_case_is_mirrored():
    mirrored = sorted(_CASES + _HTTP_CASES)
    assert len(mirrored) == 25
    assert mirrored == sorted(n for n in _RDF if n.startswith("test_"))


@pytest.mark.parametrize("case", _CASES)
def test_reference_case_on_the_port(case):
    _RDF[case]()


@pytest.fixture()
def rdf_serving():
    """The reference's fixture on the port: its model on the port's
    ``memory:`` update topic, a port ``ServingLayer`` on the CPU."""
    tp.reset_memory_brokers()
    port = ioutils.choose_free_port()
    config = _RDF["_cls_config"]({
        "oryx.serving.api.port": port,
        "oryx.serving.model-manager-class": RDF_MANAGER,
        "oryx.serving.application-resources": RDF_RESOURCES,
    })
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    tp.TopicProducerImpl("memory:", "OryxUpdate").send(
        "MODEL", _RDF["_published_model_message"]())
    layer = ServingLayer(config, device="cpu")
    layer.start()
    client = _Client(port)
    try:
        _wait_ready(client)
        yield client, config
    finally:
        layer.close()
        tp.reset_memory_brokers()


@pytest.mark.parametrize("case", _HTTP_CASES)
def test_reference_http_case_on_the_port(case, rdf_serving):
    _RDF[case](rdf_serving)


# -- parity with the reference --------------------------------------------------


def _mixed_data(seed: int, n: int = 1500):
    """Four numeric predictors (rounded, so quantile thresholds tie with
    values) and two 3-valued categorical ones."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(size=(n, 4)).round(2),
                        rng.integers(0, 3, size=(n, 2))], axis=1).astype(np.float64)
    return X, [False] * 4 + [True] * 2, [0] * 4 + [3] * 2, rng


def _same_trees(ref_trees, port_trees, mean_rel: float = 0.0) -> int:
    """Asserts the two forests equal node for node; returns the node count."""
    n = 0
    stack = list(zip(ref_trees, port_trees))
    while stack:
        a, b = stack.pop()
        n += 1
        assert (a.id, a.count) == (b.id, b.count)
        assert (a.split is None) == (b.split is None), a.id
        if a.split is not None:
            assert dataclasses.astuple(a.split) == dataclasses.astuple(b.split), a.id
            stack += [(a.negative, b.negative), (a.positive, b.positive)]
        elif a.class_counts is not None:
            assert np.array_equal(a.class_counts, b.class_counts), a.id
        else:
            assert a.n == b.n, a.id
            assert abs(a.mean - b.mean) <= mean_rel * abs(a.mean), a.id
    return n


def _both(X, y, is_cat, n_cat, seed, **kw):
    ref = ref_train.forest_train(X, y, is_cat, n_cat,
                                 rng=np.random.default_rng(seed), **kw)
    timings, levels = {}, []
    port = rdftrain.forest_train(X, y, is_cat, n_cat,
                                 rng=np.random.default_rng(seed), device="cpu",
                                 timings=timings, levels_out=levels, **kw)
    assert timings["host_syncs"] == timings["levels"] == sum(map(len, levels))
    return ref, port


@pytest.mark.parametrize("impurity", ["entropy", "gini"])
@pytest.mark.parametrize("num_trees", [1, 4])
def test_forest_train_classification_equals_the_reference(impurity, num_trees):
    X, is_cat, n_cat, rng = _mixed_data(11)
    y = ((X[:, 0] > 0.2).astype(int) + (X[:, 4] == 1) + (X[:, 1] > 1)
         + (rng.random(len(X)) < 0.1)).astype(np.int64)
    (ref_trees, ref_imp), (trees, imp) = _both(
        X, y, is_cat, n_cat, 7, task="classification", n_classes=5,
        num_trees=num_trees, max_depth=5, max_split_candidates=16,
        impurity=impurity, min_node_size=2, min_info_gain_nats=0.0)
    assert _same_trees(ref_trees, trees) > 10 * num_trees
    assert np.abs(np.asarray(ref_imp) - imp).max() <= 1e-12


def test_forest_train_regression_with_integer_targets_equals_the_reference():
    """Integer targets: every float32 sum of the reference is exact, so the
    leaf means are equal, not close."""
    X, is_cat, n_cat, rng = _mixed_data(12)
    y = (rng.integers(0, 10, len(X)) + 5 * (X[:, 0] > 0)
         + 3 * (X[:, 5] == 2)).astype(np.float64)
    (ref_trees, ref_imp), (trees, imp) = _both(
        X, y, is_cat, n_cat, 8, task="regression", num_trees=3, max_depth=5,
        max_split_candidates=16, min_node_size=2)
    assert _same_trees(ref_trees, trees) > 30
    assert np.abs(np.asarray(ref_imp) - imp).max() <= 1e-12


def test_forest_train_regression_with_float_targets_equals_the_reference():
    """Float targets: the same structure, leaf means within 1e-5 relative
    (the port sums in fixed point, the reference in float32)."""
    X, is_cat, n_cat, rng = _mixed_data(13)
    y = rng.normal(size=len(X)) + 3 * (X[:, 0] > 0) + X[:, 1] + 2 * (X[:, 4] == 0)
    (ref_trees, ref_imp), (trees, imp) = _both(
        X, y, is_cat, n_cat, 9, task="regression", num_trees=3, max_depth=5,
        max_split_candidates=16, min_node_size=2)
    assert _same_trees(ref_trees, trees, mean_rel=1e-5) > 30
    assert np.abs(np.asarray(ref_imp) - imp).max() <= 1e-12


def test_fixed_point_sums_are_exact_and_bounded():
    """The regression channels' fixed point: integers stay integers, the
    magnitudes' sum stays below 2^61 whatever the scale, and sums in any
    order are equal."""
    rng = np.random.default_rng(5)
    for values in (np.arange(-50, 50, dtype=np.float32),
                   rng.normal(size=10_000).astype(np.float32) * 1e-20,
                   rng.normal(size=10_000).astype(np.float32) * 1e20,
                   np.zeros(7, dtype=np.float32)):
        q, scale = rdftrain._fixed_point(values)
        assert int(np.abs(q).sum()) < 2 ** 62
        assert np.all(np.abs(q * scale - values.astype(np.float64))
                      <= 0.5 * scale + 1e-7 * np.abs(values))
        order = rng.permutation(len(q))
        assert int(q.sum()) == int(q[order].sum())
    q, scale = rdftrain._fixed_point(np.arange(10, dtype=np.float32))
    assert np.array_equal(q * scale, np.arange(10))


def _rdf_config(mod, target_numeric: bool, extra=None):
    over = {
        "oryx.input-schema.feature-names": ["a", "b", "color", "label"],
        "oryx.input-schema.categorical-features":
            ["color"] if target_numeric else ["color", "label"],
        "oryx.input-schema.target-feature": "label",
        "oryx.rdf.num-trees": 3,
        "oryx.ml.eval.test-fraction": 0.25,
        **(extra or {}),
    }
    return mod.overlay_on(over, mod.get_default())


def _rdf_lines(seed: int, n: int, regression: bool) -> list:
    rng = np.random.default_rng(seed)
    colors = ["red", "green", "blue"]
    out = []
    for _ in range(n):
        a, b = rng.uniform(-5, 5, 2)
        c = colors[rng.integers(3)]
        if regression:
            # integer targets: both packages' sums are exact, so their leaf
            # means (and PMML) are equal
            label = str(round(a * 2 + (c == "red") * 3 + rng.normal(0, 0.5)))
        else:
            label = "hi" if a > b or (c == "red" and rng.random() < 0.3) else "lo"
        out.append(f"{a:.3f},{b:.3f},{c},{label}")
    return out


_TIMESTAMP = re.compile(r"<Timestamp>[^<]*</Timestamp>")


def _models(regression: bool, lines: list):
    """Both packages' ``build_model`` on the same lines under the test seed."""
    params = [16, 5, "variance" if regression else "entropy", 2, 0.0]
    ref_rand.use_test_seed()
    ref_pmml = RefRDFUpdate(_rdf_config(ref_cfg, regression)).build_model(
        None, [RefKeyMessage(None, ln) for ln in lines], params, None)
    rand.use_test_seed()
    pmml = RDFUpdate(_rdf_config(cfg, regression), device="cpu").build_model(
        None, [KeyMessage(None, ln) for ln in lines], params, None)
    return ref_pmml, pmml


@pytest.mark.parametrize("regression", [False, True])
def test_update_model_pmml_and_evaluation_equal_the_reference(regression):
    """``RDFUpdate.build_model`` under the test seed writes the same PMML
    apart from its ``Timestamp``; each package's ``evaluate`` scores either
    package's model the same."""
    lines = _rdf_lines(21 + regression, 400, regression)
    ref_pmml, pmml = _models(regression, lines[:300])
    ref_text, text = ref_pmmlutils.to_string(ref_pmml), pmmlutils.to_string(pmml)
    assert _TIMESTAMP.sub("", ref_text) == _TIMESTAMP.sub("", text)
    assert "<Timestamp>" in text
    ref_update = RefRDFUpdate(_rdf_config(ref_cfg, regression))
    update = RDFUpdate(_rdf_config(cfg, regression), device="cpu")
    test = lines[300:]
    want = ref_update.evaluate(None, ref_pmml, None,
                               [RefKeyMessage(None, ln) for ln in test], [])
    for model_text in (ref_text, text):
        got = update.evaluate(None, pmmlutils.from_string(model_text), None,
                              [KeyMessage(None, ln) for ln in test], [])
        assert got == want


def test_forest_to_pmml_equals_the_reference():
    """The codec alone, on each package's trees from one seed."""
    X, _, _, rng = _mixed_data(14, 600)
    X = X[:, [0, 1, 4]]
    y = ((X[:, 0] > X[:, 1]) + (X[:, 2] == 1)).astype(np.int64)
    kw = dict(task="classification", n_classes=3, num_trees=2, max_depth=4,
              max_split_candidates=8, impurity="gini")
    (ref_trees, ref_imp), (trees, imp) = _both(
        X, y, [False, False, True], [0, 0, 3], 3, **kw)
    names = {"oryx.input-schema.feature-names": ["a", "b", "c", "label"],
             "oryx.input-schema.categorical-features": ["c", "label"],
             "oryx.input-schema.target-feature": "label"}
    values = {2: ["x", "y", "z"], 3: ["n0", "n1", "n2"]}
    ref_text = ref_pmmlutils.to_string(ref_codec.forest_to_pmml(
        ref_trees, ref_imp, RefInputSchema(ref_cfg.overlay_on(names, ref_cfg.get_default())),
        RefEncodings(values), max_depth=4, max_split_candidates=8, impurity="gini"))
    text = pmmlutils.to_string(pmml_codec.forest_to_pmml(
        trees, imp, InputSchema(cfg.overlay_on(names, cfg.get_default())),
        CategoricalValueEncodings(values), max_depth=4, max_split_candidates=8,
        impurity="gini"))
    assert _TIMESTAMP.sub("", ref_text) == _TIMESTAMP.sub("", text)


def _streams(regression: bool, lines: list, micro: list) -> dict:
    """Each package's ``MODEL`` + speed ``UP`` stream from the same lines;
    the ``UP`` lists are byte-equal."""
    ref_pmml, pmml = _models(regression, lines)
    out = {}
    for name, text, speed, km in (
            ("ref", ref_pmmlutils.to_string(ref_pmml),
             RefSpeedManager(_rdf_config(ref_cfg, regression)), RefKeyMessage),
            ("port", pmmlutils.to_string(pmml),
             RDFSpeedModelManager(_rdf_config(cfg, regression)), KeyMessage)):
        speed.consume_key_message("MODEL", text)
        ups = speed.build_updates([km(None, ln) for ln in micro])
        out[name] = [("MODEL", text)] + [("UP", u) for u in ups]
    return out



@pytest.mark.parametrize("regression", [False, True])
def test_speed_updates_are_byte_equal_and_serve_the_same(regression):
    """Both speed managers turn the same ``MODEL`` and microbatch into the
    same ``UP`` strings; either package's stream gives the same predictions
    (and class distributions) in both packages' serving managers."""
    lines = _rdf_lines(31 + regression, 360, regression)
    streams = _streams(regression, lines[:240], lines[240:])
    assert [m for k, m in streams["ref"] if k == "UP"] == \
        [m for k, m in streams["port"] if k == "UP"]
    assert len(streams["port"]) > 3
    queries = [ln[:ln.rindex(",") + 1] for ln in _rdf_lines(41, 50, regression)]
    for stream in streams.values():
        ref_manager = RefServingManager(_rdf_config(ref_cfg, regression))
        manager = RDFServingModelManager(_rdf_config(cfg, regression))
        for key, message in stream:
            ref_manager.consume_key_message(key, message)
            manager.consume_key_message(key, message)
        for q in queries:
            tokens = q.split(",")
            assert manager.get_model().predict(tokens) == \
                ref_manager.get_model().predict(tokens)
            if not regression:
                assert np.array_equal(
                    manager.get_model().make_prediction(tokens).category_probabilities,
                    ref_manager.get_model().make_prediction(tokens).category_probabilities)


def _layer_answers(layer_cls, topic_mod, config_mod, manager, resources,
                   stream, queries, **kw) -> list:
    topic_mod.reset_memory_brokers()
    port = ioutils.choose_free_port()
    config = _rdf_config(config_mod, False, {
        "oryx.serving.api.port": port,
        "oryx.serving.model-manager-class": manager,
        "oryx.serving.application-resources": resources})
    topic_mod.maybe_create_topics(config, "input-topic", "update-topic")
    producer = topic_mod.TopicProducerImpl("memory:", "OryxUpdate")
    for key, message in stream:
        producer.send(key, message)
    layer = layer_cls(config, **kw)
    layer.start()
    client = _Client(port)
    try:
        _wait_ready(client)
        deadline = time.monotonic() + 30
        while layer.manager.get_model() is None or layer._metered_updates is None \
                or layer._metered_updates._consumed < len(stream):
            assert time.monotonic() < deadline, "the layer never applied the stream"
            time.sleep(0.02)
        answers = []
        for q in queries:
            for path in (f"/predict/{q}", f"/classificationDistribution/{q}"):
                r = client.get(path)
                answers.append((path, r.status_code, r.content))
        r = client.post("/predict", "\n".join(queries))
        answers.append(("POST /predict", r.status_code, r.content))
        for path in ("/feature/importance", "/feature/importance/1",
                     "/predict/x,y,red,"):
            r = client.get(path)
            answers.append((path, r.status_code, r.content))
        return answers
    finally:
        layer.close()
        topic_mod.reset_memory_brokers()


def test_either_stream_answers_the_same_over_both_serving_layers():
    """One request list against both packages' ``ServingLayer``s, each fed
    either package's ``MODEL`` + ``UP`` stream on its own ``memory:``
    broker: the same statuses and bodies."""
    lines = _rdf_lines(51, 300, False)
    streams = _streams(False, lines[:220], lines[220:])
    queries = [ln[:ln.rindex(",") + 1] for ln in _rdf_lines(52, 20, False)]
    for stream in streams.values():
        want = _layer_answers(RefServingLayer, ref_tp, ref_cfg, REF_RDF_MANAGER,
                              REF_RDF_RESOURCES, stream, queries)
        got = _layer_answers(ServingLayer, tp, cfg, RDF_MANAGER, RDF_RESOURCES,
                             stream, queries, device="cpu")
        assert got == want
        assert [s for _, s, _ in got].count(200) == len(got) - 1  # x,y is a 400


# -- chip_smoke.py's rdf phase on the CPU ----------------------------------------


def test_smoke_rdf_phase_at_a_small_size(monkeypatch):
    """``chip_smoke.rdf_phase`` (trainer twice and against the CPU,
    regression bits, the generation, speed ``UP``s, the HTTP app) and the
    one-tree profile window on 24,000 covtype-shaped rows, 4 trees of depth
    6 (the generation on the first 20,000), every check as strict as on the
    card; the card-only calls (device
    memory, synchronize) stand in as no-ops."""
    import chip_smoke as cs
    from oryx_tpu_torch.ml import mlupdate
    from oryx_tpu_torch.serving import app as serving_app

    cpu = torch.device("cpu")
    for mod in (cs, rdftrain, mlupdate, serving_app):
        monkeypatch.setattr(mod, "resolve", lambda device=None: cpu)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    sizes = dict(RDF_ROWS=24_000, RDF_CPU_ROWS=24_000, RDF_TREES=4,
                 RDF_DEPTH=6, RDF_LINES=20_000, RDF_MICROBATCH=1_000,
                 RDF_HTTP_PREDICT=100, RDF_HTTP_DISTRIBUTION=10)
    for name, value in sizes.items():
        monkeypatch.setattr(cs, name, value)
    tp.reset_memory_brokers()
    try:
        data = cs.covtype_data(np.random.default_rng(cs.SEED + 19), 24_000)
        levels = cs.rdf_tree_window(data, cpu)()
        assert 1 < len(levels) <= 7
        out = cs.rdf_phase(data, cpu, np.random.default_rng(3))
    finally:
        tp.reset_memory_brokers()
    train = out["train"]
    assert train["held_against_cpu"]["first_difference"] is None
    assert train["regression"]["equal_bits"]
    assert train["regression"]["held_against_cpu"]["first_difference"] is None
    assert train["timed"]["host_syncs"] == train["timed"]["levels"]
    assert out["generation"]["accuracy"] >= 0.90
    assert out["http"]["statuses"] == {200: 112}
    assert not any(out["launches"].values())
