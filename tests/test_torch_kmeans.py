"""The port's k-means family against the reference's, on the same inputs.

* the Lloyd trainer from the same starting centres (injected through
  ``oryx_tpu_torch.state``: ``jax.random`` streams cannot be reproduced in
  torch) and the IVF fit's pieces;
* the host modules copied from the reference (config, schema, PMML codec,
  evaluation metrics) give the same answers;
* ``KMeansUpdate`` and the speed and serving managers behave like the
  reference's on planted blobs, down to the bytes of the ``UP`` messages.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from oryx_tpu.api.keymessage import KeyMessage as RefKeyMessage
from oryx_tpu.common import config as ref_cfg
from oryx_tpu.common import rand as ref_rand
from oryx_tpu.models import pmml_common as ref_pmml_common
from oryx_tpu.models.kmeans import evaluate as ref_eval
from oryx_tpu.models.kmeans import pmml_codec as ref_codec
from oryx_tpu.models.kmeans import train as ref_train
from oryx_tpu.models.kmeans.model import ClusterInfo as RefClusterInfo
from oryx_tpu.models.kmeans.serving import KMeansServingModelManager as RefServing
from oryx_tpu.models.kmeans.speed import KMeansSpeedModelManager as RefSpeed
from oryx_tpu.models.kmeans.update import KMeansUpdate as RefUpdate
from oryx_tpu.models.schema import InputSchema as RefSchema
from oryx_tpu.pmml import pmmlutils as ref_pmmlutils
from oryx_tpu_torch import state
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import rand
from oryx_tpu_torch.ml import mlupdate
from oryx_tpu_torch.models import pmml_common
from oryx_tpu_torch.models.kmeans import evaluate as kmeval
from oryx_tpu_torch.models.kmeans import pmml_codec
from oryx_tpu_torch.models.kmeans import train as kmtrain
from oryx_tpu_torch.models.kmeans.model import ClusterInfo
from oryx_tpu_torch.models.kmeans.serving import KMeansServingModelManager
from oryx_tpu_torch.models.kmeans.speed import KMeansSpeedModelManager
from oryx_tpu_torch.models.kmeans.update import KMeansUpdate
from oryx_tpu_torch.models.schema import InputSchema
from oryx_tpu_torch.ops import kernels as K
from oryx_tpu_torch.pmml import pmmlutils

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

_BLOB_CENTERS = ((0, 0), (10, 10), (-10, 6))


def _overrides(extra=None):
    over = {
        "oryx.input-schema.num-features": 2,
        "oryx.input-schema.categorical-features": [],
        "oryx.kmeans.hyperparams.k": 3,
        "oryx.kmeans.runs": 2,
        "oryx.kmeans.iterations": 10,
    }
    over.update(extra or {})
    return over


def _configs(extra=None):
    """The same overrides on each package's defaults: (reference, port)."""
    over = _overrides(extra)
    return (ref_cfg.overlay_on(over, ref_cfg.get_default()),
            cfg.overlay_on(over, cfg.get_default()))


def _blobs(n_per=60, centers=_BLOB_CENTERS, seed=7):
    """test_kmeans.py's planted blobs."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(c, 0.5, size=(n_per, 2)) for c in centers])
    rng.shuffle(pts)
    return pts


def _planted(n=900, k=6, d=4, seed=11):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-10, 10, (k, d))
    pts = means[rng.integers(0, k, n)] + rng.standard_normal((n, d)) * 0.5
    return pts.astype(np.float32), means


def _match(got, want):
    """Row order of ``got`` that puts each row nearest the same row of
    ``want`` (a permutation, or the test fails)."""
    order = np.linalg.norm(want[:, None, :] - got[None, :, :], axis=2).argmin(1)
    assert sorted(order.tolist()) == list(range(len(want)))
    return order


# -- trainer ------------------------------------------------------------------


@pytest.mark.parametrize("init", [kmtrain.INIT_KMEANS_PARALLEL, kmtrain.INIT_RANDOM])
def test_lloyd_run_from_injected_centres_matches_reference(init):
    """Both packages from the reference's own starting centres: the port's
    ``kmeans_train`` (its sweep kernel's plain version on the CPU) against
    the reference's ``_lloyd_from``. Centres 1e-4 (float32 sums in another
    order), counts exact (same assignment)."""
    pts, _ = _planted(n=700, k=7, d=5, seed=3)
    k, iterations = 7, 6
    c0 = np.array(ref_train._init_centers(jax.random.PRNGKey(5),
                                            jax.numpy.asarray(pts), k, init),
                    dtype=np.float32)
    r_centers, r_counts, _ = ref_train._lloyd_from(jax.numpy.asarray(pts),
                                                   jax.numpy.asarray(c0), k,
                                                   iterations)
    centers, counts = kmtrain.kmeans_train(
        pts, k, iterations=iterations, runs=1,
        init_centers=state.kmeans_centers(c0, device="cpu"), device="cpu")
    np.testing.assert_allclose(centers.astype(np.float32),
                               np.asarray(r_centers, dtype=np.float32),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(counts, np.asarray(r_counts).astype(np.int64))
    # the plain-torch sweeps of the IVF fit, from the same centres
    p_centers, p_counts, p_assign = kmtrain._lloyd_from(
        torch.from_numpy(pts), torch.from_numpy(c0), iterations)
    np.testing.assert_allclose(p_centers.numpy(),
                               np.asarray(r_centers, dtype=np.float32),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(p_counts.numpy(), np.asarray(r_counts))


def test_restarts_take_the_lowest_cost_first_on_a_tie():
    """Three runs from given centres: a bad start, a good one, the same good
    one again; the good run wins and the result is the first of the tie."""
    pts = _blobs().astype(np.float32)
    good = np.asarray(_BLOB_CENTERS, np.float32) + 0.3
    bad = np.asarray([[0, 0], [0.1, 0], [0.2, 0]], np.float32)
    centers, counts = kmtrain.kmeans_train(
        pts, 3, iterations=0, runs=3, init_centers=np.stack([bad, good, good]),
        device="cpu")
    np.testing.assert_array_equal(centers, good.astype(np.float64))
    assert counts.tolist() == [60, 60, 60]
    with pytest.raises(ValueError, match="init_centers"):
        kmtrain.kmeans_train(pts, 3, runs=2, init_centers=np.stack([good] * 3),
                             device="cpu")


def test_reseed_empty_is_bit_identical():
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((200, 3)).astype(np.float32)
    centers = rng.standard_normal((6, 3)).astype(np.float32)
    assign = rng.integers(0, 4, 200)  # clusters 4 and 5 are empty
    counts = np.bincount(assign, minlength=6).astype(np.float32)
    got = kmtrain._reseed_empty(pts, centers, counts, assign)
    want = ref_train._reseed_empty(pts, centers, counts, assign)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, centers)


def test_fit_index_centroids_is_deterministic_with_no_dead_cells():
    pts, means = _planted(n=900, k=6, d=4)
    a = kmtrain.fit_index_centroids(pts, 6, iterations=10, seed=3, device="cpu")
    b = kmtrain.fit_index_centroids(pts, 6, iterations=10, seed=3, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    centers, counts, assign = a
    assert centers.dtype == np.float32 and counts.dtype == np.int64
    assert assign.dtype == np.int32 and assign.shape == (900,)
    assert (counts > 0).all() and counts.sum() == 900
    np.testing.assert_array_equal(np.bincount(assign, minlength=6), counts)
    # 12 cells over 12 distinct points, five copies each: every cell used
    few = np.repeat(pts[:12], 5, axis=0)
    _, counts, _ = kmtrain.fit_index_centroids(few, 12, seed=0, device="cpu")
    assert (counts > 0).all()


@pytest.mark.parametrize("init", [kmtrain.INIT_KMEANS_PARALLEL, kmtrain.INIT_RANDOM])
def test_seeding_picks_distinct_data_points(init):
    pts, _ = _planted(n=300, k=5, d=3, seed=8)
    g = torch.Generator().manual_seed(9)
    centers = kmtrain._init_centers(g, torch.from_numpy(pts), 12, init).numpy()
    rows = {tuple(r) for r in pts.tolist()}
    assert all(tuple(c) in rows for c in centers.tolist())
    assert len({tuple(c) for c in centers.tolist()}) == 12


def test_kmeans_train_recovers_the_reference_centres():
    """test_kmeans.py's blobs: both trainers find the three blob centres;
    matched by nearest centre, they agree to 1e-6 (the same fixed point)."""
    pts = _blobs()
    r_centers, r_counts = ref_train.kmeans_train(pts, 3, iterations=15, runs=2,
                                                 key=jax.random.PRNGKey(0))
    centers, counts = kmtrain.kmeans_train(
        pts, 3, iterations=15, runs=2, generator=torch.Generator().manual_seed(0),
        device="cpu")
    assert centers.dtype == np.float64 and counts.dtype == np.int64
    order = _match(centers, r_centers)
    np.testing.assert_allclose(centers[order], r_centers, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(counts[order], r_counts)
    assert counts.sum() == len(pts)


def test_kmeans_train_clamps_k_and_rejects_no_points():
    pts = np.asarray([[0.0, 0.0], [1.0, 1.0]])
    centers, counts = kmtrain.kmeans_train(pts, 5, init=kmtrain.INIT_RANDOM,
                                           device="cpu")
    assert len(centers) == 2 and counts.tolist() == [1, 1]
    with pytest.raises(ValueError, match="no points"):
        kmtrain.kmeans_train(np.zeros((0, 2)), 3, device="cpu")


# -- copied host modules -----------------------------------------------------


def test_default_config_equals_the_reference():
    assert cfg.get_default().as_dict() == ref_cfg.get_default().as_dict()
    ref, port = _configs({"oryx.kmeans.hyperparams.k": [2, 4]})
    assert port.as_dict() == ref.as_dict()
    kmeans = cfg.get_default().get_config("oryx.kmeans")
    assert (kmeans.get_int("iterations"), kmeans.get_int("runs"),
            kmeans.get_string("initialization-strategy"),
            kmeans.get_string("evaluation-strategy"),
            kmeans.get_int("hyperparams.k")) == (30, 3, "k-means||",
                                                 "SILHOUETTE", 10)


def test_input_schema_and_features_agree():
    extra = {
        "oryx.input-schema.feature-names": ["id", "a", "b", "c", "label"],
        "oryx.input-schema.id-features": ["id"],
        "oryx.input-schema.ignored-features": ["c"],
        "oryx.input-schema.numeric-features": ["a", "b"],
        "oryx.input-schema.categorical-features": None,
        "oryx.input-schema.target-feature": "label",
    }
    ref_conf, conf = _configs(extra)
    ref_schema, schema = RefSchema(ref_conf), InputSchema(conf)
    for attr in ("feature_names", "id_features", "active_features",
                 "numeric_features", "categorical_features", "target_feature",
                 "target_feature_index", "num_features", "num_predictors"):
        assert getattr(schema, attr) == getattr(ref_schema, attr), attr
    tokens = ["x", "1.5", "2.5", "9", "pos"]
    np.testing.assert_array_equal(
        pmml_common.features_from_tokens(tokens, schema),
        ref_pmml_common.features_from_tokens(tokens, ref_schema))
    with pytest.raises(IndexError):
        pmml_common.features_from_tokens(tokens + ["extra"], schema)


def _clusters(cls, centers, counts):
    return [cls(i, c, n) for i, (c, n) in enumerate(zip(centers, counts))]


def test_pmml_written_by_either_package_reads_in_the_other():
    ref_conf, conf = _configs()
    centers = np.asarray([[1.5, -2.0], [0.0, 4.25], [1e-7, 3.0]])
    counts = [10, 20, 0]
    mine = pmmlutils.to_string(pmml_codec.clustering_model_to_pmml(
        _clusters(ClusterInfo, centers, counts), InputSchema(conf)))
    theirs = ref_pmmlutils.to_string(ref_codec.clustering_model_to_pmml(
        _clusters(RefClusterInfo, centers, counts), RefSchema(ref_conf)))
    for text in (mine, theirs):
        ref_codec.validate_pmml_vs_schema(ref_pmmlutils.from_string(text),
                                          RefSchema(ref_conf))
        pmml_codec.validate_pmml_vs_schema(pmmlutils.from_string(text),
                                           InputSchema(conf))
        for back in (ref_codec.read(ref_pmmlutils.from_string(text)),
                     pmml_codec.read(pmmlutils.from_string(text))):
            assert [c.id for c in back] == [0, 1, 2]
            assert [c.count for c in back] == counts
            np.testing.assert_array_equal(np.stack([c.center for c in back]),
                                          centers)
    # the same document but for the header's timestamp
    strip = [ln for ln in mine.split("><") if not ln.startswith("Timestamp")]
    assert strip == [ln for ln in theirs.split("><")
                     if not ln.startswith("Timestamp")]
    model = state.kmeans_serving_model(pmmlutils.from_string(theirs),
                                       InputSchema(conf))
    assert model.nearest_cluster(np.asarray([0.0, 4.0]))[0] == 1


@pytest.mark.parametrize("metric", ["sum_squared_error", "davies_bouldin_index",
                                    "dunn_index", "silhouette_coefficient"])
def test_evaluation_metrics_equal_the_reference(metric):
    """float64 host code on both sides: 1e-12 relative."""
    pts = _blobs(n_per=50)
    centers = np.asarray(_BLOB_CENTERS, np.float64) + 0.2
    got = getattr(kmeval, metric)(_clusters(ClusterInfo, centers, [1] * 3), pts)
    want = getattr(ref_eval, metric)(_clusters(RefClusterInfo, centers, [1] * 3),
                                     pts)
    assert got == pytest.approx(want, rel=1e-12)
    # the silhouette's sample past its cap: the same draw under the test seed
    if metric == "silhouette_coefficient":
        rand.use_test_seed()
        ref_rand.use_test_seed()
        got = kmeval.silhouette_coefficient(
            _clusters(ClusterInfo, centers, [1] * 3), pts, max_sample=40)
        want = ref_eval.silhouette_coefficient(
            _clusters(RefClusterInfo, centers, [1] * 3), pts, max_sample=40)
        assert got == pytest.approx(want, rel=1e-12)


# -- entry points --------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["SILHOUETTE", "DAVIES_BOULDIN", "DUNN", "SSE"])
def test_update_build_and_evaluate_match_the_reference(strategy):
    """Planted blobs: both packages' models hold the three blob centres
    (matched by nearest centre: 1e-6, sizes exact), and each package's
    ``evaluate`` scores either model to 1e-12."""
    extra = {"oryx.kmeans.evaluation-strategy": strategy}
    ref_conf, conf = _configs(extra)
    lines = [f"{p[0]},{p[1]}" for p in _blobs(n_per=40)]
    train = [KeyMessage(None, ln) for ln in lines[:100]]
    test = [KeyMessage(None, ln) for ln in lines[100:]]
    ref_train_msgs = [RefKeyMessage(None, ln) for ln in lines[:100]]
    ref_test_msgs = [RefKeyMessage(None, ln) for ln in lines[100:]]
    update, ref_update = KMeansUpdate(conf, device="cpu"), RefUpdate(ref_conf)
    assert [h.get_trial_values(1) for h in update.get_hyper_parameter_values()] == \
        [h.get_trial_values(1) for h in ref_update.get_hyper_parameter_values()]
    pmml = update.build_model(None, train, [3], None)
    ref_pmml = ref_update.build_model(None, ref_train_msgs, [3], None)
    mine, theirs = pmml_codec.read(pmml), ref_codec.read(ref_pmml)
    got = np.stack([c.center for c in mine])
    want = np.stack([c.center for c in theirs])
    order = _match(got, want)
    np.testing.assert_allclose(got[order], want, rtol=1e-6, atol=1e-6)
    assert [mine[i].count for i in order] == [c.count for c in theirs]
    assert sum(c.count for c in mine) == 100
    ref_doc = ref_pmmlutils.from_string(pmmlutils.to_string(ref_pmml))
    for model in (pmml, pmmlutils.from_string(pmmlutils.to_string(ref_pmml))):
        val = update.evaluate(None, model, None, test, train)
        ref_val = ref_update.evaluate(None, ref_doc if model is not pmml else
                                      ref_pmmlutils.from_string(
                                          pmmlutils.to_string(pmml)),
                                      None, ref_test_msgs, ref_train_msgs)
        assert val == pytest.approx(ref_val, rel=1e-12)
    if strategy == "SSE":
        assert val < 0  # lower-better metrics are negated
    assert update.build_model(None, [], [3], None) is None
    assert update.evaluate(None, pmml, None, [], []) is None


def test_update_rejects_what_the_reference_rejects():
    for extra in ({"oryx.kmeans.runs": 0},
                  {"oryx.kmeans.initialization-strategy": "nope"},
                  {"oryx.kmeans.evaluation-strategy": "nope"},
                  {"oryx.input-schema.categorical-features": ["0"]}):
        ref_conf, conf = _configs(extra)
        with pytest.raises(ValueError):
            RefUpdate(ref_conf)
        with pytest.raises(ValueError):
            KMeansUpdate(conf, device="cpu")


def _model_message(schema, codec, cluster_cls):
    clusters = [cluster_cls(0, np.asarray([0.0, 0.0]), 10),
                cluster_cls(1, np.asarray([10.0, 10.0]), 10),
                cluster_cls(2, np.asarray([-10.0, 6.0]), 4)]
    return codec.clustering_model_to_pmml(clusters, schema)


def test_speed_updates_are_byte_equal_and_serving_applies_them_identically():
    ref_conf, conf = _configs()
    ref_msg = ref_pmmlutils.to_string(
        _model_message(RefSchema(ref_conf), ref_codec, RefClusterInfo))
    msg = pmmlutils.to_string(
        _model_message(InputSchema(conf), pmml_codec, ClusterInfo))
    lines = [f"{p[0]},{p[1]}" for p in _blobs(n_per=20, seed=12)]
    lines += ["bad,datum", '["1.5", "2.5"]']
    speed, ref_speed = KMeansSpeedModelManager(conf), RefSpeed(ref_conf)
    assert speed.build_updates([]) == []
    speed.consume([KeyMessage("MODEL", ref_msg), KeyMessage("UP", "[0,[0,0],5]")])
    ref_speed.consume([RefKeyMessage("MODEL", msg)])
    ups = speed.build_updates([KeyMessage(None, ln) for ln in lines])
    ref_ups = ref_speed.build_updates([RefKeyMessage(None, ln) for ln in lines])
    assert len(ups) == 3 and ups == ref_ups
    assert sum(json.loads(u)[2] for u in ups) == 24 + 61

    serving, ref_serving = KMeansServingModelManager(conf), RefServing(ref_conf)
    assert serving.get_model() is None
    serving.consume_key_message("UP", ups[0])  # before a model: ignored
    for mgr in (serving, ref_serving):
        mgr.consume_key_message("MODEL", msg)
        for u in ups:
            mgr.consume_key_message("UP", u)
    got, want = serving.get_model().clusters, ref_serving.get_model().clusters
    assert [(c.id, c.count) for c in got] == [(c.id, c.count) for c in want]
    np.testing.assert_array_equal(np.stack([c.center for c in got]),
                                  np.stack([c.center for c in want]))
    by_id = {c.id: c for c in speed.model.clusters}
    for c in got:
        assert c.count == by_id[c.id].count
        np.testing.assert_array_equal(c.center, by_id[c.id].center)
    for q in ([9.0, 9.0], [-9.0, 5.0], [0.4, -0.3]):
        assert serving.get_model().nearest_cluster(np.asarray(q)) == \
            ref_serving.get_model().nearest_cluster(np.asarray(q))
    with pytest.raises(ValueError, match="bad key"):
        serving.consume_key_message("NOPE", "")


def test_model_ref_reads_a_file_and_a_missing_path_raises(tmp_path):
    _, conf = _configs()
    path = tmp_path / "model.pmml"
    pmmlutils.write(_model_message(InputSchema(conf), pmml_codec, ClusterInfo),
                    path)
    mgr = KMeansServingModelManager(conf)
    mgr.consume_key_message("MODEL-REF", str(path))
    assert len(mgr.get_model().clusters) == 3
    with pytest.raises(mlupdate.MissingModelError):
        mgr.consume_key_message("MODEL-REF", str(tmp_path / "missing.pmml"))


def test_sweep_entry_point_counts_no_launch_on_the_cpu():
    """The trainer's sweeps on CPU tensors run the plain version."""
    K.reset_launches()
    kmtrain.kmeans_train(_blobs(), 3, iterations=2, runs=2, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    assert K.LAUNCHES["kmeans_assign_accumulate"] == 0
