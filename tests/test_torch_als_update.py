"""The port's ALS generation (``ALSUpdate`` behind ``MLUpdate``) and its
serving manager against the reference's, at a small size.

* ``pmml_codec``: the same arrays give the same PMML text (creation time
  aside) and the same decompressed part files; each package reads the
  other's;
* ``ALSUpdate``: the time-ordered split is exact; ``build_model`` from an
  injected Y₀ publishes X/Y within relative 1e-3 (the bound
  ``test_torch_als_train.py`` uses: two alternations of float32 solves in
  another summation order); ``evaluate`` on a reference-written model dir
  gives AUC and −RMSE within 1e-6 (the same factors and, under the test
  seed, the same sampled negatives; only float32 dot products of k terms
  in another order differ); the ``UP`` stream is byte-equal;
* ``ALSServingModelManager``: each package's published stream, fed to both
  managers, gives the same top-N ids (scores within 1e-5, as in
  ``test_torch_als_serving.py``) and the same load fraction along the
  stream; a second ``MODEL`` with the same features retains as the
  reference does, one with new features makes a new model;
* the settings the port does not have raise at construction.
"""

from __future__ import annotations

import gzip
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.api.keymessage import KeyMessage as RefKeyMessage
from oryx_tpu.common import config as ref_cfg
from oryx_tpu.common import rand as ref_rand
from oryx_tpu.models.als import pmml_codec as ref_codec
from oryx_tpu.models.als import train as ref_train
from oryx_tpu.models.als.serving import ALSServingModelManager as RefManager
from oryx_tpu.models.als.update import ALSUpdate as RefUpdate
from oryx_tpu.pmml import pmmlutils as ref_pmmlutils
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import rand
from oryx_tpu_torch.models.als import pmml_codec
from oryx_tpu_torch.models.als import train as tr
from oryx_tpu_torch.models.als.serving import ALSServingModelManager
from oryx_tpu_torch.models.als.update import ALSUpdate
from oryx_tpu_torch.pmml import pmmlutils
from test_torch_mlupdate import Recorder, strip_timestamp

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

FACTOR_REL_TOL = 1e-3
EVAL_TOL = 1e-6
SCORE_TOL = 1e-5
TIMESTAMP_MS = 1_700_000_000_456


def _lines(seed=0, n_users=50, n_items=30, per_user=9, explicit=False):
    """``user,item,value,ts`` lines with planted rank-3 preferences (each
    user's top items), timestamps shuffled so the time-ordered split has
    work to do, and one unparseable line."""
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((n_users, 3)) @ rng.standard_normal((3, n_items))
    out = []
    for u in range(n_users):
        for i in np.argsort(-scores[u])[:per_user]:
            value = f"{1.0 + 4.0 * rng.random():.3f}" if explicit else "1"
            out.append([f"u{u}", f"i{i}", value])
    ts = rng.permutation(len(out)) * 1000 + 10**12
    lines = [f"{u},{i},{v},{t}" for (u, i, v), t in zip(out, ts.tolist())]
    lines.insert(7, "not,a,valid,line,at,all")
    return lines


def _overlay(extra=None):
    base = {"oryx.als.iterations": 2,
            "oryx.als.hyperparams.features": 4,
            "oryx.als.hyperparams.lambda": 0.1,
            "oryx.ml.eval.test-fraction": 0.2}
    base.update(extra or {})
    return base


def _updates(extra=None):
    overlay = _overlay(extra)
    return (ALSUpdate(cfg.overlay_on(overlay, cfg.get_default()), device="cpu"),
            RefUpdate(ref_cfg.overlay_on(overlay, ref_cfg.get_default())))


def _msgs(lines):
    return [KeyMessage(None, ln) for ln in lines], [RefKeyMessage(None, ln) for ln in lines]


def _part_text(path):
    with gzip.open(path / "part-00000.gz", "rt", encoding="utf-8") as f:
        return f.read()


def _read(codec, path):
    ids, vecs = zip(*codec.read_features(path))
    return list(ids), np.stack(vecs)


# -- pmml_codec ----------------------------------------------------------------


@pytest.mark.parametrize("implicit, log_strength", [(True, False), (False, True)])
def test_codec_writes_what_the_reference_writes(tmp_path, implicit, log_strength):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((7, 5)).astype(np.float32)
    y = rng.standard_normal((4, 5)).astype(np.float32)
    y[2, 1] = np.float32(1e-38)  # a tiny normal and an exact zero round-trip
    y[3, 0] = 0.0
    x_ids, y_ids = [f"u{i}" for i in range(7)], ["a", "b,c", 'q"', "é"]
    args = (x, y, x_ids, y_ids, 5, 0.25, 3.0, implicit, log_strength, 1e-4)
    port = pmml_codec.model_to_pmml(*args, tmp_path / "port")
    ref = ref_codec.model_to_pmml(*args, tmp_path / "ref")
    text = pmmlutils.to_string(port)
    assert strip_timestamp(text) == strip_timestamp(ref_pmmlutils.to_string(ref))
    for side in ("X", "Y"):
        assert _part_text(tmp_path / "port" / side) == _part_text(tmp_path / "ref" / side)
    # each package reads the other's part files and PMML
    for codec, path, want_ids, want in ((pmml_codec, "ref", x_ids, x),
                                        (ref_codec, "port", x_ids, x),
                                        (pmml_codec, "ref/Y", y_ids, y)):
        sub = tmp_path / path / ("X" if path in ("ref", "port") else "")
        ids, got = _read(codec, sub)
        assert ids == want_ids
        np.testing.assert_array_equal(got, want)
    meta = pmml_codec.pmml_to_meta(pmmlutils.from_string(ref_pmmlutils.to_string(ref)))
    assert meta == ref_codec.pmml_to_meta(ref_pmmlutils.from_string(text))
    assert meta["implicit"] is implicit and meta["x_ids"] == x_ids


# -- ALSUpdate -------------------------------------------------------------------


def test_split_is_the_reference_split():
    lines = _lines()
    update, ref_update = _updates()
    port_msgs, ref_msgs = _msgs(lines)
    train, test = update.split_new_data_to_train_test(port_msgs)
    ref_train_, ref_test = ref_update.split_new_data_to_train_test(ref_msgs)
    assert [km.message for km in train] == [km.message for km in ref_train_]
    assert [km.message for km in test] == [km.message for km in ref_test]
    assert len(test) == round(0.2 * len(lines)) and train[0].message.startswith("not")
    update0, ref0 = _updates({"oryx.ml.eval.test-fraction": 0.0})
    assert update0.split_new_data_to_train_test(port_msgs) == (port_msgs, [])


def _inject_y0(monkeypatch, seed, k):
    """The same Y₀ for both trainers (the first rows of one seeded matrix),
    by replacing each package's random initialiser (``jax.random`` streams
    cannot be reproduced in torch)."""
    y0 = (0.1 * np.random.default_rng(seed).standard_normal((64, k))).astype(np.float32)

    def ref_init(padded_rows, n_rows, features, key):
        assert features == k
        return jnp.zeros((padded_rows, features), jnp.float32).at[:n_rows].set(y0[:n_rows])

    def port_init(padded_rows, n, features, generator=None, device=None):
        assert features == k
        y = torch.zeros((padded_rows, features), dtype=torch.float32, device=device)
        y[:n] = torch.from_numpy(y0[:n])
        return y

    monkeypatch.setattr(ref_train, "_init_factors", ref_init)
    monkeypatch.setattr(tr, "init_item_factors", port_init)


def _build_both(tmp_path, monkeypatch, extra=None, explicit=False):
    lines = _lines(explicit=explicit)
    update, ref_update = _updates(extra)
    port_msgs, ref_msgs = _msgs(lines)
    train, test = update.split_new_data_to_train_test(port_msgs)
    ref_train_, ref_test = ref_update.split_new_data_to_train_test(ref_msgs)
    _inject_y0(monkeypatch, 5, 4)
    params = [4, 0.1, 1.0]
    pmml = update.build_model(None, train, params, tmp_path / "port")
    ref_pmml = ref_update.build_model(None, ref_train_, params, tmp_path / "ref")
    return update, ref_update, pmml, ref_pmml, (train, test), (ref_train_, ref_test), lines


@pytest.mark.parametrize("explicit", [False, True])
def test_build_model_from_an_injected_y0_matches_the_reference(tmp_path, monkeypatch,
                                                              explicit):
    extra = {"oryx.als.implicit": not explicit}
    update, _, pmml, ref_pmml, *_ = _build_both(tmp_path, monkeypatch, extra, explicit)
    assert strip_timestamp(pmmlutils.to_string(pmml)) == strip_timestamp(
        ref_pmmlutils.to_string(ref_pmml))
    for side in ("X", "Y"):
        ids, got = _read(pmml_codec, tmp_path / "port" / side)
        ref_ids, want = _read(ref_codec, tmp_path / "ref" / side)
        assert ids == ref_ids
        assert np.abs(got - want).max() / np.abs(want).max() < FACTOR_REL_TOL
    record = update.candidate_record(tmp_path / "port")
    assert record["blocks"] == {"user": 1, "item": 1} and len(record["iter_s"]) == 2
    assert {"prepare_s", "train_s", "pack_s", "write_s"} <= set(record)


@pytest.mark.parametrize("explicit", [False, True])
def test_evaluate_on_a_reference_written_model_matches_the_reference(
        tmp_path, monkeypatch, explicit):
    extra = {"oryx.als.implicit": not explicit}
    update, ref_update, _, ref_pmml, (train, test), (ref_train_, ref_test), _ = \
        _build_both(tmp_path, monkeypatch, extra, explicit)
    doc = pmmlutils.from_string(ref_pmmlutils.to_string(ref_pmml))
    rand.use_test_seed()
    got = update.evaluate(None, doc, tmp_path / "ref", test, train)
    ref_rand.use_test_seed()
    want = ref_update.evaluate(None, ref_pmml, tmp_path / "ref", ref_test, ref_train_)
    assert abs(got - want) < EVAL_TOL
    assert (got < 0) is explicit and (explicit or 0.5 < got <= 1.0)


def test_up_stream_is_the_reference_stream(tmp_path, monkeypatch):
    update, ref_update, _, ref_pmml, *_, lines = _build_both(tmp_path, monkeypatch)
    port_msgs, ref_msgs = _msgs(lines)
    doc = pmmlutils.from_string(ref_pmmlutils.to_string(ref_pmml))
    for no_known in (False, True):
        update.no_known_items = ref_update.no_known_items = no_known
        got, want = Recorder(), Recorder()
        update.publish_additional_model_data(None, doc, port_msgs[:100], port_msgs[100:],
                                             tmp_path / "ref", got)
        ref_update.publish_additional_model_data(None, ref_pmml, ref_msgs[:100],
                                                 ref_msgs[100:], tmp_path / "ref", want)
        assert got.sent == want.sent
        meta = pmml_codec.pmml_to_meta(doc)
        n_y, n_x = len(meta["y_ids"]), len(meta["x_ids"])
        ups = [json.loads(m) for _, m, _ in got.sent]
        assert [u[0] for u in ups] == ["Y"] * n_y + ["X"] * n_x
        assert [u[1] for u in ups] == meta["y_ids"] + meta["x_ids"]
        assert all(len(u) == (3 if no_known else 4) for u in ups[n_y:])


def test_checkpointing_is_refused_at_construction():
    conf = cfg.overlay_on({"oryx.batch.checkpoint.enabled": True,
                           "oryx.batch.checkpoint.dir": "/nonexistent"},
                          cfg.get_default())
    with pytest.raises(NotImplementedError, match="checkpoint"):
        ALSUpdate(conf, device="cpu")


# -- a whole generation, and the managers ---------------------------------------


def _generation(tmp_path, monkeypatch, extra=None):
    """``run_update`` in both packages on the same lines, from the same Y₀;
    returns each package's recorded stream and model dir."""
    overlay = _overlay({"oryx.ml.eval.candidates": 2,
                        "oryx.ml.eval.hyperparam-search": "grid",
                        "oryx.als.hyperparams.lambda": [0.01, 3.0], **(extra or {})})
    lines = _lines()
    port_msgs, ref_msgs = _msgs(lines)
    out = {}
    for name, update in (
            ("port", ALSUpdate(cfg.overlay_on(overlay, cfg.get_default()), device="cpu")),
            ("ref", RefUpdate(ref_cfg.overlay_on(overlay, ref_cfg.get_default())))):
        rand.use_test_seed()
        ref_rand.use_test_seed()
        _inject_y0(monkeypatch, 5, 4)
        producer = Recorder()
        msgs = port_msgs if name == "port" else ref_msgs
        update.run_update(None, TIMESTAMP_MS, msgs[:200], msgs[200:],
                          str(tmp_path / name), producer)
        out[name] = (update, producer)
    return out


def test_generation_publishes_the_reference_generation(tmp_path, monkeypatch):
    out = _generation(tmp_path, monkeypatch)
    (update, got), (_, want) = out["port"], out["ref"]
    assert [k for k, _, _ in got.sent] == [k for k, _, _ in want.sent]
    meta = pmml_codec.pmml_to_meta(pmmlutils.from_string(got.sent[0][1]))
    assert got.sent[0][0] == "MODEL"
    assert len(got.sent) == 1 + len(meta["y_ids"]) + len(meta["x_ids"])
    assert strip_timestamp(got.sent[0][1]) == strip_timestamp(want.sent[0][1])
    vectors = {"X": ([], []), "Y": ([], [])}
    for (_, m, _), (_, rm, _) in zip(got.sent[1:], want.sent[1:]):
        u, r = json.loads(m), json.loads(rm)
        assert u[0] == r[0] and u[1] == r[1] and u[3:] == r[3:]
        vectors[u[0]][0].append(u[2])
        vectors[u[0]][1].append(r[2])
    # each side's factors relative to their largest magnitude, as in the
    # build_model test
    for side, (g, w) in vectors.items():
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.size, side
        assert np.abs(g - w).max() / np.abs(w).max() < FACTOR_REL_TOL, side
    report = update.report
    assert all("failed" not in c for c in report["candidates"].values())
    assert len(report["candidates"]) == 2 and report["published"] == "MODEL"
    evals = [c["eval"] for c in report["candidates"].values()]
    assert report["best_eval"] == max(evals)
    assert (tmp_path / "port" / str(TIMESTAMP_MS) / "model.pmml").exists()


def _managers(overlay=None):
    overlay = overlay or {}
    return (ALSServingModelManager(cfg.overlay_on(overlay, cfg.get_default()), device="cpu"),
            RefManager(ref_cfg.overlay_on(overlay, ref_cfg.get_default())))


def _assert_same_serving(mgr, ref_mgr, n_users=12, how_many=5):
    model, ref_model = mgr.get_model(), ref_mgr.get_model()
    assert sorted(model.all_user_ids()) == sorted(ref_model.all_user_ids())
    assert model.all_item_ids() == ref_model.all_item_ids()
    assert model.expected_user_ids == ref_model.expected_user_ids
    assert model.expected_item_ids == ref_model.expected_item_ids
    assert model.get_fraction_loaded() == ref_model.get_fraction_loaded()
    users = sorted(model.all_user_ids())[:n_users]
    assert {u: model.get_known_items(u) for u in users} == {
        u: ref_model.get_known_items(u) for u in users}
    qs = np.stack([model.get_user_vector(u) for u in users])
    excluded = [model.get_known_items(u) for u in users]
    got = model.top_n_batch(qs, how_many, excluded=excluded)
    want = ref_model.top_n_batch(qs, how_many, excluded=excluded)
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("stream_from", ["port", "ref"])
def test_both_managers_serve_either_stream_alike(tmp_path, monkeypatch, stream_from):
    _, producer = _generation(tmp_path, monkeypatch)[stream_from]
    mgr, ref_mgr = _managers()
    assert mgr.get_model() is None
    mgr.consume_key_message("UP", producer.sent[1][1])  # before a model: ignored
    n = len(producer.sent)
    for i, (key, message, _) in enumerate(producer.sent):
        mgr.consume([KeyMessage(key, message)])
        ref_mgr.consume([RefKeyMessage(key, message)])
        if i in (0, 1, 15, 30, 31, 60, n - 1):
            assert mgr.get_model().get_fraction_loaded() == \
                ref_mgr.get_model().get_fraction_loaded()
    assert mgr.get_model().get_fraction_loaded() == 1.0
    _assert_same_serving(mgr, ref_mgr)


def _model_text(tmp_path, name, users, items, k):
    rng = np.random.default_rng(len(users) + 10 * k)
    pmml = pmml_codec.model_to_pmml(
        rng.standard_normal((len(users), k)), rng.standard_normal((len(items), k)),
        users, items, k, 0.1, 1.0, True, False, 1e-5, tmp_path / name)
    return pmmlutils.to_string(pmml)


def test_model_handoffs_retain_and_rebuild_as_the_reference(tmp_path, monkeypatch):
    _, producer = _generation(tmp_path, monkeypatch)["ref"]
    mgr, ref_mgr = _managers()

    def both(key, message):
        mgr.consume_key_message(key, message)
        ref_mgr.consume_key_message(key, message)

    for key, message, _ in producer.sent:
        both(key, message)
    first = mgr.get_model()
    meta = pmml_codec.pmml_to_meta(pmmlutils.from_string(producer.sent[0][1]))
    users, items = meta["x_ids"], meta["y_ids"]
    # same features: every row was written since the first MODEL, so all stay
    both("MODEL", _model_text(tmp_path, "m2", users[:20] + ["u-new"], items[:10], 4))
    assert mgr.get_model() is first
    _assert_same_serving(mgr, ref_mgr)
    assert mgr.get_model().expected_user_ids == {"u-new"}
    # a few rows written, then a smaller model: the rest of the old rows go
    both("UP", json.dumps(["X", users[-1], [0.5, 0.25, -1.0, 2.0], [items[0]]]))
    both("UP", json.dumps(["Y", items[-1], [1.0, 0.0, 0.5, -0.5]]))
    both("MODEL", _model_text(tmp_path, "m3", users[:5], items[:3], 4))
    assert mgr.get_model() is first
    assert sorted(mgr.get_model().all_user_ids()) == sorted(users[:5] + [users[-1]])
    assert mgr.get_model().all_item_ids() == items[:3] + [items[-1]]
    _assert_same_serving(mgr, ref_mgr, n_users=6)
    # new features: a new, empty model expecting every id
    both("MODEL-REF", str(_write_model(tmp_path, users[:3], items[:2])))
    assert mgr.get_model() is not first and mgr.get_model().features == 6
    assert mgr.get_model().get_fraction_loaded() == \
        ref_mgr.get_model().get_fraction_loaded() == 0.0
    assert mgr.get_model().expected_item_ids == ref_mgr.get_model().expected_item_ids
    with pytest.raises(ValueError, match="bad update type"):
        mgr.consume_key_message("UP", json.dumps(["Z", "a", [1.0]]))
    with pytest.raises(ValueError, match="bad key"):
        mgr.consume_key_message("NOPE", "")


def _write_model(tmp_path, users, items):
    path = tmp_path / "m4.pmml"
    pmmlutils.write(pmmlutils.from_string(_model_text(tmp_path, "m4", users, items, 6)),
                    path)
    return path


@pytest.mark.parametrize("overlay", [
    {"oryx.als.sample-rate": 0.5},
    {"oryx.serving.device-dtype": "bfloat16"},
    {"oryx.serving.device-dtype": "int8"},
    {"oryx.serving.compute.sharded": True},
    {"oryx.serving.index.enabled": True},
    {"oryx.serving.compute.precompile-batches": True},
])
def test_unsupported_serving_settings_raise_at_construction(overlay):
    with pytest.raises(NotImplementedError):
        ALSServingModelManager(cfg.overlay_on(overlay, cfg.get_default()), device="cpu")


def test_supported_serving_settings_construct():
    for overlay in ({}, {"oryx.serving.device-dtype": "float32"},
                    {"oryx.serving.compute.precompile-batches": True,
                     "oryx.compile.prewarm-swap": False}):
        mgr = ALSServingModelManager(cfg.overlay_on(overlay, cfg.get_default()),
                                     device="cpu")
        assert mgr.get_model() is None
