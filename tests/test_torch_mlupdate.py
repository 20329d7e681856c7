"""The port's batch harness (``MLUpdate.run_update``) against the reference's.

* the same toy ``MLUpdate`` subclass (deterministic build and evaluation)
  runs in both packages, under the test seed: equal combos, split, best
  candidate, published ``(key, message)`` sequence and promoted dir, for
  ``MODEL`` and ``MODEL-REF``, the threshold gate, NaN / ``None``
  evaluations, a failed candidate and the scratch dir's removal;
* the host modules the harness copies (``ioutils``, ``executils``,
  ``datastore``, the publish side of ``lineage``) behave as the reference's;
* ``KMeansUpdate`` runs a generation behind the same harness, and its
  ``MODEL`` loads in both packages' serving managers;
* the kernel wrappers' launch counters and the sweep plan's cache are
  right under concurrent host threads (parallel candidate builds).
"""

from __future__ import annotations

import json
import re
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from oryx_tpu.api.keymessage import KeyMessage as RefKeyMessage
from oryx_tpu.common import config as ref_cfg
from oryx_tpu.common import executils as ref_executils
from oryx_tpu.common import ioutils as ref_ioutils
from oryx_tpu.common import lineage as ref_lineage
from oryx_tpu.common import rand as ref_rand
from oryx_tpu.ml import mlupdate as ref_mlupdate
from oryx_tpu.ml import param as ref_hp
from oryx_tpu.models.kmeans.serving import KMeansServingModelManager as RefKMServing
from oryx_tpu.pmml import pmmlutils as ref_pmmlutils
from oryx_tpu.store import datastore as ref_datastore
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import executils, ioutils, lineage, rand
from oryx_tpu_torch.ml import mlupdate
from oryx_tpu_torch.ml import param as hp
from oryx_tpu_torch.models.kmeans import pmml_codec as km_codec
from oryx_tpu_torch.models.kmeans.serving import KMeansServingModelManager
from oryx_tpu_torch.models.kmeans.update import KMeansUpdate
from oryx_tpu_torch.ops import kernels as K
from oryx_tpu_torch.pmml import pmmlutils
from oryx_tpu_torch.store import datastore

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

TIMESTAMP_MS = 1_700_000_000_123


def strip_timestamp(text: str) -> str:
    """A PMML document with its Header's creation time blanked: the one
    part of a model's text that depends on when it was written."""
    return re.sub(r"(<(?:\w+:)?Timestamp>)[^<]*(</)", r"\1\2", text)


def _toy_class(base, hp_mod, pmml_mod):
    """The toy model family, on either package's harness: the candidate's
    hyperparameter and its train-data digest in the PMML, a side file in
    its dir, a scripted evaluation, and one ``UP`` of additional data."""

    class Toy(base):
        scores: dict = {}
        fail = ()

        def get_hyper_parameter_values(self):
            return [hp_mod.DiscreteRange(1, 3), hp_mod.Unordered(["a", "b"])]

        def build_model(self, context, train_data, hyper_parameters,
                        candidate_path, device=None):
            p, tag = int(hyper_parameters[0]), hyper_parameters[1]
            if p in self.fail:
                raise RuntimeError(f"candidate {p} fails")
            (Path(candidate_path) / "side.txt").write_text(f"{p}{tag}")
            pmml = pmml_mod.build_skeleton_pmml()
            pmml_mod.add_extension(pmml, "param", p)
            pmml_mod.add_extension(pmml, "tag", tag)
            pmml_mod.add_extension_content(
                pmml, "train", [km.message for km in train_data])
            return pmml

        def evaluate(self, context, model, model_parent_path, test_data,
                     train_data):
            p = int(pmml_mod.get_extension_value(model, "param"))
            tag = pmml_mod.get_extension_value(model, "tag")
            side = (Path(model_parent_path) / "side.txt").read_text()
            assert side == f"{p}{tag}"
            default = p + (0.5 if tag == "b" else 0.0) + 0.001 * len(test_data)
            return self.scores.get((p, tag), default)

        def publish_additional_model_data(self, context, pmml, new_data,
                                          past_data, model_path, producer):
            producer.send("UP", json.dumps([
                (Path(model_path) / "side.txt").read_text(),
                len(new_data), len(past_data)]))

    return Toy


PortToy = _toy_class(mlupdate.MLUpdate, hp, pmmlutils)
RefToy = _toy_class(ref_mlupdate.MLUpdate, ref_hp, ref_pmmlutils)


class Recorder:
    """A producer that records ``(key, message, headers)``."""

    def __init__(self):
        self.sent = []

    def send(self, key, message, headers=None):
        self.sent.append((key, message, headers))

    def pairs(self, model_dir=None):
        out = []
        for key, message, _ in self.sent:
            if key == "MODEL-REF":
                message = str(Path(message).relative_to(model_dir))
            elif key == "MODEL":
                message = strip_timestamp(message)
            out.append((key, message))
        return out


def _overlay(extra=None):
    base = {"oryx.ml.eval.candidates": 4,
            "oryx.ml.eval.hyperparam-search": "grid",
            "oryx.ml.eval.test-fraction": 0.25}
    base.update(extra or {})
    return base


def _run(toy, config, tmp_path, name, new, past, scores=None, fail=()):
    """One generation of ``toy`` under the test seed; returns the updater,
    its producer and the model dir."""
    for r in (rand, ref_rand):
        r.use_test_seed()
    update = (toy(config, device="cpu") if toy is PortToy else toy(config))
    update.scores, update.fail = dict(scores or {}), fail
    model_dir = tmp_path / name
    producer = Recorder()
    update.run_update(None, TIMESTAMP_MS, new, past, str(model_dir), producer)
    return update, producer, model_dir


def _both(tmp_path, extra=None, scores=None, fail=(), n_new=40, n_past=7):
    """The toy generation in both packages on the same data."""
    overlay = _overlay(extra)
    new = [f"d{i}" for i in range(n_new)]
    past = [f"p{i}" for i in range(n_past)]
    port = _run(PortToy, cfg.overlay_on(overlay, cfg.get_default()), tmp_path,
                "port", [KeyMessage(None, m) for m in new],
                [KeyMessage(None, m) for m in past], scores, fail)
    ref = _run(RefToy, ref_cfg.overlay_on(overlay, ref_cfg.get_default()),
               tmp_path, "ref", [RefKeyMessage(None, m) for m in new],
               [RefKeyMessage(None, m) for m in past], scores, fail)
    return port, ref


def _model_dirs(model_dir):
    return sorted(p.name for p in model_dir.iterdir()) if model_dir.exists() else []


# -- the harness ----------------------------------------------------------------


def test_combos_and_split_equal_the_reference():
    overlay = _overlay({"oryx.ml.eval.hyperparam-search": "random",
                        "oryx.ml.eval.candidates": 5})
    rand.use_test_seed()
    port = PortToy(cfg.overlay_on(overlay, cfg.get_default()), device="cpu")
    combos = hp.choose_hyper_parameter_combos(
        port.get_hyper_parameter_values(), port.candidates,
        port.hyperparam_search)
    split = port.split_new_data_to_train_test(list(range(200)))
    ref_rand.use_test_seed()
    ref = RefToy(ref_cfg.overlay_on(overlay, ref_cfg.get_default()))
    assert combos == ref_hp.choose_hyper_parameter_combos(
        ref.get_hyper_parameter_values(), ref.candidates,
        ref.hyperparam_search)
    assert split == ref.split_new_data_to_train_test(list(range(200)))
    assert 0 < len(split[1]) < 100


@pytest.mark.parametrize("max_size", [16777216, 10])
def test_generation_publishes_what_the_reference_publishes(tmp_path, max_size):
    """The best of four grid candidates promoted under the same dir name and
    published as ``MODEL`` (or ``MODEL-REF`` past the max size), then the
    additional data: the same ``(key, message)`` sequence."""
    (port, producer, model_dir), (ref, ref_producer, ref_dir) = _both(
        tmp_path, {"oryx.update-topic.message.max-size": max_size})
    key = "MODEL" if max_size > 1000 else "MODEL-REF"
    assert [k for k, _, _ in producer.sent] == [key, "UP"]
    assert producer.pairs(model_dir) == ref_producer.pairs(ref_dir)
    assert _model_dirs(model_dir) == _model_dirs(ref_dir) == [str(TIMESTAMP_MS)]
    promoted = model_dir / str(TIMESTAMP_MS)
    assert (promoted / "side.txt").read_text() == "3b"
    assert sorted(p.name for p in promoted.iterdir()) == ["model.pmml", "side.txt"]
    combos = port.report["combos"]
    assert sorted(combos) == [[1, "a"], [1, "b"], [3, "a"], [3, "b"]]
    assert port.report["best"] == str(combos.index([3, "b"]))
    assert port.report["published"] == key
    # the candidates trained on the new lines not held out, then the past
    doc = pmmlutils.read(promoted / "model.pmml")
    train = pmmlutils.get_extension_content(doc, "train")
    assert 7 < len(train) < 47 and train[-7:] == [f"p{i}" for i in range(7)]
    # each send carries the lineage headers, the stamp on the model only
    assert lineage.PROVENANCE_HEADER in producer.sent[0][2]
    assert set(producer.sent[1][2]) == {lineage.GENERATION_HEADER}
    stamp = lineage.parse_stamp(producer.sent[0][2])
    assert (stamp["new_rows"], stamp["past_rows"], stamp["origin"]) == (40, 7, "scratch")
    assert set(stamp) == set(ref_lineage.parse_stamp(ref_producer.sent[0][2]))


@pytest.mark.parametrize("threshold, published", [(3.4, True), (3.6, False)])
def test_threshold_gate_matches_the_reference(tmp_path, threshold, published):
    (_, producer, model_dir), (_, ref_producer, ref_dir) = _both(
        tmp_path, {"oryx.ml.eval.threshold": threshold})
    assert bool(producer.sent) is published
    assert producer.pairs(model_dir) == ref_producer.pairs(ref_dir)
    assert _model_dirs(model_dir) == _model_dirs(ref_dir)


@pytest.mark.parametrize("scores, best", [
    ({(1, "a"): float("nan"), (1, "b"): None}, "3b"),
    ({(3, "b"): float("nan"), (3, "a"): None, (1, "b"): np.float32("nan")}, "1a"),
    ({(1, "a"): 0.2, (1, "b"): float("nan"), (3, "a"): float("nan"),
      (3, "b"): None}, "1a"),
])
def test_a_nan_or_missing_evaluation_is_never_best(tmp_path, scores, best):
    (port, producer, model_dir), (_, ref_producer, ref_dir) = _both(
        tmp_path, scores=scores)
    assert producer.pairs(model_dir) == ref_producer.pairs(ref_dir)
    assert (model_dir / str(TIMESTAMP_MS) / "side.txt").read_text() == best
    assert not mlupdate._better(float("nan"), 0.1)
    assert mlupdate._better(-1.0, None) and not mlupdate._better(None, None)


def test_a_failed_candidate_is_skipped_and_recorded(tmp_path):
    (port, producer, model_dir), (_, ref_producer, ref_dir) = _both(
        tmp_path, fail=(3,))
    assert producer.pairs(model_dir) == ref_producer.pairs(ref_dir)
    assert (model_dir / str(TIMESTAMP_MS) / "side.txt").read_text() == "1b"
    failed = {tuple(rec["hyperparameters"]): rec.get("failed")
              for rec in port.report["candidates"].values()}
    assert sorted(c for c, f in failed.items() if f) == [(3, "a"), (3, "b")]
    assert "candidate 3 fails" in failed[(3, "a")]
    # every candidate failing publishes nothing, in both packages
    (_, producer, model_dir), (_, ref_producer, ref_dir) = _both(
        tmp_path / "all", fail=(1, 3))
    assert producer.sent == ref_producer.sent == []
    assert _model_dirs(model_dir) == _model_dirs(ref_dir) == []


@pytest.mark.parametrize("speculation", [True, False])
def test_scratch_dir_is_removed(tmp_path, monkeypatch, speculation):
    made = []
    real = tempfile.mkdtemp

    def recording_mkdtemp(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(tempfile, "mkdtemp", recording_mkdtemp)
    (_, producer, model_dir), (_, ref_producer, ref_dir) = _both(
        tmp_path, {"oryx.ml.eval.speculation.enabled": speculation,
                   "oryx.ml.eval.parallelism": 2})
    assert producer.pairs(model_dir) == ref_producer.pairs(ref_dir)
    assert len(made) == 2 and not any(Path(p).exists() for p in made)


def test_no_data_publishes_nothing_and_test_fraction_zero_means_one_candidate(tmp_path):
    (_, producer, _), (_, ref_producer, _) = _both(tmp_path, n_new=0, n_past=0)
    assert producer.sent == ref_producer.sent == []
    (port, producer, model_dir), (_, ref_producer, ref_dir) = _both(
        tmp_path / "t0", {"oryx.ml.eval.test-fraction": 0.0})
    assert port.candidates == 1 and len(port.report["candidates"]) == 1
    assert producer.pairs(model_dir) == ref_producer.pairs(ref_dir)


def test_round_robin_is_off_on_the_cpu_and_without_parallelism():
    conf = cfg.overlay_on(_overlay({"oryx.ml.eval.parallelism": 2}),
                          cfg.get_default())
    assert PortToy(conf, device="cpu")._candidate_devices(4) is None
    one = cfg.overlay_on(_overlay(), cfg.get_default())
    assert PortToy(one)._candidate_devices(4) is None


def test_run_update_without_a_card_raises_before_any_candidate(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device rule holds by using it")
    update = PortToy(cfg.overlay_on(_overlay(), cfg.get_default()))
    producer = Recorder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        update.run_update(None, TIMESTAMP_MS, [KeyMessage(None, "x")], [],
                          str(tmp_path / "m"), producer)
    assert producer.sent == [] and not (tmp_path / "m").exists()


# -- copied host modules -------------------------------------------------------


def test_ioutils_behave_as_the_reference(tmp_path):
    for mod, root in ((ioutils, tmp_path / "port"), (ref_ioutils, tmp_path / "ref")):
        d = mod.mkdirs(root / "a" / "b")
        for name in ("z.txt", "a.txt", ".hidden"):
            (d / name).write_text(name)
        mod.atomic_write_text(d / "w.txt", "payload")
        assert (d / "w.txt").read_text() == "payload"
        assert [p.name for p in mod.list_files(d)] == ["a.txt", "w.txt", "z.txt"]
        assert [p.name for p in mod.list_files(d, "*.txt")] == [
            "a.txt", "w.txt", "z.txt"]
        mod.close_quietly(None)
        mod.delete_recursively(root / "a")
        assert not (root / "a").exists()
        assert mod.choose_free_port() > 0


def test_executils_collect_as_the_reference():
    for mod in (executils, ref_executils):
        assert mod.collect_in_parallel(5, lambda i: i * i, 3) == [0, 1, 4, 9, 16]
        assert mod.collect_in_parallel(0, lambda i: i) == []
        assert list(mod.map_in_parallel(range(4), lambda v: v + 1, 2)) == [1, 2, 3, 4]

        def flaky(i, attempt):
            if i == 1:
                raise ValueError("no")
            return (i, attempt)

        assert mod.collect_speculative(3, flaky, 2, poll_sec=0.01) == [
            (0, 0), None, (2, 0)]
        seen = []
        mod.do_in_parallel(3, seen.append, 2)
        assert sorted(seen) == [0, 1, 2]
    assert executils.device_sync(torch.ones(3)) == 3.0


def test_datastore_writes_and_reads_what_the_reference_does(tmp_path):
    msgs = [("k1", "m1"), (None, "m,2"), ("k3", '["x", 1]')]
    port = datastore.DataStore(f"file:{tmp_path / 'port'}")
    ref = ref_datastore.DataStore(f"file:{tmp_path / 'ref'}")
    assert port.write_segment(5, []) is None
    for ts in (1000, 2000):
        seg = port.write_segment(ts, [KeyMessage(k, m) for k, m in msgs])
        ref_seg = ref.write_segment(ts, [RefKeyMessage(k, m) for k, m in msgs])
        assert seg.name == ref_seg.name == f"oryx-{ts}.data"
        assert (seg / "part-00000.jsonl").read_bytes() == (
            ref_seg / "part-00000.jsonl").read_bytes()
    assert [(km.key, km.message) for km in port.read_all()] == msgs * 2
    now = 2000 + 3600 * 1000
    assert [p.name for p in port.delete_older_than(1, now_ms=now)] == [
        p.name for p in ref.delete_older_than(1, now_ms=now)] == ["oryx-1000.data"]
    assert port.delete_older_than(-1) == []

    store = datastore.ModelStore(str(tmp_path / "models"))
    ref_store = ref_datastore.ModelStore(str(tmp_path / "ref_models"))
    assert store.latest() is None
    for s, root in ((store, tmp_path / "c"), (ref_store, tmp_path / "rc")):
        for ts in (30, 200, 1000):
            cand = ioutils.mkdirs(root / str(ts))
            (cand / "model.pmml").write_text(str(ts))
            s.promote(cand, ts)
        s.new_model_dir(5)
    assert [d.name for d in store.model_dirs()] == [
        d.name for d in ref_store.model_dirs()] == ["5", "30", "200", "1000"]
    assert (store.latest() / "model.pmml").read_text() == "1000"
    assert [d.name for d in store.delete_older_than(0, now_ms=100)] == [
        d.name for d in ref_store.delete_older_than(0, now_ms=100)] == ["5", "30"]


class _Context:
    input_offsets = {0: 12, 1: 40}
    input_watermark_ms = 99
    input_max_event_ms = 120


@pytest.mark.parametrize("context", [None, _Context()])
def test_lineage_stamps_as_the_reference(context):
    stamp = lineage.make_stamp(context, 1000, 1, 2, 3, 4)
    ref_stamp = ref_lineage.make_stamp(context, 1000, 1, 2, 3, 4)
    for s in (stamp, ref_stamp):
        del s["generation"], s["published_ms"]
    assert stamp == ref_stamp
    assert lineage.mint_generation_id("abcdef0123456789") == \
        ref_lineage.mint_generation_id("abcdef0123456789") == "gabcdef012345"
    assert re.fullmatch(r"g3e8-[0-9a-f]{6}", lineage.mint_generation_id(None, 1000))
    for headers in (None, {}, {lineage.PROVENANCE_HEADER: "not json"},
                    {lineage.PROVENANCE_HEADER: "[1]"},
                    {lineage.PROVENANCE_HEADER: '{"generation": "g1"}',
                     lineage.WATERMARK_HEADER: '{"watermark_ms": 5}'}):
        assert lineage.parse_stamp(headers) == ref_lineage.parse_stamp(headers)
        assert lineage.parse_watermark(headers) == ref_lineage.parse_watermark(headers)


def test_stamped_producer_sends_as_the_reference():
    class Bare:
        def __init__(self):
            self.sent = []

        def send(self, key, message):
            self.sent.append((key, message))

    stamp = {"generation": "g1", "n": 1}
    sends = [("MODEL", "m", None), ("UP", "u", {"traceparent": "t"}),
             ("MODEL-REF", "r", None)]
    outs = []
    for mod in (lineage, ref_lineage):
        rec, bare = Recorder(), Bare()
        for producer in (mod.StampedProducer(rec, stamp),
                         mod.StampedProducer(bare, stamp)):
            for key, message, headers in sends:
                producer.send(key, message, headers=headers)
        assert mod.StampedProducer(rec, stamp).sent is rec.sent
        outs.append((rec.sent, bare.sent))
    assert outs[0] == outs[1]
    assert outs[0][1] == [(k, m) for k, m, _ in sends]


# -- KMeansUpdate behind the harness --------------------------------------------


def test_kmeans_generation_publishes_a_model_both_managers_load(tmp_path):
    overlay = {"oryx.input-schema.num-features": 2,
               "oryx.input-schema.categorical-features": [],
               "oryx.kmeans.hyperparams.k": [2, 3],
               "oryx.kmeans.iterations": 5, "oryx.kmeans.runs": 2,
               "oryx.ml.eval.candidates": 2,
               "oryx.ml.eval.hyperparam-search": "grid",
               "oryx.kmeans.evaluation-strategy": "SSE"}
    conf = cfg.overlay_on(overlay, cfg.get_default())
    rng = np.random.default_rng(3)
    centres = np.array([[0.0, 0.0], [10.0, 10.0], [-10.0, 6.0]])
    pts = centres[rng.integers(0, 3, 150)] + rng.standard_normal((150, 2)) * 0.3
    lines = [KeyMessage(None, f"{a},{b}") for a, b in pts]
    rand.use_test_seed()
    update = KMeansUpdate(conf, device="cpu")
    producer = Recorder()
    update.run_update(None, TIMESTAMP_MS, lines, [], str(tmp_path), producer)
    assert [k for k, _, _ in producer.sent] == ["MODEL"]
    report = update.report
    assert sorted(c["hyperparameters"] for c in report["candidates"].values()) == [
        [2], [3]]
    # SSE is lower-better, negated: three planted blobs beat two
    assert report["candidates"][report["best"]]["hyperparameters"] == [3] and all(
        "failed" not in c for c in report["candidates"].values())
    text = producer.sent[0][1]
    served = KMeansServingModelManager(conf)
    served.consume([KeyMessage("MODEL", text)])
    ref_served = RefKMServing(ref_cfg.overlay_on(overlay, ref_cfg.get_default()))
    ref_served.consume([RefKeyMessage("MODEL", text)])
    got = served.get_model().clusters
    want = km_codec.read(pmmlutils.read(tmp_path / str(TIMESTAMP_MS) / "model.pmml"))
    assert len(got) == 3 and [c.id for c in got] == [c.id for c in want]
    for g, w, r in zip(got, want, ref_served.get_model().clusters):
        np.testing.assert_array_equal(g.center, w.center)
        np.testing.assert_array_equal(g.center, r.center)
    for q in centres:
        assert served.get_model().nearest_cluster(q) == \
            ref_served.get_model().nearest_cluster(q)


# -- shared state under host threads --------------------------------------------


def test_launch_counters_lose_no_update_under_threads():
    """Eight threads count 2,000 launches each with a short switch
    interval: a read-modify-write without the lock loses some."""
    K.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for _ in range(2000):
                K._count("spd_solve_batched", (t % 2, 50), "spd_solve_batched.warp")
                K._count_shape("gather_gramian_accumulate.reduce", (t % 2,))

        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert K.LAUNCHES["spd_solve_batched"] == 16_000
    assert K.SHAPE_LAUNCHES[("spd_solve_batched.warp", (0, 50))] == 8_000
    assert K.SHAPE_LAUNCHES[("gather_gramian_accumulate.reduce", (1,))] == 8_000
    K.reset_launches()
    assert K.LAUNCHES["spd_solve_batched"] == 0 and not K.SHAPE_LAUNCHES


def test_sweep_plan_cache_is_shared_correctly_by_threads():
    K.kmeans_sweep_plan.cache_clear()
    shapes = [(100_000, 256, 64), (1_000, 3, 5), (50_000, 1024, 128)] * 4
    want = [K.kmeans_sweep_plan.__wrapped__(*s) for s in shapes]
    results = executils.collect_in_parallel(
        len(shapes), lambda i: K.kmeans_sweep_plan(*shapes[i]), 6)
    assert results == want
    assert K.kmeans_sweep_plan.cache_info().currsize == 3
