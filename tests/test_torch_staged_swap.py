"""The port's staged generation swap (``ALSServingModelManager`` with
``precompile-batches`` and ``prewarm-swap``), held to the reference.

* ``tests/test_compilecache.py``'s prewarmed-swap case on the port's
  ``ServingLayer``. Its "zero compiles after the flip" has no torch
  counterpart (torch compiles nothing per shape); it becomes: generation
  2's warm ladder finished before the flip, and no answer, before or after
  it, came from a generation whose ladder had not finished. The generation
  header of the answers never goes back, and ``/lineage`` shows the staged
  generation as staged, not live, until the flip.
* ``tests/test_compilecache.py``'s deadline case on the port's manager,
  with the deadline-promotion counter.
* Both packages' managers fed one ``MODEL`` / ``UP`` / ``MODEL`` / ``UP``
  stream hold the same live and staged generations at each step and give
  the same top-N after the promotion.

Models and streams are the reference's (``_train_model``), published to the
port's ``memory:`` broker. ``tests/test_compilecache.py``'s persistent XLA
cache case is not mirrored: torch keeps no compiled-program cache.
Last, the CPU rehearsal of ``chip_smoke.serving_swap_phase``.
"""

from __future__ import annotations

import json
import threading
import time

import httpx
import numpy as np
import pytest
import torch

from oryx_tpu.common import config as ref_cfg
from oryx_tpu.models.als import pmml_codec as ref_als_codec
from oryx_tpu.models.als.serving import ALSServingModelManager as RefManager
from oryx_tpu.pmml import pmmlutils as ref_pmmlutils
from oryx_tpu_torch.common import compilecache
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.models.als.serving import ALSServingModel, ALSServingModelManager
from oryx_tpu_torch.serving.app import ServingLayer
from oryx_tpu_torch.serving.batcher import pow2_buckets
from oryx_tpu_torch.transport import topic as tp
from test_compilecache import _train_model

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

_MANAGER = "oryx_tpu_torch.models.als.serving.ALSServingModelManager"


def _stream(pmml, model_dir, known) -> list:
    """The reference test's ``_publish`` stream as (key, message) pairs."""
    out = [("MODEL", ref_pmmlutils.to_string(pmml))]
    for id_, vec in ref_als_codec.read_features(model_dir / "Y"):
        out.append(("UP", json.dumps(["Y", id_, [float(v) for v in vec]])))
    for id_, vec in ref_als_codec.read_features(model_dir / "X"):
        out.append(("UP", json.dumps(
            ["X", id_, [float(v) for v in vec], known.get(id_, [])])))
    return out


def _generation(tmp_path, name: str, features: int, seed: int):
    model_dir = tmp_path / name
    model_dir.mkdir()
    pmml, known = _train_model(model_dir, features=features, seed=seed)
    return _stream(pmml, model_dir, known), known


def _counter(name: str) -> float:
    return metrics_mod.default_registry().snapshot().get(name, {}).get("", 0.0)


def test_prewarmed_generation_swap_warms_before_the_flip(tmp_path, monkeypatch):
    """A MODEL push with new shapes (features 4 -> 5) during traffic: the
    old generation keeps serving while the staged one fills and warms off
    the request path; the flip comes after the staged generation's whole
    ladder, and every answer came from a generation whose ladder had
    finished."""
    tp.reset_memory_brokers()
    compilecache.warmup_state().reset()
    top = pow2_buckets(8)[-1]
    ladder_done: set = set()
    served: list = []  # (model id, its ladder done when it answered)
    flips: list = []

    warm_bucket = ALSServingModel.warm_bucket
    top_n_batch = ALSServingModel.top_n_batch

    def warm(self, batch_size, how_many=10):
        warm_bucket(self, batch_size, how_many)
        if batch_size == top:
            ladder_done.add(id(self))

    def answer(self, *args, **kwargs):
        if threading.current_thread().name != "OryxServingBatchWarmer":
            served.append((id(self), id(self) in ladder_done))
        return top_n_batch(self, *args, **kwargs)

    monkeypatch.setattr(ALSServingModel, "warm_bucket", warm)
    monkeypatch.setattr(ALSServingModel, "top_n_batch", answer)
    port = ioutils.choose_free_port()
    config = cfg.overlay_on({
        "oryx.serving.api.port": port,
        "oryx.serving.model-manager-class": _MANAGER,
        "oryx.serving.application-resources": "oryx_tpu_torch.serving.resources.als",
        "oryx.serving.compute.precompile-batches": True,
        "oryx.serving.compute.coalesce-max-batch": 8,
    }, cfg.get_default())
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    gen1, _ = _generation(tmp_path, "gen1", 4, 0)
    gen2, known2 = _generation(tmp_path, "gen2", 5, 1)
    prod = tp.TopicProducerImpl("memory:", "OryxUpdate")
    for key, message in gen1:
        prod.send(key, message)
    prewarmed = _counter("oryx_serving_prewarmed_swaps_total")
    layer = ServingLayer(config, device="cpu")
    layer.start()
    promote = layer.manager.promote_staged

    def recorded_promote(expected=None):
        flips.append(id(expected) in ladder_done)
        return promote(expected=expected)

    layer.manager.promote_staged = recorded_promote
    base = f"http://127.0.0.1:{port}"
    try:
        with httpx.Client(base_url=base, timeout=60) as client:
            deadline = time.monotonic() + 60
            while not (client.get("/readyz").status_code == 200
                       and layer._warmer.warmed_models >= 1):
                assert time.monotonic() < deadline, "gen1 never became warm-ready"
                time.sleep(0.1)
            assert layer.manager.get_model().features == 4
            stop = threading.Event()
            responses: list = []

            def traffic():
                with httpx.Client(base_url=base, timeout=60) as c:
                    while not stop.is_set():
                        r = c.get("/recommend/u0?considerKnownItems=true")
                        responses.append(
                            (r.status_code, r.headers.get("x-oryx-model-generation")))

            t = threading.Thread(target=traffic, daemon=True)
            t.start()
            try:
                for key, message in gen2:
                    prod.send(key, message)
                deadline = time.monotonic() + 90
                while layer.manager.get_model().features != 5:
                    assert time.monotonic() < deadline, "staged generation never promoted"
                    staged = layer.manager.get_staged_model()
                    if staged is not None:
                        lineage = client.get("/lineage").json()
                        # staged, not live, until the flip
                        assert lineage["live"]["generation"] == "anon-1"
                    time.sleep(0.05)
                time.sleep(0.3)  # answers after the flip
            finally:
                stop.set()
                t.join(timeout=30)
            assert responses and all(s == 200 for s, _ in responses), (
                sorted({s for s, _ in responses}))
            gens = [g for _, g in responses]
            assert gens[-1] == "anon-2"
            assert "anon-1" not in gens[gens.index("anon-2"):]
            assert layer._warmer.promoted_models >= 1
            assert layer.manager.get_staged_model() is None
            assert flips and all(flips)
            assert _counter("oryx_serving_prewarmed_swaps_total") == prewarmed + 1
            assert client.get("/lineage").json()["live"]["generation"] == "anon-2"
            for i in range(10):
                r = client.get(f"/recommend/u{i}")
                assert r.status_code == 200
                assert all(rec["id"] not in known2.get(f"u{i}", [])
                           for rec in r.json())
            assert served and all(done for _, done in served)
            gen2_model = id(layer.manager.get_model())
            assert gen2_model in {m for m, _ in served}
    finally:
        layer.close()
        tp.reset_memory_brokers()
        compilecache.warmup_state().reset()


def test_swap_deadline_promotes_unwarmed(tmp_path):
    """The reference's deadline case: a staged generation that no warmer
    promotes (here: none runs) is promoted by the swap deadline, counted
    in ``oryx_serving_swap_deadline_promotions_total``."""
    config = cfg.overlay_on({
        "oryx.serving.compute.precompile-batches": True,
        "oryx.compile.swap-deadline-sec": 0.2,
        "oryx.serving.model-manager-class": _MANAGER,
    }, cfg.get_default())
    manager = ALSServingModelManager(config, device="cpu")
    (gen1, _), (gen2, _) = (_generation(tmp_path, "g1", 4, 0),
                            _generation(tmp_path, "g2", 5, 1))
    manager.consume_key_message(*gen1[0])
    assert manager.get_model() is not None
    manager.consume_key_message(*gen2[0])
    assert manager.get_model().features == 4
    assert manager.get_staged_model().features == 5
    before = _counter("oryx_serving_swap_deadline_promotions_total")
    time.sleep(0.25)
    assert manager.get_model().features == 5  # deadline valve promoted
    assert manager.get_staged_model() is None
    assert _counter("oryx_serving_swap_deadline_promotions_total") == before + 1


def _view(model) -> "tuple | None":
    """(features, item ids and rows, user ids, fraction loaded)."""
    if model is None:
        return None
    items = sorted(model.y.ids())
    return (model.features, items,
            np.stack([model.get_item_vector(i) for i in items]) if items else None,
            sorted(model.x.ids()), model.get_fraction_loaded())


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return (a[0] == b[0] and a[1] == b[1] and a[3] == b[3] and a[4] == b[4]
            and (a[2] is b[2] or np.array_equal(a[2], b[2])))


def test_both_packages_hold_the_same_generations_through_a_staged_swap(tmp_path):
    overlay = {"oryx.serving.compute.precompile-batches": True,
               "oryx.compile.swap-deadline-sec": 0}
    ref = RefManager(ref_cfg.overlay_on(overlay, ref_cfg.get_default()))
    port = ALSServingModelManager(cfg.overlay_on(overlay, cfg.get_default()),
                                  device="cpu")
    gen1, _ = _generation(tmp_path, "g1", 4, 0)
    gen2, known2 = _generation(tmp_path, "g2", 5, 1)

    def step(messages):
        for key, message in messages:
            ref.consume_key_message(key, message)
            port.consume_key_message(key, message)
        for getter in ("get_model", "get_staged_model"):
            assert _same(_view(getattr(ref, getter)()),
                         _view(getattr(port, getter)())), getter

    step(gen1[:1])  # the first MODEL goes live at once
    assert port.get_model().features == 4 and port.get_staged_model() is None
    step(gen1[1:])
    step(gen2[:1])  # new features: staged behind the live generation
    assert port.get_model().features == 4
    assert port.get_staged_model().features == 5
    step(gen2[1:])  # the UPs fill the staged generation only
    assert port.get_staged_model().get_fraction_loaded() == 1.0
    assert ref.promote_staged(expected=ref.get_staged_model())
    assert port.promote_staged(expected=port.get_staged_model())
    step([])
    assert port.get_model().features == 5
    ref_model, port_model = ref.get_model(), port.get_model()
    for u in sorted(known2):
        q = port_model.get_user_vector(u)
        np.testing.assert_array_equal(q, ref_model.get_user_vector(u))
        want = ref_model.top_n(q, 5, excluded=known2[u])
        got = port_model.top_n(q, 5, excluded=known2[u])
        assert [i for i, _ in got] == [i for i, _ in want], u
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   rtol=1e-5)


@pytest.mark.parametrize("prewarm", [True, False])
def test_ups_fill_the_generation_the_topic_describes(tmp_path, prewarm):
    """With the staged swap a second MODEL's UPs land in the staged model
    and the live one is untouched; without it the new generation goes live
    at once and takes them."""
    manager = ALSServingModelManager(cfg.overlay_on({
        "oryx.serving.compute.precompile-batches": True,
        "oryx.compile.prewarm-swap": prewarm,
        "oryx.compile.swap-deadline-sec": 0}, cfg.get_default()), device="cpu")
    gen1, _ = _generation(tmp_path, "g1", 4, 0)
    gen2, _ = _generation(tmp_path, "g2", 5, 1)
    for key, message in gen1:
        manager.consume_key_message(key, message)
    live = manager.get_model()
    before = _view(live)
    for key, message in gen2:
        manager.consume_key_message(key, message)
    if prewarm:
        assert manager.get_model() is live and _same(_view(live), before)
        assert manager.get_staged_model().get_fraction_loaded() == 1.0
    else:
        assert manager.get_staged_model() is None
        assert manager.get_model().features == 5
        assert manager.get_model().get_fraction_loaded() == 1.0


def test_smoke_serving_swap_phase_on_a_small_loop(tmp_path, monkeypatch):
    """``chip_smoke.serving_swap_phase`` on a ``LambdaLoop`` at 300 users ×
    120 items (k = 4) on the CPU, generation 2 at k = 6 on the first 150
    users' lines, 1 s windows: the staged run's checks as strict as on the
    card (no 5xx, headers never back, one prewarmed promotion, generation
    2's answers), the contrast run, the deadline valve, and generation 2's
    launches counted as the wrappers count them (the fused path's plain
    versions stand in for the kernels)."""
    import chip_smoke as cs
    from oryx_tpu_torch.models.als import train as tr
    from oryx_tpu_torch.ops import kernels as K

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(tr, "_resolve_paths", lambda *a: (True, True))
    gg, spd = tr.gather_gramian_accumulate, tr.spd_solve_batched

    def counted_gg(*args, **kwargs):
        K._count("gather_gramian_accumulate", cs.gg_key(args, kwargs))
        return gg(*args, **kwargs)

    def counted_spd(a, b):
        K._count("spd_solve_batched", tuple(b.shape),
                 "spd_solve_batched." + K.spd_variant(b.shape[1]))
        return spd(a, b)

    monkeypatch.setattr(tr, "gather_gramian_accumulate", counted_gg)
    monkeypatch.setattr(tr, "spd_solve_batched", counted_spd)
    for name, value in dict(FEATURES=4, SWAP_FEATURES=6, SWAP_USERS=150,
                            SWAP_WINDOW_S=1.0, HTTP_USERS=30,
                            SWAP_CHECKED=10).items():
        monkeypatch.setattr(cs, name, value)
    rng = np.random.default_rng(11)
    u_f, i_f = rng.standard_normal((300, 2)), rng.standard_normal((120, 2))
    p = np.exp(u_f @ i_f.T)
    p /= p.sum(axis=1, keepdims=True)
    lines = [f"u{u},i{rng.choice(120, p=p[u])},1,{t}"
             for t, u in enumerate(rng.integers(0, 300, 3_000).tolist())]
    loop = cs.LambdaLoop(str(tmp_path), {
        "oryx.id": "swap",
        "oryx.batch.streaming.config.platform": "cpu",
        "oryx.speed.streaming.config.platform": "cpu",
        "oryx.als.hyperparams.features": 4,
        "oryx.als.iterations": 2,
    }, broker="memory:", serving_device="cpu")
    try:
        loop.run_batch(lines, 0.2, 0.5, 120)
        out = cs.serving_swap_phase(
            loop, [ln for ln in lines if int(ln[1:ln.index(",")]) < 150],
            np.random.default_rng(3), device="cpu")
    finally:
        loop.close()
        loop.await_layers()
        tp.reset_memory_brokers()
    swap, contrast = out["swap"], out["contrast"]
    assert swap["server_errors"] == 0 and swap["threads_left"] == []
    assert set(swap["windows"]) == {"before", "staged", "staged_after_append",
                                    "after"}
    assert swap["windows"]["before"]["requests"] > 0
    assert swap["windows"]["after"]["requests"] > 0
    assert swap["stage_to_promote_s"] > 0 and swap["warm_ladder_s"] > 0
    assert swap["gen2_answers_checked"]["requests"] == 20
    assert set(contrast["windows"]) == {"before", "loading",
                                        "loading_after_append", "after"}
    assert contrast["counters"]["oryx_serving_prewarmed_swaps_total"] == 0
    assert out["deadline"]["counter_delta"] == 1
    gen2 = out["gen2"]
    blocks = sum(gen2["blocks"].values())
    assert out["launches"] == {"gather_gramian_accumulate": 3 * blocks,
                               "spd_solve_batched": 3 * blocks}
    assert len(gen2["held_against_plain"]) >= 2


def test_smoke_top_n_check_takes_a_tie_at_the_cut_only():
    """``chip_smoke.check_same_top_n``'s ``beyond``: an id ranked just past
    the cut may stand in for the last answer only where their scores tie
    (within ``HTTP_REL``); an id that does not tie still fails."""
    import chip_smoke as cs

    want = [("a", 3.0), ("b", 2.0)]
    got = [{"id": "a", "value": 3.0}, {"id": "c", "value": 2.0}]
    cs.check_same_top_n(got, want, "tie", beyond=[("c", 2.0 - 1e-6)])
    with pytest.raises(cs.SmokeFailure):
        cs.check_same_top_n(got, want, "no tie", beyond=[("c", 1.9)])
    with pytest.raises(cs.SmokeFailure):
        cs.check_same_top_n(got, want, "nothing beyond")


def test_smoke_top_n_check_takes_any_tie_of_the_cuts_group():
    """A tie group of three across the cut: the answer may hold the
    reference's 12th in place of its 10th where all three tie (the failure
    a single ``beyond`` answer gave), each stand-in is recorded with both
    scores, and an untied 12th still fails."""
    import chip_smoke as cs

    want = [("a", 3.0), ("b", 2.0)]
    got = [{"id": "a", "value": 3.0}, {"id": "d", "value": 2.0 - 1e-6}]
    ties: list = []
    cs.check_same_top_n(got, want, "tie", beyond=[("c", 2.0 - 5e-7), ("d", 2.0 - 9e-6)],
                        ties=ties)
    assert ties == [{"label": "tie", "id": "d", "got": 2.0 - 1e-6,
                     "ref": 2.0 - 9e-6, "cut": 2.0}]
    with pytest.raises(cs.SmokeFailure):
        cs.check_same_top_n(got, want, "no tie", beyond=[("c", 2.0 - 5e-7), ("d", 1.9)])
    ties.clear()
    cs.check_same_top_n([{"id": i, "value": v} for i, v in want], want, "same",
                        beyond=[("c", 2.0)], ties=ties)
    assert ties == []
