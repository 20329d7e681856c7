"""The factor arena's sizing knobs (``oryx.serving.arena.*``) on the port's
``FeatureVectorStore``, held to the reference's store.

Both packages' stores go through the same bulk load, point writes,
``reserve``, removals, retain and a reload, under the defaults and under
``initial-rows = 7, min-fill = 0.5``: after every step the slab's capacity
and the live rows are equal. Then the reference's first two arena cases
(``tests/test_factor_arena.py:35``, ``:47``) through :func:`_mirror`, the
clamps of ``configure`` beside the reference's, and the serving app and a
lambda layer applying the knobs as the reference's do.
"""

from __future__ import annotations

import numpy as np
import pytest

from oryx_tpu.models.als import vectors as ref_vectors
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.models.als import vectors
from test_torch_observability import _mirror


@pytest.fixture(autouse=True)
def _default_knobs():
    yield
    vectors.configure(cfg.get_default())
    ref_vectors.configure(cfg.get_default())


def _configure(settings: dict) -> None:
    conf = cfg.overlay_on(settings, cfg.get_default())
    vectors.configure(conf)
    ref_vectors.configure(conf)


def _state(store) -> tuple:
    slab = store._slab
    return (0 if slab is None else slab.shape[0], store.size(), store.ids())


def _vec(rng, k: int = 3):
    return rng.standard_normal(k).astype(np.float32)


def _steps(rng):
    """(label, fn(store)) pairs: the same writes on either package."""
    ids = [f"x{i}" for i in range(1500)]
    mat = rng.standard_normal((1500, 3)).astype(np.float32)
    more = [f"y{i}" for i in range(900)]
    more_mat = rng.standard_normal((900, 3)).astype(np.float32)
    dup = ["d0", "d1", "d0", "d2"]
    dup_mat = rng.standard_normal((4, 3)).astype(np.float32)
    points = [(f"p{i}", _vec(rng)) for i in range(25)]
    return [
        ("set one", lambda s: s.set_vector("a", points[0][1])),
        ("points", lambda s: [s.set_vector(i, v) for i, v in points]),
        ("rewrite a held id", lambda s: s.set_vector("p3", points[4][1])),
        ("bulk load", lambda s: s.bulk_load(ids, mat)),
        ("bulk load, half held", lambda s: s.bulk_load(ids[750:] + more, np.concatenate(
            [mat[750:], more_mat]))),
        ("duplicates", lambda s: s.bulk_load(dup, dup_mat)),
        ("reserve", lambda s: s.reserve(5000)),
        ("remove one", lambda s: s.remove_vector("x5")),
        ("remove unknown", lambda s: s.remove_vector("nope")),
        ("retain: end the recent set", lambda s: s.retain_recent_and_ids(set())),
        ("points after", lambda s: [s.set_vector(i, v) for i, v in points[:6]]),
        ("retain a few", lambda s: s.retain_recent_and_ids({"x1", "x30", "y2"} | set(ids[:500]))),
        ("remove down", lambda s: [s.remove_vector(i) for i in ("x1", "p0", "p1")]),
        ("retain none", lambda s: s.retain_recent_and_ids(set())),
        ("retain none again", lambda s: s.retain_recent_and_ids(set())),
        ("reload", lambda s: s.bulk_load(more, more_mat)),
        ("grow by points", lambda s: [s.set_vector(f"q{i}", v)
                                      for i, (_, v) in enumerate(points)]),
    ]


@pytest.mark.parametrize("settings", [
    {},
    {"oryx.serving.arena.initial-rows": 7, "oryx.serving.arena.min-fill": 0.5},
], ids=["defaults", "initial-rows-7-min-fill-0.5"])
@pytest.mark.parametrize("first", ["point", "bulk", "reserve"])
def test_capacity_and_live_rows_equal_the_reference_after_every_step(settings, first):
    _configure(settings)
    port, ref = vectors.FeatureVectorStore(), ref_vectors.FeatureVectorStore()
    rng = np.random.default_rng(5)
    steps = _steps(rng)
    if first == "bulk":
        steps.insert(0, steps.pop(3))
    elif first == "reserve":
        steps.insert(0, ("reserve first", lambda s: s.reserve(50)))
    seen = set()
    for label, step in steps:
        step(port)
        step(ref)
        assert _state(port) == _state(ref), label
        seen.add(_state(ref)[0])
    # the sequence really grew and shrank the slab
    assert len(seen) >= 3, seen


def test_configure_clamps_as_the_reference_does():
    for settings in ({"oryx.serving.arena.initial-rows": 0,
                      "oryx.serving.arena.min-fill": 2.0},
                     {"oryx.serving.arena.initial-rows": -5,
                      "oryx.serving.arena.min-fill": -1.0},
                     {"oryx.serving.arena.initial-rows": 33,
                      "oryx.serving.arena.min-fill": 0.1}):
        _configure(settings)
        assert (vectors._DEFAULT_INITIAL_ROWS, vectors._DEFAULT_MIN_FILL) == (
            ref_vectors._DEFAULT_INITIAL_ROWS, ref_vectors._DEFAULT_MIN_FILL)
    assert (vectors._DEFAULT_INITIAL_ROWS, vectors._DEFAULT_MIN_FILL) == (33, 0.1)
    # a store keeps the initial rows it was made with
    store = vectors.FeatureVectorStore()
    _configure({"oryx.serving.arena.initial-rows": 2})
    store.set_vector("a", np.ones(2, np.float32))
    assert store._slab.shape[0] == 33


def test_serving_app_and_layer_apply_the_knobs():
    from oryx_tpu_torch.lambda_rt.layer import AbstractLayer
    from oryx_tpu_torch.serving.app import make_app

    conf = cfg.overlay_on({"oryx.serving.arena.initial-rows": 9,
                           "oryx.serving.arena.min-fill": 0.75}, cfg.get_default())
    make_app(conf, None)
    assert (vectors._DEFAULT_INITIAL_ROWS, vectors._DEFAULT_MIN_FILL) == (9, 0.75)
    vectors.configure(cfg.get_default())
    AbstractLayer(conf.with_values({"oryx.serving.arena.initial-rows": 11}), "speed")
    assert (vectors._DEFAULT_INITIAL_ROWS, vectors._DEFAULT_MIN_FILL) == (11, 0.75)


_REF = _mirror("test_factor_arena.py", {"FeatureVectorStore": vectors.FeatureVectorStore})
test_arena_grows_by_doubling_and_preserves_values = _REF[
    "test_arena_grows_by_doubling_and_preserves_values"]
test_removed_rows_repack_without_capacity_growth = _REF[
    "test_removed_rows_repack_without_capacity_growth"]
