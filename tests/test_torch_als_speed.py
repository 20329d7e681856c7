"""The port's ALS speed tier against the reference's, on the same inputs.

* ``ops/solver``: ``get_solver`` / ``Solver.solve`` give the reference's
  bits, a singular Gramian the reference's apparent rank, and
  ``SolverCache`` keeps its single-flight and dirty semantics;
* ``models/als/foldin``: the target estimate and the single and batched
  fold-ins give the reference's bits, implicit and explicit;
* ``common/lockutils``: the rate limit and the readers-writer lock;
* ``ALSSpeedModelManager``: both packages' managers, fed the same ``MODEL``
  + ``UP`` stream and the same microbatch, emit the same ``UP`` strings,
  byte for byte, with ``no-known-items`` on and off, behind the same
  load-fraction gate, and across ``MODEL`` handoffs with and without a
  feature change;
* the whole loop: the speed ``UP``s served by both packages' serving
  managers give the same top-N (scores within 1e-5, the bound of
  ``tests/test_torch_als_update.py``).
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from oryx_tpu.api.keymessage import KeyMessage as RefKeyMessage
from oryx_tpu.common import config as ref_cfg
from oryx_tpu.common import lockutils as ref_lockutils
from oryx_tpu.models.als import foldin as ref_foldin
from oryx_tpu.models.als.serving import ALSServingModelManager as RefServing
from oryx_tpu.models.als.speed import ALSSpeedModelManager as RefSpeed
from oryx_tpu.ops import solver as ref_solver
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import lockutils
from oryx_tpu_torch.models.als import foldin, pmml_codec
from oryx_tpu_torch.models.als.serving import ALSServingModelManager
from oryx_tpu_torch.models.als.speed import ALSSpeedModelManager
from oryx_tpu_torch.ops import solver
from oryx_tpu_torch.pmml import pmmlutils
from chip_smoke import settle_solvers

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

SCORE_TOL = 1e-5
K = 6


def _spd(rng, k):
    m = rng.standard_normal((3 * k, k))
    return m.T @ m


# -- ops/solver ------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 10, 50])
def test_solver_solves_with_the_reference_bits(k):
    rng = np.random.default_rng(k)
    gram = _spd(rng, k).astype(np.float32)
    b = rng.standard_normal((7, k))
    got, want = solver.get_solver(gram), ref_solver.get_solver(gram)
    assert np.array_equal(got.solve(b), want.solve(b))
    assert np.array_equal(got.solve(b[0]), want.solve(b[0]))
    assert np.array_equal(got.solve_f_to_f(b), want.solve_f_to_f(b))
    assert got.solve_d_to_d(b).dtype == np.float64
    np.testing.assert_allclose(gram.astype(np.float64) @ got.solve(b).T, b.T,
                               rtol=1e-6, atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("case", ["rank2of3", "zero", "tiny-direction", "rank5of8"])
def test_singular_gramian_gives_the_reference_apparent_rank(case):
    rng = np.random.default_rng(3)
    if case == "rank2of3":
        m = np.diag([1.0, 1.0, 0.0])
    elif case == "zero":
        m = np.zeros((4, 4))
    elif case == "tiny-direction":
        m = np.diag([1.0, 1.0, 1e-7])  # below 1e-5 of the largest
    else:
        v = rng.standard_normal((5, 8))
        m = v.T @ v
    with pytest.raises(solver.SingularMatrixSolverException) as got:
        solver.get_solver(m)
    with pytest.raises(ref_solver.SingularMatrixSolverException) as want:
        ref_solver.get_solver(m)
    assert got.value.apparent_rank == want.value.apparent_rank
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not square"):
        solver.get_solver(np.zeros((2, 3)))


@pytest.mark.parametrize("module", [solver, ref_solver], ids=["port", "reference"])
def test_solver_cache_single_flight_and_dirty(module):
    """tests/test_math.py's case, on both packages: a clean cache does not
    recompute; a dirty one recomputes in the background."""
    calls = []
    vecs = np.eye(3, dtype=np.float32) * 2.0

    def compute():
        calls.append(1)
        return vecs.T @ vecs

    cache = module.SolverCache(compute)
    s1 = cache.get(blocking=True)
    assert s1 is not None and len(calls) == 1
    assert cache.get(blocking=True) is s1 and len(calls) == 1
    cache.compute_now()  # clean: nothing to do
    assert len(calls) == 1
    cache.set_dirty()
    cache.compute_now()
    deadline = time.monotonic() + 10
    while len(calls) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(calls) == 2
    deadline = time.monotonic() + 10
    while cache.get(blocking=False) is s1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cache.get(blocking=False) is not s1


@pytest.mark.parametrize("module", [solver, ref_solver], ids=["port", "reference"])
def test_solver_cache_computes_once_for_concurrent_first_gets(module):
    """Eight threads asking a cold cache at once: one computation, and every
    caller gets its solver."""
    calls = []

    def compute():
        calls.append(1)
        time.sleep(0.2)
        return np.eye(4) * 3.0

    cache = module.SolverCache(compute)
    got = []
    threads = [threading.Thread(target=lambda: got.append(cache.get(blocking=True)))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(got) == 8
    assert all(s is got[0] and s is not None for s in got)


@pytest.mark.parametrize("module", [solver, ref_solver], ids=["port", "reference"])
def test_solver_cache_keeps_the_last_solver_on_a_singular_gramian(module):
    grams = [np.eye(3), np.zeros((3, 3))]
    cache = module.SolverCache(lambda: grams[0])
    first = cache.get(blocking=True)
    grams[0] = grams[1]
    cache.set_dirty()
    cache._maybe_launch(wait=True)  # the recompute, in this thread
    assert cache.get(blocking=True) is first
    empty = module.SolverCache(lambda: None)
    assert empty.get(blocking=True) is None  # no data: no solver, no hang


# -- models/als/foldin ------------------------------------------------------------


def test_target_qui_is_the_reference_target():
    for implicit in (True, False):
        for value in (-3.0, -0.5, 0.0, 0.25, 1.0, 4.0):
            for current in (-0.5, 0.0, 0.3, 0.5, 0.99, 1.0, 1.7):
                got = foldin.compute_target_qui(implicit, value, current)
                want = ref_foldin.compute_target_qui(implicit, value, current)
                assert (np.isnan(got) and np.isnan(want)) or got == want


def _foldin_inputs(seed, b=64, k=K):
    rng = np.random.default_rng(seed)
    gram = _spd(rng, k).astype(np.float32)
    values = np.round(rng.standard_normal(b) * 2, 2)
    values[:4] = [0.0, 1.0, -1.0, 5.0]
    xus = rng.standard_normal((b, k)).astype(np.float32) * 0.4
    yis = rng.standard_normal((b, k)).astype(np.float32) * 0.4
    has_xu = rng.random(b) < 0.8
    has_yi = rng.random(b) < 0.9
    return gram, values, xus, has_xu, yis, has_yi


@pytest.mark.parametrize("implicit", [True, False], ids=["implicit", "explicit"])
def test_batched_fold_in_gives_the_reference_bits(implicit):
    gram, values, xus, has_xu, yis, has_yi = _foldin_inputs(11)
    got = foldin.compute_updated_batch(solver.get_solver(gram), values, xus,
                                       has_xu, yis, has_yi, implicit)
    want = ref_foldin.compute_updated_batch(ref_solver.get_solver(gram), values,
                                            xus, has_xu, yis, has_yi, implicit)
    assert np.array_equal(got[1], want[1]) and got[1].any() and not got[1].all()
    assert np.array_equal(got[0][got[1]], want[0][want[1]])


@pytest.mark.parametrize("implicit", [True, False], ids=["implicit", "explicit"])
def test_single_fold_in_gives_the_reference_bits(implicit):
    gram, values, xus, has_xu, yis, has_yi = _foldin_inputs(12, b=24)
    port_s, ref_s = solver.get_solver(gram), ref_solver.get_solver(gram)
    seen = set()
    for b in range(24):
        xu = xus[b] if has_xu[b] else None
        yi = yis[b] if has_yi[b] else None
        got = foldin.compute_updated_xu(port_s, values[b], xu, yi, implicit)
        want = ref_foldin.compute_updated_xu(ref_s, values[b], xu, yi, implicit)
        seen.add(got is None)
        assert (got is None and want is None) or np.array_equal(got, want)
    assert seen == {True, False}


# -- common/lockutils ---------------------------------------------------------------


@pytest.mark.parametrize("module", [lockutils, ref_lockutils], ids=["port", "reference"])
def test_rate_limit_check_passes_once_per_interval(module):
    check = module.RateLimitCheck(60)
    assert [check.test() for _ in range(3)] == [True, False, False]
    fast = module.RateLimitCheck(0.05)
    assert fast.test() and not fast.test()
    time.sleep(0.06)
    assert fast.test()
    with pytest.raises(ValueError):
        module.RateLimitCheck(0)


def test_read_write_lock_shares_reads_and_excludes_a_writer():
    lock = lockutils.AutoReadWriteLock()
    inside, events = [], []

    def read():
        with lock.read():
            inside.append(1)

    with lock.read():
        reader = threading.Thread(target=read)
        reader.start()
        reader.join(timeout=10)
        assert inside == [1]  # a second reader got in beside the first

        def write():
            with lock.write():
                events.append("write")

        writer = threading.Thread(target=write)
        writer.start()
        time.sleep(0.05)
        assert events == []  # the writer waits for the reader
    writer.join(timeout=10)
    assert not writer.is_alive() and events == ["write"]


# -- the speed managers ------------------------------------------------------------


def _configs(extra=None):
    over = {"oryx.als.hyperparams.features": K}
    over.update(extra or {})
    return (cfg.overlay_on(over, cfg.get_default()),
            ref_cfg.overlay_on(over, ref_cfg.get_default()))


def _stream(tmp_path, n_users=40, n_items=25, k=K, implicit=True, seed=5,
            name="m"):
    """A generation's update stream: ``MODEL`` (inline PMML) first, a ``Y``
    ``UP`` per item, then an ``X`` ``UP`` per user with its known items,
    as ``ALSUpdate`` publishes it. Returns the messages and the factors."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_users, k)) * 0.5).astype(np.float32)
    y = (rng.standard_normal((n_items, k)) * 0.5).astype(np.float32)
    users = [f"u{i}" for i in range(n_users)]
    items = [f"i{i}" for i in range(n_items)]
    pmml = pmml_codec.model_to_pmml(x, y, users, items, k, 0.1, 1.0, implicit,
                                    False, 1e-5, tmp_path / name)
    msgs = [("MODEL", pmmlutils.to_string(pmml))]
    msgs += [("UP", json.dumps(["Y", i, v.tolist()])) for i, v in zip(items, y)]
    for u, (user, v) in enumerate(zip(users, x)):
        known = sorted(items[j] for j in rng.choice(n_items, 3, replace=False))
        msgs.append(("UP", json.dumps(["X", user, v.tolist(), known])))
    return msgs


def _microbatch(seed, n=120, n_users=40, n_items=25, explicit=False):
    """``user,item,value,ts`` lines over known and new users and items,
    with repeated pairs (aggregated) and, implicit, negative values."""
    rng = np.random.default_rng(seed)
    lines = []
    for t in range(n):
        u = rng.integers(0, n_users + 6)
        i = rng.integers(0, n_items + 4)
        if explicit:
            value = f"{rng.integers(1, 6)}"
        else:
            value = f"{rng.choice([1.0, 1.0, 2.5, -1.0, 0.5])}"
        lines.append(f"u{u},i{i},{value},{1000 + t}")
    lines.append("not a line")
    return lines


def _feed(managers, msgs):
    for mgr in managers:
        is_ref = isinstance(mgr, (RefSpeed, RefServing))
        cls = RefKeyMessage if is_ref else KeyMessage
        mgr.consume(cls(k, m) for k, m in msgs)


def _build(mgr, lines):
    cls = RefKeyMessage if isinstance(mgr, RefSpeed) else KeyMessage
    if mgr.model is not None:
        # both packages hand out the previous solver while a recompute
        # runs: bring the caches current so both fold in alike
        settle_solvers([mgr.model.xtx_cache, mgr.model.yty_cache])
    return list(mgr.build_updates([cls(None, ln) for ln in lines]))


def _speed_pair(extra=None):
    conf, ref_conf = _configs(extra)
    return ALSSpeedModelManager(conf), RefSpeed(ref_conf)


@pytest.mark.parametrize("no_known", [False, True], ids=["known-items", "no-known-items"])
@pytest.mark.parametrize("implicit", [True, False], ids=["implicit", "explicit"])
def test_speed_updates_are_the_reference_bytes(tmp_path, implicit, no_known):
    extra = {"oryx.als.implicit": implicit, "oryx.als.no-known-items": no_known}
    speed, ref_speed = _speed_pair(extra)
    _feed((speed, ref_speed), _stream(tmp_path, implicit=implicit))
    assert speed.model.get_fraction_loaded() == 1.0
    for seed in (1, 2):  # the second microbatch after hearing the first's UPs
        lines = _microbatch(seed, explicit=not implicit)
        got, want = _build(speed, lines), _build(ref_speed, lines)
        assert got == want and len(got) > 40
        ups = [json.loads(u) for u in got]
        assert {u[0] for u in ups} == {"X", "Y"}
        assert all(len(u) == (3 if no_known else 4) for u in ups)
        assert speed.report["updates"] == len(got)
        assert {"prepare_s", "solver_s", "gather_s", "foldin_s",
                "format_s"} <= set(speed.report)
        _feed((speed, ref_speed), [("UP", u) for u in got])
    assert speed.model.x.ids() == ref_speed.model.x.ids()
    assert speed.model.y.ids() == ref_speed.model.y.ids()


def test_speed_waits_for_the_load_fraction_as_the_reference(tmp_path):
    speed, ref_speed = _speed_pair()
    lines = _microbatch(3)
    assert _build(speed, lines) == _build(ref_speed, lines) == []  # no model
    msgs = _stream(tmp_path)
    fed = 0
    for n in (1, 20, 40, 52, len(msgs)):
        _feed((speed, ref_speed), msgs[fed:n])
        fed = n
        assert speed.model.get_fraction_loaded() == \
            ref_speed.model.get_fraction_loaded()
    assert speed.model.get_fraction_loaded() == 1.0
    speed2, ref_speed2 = _speed_pair()
    _feed((speed2, ref_speed2), msgs[:50])  # below the 0.8 default
    assert speed2.model.get_fraction_loaded() < 0.8
    assert _build(speed2, lines) == _build(ref_speed2, lines) == []
    _feed((speed2, ref_speed2), msgs[50:])
    got = _build(speed2, lines)
    assert got and got == _build(ref_speed2, lines)
    # the speed tier ignores UPs before any model, as the reference
    speed3, ref_speed3 = _speed_pair()
    _feed((speed3, ref_speed3), msgs[1:3])
    assert speed3.model is None and ref_speed3.model is None
    with pytest.raises(ValueError, match="bad update type"):
        speed2.consume_key_message("UP", json.dumps(["Z", "a", [1.0]]))
    with pytest.raises(ValueError, match="bad key"):
        speed2.consume_key_message("NOPE", "")


@pytest.mark.parametrize("new_features", [False, True], ids=["same-features", "new-features"])
def test_speed_model_handoff_is_the_reference_handoff(tmp_path, new_features):
    speed, ref_speed = _speed_pair()
    _feed((speed, ref_speed), _stream(tmp_path))
    first = speed.model
    lines = _microbatch(4)
    _feed((speed, ref_speed), [("UP", u) for u in _build(speed, lines)])
    _build(ref_speed, lines)
    # the next generation: fewer users and items, or another width
    k = K + 2 if new_features else K
    msgs = _stream(tmp_path, n_users=30, n_items=18, k=k, seed=9, name="m2")
    _feed((speed, ref_speed), msgs[:1])
    assert (speed.model is not first) == new_features
    for side in ("x", "y"):
        assert getattr(speed.model, side).ids() == getattr(ref_speed.model, side).ids()
    assert speed.model.expected_user_ids == ref_speed.model.expected_user_ids
    assert speed.model.expected_item_ids == ref_speed.model.expected_item_ids
    _feed((speed, ref_speed), msgs[1:])
    lines = _microbatch(5)
    got = _build(speed, lines)
    assert got and got == _build(ref_speed, lines)


# -- the whole loop ------------------------------------------------------------------


def test_speed_updates_serve_alike_in_both_packages(tmp_path):
    """Generation stream, then two speed microbatches whose UPs both speed
    managers hear and both serving managers apply: the same ids, known
    items and top-N."""
    conf, ref_conf = _configs()
    speed, ref_speed = _speed_pair()
    serving = ALSServingModelManager(conf, device="cpu")
    ref_serving = RefServing(ref_conf)
    managers = (speed, ref_speed, serving, ref_serving)
    _feed(managers, _stream(tmp_path))
    for seed in (6, 7):
        lines = _microbatch(seed)
        ups = _build(speed, lines)
        assert ups == _build(ref_speed, lines)
        _feed(managers, [("UP", u) for u in ups])
    model, ref_model = serving.get_model(), ref_serving.get_model()
    assert model.all_item_ids() == ref_model.all_item_ids()
    assert sorted(model.all_user_ids()) == sorted(ref_model.all_user_ids())
    users = sorted(model.all_user_ids())
    assert {u: model.get_known_items(u) for u in users} == \
        {u: ref_model.get_known_items(u) for u in users}
    qs = np.stack([model.get_user_vector(u) for u in users])
    excluded = [model.get_known_items(u) for u in users]
    got = model.top_n_batch(qs, 5, excluded=excluded)
    want = ref_model.top_n_batch(qs, 5, excluded=excluded)
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   rtol=0, atol=SCORE_TOL)
    assert model.y.materializations["full"] == 1
