"""The port's incremental device snapshot and serving fold-in API.

* the reference's ``tests/test_incremental_snapshot.py`` cases on the
  port's ``FeatureVectorStore`` (device: the CPU): point updates and
  appends cross to the device as their rows only (counted at the
  ``_host_gather`` seam), never as a whole re-upload; the incremental
  matrix equals a whole rebuild; a structural change (removal, retain,
  bulk load) forces one; the delta chain survives interleaved consumers;
  a matrix or snapshot once handed out never changes, and the transition
  log does not keep old matrices alive;
* the serving model's API against the reference's ``ALSServingModel`` on
  the same stream: ``dot_with_items``, ``item_counts``, ``user_counts``
  and ``get_known_item_vectors_for_user`` exactly; ``top_n_cosine`` the
  same ids with scores within 1e-5; ``get_yty_solver().solve`` and
  ``build_temporary_user_vector`` within relative 1e-5 (both Gramians are
  float32 products, the reference's by XLA and the port's by torch, so
  they differ in the last bits, and the float64 solves carry that over).
"""

from __future__ import annotations

import gc
import json
import time
import weakref

import numpy as np
import pytest
import torch

from oryx_tpu.common import config as ref_cfg
from oryx_tpu.models.als.serving import ALSServingModelManager as RefServing
from oryx_tpu.api.keymessage import KeyMessage as RefKeyMessage
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.models.als import vectors as vmod
from oryx_tpu_torch.models.als.serving import ALSServingModel, ALSServingModelManager
from oryx_tpu_torch.models.als.vectors import FeatureVectorStore

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

CPU = torch.device("cpu")
SCORE_TOL = 1e-5
SOLVE_REL_TOL = 1e-5


@pytest.fixture
def gathered(monkeypatch):
    """Rows passing through the store's host→device gather, one entry per
    gather: a whole rebuild gathers every live row, an incremental step
    only its delta."""
    counts = []
    orig = vmod._host_gather

    def counting(slab, rows):
        out = orig(slab, rows)
        counts.append(len(out))
        return out

    monkeypatch.setattr(vmod, "_host_gather", counting)
    return counts


def _loaded_store(n=500, k=8, seed=0):
    rng = np.random.default_rng(seed)
    store = FeatureVectorStore()
    mat = rng.standard_normal((n, k)).astype(np.float32)
    store.bulk_load([f"i{i}" for i in range(n)], mat)
    return store, mat


def test_point_updates_do_not_reupload(gathered):
    store, _ = _loaded_store(n=500)
    ids0, mat0 = store.materialize(CPU)
    assert gathered == [500]  # the first build is whole
    before = mat0.clone()
    gathered.clear()
    upd = {f"i{i}": np.full(8, float(i), dtype=np.float32) for i in (3, 99, 250)}
    for id_, v in upd.items():
        store.set_vector(id_, v)
    ids1, mat1 = store.materialize(CPU)
    assert gathered == [3]  # only the delta crossed
    assert mat1 is not mat0 and torch.equal(mat0, before)
    changed, n_new = store.delta_since(mat0, mat1)
    assert changed.tolist() == [3, 99, 250] and n_new == 0
    for id_, v in upd.items():
        assert np.array_equal(mat1[ids1.index(id_)].numpy(), v)
    assert torch.equal(mat1[0], mat0[0])
    assert store.materializations == {"full": 1, "incremental": 1}
    assert store.materialize(CPU)[1] is mat1  # no write since: the same matrix


def test_new_ids_append_without_reupload(gathered):
    store, _ = _loaded_store(n=200)
    ids0, mat0 = store.materialize(CPU)
    held = list(ids0[:mat0.shape[0]])
    gathered.clear()
    store.set_vector("fresh1", np.ones(8, dtype=np.float32))
    store.set_vector("fresh2", 2 * np.ones(8, dtype=np.float32))
    store.set_vector("i4", 3 * np.ones(8, dtype=np.float32))
    ids1, mat1 = store.materialize(CPU)
    assert gathered == [3]
    assert mat1.shape == (202, 8) and list(ids1[200:202]) == ["fresh1", "fresh2"]
    assert store.delta_since(mat0, mat1)[0].tolist() == [4]
    assert store.delta_since(mat0, mat1)[1] == 2
    # the earlier snapshot's rows are named as before
    assert mat0.shape[0] == 200 and list(ids0[:200]) == held


def test_incremental_equals_full_rebuild():
    store, _ = _loaded_store(n=120)
    store.materialize(CPU)
    rng = np.random.default_rng(7)
    for i in rng.integers(0, 120, 20):
        store.set_vector(f"i{i}", rng.standard_normal(8).astype(np.float32))
    store.materialize(CPU)  # one incremental step ...
    store.set_vector("new", rng.standard_normal(8).astype(np.float32))
    store.set_vector("i5", rng.standard_normal(8).astype(np.float32))
    store.set_vector("new", rng.standard_normal(8).astype(np.float32))
    ids_inc, mat_inc = store.materialize(CPU)  # ... and another
    assert store.materializations == {"full": 1, "incremental": 2}
    fresh = FeatureVectorStore()
    for id_ in ids_inc[:mat_inc.shape[0]]:
        fresh.set_vector(id_, store.get_vector(id_))
    ids_full, mat_full = fresh.materialize(CPU)
    assert list(ids_inc[:mat_inc.shape[0]]) == list(ids_full)
    assert torch.equal(mat_inc, mat_full)
    host_ids, host, _, _ = store.host_matrix()
    assert torch.equal(mat_inc, torch.from_numpy(host))


@pytest.mark.parametrize("change", ["remove", "retain", "bulk_load"])
def test_structural_change_forces_a_rebuild(gathered, change):
    store, _ = _loaded_store(n=50)
    _, mat0 = store.materialize(CPU)
    store.set_vector("i3", np.ones(8, dtype=np.float32))  # a pending update
    gathered.clear()
    if change == "remove":
        store.remove_vector("i7")
        n = 49
    elif change == "retain":
        # every row was written since the (first) retain: all stay; then
        # only the named ones and i3, written since the first
        store.retain_recent_and_ids({f"i{i}" for i in range(10, 20)})
        store.set_vector("i3", np.ones(8, dtype=np.float32))
        store.retain_recent_and_ids({"i12"})
        n = 2
    else:
        store.bulk_load(["i1", "x"], np.zeros((2, 8), dtype=np.float32))
        n = 51
    ids, mat = store.materialize(CPU)
    assert gathered == [n] and mat.shape[0] == n
    assert store.delta_since(mat0, mat) is None  # the chain is cut
    assert store.materializations == {"full": 2, "incremental": 0}
    assert torch.equal(mat, torch.from_numpy(store.host_matrix()[1]))
    if change == "remove":
        assert "i7" not in list(ids[:n])
    store.remove_vector("absent")  # nothing to remove: nothing to rebuild
    assert store.materialize(CPU)[1] is mat


def test_delta_chain_survives_interleaved_consumers():
    """get_vtv between snapshot reads (host BLAS while the cache is stale,
    the cached matrix once it is current) must not break the chain."""
    store, _ = _loaded_store(n=100)
    _, mat0 = store.materialize(CPU)
    store.set_vector("i5", np.ones(8, dtype=np.float32))
    vtv_host = store.get_vtv()
    _, mat1 = store.materialize(CPU)
    vtv_dev = store.get_vtv()
    host = store.host_matrix()[1]
    np.testing.assert_allclose(vtv_host, host.T @ host, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(vtv_dev, host.T @ host, rtol=1e-6, atol=1e-4)
    store.set_vector("i9", 2 * np.ones(8, dtype=np.float32))
    store.set_vector("late", 3 * np.ones(8, dtype=np.float32))
    _, mat2 = store.materialize(CPU)
    changed, n_new = store.delta_since(mat0, mat2)
    assert changed.tolist() == [5, 9] and n_new == 1
    assert store.delta_since(mat1, mat2)[0].tolist() == [9]
    assert store.delta_since(mat2, mat0) is None


def test_transitions_hold_no_old_matrix_alive():
    store, _ = _loaded_store(n=30)
    _, mat = store.materialize(CPU)
    refs = []
    for i in range(3):
        store.set_vector(f"i{i}", np.full(8, float(i), dtype=np.float32))
        refs.append(weakref.ref(mat))
        _, mat = store.materialize(CPU)
    gc.collect()
    assert all(r() is None for r in refs)
    assert store.get_vtv() is not None and FeatureVectorStore().get_vtv() is None


def _serving_model(n=300, k=8, seed=3):
    rng = np.random.default_rng(seed)
    model = ALSServingModel(k, True, device="cpu")
    y = rng.standard_normal((n, k)).astype(np.float32)
    model.bulk_load_items([f"i{i}" for i in range(n)], y)
    model.bulk_load_users(["u0", "u1"], rng.standard_normal((2, k)).astype(np.float32))
    return model, rng


def test_held_snapshot_is_unchanged_by_later_updates(gathered):
    model, rng = _serving_model()
    snap0 = model.y_snapshot()
    mat0, norms0 = snap0.mat.clone(), snap0.norms.clone()
    q = rng.standard_normal(8).astype(np.float32)
    top0 = model.top_n(q, 10)
    gathered.clear()
    model.set_item_vector("i13", 100 * q)  # would now rank first
    model.set_item_vector("brand-new", 50 * q)
    snap1 = model.y_snapshot()
    assert gathered == [2] and snap1 is not snap0
    assert model.y.materializations == {"full": 1, "incremental": 1}
    assert torch.equal(snap0.mat, mat0) and torch.equal(snap0.norms, norms0)
    assert snap0.n == 300 and snap1.n == 301
    # the shared id map never names a row a snapshot does not hold
    assert snap0.index_of("brand-new") is None and snap1.index_of("brand-new") == 300
    assert snap0.index_of("i13") == snap1.index_of("i13") == 13
    vals, idx = torch.topk(snap0.mat @ torch.from_numpy(q), 10)
    assert model._collect(snap0, vals.numpy(), idx.numpy(), 10, None, None) == top0
    assert [i for i, _ in model.top_n(q, 2)] == ["i13", "brand-new"]
    assert torch.equal(snap1.norms, torch.linalg.vector_norm(snap1.mat, dim=1))
    # exclusion through the newer snapshot reaches the appended row
    assert "brand-new" not in [i for i, _ in model.top_n(q, 5, excluded=["brand-new"])]
    model.y.remove_vector("i0")  # structural: a new id map
    snap2 = model.y_snapshot()
    assert snap2.id_to_idx is not snap1.id_to_idx and snap2.index_of("i13") == 12
    assert snap1.index_of("i13") == 13


# -- the serving fold-in API against the reference --------------------------------


def _stream(n_users=30, n_items=40, k=6, seed=8):
    """MODEL-less UP stream: Y rows, X rows with known items, then a few
    point updates and new rows."""
    rng = np.random.default_rng(seed)
    msgs = [json.dumps(["Y", f"i{i}", rng.standard_normal(k).round(4).tolist()])
            for i in range(n_items)]
    for u in range(n_users):
        known = [f"i{j}" for j in rng.choice(n_items, 4, replace=False)]
        msgs.append(json.dumps(["X", f"u{u}", rng.standard_normal(k).round(4).tolist(),
                                known]))
    for j in (3, 17, n_items, n_items + 1):
        msgs.append(json.dumps(["Y", f"i{j}", rng.standard_normal(k).round(4).tolist()]))
    msgs.append(json.dumps(["X", "u2", rng.standard_normal(k).round(4).tolist(),
                            ["i1", f"i{n_items}"]]))
    return msgs


def _both_managers(tmp_path, k=6):
    from oryx_tpu_torch.models.als import pmml_codec
    from oryx_tpu_torch.pmml import pmmlutils

    pmml = pmml_codec.model_to_pmml(np.zeros((1, k)), np.zeros((1, k)), ["u0"],
                                    ["i0"], k, 0.1, 1.0, True, False, 1e-5,
                                    tmp_path / "m")
    text = pmmlutils.to_string(pmml)
    mgr = ALSServingModelManager(cfg.get_default(), device="cpu")
    ref_mgr = RefServing(ref_cfg.get_default())
    mgr.consume_key_message("MODEL", text)
    ref_mgr.consume_key_message("MODEL", text)
    msgs = _stream(k=k)
    for m in msgs[:-5]:
        mgr.consume([KeyMessage("UP", m)])
        ref_mgr.consume([RefKeyMessage("UP", m)])
    mgr.get_model().y_snapshot()  # a whole build, then point updates
    for m in msgs[-5:]:
        mgr.consume([KeyMessage("UP", m)])
        ref_mgr.consume([RefKeyMessage("UP", m)])
    mgr.get_model().y_snapshot()
    assert mgr.get_model().y.materializations == {"full": 1, "incremental": 1}
    return mgr, ref_mgr


def _both_models(tmp_path):
    mgr, ref_mgr = _both_managers(tmp_path)
    return mgr.get_model(), ref_mgr.get_model()


def test_known_item_api_is_the_reference_api(tmp_path):
    model, ref_model = _both_models(tmp_path)
    assert model.item_counts() == ref_model.item_counts()
    assert model.user_counts() == ref_model.user_counts()
    for user in ("u2", "u5", "nobody"):
        got = sorted(model.get_known_item_vectors_for_user(user), key=lambda t: t[0])
        want = sorted(ref_model.get_known_item_vectors_for_user(user), key=lambda t: t[0])
        assert [i for i, _ in got] == [i for i, _ in want]
        assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(got, want))
    q = np.arange(6, dtype=np.float32) / 7
    ids = ["i1", "i40", "missing", "i17"]
    assert model.dot_with_items(q, ids) == ref_model.dot_with_items(q, ids)


def test_cosine_top_n_is_the_reference_top_n(tmp_path):
    model, ref_model = _both_models(tmp_path)
    rng = np.random.default_rng(2)
    for n_q in (1, 3, 5):
        qs = rng.standard_normal((n_q, 6)).astype(np.float32)
        for kwargs in ({}, {"offset": 2},
                       {"allowed": lambda i: i.endswith("1")},
                       {"rescore": lambda i, s: float("nan") if i == "i3" else -s}):
            got = model.top_n_cosine(qs, 6, **kwargs)
            want = ref_model.top_n_cosine(qs, 6, **kwargs)
            assert [i for i, _ in got] == [i for i, _ in want]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                       rtol=0, atol=SCORE_TOL)
    empty = ALSServingModel(6, True, device="cpu")
    assert empty.top_n_cosine(qs, 3) == [] and empty.get_yty_solver() is None


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max()


def test_fold_in_is_the_reference_fold_in(tmp_path):
    model, ref_model = _both_models(tmp_path)
    solver, ref_solver = model.get_yty_solver(), ref_model.get_yty_solver()
    b = np.random.default_rng(4).standard_normal((5, 6))
    assert _rel(solver.solve(b), ref_solver.solve(b)) < SOLVE_REL_TOL
    contexts = [[("i1", 1.0)], [("i3", 1.0), ("i40", 2.0), ("i7", -1.0)],
                [("missing", 1.0), ("i2", 0.5)], [("i5", 1.0), ("i5", 1.0)]]
    for items in contexts:
        got = model.build_temporary_user_vector(items)
        want = ref_model.build_temporary_user_vector(items)
        assert got.dtype == np.float32 and _rel(got, want) < SOLVE_REL_TOL
        xu = np.full(6, 0.1, dtype=np.float32)
        assert _rel(model.build_temporary_user_vector(items, xu),
                    ref_model.build_temporary_user_vector(items, xu)) < SOLVE_REL_TOL
    assert model.build_temporary_user_vector([("missing", 1.0)]) is None


def test_serving_manager_warms_the_solver_as_the_reference(tmp_path):
    """Once the model is loaded enough, a message starts the YᵀY
    factorisation in the background; the next within the rate limit does
    not, and leaves the cache dirty, as in the reference."""
    managers = _both_managers(tmp_path)
    for mgr in managers:
        assert mgr.get_model().yty_cache._solver is None  # rate-limited so far
        mgr._solver_trigger_rate = type(mgr._solver_trigger_rate)(5)
    up = json.dumps(["Y", "i1", [0.5] * 6])
    for mgr, km in zip(managers, (KeyMessage, RefKeyMessage)):
        cache = mgr.get_model().yty_cache
        mgr.consume([km("UP", up)])
        deadline = time.monotonic() + 10
        while (cache._solver is None or cache._in_flight) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert cache._solver is not None and not cache._dirty
        mgr.consume([km("UP", up)])
        assert cache._dirty and not cache._in_flight
