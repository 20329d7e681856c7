"""The port's sharded serving scan against the reference's.

The eight cases of ``tests/test_sharded_serving.py``, each run on both
packages: the reference's model on its eight-device CPU mesh
(``tests/conftest.py``), the port's on a mesh of eight ``cpu`` entries
(``make_mesh(devices=["cpu"] * 8)``), where each shard is its own tensor
scored, masked and cut to a local top-k before the cross-shard merge. Both
must give the same ids in the same order (the factors are standard normal:
no ties) with scores within 1e-5 relative, and the port's sharded answers
must equal its own one-device scan.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from oryx_tpu.common import rand as ref_rand
from oryx_tpu.models.als.serving import ALSServingModel as RefModel
from oryx_tpu.parallel.mesh import make_mesh as ref_make_mesh
from oryx_tpu_torch.common import rand
from oryx_tpu_torch.models.als.serving import ALSServingModel
from oryx_tpu_torch.parallel.mesh import ShardedRows, make_mesh

torch.set_num_threads(1)

REL = 1e-5
SHARDS = 8


def _mesh():
    return make_mesh(axes=("model",), devices=["cpu"] * SHARDS)


def _build(n_items=1000, features=16, seed=0, sample_rate=1.0):
    """(reference sharded, port sharded, port one-device, queries) on the
    same seeded items; every LSH drawn under the test seed."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n_items, features)).astype(np.float32)
    ids = [f"i{i}" for i in range(n_items)]
    ref_rand.use_test_seed()
    ref = RefModel(features, implicit=True, sample_rate=sample_rate,
                   mesh=ref_make_mesh(axes=("model",)))
    models = []
    for mesh in (_mesh(), None):
        rand.use_test_seed()
        models.append(ALSServingModel(features, True, sample_rate,
                                      device="cpu", mesh=mesh))
    for m in (ref, *models):
        m.bulk_load_items(ids, y)
    return ref, models[0], models[1], rng.standard_normal(
        (8, features)).astype(np.float32)


def _same(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert abs(g - w) <= REL * max(abs(w), 1e-6), (g, w)


def _all_same(got, *wants):
    for want in wants:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)


def test_sharded_matches_single_device():
    ref, got, single, queries = _build()
    snap = got.y_snapshot()
    assert isinstance(snap.sharded_mat, ShardedRows)
    assert snap.sharded_mat.n_shards == SHARDS
    _all_same(got.top_n_batch(queries, 10), ref.top_n_batch(queries, 10),
              single.top_n_batch(queries, 10))


def test_sharded_item_count_not_divisible_by_shards():
    ref, got, single, queries = _build(n_items=1003)
    snap = got.y_snapshot()
    assert snap.sharded_mat.shape[0] == 1008  # padded to the shard count
    assert not snap.sharded_mat.full()[1003:].any()
    res = got.top_n_batch(queries, 7)
    _all_same(res, ref.top_n_batch(queries, 7), single.top_n_batch(queries, 7))
    for r in res:  # padding rows never surface
        assert all(int(i[1:]) < 1003 for i, _ in r)


def test_sharded_with_host_callable_falls_back():
    ref, got, _, queries = _build(n_items=200)
    banned = {"i0", "i1", "i2"}
    alloweds = [lambda i: i not in banned] * 8
    res = got.top_n_batch(queries, 5, alloweds=alloweds)
    _all_same(res, ref.top_n_batch(queries, 5, alloweds=alloweds))
    for r in res:
        assert len(r) == 5 and banned.isdisjoint({i for i, _ in r})


def test_sharded_excluded_device_side():
    ref, got, single, queries = _build(n_items=400)
    excl = [{i for i, _ in r[:3]} for r in single.top_n_batch(queries, 10)]
    res = got.top_n_batch(queries, 5, excluded=excl)
    _all_same(res, ref.top_n_batch(queries, 5, excluded=excl),
              single.top_n_batch(queries, 5, excluded=excl))
    for b, r in enumerate(res):
        assert len(r) == 5 and excl[b].isdisjoint({i for i, _ in r})


def test_sharded_top_n_single_query_excluded():
    ref, got, single, queries = _build(n_items=300)
    excl = {i for i, _ in single.top_n(queries[0], 8)[:2]}
    res = got.top_n(queries[0], 5, excluded=excl)
    assert len(res) == 5 and excl.isdisjoint({i for i, _ in res})
    _same(res, ref.top_n(queries[0], 5, excluded=excl))
    _same(res, single.top_n(queries[0], 5, excluded=excl))


def test_sharded_lsh_masks_on_device():
    ref, got, single, _ = _build(n_items=800, seed=3, sample_rate=0.5)
    queries = np.random.default_rng(3).standard_normal((4, 16)).astype(np.float32)
    res = got.top_n_batch(queries, 6)
    assert got.lsh is not None and got.lsh.num_hashes > 0
    snap = got.y_snapshot()
    assert snap.sharded_mat is not None  # really the sharded path
    assert torch.equal(snap.sharded_buckets.full()[:snap.n], snap.buckets)
    for b, r in enumerate(res):
        assert r, "LSH-masked sharded scan returned nothing"
        cand = set(got.lsh.get_candidate_indices(queries[b]))
        assert all(int(snap.buckets[snap.index_of(i)]) in cand for i, _ in r)
    _all_same(res, ref.top_n_batch(queries, 6), single.top_n_batch(queries, 6))


def test_sharded_how_many_exceeds_shard_rows():
    ref, got, single, queries = _build(n_items=96)  # 12 rows a shard
    res = got.top_n_batch(queries, 40)
    assert all(len(r) == 40 for r in res)
    _all_same(res, ref.top_n_batch(queries, 40), single.top_n_batch(queries, 40))


@pytest.mark.parametrize("package", ["reference", "port"])
def test_sharded_snapshot_tracks_point_updates(package):
    ref, got, _, queries = _build(n_items=320)
    model = ref if package == "reference" else got
    q = queries[0]
    winner = (q / np.linalg.norm(q) * 50.0).astype(np.float32)
    model.set_item_vector("i300", winner)
    assert model.top_n(q, 3)[0][0] == "i300"
    assert model.y_snapshot().sharded_mat is not None  # still sharded
    model.set_item_vector("fresh", (winner * 2).astype(np.float32))
    res = model.top_n(q, 3)
    assert res[0][0] == "fresh"
    if package == "port":
        ref.set_item_vector("i300", winner)
        ref.set_item_vector("fresh", (winner * 2).astype(np.float32))
        _same(res, ref.top_n(q, 3))
        _all_same(got.top_n_batch(queries, 5), ref.top_n_batch(queries, 5))


def test_int8_with_a_mesh_degrades_to_bfloat16(caplog):
    with caplog.at_level("WARNING"):
        model = ALSServingModel(8, True, device_dtype="int8", device="cpu",
                                mesh=_mesh())
    assert model.device_dtype == "bfloat16"
    assert "not supported with sharded serving" in caplog.text
