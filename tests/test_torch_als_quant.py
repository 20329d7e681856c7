"""The port's serving representations against the reference's: LSH masking,
the bfloat16 scoring copy, the int8 slab with its exact rescore, and the
store's host-delta API.

* Parity, both packages on the same numpy-seeded float32 inputs:
  ``_quantize_rows`` the same bytes; the LSH hyperplanes, buckets,
  candidate sets and lookup table the same bytes under the test seed; the
  int8 candidate scan's scores within 1e-5 of the row's largest score;
  ``top_n`` / ``top_n_batch`` / ``top_n_cosine`` on the float32 + LSH,
  bfloat16, int8 and int8 + LSH paths, with exclusions and an ``allowed``
  filter: the same ids in the same order, scores within 1e-5 relative
  (bfloat16: 1e-2). The data have no ties (standard normal factors).
* Mirrors of the reference's cases on the port (device: the CPU):
  ``tests/test_als.py``'s LSH cases (:223, :231, :282),
  ``tests/test_factor_arena.py``'s pinned rescore view (:118), host
  deltas (:175, :204), int8 recall (:243), incremental int8 snapshot
  (:272), exclusions and LSH on int8 (:298) and the quantized byte count
  of :326, and ``tests/test_incremental_snapshot.py:130`` (LSH buckets
  hashed again for only the delta).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.common import rand as ref_rand
from oryx_tpu.models.als import lsh as ref_lsh
from oryx_tpu.models.als import serving as ref_serving
from oryx_tpu.models.als.serving import ALSServingModel as RefModel
from oryx_tpu_torch.common import rand
from oryx_tpu_torch.models.als import lsh
from oryx_tpu_torch.models.als import serving
from oryx_tpu_torch.models.als.lsh import LocalitySensitiveHash, choose_hash_config
from oryx_tpu_torch.models.als.serving import ALSServingModel, _QuantSnapshot
from oryx_tpu_torch.models.als.vectors import FeatureVectorStore

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

REL = 1e-5
BF16_REL = 1e-2


def _factors(seed, n=3000, k=16):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, k)).astype(np.float32)
    qs = rng.standard_normal((12, k)).astype(np.float32)
    return y, qs, [f"i{j}" for j in range(n)]


def _pair(dtype, sample_rate, y, ids):
    """The reference's model and the port's on the same items; both LSH
    instances drawn under the test seed."""
    ref_rand.use_test_seed()
    ref = RefModel(y.shape[1], True, sample_rate, device_dtype=dtype)
    rand.use_test_seed()
    got = ALSServingModel(y.shape[1], True, sample_rate, device_dtype=dtype,
                          device="cpu")
    ref.bulk_load_items(ids, y)
    got.bulk_load_items(ids, y)
    return ref, got


def _same(got, ref, rel=REL):
    """Same ids in the same order, scores within ``rel`` relative."""
    assert [i for i, _ in got] == [i for i, _ in ref]
    for (_, g), (_, r) in zip(got, ref):
        assert abs(g - r) <= rel * max(abs(r), 1e-6), (g, r)


# -- parity: building blocks --------------------------------------------------


def test_quantize_rows_gives_the_reference_bytes():
    y, _, _ = _factors(1)
    y[5] = 0.0  # a zero row gets scale 1
    q, s = serving._quantize_rows(y)
    rq, rs = ref_serving._quantize_rows(y)
    assert q.dtype == np.int8 and q.tobytes() == rq.tobytes()
    assert s.tobytes() == rs.tobytes()
    assert s[5] == 1.0
    eq, es = serving._quantize_rows(np.zeros((0, 4), np.float32))
    assert eq.shape == (0, 4) and es.shape == (0,)


@pytest.mark.parametrize("sample_rate", [0.1, 0.3, 0.5])
def test_lsh_gives_the_reference_bytes_under_the_test_seed(sample_rate):
    y, qs, _ = _factors(2, n=500, k=12)
    ref_rand.use_test_seed()
    ref = ref_lsh.LocalitySensitiveHash(sample_rate, 12)
    rand.use_test_seed()
    got = LocalitySensitiveHash(sample_rate, 12)
    assert (got.num_hashes, got.max_bits_differing) == (
        ref.num_hashes, ref.max_bits_differing)
    assert got.hyperplanes.tobytes() == ref.hyperplanes.tobytes()
    assert got.assign_buckets(y).tobytes() == ref.assign_buckets(y).tobytes()
    for q in qs:
        assert got.get_index_for(q) == ref.get_index_for(q)
        assert (got.get_candidate_indices(q).tobytes()
                == ref.get_candidate_indices(q).tobytes())
    assert got.get_candidate_lut(qs).tobytes() == ref.get_candidate_lut(qs).tobytes()


def test_int8_candidate_scan_scores_match_the_reference():
    """The quantized masked scores (by row chunk in the port, chunks
    forced small here) within 1e-5 of each row's largest score."""
    y, qs, ids = _factors(3)
    _, got = _pair("int8", 1.0, y, ids)
    snap = got.y_snapshot()
    q, s = ref_serving._quantize_rows(y)
    excl = np.full((len(qs), 8), -1, dtype=np.int64)
    excl[0, :3] = [0, 7, 2999]
    ref = np.asarray(ref_serving._quant_masked_scores(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(qs), None,
        jnp.asarray(excl.astype(np.int32))))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serving, "_SCAN_BYTES", 4 * (len(qs) + 16) * 1024)
        assert serving._scan_rows(len(qs), 16) == 1024  # three chunks
        port = serving._quant_masked_scores(
            snap, torch.as_tensor(qs), excl=torch.as_tensor(excl)).numpy()
        vals, idx = serving._quant_candidates(
            snap, torch.as_tensor(qs), 64, excl=torch.as_tensor(excl))
    finite = np.isfinite(ref)
    assert (np.isfinite(port) == finite).all()
    assert not finite[0, [0, 7, 2999]].any()
    scale = np.abs(ref[finite]).max()
    np.testing.assert_allclose(port[finite], ref[finite], rtol=0,
                               atol=REL * scale)
    # the chunked running top-r is the top-r of the whole score matrix
    want = np.sort(port, axis=1)[:, ::-1][:, :64]
    np.testing.assert_array_equal(vals.numpy(), want)
    np.testing.assert_array_equal(
        np.take_along_axis(port, idx.numpy(), axis=1), want)


# -- parity: the serving paths ------------------------------------------------

PATHS = [("float32", 0.3), ("bfloat16", 1.0), ("bfloat16", 0.3),
         ("int8", 1.0), ("int8", 0.3)]


@pytest.mark.parametrize("dtype,sample_rate", PATHS)
def test_top_n_batch_matches_the_reference(dtype, sample_rate):
    y, qs, ids = _factors(4)
    ref, got = _pair(dtype, sample_rate, y, ids)
    rel = BF16_REL if dtype == "bfloat16" else REL
    rng = np.random.default_rng(9)
    excluded = [[ids[j] for j in rng.choice(len(ids), n, replace=False)]
                for n in (0, 1, 3, 8, 9, 0, 2, 30, 0, 1, 5, 4)]
    excluded[2] = excluded[2] + ["unknown"]
    for ex in (None, excluded):
        for r, g in zip(ref.top_n_batch(qs, 10, excluded=ex),
                        got.top_n_batch(qs, 10, excluded=ex)):
            assert len(g) == 10
            _same(g, r, rel)
    allowed = lambda i: int(i[1:]) % 3 == 0  # noqa: E731
    alloweds = [allowed, None] * 6
    for r, g in zip(ref.top_n_batch(qs, 10, alloweds=alloweds, excluded=excluded),
                    got.top_n_batch(qs, 10, alloweds=alloweds, excluded=excluded)):
        _same(g, r, rel)


@pytest.mark.parametrize("dtype,sample_rate", PATHS)
def test_top_n_and_cosine_match_the_reference(dtype, sample_rate):
    y, qs, ids = _factors(5)
    ref, got = _pair(dtype, sample_rate, y, ids)
    rel = BF16_REL if dtype == "bfloat16" else REL
    allowed = lambda i: int(i[1:]) % 7 != 0  # noqa: E731
    rescore = lambda i, s: s * (1.0 + int(i[1:]) % 3)  # noqa: E731
    for q in qs[:4]:
        kw = dict(offset=2, allowed=allowed, excluded=ids[:40:3])
        _same(got.top_n(q, 8, **kw), ref.top_n(q, 8, **kw), rel)
        _same(got.top_n(q, 5, rescore=rescore), ref.top_n(q, 5, rescore=rescore), rel)
    # a filter that starves the first cut: the port widens as the reference
    keep = lambda i: int(i[1:]) % 97 == 0  # noqa: E731
    _same(got.top_n(qs[0], 10, allowed=keep), ref.top_n(qs[0], 10, allowed=keep), rel)
    for sets in (qs[:1], qs[1:4]):
        _same(got.top_n_cosine(sets, 10), ref.top_n_cosine(sets, 10), REL)
        _same(got.top_n_cosine(sets, 6, offset=3, allowed=allowed),
              ref.top_n_cosine(sets, 6, offset=3, allowed=allowed), REL)


def test_unknown_device_dtype_raises_and_index_without_int8_serves_flat(caplog):
    with pytest.raises(ValueError, match="device-dtype"):
        ALSServingModel(4, True, device_dtype="float16", device="cpu")
    m = ALSServingModel(4, True, device_dtype="bfloat16", index_enabled=True,
                        device="cpu")
    assert not m.index_enabled
    assert "requires device-dtype=int8" in caplog.text
    m.bulk_load_items(["a", "b"], np.eye(2, 4, dtype=np.float32))
    snap = m.y_snapshot()
    assert isinstance(snap, serving._YSnapshot)
    assert snap.score_mat.dtype == torch.bfloat16 and snap.mat.dtype == torch.float32
    auto = ALSServingModel(4, True, device_dtype="auto", device="cpu")
    auto.bulk_load_items(["a"], np.ones((1, 4), np.float32))
    assert auto.y_snapshot().score_mat is auto.y_snapshot().mat


# -- mirrors of tests/test_als.py -------------------------------------------


def test_lsh_config_fraction():
    n, dd = choose_hash_config(0.3)
    assert n > 0
    assert lsh._candidate_fraction(n, dd) <= 0.3 + 1e-9


def test_lsh_candidate_buckets_contain_query_bucket():
    h = LocalitySensitiveHash(0.3, 10)
    v = np.random.default_rng(3).standard_normal(10).astype(np.float32)
    own = h.get_index_for(v)
    cands = h.get_candidate_indices(v)
    assert own in cands
    assert len(cands) < h.num_buckets


def _serving_model(n_items=200, k=8, sample_rate=1.0):
    rng = np.random.default_rng(7)
    m = ALSServingModel(k, True, sample_rate, device="cpu")
    for i in range(n_items):
        m.set_item_vector(f"i{i}", rng.standard_normal(k).astype(np.float32))
    m.set_user_vector("u0", rng.standard_normal(k).astype(np.float32))
    return m


def test_lsh_sampling_reduces_candidates_but_keeps_quality():
    m_full = _serving_model(500, 16, 1.0)
    m_lsh = ALSServingModel(16, True, 0.5, device="cpu")
    for i in m_full.y.ids():
        m_lsh.set_item_vector(i, m_full.y.get_vector(i))
    q = m_full.get_user_vector("u0")
    m_lsh.set_user_vector("u0", q)
    full = [i for i, _ in m_full.top_n(q, 20)]
    approx = [i for i, _ in m_lsh.top_n(q, 20)]
    overlap = len(set(full[:10]) & set(approx)) / 10
    assert overlap >= 0.3  # approximate, not empty or broken


# -- mirrors of tests/test_factor_arena.py ------------------------------------


def test_quant_rescore_view_survives_concurrent_gc():
    """The exact-rescore gather is pinned to the snapshot's slab view: a
    structural store change mid-request neither crashes the gather nor
    misaligns candidate rows, and a refill with new ids after the GC does
    not reach the pinned rows."""
    rng = np.random.default_rng(21)
    n, k = 300, 8
    y = rng.standard_normal((n, k)).astype(np.float32)
    m = ALSServingModel(k, implicit=True, device_dtype="int8", device="cpu")
    m.bulk_load_items([f"i{i}" for i in range(n)], y)
    snap = m.y_snapshot()
    np.testing.assert_array_equal(snap.gather_rows(np.arange(10)), y[:10])
    # structural change: GC the live store down to nothing mid-request
    m.y.retain_recent_and_ids(set())  # ends the recent set
    m.y.retain_recent_and_ids(set())  # drops every row
    assert m.y.size() == 0
    np.testing.assert_array_equal(snap.gather_rows(np.arange(10)), y[:10])
    z = 100 + rng.standard_normal((n, k)).astype(np.float32)
    m.y.bulk_load([f"gen2-{i}" for i in range(n)], z)
    assert m.y.size() == n
    np.testing.assert_array_equal(snap.gather_rows(np.arange(10)), y[:10])


def test_host_delta_composes_and_matches_full_rebuild():
    rng = np.random.default_rng(3)
    s = FeatureVectorStore()
    s.bulk_load([f"i{i}" for i in range(50)],
                rng.standard_normal((50, 4)).astype(np.float32))
    ids0, host0, v0, _ = s.host_matrix()
    s.set_vector("i7", np.full(4, 1, dtype=np.float32))
    s.set_vector("i7", np.full(4, 2, dtype=np.float32))  # newest wins
    s.set_vector("i9", np.full(4, 3, dtype=np.float32))
    s.set_vector("new-a", np.full(4, 4, dtype=np.float32))
    s.set_vector("new-b", np.full(4, 5, dtype=np.float32))
    d = s.delta_info(v0, len(ids0))
    assert d is not None
    assert sorted(d.changed_ids) == ["i7", "i9"]
    assert d.appended_ids == ["new-a", "new-b"]
    vals = dict(zip(d.changed_ids, d.changed_vals))
    assert vals["i7"][0] == 2 and vals["i9"][0] == 3
    assert d.appended_vals[0][0] == 4 and d.appended_vals[1][0] == 5
    rebuilt = np.concatenate([host0, d.appended_vals])
    pos = {id_: i for i, id_ in enumerate(ids0)}
    for id_, val in vals.items():
        rebuilt[pos[id_]] = val
    ids1, host1, _, (slab, rows) = s.host_matrix()
    assert ids1 == ids0 + d.appended_ids
    np.testing.assert_array_equal(rebuilt, host1)
    # the appended ids' slab rows index the delta's slab
    np.testing.assert_array_equal(d.slab[d.appended_rows], d.appended_vals)
    np.testing.assert_array_equal(slab[rows], host1)
    assert s.delta_info(s.host_matrix()[2], len(ids1)).changed_ids == []


def test_host_delta_cut_by_structural_change():
    s = FeatureVectorStore()
    s.bulk_load(["a", "b"], np.zeros((2, 3), dtype=np.float32))
    _, _, v0, _ = s.host_matrix()
    s.remove_vector("a")
    assert s.delta_info(v0, 2) is None  # removal is structural


def test_quantized_recall_at_10_on_planted_structure():
    rng = np.random.default_rng(5)
    n, k, n_centers = 8000, 32, 64
    centers = rng.standard_normal((n_centers, k)).astype(np.float32)
    assign = rng.integers(0, n_centers, n)
    y = (centers[assign] + 0.3 * rng.standard_normal((n, k))).astype(np.float32)
    ids = [f"i{i}" for i in range(n)]
    q8 = ALSServingModel(k, implicit=True, device_dtype="int8", device="cpu")
    q8.bulk_load_items(ids, y)
    got = q8.top_n_batch(centers, 10)
    exact = y @ centers.T
    recalls = []
    for c in range(n_centers):
        truth = {f"i{i}" for i in np.argsort(-exact[:, c])[:10]}
        recalls.append(len(truth & {i for i, _ in got[c]}) / 10.0)
    assert np.mean(recalls) >= 0.99, np.mean(recalls)
    for id_, score in got[0]:
        assert abs(score - float(exact[int(id_[1:]), 0])) < 1e-4


def test_quant_incremental_snapshot_equals_full_rebuild():
    rng = np.random.default_rng(7)
    n, k = 500, 16
    m = ALSServingModel(k, implicit=True, device_dtype="int8", device="cpu")
    m.bulk_load_items([f"i{i}" for i in range(n)],
                      rng.standard_normal((n, k)).astype(np.float32))
    snap0 = m.y_snapshot()
    assert isinstance(snap0, _QuantSnapshot)
    qmat0 = snap0.qmat.clone()
    for i in (3, 99, 250):
        m.set_item_vector(f"i{i}", rng.standard_normal(k).astype(np.float32))
    m.set_item_vector("fresh", rng.standard_normal(k).astype(np.float32))
    snap1 = m.y_snapshot()
    assert snap1.n == n + 1 and snap1.ids[-1] == "fresh"
    # the held snapshot's tensors were not written
    assert torch.equal(snap0.qmat, qmat0) and snap0.n == n
    fresh = ALSServingModel(k, implicit=True, device_dtype="int8", device="cpu")
    fresh.bulk_load_items(
        snap1.ids, np.stack([m.y.get_vector(i) for i in snap1.ids]))
    snap_f = fresh.y_snapshot()
    for name in ("qmat", "qscale", "norms"):
        assert torch.equal(getattr(snap1, name), getattr(snap_f, name)), name


def test_quant_exclusions_and_lsh_paths():
    rng = np.random.default_rng(13)
    n, k = 2000, 16
    ids = [f"i{i}" for i in range(n)]
    y = rng.standard_normal((n, k)).astype(np.float32)
    q8 = ALSServingModel(k, implicit=True, device_dtype="int8", device="cpu")
    q8.bulk_load_items(ids, y)
    q = rng.standard_normal(k).astype(np.float32)
    base = [i for i, _ in q8.top_n(q, 5)]
    excluded = base[:2]
    got = q8.top_n(q, 5, excluded=excluded)
    assert not set(excluded) & {i for i, _ in got}
    m_lsh = ALSServingModel(k, implicit=True, sample_rate=0.5,
                            device_dtype="int8", device="cpu")
    m_lsh.bulk_load_items(ids, y)
    res = m_lsh.top_n_batch(rng.standard_normal((4, k)).astype(np.float32), 5)
    assert all(len(r) == 5 for r in res)
    cos = q8.top_n_cosine(np.stack([y[3], y[8]]), 5)
    assert len(cos) == 5


def test_quantized_bytes_are_a_quarter_of_float32():
    """The byte identity of ``tests/test_factor_arena.py:326``: int8 rows
    and float32 scales, (k + 4) bytes a row."""
    rng = np.random.default_rng(1)
    n, k = 1000, 8
    m = ALSServingModel(k, implicit=True, device_dtype="int8", device="cpu")
    m.bulk_load_items([f"i{i}" for i in range(n)],
                      rng.standard_normal((n, k)).astype(np.float32))
    snap = m.y_snapshot()
    assert snap.quantized_nbytes() == n * k + n * 4
    # on the device beside them only the exact float32 norms
    assert m.device_factor_bytes() == n * k + 2 * 4 * n


# -- mirror of tests/test_incremental_snapshot.py:130 ------------------------


def test_snapshot_reuses_lsh_buckets(monkeypatch):
    """After a microbatch of UPs the snapshot hashes only the changed and
    appended rows again, and its buckets equal a from-scratch hashing."""
    rng = np.random.default_rng(3)
    model = ALSServingModel(16, implicit=True, sample_rate=0.5, device="cpu")
    n = 400
    y = rng.standard_normal((n, 16)).astype(np.float32)
    model.bulk_load_items([f"i{i}" for i in range(n)], y)
    snap0 = model.y_snapshot()
    assert snap0.buckets is not None
    buckets0 = snap0.buckets.clone()

    hashed_rows = []
    orig = LocalitySensitiveHash.assign_buckets

    def counting(self, mat):
        hashed_rows.append(len(mat))
        return orig(self, mat)

    monkeypatch.setattr(LocalitySensitiveHash, "assign_buckets", counting)
    model.set_item_vector("i13", rng.standard_normal(16).astype(np.float32))
    model.set_item_vector("brand-new", rng.standard_normal(16).astype(np.float32))
    snap1 = model.y_snapshot()
    assert hashed_rows == [1, 1]  # one changed row + one appended row
    assert snap1.mat.shape[0] == n + 1
    expect = orig(model.lsh, snap1.mat.numpy())
    np.testing.assert_array_equal(snap1.buckets.numpy(), expect)
    assert torch.equal(snap0.buckets, buckets0)  # the held snapshot's
    res = model.top_n(rng.standard_normal(16).astype(np.float32), 5)
    assert len(res) == 5
