"""The port's IVF index (``models/als/ivf.py``) against the reference's.

* Mirrors of the first nine cases of ``tests/test_ivf.py`` on the port
  (device: the CPU): recall@10 >= 0.99 on the planted catalog with exact
  scores; batch equal to single with exclusions; probe widening under heavy
  filtering; cosine and LSH; incremental maintenance equal to a rebuild
  with the same centroids, byte for byte; the skew re-cluster; the four
  ``oryx_index_*`` metrics (the reference's per-program cost keys are not
  ported); the k-means fit's determinism and empty-cell reseeding. And the
  port's version of its HTTP handoff case: after a second ``MODEL`` with
  new features the layer answers ``/recommend`` from the new generation's
  IVF snapshot, equal to the model's own answers.
* Parity on the same numpy-seeded float32 inputs, with the same centroids
  given to both packages' ``IVFSnapshot.build`` (the reference's k-means
  seeds from ``jax.random``): the cell tables (``cell_pos``, ``cell_len``,
  ``cell_q``, ``cell_scale``, ``cell_norms``, ``cell_buckets``) the same
  bytes; ``top_n`` / ``top_n_batch`` / ``top_n_cosine`` with exclusions
  and an ``allowed`` filter, with and without LSH: the same ids in the
  same order, scores within 1e-5 relative; the incremental snapshot after
  a burst the same bytes as the reference's.
"""

from __future__ import annotations

import json
import time

import httpx
import numpy as np
import pytest
import torch

from oryx_tpu.common import rand as ref_rand
from oryx_tpu.models.als import ivf as ref_ivf
from oryx_tpu.models.als.serving import ALSServingModel as RefModel
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import rand
from oryx_tpu_torch.models.als import ivf
from oryx_tpu_torch.models.als.serving import ALSServingModel
from oryx_tpu_torch.models.kmeans.train import _reseed_empty, fit_index_centroids
from oryx_tpu_torch.serving.app import ServingLayer
from oryx_tpu_torch.transport import topic as tp

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

REL = 1e-5
CELL_TABLES = ("cell_pos", "cell_q", "cell_scale", "cell_norms")


def _planted(n=8000, k=32, n_centers=64, noise=0.05, seed=7):
    """Items in tight blobs around well-separated centres; the centres are
    the queries (the reference test's construction)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, k)).astype(np.float32) * 3.0
    reps = n // n_centers
    items = (np.repeat(centers, reps, axis=0)
             + rng.standard_normal((reps * n_centers, k)).astype(np.float32)
             * noise)
    ids = [f"i{j}" for j in range(len(items))]
    return centers, items, ids


def _ivf_model(items, ids, k, **kw):
    m = ALSServingModel(k, implicit=True, device_dtype="int8",
                        index_enabled=True, device="cpu", **kw)
    m.bulk_load_items(ids, items)
    return m


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- mirrors of tests/test_ivf.py ---------------------------------------------


def test_ivf_recall_at_10_on_planted_structure():
    k = 32
    centers, items, ids = _planted(k=k)
    m = _ivf_model(items, ids, k)
    snap = m.y_snapshot()
    assert isinstance(snap, ivf.IVFSnapshot)
    assert snap.n_cells >= 16 and snap.cell_q is not None
    hits = total = 0
    for q in centers:
        exact = set(np.argsort(-(items @ q))[:10])
        got = m.top_n(q, 10)
        assert len(got) == 10
        for id_, score in got:
            assert abs(score - float(items[int(id_[1:])] @ q)) < 1e-4
        hits += len({int(g[0][1:]) for g in got} & exact)
        total += 10
    assert hits / total >= 0.99, f"IVF recall@10 {hits / total:.4f}"


def test_ivf_batch_matches_single_and_masks_exclusions():
    k = 32
    centers, items, ids = _planted(n=4000, k=k)
    m = _ivf_model(items, ids, k)
    qs = centers[:16].copy()
    excl = [tuple(ids[j] for j in np.argsort(-(items @ qs[b]))[:3])
            if b % 2 == 0 else None for b in range(16)]
    res = m.top_n_batch(qs, 10, excluded=excl)
    for b in range(16):
        assert len(res[b]) == 10
        if excl[b]:
            assert not ({t[0] for t in res[b]} & set(excl[b]))
        single = m.top_n(qs[b], 10, excluded=excl[b])
        assert [t[0] for t in res[b]] == [t[0] for t in single]


def test_ivf_probe_widening_under_heavy_filtering():
    k = 32
    centers, items, ids = _planted(n=4000, k=k)
    m = _ivf_model(items, ids, k, index_probes=2)
    q = centers[5]
    order = np.argsort(-(items @ q))
    blocked = {ids[j] for j in order[:600]}  # several cells' worth
    got = m.top_n(q, 10, allowed=lambda s: s not in blocked)
    assert len(got) == 10
    expect = [ids[j] for j in order if ids[j] not in blocked][:10]
    assert {t[0] for t in got} == set(expect)


def test_ivf_cosine_and_lsh_paths():
    k = 32
    centers, items, ids = _planted(n=4000, k=k)
    m = _ivf_model(items, ids, k, sample_rate=0.3)
    snap = m.y_snapshot()
    assert snap.cell_buckets is not None  # LSH buckets rode the cells
    assert len(m.top_n(centers[3], 10)) == 10
    cos = m.top_n_cosine(centers[:2].copy(), 8)
    assert len(cos) == 8
    top_id, top_score = cos[0]
    r = items[int(top_id[1:])]
    sims = [float(r @ c) / max(np.linalg.norm(r) * np.linalg.norm(c), 1e-12)
            for c in centers[:2]]
    assert abs(top_score - np.mean(sims)) < 1e-4


def _burst(m, centers, items, k, rng):
    for j in range(40):  # move rows to other clusters
        tgt = centers[(j * 7) % 16]
        m.set_item_vector(
            f"i{j}", tgt + rng.standard_normal(k).astype(np.float32) * 0.05)
    for j in range(100, 110):  # rewrite in place (same cell)
        m.set_item_vector(f"i{j}", items[j] * 1.5)
    for j in range(20):  # appends
        m.set_item_vector(
            f"new{j}",
            centers[j % 16] + rng.standard_normal(k).astype(np.float32) * 0.05)


def test_ivf_incremental_equals_full_rebuild_after_speed_burst():
    k = 12
    centers, items, ids = _planted(n=800, k=k, n_centers=16)
    rng = np.random.default_rng(3)
    m = _ivf_model(items, ids, k)
    s0 = m.y_snapshot()
    held = {name: getattr(s0, name).clone() for name in CELL_TABLES}
    _burst(m, centers, items, k, rng)
    s1 = m.y_snapshot()
    assert s1 is not s0 and s1.n == 820
    assert s1.centroids_np is s0.centroids_np  # the delta path, no re-fit
    for name in CELL_TABLES:  # the held snapshot's tensors were not written
        assert torch.equal(getattr(s0, name), held[name]), name
    ids2, host, version, row_view = m.y.host_matrix()
    s2 = ivf.IVFSnapshot.build(
        ids2, host, version, None, row_view, centroids=s1.centroids_np,
        cell_width=s1.cell_width, device="cpu")
    for name in CELL_TABLES:
        assert torch.equal(getattr(s1, name), getattr(s2, name)), name
    q = centers[5]
    final = np.stack([m.y.get_vector(i) for i in ids2])
    exact = {ids2[j] for j in np.argsort(-(final @ q))[:10]}
    assert len({t[0] for t in m.top_n(q, 10)} & exact) >= 9


def test_ivf_skew_drift_triggers_recluster():
    k = 12
    centers, items, ids = _planted(n=800, k=k, n_centers=16)
    rng = np.random.default_rng(4)
    m = _ivf_model(items, ids, k, index_skew=2.5)
    s0 = m.y_snapshot()
    for j in range(600):
        m.set_item_vector(
            f"pile{j}",
            centers[0] + rng.standard_normal(k).astype(np.float32) * 0.02)
    s1 = m.y_snapshot()
    assert s1.n == 1400
    assert s1.centroids_np is not s0.centroids_np


def test_ivf_telemetry_counters_and_skew_gauge():
    registry = metrics_mod.default_registry()
    k = 16
    centers, items, ids = _planted(n=2000, k=k, n_centers=32)
    before = registry.snapshot()
    m = _ivf_model(items, ids, k)
    m.top_n_batch(centers[:8].copy(), 10)
    snap = registry.snapshot()

    def grew(name):
        return (snap.get(name, {}).get("", 0)
                > before.get(name, {}).get("", 0))

    assert grew("oryx_index_cells_total")
    assert grew("oryx_index_probed_cells_total")
    assert grew("oryx_index_candidate_rows_total")
    assert snap.get("oryx_index_cell_skew", {}).get("", 0) >= 1.0


def test_fit_index_centroids_deterministic_bounded_no_dead_cells():
    rng = np.random.default_rng(11)
    blobs = rng.standard_normal((4, 8)).astype(np.float32) * 4.0
    pts = (np.repeat(blobs, 100, axis=0)
           + rng.standard_normal((400, 8)).astype(np.float32) * 0.3)
    a = fit_index_centroids(pts, 8, iterations=10, seed=5, device="cpu")
    b = fit_index_centroids(pts, 8, iterations=10, seed=5, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[2], b[2])
    centers, counts, assign = a
    assert centers.shape == (8, 8) and assign.shape == (400,)
    assert (counts > 0).all(), "dead cells survived reseeding"
    assert counts.sum() == 400


def test_reseed_empty_moves_center_to_worst_served_point():
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [10.0, 10.0]], dtype=np.float32)
    centers = np.array([[0.5, 0.0], [99.0, 99.0]], dtype=np.float32)
    assign = np.array([0, 0, 0], dtype=np.int32)
    counts = np.array([3, 0], dtype=np.int64)
    patched = _reseed_empty(pts, centers, counts, assign)
    np.testing.assert_array_equal(patched[1], pts[2])
    np.testing.assert_array_equal(patched[0], centers[0])


# -- parity with the reference ------------------------------------------------


def _pair(items, ids, k, centers, sample_rate=1.0, **kw):
    """Both packages' int8 + index models on the same items, each holding an
    IVF snapshot built with the same ``centers`` as centroids."""
    ref_rand.use_test_seed()
    ref = RefModel(k, True, sample_rate, device_dtype="int8",
                   index_enabled=True, **kw)
    rand.use_test_seed()
    got = ALSServingModel(k, True, sample_rate, device_dtype="int8",
                          index_enabled=True, device="cpu", **kw)
    for m, mod, extra in ((ref, ref_ivf, {}), (got, ivf, {"device": "cpu"})):
        m.bulk_load_items(ids, items)
        i_, host, version, view = m.y.host_matrix()
        m._snapshot = mod.IVFSnapshot.build(
            i_, host, version, m.lsh, view, centroids=centers,
            probes=m.index_probes, skew_bound=m.index_skew, **extra)
    return ref, got


def _same(got, ref):
    assert [i for i, _ in got] == [i for i, _ in ref]
    for (_, g), (_, r) in zip(got, ref):
        assert abs(g - r) <= REL * max(abs(r), 1e-6), (g, r)


@pytest.mark.parametrize("sample_rate", [1.0, 0.3])
def test_cell_tables_are_the_reference_bytes(sample_rate):
    k = 16
    centers, items, ids = _planted(n=3000, k=k, n_centers=32, noise=0.3)
    ref, got = _pair(items, ids, k, centers, sample_rate)
    rs, gs = ref.y_snapshot(), got.y_snapshot()
    assert isinstance(gs, ivf.IVFSnapshot)
    assert (gs.n_cells, gs.cell_width, gs.probes) == (
        rs.n_cells, rs.cell_width, rs.probes)
    assert gs.cell_len.tobytes() == rs.cell_len.tobytes()
    assert gs.assign.tobytes() == rs.assign.tobytes()
    names = CELL_TABLES + (("cell_buckets",) if sample_rate < 1 else ())
    for name in names:
        a, b = _np(getattr(gs, name)), np.asarray(getattr(rs, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert gs.quantized_nbytes() == rs.quantized_nbytes()
    assert gs.device_nbytes() == rs.device_nbytes()


@pytest.mark.parametrize("sample_rate", [1.0, 0.3])
def test_top_n_paths_answer_as_the_reference(sample_rate):
    k = 16
    centers, items, ids = _planted(n=3000, k=k, n_centers=32, noise=0.3)
    ref, got = _pair(items, ids, k, centers, sample_rate, index_probes=4)
    rng = np.random.default_rng(8)
    qs = (centers[rng.integers(0, 32, 10)]
          + rng.standard_normal((10, k)).astype(np.float32) * 0.5)
    excluded = [[ids[j] for j in rng.choice(len(ids), n, replace=False)]
                for n in (0, 1, 3, 8, 9, 0, 2, 30, 0, 1)]
    excluded[1] = [r[0] for r in ref.top_n(qs[1], 3)]  # the best ones
    for ex in (None, excluded):
        for r, g in zip(ref.top_n_batch(qs, 10, excluded=ex),
                        got.top_n_batch(qs, 10, excluded=ex)):
            _same(g, r)
    allowed = lambda i: int(i[1:]) % 5 != 0  # noqa: E731
    alloweds = [allowed, None] * 5
    for r, g in zip(ref.top_n_batch(qs, 10, alloweds=alloweds, excluded=excluded),
                    got.top_n_batch(qs, 10, alloweds=alloweds, excluded=excluded)):
        _same(g, r)
    rescore = lambda i, s: s * (1.0 + int(i[1:]) % 3)  # noqa: E731
    for q, ex in zip(qs[:4], excluded[:4]):
        kw = dict(offset=1, allowed=allowed, excluded=ex)
        _same(got.top_n(q, 6, **kw), ref.top_n(q, 6, **kw))
        _same(got.top_n(q, 5, rescore=rescore), ref.top_n(q, 5, rescore=rescore))
    # a filter that starves the probed cells: both widen the same way
    order = np.argsort(-(items @ qs[0]))
    blocked = {ids[j] for j in order[:400]}
    keep = lambda s: s not in blocked  # noqa: E731
    _same(got.top_n(qs[0], 10, allowed=keep), ref.top_n(qs[0], 10, allowed=keep))
    for sets in (qs[:1], qs[2:5]):
        _same(got.top_n_cosine(sets, 10), ref.top_n_cosine(sets, 10))
        _same(got.top_n_cosine(sets, 5, offset=2, allowed=allowed),
              ref.top_n_cosine(sets, 5, offset=2, allowed=allowed))


def test_incremental_snapshot_is_the_reference_bytes():
    k = 12
    centers, items, ids = _planted(n=800, k=k, n_centers=16)
    ref, got = _pair(items, ids, k, centers)
    for m in (ref, got):
        _burst(m, centers, items, k, np.random.default_rng(3))
    rs, gs = ref.y_snapshot(), got.y_snapshot()
    assert gs.centroids_np is got._snapshot.centroids_np and gs.n == rs.n == 820
    for name in CELL_TABLES:
        assert _np(getattr(gs, name)).tobytes() == np.asarray(
            getattr(rs, name)).tobytes(), name


# -- the HTTP layer after a MODEL handoff -----------------------------------


def _stream(tmp_path, features: int, seed: int):
    """A reference-trained tiny model's ``(key, message)`` stream and its
    known items (``tests/test_serving.py``'s construction, at ``features``)."""
    from oryx_tpu.models.als import data as ref_data
    from oryx_tpu.models.als import pmml_codec as ref_codec
    from oryx_tpu.models.als import train as ref_train
    from oryx_tpu.pmml import pmmlutils as ref_pmmlutils

    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((30, 3)) @ rng.standard_normal((3, 40))
    lines = [f"u{u},i{i},1,{u * 100 + int(i)}"
             for u in range(30) for i in np.argsort(-scores[u])[:6]]
    batch = ref_data.prepare(lines, implicit=True)
    x, y = ref_train.als_train(batch, features=features, lam=0.001, alpha=1.0,
                               implicit=True, iterations=3, chunk=256)
    pmml = ref_codec.model_to_pmml(
        np.asarray(x), np.asarray(y), batch.users.index_to_id,
        batch.items.index_to_id, features, 0.001, 1.0, True, False, 1e-5,
        tmp_path)
    known: dict = {}
    for it in ref_data.parse_lines(lines):
        known.setdefault(it.user, []).append(it.item)
    out = [("MODEL", ref_pmmlutils.to_string(pmml))]
    for id_, vec in ref_codec.read_features(tmp_path / "Y"):
        out.append(("UP", json.dumps(["Y", id_, [float(v) for v in vec]])))
    for id_, vec in ref_codec.read_features(tmp_path / "X"):
        out.append(("UP", json.dumps(["X", id_, [float(v) for v in vec],
                                      known.get(id_, [])])))
    return out, known


def test_ivf_handoff_http_answers_from_the_new_generation(tmp_path):
    """index.enabled + device-dtype = int8: after a second ``MODEL`` with
    new features the layer's model is the new generation on an IVF
    snapshot, and ``/recommend`` (known items excluded, and with
    ``considerKnownItems``) equals the model's own ``top_n``."""
    tp.reset_memory_brokers()
    port = ioutils.choose_free_port()
    conf = cfg.overlay_on({
        "oryx.serving.api.port": port,
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.models.als.serving.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu_torch.serving.resources.als",
        "oryx.serving.device-dtype": "int8",
        "oryx.serving.index.enabled": True,
        "oryx.serving.index.probes": 4,
    }, cfg.get_default())
    tp.maybe_create_topics(conf, "input-topic", "update-topic")
    prod = tp.TopicProducerImpl("memory:", "OryxUpdate")
    (tmp_path / "g1").mkdir()
    (tmp_path / "g2").mkdir()
    gen1, _ = _stream(tmp_path / "g1", 4, 0)
    gen2, known2 = _stream(tmp_path / "g2", 5, 1)
    for key, msg in gen1:
        prod.send(key, msg)
    layer = ServingLayer(conf, device="cpu")
    layer.start()
    try:
        with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=60) as c:
            deadline = time.monotonic() + 60
            while c.get("/ready").status_code != 200:
                assert time.monotonic() < deadline, "gen1 never ready"
                time.sleep(0.05)
            assert isinstance(layer.manager.get_model().y_snapshot(),
                              ivf.IVFSnapshot)
            for key, msg in gen2:
                prod.send(key, msg)
            deadline = time.monotonic() + 60
            while True:
                model = layer.manager.get_model()
                if (model.features == 5 and model.get_fraction_loaded() >= 1.0
                        and len(model.x.ids()) == len(known2)):
                    break
                assert time.monotonic() < deadline, "gen2 never loaded"
                time.sleep(0.05)
            snap = model.y_snapshot()
            assert isinstance(snap, ivf.IVFSnapshot) and snap.n == model.y.size()
            for u in sorted(known2)[:12]:
                xu = model.get_user_vector(u)
                for consider, excluded in (("false", known2[u]), ("true", None)):
                    r = c.get(f"/recommend/{u}?howMany=5"
                              f"&considerKnownItems={consider}")
                    assert r.status_code == 200
                    want = model.top_n(xu, 5, excluded=excluded)
                    got = [(e["id"], e["value"]) for e in r.json()]
                    assert [i for i, _ in got] == [i for i, _ in want]
                    np.testing.assert_allclose([v for _, v in got],
                                               [v for _, v in want], rtol=1e-6)
                    if excluded:
                        assert not {i for i, _ in got} & set(excluded)
    finally:
        layer.close()
        tp.reset_memory_brokers()


def test_smoke_serving_quant_phase_at_a_small_size(monkeypatch):
    """``chip_smoke.serving_quant_phase`` on the CPU at a small size: flat
    int8 / bfloat16 / LSH beside float32 with their checks, the device
    programs (CUDA events and memory stats stood in for), and the IVF
    index with recall, qps and the burst equal to a rebuild."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "FEATURES", 16)
    monkeypatch.setattr(cs, "IVF_CENTERS", 64)
    monkeypatch.setattr(cs, "IVF_N", 64 * 128)
    monkeypatch.setattr(cs, "IVF_BURST_CHANGED", 500)
    monkeypatch.setattr(cs, "IVF_BURST_NEW", 50)
    monkeypatch.setattr(cs, "INNER", 1)
    monkeypatch.setattr(cs, "resolve", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(cs, "time_ms", lambda fn, **kw: (fn(), 0.5)[1])
    for name, value in (("synchronize", None), ("empty_cache", None),
                        ("reset_peak_memory_stats", None),
                        ("memory_allocated", 1000), ("max_memory_allocated", 2000)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, v=value, **kw: v)
    rng = np.random.default_rng(5)
    y = rng.standard_normal((6000, 16), dtype=np.float32)
    ids = [f"i{j}" for j in range(len(y))]
    flagship = ALSServingModel(16, True, device="cpu")
    flagship.bulk_load_items(ids, y)
    out = cs.serving_quant_phase(flagship, y, ids, rng, device="cpu")
    flat, index = out["flat"], out["ivf"]
    assert set(flat["models"]) == {"float32", "int8", "bfloat16", "lsh_0.3"}
    assert flat["models"]["int8"]["quantized_nbytes"] == 6000 * 20
    assert {p["program"] for p in flat["programs"]} == {
        "int8 scan", "bf16 scan", "LSH-masked scan"}
    assert [m["transient"] for m in flat["int8_scan_memory"]] == [1000, 1000]
    assert index["recall_at_10"] >= 0.99 and index["flat_int8"]["recall_at_10"] >= 0.99
    assert all(index["burst"]["equal_to_rebuild"].values())
    assert set(index["build"]) == {"quantize_s", "fit_s", "assign_s", "land_s"}
    assert {p["program"] for p in index["programs"]} == {"IVF probe", "IVF scan"}
    assert not any(out["launches"].values())
