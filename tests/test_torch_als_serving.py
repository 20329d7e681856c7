"""The port's ALS serving and evaluation against the reference's, on the
same factors (carried across with ``oryx_tpu_torch.state``) and, for AUC,
the same negative-sampling seed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from oryx_tpu.common import rand as ref_rand
from oryx_tpu.models.als import evaluate as ref_eval
from oryx_tpu.models.als.data import IDIndexMapping
from oryx_tpu.models.als.data import RatingBatch as RefBatch
from oryx_tpu.models.als.serving import ALSServingModel as RefModel
from oryx_tpu_torch import state
from oryx_tpu_torch.common import rand
from oryx_tpu_torch.models.als import data, evaluate

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

# score tolerance (absolute, scores are O(1)): float32 dot products of 12
# terms in another summation order
SCORE_TOL = 1e-5


def _factors(seed, n_users=40, n_items=300, k=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_users, k)).astype(np.float32)
    y = rng.standard_normal((n_items, k)).astype(np.float32)
    # a few exact ties among items, to exercise the tie comparison
    y[7] = y[3]
    y[11] = y[3]
    users = [f"u{i}" for i in range(n_users)]
    items = [f"i{i}" for i in range(n_items)]
    return x, y, users, items


def _assert_same_top_n(got, ref, qs, y):
    """Same scores in the same order; at each position the same id, unless
    the two ids' exact scores are tied within the tolerance."""
    assert len(got) == len(ref)
    for g, r, q in zip(got, ref, qs):
        assert len(g) == len(r)
        assert len({i for i, _ in g}) == len(g)
        gs = np.array([s for _, s in g])
        rs = np.array([s for _, s in r])
        assert np.abs(gs - rs).max(initial=0.0) < SCORE_TOL
        exact = y.astype(np.float64) @ q.astype(np.float64)
        for (gid, _), (rid, _) in zip(g, r):
            if gid != rid:
                assert abs(exact[int(gid[1:])] - exact[int(rid[1:])]) < SCORE_TOL


def _models(seed):
    x, y, users, items = _factors(seed)
    ref = RefModel(y.shape[1], True, device_dtype="float32")
    ref.bulk_load_users(users, x)
    ref.bulk_load_items(items, y)
    got = state.serving_model(x, y, users, items, device="cpu")
    return x, y, users, items, ref, got


@pytest.mark.parametrize("how_many", [1, 10, 40])
def test_top_n_batch_matches_reference(how_many):
    x, y, _, _, ref, got = _models(1)
    qs = np.concatenate([x[:9], y[3:4]])  # scores the tied items highest
    _assert_same_top_n(got.top_n_batch(qs, how_many),
                       ref.top_n_batch(qs, how_many), qs, y)


def test_top_n_batch_with_exclusion_matches_reference():
    x, y, _, items, ref, got = _models(2)
    rng = np.random.default_rng(5)
    excluded = [
        [items[j] for j in rng.choice(len(items), size=n, replace=False)]
        for n in (0, 1, 7, 8, 9, 30)
    ]
    excluded[2] = excluded[2] + ["unknown-item"]  # ids absent from Y drop
    qs = x[:6]
    res = got.top_n_batch(qs, 10, excluded=excluded)
    _assert_same_top_n(res, ref.top_n_batch(qs, 10, excluded=excluded), qs, y)
    for r, ex in zip(res, excluded):
        assert not {i for i, _ in r} & set(ex)


def test_top_n_with_offset_allowed_and_exclusion_matches_reference():
    x, y, _, items, ref, got = _models(3)
    allowed = lambda i: int(i[1:]) % 3 == 0  # noqa: E731
    kw = dict(offset=2, allowed=allowed, excluded=items[:5])
    _assert_same_top_n([got.top_n(x[0], 5, **kw)],
                       [ref.top_n(x[0], 5, **kw)], x[:1], y)
    alloweds = [allowed, None]
    _assert_same_top_n(got.top_n_batch(x[:2], 4, alloweds=alloweds),
                       ref.top_n_batch(x[:2], 4, alloweds=alloweds), x[:2], y)


def test_point_update_reaches_the_device_copy():
    x, y, _, _, _, got = _models(4)
    q = x[0]
    best = got.top_n(q, 1)[0][0]
    got.set_item_vector("new", 100.0 * q)
    assert got.top_n(q, 1)[0][0] == "new"
    assert got.top_n_batch(q[None], 2)[0][1][0] == best


def _eval_batches(seed, n_users=40, n_items=300):
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, n_users * n_items, 2000))
    rows, cols = (pairs // n_items).astype(np.int32), (pairs % n_items).astype(np.int32)
    vals = rng.standard_normal(len(pairs)).astype(np.float32)
    test = rng.random(len(pairs)) < 0.2
    users = IDIndexMapping(f"u{i}" for i in range(n_users))
    items = IDIndexMapping(f"i{i}" for i in range(n_items))
    out = []
    for cls in (RefBatch, data.RatingBatch):
        out.append(tuple(cls(rows[m], cols[m], vals[m], users, items)
                         for m in (~test, test)))
    return out


def test_rmse_and_auc_match_reference():
    """RMSE within 1e-6 relative; AUC within 1e-9: the same negatives
    (both generators under the test seed) on float32 scores whose order
    the summation order does not change at these margins."""
    x, y, _, _ = _factors(6)
    (ref_train, ref_test), (train, test) = _eval_batches(6)
    tx, ty = (state.init_y(a, device="cpu") for a in (x, y))
    r = ref_eval.rmse(x, y, ref_test)
    assert abs(evaluate.rmse(tx, ty, test) - r) < 1e-6 * r
    ref_rand.use_test_seed()
    ref_auc = ref_eval.area_under_curve(x, y, ref_train, ref_test)
    rand.use_test_seed()
    auc = evaluate.area_under_curve(tx, ty, train, test)
    assert 0.0 < ref_auc < 1.0
    assert abs(auc - ref_auc) < 1e-9
