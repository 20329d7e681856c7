"""ALS evaluation: RMSE (explicit) and mean per-user AUC (implicit).

The port of the reference's ``models/als/evaluate.py`` (Evaluation.java:
49-137 in the original Oryx): explicit models score RMSE over the test
split; implicit models score mean AUC, each user's positive test items
against sampled negatives (items the user has not interacted with).
Negative sampling is the reference's host algorithm on a numpy generator
from :mod:`oryx_tpu_torch.common.rand`, so under the test seed both packages
draw the same negatives; scoring is one gather and row-wise dot on the
factors' device.
"""

from __future__ import annotations

import numpy as np
import torch

from oryx_tpu_torch.common import rand
from oryx_tpu_torch.models.als.data import RatingBatch


def _pair_scores(x, y, rows, cols) -> torch.Tensor:
    return (x[rows] * y[cols]).sum(dim=-1)


def _index(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=like.device)


def rmse(x: torch.Tensor, y: torch.Tensor, test: RatingBatch) -> float:
    """Root mean squared error over test pairs (Evaluation.rmse)."""
    if test.nnz == 0:
        return float("nan")
    preds = _pair_scores(x, y, _index(test.rows, x), _index(test.cols, y))
    vals = torch.as_tensor(test.vals, dtype=torch.float32, device=x.device)
    return float(torch.sqrt(torch.mean((preds - vals) ** 2)))


def area_under_curve(x: torch.Tensor, y: torch.Tensor, train: RatingBatch,
                     test: RatingBatch, negatives_per_positive: int = 10,
                     rng: "np.random.Generator | None" = None) -> float:
    """Mean over users of per-user AUC vs sampled negatives
    (Evaluation.areaUnderCurve). ``rng`` defaults to a generator from
    :func:`oryx_tpu_torch.common.rand.get_random`."""
    if test.nnz == 0:
        return float("nan")
    n_items = y.shape[0]
    if n_items < 2:
        return float("nan")
    known: dict[int, set[int]] = {}
    for r, c in zip(train.rows.tolist(), train.cols.tolist()):
        known.setdefault(r, set()).add(c)
    for r, c in zip(test.rows.tolist(), test.cols.tolist()):
        known.setdefault(r, set()).add(c)

    rng = rand.get_random() if rng is None else rng
    pos_rows, pos_cols, neg_cols = [], [], []
    npp = negatives_per_positive
    # per-user rejection sampling with top-up retries (the reference's
    # algorithm, draw for draw)
    by_user: dict[int, list[int]] = {}
    for r, c in zip(test.rows.tolist(), test.cols.tolist()):
        by_user.setdefault(r, []).append(c)
    for r, cols in by_user.items():
        ku = known.get(r, set())
        if len(ku) >= n_items:
            continue
        ku_arr = np.fromiter(ku, dtype=np.int64, count=len(ku))
        need = npp * len(cols)
        negs: list[int] = []
        for _ in range(100):
            if len(negs) >= need:
                break
            draw = rng.integers(0, n_items, size=max(2 * (need - len(negs)), 16))
            negs.extend(draw[~np.isin(draw, ku_arr)][: need - len(negs)].tolist())
        for i, c in enumerate(cols):
            for j in negs[i * npp : (i + 1) * npp]:
                pos_rows.append(r)
                pos_cols.append(c)
                neg_cols.append(j)
    if not pos_rows:
        return float("nan")
    rows = np.asarray(pos_rows, dtype=np.int64)
    rows_t = _index(rows, x)
    pos_scores = _pair_scores(x, y, rows_t, _index(pos_cols, y))
    neg_scores = _pair_scores(x, y, rows_t, _index(neg_cols, y))
    pos_scores, neg_scores = (s.cpu().numpy() for s in (pos_scores, neg_scores))
    correct = (pos_scores > neg_scores).astype(np.float64) + 0.5 * (
        pos_scores == neg_scores)
    # mean of per-user AUC (not pooled) — the reference averages per user
    sums = np.bincount(rows, weights=correct)
    counts = np.bincount(rows)
    users = counts > 0
    return float(np.mean(sums[users] / counts[users]))
