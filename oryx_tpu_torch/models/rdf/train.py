"""Random-decision-forest training on the card: binned, level-wise, histogram-based.

The port of the JAX package's ``oryx_tpu/models/rdf/train.py`` (MLlib's
``RandomForest.trainClassifier/trainRegressor`` behind RDFUpdate.buildModel
in the original Oryx). Trees grow level by level; each level evaluates every
(node, feature, candidate split) of the frontier at once:

  * features are pre-binned on the host (numeric → quantile thresholds, at
    most ``max_split_candidates - 1`` of them; categorical → the encoding
    itself): :func:`bin_features`, the reference's numpy code;
  * the (node, feature, bin, channel) histogram is one ``index_add_`` over
    a flattened index (see below);
  * the gain of every split comes from prefix sums over the bin axis;
    categorical bins are first ordered by a target statistic (Breiman's
    ordered-prefix trick) with a stable ``argsort`` and ``gather``;
  * per-node random feature subsets (sqrt(P) classification, P/3
    regression: MLlib's "auto") enter as a mask.

The growth loop is host Python, one iteration per depth level, with ONE
device-to-host read per level (the reference's single ``device_get``):
the level's results are packed into one tensor. Host uploads (the feature
masks, the split flags, the bag weights) go through pinned memory without
waiting for the card.

Randomness is the caller's numpy ``Generator``, drawn in the reference's
order: one ``poisson(1.0, n)`` per tree when ``num_trees > 1``, then, level
by level, one ``choice(P, subset, replace=False)`` per node, stopping after
the first level where no node splits. The same seed therefore draws the same
bags and masks in both packages.

The histogram is integer arithmetic, so it is exact and its sums do not
depend on the order in which the card's atomics land:

  * classification: the channels are bag weight × one-hot class, so the
    class is folded into the index (``key·C + class``) and the int32 bag
    weight is the only value scattered;
  * regression: the channels ``[w, w·y, w·y²]`` (the reference's float32
    products) are scaled by a per-tree power of two and rounded to int64
    fixed point, with headroom so that no sum can overflow; the sums are
    converted back to float32 after the prefix sums. They are at least as
    accurate as a float32 sum and equal on every run.

The index is flattened to (node, feature, bin[, class]) over all N·P
(example, feature) pairs: an int32 key and an int32 (classification) or
int64 (regression, one channel at a time) value per pair, about 0.25 GB of
transients at 581,012 × 54 instead of the 0.88 GB of an (N·P, C) float32
operand. Examples already in a finished leaf scatter a zero weight into
node 0, as in the reference.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from oryx_tpu_torch.common.device import resolve

log = logging.getLogger(__name__)

CLASSIFICATION = "classification"
REGRESSION = "regression"

_EPS = 1e-12

# the regression fixed point keeps every sum of |value| · 2^k below 2^61
_FIXED_POINT_BITS = 61


# ---------------------------------------------------------------------------
# Trained-tree structure handed to the PMML codec
# ---------------------------------------------------------------------------


@dataclass
class TrainedSplit:
    predictor_index: int
    threshold: Optional[float]  # numeric: positive/right = value > threshold
    left_categories: Optional[list]  # categorical: encodings routed left/negative
    default_right: bool  # missing values follow the bigger child


@dataclass
class TrainedNode:
    id: str
    count: float  # examples reaching this node (unbagged re-walk)
    split: Optional[TrainedSplit] = None
    negative: "Optional[TrainedNode]" = None
    positive: "Optional[TrainedNode]" = None
    # leaf payload: classification → per-class counts; regression → (mean, n)
    class_counts: Optional[np.ndarray] = None
    mean: Optional[float] = None
    n: Optional[float] = None

    @property
    def is_leaf(self) -> bool:
        return self.split is None


# ---------------------------------------------------------------------------
# Host-side binning (the reference's numpy code)
# ---------------------------------------------------------------------------


def bin_features(
    X: np.ndarray,
    is_categorical: np.ndarray,
    n_categories: np.ndarray,
    max_split_candidates: int,
) -> tuple[np.ndarray, list, int]:
    """Quantile-bin numeric columns; categorical columns keep their encoding.

    Returns (bins int32 (N,P), per-feature thresholds (None for categorical),
    B = max bin count over features).
    """
    n, p = X.shape
    bins = np.zeros((n, p), dtype=np.int32)
    thresholds: list = []
    max_bins = 2
    for j in range(p):
        if is_categorical[j]:
            thresholds.append(None)
            bins[:, j] = X[:, j].astype(np.int32)
            max_bins = max(max_bins, int(n_categories[j]))
        else:
            col = X[:, j]
            qs = (
                np.quantile(col, np.linspace(0, 1, max_split_candidates + 1)[1:-1])
                if n > 1
                else np.zeros(0)
            )
            t = np.unique(qs)
            # drop a threshold equal to the max: nothing would go right of it
            if t.size and t[-1] >= col.max():
                t = t[:-1]
            thresholds.append(t)
            # side="left": bin ≤ s ⇔ value ≤ t[s], matching _finalize_tree and
            # the PMML greaterThan wire convention (value == threshold → left,
            # as in reference RDFUpdate.java:545)
            bins[:, j] = np.searchsorted(t, col, side="left").astype(np.int32)
            max_bins = max(max_bins, t.size + 1)
    return bins, thresholds, max_bins


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``; to the card through pinned memory, without
    waiting for the card."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _fixed_point(values: np.ndarray) -> tuple[np.ndarray, float]:
    """``values`` (float32) as int64 multiples of 2^-k, with k the largest
    that keeps the sum of their magnitudes below 2^61; returns (the int64
    values, 2^-k). Float32 cannot hold a sum past 2^128, so k stays in
    [-60, 100] and 2^-k is a normal float32."""
    total = float(np.abs(values.astype(np.float64)).sum())
    k = 0 if total == 0.0 else int(np.clip(
        math.floor(_FIXED_POINT_BITS - math.log2(total)), -60, 100))
    q = np.rint(values.astype(np.float64) * 2.0 ** k).astype(np.int64)
    return q, 2.0 ** -k


# ---------------------------------------------------------------------------
# One level of frontier growth — the device work
# ---------------------------------------------------------------------------


def _histogram(keys, node_assign, weights, *, n_nodes, n_bins, n_features,
               n_classes):
    """The (n_nodes, P, B, C) integer histogram of one level.

    ``keys`` (N, P) is each pair's (feature, bin[, class]) offset within a
    node's block; ``weights`` is the (N,) int32 bag weight (classification,
    ``n_classes`` > 0) or the list of three (N,) int64 fixed-point channels
    (regression). Inactive examples scatter zero into node 0."""
    n = keys.shape[0]
    active = node_assign >= 0
    node = torch.where(active, node_assign, 0)
    width = n_features * n_bins * (n_classes or 1)
    key = (keys + (node * width).to(keys.dtype)[:, None]).view(-1)
    size = n_nodes * width
    if n_classes:
        src = torch.where(active, weights, 0)[:, None].expand(n, n_features)
        hist = torch.zeros(size, dtype=weights.dtype, device=keys.device)
        hist.index_add_(0, key, src.reshape(-1))
        return hist.view(n_nodes, n_features, n_bins, n_classes)
    hist = torch.zeros((len(weights), size), dtype=torch.int64, device=keys.device)
    for c, w in enumerate(weights):
        src = torch.where(active, w, 0)[:, None].expand(n, n_features)
        hist[c].index_add_(0, key, src.reshape(-1))
    return hist.T.reshape(n_nodes, n_features, n_bins, len(weights))


def _level_step(keys, weights, scales, node_assign, feature_mask, cat_mask, *,
                n_nodes: int, n_bins: int, n_classes: int, task: str,
                impurity: str):
    """Evaluate every (node, feature, candidate-split) of one depth level.

    Returns ``packed``, (n_nodes, 4 + C + B) float32: per node the best gain,
    the best feature, the left and right weight mass, the node's channel
    totals (the leaf statistics) and a (B,) left-bin mask over ORIGINAL bin
    indices; and, on the device, the best feature and the left mask, which
    :func:`_route` reads."""
    n_features = keys.shape[1]
    hist_i = _histogram(keys, node_assign, weights, n_nodes=n_nodes,
                        n_bins=n_bins, n_features=n_features,
                        n_classes=n_classes)
    totals_i = hist_i[:, 0].sum(dim=1)  # (n_nodes, C) node aggregates

    def to_float(h):  # exact integers (classification) or fixed point
        return h.to(torch.float32) * scales

    hist = to_float(hist_i)
    totals = to_float(totals_i)

    def weight_of(h):  # example-weight mass of a histogram slice
        if task == CLASSIFICATION:
            return h.sum(dim=-1)
        return h[..., 0]

    # order bins: numeric = natural order; categorical = by target statistic
    bin_w = weight_of(hist)  # (n_nodes, P, B)
    if task == CLASSIFICATION:
        maj = torch.argmax(totals, dim=1)  # node majority class
        maj_counts = torch.gather(
            hist, 3, maj[:, None, None, None].expand(*hist.shape[:3], 1))[..., 0]
        stat = maj_counts / bin_w.clamp_min(_EPS)
    else:
        stat = hist[..., 1] / hist[..., 0].clamp_min(_EPS)  # per-bin mean y
    natural = torch.arange(n_bins, dtype=stat.dtype,
                           device=stat.device).expand(stat.shape)
    order_key = torch.where(cat_mask[None, :, None], stat, natural)
    order = torch.argsort(order_key, dim=2, stable=True)  # (n_nodes, P, B)
    sorted_i = torch.gather(hist_i, 2, order[..., None].expand(hist_i.shape))

    left_i = torch.cumsum(sorted_i, dim=2)  # prefix sums over ordered bins
    left = to_float(left_i)
    right = to_float(totals_i[:, None, None, :] - left_i)

    def impurity_times_n(h):
        """n * impurity(h) — weight-scaled so child terms just add."""
        if task == CLASSIFICATION:
            nw = h.sum(dim=-1)
            p = h / nw.clamp_min(_EPS)[..., None]
            if impurity == "gini":
                return nw * (1.0 - (p * p).sum(dim=-1))
            logp = torch.where(p > 0, torch.log(p), torch.zeros_like(p))
            return nw * (-(p * logp).sum(dim=-1))
        # variance impurity: sum w*y^2 - (sum w*y)^2 / sum w
        return h[..., 2] - h[..., 1] ** 2 / h[..., 0].clamp_min(_EPS)

    parent = impurity_times_n(totals)  # (n_nodes,)
    gain = parent[:, None, None] - impurity_times_n(left) - impurity_times_n(right)

    nl = weight_of(left)
    nr = weight_of(right)
    valid = (nl > 0) & (nr > 0) & feature_mask[:, :, None]
    # the final prefix (everything left) is never valid since nr == 0 there
    gain = torch.where(valid, gain, torch.full_like(gain, -math.inf))

    flat_gain = gain.reshape(n_nodes, -1)
    best = torch.argmax(flat_gain, dim=1)  # the first maximum, as jnp.argmax
    best_gain = torch.gather(flat_gain, 1, best[:, None])[:, 0]
    best_feature = best // n_bins
    best_s = best % n_bins

    # left mask over ORIGINAL bins: rank of bin in the chosen feature's order ≤ s
    order_f = torch.gather(
        order, 1, best_feature[:, None, None].expand(n_nodes, 1, n_bins))[:, 0, :]
    inv = torch.argsort(order_f, dim=1)  # rank of each original bin
    left_mask = inv <= best_s[:, None]

    count_l = torch.gather(nl.reshape(n_nodes, -1), 1, best[:, None])[:, 0]
    count_r = torch.gather(nr.reshape(n_nodes, -1), 1, best[:, None])[:, 0]
    packed = torch.cat([
        best_gain[:, None], best_feature.to(torch.float32)[:, None],
        count_l[:, None], count_r[:, None], totals,
        left_mask.to(torch.float32)], dim=1)
    return packed, best_feature, left_mask


def _route(bins, node_assign, split_flag, best_feature, left_masks):
    """Send each active example to its child for the next level: left → 2i,
    right → 2i + 1; examples in now-terminal nodes go inactive (-1)."""
    active = node_assign >= 0
    safe = torch.where(active, node_assign, 0)
    f = best_feature[safe]
    b = torch.gather(bins, 1, f[:, None])[:, 0].long()
    goes_left = left_masks[safe, b]
    child = 2 * safe + torch.where(goes_left, 0, 1)
    return torch.where(active & split_flag[safe], child, -1)


# ---------------------------------------------------------------------------
# Forest training
# ---------------------------------------------------------------------------


def subset_size(n_features: int, num_trees: int, task: str) -> int:
    """Per-node feature-subset size: MLlib "auto" (all features if one tree)."""
    if num_trees == 1:
        return n_features
    if task == CLASSIFICATION:
        return max(1, int(np.sqrt(n_features)))
    return max(1, n_features // 3)


class ForestInputs:
    """A forest's training inputs on the device: the binned features, each
    (example, feature) pair's histogram offset within a node's block, the
    categorical mask, and the host arrays each tree's weights come from."""

    def __init__(self, bins_np: np.ndarray, y: np.ndarray,
                 is_categorical: np.ndarray, *, task: str, n_classes: int,
                 n_bins: int, max_depth: int, device: torch.device):
        n, p = bins_np.shape
        self.task = task
        self.n_bins = n_bins
        self.n_features = p
        self.device = device
        self.classification = task == CLASSIFICATION
        self.n_classes = n_classes if self.classification else 0
        c = n_classes if self.classification else 1
        width = (1 << max_depth) * p * n_bins * c
        key_dtype = torch.int32 if width < 2 ** 31 else torch.int64
        self.bins = _upload(bins_np, device)
        keys = (torch.arange(p, device=device, dtype=key_dtype)[None, :] * n_bins
                + self.bins.to(key_dtype))
        if self.classification:
            y_int = np.asarray(y).astype(np.int64)
            # a label outside [0, C) has an all-zero one-hot row in the
            # reference: it adds no weight anywhere
            self.in_range = (y_int >= 0) & (y_int < n_classes)
            cls = _upload(np.where(self.in_range, y_int, 0), device).to(key_dtype)
            keys = keys * n_classes + cls[:, None]
        else:
            self.y32 = np.asarray(y, dtype=np.float32)
            self.y_sq = self.y32 * self.y32
        self.keys = keys
        self.cat_mask = _upload(np.asarray(is_categorical, dtype=bool), device)

    def tree_weights(self, bag: np.ndarray):
        """(weights, scales) of one tree with bag weights ``bag``: the int32
        weight (classification) or the three int64 fixed-point channels of
        the reference's float32 ``[1, y, y*y] * bag`` and their scales."""
        if self.classification:
            weights = _upload(np.where(self.in_range, bag, 0).astype(np.int32),
                              self.device)
            return weights, torch.ones((), dtype=torch.float32, device=self.device)
        fixed = [_fixed_point(ch)
                 for ch in (bag, self.y32 * bag, self.y_sq * bag)]
        weights = [_upload(q, self.device) for q, _ in fixed]
        scales = torch.tensor([sc for _, sc in fixed], dtype=torch.float32,
                              device=self.device)
        return weights, scales


def forest_train(
    X: np.ndarray,
    y: np.ndarray,
    is_categorical: Sequence[bool],
    n_categories: Sequence[int],
    *,
    task: str,
    n_classes: int = 0,
    num_trees: int,
    max_depth: int,
    max_split_candidates: int,
    impurity: str = "entropy",
    min_node_size: int = 1,
    min_info_gain_nats: float = 0.0,
    rng: "np.random.Generator",
    device=None,
    timings: "dict | None" = None,
    levels_out: "list | None" = None,
) -> tuple[list[TrainedNode], np.ndarray]:
    """Train a forest on ``device`` (``None``: the CUDA card); returns (tree
    roots, per-predictor importances).

    Node record counts come from an unbagged re-walk of the training data,
    and importances are each predictor's share of all examples passing
    through nodes that split on it (RDFUpdate.treeNodeExampleCounts:267,
    predictorExampleCounts:310, countsToImportances:547-553).

    ``timings``, when a dict is passed, receives ``bin_s`` (host binning),
    ``upload_s`` (the binned features to the device), ``levels_s`` (the
    device levels, their host reads and routing), ``masks_s`` (the host's
    feature-mask draws), ``finalize_s`` (the host re-walk and tree build),
    ``levels`` and ``host_syncs`` (one per level). ``levels_out``, when a
    list is passed, receives each tree's per-level host arrays (the split
    decisions and each node's best gain, ``gain``).
    """
    dev = resolve(device)
    n, p = X.shape
    if n == 0:
        raise ValueError("no training examples")
    is_categorical = np.asarray(is_categorical, dtype=bool)
    n_categories = np.asarray(n_categories, dtype=np.int64)
    if task == CLASSIFICATION and n_classes < 2:
        raise ValueError("classification needs >= 2 classes")
    if task == REGRESSION:
        impurity = "variance"
    elif impurity not in ("gini", "entropy"):
        raise ValueError(f"bad impurity: {impurity}")
    if min_node_size < 1:
        raise ValueError("min-node-size must be at least 1")
    if min_info_gain_nats < 0:
        raise ValueError("min-info-gain-nats must be non-negative")

    clock = {"bin_s": 0.0, "upload_s": 0.0, "levels_s": 0.0, "masks_s": 0.0,
             "finalize_s": 0.0, "levels": 0, "host_syncs": 0}
    t0 = time.perf_counter()
    bins_np, thresholds, n_bins = bin_features(
        X, is_categorical, n_categories, max_split_candidates
    )
    clock["bin_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    inputs = ForestInputs(bins_np, y, is_categorical, task=task,
                          n_classes=n_classes, n_bins=n_bins,
                          max_depth=max_depth, device=dev)
    clock["upload_s"] = time.perf_counter() - t0

    subset = subset_size(p, num_trees, task)

    trees: list[TrainedNode] = []
    predictor_counts = np.zeros(p, dtype=np.float64)

    for _ in range(num_trees):
        bag = (
            rng.poisson(1.0, size=n).astype(np.float32)
            if num_trees > 1
            else np.ones(n, dtype=np.float32)
        )
        levels = grow_tree(
            inputs,
            *inputs.tree_weights(bag),
            rng,
            subset_size=subset,
            max_depth=max_depth,
            impurity=impurity,
            min_node_size=min_node_size,
            min_info_gain_nats=min_info_gain_nats,
            clock=clock,
        )
        if levels_out is not None:
            levels_out.append(levels)
        t0 = time.perf_counter()
        root, pred_counts = _finalize_tree(
            levels, bins_np, thresholds, is_categorical, n_categories, task
        )
        clock["finalize_s"] += time.perf_counter() - t0
        trees.append(root)
        predictor_counts += pred_counts
    total = predictor_counts.sum()
    importances = predictor_counts / total if total > 0 else np.zeros(p)
    if timings is not None:
        timings.update(clock)
    return trees, importances


def _draw_masks(rng, n_nodes: int, n_features: int, subset_size: int) -> np.ndarray:
    mask_np = np.zeros((n_nodes, n_features), dtype=bool)
    for i in range(n_nodes):
        mask_np[i, rng.choice(n_features, size=subset_size, replace=False)] = True
    return mask_np


def grow_tree(
    inputs: ForestInputs, weights, scales, rng, *, subset_size, max_depth,
    impurity, min_node_size=1, min_info_gain_nats=0.0, clock=None,
):
    """Level-wise growth of one tree; returns per-level split decisions as
    host arrays. ``clock``, a dict, accumulates the timings of
    :func:`forest_train`."""
    if clock is None:
        clock = {"levels_s": 0.0, "masks_s": 0.0, "levels": 0, "host_syncs": 0}
    dev, task, n_bins = inputs.device, inputs.task, inputs.n_bins
    n_features = inputs.n_features
    n = inputs.keys.shape[0]
    node_assign = torch.zeros(n, dtype=torch.int64, device=dev)
    levels = []
    for depth in range(max_depth + 1):
        n_nodes = 1 << depth
        t0 = time.perf_counter()
        mask_np = _draw_masks(rng, n_nodes, n_features, subset_size)
        t1 = time.perf_counter()
        clock["masks_s"] += t1 - t0
        packed, feat, left_mask = _level_step(
            inputs.keys,
            weights,
            scales,
            node_assign,
            _upload(mask_np, dev),
            inputs.cat_mask,
            n_nodes=n_nodes,
            n_bins=n_bins,
            n_classes=inputs.n_classes,
            task=task,
            impurity=impurity,
        )
        # ONE device-to-host read per level: the split decision is host
        # control flow by design (level-wise growth)
        host = packed.cpu().numpy()
        clock["host_syncs"] += 1
        clock["levels"] += 1
        c = host.shape[1] - 4 - n_bins
        gain = host[:, 0]
        feat_np = host[:, 1].astype(np.int32)
        cl_np, cr_np = host[:, 2], host[:, 3]
        totals_np = host[:, 4:4 + c]
        left_mask_np = host[:, 4 + c:] > 0.5
        # a node splits if it found positive gain, more depth is allowed, and
        # the reference's pre-prune knobs pass: per-example gain at least
        # min-info-gain-nats, both children at least min-node-size examples
        # (oryx.rdf.hyperparams.*, RDFUpdate.java minNodeSize/minInfoGainNats)
        node_w = totals_np.sum(axis=1) if task == CLASSIFICATION else totals_np[:, 0]
        norm_gain = gain / np.maximum(node_w, _EPS)
        split = (
            np.isfinite(gain)
            & (gain > _EPS)
            & (depth < max_depth)
            & (norm_gain >= min_info_gain_nats)
            & (cl_np >= min_node_size)
            & (cr_np >= min_node_size)
        )
        levels.append(
            dict(
                split=split,
                feature=feat_np,
                left_mask=left_mask_np,
                count_l=cl_np,
                count_r=cr_np,
                totals=totals_np,
                gain=gain,
            )
        )
        if not split.any():
            clock["levels_s"] += time.perf_counter() - t1
            break
        node_assign = _route(inputs.bins, node_assign, _upload(split, dev),
                             feat, left_mask)
        clock["levels_s"] += time.perf_counter() - t1
    return levels


def _finalize_tree(levels, bins_np, thresholds, is_categorical, n_categories, task):
    """Host pass: re-walk the unbagged data for per-node record counts and
    per-predictor example counts, then build the TrainedNode tree."""
    n, p = bins_np.shape
    assign = np.zeros(n, dtype=np.int64)
    active = np.ones(n, dtype=bool)
    node_counts_per_level = []
    pred_counts = np.zeros(p, dtype=np.float64)
    rows = np.arange(n)
    for level in levels:
        n_nodes = len(level["split"])
        counts = np.bincount(assign[active], minlength=n_nodes).astype(np.float64)
        node_counts_per_level.append(counts)
        for i in np.nonzero(level["split"])[0]:
            pred_counts[level["feature"][i]] += counts[i]
        # route the still-active examples whose node split
        safe = np.clip(assign, 0, n_nodes - 1)
        splits_here = level["split"][safe] & active
        feat = level["feature"][safe]
        goes_left = level["left_mask"][safe, bins_np[rows, feat]]
        assign = np.where(splits_here, 2 * assign + np.where(goes_left, 0, 1), assign)
        active = splits_here

    def build(depth: int, idx: int, node_id: str) -> TrainedNode:
        level = levels[depth]
        counts = node_counts_per_level[depth]
        count = float(counts[idx]) if idx < len(counts) else 0.0
        totals = level["totals"][idx]
        if not level["split"][idx] or depth + 1 >= len(levels):
            return _leaf(node_id, count, totals, task)
        f = int(level["feature"][idx])
        lm = level["left_mask"][idx]
        default_right = bool(level["count_r"][idx] > level["count_l"][idx])
        if is_categorical[f]:
            left_cats = [b for b in range(int(n_categories[f])) if lm[b]]
            split = TrainedSplit(f, None, left_cats, default_right)
        else:
            t = thresholds[f]
            s = int(lm.sum()) - 1  # bins ≤ s go left ⇔ value ≤ t[s]
            thr = float(t[s]) if s < len(t) else float(np.inf)
            split = TrainedSplit(f, thr, None, default_right)
        return TrainedNode(
            node_id,
            count,
            split=split,
            negative=build(depth + 1, 2 * idx, node_id + "-"),
            positive=build(depth + 1, 2 * idx + 1, node_id + "+"),
        )

    return build(0, 0, "r"), pred_counts


def _leaf(node_id: str, count: float, totals: np.ndarray, task: str) -> TrainedNode:
    if task == CLASSIFICATION:
        cc = np.asarray(totals, dtype=np.float64)
        if cc.sum() <= 0:
            cc = np.ones_like(cc)  # node never saw bagged weight: uniform
        return TrainedNode(node_id, count, class_counts=cc)
    w, wy = float(totals[0]), float(totals[1])
    mean = wy / w if w > 0 else 0.0
    return TrainedNode(node_id, count, mean=mean, n=max(w, 0.0))
