"""k-means internal evaluation metrics, vectorized.

A copy of the JAX package's
``oryx_tpu/models/kmeans/evaluate.py``
(host code, no JAX), held equal to it by ``tests/test_torch_kmeans.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's four KMeansEvalStrategy implementations
(app/oryx-app-mllib/.../kmeans/SilhouetteCoefficient.java:30-120,
DaviesBouldinIndex.java:27-66, DunnIndex.java:27-60, SumSquaredError.java:25-36,
AbstractKMeansEvaluation.java:35-75). Per-point cluster metrics (count, mean
and squared distance to the assigned centroid) come from one batched
assignment; the silhouette's pairwise dissimilarities are a single (S,S)
distance matrix on a capped sample (the reference samples to ≤100k points and
loops; here the cap keeps the O(S²) matrix device-friendly).

Directions follow the reference (KMeansUpdate.evaluate:150-177): silhouette
and Dunn are higher-better; Davies-Bouldin and SSE are lower-better and are
negated by the caller.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from oryx_tpu_torch.models.kmeans.model import ClusterInfo, assign, distances_to_centers

SILHOUETTE_MAX_SAMPLE = 8192  # reference MAX_SAMPLE_SIZE=100000 with host loops


def _centers(clusters: Sequence[ClusterInfo]) -> np.ndarray:
    return np.stack([c.center for c in clusters])


def _cluster_metrics(points: np.ndarray, centers: np.ndarray):
    """Per-cluster (count, mean dist, sum sq dist) — fetchClusterMetrics."""
    idx, dist = assign(points, centers)
    k = len(centers)
    counts = np.bincount(idx, minlength=k).astype(np.float64)
    sum_dist = np.bincount(idx, weights=dist, minlength=k)
    sum_sq = np.bincount(idx, weights=dist * dist, minlength=k)
    with np.errstate(invalid="ignore"):
        mean_dist = np.where(counts > 0, sum_dist / np.maximum(counts, 1), 0.0)
    return idx, counts, mean_dist, sum_sq


def sum_squared_error(clusters: Sequence[ClusterInfo], points: np.ndarray) -> float:
    """Total squared distance to assigned centroids; lower is better."""
    _, _, _, sum_sq = _cluster_metrics(points, _centers(clusters))
    return float(sum_sq.sum())


def davies_bouldin_index(clusters: Sequence[ClusterInfo], points: np.ndarray) -> float:
    """Mean over clusters of max_{j≠i} (scatter_i+scatter_j)/d(c_i,c_j);
    lower is better."""
    centers = _centers(clusters)
    _, _, mean_dist, _ = _cluster_metrics(points, centers)
    k = len(centers)
    if k < 2:
        return 0.0
    center_d = distances_to_centers(centers, centers)
    scatter_sum = mean_dist[:, None] + mean_dist[None, :]  # (k, k)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = scatter_sum / center_d
    np.fill_diagonal(ratio, 0.0)
    # coincident centers ⇒ infinite ratio must PROPAGATE so the degenerate
    # model ranks worst (reference DaviesBouldinIndex.java keeps Infinity);
    # only a 0/0 (both scatters zero too) is treated as no-contribution
    ratio = np.nan_to_num(ratio, nan=0.0)
    return float(ratio.max(axis=1).mean())


def dunn_index(clusters: Sequence[ClusterInfo], points: np.ndarray) -> float:
    """min inter-center distance / max mean intra-cluster distance;
    higher is better."""
    centers = _centers(clusters)
    _, _, mean_dist, _ = _cluster_metrics(points, centers)
    max_intra = mean_dist.max()
    if len(centers) < 2 or max_intra == 0:
        return 0.0
    center_d = distances_to_centers(centers, centers)
    iu = np.triu_indices(len(centers), k=1)
    return float(center_d[iu].min() / max_intra)


def silhouette_coefficient(
    clusters: Sequence[ClusterInfo],
    points: np.ndarray,
    max_sample: int = SILHOUETTE_MAX_SAMPLE,
    rng: "np.random.Generator | None" = None,
) -> float:
    """Mean silhouette over sampled points, in [-1, 1]; higher is better.
    Singleton clusters contribute 0 per point (SilhouetteCoefficient.java:63-66)."""
    points = np.asarray(points, dtype=np.float64)
    if len(points) > max_sample:
        if rng is None:
            from oryx_tpu_torch.common import rand

            rng = rand.get_random()
        points = points[rng.choice(len(points), max_sample, replace=False)]
    centers = _centers(clusters)
    idx, _ = assign(points, centers)
    n, k = len(points), len(centers)
    if n == 0:
        return 0.0
    one_hot = np.zeros((n, k))
    one_hot[np.arange(n), idx] = 1.0
    counts = one_hot.sum(axis=0)  # (k,)
    # (S, k) total distance to each cluster's points, in row blocks so the
    # full S×S pairwise matrix never materializes (O(block·S) transient)
    sums_to_cluster = np.empty((n, k))
    block = 1024
    for start in range(0, n, block):
        d = distances_to_centers(points[start : start + block], points)
        sums_to_cluster[start : start + block] = d @ one_hot
    own = counts[idx]
    # a: mean distance to *other* points of own cluster (n−1 divisor)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = sums_to_cluster[np.arange(n), idx] / np.maximum(own - 1, 1)
        mean_other = sums_to_cluster / np.maximum(counts, 1)[None, :]
    mean_other[:, counts == 0] = np.inf
    mean_other[np.arange(n), idx] = np.inf
    b = mean_other.min(axis=1)
    s = np.where(
        (own > 1) & np.isfinite(b),
        (b - a) / np.maximum(np.maximum(a, b), 1e-30),
        0.0,
    )
    return float(s.mean())
