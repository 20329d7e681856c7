"""k-means model structures: clusters, distances, assignment.

A copy of the JAX package's
``oryx_tpu/models/kmeans/model.py``
(host code, no JAX), held equal to it by ``tests/test_torch_kmeans.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's ClusterInfo / DistanceFn / KMeansUtils
(app/oryx-app-common/.../kmeans/ClusterInfo.java, EuclideanDistanceFn.java,
KMeansUtils.java:36-85). Assignment is vectorized: distances to all centers
come from one ``||x||² − 2·X·Cᵀ + ||c||²`` expansion, so a batch of points
against the centroid matrix is a single MXU matmul instead of the reference's
per-point loop over clusters.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class ClusterInfo:
    """id + center + running count, with running-mean update
    (ClusterInfo.java update())."""

    def __init__(self, id_: int, center: np.ndarray, count: int):
        self.id = int(id_)
        self.center = np.asarray(center, dtype=np.float64)
        self.count = int(count)

    def update(self, vector: np.ndarray, count: int = 1) -> None:
        """Fold ``count`` new points with mean ``vector`` into the running
        centroid mean."""
        total = self.count + count
        self.center = (self.center * self.count + np.asarray(vector) * count) / total
        self.count = total

    def __repr__(self) -> str:  # pragma: no cover
        return f"ClusterInfo({self.id}, count={self.count})"


def check_unique_ids(clusters: Sequence[ClusterInfo]) -> None:
    """(KMeansUtils.checkUniqueIDs:77-85)"""
    ids = [c.id for c in clusters]
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate cluster IDs: {ids}")


def euclidean_distance(a: np.ndarray, b: np.ndarray) -> float:
    """(EuclideanDistanceFn.java)"""
    return float(np.linalg.norm(np.asarray(a, dtype=np.float64) - b))


def distances_to_centers(points: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """(N, k) Euclidean distances via the matmul expansion."""
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    sq = (
        (points * points).sum(axis=1, keepdims=True)
        - 2.0 * points @ centers.T
        + (centers * centers).sum(axis=1)[None, :]
    )
    return np.sqrt(np.maximum(sq, 0.0))


def assign(points: np.ndarray, centers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Nearest-center index and distance per point."""
    d = distances_to_centers(points, centers)
    idx = d.argmin(axis=1)
    return idx, d[np.arange(len(d)), idx]


def closest_cluster(
    clusters: Sequence[ClusterInfo], point: np.ndarray
) -> tuple[ClusterInfo, float]:
    """(KMeansUtils.closestCluster) — returns (cluster, distance)."""
    if not clusters:
        raise ValueError("no clusters")
    centers = np.stack([c.center for c in clusters])
    idx, dist = assign(point, centers)
    return clusters[int(idx[0])], float(dist[0])
