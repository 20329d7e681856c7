"""k-means training on the card.

The port of the JAX package's ``oryx_tpu/models/kmeans/train.py``
(Spark MLlib's ``KMeans.train`` behind KMeansUpdate.buildModel in the
original Oryx):

  * :func:`kmeans_train` — the batch trainer. Each restart seeds its centres
    (``random``: k distinct points; ``k-means||``: sequential D²-weighted
    k-means++ seeding), then runs ``iterations`` Lloyd sweeps and one more
    that only reads counts and cost, each sweep one call of the hand-written
    kernel :func:`~oryx_tpu_torch.ops.kernels.kmeans_assign_accumulate`.
    An empty cluster keeps its centre (MLlib's behaviour). Restarts run one
    after another; the lowest cost wins, the first on a tie.
  * :func:`fit_index_centroids` — the bounded deterministic fit for an IVF
    index, in plain torch as the reference computes it (no kernel): Lloyd
    sweeps from k-means++ centres, then empty clusters reseeded onto the
    worst-served points.

Randomness comes from explicit ``torch.Generator`` objects on the points'
device (``jax.random`` streams cannot be reproduced in torch): a test that
compares values with the reference injects the same starting centres
through ``init_centers`` (see :func:`oryx_tpu_torch.state.kmeans_centers`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from oryx_tpu_torch.common import rand
from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.ops import kernels as K

INIT_RANDOM = "random"
INIT_KMEANS_PARALLEL = "k-means||"


def _sq_dists(points, centers):
    """(N, k) squared Euclidean distances by the matmul expansion."""
    sq = ((points * points).sum(dim=1, keepdim=True)
          - 2.0 * points @ centers.T
          + (centers * centers).sum(dim=1)[None, :])
    return sq.clamp_min(0.0)


def _device_generator(generator: torch.Generator,
                      device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from the next draw of ``generator``
    (torch's samplers on the card need a generator on the card)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(device=device).manual_seed(seed)


def _init_random(generator, points, k: int):
    """k distinct points, uniformly."""
    idx = torch.randperm(points.shape[0], generator=generator,
                         device=points.device)[:k]
    return points[idx]


def _init_plus_plus(generator, points, k: int):
    """D²-weighted sequential seeding (k-means++). No host sync: the
    degenerate case (every point on a centre) draws uniformly on the card."""
    n = points.shape[0]
    centers = torch.empty((k, points.shape[1]), dtype=points.dtype,
                          device=points.device)
    # index_select with a (1,) index tensor: indexing with a 0-d tensor
    # would read it back to the host
    first = torch.randint(0, n, (1,), generator=generator, device=points.device)
    centers[0] = points.index_select(0, first)[0]
    min_d2 = _sq_dists(points, centers[:1])[:, 0]
    uniform = torch.full_like(min_d2, 1.0 / n)
    for j in range(1, k):
        total = min_d2.sum()
        probs = torch.where(total > 0, min_d2 / total.clamp_min(1e-30), uniform)
        c = points.index_select(0, torch.multinomial(probs, 1, generator=generator))
        centers[j] = c[0]
        d2_new = ((points - c) ** 2).sum(dim=1)
        min_d2 = torch.minimum(min_d2, d2_new)
    return centers


def _init_centers(generator, points, k: int, init: str):
    if init == INIT_RANDOM:
        return _init_random(generator, points, k)
    return _init_plus_plus(generator, points, k)


def _lloyd_run(points, weights, centers, iterations: int):
    """``iterations`` sweeps from ``centers`` and a last one that reads only
    counts and cost: ``iterations + 1`` kernel calls, no host sync."""
    counts = cost = None
    for i in range(iterations + 1):
        sums, counts, cost = K.kmeans_assign_accumulate(points, weights, centers)
        if i < iterations:
            new_centers = sums / counts.clamp_min(1.0)[:, None]
            centers = torch.where((counts > 0)[:, None], new_centers, centers)
    return centers, counts, cost


def _as_points(points, dev: torch.device) -> torch.Tensor:
    if isinstance(points, torch.Tensor):
        return points.to(device=dev, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.asarray(points, dtype=np.float32), device=dev)


def kmeans_train(points, k: int, iterations: int = 30, runs: int = 1,
                 init: str = INIT_KMEANS_PARALLEL,
                 generator: "torch.Generator | None" = None, device=None,
                 init_centers=None, timings: "dict | None" = None):
    """Train on (N, d) points; returns (centers (k, d) float64 numpy,
    counts (k,) int64 numpy), k clamped to N.

    ``generator`` seeds the restarts (default: one from
    :func:`oryx_tpu_torch.common.rand.torch_generator`). ``init_centers``,
    a (k, d) array or one (k, d) array per run, replaces the seeding: the
    test seam that starts the port from the reference's centres.
    ``timings``, when a dict is passed, receives ``init_s`` and
    ``sweeps_s``, the seconds of seeding and of the Lloyd sweeps over all
    runs (measured by synchronising the device between them, which only a
    timed call does).
    """
    dev = resolve(device)
    pts = _as_points(points, dev)
    n = pts.shape[0]
    if n == 0:
        raise ValueError("no points")
    k = min(int(k), n)
    runs = max(int(runs), 1)
    weights = torch.ones((n,), dtype=torch.float32, device=dev)
    if init_centers is not None:
        starts = torch.as_tensor(init_centers, dtype=torch.float32).to(dev)
        if starts.dim() == 2:
            starts = starts.expand(runs, *starts.shape)
        if starts.shape != (runs, k, pts.shape[1]):
            raise ValueError(f"init_centers has shape {tuple(starts.shape)}, "
                             f"expected {(runs, k, pts.shape[1])}")
    elif generator is None:
        generator = rand.torch_generator()
    clock = {"init_s": 0.0, "sweeps_s": 0.0}

    def timed(key, fn, *args):
        if timings is None:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        clock[key] += time.perf_counter() - t0
        return out

    results = []
    for r in range(runs):
        if init_centers is not None:
            seed = starts[r].contiguous()
        else:
            seed = timed("init_s", _init_centers,
                         _device_generator(generator, dev), pts, k, init)
        results.append(timed("sweeps_s", _lloyd_run, pts, weights, seed,
                             iterations))
    if timings is not None:
        timings.update(clock)
    costs = torch.stack([r[2] for r in results])
    best = int(torch.argmin(costs))  # the first on a tie
    centers, counts = results[best][0], results[best][1]
    return (centers.cpu().numpy().astype(np.float64),
            counts.cpu().numpy().astype(np.int64))


# -- the IVF index's fit (plain torch, no kernel) ------------------------------


def _lloyd_from(points, centers, iterations: int):
    """``iterations`` Lloyd sweeps from given centres with unit weights;
    returns the final (centers, counts, assign)."""
    for _ in range(iterations):
        d2 = _sq_dists(points, centers)
        a = torch.nn.functional.one_hot(d2.argmin(dim=1), centers.shape[0]) \
            .to(points.dtype)
        counts = a.sum(dim=0)
        sums = a.T @ points
        new_centers = sums / counts.clamp_min(1.0)[:, None]
        centers = torch.where((counts > 0)[:, None], new_centers, centers)
    assign = _sq_dists(points, centers).argmin(dim=1)
    counts = torch.bincount(assign, minlength=centers.shape[0]).to(points.dtype)
    return centers, counts, assign


def _reseed_empty(points: np.ndarray, centers: np.ndarray,
                  counts: np.ndarray, assign: np.ndarray) -> np.ndarray:
    """Move each empty cluster's centre onto the point farthest from its
    assigned centre (distinct points, worst-served first). Host numpy, a
    copy of the reference's."""
    empty = np.flatnonzero(counts == 0)
    if empty.size == 0:
        return centers
    d2 = ((points - centers[assign]) ** 2).sum(axis=1)
    order = np.argsort(-d2, kind="stable")
    centers = centers.copy()
    for j, c in enumerate(empty[: len(order)]):
        centers[c] = points[order[j]]
    return centers


def fit_index_centroids(points, k: int, iterations: int = 20, seed: int = 0,
                        reseed_rounds: int = 4, device=None):
    """Deterministic bounded k-means fit for an IVF index: k-means++ from a
    generator seeded with ``seed``, at most ``iterations`` Lloyd sweeps, then
    up to ``reseed_rounds`` empty-cluster repairs (reseed onto the
    worst-served points, then 2 more sweeps). Returns (centers (k, d)
    float32, counts (k,) int64, assign (n,) int32), numpy."""
    dev = resolve(device)
    host = np.ascontiguousarray(np.asarray(points, dtype=np.float32))
    n = len(host)
    if n == 0:
        raise ValueError("no points")
    k = max(1, min(int(k), n))
    pts = torch.as_tensor(host, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    centers = _init_centers(g, pts, k, INIT_KMEANS_PARALLEL)
    centers, counts, assign = _lloyd_from(pts, centers, int(iterations))
    for _ in range(max(0, int(reseed_rounds))):
        counts_np = counts.cpu().numpy()
        if (counts_np > 0).all():
            break
        patched = _reseed_empty(host, centers.cpu().numpy(), counts_np,
                                assign.cpu().numpy())
        centers, counts, assign = _lloyd_from(
            pts, torch.as_tensor(patched, device=dev), 2)
    return (centers.cpu().numpy().astype(np.float32),
            counts.cpu().numpy().astype(np.int64),
            assign.cpu().numpy().astype(np.int32))
