#!/usr/bin/env python3
"""Drive the PyTorch port's ALS loop and k-means path on one CUDA card and
check every step.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``. Imports nothing of JAX or of the reference package
``oryx_tpu``. Phases, each printing one JSON object per line:

  env      torch/CUDA versions, the card's name and power limit (the raw
           ``nvidia-smi`` line is printed on its own line too);
  build    every kernel built from ``oryx_tpu_torch/ops/csrc`` into
           ``build/`` (one ``nvcc`` per source, started together);
  data     a seeded synthetic implicit dataset at the batch benchmark's
           training shape — 100,000 users × 10,000 items, ~1,000,000
           interactions with planted rank-5 preferences and power-law item
           popularity (exponent −0.8) — as CSV lines through
           ``data.prepare``, with a 10% hold-out;
  kernels  each kernel against its plain PyTorch version on the card, on
           the first packed block of each side of that data (k = 50;
           gather-Gramian in float32 and bfloat16), timed with CUDA events
           beside the plain version, a one-call library equivalent where
           one exists, and the card's bound for the same work;
  train    the main path: ``als_train`` (k = 50, λ = 1, α = 1, implicit,
           3 iterations, float32) with the launch counters set to 0 just
           before; both kernels must have launched once per row block per
           iteration; factors finite; hold-out AUC > 0.75;
  serve    the trained model loaded into ``ALSServingModel``: 256 users'
           ``top_n_batch(how_many=10)`` excluding their training items,
           checked against an exact float64 scan (overlap >= 0.99); the
           counters are read after it;
  profile  one more training iteration under ``torch.profiler`` (device
           time by kernel, idle share);
  serve_flagship
           1,000,000 items × 50 features (seeded), ``top_n_batch`` timed
           at batch 1, 16 and 256, top-10, checked against an exact scan;
  kmeans_kernel
           the Lloyd-sweep kernel against its plain version on 1,000,000 ×
           64 standard-normal points with K = 256 (near ties allowed, timed
           beside the plain version, the cross term's ``torch.matmul`` and
           the card's bound), on 200,000 points of 256 planted blobs (exact
           counts), and at K = 1,024, D = 128 (chunked centres, partial sums
           in device memory);
  kmeans_update
           the k-means main path: 100,000 CSV lines of 64 features from
           the planted blobs through ``KMeansUpdate.build_model`` (the
           reference's defaults with k = 256: 3 runs × 30 iterations,
           k-means||) and ``evaluate`` with all four strategies, the launch
           counters set to 0 just before and read just after (93 sweeps);
           −SSE against one more sweep's cost on the published centres; the
           PMML served by ``KMeansServingModelManager`` (1,000 queries
           against a host float64 assign); a 10,000-line microbatch folded by
           ``KMeansSpeedModelManager`` and its ``UP`` lines applied to the
           serving model;
  kmeans_train
           ``kmeans_train`` at 1,000,000 × 64, k = 256, 8 iterations, one
           run, twice (the second timed): point-iters/s, seeding and sweep
           seconds apart.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the script
exits non-zero and prints no ``ok`` line. Without a CUDA card it exits 1
at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import config as oryx_config
from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.models.als import data as als_data
from oryx_tpu_torch.models.als import evaluate
from oryx_tpu_torch.models.als import train as tr
from oryx_tpu_torch.models.als.serving import ALSServingModel
from oryx_tpu_torch.models.kmeans import pmml_codec
from oryx_tpu_torch.models.kmeans import train as kmtrain
from oryx_tpu_torch.models.kmeans.serving import KMeansServingModelManager
from oryx_tpu_torch.models.kmeans.speed import KMeansSpeedModelManager
from oryx_tpu_torch.models.kmeans.update import KMeansUpdate
from oryx_tpu_torch.ops import _build
from oryx_tpu_torch.ops import kernels as K
from oryx_tpu_torch.pmml import pmmlutils
from oryx_tpu_torch import state

SEED = 20261016
N_USERS, N_ITEMS, NNZ, RANK = 100_000, 10_000, 1_000_000, 5
# λ = 1: with ~9 interactions per user, ALS-WR's λ·n_u at λ = 0.01 leaves
# 50 features nearly unregularised and the hold-out AUC falls well short
# of the 0.75 gate; the kernels' work does not depend on λ
FEATURES, LAM, ALPHA, ITERATIONS = 50, 1.0, 1.0, 3
TEST_FRACTION = 0.1
FLAGSHIP_ITEMS = 1_000_000

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

GG_SOURCE = "oryx_tpu_torch/ops/csrc/gather_gramian.cu"
SPD_SOURCE = "oryx_tpu_torch/ops/csrc/spd_solve.cu"
GG_REPLACES = "oryx_tpu/ops/pallas_kernels.py:221"
SPD_REPLACES = "oryx_tpu/ops/pallas_kernels.py:89"
KM_SOURCE = "oryx_tpu_torch/ops/csrc/kmeans_assign.cu"
KM_REPLACES = "oryx_tpu/ops/pallas_kernels.py:357"
ALS_WRAPPERS = ("gather_gramian_accumulate", "spd_solve_batched")

# k-means: bench_batch.py's accelerator shape (1M × 64, K = 256, 8
# iterations); the update path's data are planted Gaussian blobs (centres
# uniform in [−10, 10]^64, σ = 1), k = 256 with the reference's defaults
KM_N, KM_D, KM_K, KM_ITERATIONS = 1_000_000, 64, 256, 8
KM_BLOB_POINTS, KM_LINES, KM_MICROBATCH = 200_000, 100_000, 10_000


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_query() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the card, each call between two
    CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- data -------------------------------------------------------------------


def synthetic_lines(rng: np.random.Generator) -> list[str]:
    """``user,item,1,ts`` lines: users pick items by power-law popularity
    and keep them almost only when the planted rank-5 score is above the
    user's 75th percentile (the reference's quality-test generator, made
    vectorised: for standard-normal item factors a user's scores are
    N(0, |u|²), whose 75th percentile is 0.6745·|u|)."""
    u_f = rng.standard_normal((N_USERS, RANK))
    i_f = rng.standard_normal((N_ITEMS, RANK))
    pop = rng.permutation(np.arange(1, N_ITEMS + 1, dtype=np.float64) ** -0.8)
    pop /= pop.sum()
    thresholds = 0.6745 * np.linalg.norm(u_f, axis=1)
    keys = np.zeros(0, dtype=np.int64)
    while True:
        m = 4 * NNZ
        u = rng.integers(0, N_USERS, m)
        i = rng.choice(N_ITEMS, p=pop, size=m)
        score = np.einsum("nr,nr->n", u_f[u], i_f[i])
        keep = (score >= thresholds[u]) | (rng.random(m) >= 0.95)
        keys = np.concatenate([keys, u[keep] * N_ITEMS + i[keep]])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]  # first occurrence of each pair, in order
        if len(keys) >= NNZ:
            break
    keys = keys[:NNZ]
    return [f"u{k // N_ITEMS},i{k % N_ITEMS},1,{t}"
            for t, k in enumerate(keys.tolist())]


def holdout_batch(lines, users, items) -> als_data.RatingBatch:
    rows, cols = [], []
    for ln in lines:
        u, i, _, _ = ln.split(",")
        r, c = users.id_to_index.get(u), items.id_to_index.get(i)
        if r is not None and c is not None:
            rows.append(r)
            cols.append(c)
    rows = np.asarray(rows, dtype=np.int32)
    order = np.argsort(rows, kind="stable")
    return als_data.RatingBatch(
        rows[order], np.asarray(cols, dtype=np.int32)[order],
        np.ones(len(rows), dtype=np.float32), users, items,
    )


# -- kernels ----------------------------------------------------------------


def gg_entry(side, y, dtype, label):
    """The gather-Gramian kernel on block 0 of ``side`` against its plain
    version."""
    srow, scols, svals, slens = (side.srows[0], side.scols[0], side.svals[0],
                                 side.slens[0])
    t = scols.shape[-1]
    w, coef = tr._entry_weights(svals, slens, ALPHA, True, t)
    ys = y.to(dtype)
    args = (ys, srow, scols, w, coef, slens)
    a, b = K.gather_gramian_accumulate(*args, block=side.block)
    pa, pb = K.gather_gramian_accumulate_plain(*args, block=side.block)
    torch.cuda.synchronize()
    abs_err = max(float((a - pa).abs().max()), float((b - pb).abs().max()))
    rel_err = max(float((a - pa).abs().max() / pa.abs().max()),
                  float((b - pb).abs().max() / pb.abs().max()))
    # the same rounded inputs on both sides, so only the summation order
    # differs: float32 sums over up to ~10^4 entries (a popular item's row)
    tol = 1e-4
    check(torch.isfinite(a).all() and torch.isfinite(b).all(),
          f"gather_gramian {label}: non-finite output")
    check(rel_err < tol, f"gather_gramian {label}: rel err {rel_err} >= {tol}")
    ms = time_ms(lambda: K.gather_gramian_accumulate(*args, block=side.block))
    plain_ms = time_ms(
        lambda: K.gather_gramian_accumulate_plain(*args, block=side.block),
        reps=10)
    valid = torch.arange(t, device=slens.device)[None, :] < slens[:, None]
    n_valid = int(valid.sum())
    rows_read = int(torch.unique(scols[valid]).numel())
    k = y.shape[1]
    s = scols.shape[0]
    nbytes = (rows_read * k * ys.element_size()  # gathered factor rows
              + s * t * (4 + 4 + 4) + s * (4 + 4)  # scols, w, coef; srow, slens
              + (side.block + 1) * k * (k + 1) * 4)  # A and b written
    flops = n_valid * (2.0 * k * k + 2.0 * k)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return {
        "name": f"gather_gramian_accumulate[{label}]",
        "route": "cuda", "source": GG_SOURCE, "replaces": GG_REPLACES,
        "wrapper": "gather_gramian_accumulate",
        "shape": {"block": side.block, "slots": s, "T": t, "k": k,
                  "valid_entries": n_valid, "dtype": str(dtype)},
        "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def spd_entry(side, y):
    """The SPD kernel on block 0's regularised normal equations."""
    yty = y.T @ y
    big_a, big_b, _ = tr._normal_equations(
        y, side.srows[0], side.scols[0], side.svals[0], side.slens[0],
        block=side.block, features=FEATURES, lam=LAM, alpha=ALPHA,
        implicit=True, slot_chunk=side.slot_chunk, yty=yty,
        fused_gramian=True,
    )
    big_a, big_b = big_a.contiguous(), big_b.contiguous()
    x = K.spd_solve_batched(big_a, big_b)
    px = K.spd_solve_batched_plain(big_a, big_b)
    torch.cuda.synchronize()
    abs_err = float((x - px).abs().max())
    rel_err = abs_err / float(px.abs().max())
    tol = 1e-4
    check(torch.isfinite(x).all(), "spd_solve: non-finite output")
    check(rel_err < tol, f"spd_solve: rel err {rel_err} >= {tol}")
    ms = time_ms(lambda: K.spd_solve_batched(big_a, big_b))
    plain_ms = time_ms(lambda: K.spd_solve_batched_plain(big_a, big_b), reps=5,
                       warmup=1)
    rhs = big_b[..., None]
    library_ms = time_ms(lambda: torch.linalg.solve(big_a, rhs))
    cholesky_ms = time_ms(lambda: K.spd_solve_cholesky(big_a, big_b))
    n, k = big_b.shape
    nbytes = n * (k * k + 2 * k) * 4
    flops = n * (k ** 3 / 3.0 + 2.0 * k * k)  # Cholesky factor + 2 solves
    bound_ms, bound_by = bound(nbytes, flops, torch.float32)
    return {
        "name": "spd_solve_batched[user,float32]",
        "route": "cuda", "source": SPD_SOURCE, "replaces": SPD_REPLACES,
        "wrapper": "spd_solve_batched",
        "shape": {"batch": n, "k": k},
        "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "library": "torch.linalg.solve", "cholesky_ms": cholesky_ms,
    }


# -- profile ----------------------------------------------------------------


def _interval_union_us(intervals) -> float:
    busy, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_iteration(user_side, item_side, y):
    """One more iteration (both halves) from the trained Y under
    ``torch.profiler``."""
    yp = torch.zeros((item_side.padded_rows, FEATURES), device=y.device)
    yp[: y.shape[0]] = y

    def half(side, opp):
        return tr.solve_side_blocked(
            opp, side.srows, side.scols, side.svals, side.slens, LAM, ALPHA,
            block=side.block, features=FEATURES, implicit=True,
            slot_chunk=side.slot_chunk,
        )

    return device_profile(lambda: half(item_side, half(user_side, yp)))


def device_profile(fn) -> dict:
    """``fn`` once to warm up, then once under ``torch.profiler``: device
    time by kernel, and the share of the call's host wall time in which no
    kernel ran. A one-element fill runs first inside the profiler (the
    tracer has been seen to drop the first kernel it would record) and is
    left out: only device events that start inside the measured window
    count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        with record_function("chip_smoke.window"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    window = [e.time_range.start for e in events
              if e.name == "chip_smoke.window"]
    opened = min(window) if window else -float("inf")
    by_name: dict = {}
    spans = []
    for e in events:
        if (e.device_type != DeviceType.CUDA or e.time_range.start < opened
                or e.name == "chip_smoke.window"):  # the annotation's own span
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("(")[0][:70]
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    if not spans:
        return {"device_time": "not measured", "wall_ms": wall_us / 1e3}
    busy_us = _interval_union_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "kernels_ms": {n: us / 1e3 for n, us in top},
    }


# -- serve ------------------------------------------------------------------


def overlap_with_exact(results, qs: np.ndarray, y: np.ndarray, ids,
                       excluded_rows=None, how_many: int = 10) -> float:
    """Mean share of each query's top-N that an exact float64 scan on the
    host also ranks in its top-N."""
    y64 = y.astype(np.float64)
    hits = 0
    for b, res in enumerate(results):
        scores = y64 @ qs[b].astype(np.float64)
        if excluded_rows is not None:
            scores[excluded_rows[b]] = -np.inf
        top = np.argpartition(-scores, how_many)[:how_many]
        hits += len({ids[j] for j in top} & {i for i, _ in res})
    return hits / (how_many * len(results))


def serve_trained(batch, x, y, rng):
    users, items = batch.users, batch.items
    model = state.serving_model(x, y, users.index_to_id, items.index_to_id)
    starts = np.searchsorted(batch.rows, np.arange(len(users) + 1))
    chosen = rng.choice(len(users), size=256, replace=False)
    for u in chosen:
        cols = batch.cols[starts[u]:starts[u + 1]]
        model.add_known_items(users.index_to_id[u],
                              [items.index_to_id[c] for c in cols])
    excluded = [model.get_known_items(users.index_to_id[u]) for u in chosen]
    qs = x[torch.as_tensor(chosen, device=x.device)].cpu().numpy()
    t0 = time.perf_counter()
    res = model.top_n_batch(qs, 10, excluded=excluded)
    serve_s = time.perf_counter() - t0
    check(all(len(r) == 10 for r in res), "serve: short top-10 list")
    for r, ex in zip(res, excluded):
        check(not ({i for i, _ in r} & ex), "serve: a known item came back")
    excl_rows = [batch.cols[starts[u]:starts[u + 1]] for u in chosen]
    ov = overlap_with_exact(res, qs, y.cpu().numpy(), items.index_to_id,
                            excl_rows)
    check(ov >= 0.99, f"serve: overlap with the exact scan {ov} < 0.99")
    return {"queries": len(chosen), "seconds": serve_s, "overlap": ov}


def serve_flagship(rng):
    """top_n_batch at 1M items × 50 features, seeded factors."""
    y = rng.standard_normal((FLAGSHIP_ITEMS, FEATURES), dtype=np.float32)
    ids = [f"i{j}" for j in range(FLAGSHIP_ITEMS)]
    model = ALSServingModel(FEATURES, True)
    t0 = time.perf_counter()
    model.bulk_load_items(ids, y)
    model.y_snapshot()
    load_s = time.perf_counter() - t0
    out = {"items": FLAGSHIP_ITEMS, "features": FEATURES, "load_s": load_s}
    for batch_size, reps in ((1, 50), (16, 30), (256, 15)):
        qs = rng.standard_normal((batch_size, FEATURES), dtype=np.float32)
        res = model.top_n_batch(qs, 10)  # warm-up, and the result checked
        ov = overlap_with_exact(res, qs, y, ids)
        check(ov >= 0.99, f"flagship b{batch_size}: overlap {ov} < 0.99")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            model.top_n_batch(qs, 10)
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        out[f"b{batch_size}"] = {"median_s": med, "qps": batch_size / med,
                                 "p90_s": float(np.percentile(times, 90)),
                                 "overlap": ov}
    return out


# -- k-means --------------------------------------------------------------------


def sweep_check(points, weights, centers, near_ties: bool, label: str) -> dict:
    """The Lloyd-sweep kernel against its plain version on the same card
    tensors. Tolerances, with their reasons:

    * cost: 1e-5 relative — float32 sums of the same d² in another order
      (a near tie changes a point's d² only by a rounding);
    * counts: when the centres are well separated, the same nearest centre
      for every point — unit-weight counts equal, weighted counts to 1e-6
      relative (float32 sums in another order); with near ties
      (standard-normal points: a few lie within float32 rounding of two
      centres, and the two versions round the cross term differently) an
      L1 difference of at most 1e-3·N; either way they sum to Σw;
    * sums: 1e-4 of the largest |sum|, on the clusters whose counts agree
      — float32 sums of the same w·p terms in another order."""
    sums, counts, cost = K.kmeans_assign_accumulate(points, weights, centers)
    p_sums, p_counts, p_cost = K.kmeans_assign_accumulate_plain(
        points, weights, centers)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(sums).all()) and bool(torch.isfinite(cost)),
          f"kmeans {label}: non-finite output")
    cost_rel = abs(float(cost) - float(p_cost)) / abs(float(p_cost))
    check(cost_rel <= 1e-5, f"kmeans {label}: cost rel err {cost_rel} > 1e-5")
    total = float(weights.double().sum())
    check(abs(float(counts.double().sum()) - total) <= 1e-6 * total,
          f"kmeans {label}: counts sum to {float(counts.sum())}, not {total}")
    count_l1 = float((counts.double() - p_counts.double()).abs().sum())
    same = counts == p_counts
    if near_ties:
        check(count_l1 <= 1e-3 * points.shape[0],
              f"kmeans {label}: count L1 difference {count_l1}")
    else:
        same[:] = True
        check(bool(torch.allclose(counts, p_counts, rtol=1e-6, atol=0.0)),
              f"kmeans {label}: weighted counts differ ({count_l1})")
        ones = torch.ones_like(weights)
        check(torch.equal(
            K.kmeans_assign_accumulate(points, ones, centers)[1],
            K.kmeans_assign_accumulate_plain(points, ones, centers)[1]),
            f"kmeans {label}: the nearest centres differ")
    diff = (sums.double() - p_sums.double())[same].abs()
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = abs_err / float(p_sums.abs().max())
    check(rel_err <= 1e-4, f"kmeans {label}: sums rel err {rel_err} > 1e-4")
    return {"label": label, "n": points.shape[0], "d": points.shape[1],
            "k": centers.shape[0], "cost_rel_err": cost_rel,
            "count_l1": count_l1, "clusters_compared": int(same.sum()),
            "max_abs_err": abs_err, "max_rel_err": rel_err}


def blob_means(rng: np.random.Generator) -> np.ndarray:
    return rng.uniform(-10.0, 10.0, (KM_K, KM_D)).astype(np.float32)


def blob_points(rng: np.random.Generator, means: np.ndarray, n: int):
    labels = rng.integers(0, len(means), n)
    return (means[labels]
            + rng.standard_normal((n, means.shape[1]), dtype=np.float32))


def kmeans_kernel_phase(dev, rng):
    """The sweep kernel in its three cases; the first timed. Returns the
    phase's record, the kernels-line entry, and the 1M × 64 points."""
    pts = torch.from_numpy(
        rng.standard_normal((KM_N, KM_D), dtype=np.float32)).to(dev)
    ones = torch.ones(KM_N, device=dev)
    centers = torch.from_numpy(
        rng.standard_normal((KM_K, KM_D), dtype=np.float32)).to(dev)
    cases = [sweep_check(pts, ones, centers, True, "1M x 64, K=256, normal")]
    args = (pts, ones, centers)
    kernel_ms = time_ms(lambda: K.kmeans_assign_accumulate(*args))
    plain_ms = time_ms(lambda: K.kmeans_assign_accumulate_plain(*args),
                       reps=5, warmup=1)
    cross_ms = time_ms(lambda: pts @ centers.T)
    nbytes = (KM_N * KM_D + KM_N + KM_K * KM_D  # points, weights, centres
              + KM_K * KM_D + KM_K + 1) * 4  # sums, counts, cost written
    flops = 2.0 * KM_N * KM_K * KM_D + 2.0 * KM_N * KM_D
    bound_ms, bound_by = bound(nbytes, flops, torch.float32)

    means = blob_means(rng)
    blobs = torch.from_numpy(blob_points(rng, means, KM_BLOB_POINTS)).to(dev)
    cases.append(sweep_check(blobs, torch.ones(KM_BLOB_POINTS, device=dev),
                             torch.from_numpy(means).to(dev), False,
                             "200k planted blobs, K=256"))
    wide_means = rng.uniform(-10.0, 10.0, (1024, 128)).astype(np.float32)
    wide = torch.from_numpy(blob_points(rng, wide_means, 50_000)).to(dev)
    wide_args = (wide, torch.ones(50_000, device=dev),
                 torch.from_numpy(wide_means).to(dev))
    cases.append(sweep_check(*wide_args, False, "50k blobs, K=1024, D=128"))
    wide_ms = time_ms(lambda: K.kmeans_assign_accumulate(*wide_args), reps=5)
    sweep_profile = device_profile(lambda: K.kmeans_assign_accumulate(*args))
    first = cases[0]
    entry = {
        "name": "kmeans_assign_accumulate[1M x 64, K=256]",
        "route": "cuda", "source": KM_SOURCE, "replaces": KM_REPLACES,
        "wrapper": "kmeans_assign_accumulate",
        "shape": {"n": KM_N, "d": KM_D, "k": KM_K, "dtype": "float32"},
        "max_abs_err": first["max_abs_err"], "max_rel_err": first["max_rel_err"],
        "tol": 1e-4, "cost_rel_err": first["cost_rel_err"], "cost_tol": 1e-5,
        "count_l1": first["count_l1"],
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "cross_term_matmul_ms": cross_ms,
    }
    record = {"cases": cases, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "cross_term_matmul_ms": cross_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "wide_kernel_ms": wide_ms,
              "sweep_profile": sweep_profile}
    return record, entry, pts


def csv_lines(points: np.ndarray) -> list:
    return [",".join(f"{v:.6f}" for v in row) for row in points.tolist()]


def kmeans_update_phase(dev, rng) -> dict:
    """The k-means main path through its entry points (see the module
    docstring); returns the phase's record with the launch counts."""
    means = blob_means(rng)
    t0 = time.perf_counter()
    lines = csv_lines(blob_points(rng, means, KM_LINES))
    micro = csv_lines(blob_points(rng, means, KM_MICROBATCH))
    timing = {"make_lines_s": time.perf_counter() - t0}
    conf = oryx_config.overlay_on(
        {"oryx.input-schema.num-features": KM_D,
         "oryx.input-schema.categorical-features": [],
         "oryx.kmeans.hyperparams.k": KM_K},
        oryx_config.get_default())
    runs = conf.get_int("oryx.kmeans.runs")
    iterations = conf.get_int("oryx.kmeans.iterations")
    train = [KeyMessage(None, ln) for ln in lines]
    update = KMeansUpdate(conf)
    k = int(update.get_hyper_parameter_values()[0].get_trial_values(1)[0])
    strategies = ("SILHOUETTE", "DAVIES_BOULDIN", "DUNN", "SSE")
    scorers = {s: KMeansUpdate(conf.with_values(
        {"oryx.kmeans.evaluation-strategy": s})) for s in strategies}

    K.reset_launches()
    t0 = time.perf_counter()
    pmml = update.build_model(None, train, [k], None)
    torch.cuda.synchronize()
    timing["build_model_s"] = time.perf_counter() - t0
    scores = {}
    for strategy in strategies:
        t0 = time.perf_counter()
        scores[strategy] = scorers[strategy].evaluate(None, pmml, None, [], train)
        timing[f"evaluate_{strategy.lower()}_s"] = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)

    expected = runs * (iterations + 1)
    check(launches["kmeans_assign_accumulate"] == expected,
          f"kmeans_update: {launches['kmeans_assign_accumulate']} sweep "
          f"launches, expected {expected} ({runs} runs x {iterations + 1})")
    clusters = pmml_codec.read(pmml)
    check(len(clusters) == KM_K, f"kmeans_update: {len(clusters)} clusters")
    check(sum(c.count for c in clusters) == KM_LINES,
          "kmeans_update: cluster sizes do not sum to the line count")
    check(-1.0 <= scores["SILHOUETTE"] <= 1.0,
          f"kmeans_update: silhouette {scores['SILHOUETTE']}")
    t0 = time.perf_counter()
    points = update._to_points(train)
    timing["parse_s"] = time.perf_counter() - t0
    published = np.stack([c.center for c in clusters])
    _, _, cost = K.kmeans_assign_accumulate(
        torch.from_numpy(points.astype(np.float32)).to(dev),
        torch.ones(len(points), device=dev),
        torch.from_numpy(published.astype(np.float32)).to(dev))
    sse_rel = abs(-scores["SSE"] - float(cost)) / float(cost)
    check(sse_rel <= 1e-4, f"kmeans_update: -SSE {scores['SSE']} vs the "
          f"sweep's cost {float(cost)}: rel {sse_rel} > 1e-4")

    # serving: MODEL, 1,000 nearest-cluster queries against a host assign
    text = pmmlutils.to_string(pmml)
    serving = KMeansServingModelManager(conf)
    t0 = time.perf_counter()
    serving.consume([KeyMessage("MODEL", text)])
    queries = points[:1000]
    answers = [serving.get_model().nearest_cluster(q) for q in queries]
    timing["serve_1000_s"] = time.perf_counter() - t0
    d2 = ((queries[:, None, :] - published[None, :, :]) ** 2).sum(axis=2)
    ids = [c.id for c in clusters]
    want = [ids[j] for j in d2.argmin(axis=1)]
    check([a[0] for a in answers] == want,
          "kmeans serve: nearest clusters differ from the host assign")
    dist = np.sqrt(d2.min(axis=1))
    check(np.allclose([a[1] for a in answers], dist, rtol=1e-9, atol=1e-9),
          "kmeans serve: distances differ from the host assign")

    # speed: fold a microbatch, apply its UP lines to the serving model
    speed = KMeansSpeedModelManager(conf)
    speed.consume([KeyMessage("MODEL", text)])
    t0 = time.perf_counter()
    ups = speed.build_updates([KeyMessage(None, ln) for ln in micro])
    timing["speed_build_updates_s"] = time.perf_counter() - t0
    serving.consume([KeyMessage("UP", u) for u in ups])
    by_id = {c.id: c for c in speed.model.clusters}
    served = serving.get_model().clusters
    check(len(ups) > 0 and all(
        c.count == by_id[c.id].count and np.array_equal(c.center, by_id[c.id].center)
        for c in served), "kmeans speed: serving does not hold the speed model")
    check(sum(c.count for c in served) == KM_LINES + KM_MICROBATCH,
          "kmeans speed: counts do not add up")
    return {"lines": KM_LINES, "features": KM_D, "k": k, "runs": runs,
            "iterations": iterations, "launches": launches,
            "scores": scores, "sse_vs_sweep_cost_rel": sse_rel,
            "updates": len(ups), **timing}


def kmeans_train_phase(points) -> dict:
    """``kmeans_train`` at bench_batch.py's accelerator shape, twice."""
    out = {"n": KM_N, "d": KM_D, "k": KM_K, "iterations": KM_ITERATIONS,
           "runs": 1}
    for call in ("first", "timed"):
        K.reset_launches()
        timings: dict = {}
        t0 = time.perf_counter()
        centers, counts = kmtrain.kmeans_train(
            points, KM_K, iterations=KM_ITERATIONS, runs=1,
            generator=torch.Generator().manual_seed(SEED + 7), timings=timings)
        seconds = time.perf_counter() - t0
        launches = K.LAUNCHES["kmeans_assign_accumulate"]
        check(launches == KM_ITERATIONS + 1,
              f"kmeans_train: {launches} sweep launches")
        check(np.isfinite(centers).all() and counts.sum() == KM_N,
              "kmeans_train: bad centres or counts")
        out[call] = {"seconds": seconds, "launches": launches, **timings}
    timed = out["timed"]
    out["point_iters_per_s"] = KM_N * KM_ITERATIONS / timed["seconds"]
    out["sweep_point_iters_per_s"] = KM_N * KM_ITERATIONS / timed["sweeps_s"]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = resolve(None)
    smi = gpu_query()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    built = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, built=built)

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    lines = synthetic_lines(rng)
    test_mask = rng.random(len(lines)) < TEST_FRACTION
    train_lines = [ln for ln, m in zip(lines, test_mask) if not m]
    test_lines = [ln for ln, m in zip(lines, test_mask) if m]
    batch = als_data.prepare(train_lines, implicit=True)
    test = holdout_batch(test_lines, batch.users, batch.items)
    emit("data", seconds=time.perf_counter() - t0, users=len(batch.users),
         items=len(batch.items), train_nnz=batch.nnz, test_nnz=test.nnz)

    # kernels against their plain versions, on real packed blocks
    user_side, item_side = tr.prepare_blocked(batch, FEATURES, device=dev)
    g = torch.Generator().manual_seed(SEED)
    y_items = tr.init_item_factors(item_side.padded_rows, len(batch.items),
                                   FEATURES, g, dev)
    y_users = tr.init_item_factors(user_side.padded_rows, len(batch.users),
                                   FEATURES, g, dev)
    entries = []
    for side, opp, label in ((user_side, y_items, "user"),
                             (item_side, y_users, "item")):
        for dtype in (torch.float32, torch.bfloat16):
            dname = "float32" if dtype == torch.float32 else "bfloat16"
            entries.append(gg_entry(side, opp, dtype,
                                    f"{label},T={side.slot_width},{dname}"))
    entries.append(spd_entry(user_side, y_items))
    emit("kernels_checked", n=len(entries))

    # the main path: train, then serve the trained model
    K.reset_launches()
    timings: dict = {}
    t0 = time.perf_counter()
    x, y = tr.als_train(batch, FEATURES, LAM, ALPHA, True, ITERATIONS,
                        generator=torch.Generator().manual_seed(SEED + 1),
                        timings=timings)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    blocks = user_side.n_blocks + item_side.n_blocks
    expected = ITERATIONS * blocks
    check(bool(torch.isfinite(x).all()) and bool(torch.isfinite(y).all()),
          "train: non-finite factors")
    check(x.shape == (len(batch.users), FEATURES)
          and y.shape == (len(batch.items), FEATURES), "train: factor shapes")
    t0 = time.perf_counter()
    auc = evaluate.area_under_curve(x, y, batch, test,
                                    rng=np.random.default_rng(SEED + 2))
    auc_s = time.perf_counter() - t0
    check(auc > 0.75, f"train: hold-out AUC {auc} <= 0.75")
    steady = timings["iter_s"][1:] or timings["iter_s"]
    emit("train", seconds=train_s, pack_s=timings["pack_s"],
         pack_user_s=timings["pack_user_s"],
         pack_item_s=timings["pack_item_s"], iter_s=timings["iter_s"],
         ratings_per_s=batch.nnz * ITERATIONS / train_s,
         steady_ratings_per_s=batch.nnz / float(np.mean(steady)),
         blocks={"user": user_side.n_blocks, "item": item_side.n_blocks},
         auc=auc, auc_s=auc_s)
    serve = serve_trained(batch, x, y, rng)
    launches = dict(K.LAUNCHES)
    emit("serve", **serve, launches=launches)
    for wrapper in ALS_WRAPPERS:
        n = launches[wrapper]
        check(n == expected, f"{wrapper}: {n} launches on the main path, "
              f"expected {expected} ({blocks} blocks x {ITERATIONS} iterations)")

    emit("profile", **profile_iteration(user_side, item_side, y))
    emit("serve_flagship", **serve_flagship(rng))

    record, km_entry, km_points = kmeans_kernel_phase(dev, rng)
    emit("kmeans_kernel", **record)
    km_update = kmeans_update_phase(dev, rng)
    emit("kmeans_update", **km_update)
    emit("kmeans_train", **kmeans_train_phase(km_points))

    for e in entries:  # ALS launches from the ALS path, k-means from its own
        e["launches"] = launches[e.pop("wrapper")]
    km_entry["launches"] = km_update["launches"][km_entry.pop("wrapper")]
    entries.append(km_entry)
    for e in entries:
        check(e["launches"] > 0, f"{e['name']}: not launched on its path")
    print(json.dumps({"kernels": entries, "gpu": smi}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
