#!/usr/bin/env python3
"""Drive the PyTorch port's ALS loop on one CUDA card and check every step.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``. Imports nothing of JAX or of the reference package
``oryx_tpu``. Phases, each printing one JSON object per line:

  env      torch/CUDA versions, the card's name and power limit (the raw
           ``nvidia-smi`` line is printed on its own line too);
  build    both kernels built from ``oryx_tpu_torch/ops/csrc`` into
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
  flagship 1,000,000 items × 50 features (seeded), ``top_n_batch`` timed
           at batch 1, 16 and 256, top-10, checked against an exact scan.

Then the ``{"kernels": [...]}`` line; ``profile``, one more training
iteration under ``torch.profiler`` (device time by kernel, idle share);
the flagship serving timings; and last
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

from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.models.als import data as als_data
from oryx_tpu_torch.models.als import evaluate
from oryx_tpu_torch.models.als import train as tr
from oryx_tpu_torch.models.als.serving import ALSServingModel
from oryx_tpu_torch.ops import _build
from oryx_tpu_torch.ops import kernels as K
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
    ``torch.profiler``: device time by kernel, and the share of the
    iteration's host wall time in which no kernel ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    yp = torch.zeros((item_side.padded_rows, FEATURES), device=y.device)
    yp[: y.shape[0]] = y

    def half(side, opp):
        return tr.solve_side_blocked(
            opp, side.srows, side.scols, side.svals, side.slens, LAM, ALPHA,
            block=side.block, features=FEATURES, implicit=True,
            slot_chunk=side.slot_chunk,
        )

    def iteration():
        return half(item_side, half(user_side, yp))

    iteration()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iteration()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
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
    for wrapper, n in launches.items():
        check(n == expected, f"{wrapper}: {n} launches on the main path, "
              f"expected {expected} ({blocks} blocks x {ITERATIONS} iterations)")
    for e in entries:
        e["launches"] = launches[e.pop("wrapper")]
    print(json.dumps({"kernels": entries, "gpu": smi}), flush=True)

    emit("profile", **profile_iteration(user_side, item_side, y))
    emit("serve_flagship", **serve_flagship(rng))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
