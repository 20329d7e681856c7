#!/usr/bin/env python3
"""Drive the PyTorch port's ALS loop (batch, speed, serving) and k-means
path on one CUDA card and check every step.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``. Imports nothing of JAX or of the reference package
``oryx_tpu``. Phases, each printing one JSON object per line:

  env      torch/CUDA versions, the card's name and power limit (the raw
           ``nvidia-smi`` line is printed on its own line too);
  build    every kernel built from ``oryx_tpu_torch/ops/csrc`` into
           ``build/`` (one ``nvcc`` per source, started together); the
           registers and spill bytes ``ptxas -v`` logged for each SPD kernel
           and each of the sweep's kernels (a spill fails);
  data     a seeded synthetic implicit dataset at the batch benchmark's
           training shape — 100,000 users × 10,000 items, ~1,000,000
           interactions with planted rank-5 preferences and power-law item
           popularity (exponent −0.8) — as CSV lines through
           ``data.prepare``, with a 10% hold-out;
  kernels  each kernel against its plain PyTorch version on the card, on
           the first packed block of each side of that data (k = 50;
           gather-Gramian in float32 and bfloat16), timed with CUDA events
           beside the plain version, a one-call library equivalent where
           one exists, and the card's bound for the same work; the
           gather-Gramian also with its work-unit schedule reported (units,
           split rows, largest unit, workspace bytes), called twice for
           the same bits, timed by bare launches and through its wrapper,
           and beside a ``torch.bmm`` of the pre-gathered slab (per-slot
           products only); the SPD solve also on 7,692 seeded systems at
           k = 10 (the reference's default; warp kernel) and k = 128 (CTA
           kernel), and each k <= 64 beside the CTA kernel on the same
           systems (both SPD kernels timed by bare launches of their C
           entries, the wrapper apart;
           the reference's fused elimination step's float64 error is
           reported beside the plain version's);
  spd_crossover
           the warp and CTA SPD kernels on the same 7,692 seeded systems at
           k = 1 .. 65, around the warp kernel's templates and crossover;
  train    the main path: ``als_train`` (k = 50, λ = 1, α = 1, implicit,
           3 iterations, float32) with the launch counters set to 0 just
           before; both kernels must have launched once per row block per
           iteration, at each side's block shape, the SPD solve in its warp
           kernel, and the gather-Gramian's reduce once per iteration for
           each block whose schedule has a split row; factors finite;
           hold-out AUC > 0.75;
  serve    the trained model loaded into ``ALSServingModel``: 256 users'
           ``top_n_batch(how_many=10)`` excluding their training items,
           checked against an exact float64 scan (overlap >= 0.99); the
           counters are read after it;
  serve_flagship
           1,000,000 items × 50 features (seeded), ``top_n_batch`` timed
           at batch 1, 16 and 256, top-10, checked against an exact scan;
  kmeans_kernel
           the Lloyd-sweep kernel against its plain version on 1,000,000 ×
           64 standard-normal points with K = 256 (near ties allowed), on
           200,000 points of 256 planted blobs (exact counts) and on their
           first 100,000 (the update path's shape), both timed by bare
           launches of the C entry (20 per event pair; the same bits as the
           wrapper's) and through the wrapper, beside the plain version, the
           cross term's ``torch.matmul`` (the entry's ``library_ms``) and
           the card's bound; and at K = 1,024, D = 128 (chunked centres,
           partial sums in device memory);
  profile  one ``torch.profiler`` session, started straight after the
           sweep's timing, with three windows back to back: one more
           training iteration, with the packed blocks' schedules as the
           trainer passes them, and one sweep at each of the two timed
           shapes (device time by kernel, idle share); each sweep's window
           must list each of its three launches once, and is printed in
           the ``kmeans_kernel`` line (``profile``,
           ``update_shape.profile``);
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
           serving model; and one ``KMeansUpdate.run_update`` on the same
           lines (one candidate, 93 sweeps) published to a recording
           producer, whose ``MODEL`` a fresh ``KMeansServingModelManager``
           must hold as the promoted PMML's 256 clusters; the sweep's first
           launch at each shape that run reached is kept and held against
           the plain version after it;
  kmeans_train
           ``kmeans_train`` at 1,000,000 × 64, k = 256, 8 iterations, one
           run, twice (the second timed): point-iters/s, seeding and sweep
           seconds apart;
  als_generation
           one ALS batch generation on the same 1,000,000 lines:
           ``ALSUpdate.run_update`` (time-ordered 10% hold-out, one
           candidate, λ = 1, trained on the card at k = 50, 3 iterations,
           α = 1, written as part files, evaluated by AUC; cut from two λ
           candidates for time), promoted and published to a recording
           producer; the candidate must have built and been evaluated on
           the card, its AUC > 0.75, both ALS kernels launched
           iterations × (user + item blocks) times
           (counters set to 0 just before ``run_update``), one ``MODEL``
           first, a ``Y`` ``UP`` per item before any ``X`` ``UP``, and one
           ``X`` ``UP`` with its known items per user of the training split;
           then a fresh ``ALSServingModelManager`` on the card consumes the
           stream (fraction loaded 1.0) and its top-10 for 256 users,
           known items excluded, must equal (ids, and scores bit for bit) a
           model loaded straight from the promoted part files. Each ALS
           kernel's first launch at each shape the generation reached is
           kept (inputs and outputs) and held against its plain version
           after ``run_update``. Host seconds
           by stage: split, each candidate's prepare / pack / iterations /
           part-file write / evaluation, promote, publish, consume, the
           first top-N. It runs after the kernel phases: it is mostly host
           work;
  als_speed
           the ALS speed tier on that generation, last: a new
           ``ALSSpeedModelManager`` consumes the generation's stream
           (fraction loaded 1.0); the held-out 10% of the lines (100,000,
           the newest) goes in as two microbatches of 50,000. For each, the
           solver caches are brought current, ``build_updates`` folds it in
           (host seconds by stage: prepare, solver get, vector gather,
           fold-in, formatting; ``UP``s a second), and both the speed
           manager and the generation's serving manager on the card hear
           its ``UP``s. Checks: one X ``UP`` carrying its item and one Y
           ``UP`` per changed pair; 256 sampled ``UP``s of each kind against
           ``v + solve(VᵀV, w·Δq)`` in float64 from the pre-batch X and Y
           (relative 1e-4); the serving snapshot taken incrementally (no
           whole upload after the generation's first) and ``torch.equal``
           to a whole upload; 256 users' top-10 (half of them touched, known
           items from the ``UP``s included) equal to a model loaded fresh
           from the stores, ids and scores bit for bit; ``get_vtv`` on the
           card's matrix against a float64 Gramian (relative 1e-5),
           ``build_temporary_user_vector`` for 256 contexts of 1-20 items
           against a float64 fold-in (relative 1e-4), ``top_n_cosine`` for
           16 item sets against an exact float64 scan (overlap >= 0.99).
           Printed: each microbatch's consume seconds (both managers),
           incremental and whole-upload snapshot milliseconds, YᵀY solver
           seconds and input-to-servable seconds (lines to a serving
           snapshot holding their updates). Then the 1,000,000 × 50f
           serving model: three rounds of 10,000 changed and 1,000 new rows,
           each snapshot timed incrementally beside a whole upload of the
           same store (``torch.equal``), and 16 queries' top-10 equal to a
           model loaded fresh. No kernel may launch in this phase.

Then the ``{"kernels": [...], "paths": {...}, "path_checks": {...}}`` line
(``paths``: the launches of each wrapper in the two generations' runs and
in the speed phase, where all three must be 0;
``path_checks``: for each generation, one record per kernel and shape it
launched at, that launch's output against the plain version on the same
inputs), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Each kernels-line entry's ``launches``
is its kernel's count at its shape in the run of the path that reaches it
(``K.SHAPE_LAUNCHES``): the ALS train and serve run, ``build_model``'s run
or ``kmeans_train``'s timed call; an entry at a shape no path runs (the
bfloat16 gather-Gramian, the synthetic SPD systems) shows 0, with
``on_main_path`` false; a gather-Gramian entry's ``reduce_launches`` is
counted the same way. Any failed check raises: the script
exits non-zero and prints no ``ok`` line. Without a CUDA card it exits 1
at once.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import config as oryx_config
from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.models.als import data as als_data
from oryx_tpu_torch.models.als import evaluate
from oryx_tpu_torch.models.als import pmml_codec as als_codec
from oryx_tpu_torch.models.als import train as tr
from oryx_tpu_torch.models.als.serving import ALSServingModel, ALSServingModelManager
from oryx_tpu_torch.models.als.speed import ALSSpeedModelManager
from oryx_tpu_torch.models.als.update import ALSUpdate
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
# synthetic SPD cases: the user block's system count at the reference's
# default k = 10 (the warp kernel) and at k = 128 (the CTA kernel)
SPD_SYNTHETIC_SYSTEMS, SPD_SYNTHETIC_K = 7_692, (10, 128)
# kernel timings: calls per CUDA-event pair (the SPD warp kernel at small k
# and the gather-Gramian on a user block are shorter than one wrapper
# call's host time)
INNER = 20

# k-means: bench_batch.py's accelerator shape (1M × 64, K = 256, 8
# iterations); the update path's data are planted Gaussian blobs (centres
# uniform in [−10, 10]^64, σ = 1), k = 256 with the reference's defaults
KM_N, KM_D, KM_K, KM_ITERATIONS = 1_000_000, 64, 256, 8
KM_BLOB_POINTS, KM_LINES, KM_MICROBATCH = 200_000, 100_000, 10_000

# one ALS batch generation at the train phase's shape: one candidate (λ =
# LAM), cut from a grid of two (λ 0.5 and 1) to keep the phase near 90 s;
# two took 109 s of run_update on the H100, most of it the part-file
# write and the evaluation's re-parse of each candidate
GENERATION_TIMESTAMP_MS = 1_760_000_000_000

# the speed tier: the generation's held-out 10% (100,000 lines, the
# newest) as two microbatches of 50,000 (the size the reference's fold-in
# notes are written for, oryx_tpu/models/als/speed.py:205-210); 256
# sampled checks of each kind; at the flagship width, rounds of 10,000
# changed and 1,000 new rows
SPEED_MICROBATCH, SPEED_SAMPLES = 50_000, 256
FLAGSHIP_CHANGED, FLAGSHIP_NEW = 10_000, 1_000


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


def time_ms(fn, reps: int = 15, warmup: int = 3, inner: int = 1) -> float:
    """Median milliseconds of one call of ``fn`` on the card: ``inner``
    calls back to back between two CUDA events, ``reps`` times. An ``inner``
    of more than 1 keeps the card busy while the host enqueues the next
    call, so a kernel shorter than the host's call overhead is timed for
    itself."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
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


def launch_key(kernel: str, shape: tuple) -> str:
    return f"{kernel} {tuple(shape)}"


def shape_launches() -> dict:
    """``K.SHAPE_LAUNCHES`` with its keys as strings, for JSON."""
    return {launch_key(*key): n for key, n in K.SHAPE_LAUNCHES.items()}


def gg_entry(side, y, dtype, label):
    """The gather-Gramian kernel on block 0 of ``side`` against its plain
    version: once building its own schedule, once given it (the same bits
    from both), timed by bare launches and through the wrapper as the
    trainer calls it (schedule given), beside the plain version and a
    ``torch.bmm`` of the pre-gathered slab."""
    srow, scols, svals, slens = (side.srows[0], side.scols[0], side.svals[0],
                                 side.slens[0])
    t = scols.shape[-1]
    w, coef = tr._entry_weights(svals, slens, ALPHA, True, t)
    ys = y.to(dtype)
    args = (ys, srow, scols, w, coef, slens)
    sched = K.gather_gramian_schedule(srow, slens, block=side.block,
                                      slot_width=t)
    a, b = K.gather_gramian_accumulate(*args, block=side.block)
    a2, b2 = K.gather_gramian_accumulate(*args, block=side.block,
                                         schedule=sched)
    pa, pb = K.gather_gramian_accumulate_plain(*args, block=side.block)
    torch.cuda.synchronize()
    check(torch.equal(a, a2) and torch.equal(b, b2),
          f"gather_gramian {label}: two calls differ")
    abs_err, rel_err = max_errs([(a, pa), (b, pb)])
    # the same rounded inputs on both sides, so only the summation order
    # differs: float32 sums over up to ~10^4 entries (a popular item's row)
    tol = 1e-4
    check(torch.isfinite(a).all() and torch.isfinite(b).all(),
          f"gather_gramian {label}: non-finite output")
    check(rel_err < tol, f"gather_gramian {label}: rel err {rel_err} >= {tol}")
    launch = gg_bare_launch(args, side.block, sched)
    ba, bb = launch()
    torch.cuda.synchronize()
    check(torch.equal(a, ba) and torch.equal(b, bb),
          f"gather_gramian {label}: the bare launch differs from the wrapper")
    ms = time_ms(launch, inner=INNER)
    # one wrapper call per event pair, the host's Python included: how
    # the kernel was timed before it took a schedule
    wrapper_ms = time_ms(lambda: K.gather_gramian_accumulate(
        *args, block=side.block, schedule=sched))
    plain_ms = time_ms(
        lambda: K.gather_gramian_accumulate_plain(*args, block=side.block),
        reps=10)
    # the yardstick: the per-slot products alone as one batched product,
    # gather and weighting done before, the per-row sums not done
    yg = ys[scols.long()]
    lhs = (yg * w.to(ys.dtype)[..., None]).transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.bmm(lhs, yg))
    del yg, lhs
    valid = torch.arange(t, device=slens.device)[None, :] < slens[:, None]
    n_valid = int(valid.sum())
    rows_read = int(torch.unique(scols[valid]).numel())
    k = y.shape[1]
    s = scols.shape[0]
    nbytes = (rows_read * k * ys.element_size()  # gathered factor rows
              + s * t * (4 + 4 + 4) + s * (4 + 4)  # scols, w, coef; srow, slens
              + (side.block + 1) * k * (k + 1) * 4)  # A and b written
    # A is symmetric: k(k+1)/2 multiply-adds per entry for A, k for b
    flops = n_valid * (k * (k + 1) + 2.0 * k)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    shape = (side.block + 1, s, t, k, str(ys.dtype))
    return {
        "name": f"gather_gramian_accumulate[{label}]",
        "route": "cuda", "source": GG_SOURCE, "replaces": GG_REPLACES,
        "launch_key": launch_key("gather_gramian_accumulate", shape),
        "reduce_launch_key": launch_key("gather_gramian_accumulate.reduce",
                                        shape),
        "shape": {"block": side.block, "slots": s, "T": t, "k": k,
                  "valid_entries": n_valid, "dtype": str(dtype)},
        "schedule": {"units": sched.units, "split_rows": sched.split_rows,
                     "split_units": sched.split_units,
                     "unit_entries": sched.unit_entries,
                     "max_entries_per_unit": sched.max_entries_per_unit,
                     "workspace_bytes": sched.workspace_bytes(k)},
        "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
        "bitwise_repeat": True,
        "ms": ms, "kernel_ms": ms, "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "library": "torch.bmm of the pre-gathered, weighted (S, k, T) x "
                   "(S, T, k) slab: the per-slot products only, gather and "
                   "per-row accumulation outside the timed call",
    }


def gg_bare_launch(args, block, sched):
    """A no-argument launch of ``oryx_gather_gramian`` (both passes) on the
    wrapper's arguments into preallocated outputs, with the pointers taken
    once: the kernel timed apart from the wrapper's host cost, as the SPD
    kernels are."""
    ys, _, scols, w, coef, slens = args
    t, k = scols.shape[1], ys.shape[1]
    a = torch.empty((block + 1, k, k), device=ys.device)
    b = torch.empty((block + 1, k), device=ys.device)
    ws = torch.empty((max(sched.split_units, 1), k * k + k), device=ys.device)
    fn = K._entry("gather_gramian", "oryx_gather_gramian")
    cargs = (ys.data_ptr(), int(ys.dtype == torch.bfloat16),
             sched.work.data_ptr(), sched.work.shape[0],
             sched.split.data_ptr(), sched.split_rows, scols.data_ptr(),
             w.data_ptr(), coef.data_ptr(), slens.data_ptr(), ws.data_ptr(),
             a.data_ptr(), b.data_ptr(), t, k,
             torch.cuda.current_stream().cuda_stream)

    def launch():
        err = fn(*cargs)
        check(err == 0, f"oryx_gather_gramian: CUDA error {err}")
        return a, b

    return launch


def spd_blocks(side, y):
    """Block 0's regularised normal equations (A, b) on the card."""
    yty = y.T @ y
    big_a, big_b, _ = tr._normal_equations(
        y, side.srows[0], side.scols[0], side.svals[0], side.slens[0],
        block=side.block, features=FEATURES, lam=LAM, alpha=ALPHA,
        implicit=True, slot_chunk=side.slot_chunk, yty=yty,
        fused_gramian=True, schedule=side.gg_schedules[0],
    )
    return big_a.contiguous(), big_b.contiguous()


def spd_synthetic(dev, n, k, seed):
    """n seeded SPD systems m·mᵀ + 2I (m standard normal × 0.3) on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    m = torch.randn((n, k, k), device=dev, generator=g) * 0.3
    a = m @ m.transpose(1, 2) + 2.0 * torch.eye(k, device=dev)
    return a.contiguous(), torch.randn((n, k), device=dev, generator=g)


def spd_fused_form(a, b):
    """The reference kernel's elimination step as it is written
    (``oryx_tpu/ops/pallas_kernels.py:111-112``): subtracting
    (fac − e_j) ⊗ piv_row from every row, which leaves row j as
    aug_j − (piv − 1)·aug_j/piv. Only its float64 error is reported, beside
    the plain version's; nothing is held to it."""
    k = b.shape[-1]
    aug = torch.cat([a, b[..., None]], dim=-1)
    rows = torch.arange(k, device=a.device)
    for j in range(k):
        piv_row = aug[:, j:j + 1, :] / aug[:, j:j + 1, j:j + 1]
        fac = aug[:, :, j:j + 1] - (rows == j).float()[None, :, None]
        aug = aug - fac * piv_row
    return aug[:, :, k]


def spd_kernel_label(mangled: str) -> str:
    """``warp<KP>`` for each SPD warp-kernel template, ``cta`` for the CTA
    kernel."""
    kp = re.search(r"spd_solve_warp_kernelILi(\d+)E", mangled)
    return f"warp<{kp.group(1)}>" if kp else "cta"


def sweep_kernel_label(mangled: str) -> str:
    """``assign_kernel<true>`` (16-byte loads) / ``<false>`` (scalar loads),
    ``partial_kernel<true>`` (slab in shared memory) / ``<false>``,
    ``reduce_kernel``."""
    m = re.search(r"(assign_kernel|partial_kernel|reduce_kernel)(?:ILb([01])E)?",
                  mangled)
    if m is None:
        return mangled
    flag = {"1": "<true>", "0": "<false>", None: ""}[m.group(2)]
    return m.group(1) + flag


def ptxas_usage(log: str, label) -> dict:
    """Registers and spill bytes per kernel from ``ptxas -v``'s log, keyed
    by ``label(mangled name)``."""
    usage, kernel = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel = label(entry.group(1))
            usage[kernel] = {}
        elif kernel and "bytes spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            usage[kernel]["spill_bytes"] = int(stores) + int(loads)
        elif kernel and "Used" in line and "registers" in line:
            usage[kernel]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return usage


def ptxas_checked(name: str, label, kernels: int) -> dict:
    """The ptxas usage of every kernel in library ``name``, from its build
    log; fails if any spills, or if fewer than ``kernels`` are listed."""
    usage = ptxas_usage(_build.build_log(name), label)
    check(len(usage) >= kernels and all(
        u.get("spill_bytes") == 0 and u.get("registers") for u in usage.values()),
          f"{name}: ptxas reports spills or no usage: {usage}")
    return usage


def spd_cta_entry():
    """The library's ``oryx_spd_solve_cta``, the CTA kernel at any k, bound
    with ``oryx_spd_solve``'s signature: only this script calls it, to time
    the CTA kernel beside the warp kernel on the same systems."""
    fn = _build.library("spd_solve").oryx_spd_solve_cta
    fn.argtypes, fn.restype = K._SIGNATURES["oryx_spd_solve"]
    return fn


def bare_launch(fn, a, b):
    """A no-argument launch of ``fn``, an ``oryx_spd_solve`` entry, on (a, b)
    into a preallocated x, with the pointers taken once. The warp and the
    CTA kernel are timed through it at the same small host cost per call;
    the wrapper's own checks cost more host time than the warp kernel takes
    at k <= 32."""
    x = torch.empty_like(b)
    args = (a.data_ptr(), b.data_ptr(), x.data_ptr(), b.shape[0], b.shape[1],
            torch.cuda.current_stream().cuda_stream)

    def launch():
        err = fn(*args)
        check(err == 0, f"oryx_spd_solve: CUDA error {err}")
        return x

    return launch


def spd_entry(big_a, big_b, label, cta_fn):
    """The SPD kernel on (A, b) against its plain version, timed beside the
    plain version, ``torch.linalg.solve``, a Cholesky solve and, for k <= 64,
    the CTA kernel on the same systems (both kernels by bare launches; the
    wrapper call is timed too). Both are also held against a float64 solve
    (reported, not checked), and so is the reference's fused step."""
    n, k = big_b.shape
    x = K.spd_solve_batched(big_a, big_b)
    px = K.spd_solve_batched_plain(big_a, big_b)
    fx = spd_fused_form(big_a, big_b)
    exact = torch.linalg.solve(big_a.double(), big_b.double())
    torch.cuda.synchronize()
    abs_err, rel_err = max_errs([(x, px)])
    f64_err = {name: float((v.double() - exact).abs().max() / exact.abs().max())
               for name, v in (("kernel", x), ("plain", px),
                               ("reference_fused_step", fx))}
    tol = 1e-4
    check(torch.isfinite(x).all(), f"spd_solve {label}: non-finite output")
    check(rel_err < tol, f"spd_solve {label}: rel err {rel_err} >= {tol}")
    ms = time_ms(bare_launch(K._spd_solve_entry(), big_a, big_b),
                 inner=INNER)
    wrapper_ms = time_ms(lambda: K.spd_solve_batched(big_a, big_b),
                         inner=INNER)
    plain_ms = time_ms(lambda: K.spd_solve_batched_plain(big_a, big_b), reps=5,
                       warmup=1)
    rhs = big_b[..., None]
    library_ms = time_ms(lambda: torch.linalg.solve(big_a, rhs),
                         inner=INNER)
    cholesky_ms = time_ms(lambda: K.spd_solve_cholesky(big_a, big_b),
                          inner=INNER)
    variant = K.spd_variant(k)
    cta_ms = (time_ms(bare_launch(cta_fn, big_a, big_b), inner=INNER)
              if variant == "warp" else ms)
    nbytes = n * (k * k + 2 * k) * 4
    flops = n * (k ** 3 / 3.0 + 2.0 * k * k)  # Cholesky factor + 2 solves
    bound_ms, bound_by = bound(nbytes, flops, torch.float32)
    return {
        "name": f"spd_solve_batched[{label}]",
        "route": "cuda", "source": SPD_SOURCE, "replaces": SPD_REPLACES,
        "launch_key": launch_key(f"spd_solve_batched.{variant}", (n, k)),
        "variant": variant,
        "shape": {"batch": n, "k": k},
        "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
        "rel_err_vs_float64": f64_err,
        "ms": ms, "kernel_ms": ms, "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "library": "torch.linalg.solve", "cholesky_ms": cholesky_ms,
        "cta_ms": cta_ms,
    }


def spd_crossover(dev, cta_fn) -> dict:
    """The warp and the CTA kernel on the same 7,692 seeded systems at each
    k around the warp kernel's crossover, both by bare launches."""
    out = {}
    for k in (1, 10, 16, 17, 32, 33, 50, 64, 65):
        a, b = spd_synthetic(dev, SPD_SYNTHETIC_SYSTEMS, k, SEED + 100 + k)
        launch = bare_launch(K._spd_solve_entry(), a, b)
        cta = bare_launch(cta_fn, a, b)
        x, cx = launch(), cta()
        torch.cuda.synchronize()
        out[f"k={k}"] = {
            "variant": K.spd_variant(k),
            "rel_diff": float((x - cx).abs().max() / cx.abs().max()),
            "ms": time_ms(launch, inner=INNER),
            "cta_ms": time_ms(cta, inner=INNER),
        }
    return out


# -- profile ----------------------------------------------------------------


def _interval_union_us(intervals) -> float:
    busy, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def iteration_fn(user_side, item_side, y):
    """One more iteration (both halves) from the trained Y, as a function
    for ``device_profiles``."""
    yp = torch.zeros((item_side.padded_rows, FEATURES), device=y.device)
    yp[: y.shape[0]] = y

    def half(side, opp):
        return tr.solve_side_blocked(
            opp, side.srows, side.scols, side.svals, side.slens, LAM, ALPHA,
            block=side.block, features=FEATURES, implicit=True,
            slot_chunk=side.slot_chunk, schedules=side.gg_schedules,
        )

    return lambda: half(item_side, half(user_side, yp))


WINDOW = "chip_smoke.window"


def device_profiles(windows: dict) -> dict:
    """Each function of ``windows`` once to warm up, then each once more,
    back to back, in ONE ``torch.profiler`` session, each inside a window
    of its own: per window, device time by kernel and the share of the
    window's host wall time in which no kernel ran.

    One session serves every window because on the H100 machines a session
    begun some seconds after the previous one ended has recorded no device
    events, and no later session of the process recorded any; how many
    seconds differs from run to run (``profiler_gap.py``). A one-element
    fill runs first inside the session (the tracer has been seen to drop
    the first kernel it would record) and is left out: a device event
    counts in the last window opened before it started."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in windows.values():
        fn()
    torch.cuda.synchronize()
    walls_us = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        for i, (name, fn) in enumerate(windows.items()):
            with record_function(f"{WINDOW}:{i}"):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls_us[name] = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    opened = sorted((e.time_range.start, int(e.name.split(":")[1]))
                    for e in events if e.name.startswith(WINDOW + ":")
                    and e.device_type != DeviceType.CUDA)
    names = list(windows)
    spans: dict = {name: [] for name in names}
    for e in events:
        # the annotations' own device-side spans are left out
        if e.device_type != DeviceType.CUDA or e.name.startswith(WINDOW):
            continue
        start = e.time_range.start
        inside = [i for t, i in opened if t <= start]
        if inside:
            spans[names[inside[-1]]].append(e)
    return {name: window_profile(spans[name], walls_us[name])
            for name in names}


def window_profile(events, wall_us: float) -> dict:
    """Device time by kernel and idle share of one profiled window."""
    if not events:
        return {"device_time": "not measured", "wall_ms": wall_us / 1e3}
    by_name: dict = {}
    count: dict = {}
    for e in events:
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("(")[0][:70]
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end
                                                  - e.time_range.start)
        count[name] = count.get(name, 0) + 1
    busy_us = _interval_union_us(
        [(e.time_range.start, e.time_range.end) for e in events])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:16]
    return {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "kernels_ms": {n: us / 1e3 for n, us in top},
        "kernel_launches": {n: count[n] for n, _ in top},
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


def flagship_model(rng):
    """A serving model on the card holding 1M items × 50 seeded features:
    (model, Y, ids); Y is loaded, not yet uploaded."""
    y = rng.standard_normal((FLAGSHIP_ITEMS, FEATURES), dtype=np.float32)
    ids = [f"i{j}" for j in range(FLAGSHIP_ITEMS)]
    model = ALSServingModel(FEATURES, True)
    model.bulk_load_items(ids, y)
    return model, y, ids


def serve_flagship(rng):
    """top_n_batch at 1M items × 50 features, seeded factors."""
    t0 = time.perf_counter()
    model, y, ids = flagship_model(rng)
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


# -- ALS generation ---------------------------------------------------------


class RecordingProducer:
    """An update-topic producer that records ``(key, message, headers)``."""

    def __init__(self):
        self.sent = []

    def send(self, key, message, headers=None):
        self.sent.append((key, message, headers))


def aligned_copy(value):
    """A contiguous copy of a tensor at the same offset from a 16-byte
    boundary, so a kernel given the copy takes the same load path; any
    other value as it is."""
    if not isinstance(value, torch.Tensor):
        return value
    off = (value.data_ptr() % 16) // value.element_size()
    flat = torch.empty(value.numel() + off, dtype=value.dtype,
                       device=value.device)
    return flat[off:].view(value.shape).copy_(value)


def copy_outputs(out):
    return tuple(o.clone() for o in out) if isinstance(out, tuple) else out.clone()


def gg_key(args, kwargs) -> tuple:
    y, scols = args[0], args[2]
    return (kwargs["block"] + 1, *scols.shape, y.shape[1], str(y.dtype))


def spd_key(args, kwargs) -> tuple:
    return tuple(args[1].shape)


def sweep_key(args, kwargs) -> tuple:
    points, _, centers = args
    return (*points.shape, centers.shape[0])


class FirstLaunches:
    """For the length of a ``with`` block, wraps kernel wrappers where a path
    looks them up (``(module, name, key)`` each, ``key`` giving the shape
    that ``K.SHAPE_LAUNCHES`` counts the launch under) and keeps, for the
    first call at each shape, copies of its inputs and of what it returned:
    the launches a path made, to hold against the plain versions after it.
    Calls from several threads are recorded under a lock."""

    def __init__(self, targets):
        self.targets = targets
        self.calls: dict = {}
        self.saved: list = []
        self.lock = threading.Lock()

    def _wrap(self, name, fn, key):
        def recorded(*args, **kwargs):
            shape = key(args, kwargs)
            with self.lock:
                first = (name, shape) not in self.calls
                if first:
                    self.calls[(name, shape)] = None
            if not first:
                return fn(*args, **kwargs)
            inputs = ([aligned_copy(a) for a in args],
                      {k: aligned_copy(v) for k, v in kwargs.items()})
            out = fn(*args, **kwargs)
            with self.lock:
                self.calls[(name, shape)] = (*inputs, copy_outputs(out))
            return out
        return recorded

    def __enter__(self):
        for module, name, key in self.targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))
            setattr(module, name, self._wrap(name, fn, key))
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)
        self.saved.clear()
        return False


def max_errs(pairs) -> tuple[float, float]:
    """The largest |output − plain| over (output, plain) pairs, and the
    largest of each such difference over its plain output's largest
    magnitude."""
    diffs = [(float((o - p).abs().max()), float(p.abs().max())) for o, p in pairs]
    return max(d for d, _ in diffs), max(d / m for d, m in diffs)


def hold_path_launches(first: FirstLaunches, counted: dict, phase: str) -> list:
    """Every shape at which ``phase``'s path launched a kernel, held against
    the plain version on the inputs of its first launch there: the wrapper
    called again on them must return the same bits as on the path, and
    those must agree with the plain version within the kernel phases'
    tolerances — 1e-4 of the plain output's largest magnitude for the
    gather-Gramian and the SPD solve (float32 sums and eliminations in
    another order), and for the sweep ``sweep_check``'s with near ties
    allowed (the path's own centres: two may share a blob, so a point may
    lie within a rounding of both). ``counted`` is ``K.SHAPE_LAUNCHES`` as
    read just after the path; every shape counted there must have been
    recorded."""
    wanted = {(kernel.split(".")[0], shape) for kernel, shape in counted
              if not kernel.endswith(".reduce")}
    check(set(first.calls) == wanted,
          f"{phase}: recorded shapes {sorted(first.calls)} are not the "
          f"counted ones {sorted(wanted)}")
    out = []
    for (name, shape), (args, kwargs, path_out) in sorted(first.calls.items()):
        label = f"{phase} {name} {shape}"
        got = getattr(K, name)(*args, **kwargs)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        path_out = path_out if isinstance(path_out, tuple) else (path_out,)
        check(all(torch.equal(g, p) for g, p in zip(got, path_out)),
              f"{label}: the wrapper gives other bits than on the path")
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{label}: non-finite output")
        entry = {"kernel": name, "shape": list(shape),
                 "path_launches": counted.get(
                     (f"{name}.{K.spd_variant(shape[1])}"
                      if name == "spd_solve_batched" else name, shape), 0)}
        if name == "kmeans_assign_accumulate":
            entry.update(sweep_check(*args, near_ties=True, label=label),
                         tol=1e-4, cost_tol=1e-5)
        else:
            plain = (K.gather_gramian_accumulate_plain(*args,
                                                       block=kwargs["block"])
                     if name == "gather_gramian_accumulate"
                     else (K.spd_solve_batched_plain(*args),))
            abs_err, rel_err = max_errs(zip(got, plain))
            check(rel_err < 1e-4, f"{label}: rel err {rel_err} >= 1e-4")
            entry.update(max_abs_err=abs_err, max_rel_err=rel_err, tol=1e-4)
        out.append(entry)
    return out


def known_items_of(lines) -> dict:
    """Each user's items over ``user,item,...`` lines, sorted: what the
    ``UP`` X messages carry."""
    known: dict = {}
    for ln in lines:
        user, item = ln.split(",", 2)[:2]
        known.setdefault(user, set()).add(item)
    return {u: sorted(items) for u, items in known.items()}


def read_part_files(path: Path):
    ids, vecs = [], []
    for id_, vec in als_codec.read_features(path):
        ids.append(id_)
        vecs.append(vec)
    return ids, np.stack(vecs)


def check_update_stream(sent, meta, train_users, known) -> dict:
    """One ``MODEL`` (or ``MODEL-REF``) first, then a ``Y`` ``UP`` for every
    item of the model before any ``X``, then one ``X`` ``UP`` for each user
    of the training split with its known items (over all the lines)."""
    keys = [k for k, _, _ in sent]
    check(keys[0] in ("MODEL", "MODEL-REF")
          and not ({"MODEL", "MODEL-REF"} & set(keys[1:])),
          f"als_generation: not one model message first: {keys[:3]}")
    check(set(keys[1:]) == {"UP"}, "als_generation: a non-UP after the model")
    ups = [json.loads(m) for _, m, _ in sent[1:]]
    kinds = [u[0] for u in ups]
    n_y = kinds.count("Y")
    check(kinds == ["Y"] * n_y + ["X"] * (len(kinds) - n_y),
          "als_generation: an X UP came before the last Y UP")
    check([u[1] for u in ups[:n_y]] == meta["y_ids"],
          "als_generation: Y UPs are not the model's items in order")
    x_ups = ups[n_y:]
    check([u[1] for u in x_ups] == meta["x_ids"]
          and set(meta["x_ids"]) == train_users,
          "als_generation: X UPs are not one per user of the training split")
    check(all(u[3] == known[u[1]] for u in x_ups),
          "als_generation: an X UP's known items differ from the user's items")
    check(all(len(u[2]) == meta["features"] for u in ups),
          "als_generation: a vector of the wrong width")
    return {"model": 1, "y_ups": n_y, "x_ups": len(x_ups)}


def als_generation_phase(lines, rng):
    """One ALS batch generation through its entry points: ``ALSUpdate
    .run_update`` (its candidate trained on the card, evaluated, promoted
    and published to a recording producer), then a fresh
    ``ALSServingModelManager`` on the card consuming the whole stream, and
    its top-10 for 256 users held against a model loaded straight from the
    promoted part files (see the module docstring). Returns the phase's
    record, the published ``(key, message, headers)`` stream, the serving
    manager and the configuration, for the speed phase."""
    conf = oryx_config.overlay_on({
        "oryx.ml.eval.test-fraction": TEST_FRACTION,
        "oryx.ml.eval.candidates": 1,
        "oryx.als.hyperparams.lambda": LAM,
        "oryx.als.hyperparams.features": FEATURES,
        "oryx.als.hyperparams.alpha": ALPHA,
        "oryx.als.iterations": ITERATIONS,
    }, oryx_config.get_default())
    update = ALSUpdate(conf)
    msgs = [KeyMessage(None, ln) for ln in lines]
    producer = RecordingProducer()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="oryx-generation-") as model_dir:
        K.reset_launches()
        with FirstLaunches([(tr, "gather_gramian_accumulate", gg_key),
                            (tr, "spd_solve_batched", spd_key)]) as first:
            t0 = time.perf_counter()
            update.run_update(None, GENERATION_TIMESTAMP_MS, msgs, [],
                              model_dir, producer)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        counted = dict(K.SHAPE_LAUNCHES)
        report = update.report
        cands = report["candidates"]
        check(len(cands) == 1 and all(
            "failed" not in c and "eval" in c for c in cands.values()),
              f"als_generation: not every candidate built and evaluated: "
              f"{ {n: c.get('failed') for n, c in cands.items()} }")
        check(all(c["device"].startswith("cuda") for c in cands.values()),
              "als_generation: a candidate was not built on the card")
        aucs = {n: c["eval"] for n, c in cands.items()}
        best = report["best"]
        check(aucs[best] == max(aucs.values()) and aucs[best] > 0.75,
              f"als_generation: promoted {best} of AUCs {aucs}")
        expected = sum(ITERATIONS * (c["blocks"]["user"] + c["blocks"]["item"])
                       for c in cands.values())
        for wrapper in ALS_WRAPPERS:
            check(launches[wrapper] == expected,
                  f"als_generation: {launches[wrapper]} {wrapper} launches, "
                  f"expected {expected} (iterations x blocks, both candidates)")
        held = hold_path_launches(first, counted, "als_generation")
        promoted = Path(model_dir) / str(GENERATION_TIMESTAMP_MS)
        meta = als_codec.pmml_to_meta(pmmlutils.read(promoted / "model.pmml"))
        # the lines' timestamps are their positions, so the time-ordered
        # training split is the first 90%
        n_train = int(round(len(lines) * (1.0 - TEST_FRACTION)))
        known = known_items_of(lines)
        train_known = known_items_of(lines[:n_train])
        counts = check_update_stream(producer.sent, meta, set(train_known), known)
        train_items = {i for items in train_known.values() for i in items}
        check(set(meta["y_ids"]) == train_items,
              f"als_generation: {counts['y_ups']} Y UPs for the "
              f"{len(train_items)} items of the training split")

        manager = ALSServingModelManager(conf)
        t0 = time.perf_counter()
        manager.consume(KeyMessage(k, m) for k, m, _ in producer.sent)
        consume_s = time.perf_counter() - t0
        model = manager.get_model()
        fraction = model.get_fraction_loaded()
        check(fraction == 1.0, f"als_generation: fraction loaded {fraction}")

        x_ids, x = read_part_files(promoted / meta["x_dir"])
        y_ids, y = read_part_files(promoted / meta["y_dir"])
        users = [x_ids[i] for i in rng.choice(len(x_ids), 256, replace=False)]
        direct = state.serving_model(x, y, x_ids, y_ids,
                                     known_items={u: known[u] for u in users})
        qs = np.stack([model.get_user_vector(u) for u in users])
        check(np.array_equal(qs, np.stack([direct.get_user_vector(u)
                                           for u in users])),
              "als_generation: user vectors differ after the JSON round trip")
        excluded = [model.get_known_items(u) for u in users]
        check(excluded == [direct.get_known_items(u) for u in users],
              "als_generation: known items differ")
        t0 = time.perf_counter()
        res = model.top_n_batch(qs, 10, excluded=excluded)
        first_top_n_s = time.perf_counter() - t0
        want = direct.top_n_batch(qs, 10, excluded=excluded)
        check(torch.equal(model.y_snapshot().mat, direct.y_snapshot().mat),
              "als_generation: the served Y differs from the part files'")
        check([[i for i, _ in r] for r in res] == [[i for i, _ in r] for r in want]
              and all(len(r) == 10 for r in res),
              "als_generation: top-10 ids differ from the directly loaded model's")
        check(torch.equal(torch.tensor([[v for _, v in r] for r in res]),
                          torch.tensor([[v for _, v in r] for r in want])),
              "als_generation: top-10 scores differ from the directly loaded model's")
        for r, ex in zip(res, excluded):
            check(not ({i for i, _ in r} & ex), "als_generation: a known item came back")

    stages = {"split_s": report["split_s"]}
    for name, c in sorted(cands.items()):
        stages[f"candidate_{name}"] = {
            key: c[key] for key in (
                "hyperparameters", "build_s", "prepare_s", "train_s", "pack_s",
                "iter_s", "write_s", "evaluate_s", "evaluate_load_s",
                "evaluate_parse_s", "evaluate_score_s", "eval", "blocks")}
    publish_s = report["publish_model_s"] + report["publish_additional_s"]
    device_iter_s = sum(sum(c["iter_s"]) for c in cands.values())
    out.update(
        combos=report["combos"], best=best, aucs=aucs, stages=stages,
        promote_s=report["promote_s"],
        publish_model_s=report["publish_model_s"],
        publish_y_s=report["publish_y_s"],
        known_items_s=report["known_items_s"],
        publish_x_s=report["publish_x_s"],
        publish_s=publish_s, consume_s=consume_s,
        first_top_n_s=first_top_n_s, run_update_s=report["run_update_s"],
        run_update_wall_s=run_s,
        model_to_servable_s=publish_s + consume_s,
        device_iter_share=device_iter_s / run_s,
        published=report["published"],
        model_bytes=len(producer.sent[0][1].encode("utf-8")),
        messages=counts, fraction_loaded=fraction, launches=launches,
        expected_launches=expected,
        shape_launches={launch_key(*key): n for key, n in counted.items()},
        held_against_plain=held, top_n_users=len(users))
    return out, producer.sent, manager, conf


# -- ALS speed tier ---------------------------------------------------------


def settle_solvers(caches) -> float:
    """Bring solver caches up to their vectors: wait out a background
    recompute, then recompute in this thread if dirty; returns the seconds.
    ``SolverCache`` hands out the previous solver while a recompute runs,
    so a microbatch that follows the previous one's ``UP``s at once folds
    in against whichever Gramian that race left; the float64 checks below
    need the current one."""
    t0 = time.perf_counter()
    for cache in caches:
        deadline = time.monotonic() + 60
        while cache._in_flight and time.monotonic() < deadline:
            time.sleep(0.001)
        cache._maybe_launch(wait=True)
    return time.perf_counter() - t0


def pair_values(lines) -> dict:
    """``(user, item) -> summed value`` over ``user,item,value,ts`` lines:
    the implicit aggregation ``data.prepare`` applies (no decay, no log
    strength)."""
    out: dict = {}
    for ln in lines:
        u, i, v = ln.split(",")[:3]
        out[(u, i)] = out.get((u, i), 0.0) + float(v)
    return out


def implicit_target(value: float, current: float) -> float:
    """The implicit target estimate (ALSUtils.computeTargetQui), or NaN."""
    if value > 0.0 and current < 1.0:
        return current + value / (1.0 + value) * (1.0 - max(0.0, current))
    if value < 0.0 and current > 0.0:
        return current + value / (value - 1.0) * -min(1.0, current)
    return float("nan")


def check_speed_updates(ups, values, pre, rng, label) -> dict:
    """The microbatch's ``UP``s against an independent reading of the same
    pre-batch X and Y: one X ``UP``, carrying its item, per pair whose item
    has a vector and whose target estimate is defined (float32 dot, as the
    fold-in computes it), one Y ``UP`` per pair likewise; and for 256
    sampled ``UP``s of each kind, ``v + solve(VᵀV, w·Δq)`` recomputed with
    ``np.linalg.solve`` in float64, within relative 1e-4 (a float32
    Gramian's rounding through the solve)."""
    parsed = [json.loads(u) for u in ups]
    got = {"X": {}, "Y": {}}
    for u in parsed:
        check(len(u) == 4 and len(u[3]) == 1 and len(u[2]) == FEATURES,
              f"{label}: malformed UP {u[:2]}")
        pair = (u[1], u[3][0]) if u[0] == "X" else (u[3][0], u[1])
        check(pair in values, f"{label}: an UP for a pair not in the microbatch")
        check(pair not in got[u[0]], f"{label}: two {u[0]} UPs for {pair}")
        got[u[0]][pair] = np.asarray(u[2], dtype=np.float32)
    (x_index, x0), (y_index, y0) = pre
    gram = {"X": y0.astype(np.float64).T @ y0.astype(np.float64),
            "Y": x0.astype(np.float64).T @ x0.astype(np.float64)}
    want_pairs = {"X": set(), "Y": set()}
    for (user, item), value in values.items():
        xr, yr = x_index.get(user), y_index.get(item)
        dot = float(np.dot(x0[xr], y0[yr])) if xr is not None and yr is not None else 0.0
        if yr is not None and not np.isnan(
                implicit_target(value, dot if xr is not None else 0.5)):
            want_pairs["X"].add((user, item))
        if xr is not None and not np.isnan(
                implicit_target(value, dot if yr is not None else 0.5)):
            want_pairs["Y"].add((user, item))
    out = {}
    for kind in ("X", "Y"):
        check(set(got[kind]) == want_pairs[kind],
              f"{label}: {len(got[kind])} {kind} UPs for "
              f"{len(want_pairs[kind])} changed pairs")
        pairs = sorted(got[kind])
        worst = 0.0
        for j in rng.choice(len(pairs), min(SPEED_SAMPLES, len(pairs)), replace=False):
            user, item = pairs[j]
            xr, yr = x_index.get(user), y_index.get(item)
            xu = x0[xr].astype(np.float64) if xr is not None else None
            yi = y0[yr].astype(np.float64) if yr is not None else None
            own, other = (xu, yi) if kind == "X" else (yi, xu)
            qui = float(own @ other) if own is not None else 0.0
            target = implicit_target(values[(user, item)],
                                     qui if own is not None else 0.5)
            want = np.linalg.solve(gram[kind], other * (target - qui))
            if own is not None:
                want = want + own
            rel = float(np.abs(got[kind][(user, item)] - want).max()
                        / np.abs(want).max())
            worst = max(worst, rel)
        check(worst < 1e-4, f"{label}: {kind} UPs differ from the float64 "
              f"fold-in by rel {worst}")
        out[kind] = {"ups": len(pairs), "max_rel_err_f64": worst}
    return out


def check_served_top_n(model, touched, rng, label) -> dict:
    """256 users, half of them touched by the microbatch: the manager's
    top-10 (known items excluded, ``UP``-carried ones among them) equal to
    a model built fresh from the stores' host matrices, ids and scores bit
    for bit."""
    all_users = model.all_user_ids()
    half = SPEED_SAMPLES // 2
    users = list(rng.choice(sorted(touched), half, replace=False))
    rest = sorted(set(all_users) - set(users))
    users += [rest[j] for j in rng.choice(len(rest), SPEED_SAMPLES - half, replace=False)]
    known = {u: model.get_known_items(u) for u in users}
    x_ids, x, _ = model.x.host_matrix()
    y_ids, y, _ = model.y.host_matrix()
    fresh = state.serving_model(x, y, x_ids, y_ids, known_items=known)
    qs = np.stack([model.get_user_vector(u) for u in users])
    excluded = [known[u] for u in users]
    res = model.top_n_batch(qs, 10, excluded=excluded)
    want = fresh.top_n_batch(qs, 10, excluded=excluded)
    check([[i for i, _ in r] for r in res] == [[i for i, _ in r] for r in want]
          and all(len(r) == 10 for r in res),
          f"{label}: top-10 ids differ from a freshly loaded model's")
    check(torch.equal(torch.tensor([[v for _, v in r] for r in res]),
                      torch.tensor([[v for _, v in r] for r in want])),
          f"{label}: top-10 scores differ from a freshly loaded model's")
    for r, ex in zip(res, excluded):
        check(not ({i for i, _ in r} & ex), f"{label}: a known item came back")
    return {"users": len(users), "touched": half}


def check_fold_in_api(model, rng, label) -> dict:
    """The serving fold-in API on the card: ``get_vtv`` on the card's
    matrix against a float64 host Gramian (relative 1e-5: a float32
    product over the items); ``build_temporary_user_vector`` for 256
    anonymous contexts of 1-20 items against a float64 fold-in (relative
    1e-4); ``top_n_cosine`` for 16 item sets against an exact float64 scan
    (overlap >= 0.99)."""
    store = model.y
    y_ids, y, version = store.host_matrix()
    check(store._cached_version == version,
          f"{label}: the device matrix is not current for get_vtv")
    t0 = time.perf_counter()
    vtv = store.get_vtv()
    vtv_s = time.perf_counter() - t0
    y64 = y.astype(np.float64)
    gram = y64.T @ y64
    vtv_rel = float(np.abs(vtv - gram).max() / np.abs(gram).max())
    check(vtv_rel < 1e-5, f"{label}: get_vtv rel err {vtv_rel} >= 1e-5")
    solver_s = settle_solvers([model.yty_cache])
    index = {s: i for i, s in enumerate(y_ids)}
    worst = 0.0
    for _ in range(SPEED_SAMPLES):
        items = [y_ids[j] for j in rng.choice(len(y_ids), rng.integers(1, 21),
                                              replace=False)]
        got = model.build_temporary_user_vector([(i, 1.0) for i in items])
        vec = None
        for item in items:
            yi = y64[index[item]]
            qui = float(vec @ yi) if vec is not None else 0.0
            target = implicit_target(1.0, qui if vec is not None else 0.5)
            if np.isnan(target):
                continue
            step = np.linalg.solve(gram, yi * (target - qui))
            vec = step if vec is None else vec + step
        worst = max(worst, float(np.abs(got - vec).max() / np.abs(vec).max()))
    check(worst < 1e-4, f"{label}: temporary user vectors rel err {worst}")
    norms = np.linalg.norm(y64, axis=1)
    hits = 0
    t0 = time.perf_counter()
    for _ in range(16):
        items = rng.choice(len(y_ids), rng.integers(1, 6), replace=False)
        qs = y[items]
        res = model.top_n_cosine(qs, 10)
        q64 = qs.astype(np.float64)
        sims = (y64 @ q64.T) / np.maximum(
            norms[:, None] * np.linalg.norm(q64, axis=1)[None, :], 1e-12)
        top = np.argpartition(-sims.mean(axis=1), 10)[:10]
        hits += len({y_ids[j] for j in top} & {i for i, _ in res})
    cosine_s = time.perf_counter() - t0
    overlap = hits / 160
    check(overlap >= 0.99, f"{label}: cosine overlap {overlap} < 0.99")
    return {"vtv_rel_err": vtv_rel, "vtv_s": vtv_s, "yty_solver_s": solver_s,
            "temporary_user_vector_max_rel_err_f64": worst,
            "cosine_overlap": overlap, "cosine_16_sets_s": cosine_s}


def whole_upload_ms(store, dev) -> tuple:
    """The store uploaded whole (host gather, copy to the card), host
    milliseconds around a synchronise; and the matrix."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, host, _ = store.host_matrix()
    mat = torch.from_numpy(host).to(dev)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, ids, mat


def timed_snapshot_ms(model) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = model.y_snapshot()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, snap


def flagship_snapshots(dev, rng) -> dict:
    """The seeded 1,000,000 × 50f serving model: three rounds of 10,000
    changed and 1,000 new rows through ``set_item_vector``, each followed
    by a timed incremental ``y_snapshot``, beside a whole upload of the
    same store (``torch.equal`` matrices); then top-10 for 16 queries equal
    to a model loaded fresh from the store, ids and scores bit for bit."""
    model, _, ids = flagship_model(rng)
    first_ms, _ = timed_snapshot_ms(model)
    rounds = []
    for r in range(3):
        changed = rng.choice(len(ids), FLAGSHIP_CHANGED, replace=False)
        vecs = rng.standard_normal((FLAGSHIP_CHANGED + FLAGSHIP_NEW, FEATURES),
                                   dtype=np.float32)
        t0 = time.perf_counter()
        for j, v in zip(changed.tolist(), vecs):
            model.set_item_vector(ids[j], v)
        for j, v in enumerate(vecs[FLAGSHIP_CHANGED:]):
            model.set_item_vector(f"new{r}-{j}", v)
        writes_s = time.perf_counter() - t0
        inc_ms, snap = timed_snapshot_ms(model)
        full_ms, full_ids, full = whole_upload_ms(model.y, dev)
        check(torch.equal(snap.mat, full) and snap.n == len(full_ids)
              and list(snap.ids[:snap.n]) == full_ids,
              f"flagship round {r}: the incremental matrix is not the whole upload")
        rounds.append({"incremental_ms": inc_ms, "full_upload_ms": full_ms,
                       "writes_s": writes_s, "items": snap.n})
    check(model.y.materializations == {"full": 1, "incremental": 3},
          f"flagship: materialisations {model.y.materializations}")
    fresh = ALSServingModel(FEATURES, True)
    fresh.bulk_load_items(full_ids, model.y.host_matrix()[1])
    qs = rng.standard_normal((16, FEATURES), dtype=np.float32)
    res, want = model.top_n_batch(qs, 10), fresh.top_n_batch(qs, 10)
    check(res == want and all(len(r) == 10 for r in res),
          "flagship: top-10 differs from a freshly loaded model's")
    return {"items": FLAGSHIP_ITEMS, "changed_rows": FLAGSHIP_CHANGED,
            "new_rows": FLAGSHIP_NEW, "first_snapshot_ms": first_ms,
            "rounds": rounds, "materializations": dict(model.y.materializations)}


def als_speed_phase(lines, sent, manager, conf, rng) -> dict:
    """The ALS speed tier on the generation's stream (see the module
    docstring): a new ``ALSSpeedModelManager`` consumes it; the held-out
    10% of the lines, the newest, goes in as two microbatches whose ``UP``s
    both managers hear; each is checked against float64 and the serving
    snapshot taken incrementally; then the flagship's snapshots."""
    dev = resolve(None)
    phase_t0 = time.perf_counter()
    K.reset_launches()
    speed = ALSSpeedModelManager(conf)
    t0 = time.perf_counter()
    speed.consume(KeyMessage(k, m) for k, m, _ in sent)
    speed_load_s = time.perf_counter() - t0
    fraction = speed.model.get_fraction_loaded()
    check(fraction == 1.0, f"als_speed: speed fraction loaded {fraction}")
    model = manager.get_model()
    full_builds = model.y.materializations["full"]
    n_train = int(round(len(lines) * (1.0 - TEST_FRACTION)))
    held_out = lines[n_train:]
    batches = [held_out[j:j + SPEED_MICROBATCH]
               for j in range(0, len(held_out), SPEED_MICROBATCH)]
    out: dict = {"speed_load_s": speed_load_s, "microbatches": []}
    for b, batch in enumerate(batches):
        label = f"als_speed microbatch {b}"
        solver_settle_s = settle_solvers([speed.model.xtx_cache,
                                          speed.model.yty_cache])
        x_ids, x0, _ = speed.model.x.host_matrix()
        y_ids, y0, _ = speed.model.y.host_matrix()
        pre = (({s: i for i, s in enumerate(x_ids)}, x0),
               ({s: i for i, s in enumerate(y_ids)}, y0))
        incremental = model.y.materializations["incremental"]
        t_in = time.perf_counter()
        ups = speed.build_updates([KeyMessage(None, ln) for ln in batch])
        build_s = time.perf_counter() - t_in
        t0 = time.perf_counter()
        manager.consume(KeyMessage("UP", u) for u in ups)
        serving_consume_s = time.perf_counter() - t0
        snapshot_ms, snap = timed_snapshot_ms(model)
        input_to_servable_s = time.perf_counter() - t_in
        t0 = time.perf_counter()
        speed.consume(KeyMessage("UP", u) for u in ups)
        speed_consume_s = time.perf_counter() - t0
        counts = check_speed_updates(ups, pair_values(batch), pre, rng, label)
        check(model.y.materializations == {"full": full_builds,
                                           "incremental": incremental + 1},
              f"{label}: materialisations {model.y.materializations}")
        full_ms, full_ids, full = whole_upload_ms(model.y, dev)
        check(torch.equal(snap.mat, full) and list(snap.ids[:snap.n]) == full_ids,
              f"{label}: the incremental matrix is not the whole upload")
        touched = {json.loads(u)[1] for u in ups if u.startswith('["X"')}
        for u in ups[:1000]:
            up = json.loads(u)
            if up[0] == "X":
                check(up[3][0] in model.get_known_items(up[1]),
                      f"{label}: an UP's item is not among the known items")
        record = {
            "lines": len(batch), "interactions": speed.report["interactions"],
            "ups": len(ups), "x_ups": counts["X"]["ups"],
            "y_ups": counts["Y"]["ups"], "checks": counts,
            "build_updates_s": build_s,
            "stages_s": {k: speed.report[k] for k in (
                "prepare_s", "solver_s", "gather_s", "foldin_s", "format_s")},
            "ups_per_s": len(ups) / build_s,
            "solver_settle_s": solver_settle_s,
            "serving_consume_s": serving_consume_s,
            "speed_consume_s": speed_consume_s,
            "snapshot_incremental_ms": snapshot_ms,
            "snapshot_full_upload_ms": full_ms, "items": snap.n,
            "input_to_servable_s": input_to_servable_s,
            "top_n": check_served_top_n(model, touched, rng, label),
            "fold_in_api": check_fold_in_api(model, rng, label),
        }
        out["microbatches"].append(record)
    out["flagship"] = flagship_snapshots(dev, rng)
    out["launches"] = dict(K.LAUNCHES)
    out["seconds"] = time.perf_counter() - phase_t0
    check(not any(out["launches"].values()),
          f"als_speed: kernels launched on the speed path: {out['launches']}")
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


def sweep_bare_launch(points, weights, centers):
    """A no-argument launch of ``oryx_kmeans_assign`` (all three launches)
    on the wrapper's arguments and plan, into preallocated scratch and
    output, with the pointers taken once: the sweep timed apart from the
    wrapper's host cost, as the other kernels are."""
    n, d = points.shape
    k = centers.shape[0]
    plan = K.kmeans_sweep_plan(n, k, d)
    dev = points.device
    assign = torch.empty(n, device=dev, dtype=torch.int32)
    min_d2 = torch.empty(n, device=dev)
    ws = torch.empty((plan.parts, plan.slab_floats), device=dev)
    out = torch.empty(plan.slab_floats, device=dev)
    fn = K._entry("kmeans_assign", "oryx_kmeans_assign")
    cargs = K.kmeans_sweep_args(points, weights, centers, plan, assign, min_d2,
                                ws, out, torch.cuda.current_stream().cuda_stream)

    def launch():
        err = fn(*cargs)
        check(err == 0, f"oryx_kmeans_assign: CUDA error {err}")
        return out

    return launch


SWEEP_LAUNCHES = ("assign_kernel", "partial_kernel", "reduce_kernel")


def sweep_profile(prof: dict, label: str) -> dict:
    """One sweep's window of ``device_profiles``; fails unless it lists each
    of the sweep's three launches once."""
    launches = prof.get("kernel_launches", {})
    for kernel in SWEEP_LAUNCHES:
        seen = sum(c for name, c in launches.items() if name.startswith(kernel))
        check(seen == 1, f"kmeans {label}: the profile lists {seen} "
              f"{kernel} launches, not 1: {launches}")
    return prof


def sweep_timing(points, weights, centers, label: str) -> dict:
    """The sweep timed by bare launches of its C entry (20 per CUDA-event
    pair) and through the wrapper (one call per pair), beside its plain
    version, the cross term's ``torch.matmul`` (TF32 off) and the card's
    bound for (N, D, K). ``device_profiles`` profiles it later."""
    n, d = points.shape
    k = centers.shape[0]
    args = (points, weights, centers)
    launch = sweep_bare_launch(*args)
    bare = launch().clone()
    sums, counts, cost = K.kmeans_assign_accumulate(*args)
    torch.cuda.synchronize()
    check(torch.equal(bare, torch.cat([sums.flatten(), counts, cost[None]])),
          f"kmeans {label}: the bare launch differs from the wrapper")
    nbytes = (n * d + n + k * d  # points, weights, centres
              + k * d + k + 1) * 4  # sums, counts, cost written
    flops = 2.0 * n * k * d + 2.0 * n * d
    bound_ms, bound_by = bound(nbytes, flops, torch.float32)
    return {
        "kernel_ms": time_ms(launch, inner=INNER),
        "wrapper_ms": time_ms(lambda: K.kmeans_assign_accumulate(*args)),
        "plain_ms": time_ms(lambda: K.kmeans_assign_accumulate_plain(*args),
                            reps=5, warmup=1),
        "cross_term_matmul_ms": time_ms(lambda: points @ centers.T),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def sweep_entry(label, case, timing) -> dict:
    """A kernels-line entry for the sweep at one shape."""
    n, d, k = case["n"], case["d"], case["k"]
    plan = K.kmeans_sweep_plan(n, k, d)
    return {
        "name": f"kmeans_assign_accumulate[{label}]",
        "route": "cuda", "source": KM_SOURCE, "replaces": KM_REPLACES,
        "launch_key": launch_key("kmeans_assign_accumulate", (n, d, k)),
        "shape": {"n": n, "d": d, "k": k, "dtype": "float32"},
        "plan": {"tiles": plan.tiles, "assign_ctas": plan.assign_ctas,
                 "stages": plan.stages,
                 "parts": plan.parts, "walk_threads": plan.walk_threads,
                 "walk_groups": plan.walk_groups,
                 "slab_in_smem": plan.slab_in_smem},
        "max_abs_err": case["max_abs_err"], "max_rel_err": case["max_rel_err"],
        "tol": 1e-4, "cost_rel_err": case["cost_rel_err"], "cost_tol": 1e-5,
        "count_l1": case["count_l1"],
        "ms": timing["kernel_ms"],
        **{key: v for key, v in timing.items() if key != "profile"},
        "library_ms": timing["cross_term_matmul_ms"],
        "library": "cross term only: points @ centers.T (torch.matmul, "
                   "TF32 off); no PyTorch call computes the sweep",
    }


def kmeans_kernel_phase(dev, rng):
    """The sweep kernel in its four cases; the 1M × 64 case and the update
    path's 100k × 64 case timed. Returns the phase's record, the
    kernels-line entries (100k, then 1M), the 1M × 64 points and the two
    timed cases' arguments by label, for ``device_profiles``."""
    pts = torch.from_numpy(
        rng.standard_normal((KM_N, KM_D), dtype=np.float32)).to(dev)
    ones = torch.ones(KM_N, device=dev)
    centers = torch.from_numpy(
        rng.standard_normal((KM_K, KM_D), dtype=np.float32)).to(dev)
    cases = [sweep_check(pts, ones, centers, True, "1M x 64, K=256, normal")]
    args = (pts, ones, centers)
    timing = sweep_timing(*args, "1M x 64")

    means = blob_means(rng)
    blobs = torch.from_numpy(blob_points(rng, means, KM_BLOB_POINTS)).to(dev)
    blob_centers = torch.from_numpy(means).to(dev)
    cases.append(sweep_check(blobs, torch.ones(KM_BLOB_POINTS, device=dev),
                             blob_centers, False, "200k planted blobs, K=256"))
    # the update path's shape: build_model's sweeps run on 100k lines
    update_args = (blobs[:KM_LINES].contiguous(),
                   torch.ones(KM_LINES, device=dev), blob_centers)
    cases.append(sweep_check(*update_args, False, "100k planted blobs, K=256"))
    update_timing = sweep_timing(*update_args, "100k x 64")
    wide_means = rng.uniform(-10.0, 10.0, (1024, 128)).astype(np.float32)
    wide = torch.from_numpy(blob_points(rng, wide_means, 50_000)).to(dev)
    wide_args = (wide, torch.ones(50_000, device=dev),
                 torch.from_numpy(wide_means).to(dev))
    cases.append(sweep_check(*wide_args, False, "50k blobs, K=1024, D=128"))
    wide_ms = time_ms(sweep_bare_launch(*wide_args), inner=INNER)
    entries = [sweep_entry("100k x 64, K=256, update", cases[2], update_timing),
               sweep_entry("1M x 64, K=256", cases[0], timing)]
    record = {"cases": cases, **timing, "update_shape": update_timing,
              "wide_kernel_ms": wide_ms}
    return record, entries, pts, {"1M x 64": args, "100k x 64": update_args}


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
    by_shape = shape_launches()

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
    generation = kmeans_generation(conf, train, runs * (iterations + 1))
    return {"lines": KM_LINES, "features": KM_D, "k": k, "runs": runs,
            "iterations": iterations, "launches": launches,
            "shape_launches": by_shape,
            "scores": scores, "sse_vs_sweep_cost_rel": sse_rel,
            "updates": len(ups), "generation": generation, **timing}


def kmeans_generation(conf, lines, expected_sweeps: int) -> dict:
    """The same k-means path behind ``MLUpdate``: one ``run_update`` on the
    lines (one candidate, 10% held out), published to a recording producer
    and consumed by ``KMeansServingModelManager``, whose model must hold the
    promoted PMML's clusters."""
    update = KMeansUpdate(conf)
    producer = RecordingProducer()
    with tempfile.TemporaryDirectory(prefix="oryx-kmeans-generation-") as model_dir:
        K.reset_launches()
        with FirstLaunches([(K, "kmeans_assign_accumulate", sweep_key)]) as first:
            t0 = time.perf_counter()
            update.run_update(None, GENERATION_TIMESTAMP_MS, lines, [],
                              model_dir, producer)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        sweeps = K.LAUNCHES["kmeans_assign_accumulate"]
        counted = dict(K.SHAPE_LAUNCHES)
        check(sweeps == expected_sweeps, f"kmeans generation: {sweeps} sweep "
              f"launches, expected {expected_sweeps}")
        held = hold_path_launches(first, counted, "kmeans_generation")
        cands = update.report["candidates"]
        check(len(cands) == 1 and all("failed" not in c for c in cands.values()),
              f"kmeans generation: candidates {cands}")
        check([k for k, _, _ in producer.sent] == ["MODEL"],
              "kmeans generation: not one MODEL published")
        promoted = pmmlutils.read(
            Path(model_dir) / str(GENERATION_TIMESTAMP_MS) / "model.pmml")
    serving = KMeansServingModelManager(conf)
    serving.consume(KeyMessage(k, m) for k, m, _ in producer.sent)
    served = serving.get_model().clusters
    want = pmml_codec.read(promoted)
    check(len(served) == KM_K and [c.id for c in served] == [c.id for c in want]
          and all(np.array_equal(c.center, w.center) for c, w in zip(served, want)),
          "kmeans generation: the served clusters differ from the promoted PMML's")
    cand = next(iter(cands.values()))
    return {"run_update_s": run_s, "split_s": update.report["split_s"],
            "build_s": cand["build_s"], "evaluate_s": cand["evaluate_s"],
            "eval": cand["eval"], "publish_model_s": update.report["publish_model_s"],
            "model_bytes": len(producer.sent[0][1].encode("utf-8")),
            "clusters": len(served), "launches": sweeps,
            "held_against_plain": held}


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
        out[call] = {"seconds": seconds, "launches": launches,
                     "shape_launches": shape_launches(), **timings}
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
    emit("build", seconds=time.perf_counter() - t0, built=built,
         spd_ptxas=ptxas_checked("spd_solve", spd_kernel_label, 2),
         sweep_ptxas=ptxas_checked("kmeans_assign", sweep_kernel_label, 5))
    cta_fn = spd_cta_entry()

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
    # each entry's launches expected on the main path: one per row block
    # per iteration at its side's shape; the trainer computes in float32,
    # so the bfloat16 gather-Gramian and the synthetic SPD systems are on
    # no path
    entries = []
    for side, opp, label in ((user_side, y_items, "user"),
                             (item_side, y_users, "item")):
        for dtype in (torch.float32, torch.bfloat16):
            dname = "float32" if dtype == torch.float32 else "bfloat16"
            entries.append(gg_entry(side, opp, dtype,
                                    f"{label},T={side.slot_width},{dname}"))
            on_path = dtype == torch.float32
            entries[-1]["expected_launches"] = (
                side.n_blocks * ITERATIONS if on_path else 0)
            # a reduce launch per call on a block whose schedule has a
            # split row
            entries[-1]["expected_reduce_launches"] = ITERATIONS * sum(
                1 for sc in side.gg_schedules if sc.split_rows) if on_path else 0
    for side, opp, label in ((user_side, y_items, "user"),
                             (item_side, y_users, "item")):
        entries.append(spd_entry(*spd_blocks(side, opp),
                                 f"{label},k={FEATURES}", cta_fn))
        entries[-1]["expected_launches"] = side.n_blocks * ITERATIONS
    for k in SPD_SYNTHETIC_K:
        entries.append(spd_entry(
            *spd_synthetic(dev, SPD_SYNTHETIC_SYSTEMS, k, SEED + k),
            f"synthetic,k={k}", cta_fn))
        entries[-1]["expected_launches"] = 0
    torch.cuda.empty_cache()
    emit("spd_crossover", **spd_crossover(dev, cta_fn))
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
    als_shape_launches = shape_launches()
    emit("serve", **serve, launches=launches,
         shape_launches=als_shape_launches)
    for wrapper in ALS_WRAPPERS:
        n = launches[wrapper]
        check(n == expected, f"{wrapper}: {n} launches on the main path, "
              f"expected {expected} ({blocks} blocks x {ITERATIONS} iterations)")
    kernel = f"spd_solve_batched.{K.spd_variant(FEATURES)}"
    n = sum(c for key, c in K.SHAPE_LAUNCHES.items() if key[0] == kernel)
    check(n == expected, f"spd_solve_batched: {n} launches of {kernel} on the "
          f"main path, expected {expected}: {als_shape_launches}")

    emit("serve_flagship", **serve_flagship(rng))

    record, km_entries, km_points, sweep_args = kmeans_kernel_phase(dev, rng)
    # every profiled window in one profiler session, straight after the
    # sweep's timing: see device_profiles
    windows = {"als_iteration": iteration_fn(user_side, item_side, y)}
    for label, args in sweep_args.items():
        windows[label] = lambda a=args: K.kmeans_assign_accumulate(*a)
    profiles = device_profiles(windows)
    emit("profile", **profiles["als_iteration"])
    record["profile"] = sweep_profile(profiles["1M x 64"], "1M x 64")
    record["update_shape"]["profile"] = sweep_profile(profiles["100k x 64"],
                                                      "100k x 64")
    emit("kmeans_kernel", **record)
    km_update = kmeans_update_phase(dev, rng)
    emit("kmeans_update", **km_update)
    km_train = kmeans_train_phase(km_points)
    emit("kmeans_train", **km_train)
    # last: mostly host work, and nothing after them is profiled
    generation, sent, manager, conf = als_generation_phase(lines, rng)
    emit("als_generation", **generation)
    speed = als_speed_phase(lines, sent, manager, conf, rng)
    emit("als_speed", **speed)
    del sent, manager

    # each entry's launches at its shape, from the run of the path that
    # reaches it: the ALS run above, build_model (100k x 64), kmeans_train's
    # timed call (1M x 64)
    km_update_entry, km_train_entry = km_entries
    km_update_entry["expected_launches"] = km_update["launches"][
        "kmeans_assign_accumulate"]
    km_train_entry["expected_launches"] = KM_ITERATIONS + 1
    for e, counts in ([(e, als_shape_launches) for e in entries]
                      + [(km_update_entry, km_update["shape_launches"]),
                         (km_train_entry, km_train["timed"]["shape_launches"])]):
        e["launches"] = counts.get(e.pop("launch_key"), 0)
        e["on_main_path"] = e["launches"] > 0
        want = e.pop("expected_launches")
        check(e["launches"] == want, f"{e['name']}: {e['launches']} launches "
              f"at its shape on its path, expected {want}")
        if "reduce_launch_key" in e:
            e["reduce_launches"] = counts.get(e.pop("reduce_launch_key"), 0)
            want = e.pop("expected_reduce_launches")
            check(e["reduce_launches"] == want,
                  f"{e['name']}: {e['reduce_launches']} reduce launches at "
                  f"its shape on its path, expected {want}")
    entries.extend(km_entries)
    for source in {e["source"] for e in entries}:
        check(any(e["on_main_path"] for e in entries if e["source"] == source),
              f"{source}: not launched on its path")
    # each later path's own launch counts, read just after it ran
    paths = {
        "als_generation": {w: generation["launches"][w] for w in ALS_WRAPPERS},
        "kmeans_generation": {"kmeans_assign_accumulate":
                              km_update["generation"]["launches"]},
        "als_speed": speed["launches"],
    }
    # each later path's launches held against the plain versions, one
    # record per shape the path launched at
    path_checks = {
        "als_generation": generation["held_against_plain"],
        "kmeans_generation": km_update["generation"]["held_against_plain"],
    }
    print(json.dumps({"kernels": entries, "paths": paths,
                      "path_checks": path_checks, "gpu": smi}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
