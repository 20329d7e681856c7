"""ALS training on one CUDA card: slot-padded block normal equations.

The port of the reference's ``models/als/train.py`` (single device):

  * implicit feedback à la Hu/Koren/Volinsky (confidence c = 1 + α·|r|,
    preference p = 1 if r > 0 else 0) or explicit ALS-WR, with λ·n_u
    regularisation scaling (MLlib semantics);
  * the host pack is the reference's numpy code, bit for bit: interactions
    sorted by (row, col) and packed into fixed-width slots of T entries
    (a row with d interactions spans ceil(d/T) slots), grouped into row
    blocks of B rows padded to one slot count S per block. Only the last
    step differs: the slabs become torch tensors on the target device;
  * one block solve gathers the opposite factors per slot, forms the
    per-row Gramians and right-hand sides, regularises, and solves the
    (B, k, k) batch. On the card both steps are hand-written kernels
    (:mod:`oryx_tpu_torch.ops.kernels`): the fused gather-Gramian and the
    Gauss-Jordan SPD solve. Off the card the same calls run their plain
    PyTorch versions; the unfused path (chunked einsum + ``index_add_``)
    and the Cholesky solve remain for explicit ``fused_gramian=False`` /
    ``spd_kernel=False`` and for k past the kernels' gates.

Float32 products on the card run in full float32, never TF32
(:func:`oryx_tpu_torch.common.device.resolve`). Mesh training, the
layout cache and checkpointing are not ported yet.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from oryx_tpu_torch.common import rand
from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.models.als.data import RatingBatch
from oryx_tpu_torch.ops.kernels import (
    GatherGramianSchedule,
    gather_gramian_accumulate,
    gather_gramian_schedule,
    gather_gramian_supported,
    slot_gramians,
    spd_solve_batched,
    spd_solve_cholesky,
)

log = logging.getLogger(__name__)

# Budgets (in f32 elements) bounding the two big transients: the per-block
# Gramian carry (B+1, k, k) and the per-chunk gather/Gramian buffers
# (Sc, T, k) + (Sc, k, k).
_BLOCK_ELEM_BUDGET = 1 << 26  # 256 MB carry
_CHUNK_ELEM_BUDGET = 1 << 24  # 64 MB transient

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _auto_block(features: int) -> int:
    return max(512, min(8192, _BLOCK_ELEM_BUDGET // (features * features)))


def _auto_slot_chunk(features: int, slot_width: int) -> int:
    per_slot = max(slot_width * features, features * features)
    return max(64, min(8192, _CHUNK_ELEM_BUDGET // per_slot))


def _auto_slot_width(nnz: int, n_nonempty_rows: int) -> int:
    """Slot width T ≈ mean row degree, as a power of two in [8, 512]."""
    mean = nnz / max(1, n_nonempty_rows)
    t = 1 << max(0, math.ceil(math.log2(max(1.0, mean))))
    return max(8, min(512, t))


@dataclass
class _BlockedSide:
    """Device-resident slotted COO for one half-iteration.

    ``srows`` holds block-LOCAL row indices in [0, block]; ``block`` is the
    spill row (slot padding). Each block's slots are the contiguous
    row-sorted run of the global slot list that falls in its row range,
    right-padded to the uniform count S (a multiple of the slot chunk).
    ``gg_schedules`` holds each block's gather-Gramian work units, built
    with the pack because ``srows`` and ``slens`` never change.
    """

    srows: torch.Tensor  # (n_blocks, S) int32, pad = block
    scols: torch.Tensor  # (n_blocks, S, T) int32
    svals: torch.Tensor  # (n_blocks, S, T) float32
    slens: torch.Tensor  # (n_blocks, S) int32 valid entries per slot (0 = pad)
    n_rows: int
    block: int
    n_blocks: int
    slot_width: int
    slot_chunk: int
    gg_schedules: "list[GatherGramianSchedule]"

    @property
    def padded_rows(self) -> int:
        return self.n_blocks * self.block


def _pack_workers(workers: "int | None", nnz: int) -> int:
    """Worker count for the host-side pack scatters: explicit wins; small
    packs stay serial; big packs use up to 8 host cores."""
    if workers is not None:
        return max(1, workers)
    if nnz < 2_000_000:
        return 1
    return max(1, min(8, os.cpu_count() or 1))


def _chunked_scatter(fn, n: int, workers: int, chunk: int = 1_000_000) -> None:
    """Run ``fn(lo, hi)`` over [0, n) — serially, or chunked across a thread
    pool. Every (lo, hi) slice writes DISJOINT output cells."""
    if workers <= 1 or n <= chunk:
        fn(0, n)
        return
    step = max(chunk, -(-n // (workers * 4)))  # ~4 chunks per worker
    with cf.ThreadPoolExecutor(workers) as pool:
        futs = [
            pool.submit(fn, lo, min(n, lo + step)) for lo in range(0, n, step)
        ]
        for f in futs:
            f.result()


def _padded_rows_for(n_rows: int, block: int, n_block_multiple: int = 1) -> int:
    """Rows after block padding — exactly make_blocked_side's computation,
    callable before the pack so the first factor buffer can be allocated
    while the side is still packing."""
    n_blocks = max(1, -(-n_rows // block))
    n_blocks = -(-n_blocks // n_block_multiple) * n_block_multiple
    return n_blocks * block


def _layout_params(deg: np.ndarray, nnz: int, slot_chunk: "int | None",
                   slot_width: "int | None", block: int,
                   features: "int | None") -> tuple:
    """Slot-layout shape parameters from a degree histogram."""
    if slot_width is None:
        slot_width = _auto_slot_width(nnz, int(np.count_nonzero(deg)))
    t = slot_width
    budget_max = _auto_slot_chunk(features or 32, t)
    slot_chunk = budget_max if slot_chunk is None else max(
        16, min(slot_chunk, budget_max)
    )
    nslots_row = -(-deg // t)  # ceil; 0 slots for empty rows
    padded_rows = len(deg)
    row_slot_start = np.zeros(padded_rows + 1, dtype=np.int64)
    np.cumsum(nslots_row, out=row_slot_start[1:])
    total_slots = int(row_slot_start[-1])
    bounds = row_slot_start[::block]  # (n_blocks + 1,)
    max_s = int(np.diff(bounds).max()) if total_slots else 0
    n_chunks = max(1, -(-max(max_s, 1) // slot_chunk))
    slot_chunk = max(16, -(-max(max_s, 1) // n_chunks))
    s_len = n_chunks * slot_chunk
    return t, slot_chunk, s_len, nslots_row, row_slot_start, bounds, total_slots


def make_blocked_side(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    block: int,
    slot_chunk: int | None,
    slot_width: int | None,
    n_block_multiple: int = 1,
    features: int | None = None,
    workers: int | None = None,
    device=None,
) -> _BlockedSide:
    """Host-side slotted-COO construction (row-sorted → contiguous slots),
    the reference's numpy pack; the slabs end up on ``device``.

    ``slot_width=None`` picks T from the side's mean row degree;
    ``slot_chunk=None`` then sizes the scan chunk from T and ``features``
    to stay inside the transient budget."""
    dev = resolve(device)
    # sort by (row, col): row-major for contiguous slots, column-ascending
    # within each row so the per-slot gathers walk the factors in address
    # order. One stable argsort on a fused int64 key
    if len(rows):
        span = np.int64(cols.max()) + 1
        key = rows.astype(np.int64) * span + cols
        order = np.argsort(key, kind="stable")
    else:
        order = np.arange(0)
    r = rows[order].astype(np.int64)
    c = cols[order].astype(np.int32)
    v = vals[order].astype(np.float32)
    padded_rows = _padded_rows_for(n_rows, block, n_block_multiple)
    n_blocks = padded_rows // block
    n_workers = _pack_workers(workers, len(r))

    deg = np.bincount(r, minlength=padded_rows) if len(r) else np.zeros(
        padded_rows, dtype=np.int64
    )
    (t, slot_chunk, s_len, nslots_row, row_slot_start, bounds,
     total_slots) = _layout_params(deg, len(r), slot_chunk, slot_width,
                                   block, features)
    row_entry_start = np.zeros(padded_rows + 1, dtype=np.int64)
    np.cumsum(deg, out=row_entry_start[1:])

    # uneven block slot counts pad every block to the fullest one; surface
    # a pathological ratio rather than hiding it
    if len(r) and n_blocks > 1:
        pad_ratio = s_len * t * n_blocks / max(1, len(r))
        if pad_ratio > 6.0:
            log.warning(
                "slotted COO padding ratio %.1fx (T=%d, S=%d x %d blocks vs "
                "%d nnz): row-skewed data; consider a smaller block size",
                pad_ratio, t, s_len, n_blocks, len(r),
            )

    srows = np.full((n_blocks, s_len), block, dtype=np.int32)
    scols = np.zeros((n_blocks, s_len, t), dtype=np.int32)
    svals = np.zeros((n_blocks, s_len, t), dtype=np.float32)
    slens = np.zeros((n_blocks, s_len), dtype=np.int32)
    if total_slots:
        # per-slot coordinates: owning row, block, and index within block
        srow_f = np.repeat(np.arange(padded_rows, dtype=np.int64), nslots_row)
        sb = (srow_f // block).astype(np.int32)
        sidx = (np.arange(total_slots, dtype=np.int64) - bounds[sb]).astype(np.int32)
        # valid entries per slot straight from the degree histogram: a row's
        # slots carry T, T, ..., remainder
        slot_in_row = np.arange(total_slots, dtype=np.int64) - row_slot_start[srow_f]
        srows[sb, sidx] = (srow_f % block).astype(np.int32)
        slens[sb, sidx] = np.minimum(
            deg[srow_f] - slot_in_row * t, t
        ).astype(np.int32)
        del slot_in_row
        if len(r):
            # per-entry final coordinates — each entry owns one distinct
            # (block, slot, pos) cell, so the scatter chunks cleanly across
            # the worker pool; intermediates are freed eagerly
            p = np.arange(len(r), dtype=np.int64) - row_entry_start[r]
            slot = row_slot_start[r] + p // t
            pos = (p % t).astype(np.int32)
            del p
            eb = (r // block).astype(np.int32)
            es = (slot - bounds[eb]).astype(np.int32)
            del slot

            def scatter(lo: int, hi: int) -> None:
                scols[eb[lo:hi], es[lo:hi], pos[lo:hi]] = c[lo:hi]
                svals[eb[lo:hi], es[lo:hi], pos[lo:hi]] = v[lo:hi]

            _chunked_scatter(scatter, len(r), n_workers)
            del eb, es, pos
    schedules = [
        gather_gramian_schedule(torch.from_numpy(srows[i]),
                                torch.from_numpy(slens[i]), block=block,
                                slot_width=t, device=dev)
        for i in range(n_blocks)
    ]
    return _BlockedSide(
        *(torch.from_numpy(a).to(dev) for a in (srows, scols, svals, slens)),
        n_rows, block, n_blocks, t, slot_chunk, schedules,
    )


def _entry_weights(svals, slens, alpha, implicit, t):
    """Per-entry Gramian weight ``w`` and RHS coefficient ``coef`` (both
    masked to the slot's valid length): the confidence algebra of implicit
    feedback, or plain masking for explicit. Shared by the fused and the
    unfused paths so they can only differ in accumulation order."""
    m = (torch.arange(t, device=svals.device)[None, :]
         < slens[..., None]).float()
    if implicit:
        w = alpha * svals.abs() * m  # confidence - 1
        coef = (1.0 + w) * (svals > 0).float() * m
    else:
        w = m
        coef = svals * m
    return w, coef


def _normal_equations(y, srow, scols, svals, slens, *, block, features, lam,
                      alpha, implicit, slot_chunk, yty, fused_gramian,
                      schedule):
    """One row block's regularised normal equations against fixed factors
    ``y`` (already in the compute dtype): ``(A (block, k, k), b (block, k),
    cnt (block,))`` with ALS-WR regularisation, ``YᵀY`` for implicit
    feedback and the 1e-6·I shift, as the reference's ``_solve_block``
    assembles them.

    ``fused_gramian`` routes the accumulation through
    :func:`gather_gramian_accumulate` (the kernel on the card, with the
    block's ``schedule``); otherwise the
    block's slots are scanned in chunks of ``slot_chunk`` (einsum +
    ``index_add_``), bounding the transient to O(slot_chunk·T·k)."""
    k = features
    t = scols.shape[-1]
    dev = y.device
    idx = srow.long()
    if fused_gramian:
        w, coef = _entry_weights(svals, slens, alpha, implicit, t)
        big_a, big_b = gather_gramian_accumulate(
            y, srow, scols, w, coef, slens, block=block, schedule=schedule
        )
    else:
        big_a = torch.zeros((block + 1, k, k), device=dev, dtype=torch.float32)
        big_b = torch.zeros((block + 1, k), device=dev, dtype=torch.float32)
        for lo in range(0, srow.shape[0], slot_chunk):
            hi = lo + slot_chunk
            w, coef = _entry_weights(svals[lo:hi], slens[lo:hi], alpha,
                                     implicit, t)
            ga, gb = slot_gramians(y, scols[lo:hi], w, coef)
            big_a.index_add_(0, idx[lo:hi], ga)
            big_b.index_add_(0, idx[lo:hi], gb)
    cnt = torch.zeros(block + 1, device=dev, dtype=torch.float32).index_add_(
        0, idx, slens.float()
    )
    big_a, big_b, cnt = big_a[:block], big_b[:block], cnt[:block]

    # ALS-WR regularization scaling by interaction count (MLlib semantics).
    # In place on the fresh accumulators, and on the diagonal only: the
    # reference's `+ reg·I` then `+ 1e-6·I` add exact zeros off it, so this
    # is the same arithmetic with one (block, k, k) pass instead of three
    reg = lam * torch.clamp(cnt, min=1.0)
    if implicit:
        big_a += yty[None, :, :]
    diag = big_a.diagonal(dim1=1, dim2=2)
    diag += reg[:, None]
    diag += 1e-6
    return big_a, big_b, cnt


def _solve_block(y, srow, scols, svals, slens, *, block, features, lam, alpha,
                 implicit, slot_chunk, yty, spd_kernel, fused_gramian,
                 schedule):
    """Solve one row block's factors (block, k) against fixed ``y``; rows
    with no interactions get zero factors (reference: absent IDs)."""
    big_a, big_b, cnt = _normal_equations(
        y, srow, scols, svals, slens, block=block, features=features,
        lam=lam, alpha=alpha, implicit=implicit, slot_chunk=slot_chunk,
        yty=yty, fused_gramian=fused_gramian, schedule=schedule,
    )
    if spd_kernel:
        x = spd_solve_batched(big_a, big_b)
    else:
        x = spd_solve_cholesky(big_a, big_b)
    return torch.where((cnt > 0)[:, None], x, 0.0)


def _resolve_paths(y, features: int, spd_kernel, fused_gramian):
    """The kernel selection for one half-iteration: ``None`` means "the
    kernel on the card, the formulation without it elsewhere"; an explicit
    ``fused_gramian=True`` past the gather-Gramian gate downgrades loudly to
    the unfused path."""
    on_card = y.device.type == "cuda"
    spd = on_card if spd_kernel is None else bool(spd_kernel)
    fused = on_card if fused_gramian is None else bool(fused_gramian)
    if fused and not gather_gramian_supported(features):
        if fused_gramian:
            log.warning(
                "fused_gramian requested but features=%d exceeds the "
                "kernel's gate; using the unfused formulation", features,
            )
        fused = False
    return spd, fused


def solve_side_blocked(y, srows, scols, svals, slens, lam, alpha, *, block,
                       features, implicit, slot_chunk,
                       schedules: "list[GatherGramianSchedule]",
                       dtype="float32", spd_kernel: "bool | None" = None,
                       fused_gramian: "bool | None" = None):
    """One half-iteration on ``y``'s device: every row block in turn.
    ``schedules`` are the blocks' gather-Gramian work units
    (``_BlockedSide.gg_schedules``). Returns the (n_blocks·block, k)
    float32 factors of this side."""
    spd, fused = _resolve_paths(y, features, spd_kernel, fused_gramian)
    cd = _DTYPES[dtype]
    yty = (y.T @ y) if implicit else None  # (k, k) Gramian, float32
    ys = y.to(cd) if cd != y.dtype else y  # one cast, gathered per block
    out = [
        _solve_block(
            ys, srows[b], scols[b], svals[b], slens[b], block=block,
            features=features, lam=lam, alpha=alpha, implicit=implicit,
            slot_chunk=slot_chunk, yty=yty, spd_kernel=spd,
            fused_gramian=fused, schedule=schedules[b],
        )
        for b in range(srows.shape[0])
    ]
    return torch.cat(out).reshape(-1, features)


def _even_block(n_rows: int, features: int, ndev: int,
                block: "int | None") -> int:
    """Divide rows EVENLY across the block count the budget implies."""
    auto = _auto_block(features) if block is None else block
    n_blocks = max(1, -(-n_rows // max(32, min(auto, -(-n_rows // ndev)))))
    n_blocks = -(-n_blocks // ndev) * ndev
    return max(32, -(-n_rows // n_blocks))


def _side_packers(batch: RatingBatch, features: int, ndev: int, block_u: int,
                  block_i: int, chunk, slot_width, workers, device):
    """(pack_user, pack_item) closures."""
    n_users, n_items = len(batch.users), len(batch.items)

    def pack_user() -> _BlockedSide:
        return make_blocked_side(
            batch.rows, batch.cols, batch.vals, n_users, block_u, chunk,
            slot_width, ndev, features=features, workers=workers,
            device=device,
        )

    def pack_item() -> _BlockedSide:
        return make_blocked_side(
            batch.cols, batch.rows, batch.vals, n_items, block_i, chunk,
            slot_width, ndev, features=features, workers=workers,
            device=device,
        )

    return pack_user, pack_item


def prepare_blocked(
    batch: RatingBatch,
    features: int,
    block: int | None = None,
    chunk: int | None = None,
    slot_width: int | None = None,
    workers: int | None = None,
    device=None,
) -> tuple[_BlockedSide, _BlockedSide]:
    """Pack both half-iteration sides with production block/chunk sizing —
    the same layout :func:`als_train` builds. The two sides pack
    concurrently on big inputs."""
    dev = resolve(device)
    block_u = _even_block(len(batch.users), features, 1, block)
    block_i = _even_block(len(batch.items), features, 1, block)
    pack_user, pack_item = _side_packers(
        batch, features, 1, block_u, block_i, chunk, slot_width, workers, dev,
    )
    if _pack_workers(workers, len(batch.rows)) > 1:
        with cf.ThreadPoolExecutor(2) as pool:
            fu, fi = pool.submit(pack_user), pool.submit(pack_item)
            return fu.result(), fi.result()
    return pack_user(), pack_item()


def init_item_factors(padded_rows: int, n_items: int, features: int,
                      generator: "torch.Generator | None" = None,
                      device=None) -> torch.Tensor:
    """Random Y₀ in the padded factor buffer: 0.1·N(0, 1), the reference's
    distribution (not its bits: ``jax.random`` streams differ from
    torch's). Padding rows stay zero; gathers never read them."""
    dev = resolve(device)
    g = generator if generator is not None else rand.torch_generator()
    y0 = 0.1 * torch.randn((n_items, features), generator=g,
                           dtype=torch.float32)
    y = torch.zeros((padded_rows, features), device=dev, dtype=torch.float32)
    y[:n_items] = y0.to(dev)
    return y


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def als_train(
    batch: RatingBatch,
    features: int,
    lam: float,
    alpha: float,
    implicit: bool,
    iterations: int = 10,
    *,
    generator: "torch.Generator | None" = None,
    init_y=None,
    chunk: int | None = None,
    block: int | None = None,
    slot_width: int | None = None,
    dtype: str = "float32",
    fused_gramian: "bool | None" = None,
    spd_kernel: "bool | None" = None,
    timings: "dict | None" = None,
    device=None,
    mesh=None,
    row_axis: str | None = None,
    layout_cache=None,
    checkpointer=None,
):
    """Full alternating optimisation on one device; returns (X, Y) as
    float32 tensors of exact shape (n_users, k), (n_items, k).

    ``dtype`` sets the Gramian INPUT precision ("bfloat16" halves the
    gather bytes; accumulation and solves stay float32). ``init_y``
    (numpy or tensor with at least ``n_items`` rows) replaces the random
    Y₀, so a test can start from the reference's own initial factors;
    otherwise Y₀ comes from ``generator``.

    **Pack/compute overlap**: the item side packs on a worker thread while
    the user side packs on the calling thread, and the first user
    half-iteration is queued on the device before the item pack is awaited.
    ``timings``, when a dict is passed, receives ``pack_s`` (pack time on
    the critical path), ``pack_user_s``/``pack_item_s``/``pack_wait_s``,
    and ``iter_s``, the seconds of each iteration (measured by
    synchronising the device at iteration ends, which only a timed call
    does; the first also holds whatever of the item pack it waited for).

    ``mesh``, ``row_axis``, ``layout_cache`` and ``checkpointer`` are the
    reference's multi-device, layout-reuse and checkpoint arguments; the
    port does not support them yet and raises if one is given.
    """
    for name, value in (("mesh", mesh), ("row_axis", row_axis),
                        ("layout_cache", layout_cache),
                        ("checkpointer", checkpointer)):
        if value is not None:
            raise NotImplementedError(
                f"als_train: {name} is not supported by the port yet")
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1, got {iterations}")
    if dtype not in _DTYPES:
        raise ValueError(
            f"compute dtype must be 'float32' or 'bfloat16', got {dtype!r}"
        )
    dev = resolve(device)

    n_users, n_items = len(batch.users), len(batch.items)
    k = features
    block_u = _even_block(n_users, k, 1, block)
    block_i = _even_block(n_items, k, 1, block)
    pack_user, pack_item = _side_packers(
        batch, k, 1, block_u, block_i, chunk, slot_width, None, dev,
    )
    pool = cf.ThreadPoolExecutor(1, thread_name_prefix="oryx-als-pack")
    item_timing: dict = {}

    def timed_pack_item() -> _BlockedSide:
        t0 = time.perf_counter()
        side = pack_item()
        item_timing["s"] = time.perf_counter() - t0
        return side

    # everything past the submit sits under the finally: a user-pack or
    # factor-init failure must still join the pack worker
    try:
        item_fut = pool.submit(timed_pack_item)
        t0 = time.perf_counter()
        user_side = pack_user()
        pack_user_s = time.perf_counter() - t0

        # Y₀ needs only the item side's PADDED SHAPE: the first user
        # half-iteration must not wait on the item pack
        padded_i = _padded_rows_for(n_items, block_i)
        if init_y is not None:
            y0 = torch.as_tensor(init_y, dtype=torch.float32)[:n_items]
            if y0.shape != (n_items, k):
                raise ValueError(
                    f"init_y must have at least {n_items} rows of {k} "
                    f"features, got {tuple(y0.shape)}")
            y = torch.zeros((padded_i, k), device=dev, dtype=torch.float32)
            y[:n_items] = y0.to(dev)
        else:
            y = init_item_factors(padded_i, n_items, k, generator, dev)

        def solve(side, opp):
            return solve_side_blocked(
                opp, side.srows, side.scols, side.svals, side.slens, lam,
                alpha, block=side.block, features=k, implicit=implicit,
                slot_chunk=side.slot_chunk, dtype=dtype,
                spd_kernel=spd_kernel, fused_gramian=fused_gramian,
                schedules=side.gg_schedules,
            )

        iter_s = []
        t_iter = time.perf_counter()
        x = solve(user_side, y)  # queued while the item side still packs
        t1 = time.perf_counter()
        item_side = item_fut.result()
        wait_s = time.perf_counter() - t1
        y = solve(item_side, x)
        for it in range(iterations):
            if it:
                x = solve(user_side, y)
                y = solve(item_side, x)
            if timings is not None:
                _sync(dev)
                now = time.perf_counter()
                iter_s.append(now - t_iter)
                t_iter = now
        if timings is not None:
            timings["pack_user_s"] = pack_user_s
            timings["pack_item_s"] = item_timing.get("s", 0.0)
            timings["pack_wait_s"] = wait_s
            # pack cost on the critical path: the user pack plus however
            # much of the item pack the first user half did not hide
            timings["pack_s"] = pack_user_s + wait_s
            timings["iter_s"] = iter_s
        return x[:n_users], y[:n_items]
    finally:
        # JOIN the worker on every exit: an orphaned item pack must not
        # outlive this call
        pool.shutdown(wait=True, cancel_futures=True)
