"""ALS training on the card: slot-padded block normal equations.

The port of the reference's ``models/als/train.py``:

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

Across generations, :class:`BlockedLayoutCache` reuses the previous
generation's packed sides (``reused``) or repacks only the blocks that
appended entries touched (``delta``), bit-identical to a full pack; and
``als_train(checkpointer=...)`` saves the factors every interval and
resumes from the newest valid checkpoint (:mod:`oryx_tpu_torch.common.
checkpoint`). Both are the reference's. Each half-iteration that runs
records one call of ``als.train.user_half`` / ``als.train.item_half`` into
the device cost accounting (:mod:`oryx_tpu_torch.common.profiling`), at the
analytic cost of :func:`half_cost`, as the reference does.

With ``mesh`` and ``row_axis`` (the reference's ``shard_map`` half-
iteration, ``_sharded_solver``) the row blocks split evenly over the mesh
axis: at each half-iteration the opposite factor is gathered and copied to
every shard's device (the reference's replicated operand, about N·k·4
bytes a shard a half), and each shard solves its own blocks on its device,
so each shard launches the gather-Gramian and SPD kernels for its blocks.
The factors come back as :class:`~oryx_tpu_torch.parallel.mesh.
ShardedRows`, padded to the block boundary with zero rows.

Float32 products on the card run in full float32, never TF32
(:func:`oryx_tpu_torch.common.device.resolve`).
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import math
import os
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from oryx_tpu_torch.common import profiling
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
from oryx_tpu_torch.parallel.mesh import ShardedRows, replicated, shard_rows

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
    # host masters (srows, scols, svals, slens as numpy), kept only when a
    # BlockedLayoutCache owns the side so the next generation can repack an
    # incremental delta instead of the whole batch. Never written in place:
    # the delta path copies before writing (on the CPU the slabs above
    # alias these arrays, as torch.from_numpy does)
    np_slabs: "tuple | None" = None

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
    keep_np: bool = False,
    device=None,
) -> _BlockedSide:
    """Host-side slotted-COO construction (row-sorted → contiguous slots),
    the reference's numpy pack; the slabs end up on ``device``.

    ``slot_width=None`` picks T from the side's mean row degree;
    ``slot_chunk=None`` then sizes the scan chunk from T and ``features``
    to stay inside the transient budget. ``keep_np`` keeps the host slabs
    on the side (``np_slabs``) for a later incremental repack."""
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
    return _side_from_slabs((srows, scols, svals, slens), n_rows, block, t,
                            slot_chunk, dev, keep_np)


def _block_schedule(slabs: tuple, b: int, block: int, t: int,
                    dev) -> GatherGramianSchedule:
    """Block ``b``'s gather-Gramian work units from the host slabs."""
    srows, _, _, slens = slabs
    return gather_gramian_schedule(torch.from_numpy(srows[b]),
                                   torch.from_numpy(slens[b]), block=block,
                                   slot_width=t, device=dev)


def _side_from_slabs(slabs: tuple, n_rows: int, block: int, t: int,
                     slot_chunk: int, dev, keep_np: bool,
                     schedules: "list | None" = None) -> _BlockedSide:
    """The side of host slabs ``(srows, scols, svals, slens)``: the slabs
    on ``dev``, each block's schedule (built here unless given)."""
    n_blocks = slabs[0].shape[0]
    if schedules is None:
        schedules = [_block_schedule(slabs, b, block, t, dev)
                     for b in range(n_blocks)]
    return _BlockedSide(
        *(torch.from_numpy(a).to(dev) for a in slabs),
        n_rows, block, n_blocks, t, slot_chunk, schedules,
        np_slabs=slabs if keep_np else None,
    )


def _delta_blocked_side(
    old: _BlockedSide,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    block: int,
    slot_chunk: "int | None",
    slot_width: "int | None",
    n_block_multiple: int,
    features: "int | None",
    appended_rows: np.ndarray,
    device=None,
) -> "_BlockedSide | None":
    """Incremental repack: ``rows/cols/vals`` extend the cached side's
    batch by entries touching ``appended_rows`` (wherever they sit in the
    arrays — mid-array for the production row-sorted pipeline, the tail
    for a raw concatenation). Only the BLOCKS those rows live in re-sort
    and re-scatter, and only their gather-Gramian schedules are rebuilt
    (all of them when S grew); every other block's slabs and schedule
    carry over (their within-block slot layout depends only on their own
    rows' degrees). Returns None when the layout geometry drifted — block
    count, slot width, chunk, or a shrunk S — and a full pack is required.
    The result, slabs and schedules, is bit-identical to a from-scratch
    pack of the full batch: the global sort is stable on the (row, col)
    key, and an affected block's entries keep their original relative
    order whether sorted globally or alone. The host pack is the
    reference's; the slabs end up on ``device``."""
    if old.np_slabs is None:
        return None
    dev = resolve(device)
    padded_rows = _padded_rows_for(n_rows, block, n_block_multiple)
    n_blocks = padded_rows // block
    if n_blocks != old.n_blocks or block != old.block:
        return None
    deg = np.bincount(rows.astype(np.int64), minlength=padded_rows)
    (t, chunk, s_len, nslots_row, row_slot_start, bounds,
     total_slots) = _layout_params(deg, len(rows), slot_chunk, slot_width,
                                   block, features)
    old_s = old.np_slabs[0].shape[1]
    if t != old.slot_width or s_len < old_s:
        return None

    affected = np.unique(appended_rows // block).astype(np.int64)
    o_srows, o_scols, o_svals, o_slens = old.np_slabs
    pad_s = s_len - old_s
    if pad_s:
        # S grew: right-pad every block with empty slots — exactly the fill
        # a full pack leaves there (owner = spill row, zeros elsewhere)
        srows = np.full((n_blocks, s_len), block, dtype=np.int32)
        srows[:, :old_s] = o_srows
        scols = np.zeros((n_blocks, s_len, t), dtype=np.int32)
        scols[:, :old_s] = o_scols
        svals = np.zeros((n_blocks, s_len, t), dtype=np.float32)
        svals[:, :old_s] = o_svals
        slens = np.zeros((n_blocks, s_len), dtype=np.int32)
        slens[:, :old_s] = o_slens
    else:
        srows, scols = o_srows.copy(), o_scols.copy()
        svals, slens = o_svals.copy(), o_slens.copy()

    # re-derive the affected blocks from scratch: all of their entries (old
    # + appended) re-sort and re-scatter — the stable (row, col) sort of a
    # block's own entries is independent of every other block's
    srows[affected] = block
    scols[affected] = 0
    svals[affected] = 0
    slens[affected] = 0
    sel = np.flatnonzero(np.isin(rows // block, affected))
    if len(sel):
        r_all, c_all, v_all = rows[sel], cols[sel], vals[sel]
        span = np.int64(c_all.max()) + 1
        order = np.argsort(r_all.astype(np.int64) * span + c_all,
                           kind="stable")
        rr = r_all[order].astype(np.int64)
        cc = c_all[order].astype(np.int32)
        vv = v_all[order].astype(np.float32)
        # rank of each entry within its (col-sorted) row group: sel holds
        # every entry of each affected block, so group ranks equal the full
        # pack's per-row entry positions
        p = _slot_rank(rr)
        slot = row_slot_start[rr] + p // t
        pos = (p % t).astype(np.int32)
        eb = (rr // block).astype(np.int32)
        es = (slot - bounds[eb]).astype(np.int32)
        scols[eb, es, pos] = cc
        svals[eb, es, pos] = vv
        # per-slot owner rows + valid lengths for the affected rows
        arows = np.unique(rr)
        srow_f = np.repeat(arows, nslots_row[arows])
        sb = (srow_f // block).astype(np.int32)
        slot_in_row = _slot_rank(srow_f)
        sidx = (row_slot_start[srow_f]
                + slot_in_row - bounds[sb]).astype(np.int32)
        srows[sb, sidx] = (srow_f % block).astype(np.int32)
        slens[sb, sidx] = np.minimum(
            deg[srow_f] - slot_in_row * t, t
        ).astype(np.int32)
    slabs = (srows, scols, svals, slens)
    schedules = None  # S grew: every block's schedule is rebuilt
    if not pad_s:
        schedules = list(old.gg_schedules)
        for b in affected:
            schedules[b] = _block_schedule(slabs, int(b), block, t, dev)
    return _side_from_slabs(slabs, n_rows, block, t, chunk, dev, True,
                            schedules)


def _slot_rank(srow_f: np.ndarray) -> np.ndarray:
    """Rank of each element within its contiguous run of equal values
    (0, 1, ... per run) — per-row slot ranks when fed owner-rows-per-slot,
    per-row entry ranks when fed row-sorted entry rows."""
    grp = np.flatnonzero(np.r_[True, srow_f[1:] != srow_f[:-1]])
    return np.arange(len(srow_f), dtype=np.int64) - np.repeat(
        grp, np.diff(np.r_[grp, len(srow_f)])
    )


class BlockedLayoutCache:
    """Slotted-layout reuse across model generations (one per trainer).

    Successive batch-tier generations mostly extend the previous batch,
    and a full host pack re-sorts and re-scatters entries whose layout has
    not moved. This cache keys on the previous generation's COO arrays per
    side and picks the cheapest correct path:

      * ``reused`` — arrays identical: hand back the SAME side (zero host
        work, zero upload, the same schedules);
      * ``delta`` — the new arrays extend the old (exact prefix, OR the
        production shape: row-sorted with each row's old entries a prefix
        of its new ones — what ``build_rating_batch``'s stable row sort
        over the insertion-ordered aggregation dict emits) AND the layout
        geometry held: only the blocks the appended entries touch re-sort,
        re-scatter and get new schedules (:func:`_delta_blocked_side`);
      * ``full`` — anything else (changed historical values — new events
        aggregated into an existing pair, or time decay rewriting
        strengths — a new id sorting mid-order and renumbering an axis,
        different geometry or device, shrunk batch): full pack.

    Results are bit-identical to a from-scratch pack in every mode,
    schedules included (``tests/test_torch_checkpoint.py``). Cost: between
    generations the cache retains the previous COO triple and host slab
    copies AND pins the cached side's DEVICE slabs and schedules; during a
    delta the old and new device slabs coexist. Drop the cache object to
    reclaim everything. Not thread-safe; the batch tier packs one
    generation at a time."""

    def __init__(self):
        self._arrays: "tuple | None" = None  # canonical (rows, cols, vals)
        self._sides: dict = {}  # name -> (side, params)
        self.last_modes: dict = {}

    def match_extension(self, rows, cols, vals) -> "np.ndarray | None":
        """Indices (into the new arrays) of the entries APPENDED since the
        cached generation, or None when the new batch does not extend it.

        Two shapes match. (1) Exact prefix — the new arrays literally start
        with the old ones (how a raw log append looks). (2) Row-wise
        extension — both generations row-sorted with each row's old entries
        forming a prefix of its new entries, which is exactly what the
        production pipeline produces: ``build_rating_batch`` stable-sorts
        by row, and the aggregation dict keeps first-seen (user, item)
        pairs ahead of newly seen ones within every row. A pair whose
        VALUE changed (new events aggregated in, or time decay rewriting
        history) fails the compare and falls back to a full pack.

        One check against the CANONICAL batch triple covers both sides —
        the item side's swapped (cols, rows, vals) view extends iff the
        batch does (membership is per-entry, not per-ordering)."""
        if self._arrays is None:
            return None
        o_r, o_c, o_v = self._arrays
        n_old = len(o_r)
        if len(rows) < n_old:
            return None
        if (np.array_equal(o_r, rows[:n_old])
                and np.array_equal(o_c, cols[:n_old])
                and np.array_equal(o_v, vals[:n_old])):
            return np.arange(n_old, len(rows), dtype=np.int64)
        if n_old == 0 or np.any(np.diff(rows) < 0) or np.any(np.diff(o_r) < 0):
            return None
        nr = int(max(rows[-1], o_r[-1])) + 1
        deg_new = np.bincount(rows, minlength=nr)
        deg_old = np.bincount(o_r, minlength=nr)
        if np.any(deg_old > deg_new):
            return None
        new_start = np.zeros(nr + 1, dtype=np.int64)
        np.cumsum(deg_new, out=new_start[1:])
        old_start = np.zeros(nr + 1, dtype=np.int64)
        np.cumsum(deg_old, out=old_start[1:])
        # position of each old entry inside the new arrays: its row's new
        # segment start plus its rank within the row (rows agree by
        # construction once the degree test passed)
        idx = new_start[o_r] + (np.arange(n_old, dtype=np.int64)
                                - old_start[o_r])
        if not (np.array_equal(cols[idx], o_c)
                and np.array_equal(vals[idx], o_v)):
            return None
        appended = np.ones(len(rows), dtype=bool)
        appended[idx] = False
        return np.flatnonzero(appended)

    def side(self, name: str, rows, cols, vals, n_rows, block, slot_chunk,
             slot_width, n_block_multiple=1, features=None, workers=None,
             appended_idx: "np.ndarray | None" = None,
             device=None) -> _BlockedSide:
        """Pack one side on ``device``, reusing the cached layout when
        ``appended_idx`` (from :meth:`match_extension`) says the arrays
        extend the cached batch. ``rows`` is THIS side's row view, so
        ``rows[appended_idx]`` are the rows the appended entries touch on
        this side."""
        dev = resolve(device)
        # "cuda" and "cuda:0" are one card: key the layout by the index
        where = (dev.type, torch.cuda.current_device()
                 if dev.type == "cuda" and dev.index is None else dev.index)
        params = (block, slot_chunk, slot_width, n_block_multiple, features,
                  where)
        cached = self._sides.get(name)
        old, old_params = cached if cached is not None else (None, None)
        if old is not None and old_params == params \
                and appended_idx is not None:
            if appended_idx.size == 0 and old.n_rows == n_rows:
                self.last_modes[name] = "reused"
                return old
            side = _delta_blocked_side(
                old, rows, cols, vals, n_rows, block, slot_chunk,
                slot_width, n_block_multiple, features,
                rows[appended_idx], device=dev,
            )
            if side is not None:
                self.last_modes[name] = "delta"
                self._sides[name] = (side, params)
                return side
        side = make_blocked_side(
            rows, cols, vals, n_rows, block, slot_chunk, slot_width,
            n_block_multiple, features=features, workers=workers,
            keep_np=True, device=dev,
        )
        self.last_modes[name] = "full"
        self._sides[name] = (side, params)
        return side

    def store_batch(self, rows, cols, vals) -> None:
        """Pin the generation's canonical arrays AFTER both sides packed
        (the two sides share one COO, so the prefix test must see one
        snapshot). COPIES, not references: a caller that mutates its batch
        arrays in place (time decay rewriting ``vals``) and trains again
        would otherwise have ``match_extension`` compare the cached triple
        against itself and silently reuse pre-mutation slabs."""
        self._arrays = (rows.copy(), cols.copy(), vals.copy())

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


def shard_side(side: _BlockedSide, devices) -> list:
    """``side``'s row blocks split evenly over ``devices``: one
    ``(srows, scols, svals, slens, schedules)`` per shard, on its device.
    The block count must be a multiple of the shard count (the pack's
    ``n_block_multiple``)."""
    per = side.n_blocks // len(devices)
    if per * len(devices) != side.n_blocks:
        raise ValueError(f"{side.n_blocks} blocks do not split over "
                         f"{len(devices)} shards")
    out = []
    for s, d in enumerate(devices):
        lo, hi = s * per, (s + 1) * per
        slabs = tuple(a[lo:hi].to(d) for a in (side.srows, side.scols,
                                                 side.svals, side.slens))
        schedules = [replace(sc, work=sc.work.to(d), split=sc.split.to(d))
                     for sc in side.gg_schedules[lo:hi]]
        out.append((*slabs, schedules))
    return out


def solve_side_sharded(y, shards, devices, axis: str, lam, alpha, *, block,
                       features, implicit, slot_chunk, dtype="float32",
                       spd_kernel: "bool | None" = None,
                       fused_gramian: "bool | None" = None) -> ShardedRows:
    """One half-iteration over a mesh axis (the reference's
    ``_sharded_solver``): ``y`` (a tensor or :class:`ShardedRows`) is
    gathered and copied to every shard's device, then each shard of
    :func:`shard_side` solves its blocks there with
    :func:`solve_side_blocked`. Returns this side's factors row-sharded
    over ``axis``, shard ``i`` on ``devices[i]``."""
    full = y.full() if isinstance(y, ShardedRows) else y
    out = [
        solve_side_blocked(
            y_d, srows, scols, svals, slens, lam, alpha, block=block,
            features=features, implicit=implicit, slot_chunk=slot_chunk,
            schedules=schedules, dtype=dtype, spd_kernel=spd_kernel,
            fused_gramian=fused_gramian,
        )
        for y_d, (srows, scols, svals, slens, schedules)
        in zip(replicated(full, devices), shards)
    ]
    return ShardedRows(out, axis)


def _even_block(n_rows: int, features: int, ndev: int,
                block: "int | None") -> int:
    """Divide rows EVENLY across the block count the budget implies."""
    auto = _auto_block(features) if block is None else block
    n_blocks = max(1, -(-n_rows // max(32, min(auto, -(-n_rows // ndev)))))
    n_blocks = -(-n_blocks // ndev) * ndev
    return max(32, -(-n_rows // n_blocks))


def _side_packers(batch: RatingBatch, features: int, ndev: int, block_u: int,
                  block_i: int, chunk, slot_width, workers, device,
                  cache: "BlockedLayoutCache | None" = None):
    """(pack_user, pack_item) closures sharing one extension-match decision
    — computed HERE, before either thread starts, so concurrent side packs
    never race the cache's array comparison."""
    n_users, n_items = len(batch.users), len(batch.items)
    appended = cache.match_extension(batch.rows, batch.cols, batch.vals) \
        if cache is not None else None

    def pack_user() -> _BlockedSide:
        if cache is not None:
            return cache.side(
                "user", batch.rows, batch.cols, batch.vals, n_users, block_u,
                chunk, slot_width, ndev, features=features, workers=workers,
                appended_idx=appended, device=device,
            )
        return make_blocked_side(
            batch.rows, batch.cols, batch.vals, n_users, block_u, chunk,
            slot_width, ndev, features=features, workers=workers,
            device=device,
        )

    def pack_item() -> _BlockedSide:
        if cache is not None:
            return cache.side(
                "item", batch.cols, batch.rows, batch.vals, n_items, block_i,
                chunk, slot_width, ndev, features=features, workers=workers,
                appended_idx=appended, device=device,
            )
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
    cache: "BlockedLayoutCache | None" = None,
    device=None,
) -> tuple[_BlockedSide, _BlockedSide]:
    """Pack both half-iteration sides with production block/chunk sizing —
    the same layout :func:`als_train` builds. The two sides pack
    concurrently on big inputs. With a ``cache`` both sides go through it
    and the batch is pinned as its new generation (``cache.last_modes``
    says how each side was packed)."""
    dev = resolve(device)
    block_u = _even_block(len(batch.users), features, 1, block)
    block_i = _even_block(len(batch.items), features, 1, block)
    pack_user, pack_item = _side_packers(
        batch, features, 1, block_u, block_i, chunk, slot_width, workers, dev,
        cache,
    )
    if _pack_workers(workers, len(batch.rows)) > 1:
        with cf.ThreadPoolExecutor(2) as pool:
            fu, fi = pool.submit(pack_user), pool.submit(pack_item)
            sides = fu.result(), fi.result()
    else:
        sides = pack_user(), pack_item()
    if cache is not None:
        cache.store_batch(batch.rows, batch.cols, batch.vals)
    return sides


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


def _exact(factors, n_rows: int) -> torch.Tensor:
    """The first ``n_rows`` rows of a factor tensor or :class:`ShardedRows`."""
    if isinstance(factors, ShardedRows):
        factors = factors.full()
    return factors[:n_rows]


def _padded_shards(factors: torch.Tensor, padded_rows: int, mesh,
                   axis: str) -> ShardedRows:
    """``factors`` zero-padded to ``padded_rows`` rows (a multiple of the
    shard count) and row-sharded over ``mesh``'s ``axis``."""
    out = factors.new_zeros((padded_rows, factors.shape[1]))
    out[:factors.shape[0]] = factors
    return shard_rows(out, mesh, axis)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def half_cost(side: _BlockedSide, nnz: int, features: int,
              dtype: str) -> "tuple[float, float]":
    """Analytic (flops, bytes) of one half-iteration over ``side``: the
    reference's model (``_register_half_cost``) on the port's blocked
    layout — 2·nnz·k² Gramian + 2·nnz·k right-hand side +
    rows·(k³/3 + 2k²) solve FLOPs, and as bytes the slot-cell gather at the
    compute dtype plus the per-row Gramian and factor writes."""
    k = features
    rows = side.padded_rows
    flops = (2.0 * nnz * k * k + 2.0 * nnz * k
             + rows * (k ** 3 / 3.0 + 2.0 * k * k))
    gather_itemsize = 2.0 if dtype == "bfloat16" else 4.0
    bytes_ = (float(side.scols.numel()) * k * gather_itemsize
              + rows * k * (k + 1) * 4.0)
    return flops, bytes_


def _register_half_cost(key: str, side: _BlockedSide, nnz: int,
                        features: int, dtype: str) -> None:
    """The trainer's cost accounting (``common/profiling``): one program
    signature per half, registered from :func:`half_cost` once its side is
    packed; each half that runs records one call."""
    profiling.costs().register(key, *half_cost(side, nnz, features, dtype))


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
    layout_cache: "BlockedLayoutCache | None" = None,
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
    With a ``layout_cache`` a repeated or appended generation's pack
    collapses to a reuse or an incremental delta. ``timings``, when a dict
    is passed, receives ``pack_s`` (pack time on the critical path),
    ``pack_user_s``/``pack_item_s``/``pack_wait_s``, ``pack_modes`` (with
    a cache), ``iter_s``, the seconds of each iteration run (measured by
    synchronising the device at iteration ends, which only a timed call
    does; the first also holds whatever of the item pack it waited for),
    and ``blocks``, each side's row-block count (a kernel launch per block
    and half-iteration, on the card).

    **Preemption tolerance**: ``checkpointer`` (a
    :class:`oryx_tpu_torch.common.checkpoint.TrainerCheckpointer`) restores
    the newest valid factor state for its data fingerprint before Y₀ and
    saves ``{x, y}`` at exact size every interval (plus the final
    iteration), each save handed to a background writer. A restored
    checkpoint skips its completed iterations; a fully trained one returns
    its factors at once and launches no kernel. A checkpoint whose shapes
    differ trains from scratch with a warning. ``timings`` then also holds
    ``ckpt_wait_s`` (mid-train stall), ``ckpt_final_wait_s`` and
    ``ckpt_resumed_from``. Restore/save failures degrade to
    from-scratch/skipped — checkpointing never fails a train.

    With ``mesh`` and ``row_axis`` (a :class:`~oryx_tpu_torch.parallel.
    mesh.Mesh` and one of its axes; either alone is ignored, as in the
    reference) the block counts are multiples of the axis's shard count,
    each shard solves its blocks on its own device
    (:func:`solve_side_sharded`), and X and Y come back as
    :class:`ShardedRows` padded to the block boundary (``shape[0] =
    n_blocks·block``, the padding rows zero): consumers slice ``full()``.
    A fully trained checkpoint comes back the same way. ``device`` is then
    unused: the packs and the gathers live on the axis's first device, and
    ``timings`` also holds ``shards``, the shard count.
    """
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1, got {iterations}")
    if dtype not in _DTYPES:
        raise ValueError(
            f"compute dtype must be 'float32' or 'bfloat16', got {dtype!r}"
        )
    shard_devs = None
    if mesh is not None and row_axis is not None:
        shard_devs = mesh.axis_devices(row_axis)
        dev = resolve(shard_devs[0])
    else:
        dev = resolve(device)
    ndev = 1 if shard_devs is None else len(shard_devs)

    n_users, n_items = len(batch.users), len(batch.items)
    k = features
    block_u = _even_block(n_users, k, ndev, block)
    block_i = _even_block(n_items, k, ndev, block)
    pack_user, pack_item = _side_packers(
        batch, k, ndev, block_u, block_i, chunk, slot_width, None, dev,
        layout_cache,
    )
    pool = cf.ThreadPoolExecutor(1, thread_name_prefix="oryx-als-pack")
    item_timing: dict = {}

    def timed_pack_item() -> _BlockedSide:
        t0 = time.perf_counter()
        side = pack_item()
        item_timing["s"] = time.perf_counter() - t0
        return side

    def finish_item_pack() -> _BlockedSide:
        t1 = time.perf_counter()
        side = item_fut.result()
        wait_s = time.perf_counter() - t1
        _register_half_cost("als.train.item_half", side, batch.nnz, k, dtype)
        if layout_cache is not None:
            layout_cache.store_batch(batch.rows, batch.cols, batch.vals)
        if timings is not None:
            timings["pack_user_s"] = pack_user_s
            timings["pack_item_s"] = item_timing.get("s", 0.0)
            timings["pack_wait_s"] = wait_s
            # pack cost on the critical path: the user pack plus however
            # much of the item pack the first user half did not hide
            timings["pack_s"] = pack_user_s + wait_s
            timings["blocks"] = {"user": user_side.n_blocks,
                                 "item": side.n_blocks}
            if shard_devs is not None:
                timings["shards"] = ndev
            if layout_cache is not None:
                timings["pack_modes"] = dict(layout_cache.last_modes)
        return side

    def maybe_ckpt(completed: int, x, y) -> None:
        if checkpointer is None or not checkpointer.wants(completed,
                                                          iterations):
            return
        # exact-size slices: checkpoints are block-layout-agnostic, so a
        # resume survives a changed block or mesh geometry
        checkpointer.submit(completed, {"x": _exact(x, n_users),
                                        "y": _exact(y, n_items)})

    def finish_ckpt() -> None:
        if checkpointer is not None:
            checkpointer.finish()
            if timings is not None:
                # wait_s = mid-train joins only (the overlap evidence); the
                # final join mostly waits on the LAST iteration's device
                # compute, which a plain train pays too
                timings["ckpt_wait_s"] = checkpointer.wait_s
                timings["ckpt_final_wait_s"] = checkpointer.final_wait_s
                timings["ckpt_resumed_from"] = checkpointer.resumed_step

    # everything past the submit sits under the finally: a user-pack or
    # factor-init failure must still join the pack worker
    try:
        item_fut = pool.submit(timed_pack_item)
        t0 = time.perf_counter()
        user_side = pack_user()
        pack_user_s = time.perf_counter() - t0
        _register_half_cost("als.train.user_half", user_side, batch.nnz, k,
                            dtype)

        # resume: the newest valid checkpoint matching the data fingerprint
        # replaces Y₀ (and skips its completed iterations); shape drift —
        # a hyperparameter change that slipped past the fingerprint — falls
        # back to a fresh start, never a bad gather
        start_iter = 0
        restored = None
        if checkpointer is not None:
            ck = checkpointer.restore()
            if ck is not None:
                rx, ry = ck.arrays.get("x"), ck.arrays.get("y")
                if (rx is not None and ry is not None
                        and rx.shape == (n_users, k)
                        and ry.shape == (n_items, k)):
                    restored = (np.asarray(rx, dtype=np.float32),
                                np.asarray(ry, dtype=np.float32))
                    start_iter = min(int(ck.step), iterations)
                    checkpointer.mark_resumed(start_iter)
                else:
                    log.warning(
                        "checkpoint %s does not match the current factor "
                        "shapes; training from scratch", ck.path,
                    )
        if start_iter >= iterations:
            # fully trained checkpoint (a crash between train end and
            # publish): nothing to redo and no kernel to launch; the item
            # pack is still joined so the timings and the cache stay sound
            finish_item_pack()
            finish_ckpt()
            if timings is not None:
                timings["iter_s"] = []
            rx, ry = (torch.from_numpy(r).to(dev) for r in restored)
            if shard_devs is None:
                return rx, ry
            # the mesh contract: padded, row-sharded factors
            return (_padded_shards(rx, _padded_rows_for(n_users, block_u, ndev),
                                   mesh, row_axis),
                    _padded_shards(ry, _padded_rows_for(n_items, block_i, ndev),
                                   mesh, row_axis))

        # Y₀ needs only the item side's PADDED SHAPE: the first user
        # half-iteration must not wait on the item pack
        padded_i = _padded_rows_for(n_items, block_i, ndev)
        if restored is not None or init_y is not None:
            y0 = torch.as_tensor(
                restored[1] if restored is not None else init_y,
                dtype=torch.float32)[:n_items]
            if y0.shape != (n_items, k):
                raise ValueError(
                    f"init_y must have at least {n_items} rows of {k} "
                    f"features, got {tuple(y0.shape)}")
            y = torch.zeros((padded_i, k), device=dev, dtype=torch.float32)
            y[:n_items] = y0.to(dev)
        else:
            y = init_item_factors(padded_i, n_items, k, generator, dev)

        # the blocks of each side on their shards' devices, placed once
        placed: dict = {}
        if shard_devs is not None:
            y = shard_rows(y, mesh, row_axis)

        def solve(side, opp):
            # one cost-accounted call per half that runs: a resumed train
            # records only the halves it runs
            profiling.costs().record(
                "als.train.user_half" if side is user_side
                else "als.train.item_half")
            if shard_devs is None:
                return solve_side_blocked(
                    opp, side.srows, side.scols, side.svals, side.slens, lam,
                    alpha, block=side.block, features=k, implicit=implicit,
                    slot_chunk=side.slot_chunk, dtype=dtype,
                    spd_kernel=spd_kernel, fused_gramian=fused_gramian,
                    schedules=side.gg_schedules,
                )
            if id(side) not in placed:
                placed[id(side)] = shard_side(side, shard_devs)
            return solve_side_sharded(
                opp, placed[id(side)], shard_devs, row_axis, lam, alpha,
                block=side.block, features=k, implicit=implicit,
                slot_chunk=side.slot_chunk, dtype=dtype,
                spd_kernel=spd_kernel, fused_gramian=fused_gramian,
            )

        iter_s = []
        t_iter = time.perf_counter()
        x = solve(user_side, y)  # queued while the item side still packs
        item_side = finish_item_pack()
        y = solve(item_side, x)
        for completed in range(start_iter + 1, iterations + 1):
            if completed > start_iter + 1:
                x = solve(user_side, y)
                y = solve(item_side, x)
            maybe_ckpt(completed, x, y)
            if timings is not None:
                for d in set(shard_devs or [dev]):
                    _sync(d)
                now = time.perf_counter()
                iter_s.append(now - t_iter)
                t_iter = now
        finish_ckpt()
        if timings is not None:
            timings["iter_s"] = iter_s
        if shard_devs is not None:
            return x, y
        return x[:n_users], y[:n_items]
    finally:
        # JOIN the worker on every exit: an orphaned item pack must not
        # outlive this call — or the ALSUpdate cache lock — and write its
        # side into the shared layout cache mid-next-generation
        pool.shutdown(wait=True, cancel_futures=True)
