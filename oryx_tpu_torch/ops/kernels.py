"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version.

* :func:`gather_gramian_accumulate` (``csrc/gather_gramian.cu``: bounded
  work units from :func:`gather_gramian_schedule`, then an ordered
  reduction of split rows) replaces the reference's Pallas
  ``_make_gather_gramian_kernel`` (``oryx_tpu/ops/pallas_kernels.py:221-289``);
* :func:`spd_solve_batched` (``csrc/spd_solve.cu``: a warp per system for
  k <= 64, a CTA per system up to k = 240, :func:`spd_variant`) replaces
  ``_spd_solve_kernel`` (``pallas_kernels.py:89-116``);
* :func:`kmeans_assign_accumulate` (``csrc/kmeans_assign.cu``), one Lloyd
  sweep of k-means, replaces ``_kernel`` (``pallas_kernels.py:357-388``).

Dispatch is by the tensors' device and nothing else: a CPU tensor goes to
the plain version (that is how the CPU tests run the trainer); a CUDA
tensor goes to the kernel, or the wrapper raises. Nothing falls back from a
failed kernel to the plain version. Each kernel launch adds one to its
entry in :data:`LAUNCHES` and in :data:`SHAPE_LAUNCHES`, so a run can show
that it went through the kernels, and at which shapes; the plain versions
count nothing.

Kernels launch on PyTorch's current stream and allocate nothing: the
wrappers allocate the outputs. They are built on first use
(:mod:`oryx_tpu_torch.ops._build`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import logging
import threading

import torch

from oryx_tpu_torch.ops import _build

log = logging.getLogger(__name__)

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {"gather_gramian_accumulate": 0, "spd_solve_batched": 0,
            "kmeans_assign_accumulate": 0}
#: The same launches by kernel and shape, ``(kernel, shape) -> count``:
#: ``kernel`` is the wrapper's name, for the SPD solve with the variant
#: appended (``"spd_solve_batched.warp"``, ``".cta"``), and
#: ``"gather_gramian_accumulate.reduce"`` for the gather-Gramian's second
#: launch, which a block with a split row adds; ``shape`` is
#: ``(block + 1, S, T, k, dtype)`` for the gather-Gramian (``dtype`` as
#: ``str(y.dtype)``), ``(B, k)`` for the SPD solve and ``(N, D, K)`` for the
#: sweep.
SHAPE_LAUNCHES: dict = {}
# candidate builds launch from several host threads: every count is a
# read-modify-write, so each takes this lock
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        SHAPE_LAUNCHES.clear()


def _count(name: str, shape: tuple, kernel: "str | None" = None) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1
        _add_shape(kernel or name, shape)


def _count_shape(kernel: str, shape: tuple) -> None:
    with _launch_lock:
        _add_shape(kernel, shape)


def _add_shape(kernel: str, shape: tuple) -> None:
    key = (kernel, shape)
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1


# The reference's gate (pallas_kernels._GG_MAX_FEATURES), kept as it is: the
# CUDA kernel tiles any k, so the trainer selects the fused path exactly
# where the reference does.
GG_MAX_FEATURES = 256
# Entries per work unit of the gather-Gramian kernel (:func:`gather_gramian_schedule`
# rounds it up to a multiple of the slot width, and raises it for a block
# whose split rows would outgrow the workspace bound).
GG_UNIT_ENTRIES = 512

# Shared memory one block may use on an H100 (227 KB). The SPD CTA kernel
# keeps the augmented k x (k+1) matrix plus one k-vector there, 4·k·(k+2)
# bytes: k <= 240 fits. Past that the solve is a Cholesky factorisation.
SMEM_BYTES = 232_448
# The largest k that ``oryx_spd_solve`` sends to its warp-per-system kernel
# (``kWarpMaxK`` in ``csrc/spd_solve.cu``; the wrapper checks that the
# library agrees before its first launch).
SPD_WARP_MAX_FEATURES = 64

_C_INT = ctypes.c_int
_C_PTR = ctypes.c_void_p
_SIGNATURES = {
    "oryx_gather_gramian": (
        [_C_PTR, _C_INT, _C_PTR, _C_INT, _C_PTR, _C_INT, _C_PTR, _C_PTR,
         _C_PTR, _C_PTR, _C_PTR, _C_PTR, _C_PTR, _C_INT, _C_INT, _C_PTR],
        _C_INT,
    ),
    "oryx_spd_solve": ([_C_PTR, _C_PTR, _C_PTR, _C_INT, _C_INT, _C_PTR], _C_INT),
    "oryx_kmeans_assign": (
        [_C_PTR, _C_PTR, _C_PTR, _C_INT, _C_INT, _C_INT, _C_INT, _C_INT,
         _C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_PTR, _C_PTR, _C_PTR,
         _C_PTR, _C_PTR],
        _C_INT,
    ),
}
_cholesky_logged: set = set()


def _entry(lib_name: str, fn_name: str):
    fn = getattr(_build.library(lib_name), fn_name)
    fn.argtypes, fn.restype = _SIGNATURES[fn_name]
    return fn


def _check_cuda(name: str, dev: torch.device, **tensors) -> None:
    for arg, (t, dtypes) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected one "
                            f"of {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _route(name: str, dev: torch.device) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version (CPU
    tensors); any other device raises."""
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


# -- gather-Gramian -----------------------------------------------------------


def gather_gramian_supported(features: int) -> bool:
    """Whether the trainer's fused path takes the gather-Gramian kernel."""
    return features <= GG_MAX_FEATURES


@dataclasses.dataclass(frozen=True)
class GatherGramianSchedule:
    """The gather-Gramian kernel's work units for one packed block
    (:func:`gather_gramian_schedule`).

    ``work`` is (units + unvisited rows, 4) int32, one item per kernel
    block: ``(row, first slot, end slot, workspace slot)``. The first
    ``units`` items are the units, longest first (ties in slot order), so
    the card starts the long ones first and the short ones fill in at the
    end. A unit of a split row has its own workspace slot, numbered 0, 1,
    … in slot order; a single-unit row's has -1 and writes straight into
    the output. The rest are the rows that no valid slot visits, the spill
    row included, as empty items ``(row, 0, 0, -1)``, which write zeros.
    ``split`` is (split rows, 3) int32: ``(row, first workspace slot, end
    workspace slot)``; pass 2 sums each split row's slots in that order.
    """

    work: torch.Tensor
    split: torch.Tensor
    units: int
    split_units: int
    unit_entries: int
    max_entries_per_unit: int
    block: int
    slots: int
    slot_width: int

    @property
    def split_rows(self) -> int:
        return self.split.shape[0]

    def workspace_bytes(self, features: int) -> int:
        """Bytes of the split rows' partial tiles at ``features`` = k."""
        return self.split_units * features * (features + 1) * 4


def gather_gramian_schedule(srow, slens, *, block: int, slot_width: int,
                            unit_entries: "int | None" = None,
                            device=None) -> GatherGramianSchedule:
    """Cut a block's owner rows into the kernel's work units.

    A unit is a run of consecutive valid slots (``slens > 0``) of one owner
    row, ``unit_entries // slot_width`` slots at most, so at most
    ``unit_entries`` entries; a slot is never split and units never cross
    rows. Pad slots belong to no unit. ``unit_entries`` must be a positive
    multiple of the slot width; by default it is :data:`GG_UNIT_ENTRIES`
    rounded up to one. While the units of split rows (rows of more than
    one unit) exceed ``(block + 1) // 2``, the unit size doubles: the
    kernel's workspace, ``split_units · k(k+1)`` floats, then never exceeds
    the output's ``(block + 1) · k²`` at any k.

    Computed on the host (it synchronises on device inputs), once per block
    at pack time; the tensors go to ``device`` (default: ``srow``'s).
    """
    t = slot_width
    if unit_entries is None:
        unit_entries = -(-GG_UNIT_ENTRIES // t) * t
    if unit_entries < t or unit_entries % t:
        raise ValueError(f"unit_entries {unit_entries} must be a positive "
                         f"multiple of the slot width {t}")
    dev = srow.device if device is None else torch.device(device)
    srow = torch.as_tensor(srow).cpu().long()
    lens = torch.as_tensor(slens).cpu().long()
    slots = srow.shape[0]
    valid = torch.nonzero(lens > 0).flatten()
    rows = srow[valid]
    if rows.numel() and (bool((rows[1:] < rows[:-1]).any())
                         or int(rows[0]) < 0 or int(rows[-1]) > block):
        raise ValueError("gather_gramian_schedule: slots must be sorted by "
                         f"owner row in [0, {block}]")
    n = rows.shape[0]
    first = torch.ones(n, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    run_start = torch.nonzero(first).flatten()  # each row's first valid slot
    run = torch.cumsum(first.long(), 0) - 1
    pos = torch.arange(n) - run_start[run]  # slot's place among its row's
    run_len = torch.diff(run_start, append=torch.tensor([n]))
    u = unit_entries
    while True:
        per = u // t
        run_units = -(-run_len // per)
        run_split = run_units > 1
        split_units = int(run_units[run_split].sum())
        if 2 * split_units <= block + 1:
            break
        u *= 2
    starts = torch.nonzero(pos % per == 0).flatten()
    ends = torch.cat([starts, torch.tensor([n])])[1:]
    entries = torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.long),
                                      lens[valid]]), 0)
    unit_split = run_split[run[starts]]
    ws_slot = torch.where(unit_split, torch.cumsum(unit_split.long(), 0) - 1,
                          -1)
    unit_len = entries[ends] - entries[starts]
    units = torch.stack([rows[starts], valid[starts],
                         valid[ends - 1] + 1, ws_slot], 1)
    units = units[torch.argsort(-unit_len, stable=True)]
    unvisited = torch.ones(block + 1, dtype=torch.bool)
    unvisited[rows] = False
    zero_rows = torch.nonzero(unvisited).flatten()
    zeros = torch.zeros_like(zero_rows)
    work = torch.cat([units, torch.stack([zero_rows, zeros, zeros,
                                          zeros - 1], 1)])
    split_ends = torch.cumsum(run_units[run_split], 0)
    split = torch.stack([rows[run_start[run_split]],
                         split_ends - run_units[run_split], split_ends], 1)
    return GatherGramianSchedule(
        work=work.to(torch.int32).to(dev), split=split.to(torch.int32).to(dev),
        units=starts.shape[0], split_units=split_units, unit_entries=u,
        max_entries_per_unit=int(unit_len.max()) if n else 0,
        block=block, slots=slots, slot_width=t,
    )


def gather_gramian_accumulate(y, srow, scols, w, coef, slens, *, block: int,
                              schedule: "GatherGramianSchedule | None" = None):
    """Fused gather → per-slot Gramian → per-row accumulate for one block.

    Args:
      y: (R, k) opposite-side factors, float32 or bfloat16.
      srow: (S,) int32 block-local owner row per slot, sorted ascending,
        pad = ``block`` (the spill row).
      scols: (S, T) int32 row indices into ``y``.
      w / coef: (S, T) float32 per-entry Gramian / RHS weights, zero on
        padding entries.
      slens: (S,) int32 valid entries per slot (0 = pad slot).
      block: rows per block; the outputs carry the extra spill row.
      schedule: the block's :func:`gather_gramian_schedule`, built once
        where the block is packed; on the card, without one, the wrapper
        builds it (a host synchronisation). The plain version needs none.

    Returns (A (block+1, k, k), b (block+1, k)), float32. Rows no slot
    visits are exactly zero. On the card the result is the same bits on
    every call.
    """
    name = "gather_gramian_accumulate"
    if not _route(name, y.device):
        return gather_gramian_accumulate_plain(
            y, srow, scols, w, coef, slens, block=block)
    dev = y.device
    i32, f32 = (torch.int32,), (torch.float32,)
    _check_cuda(name, dev, y=(y, (torch.float32, torch.bfloat16)),
                srow=(srow, i32), scols=(scols, i32), w=(w, f32),
                coef=(coef, f32), slens=(slens, i32))
    s, t = scols.shape
    k = y.shape[1]
    if srow.shape != (s,) or slens.shape != (s,) or w.shape != (s, t) \
            or coef.shape != (s, t):
        raise ValueError(f"{name}: inconsistent slot shapes")
    if schedule is None:
        schedule = gather_gramian_schedule(srow, slens, block=block,
                                           slot_width=t)
    if (schedule.block, schedule.slots, schedule.slot_width) != (block, s, t):
        raise ValueError(f"{name}: the schedule is for block {schedule.block}, "
                         f"{schedule.slots} slots of {schedule.slot_width}, "
                         f"not {block}, {s} of {t}")
    _check_cuda(name, dev, work=(schedule.work, i32),
                split=(schedule.split, i32))
    a = torch.empty((block + 1, k, k), device=dev, dtype=torch.float32)
    b = torch.empty((block + 1, k), device=dev, dtype=torch.float32)
    ws = (torch.empty((schedule.split_units, k * k + k), device=dev,
                      dtype=torch.float32) if schedule.split_units else None)
    with torch.cuda.device(dev):
        err = _entry("gather_gramian", "oryx_gather_gramian")(
            y.data_ptr(), int(y.dtype == torch.bfloat16),
            schedule.work.data_ptr(), schedule.work.shape[0],
            schedule.split.data_ptr(), schedule.split_rows,
            scols.data_ptr(), w.data_ptr(), coef.data_ptr(), slens.data_ptr(),
            None if ws is None else ws.data_ptr(), a.data_ptr(), b.data_ptr(),
            t, k, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(name, err)
    shape = (block + 1, s, t, k, str(y.dtype))
    _count(name, shape)
    if schedule.split_rows:
        _count_shape(f"{name}.reduce", shape)
    return a, b


def gather_gramian_accumulate_plain(y, srow, scols, w, coef, slens, *,
                                    block: int):
    """Plain PyTorch version of :func:`gather_gramian_accumulate`: gather,
    per-slot einsum, and ``index_add_`` into the owner rows. Same roundings
    (weights cast to y's type, float32 products and sums); other summation
    order. ``slens`` is implied by the zero weights on padding entries."""
    k = y.shape[1]
    ga, gb = slot_gramians(y, scols, w, coef)
    idx = srow.long()
    a = torch.zeros((block + 1, k, k), device=y.device, dtype=torch.float32)
    b = torch.zeros((block + 1, k), device=y.device, dtype=torch.float32)
    return a.index_add_(0, idx, ga), b.index_add_(0, idx, gb)


def slot_gramians(y, scols, w, coef):
    """Per-slot Gramians (S, k, k) and right-hand sides (S, k): the gathered
    factor rows contracted over the slot width, with the weights cast to
    y's type and float32 products and sums."""
    yg = y[scols.long()].float()  # (S, T, k)
    ga = torch.einsum("st,sti,stj->sij", w.to(y.dtype).float(), yg, yg)
    gb = torch.einsum("st,sti->si", coef.to(y.dtype).float(), yg)
    return ga, gb


# -- SPD solve ----------------------------------------------------------------


def spd_use_kernel(k: int) -> bool:
    """Whether a k-feature system fits the SPD kernel's shared memory
    (k <= 240 on an H100); larger k is solved by Cholesky."""
    return 4 * k * (k + 2) <= SMEM_BYTES


def spd_variant(k: int) -> str:
    """Which solve :func:`spd_solve_batched` runs for k features on the card:
    ``"warp"`` (a warp per system, registers), ``"cta"`` (a CTA per system,
    shared memory) or ``"cholesky"``."""
    if k <= SPD_WARP_MAX_FEATURES:
        return "warp"
    return "cta" if spd_use_kernel(k) else "cholesky"


@functools.cache
def _spd_solve_entry():
    """``oryx_spd_solve``, once its library's crossover is found to be
    :data:`SPD_WARP_MAX_FEATURES`: the variant counted is then the kernel
    the entry launches."""
    warp_max_k = _build.library("spd_solve").oryx_spd_warp_max_k()
    if warp_max_k != SPD_WARP_MAX_FEATURES:
        raise RuntimeError(f"spd_solve.cu sends k <= {warp_max_k} to its warp "
                           f"kernel, kernels.py expects {SPD_WARP_MAX_FEATURES}")
    return _entry("spd_solve", "oryx_spd_solve")


def spd_solve_batched(a, b):
    """Solve ``a[i] @ x[i] = b[i]`` for a batch of regularised SPD systems.

    Args: a (B, k, k) float32, b (B, k) float32. Returns x (B, k) float32.
    Gauss-Jordan without pivoting (the reference kernel's algorithm) in the
    kernel :func:`spd_variant` names; a Cholesky solve past the CTA kernel's
    gate, on any device.
    """
    name = "spd_solve_batched"
    n, k = b.shape
    variant = spd_variant(k)
    if variant == "cholesky":
        if k not in _cholesky_logged:
            _cholesky_logged.add(k)
            log.info("spd_solve_batched: k=%d exceeds the kernel's shared "
                     "memory; using a Cholesky solve", k)
        return spd_solve_cholesky(a, b)
    if not _route(name, b.device):
        return spd_solve_batched_plain(a, b)
    dev = b.device
    f32 = (torch.float32,)
    _check_cuda(name, dev, a=(a, f32), b=(b, f32))
    if a.shape != (n, k, k):
        raise ValueError(f"{name}: a has shape {tuple(a.shape)}, expected "
                         f"{(n, k, k)}")
    x = torch.empty((n, k), device=dev, dtype=torch.float32)
    if n == 0:
        return x
    with torch.cuda.device(dev):
        err = _spd_solve_entry()(
            a.data_ptr(), b.data_ptr(), x.data_ptr(), n, k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(name, err)
    _count(name, (n, k), f"{name}.{variant}")
    return x


def spd_solve_batched_plain(a, b):
    """Plain PyTorch version of the SPD kernels: the same Gauss-Jordan steps
    in the same order, over the whole batch at once.

    Row j is set to the normalised pivot row, as the kernels write it. (The
    reference's fused form, subtracting (fac − e_j) ⊗ piv_row from every
    row, gets row j as aug_j − (piv − 1)·aug_j/piv: a cancellation that
    loses ~log2(piv) bits, more than the kernels' 1e-4 tolerance on an ALS
    item block, whose popular items give pivots of 10^3 to 10^4.)"""
    k = b.shape[-1]
    aug = torch.cat([a.float(), b.float()[..., None]], dim=-1)
    for j in range(k):
        piv_row = aug[:, j:j + 1, :] / aug[:, j:j + 1, j:j + 1]
        aug = aug - aug[:, :, j:j + 1] * piv_row
        aug[:, j:j + 1, :] = piv_row
    return aug[:, :, k]


def spd_solve_cholesky(a, b):
    """The reference's fallback semantics: Cholesky factor and solve."""
    chol, _ = torch.linalg.cholesky_ex(a.float())
    return torch.cholesky_solve(b.float()[..., None], chol)[..., 0]


# -- k-means Lloyd sweep --------------------------------------------------------

# The sweep kernel's partial sums: at most this many per-CTA slabs, at least
# 256 points each, and a workspace of at most 2^26 floats (256 MB). The count
# depends on N, K and D only, so the summation order is the same on every card.
KMEANS_MAX_PARTS = 1024
KMEANS_POINTS_PER_PART = 256
KMEANS_WORKSPACE_FLOATS = 1 << 26
# The assign launch (``kThreads``, ``kTP``, ``kTC``, ``kTD`` and ``kLd`` in
# ``csrc/kmeans_assign.cu``): 128 threads, 64 points × 256 centres per CTA,
# 32 dimensions a stage, two stages of both in shared memory, rows padded
# to 36 floats.
KMEANS_TILE_POINTS = 64
KMEANS_TILE_CENTERS = 256
KMEANS_TILE_DIMS = 32
KMEANS_TILE_ROW_FLOATS = KMEANS_TILE_DIMS + 4
# Assign CTAs at most: each walks tiles blockIdx, blockIdx + CTAs, … with one
# load pipeline across them (two CTAs for each of an H100's 132 SMs; any
# count gives the same bits).
KMEANS_ASSIGN_CTAS = 264
# The walk (``kWalkThreads``, ``kWalkTile``, ``kWalkStages``): at most 512
# threads in column groups of at most 256; tiles of 32 points of a column
# pass, with their weights, d2 and centres, four in shared memory.
KMEANS_WALK_THREADS = 512
KMEANS_WALK_MAX_COLS = 256
KMEANS_WALK_TILE = 32
KMEANS_WALK_STAGES = 4
# The largest per-CTA slab the walk keeps in shared memory: two CTAs still
# fit on an SM. A larger slab lives in the CTA's workspace slab.
KMEANS_SLAB_SMEM_BYTES = 100 * 1024


def kmeans_parts(n: int, k: int, d: int) -> int:
    """Number of partial slabs the sweep kernel reduces for (N, K, D)."""
    slab = k * d + k + 1
    return max(1, min(-(-n // KMEANS_POINTS_PER_PART), KMEANS_MAX_PARTS,
                      KMEANS_WORKSPACE_FLOATS // slab))


@dataclasses.dataclass(frozen=True)
class KMeansSweepPlan:
    """The launch geometry of one sweep at (N, K, D) (:func:`kmeans_sweep_plan`).

    Launch 1, assign: ``assign_ctas`` CTAs of 128 threads over ``tiles``
    tiles of :data:`KMEANS_TILE_POINTS` points, each tile ``stages``
    (centre chunk, dimension stage) pairs. Launch 2, the walk:
    ``parts`` CTAs of ``walk_threads`` = ``walk_groups`` × ``walk_cols``;
    CTA b walks points ``[b·per, (b+1)·per)`` in order. Thread
    ``g·walk_cols + t`` owns column ``cb + t`` of the sums of every centre
    c with ``c % walk_groups == g``, for each column pass ``cb`` (0,
    walk_cols, …); thread ``g·walk_cols`` also owns those centres' counts,
    and thread 0 the cost. The slab lives in shared memory when
    ``slab_in_smem``. Launch 3, the reduce, sums the ``parts`` slabs in
    order. ``*_smem_bytes`` are each launch's shared bytes, static and
    dynamic.
    """

    n: int
    k: int
    d: int
    tiles: int
    assign_ctas: int
    stages: int
    parts: int
    per: int
    walk_cols: int
    walk_groups: int
    slab_floats: int
    slab_in_smem: bool

    @property
    def walk_threads(self) -> int:
        return self.walk_cols * self.walk_groups

    @property
    def assign_smem_bytes(self) -> int:
        stage = (KMEANS_TILE_POINTS + KMEANS_TILE_CENTERS) * KMEANS_TILE_ROW_FLOATS
        return 4 * (2 * stage + KMEANS_TILE_POINTS + KMEANS_TILE_CENTERS)

    @property
    def walk_tile_bytes(self) -> int:
        """The walk's tiles."""
        return 4 * KMEANS_WALK_STAGES * KMEANS_WALK_TILE * (self.walk_cols + 3)

    @property
    def walk_smem_bytes(self) -> int:
        slab = 16 * -(-self.slab_floats // 4) if self.slab_in_smem else 0
        return slab + self.walk_tile_bytes

    @property
    def reduce_smem_bytes(self) -> int:
        return 0

    def walk_entries(self, thread: int) -> list:
        """The slab entries walk thread ``thread`` owns, as the kernel assigns
        them: ``("sum", c, col)``, ``("count", c)`` and ``("cost",)``."""
        g, t = divmod(thread, self.walk_cols)
        mine = range(g, self.k, self.walk_groups)
        out = [("sum", c, cb + t) for cb in range(0, self.d, self.walk_cols)
               if cb + t < self.d for c in mine]
        if t == 0:
            out += [("count", c) for c in mine]
        if thread == 0:
            out.append(("cost",))
        return out


@functools.lru_cache(maxsize=64)
def kmeans_sweep_plan(n: int, k: int, d: int) -> KMeansSweepPlan:
    """The sweep's launch geometry for N points, K centres and D dimensions:
    from the shape alone, never the card, so the summation order is the
    same on every card. The walk has ``walk_cols`` = D rounded up to a
    multiple of 32 (at most 256) threads per column group and as many
    groups as fit in 512 threads, at most K, rounded down to a power of 2,
    so at D = 64 a CTA walks with 16 warps where one group would have 2.
    The slab is kept in shared memory when it is at most
    :data:`KMEANS_SLAB_SMEM_BYTES` and fits beside the walk's tiles."""
    if min(n, k, d) <= 0:
        raise ValueError(f"kmeans_sweep_plan: n={n}, k={k}, d={d} must be > 0")
    parts = kmeans_parts(n, k, d)
    cols = min(-(-d // 32) * 32, KMEANS_WALK_MAX_COLS)
    slab = k * d + k + 1
    groups = 1 << (max(1, min(KMEANS_WALK_THREADS // cols, k)).bit_length() - 1)
    tile_bytes = 4 * KMEANS_WALK_STAGES * KMEANS_WALK_TILE * (cols + 3)
    slab_bytes = 16 * -(-slab // 4)
    return KMeansSweepPlan(
        n=n, k=k, d=d,
        tiles=-(-n // KMEANS_TILE_POINTS),
        assign_ctas=min(-(-n // KMEANS_TILE_POINTS), KMEANS_ASSIGN_CTAS),
        stages=-(-k // KMEANS_TILE_CENTERS) * -(-d // KMEANS_TILE_DIMS),
        parts=parts, per=-(-n // parts),
        walk_cols=cols, walk_groups=groups,
        slab_floats=slab,
        slab_in_smem=(4 * slab <= KMEANS_SLAB_SMEM_BYTES
                      and slab_bytes + tile_bytes <= SMEM_BYTES),
    )


def kmeans_vector_loads(points, centers) -> bool:
    """Whether the assign launch may read ``points`` and ``centers`` in
    16-byte vectors: both start on a 16-byte boundary and D % 4 == 0.
    Otherwise it reads them one float at a time (the same sums)."""
    return (points.data_ptr() % 16 == 0 and centers.data_ptr() % 16 == 0
            and points.shape[1] % 4 == 0)


def kmeans_sweep_args(points, weights, centers, plan: KMeansSweepPlan,
                      assign, min_d2, ws, out, stream) -> tuple:
    """The arguments of ``oryx_kmeans_assign`` for one sweep into the given
    scratch (assign (N,) int32, min_d2 (N,), ws (parts, slab)) and ``out``
    (slab,) float32."""
    return (points.data_ptr(), weights.data_ptr(), centers.data_ptr(),
            plan.n, plan.d, plan.k, plan.tiles, plan.assign_ctas, plan.parts,
            plan.walk_cols, plan.walk_groups, int(plan.slab_in_smem),
            int(kmeans_vector_loads(points, centers)), assign.data_ptr(),
            min_d2.data_ptr(), ws.data_ptr(), out.data_ptr(), stream)


def kmeans_assign_accumulate(points, weights, centers):
    """One Lloyd sweep: assign each point to its nearest centre and
    accumulate per centre.

    Args: points (N, D), weights (N,) (0 = the point contributes nothing),
    centers (K, D), all float32. Returns (sums (K, D), counts (K,), cost ())
    float32: the weighted sums and weights of the points nearest each centre,
    and the weighted sum of their squared distances. Distances are
    ``max(|p|² − 2·p·c + |c|², 0)``; ties go to the lowest centre index.
    On the card the launches follow :func:`kmeans_sweep_plan`; inputs that
    are not 16-byte aligned take the kernel's scalar loads.
    """
    name = "kmeans_assign_accumulate"
    if not _route(name, points.device):
        return kmeans_assign_accumulate_plain(points, weights, centers)
    dev = points.device
    f32 = (torch.float32,)
    _check_cuda(name, dev, points=(points, f32), weights=(weights, f32),
                centers=(centers, f32))
    n, d = points.shape
    k = centers.shape[0]
    if weights.shape != (n,) or centers.shape != (k, d) or k == 0 or d == 0:
        raise ValueError(f"{name}: points {tuple(points.shape)}, weights "
                         f"{tuple(weights.shape)}, centers "
                         f"{tuple(centers.shape)} do not fit together")
    slab = k * d + k + 1
    if n == 0:
        out = torch.zeros(slab, device=dev, dtype=torch.float32)
    else:
        plan = kmeans_sweep_plan(n, k, d)
        assign = torch.empty(n, device=dev, dtype=torch.int32)
        min_d2 = torch.empty(n, device=dev, dtype=torch.float32)
        ws = torch.empty((plan.parts, slab), device=dev, dtype=torch.float32)
        out = torch.empty(slab, device=dev, dtype=torch.float32)
        with torch.cuda.device(dev):
            err = _entry("kmeans_assign", "oryx_kmeans_assign")(
                *kmeans_sweep_args(points, weights, centers, plan, assign,
                                   min_d2, ws, out,
                                   torch.cuda.current_stream(dev).cuda_stream))
        _raise_on(name, err)
        _count(name, (n, d, k))
    return out[:k * d].view(k, d), out[k * d:k * d + k], out[-1]


def kmeans_assign_accumulate_plain(points, weights, centers):
    """Plain PyTorch version of :func:`kmeans_assign_accumulate`: the same
    expansion, clamp and first-index argmin; the sums as a one-hot matrix
    product. Other summation orders."""
    d2 = ((points * points).sum(dim=1, keepdim=True)
          - 2.0 * (points @ centers.T)
          + (centers * centers).sum(dim=1)[None, :]).clamp_min(0.0)
    nearest = d2.argmin(dim=1)
    min_d2 = d2.gather(1, nearest[:, None])[:, 0]
    indicator = (torch.nn.functional.one_hot(nearest, centers.shape[0])
                 .to(points.dtype) * weights[:, None])
    return indicator.T @ points, indicator.sum(dim=0), (min_d2 * weights).sum()
