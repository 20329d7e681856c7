"""The port's two trainer kernels against the reference's Pallas kernels.

On the CPU each wrapper in ``oryx_tpu_torch.ops.kernels`` runs its plain
PyTorch version (the CUDA kernels exist only on the card), so these tests
pin the plain versions — the arithmetic the kernels are held to on the card —
against the reference's Pallas kernels run in interpret mode, on the same
inputs made from a seed with numpy. The kernels themselves are checked
against these plain versions on the card by ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oryx_tpu.ops import pallas_kernels as pk
from oryx_tpu_torch.models.als import train as tr
from oryx_tpu_torch.ops import kernels as K
from test_gramian_kernel import _skewed_batch
from test_kernel_differential import _gg_reference
from test_torch_cuda import SEED, _gg_inputs, _spd, _torch_dtype

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

# (k, T, block, real slots, pad slots, hot-row slots): the production k, a k
# that is not tile-round, a single-slot grid, T = 16 as the user side packs
# it, and a hot row (a popular item) holding most of the slots, several
# work units at a small unit size
_GG_CASES = [pytest.param(*case, 0, id="-".join(map(str, case)))
             for case in ((50, 8, 24, 20, 4), (13, 16, 12, 9, 3),
                          (8, 8, 6, 1, 0), (50, 16, 10, 14, 2))]
_GG_CASES.append(pytest.param(50, 8, 40, 20, 4, 56, id="50-8-40-20-4-hot56"))


def _gg_case_inputs(k, t, block, n_slots, n_pad, hot):
    return _gg_inputs(SEED + k * t + block, k, t, block, n_slots, n_pad,
                      hot=hot)


def _pallas_gg(y, srow, scols, w, coef, slens, block, dtype="float32"):
    jy = jnp.asarray(y).astype(jnp.dtype(dtype))
    ra, rb = pk.gather_gramian_accumulate(
        jy, jnp.asarray(srow), jnp.asarray(scols), jnp.asarray(w),
        jnp.asarray(coef), jnp.asarray(slens), block=block, interpret=True,
    )
    return np.asarray(ra, dtype=np.float32), np.asarray(rb, dtype=np.float32)


@pytest.mark.parametrize("k,t,block,n_slots,n_pad,hot", _GG_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_gramian_plain_matches_pallas(k, t, block, n_slots, n_pad,
                                             hot, dtype):
    """Tolerance, relative to the largest |value|: 1e-5 in float32 (only
    the summation order differs); 2e-2 in bfloat16 (the Pallas kernel
    rounds each w·y product to bf16, the port keeps it in f32)."""
    y, srow, scols, w, coef, slens = _gg_case_inputs(k, t, block, n_slots,
                                                     n_pad, hot)
    ra, rb = _pallas_gg(y, srow, scols, w, coef, slens, block, dtype)
    ty = torch.from_numpy(y).to(_torch_dtype(dtype))
    before = dict(K.LAUNCHES)
    a, b = K.gather_gramian_accumulate(
        ty, torch.from_numpy(srow), torch.from_numpy(scols),
        torch.from_numpy(w), torch.from_numpy(coef), torch.from_numpy(slens),
        block=block,
    )
    assert K.LAUNCHES == before  # CPU tensors never reach a kernel
    a, b = a.numpy(), b.numpy()
    assert a.shape == (block + 1, k, k) and b.shape == (block + 1, k)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert np.abs(a - ra).max() / np.abs(ra).max() < tol
    assert np.abs(b - rb).max() / np.abs(rb).max() < tol
    # rows no slot visits and the spill row are EXACT zeros
    unvisited = np.setdiff1d(np.arange(block + 1), srow[slens > 0])
    assert block in unvisited and len(unvisited) > 1
    assert not a[unvisited].any() and not b[unvisited].any()
    if dtype == "float32":
        # the numpy oracle of the reference's differential fuzz
        oa, ob = _gg_reference(y, srow, scols, w, coef, block)
        assert np.abs(a - oa).max() / np.abs(oa).max() < 1e-5
        assert np.abs(b - ob).max() / np.abs(ob).max() < 1e-5


def _schedule_oracle(srow, slens, block, t, unit_entries):
    """Per owner row, its valid slots and its unit count at
    ``unit_entries``, by a plain loop over the slots."""
    per_row: dict = {}
    for s, (r, n) in enumerate(zip(srow.tolist(), slens.tolist())):
        if n > 0:
            per_row.setdefault(r, []).append(s)
    per = unit_entries // t
    units = {r: -(-len(v) // per) for r, v in per_row.items()}
    return per_row, units


def _check_schedule(sched, srow, slens, block, t, requested):
    """Every invariant of a gather-Gramian schedule, against the layout."""
    srow, slens = np.asarray(srow), np.asarray(slens)
    work = sched.work.numpy()
    units, empty = work[:sched.units], work[sched.units:]
    # launch order: longest unit first, ties in slot order
    lens = np.array([slens[lo:hi].sum() for _, lo, hi, _ in units], dtype=int)
    assert (np.diff(lens) <= 0).all()
    assert all(units[i, 1] < units[i + 1, 1] for i in range(len(units) - 1)
               if lens[i] == lens[i + 1])
    units = units[np.argsort(units[:, 1])]  # in slot order from here on
    per_row, _ = _schedule_oracle(srow, slens, block, t, sched.unit_entries)
    # the unit size: a multiple of T from the requested one, doubled only
    # as far as the workspace bound needs
    u = sched.unit_entries
    assert u % t == 0 and u >= requested and (u // requested) & (u // requested - 1) == 0
    if u > requested:
        _, half = _schedule_oracle(srow, slens, block, t, u // 2)
        assert 2 * sum(n for n in half.values() if n > 1) > block + 1
    # every valid slot in exactly one unit; units hold slots of one row, in
    # slot order, start and end on valid slots, at most U entries each
    cover = np.zeros(len(srow), dtype=int)
    entries = []
    for row, lo, hi, _ in units:
        assert lo < hi and slens[lo] > 0 and slens[hi - 1] > 0
        assert (srow[lo:hi] == row).all()
        cover[lo:hi] += slens[lo:hi] > 0
        entries.append(int(slens[lo:hi].sum()))
    assert (cover == (slens > 0)).all()
    assert (np.diff(units[:, 1]) > 0).all() and (units[:-1, 2] <= units[1:, 1]).all()
    assert max(entries, default=0) == sched.max_entries_per_unit <= u
    # unvisited rows (the spill row among them, pad slots being empty) have
    # no unit, and one empty item each, which writes zeros
    assert set(units[:, 0].tolist()) == set(per_row)
    unvisited = sorted(set(range(block + 1)) - set(per_row))
    assert empty[:, 0].tolist() == unvisited
    assert (empty[:, 1:] == [0, 0, -1]).all()
    pad = (slens == 0) & (srow == block)
    assert block in unvisited and not (cover[pad]).any()
    # split rows: their units own workspace slots 0, 1, ... in slot order;
    # single-unit rows write straight into the output
    counts = {r: int((units[:, 0] == r).sum()) for r in per_row}
    is_split = np.array([counts[r] > 1 for r in units[:, 0]], dtype=bool)
    assert (units[~is_split, 3] == -1).all()
    assert units[is_split, 3].tolist() == list(range(int(is_split.sum())))
    split = sched.split.numpy()
    assert split[:, 0].tolist() == sorted(r for r, c in counts.items() if c > 1)
    for row, lo, hi in split:
        assert units[units[:, 0] == row, 3].tolist() == list(range(lo, hi))
    assert sched.split_units == int(is_split.sum())
    assert sched.split_rows == len(split)
    # the workspace bound: never more than the A output, at any k the
    # trainer allows
    for k in (1, 8, 50, 64, 65, 130, 256):
        assert sched.workspace_bytes(k) <= (block + 1) * k * k * 4


def _dense_layout(block, slots_per_row, t):
    srow = np.repeat(np.arange(block), slots_per_row).astype(np.int32)
    return srow, np.full(len(srow), t, dtype=np.int32)


@pytest.mark.parametrize("layout", ["cases", "hot", "dense", "all-pad",
                                    "pack"])
def test_gather_gramian_schedule_invariants(layout):
    """The schedule's units on every test layout, at the smallest unit size
    (U = T), at 4·T and at the default; a dense block whose split rows would
    outgrow the workspace bound at the default U, so U grows; a block of pad
    slots only; and each block of the trainer's pack of row-skewed data."""
    runs = []  # (srow, slens, block, t, unit sizes)
    if layout in ("cases", "hot"):
        for case in _GG_CASES:
            k, t, block, n_slots, n_pad, hot = case.values
            if bool(hot) == (layout == "hot"):
                _, srow, _, _, _, slens = _gg_case_inputs(*case.values)
                runs.append((srow, slens, block, t,
                             (t, 4 * t, K.GG_UNIT_ENTRIES)))
    elif layout == "dense":
        # 8 rows of 200 full slots of T = 8: 4 units per row at U = 512,
        # 32 split units against a bound of 4; U must reach 2048
        srow, slens = _dense_layout(8, 200, 8)
        runs.append((srow, slens, 8, 8, (8, K.GG_UNIT_ENTRIES)))
    elif layout == "all-pad":
        runs.append((np.full(6, 5, np.int32), np.zeros(6, np.int32), 5, 8,
                     (8, K.GG_UNIT_ENTRIES)))
    else:
        batch, k = _skewed_batch(5)
        side = tr.make_blocked_side(batch.rows, batch.cols, batch.vals,
                                    len(batch.users), 64, None, 8,
                                    features=k, device="cpu")
        assert len(side.gg_schedules) == side.n_blocks
        for b, sched in enumerate(side.gg_schedules):
            srow, slens = side.srows[b].numpy(), side.slens[b].numpy()
            _check_schedule(sched, srow, slens, side.block, 8,
                            K.GG_UNIT_ENTRIES)
            runs.append((srow, slens, side.block, 8, (8, 16)))
    assert runs
    split_seen = False
    for srow, slens, block, t, sizes in runs:
        for u in sizes:
            sched = K.gather_gramian_schedule(
                torch.from_numpy(srow), torch.from_numpy(slens), block=block,
                slot_width=t, unit_entries=u)
            _check_schedule(sched, srow, slens, block, t, u)
            split_seen |= sched.split_rows > 0
            if layout == "hot" and u == t:  # the hot row spans >= 4 units
                assert int((sched.split[:, 2] - sched.split[:, 1]).max()) >= 4
            if layout == "dense" and u == K.GG_UNIT_ENTRIES:
                assert sched.unit_entries == 2048 and sched.split_rows == 0
            if layout == "all-pad":
                assert sched.units == 0 and sched.split_rows == 0
                assert sched.work.shape == (block + 1, 4)
    assert split_seen == (layout in ("cases", "hot", "pack"))


def test_gather_gramian_schedule_rejects_bad_layouts():
    srow = torch.tensor([0, 2, 1], dtype=torch.int32)
    slens = torch.tensor([4, 4, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="sorted"):
        K.gather_gramian_schedule(srow, slens, block=3, slot_width=8)
    with pytest.raises(ValueError, match="multiple"):
        K.gather_gramian_schedule(srow.sort().values, slens, block=3,
                                  slot_width=8, unit_entries=12)


@pytest.mark.parametrize("t", [24, 100, 1024])
def test_pack_takes_a_slot_width_that_does_not_divide_the_unit(t):
    """An explicit slot width packs whether or not it divides
    ``GG_UNIT_ENTRIES``: each block's schedule rounds the default unit size
    up to a multiple of T and keeps every invariant."""
    batch, k = _skewed_batch(5)
    side = tr.make_blocked_side(batch.rows, batch.cols, batch.vals,
                                len(batch.users), 64, None, t,
                                features=k, device="cpu")
    assert side.slot_width == t and len(side.gg_schedules) == side.n_blocks
    for b, sched in enumerate(side.gg_schedules):
        _check_schedule(sched, side.srows[b].numpy(), side.slens[b].numpy(),
                        side.block, t, -(-K.GG_UNIT_ENTRIES // t) * t)


@pytest.mark.parametrize("k,t,block,n_slots,n_pad,hot", _GG_CASES)
def test_gather_gramian_unit_sums_match_pallas(k, t, block, n_slots, n_pad,
                                               hot):
    """The card's two passes in plain arithmetic: ``slot_gramians`` summed
    unit by unit (each unit's slots in order), then each split row's units
    summed in unit order, rows no unit visits zero. Against the reference's
    Pallas kernel (interpret mode) at relative 1e-5 in float32 (only the
    summation order differs), at the smallest unit size, at 2·T and at
    the default."""
    y, srow, scols, w, coef, slens = _gg_case_inputs(k, t, block, n_slots,
                                                     n_pad, hot)
    ra, rb = _pallas_gg(y, srow, scols, w, coef, slens, block)
    ga, gb = K.slot_gramians(*(torch.from_numpy(v) for v in (y, scols, w,
                                                             coef)))
    for u in (t, 2 * t, K.GG_UNIT_ENTRIES):
        sched = K.gather_gramian_schedule(
            torch.from_numpy(srow), torch.from_numpy(slens), block=block,
            slot_width=t, unit_entries=u)
        a = torch.full((block + 1, k, k), float("nan"))
        b = torch.full((block + 1, k), float("nan"))
        ws_a = torch.empty((sched.split_units, k, k))
        ws_b = torch.empty((sched.split_units, k))
        for row, lo, hi, slot in sched.work.tolist():  # pass 1
            pa, pb = torch.zeros((k, k)), torch.zeros(k)
            for s in range(lo, hi):
                pa, pb = pa + ga[s], pb + gb[s]
            if slot < 0:
                a[row], b[row] = pa, pb
            else:
                ws_a[slot], ws_b[slot] = pa, pb
        for row, lo, hi in sched.split.tolist():  # pass 2
            pa, pb = torch.zeros((k, k)), torch.zeros(k)
            for p in range(lo, hi):
                pa, pb = pa + ws_a[p], pb + ws_b[p]
            a[row], b[row] = pa, pb
        a, b = a.numpy(), b.numpy()
        assert np.isfinite(a).all() and np.isfinite(b).all()  # every row set
        assert np.abs(a - ra).max() / np.abs(ra).max() < 1e-5
        assert np.abs(b - rb).max() / np.abs(rb).max() < 1e-5
        unvisited = np.setdiff1d(np.arange(block + 1), srow[slens > 0])
        assert not a[unvisited].any() and not b[unvisited].any()


@pytest.mark.parametrize("k", [1, 5, 50, 64])
@pytest.mark.parametrize("b", [0, 1, 33, 257])
def test_spd_plain_matches_pallas(b, k):
    """Relative error 1e-4 against the Pallas Gauss-Jordan (interpret mode),
    the reference's own tolerance against LAPACK."""
    a, rhs = _spd(np.random.default_rng(SEED + 1000 * b + k), b, k)
    ref = np.asarray(pk.spd_solve_batched(a, rhs, interpret=True),
                     dtype=np.float32)
    x = K.spd_solve_batched(torch.from_numpy(a), torch.from_numpy(rhs)).numpy()
    assert x.shape == (b, k) and np.isfinite(x).all()
    if b:
        assert np.abs(x - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.parametrize("k", [10, 50])
def test_spd_plain_holds_at_large_pivots(k):
    """Pivots of 3·10^3 to 2·10^4, as an ALS item block's popular items give
    them: the port's plain version, which writes the normalised pivot row,
    stays within 1e-5 of a float64 solve; the reference's fused step, which
    gets that row as aug_j − (piv − 1)·aug_j/piv, loses ~log2(piv) bits and
    misses the kernels' 1e-4 tolerance (a fault of the reference, not
    copied)."""
    rng = np.random.default_rng(SEED + k)
    m = rng.standard_normal((64, k, k)).astype(np.float32)
    a = ((m @ m.transpose(0, 2, 1) / k
          + np.eye(k, dtype=np.float32) * rng.uniform(1, 10, (64, k, 1)))
         * 2e3).astype(np.float32)
    rhs = (rng.standard_normal((64, k)) * 2e3).astype(np.float32)
    exact = np.linalg.solve(a.astype(np.float64), rhs[..., None])[..., 0]

    def rel_err(x):
        x = np.asarray(x, dtype=np.float64)
        return np.abs(x - exact).max() / np.abs(exact).max()

    pivots = np.diagonal(a, axis1=1, axis2=2)
    assert 1e3 < pivots.min() and pivots.max() < 1e5
    x = K.spd_solve_batched(torch.from_numpy(a), torch.from_numpy(rhs))
    assert rel_err(x.numpy()) < 1e-5
    assert rel_err(pk.spd_solve_batched(a, rhs, interpret=True)) > 1e-4


def test_spd_past_the_gate_solves_by_cholesky():
    """k = 241 is the first k whose augmented matrix does not fit the
    card's shared memory: the solve is a Cholesky one, on any device,
    and still right (relative 1e-3 against LAPACK at this size)."""
    k = 241
    a, rhs = _spd(np.random.default_rng(SEED), 2, k)
    x = K.spd_solve_batched(torch.from_numpy(a), torch.from_numpy(rhs)).numpy()
    ref = np.stack([np.linalg.solve(a[i].astype(np.float64), rhs[i])
                    for i in range(2)])
    assert np.abs(x - ref).max() / np.abs(ref).max() < 1e-3


def test_gates_at_their_boundaries():
    # gather-Gramian: the reference's gate, unchanged
    for k in (1, 50, 255, 256, 257, 512):
        assert K.gather_gramian_supported(k) == pk.gather_gramian_supported(k)
    assert K.gather_gramian_supported(256)
    assert not K.gather_gramian_supported(257)
    # SPD: 4·k·(k+2) bytes of shared memory within the H100's 232,448
    assert K.spd_use_kernel(1) and K.spd_use_kernel(50)
    assert K.spd_use_kernel(240)
    assert not K.spd_use_kernel(241)
    assert 4 * 240 * 241 <= K.SMEM_BYTES < 4 * 241 * 242


@pytest.mark.parametrize("k,variant", [(1, "warp"), (64, "warp"), (65, "cta"),
                                       (240, "cta"), (241, "cholesky")])
def test_spd_variant_at_its_boundaries(k, variant):
    """The warp kernel up to k = 64 (registers), the CTA kernel up to the
    shared-memory gate, Cholesky past it."""
    assert K.spd_variant(k) == variant
    assert K.spd_use_kernel(k) == (variant != "cholesky")


def test_spd_warp_crossover_matches_the_source():
    """``SPD_WARP_MAX_FEATURES`` is the crossover the CUDA source builds in
    (the wrapper also checks the built library before its first launch)."""
    source = (Path(K.__file__).parent / "csrc" / "spd_solve.cu").read_text()
    found = re.findall(r"constexpr int kWarpMaxK = (\d+);", source)
    assert found == [str(K.SPD_WARP_MAX_FEATURES)]


def test_unsupported_device_raises():
    y = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.spd_solve_batched(torch.zeros((1, 3, 3), device="meta"),
                            torch.zeros((1, 3), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        K.gather_gramian_accumulate(
            y, torch.zeros(1, dtype=torch.int32), torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros((1, 2)), torch.zeros((1, 2)), torch.zeros(1, dtype=torch.int32),
            block=1,
        )
