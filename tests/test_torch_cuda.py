"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode). The file imports neither JAX nor the reference package, so it
runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.) The plain versions
are themselves held against the reference's Pallas kernels by
``tests/test_torch_kernels.py`` and ``tests/test_torch_kmeans_kernel.py``
on the CPU.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from oryx_tpu_torch.models.als import train as tr
from oryx_tpu_torch.models.als.data import RatingBatch
from oryx_tpu_torch.models.kmeans import train as kmtrain
from oryx_tpu_torch.ops import kernels as K
from chip_smoke import sweep_check

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

SEED = 0x7A1C


def _gg_inputs(seed, k, t, block, n_slots, n_pad, n_factor_rows=40, hot=0):
    """A sorted slotted layout over a random subset of the block's rows (so
    some rows are never visited), slots with 0..T valid entries, and pad
    slots owned by the spill row; weights zero past each slot's length.
    ``hot`` more slots go to one row (a popular item), after the draws of
    the layout without them."""
    rng = np.random.default_rng(seed)
    owners = np.sort(rng.choice(block, size=n_slots, replace=True))
    if hot:
        owners = np.sort(np.concatenate([owners, np.full(hot, owners[0])]))
    srow = np.concatenate([owners, np.full(n_pad, block)]).astype(np.int32)
    s = len(srow)
    slens = rng.integers(0, t + 1, s).astype(np.int32)
    slens[0] = t  # at least one full slot
    slens[len(owners):] = 0
    scols = rng.integers(0, n_factor_rows, (s, t)).astype(np.int32)
    mask = np.arange(t)[None, :] < slens[:, None]
    w = ((np.abs(rng.standard_normal((s, t))) + 0.1) * mask).astype(np.float32)
    coef = (rng.standard_normal((s, t)) * mask).astype(np.float32)
    y = rng.standard_normal((n_factor_rows, k)).astype(np.float32)
    return y, srow, scols, w, coef, slens


def _torch_dtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _spd(rng, b, k):
    m = rng.standard_normal((b, k, k)).astype(np.float32) * 0.3
    a = np.einsum("bij,bkj->bik", m, m) + 2.0 * np.eye(k, dtype=np.float32)
    return a.astype(np.float32), rng.standard_normal((b, k)).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_gramian_kernel_matches_plain(cuda_device, dtype):
    """The CUDA kernel against its plain version on the card; relative
    1e-5 (f32: summation order only) — bf16 rounds identically on both."""
    y, srow, scols, w, coef, slens = _gg_inputs(SEED, 70, 16, 40, 60, 8)
    args = [torch.from_numpy(v).to(cuda_device)
            for v in (srow, scols, w, coef, slens)]
    ty = torch.from_numpy(y).to(_torch_dtype(dtype)).to(cuda_device)
    before = K.LAUNCHES["gather_gramian_accumulate"]
    a, b = K.gather_gramian_accumulate(ty, *args, block=40)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gather_gramian_accumulate"] == before + 1
    pa, pb = K.gather_gramian_accumulate_plain(ty, *args, block=40)
    assert (a - pa).abs().max() / pa.abs().max() < 1e-5
    assert (b - pb).abs().max() / pb.abs().max() < 1e-5


def _gg_on_card(device, dtype, y, srow, scols, w, coef, slens, block):
    """Two kernel calls on the same block, the first building its own
    schedule, the second given it: the same bits from both; one main launch
    per call at the block's shape, plus one reduce launch per call where the
    schedule has a split row. Returns (A, b, plain A, plain b, schedule)."""
    args = [torch.from_numpy(v).to(device)
            for v in (srow, scols, w, coef, slens)]
    ty = torch.from_numpy(y).to(_torch_dtype(dtype)).to(device)
    sched = K.gather_gramian_schedule(args[0], args[4], block=block,
                                      slot_width=scols.shape[1])
    before = dict(K.SHAPE_LAUNCHES)
    a, b = K.gather_gramian_accumulate(ty, *args, block=block)
    a2, b2 = K.gather_gramian_accumulate(ty, *args, block=block,
                                         schedule=sched)
    torch.cuda.synchronize()
    assert torch.equal(a, a2) and torch.equal(b, b2)
    shape = (block + 1, *scols.shape, y.shape[1], str(ty.dtype))
    after = dict(before)
    for kernel, n in (("gather_gramian_accumulate", 2),
                      ("gather_gramian_accumulate.reduce",
                       2 if sched.split_rows else 0)):
        if n:
            after[(kernel, shape)] = after.get((kernel, shape), 0) + n
    assert K.SHAPE_LAUNCHES == after
    pa, pb = K.gather_gramian_accumulate_plain(ty, *args, block=block)
    return a, b, pa, pb, sched


# k: each side of the 64-wide tile edges (one tile up to 64, four at 65,
# nine at 130) and the production 50
@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 50, 64, 65, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_gramian_kernel_splits_a_hot_row(cuda_device, k, dtype):
    """A row of 200 extra slots (~1,600 entries: at least 4 units at the
    default unit size) beside ordinary rows: relative 1e-5 against the
    plain version (f32 sums in another order; bf16 rounds alike on both);
    rows no slot visits and the spill row exactly 0; two calls bitwise
    equal; the reduce launched once per call."""
    block = 40
    y, srow, scols, w, coef, slens = _gg_inputs(
        SEED + k, k, 16, block, 60, 8, n_factor_rows=300, hot=200)
    a, b, pa, pb, sched = _gg_on_card(cuda_device, dtype, y, srow, scols, w,
                                      coef, slens, block)
    assert sched.split_rows >= 1
    assert int((sched.split[:, 2] - sched.split[:, 1]).max()) >= 4
    assert (a - pa).abs().max() / pa.abs().max() < 1e-5
    assert (b - pb).abs().max() / pb.abs().max() < 1e-5
    unvisited = np.setdiff1d(np.arange(block + 1), srow[slens > 0])
    assert block in unvisited and len(unvisited) > 1
    assert not a[unvisited].any() and not b[unvisited].any()


@pytest.mark.cuda
def test_gather_gramian_kernel_on_an_all_pad_block(cuda_device):
    """Pad slots only: every row, the spill row included, exactly 0, and no
    reduce launch."""
    block, t = 12, 16
    y = np.random.default_rng(SEED).standard_normal((20, 50)).astype(np.float32)
    srow = np.full(5, block, np.int32)
    scols = np.zeros((5, t), np.int32)
    w = coef = np.zeros((5, t), np.float32)
    slens = np.zeros(5, np.int32)
    a, b, _, _, sched = _gg_on_card(cuda_device, "float32", y, srow, scols, w,
                                    coef, slens, block)
    assert sched.units == 0 and sched.split_rows == 0
    assert a.shape == (block + 1, 50, 50) and not a.any() and not b.any()


@pytest.mark.cuda
def test_gather_gramian_kernel_on_a_dense_block(cuda_device):
    """8 rows of 200 full slots: the schedule raises the unit size to keep
    the workspace within the output's size; relative 1e-5 against the
    plain version."""
    rng = np.random.default_rng(SEED + 1)
    block, t, k = 8, 8, 50
    srow = np.repeat(np.arange(block), 200).astype(np.int32)
    slens = np.full(len(srow), t, np.int32)
    scols = rng.integers(0, 500, (len(srow), t)).astype(np.int32)
    w = (np.abs(rng.standard_normal((len(srow), t))) + 0.1).astype(np.float32)
    coef = rng.standard_normal((len(srow), t)).astype(np.float32)
    y = rng.standard_normal((500, k)).astype(np.float32)
    a, b, pa, pb, sched = _gg_on_card(cuda_device, "float32", y, srow, scols,
                                      w, coef, slens, block)
    assert sched.unit_entries > K.GG_UNIT_ENTRIES
    assert sched.workspace_bytes(k) <= (block + 1) * k * k * 4
    assert (a - pa).abs().max() / pa.abs().max() < 1e-5
    assert (b - pb).abs().max() / pb.abs().max() < 1e-5


def _solve_on_card(a, rhs, device, variant):
    """One ``spd_solve_batched`` call on the card: the kernel ``variant``
    launches once at the systems' shape (nothing for an empty batch);
    returns (x, plain x)."""
    ta, tb = (torch.from_numpy(v).to(device) for v in (a, rhs))
    before = dict(K.SHAPE_LAUNCHES)
    x = K.spd_solve_batched(ta, tb)
    torch.cuda.synchronize()
    after = dict(before)
    if len(rhs):
        key = (f"spd_solve_batched.{variant}", rhs.shape)
        after[key] = after.get(key, 0) + 1
    assert K.SHAPE_LAUNCHES == after
    return x, K.spd_solve_batched_plain(ta, tb)


# k: each side of the warp kernel's boundaries (one row per lane up to 32,
# two past it; the CTA kernel past 64), the widths in use (10, the
# reference default; 50, the smoke's), and the CTA kernel up to its gate;
# batch sizes 0, 1 and 33, which is not a multiple of the warp kernel's 2
# warps per CTA
@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 16, 31, 32, 33, 50, 64, 65, 128, 240])
@pytest.mark.parametrize("batch", [0, 1, 33])
def test_spd_kernel_matches_plain(cuda_device, k, batch):
    """Relative 1e-4, the reference's tolerance for the same algorithm."""
    variant = "warp" if k <= 64 else "cta"
    assert K.spd_variant(k) == variant
    a, rhs = _spd(np.random.default_rng(SEED + 1000 * batch + k), batch, k)
    x, ref = _solve_on_card(a, rhs, cuda_device, variant)
    assert x.shape == (batch, k) and bool(torch.isfinite(x).all())
    if batch:
        assert (x - ref).abs().max() / ref.abs().max() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 50, 128])
def test_spd_kernel_reads_rows_as_stored(cuda_device, k):
    """A non-symmetric, diagonally dominant A (no pivoting needed): the
    kernels agree with the plain version, which reads A's rows, to relative
    1e-4, and not with the solve of Aᵀ."""
    rng = np.random.default_rng(SEED + k)
    a = rng.uniform(-1.0, 1.0, (37, k, k)).astype(np.float32)
    a += (2.0 * k * np.eye(k, dtype=np.float32)
          * rng.uniform(1.0, 2.0, (37, k, 1)).astype(np.float32))
    rhs = rng.standard_normal((37, k)).astype(np.float32)
    x, ref = _solve_on_card(a, rhs, cuda_device, K.spd_variant(k))
    assert (x - ref).abs().max() / ref.abs().max() < 1e-4
    transposed = torch.linalg.solve(torch.from_numpy(a).transpose(1, 2),
                                    torch.from_numpy(rhs))
    assert (x.cpu() - transposed).abs().max() / transposed.abs().max() > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 50, 128])
def test_spd_kernel_is_deterministic(cuda_device, k):
    """Two calls on the same inputs give the same bits (no atomics)."""
    a, rhs = _spd(np.random.default_rng(SEED + 7 * k), 257, k)
    ta, tb = (torch.from_numpy(v).to(cuda_device) for v in (a, rhs))
    assert torch.equal(K.spd_solve_batched(ta, tb), K.spd_solve_batched(ta, tb))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 50])
def test_spd_library_crossover_and_cta_entry(cuda_device, k):
    """The library sends k <= ``SPD_WARP_MAX_FEATURES`` to its warp kernel;
    its CTA entry, which only measurements call, solves the same systems
    to relative 1e-4 of the plain version."""
    from oryx_tpu_torch.ops import _build

    lib = _build.library("spd_solve")
    assert lib.oryx_spd_warp_max_k() == K.SPD_WARP_MAX_FEATURES
    cta = lib.oryx_spd_solve_cta
    cta.argtypes, cta.restype = K._SIGNATURES["oryx_spd_solve"]
    a, rhs = _spd(np.random.default_rng(SEED + 3 * k), 65, k)
    ta, tb = (torch.from_numpy(v).to(cuda_device) for v in (a, rhs))
    x = torch.empty_like(tb)
    assert cta(ta.data_ptr(), tb.data_ptr(), x.data_ptr(), 65, k,
               torch.cuda.current_stream().cuda_stream) == 0
    ref = K.spd_solve_batched_plain(ta, tb)
    assert (x - ref).abs().max() / ref.abs().max() < 1e-4


@pytest.mark.cuda
def test_als_train_on_the_card_matches_the_cpu(cuda_device):
    """The trainer's kernel path on the card against its plain path on the
    CPU, from the same Y₀: relative 1e-4 after 2 iterations (float32 sums
    in another order)."""
    rng = np.random.default_rng(SEED)
    n_users, n_items, nnz, k = 700, 300, 9000, 50
    rows = np.sort(rng.integers(0, n_users, nnz)).astype(np.int32)
    batch = RatingBatch(rows, rng.integers(0, n_items, nnz).astype(np.int32),
                        np.ones(nnz, np.float32), range(n_users),
                        range(n_items))
    y0 = 0.1 * rng.standard_normal((n_items, k)).astype(np.float32)
    K.reset_launches()
    x, y = tr.als_train(batch, k, 0.1, 1.0, True, 2, init_y=y0, block=256)
    assert K.LAUNCHES["gather_gramian_accumulate"] > 0
    assert K.LAUNCHES["spd_solve_batched"] > 0
    assert {kernel for kernel, _ in K.SHAPE_LAUNCHES} == {
        "gather_gramian_accumulate", "spd_solve_batched.warp"}
    cx, cy = tr.als_train(batch, k, 0.1, 1.0, True, 2, init_y=y0, block=256,
                          device="cpu", fused_gramian=True, spd_kernel=True)
    for got, ref in ((x.cpu(), cx), (y.cpu(), cy)):
        assert (got - ref).abs().max() / ref.abs().max() < 1e-4


@pytest.mark.cuda
def test_half_iteration_with_packed_schedules_makes_no_host_sync(cuda_device):
    """An item half-iteration through the kernels with the pack's
    gather-Gramian schedules (a hot item makes split rows) runs with
    PyTorch's synchronisation check set to raise, and gives the same
    factors as schedules built anew from the packed device slots."""
    rng = np.random.default_rng(SEED + 3)
    n_users, n_items, nnz, k = 2000, 60, 20_000, 16
    cols = np.where(rng.random(nnz) < 0.3, 0,
                    rng.integers(1, n_items, nnz)).astype(np.int32)
    rows = rng.integers(0, n_users, nnz).astype(np.int32)
    keep = np.unique(rows.astype(np.int64) * n_items + cols, return_index=True)[1]
    rows, cols = rows[np.sort(keep)], cols[np.sort(keep)]
    order = np.argsort(rows, kind="stable")
    batch = RatingBatch(rows[order], cols[order], np.ones(len(rows), np.float32),
                        range(n_users), range(n_items))
    _, items = tr.prepare_blocked(batch, k, device=cuda_device)
    assert any(sc.split_rows for sc in items.gg_schedules)
    x = torch.from_numpy(
        0.1 * rng.standard_normal((n_users, k)).astype(np.float32)).to(cuda_device)

    def half(schedules):
        return tr.solve_side_blocked(
            x, items.srows, items.scols, items.svals, items.slens, 0.1, 1.0,
            block=items.block, features=k, implicit=True,
            slot_chunk=items.slot_chunk, schedules=schedules)

    ref = half([K.gather_gramian_schedule(  # also builds the kernels
        items.srows[b], items.slens[b], block=items.block,
        slot_width=items.slot_width) for b in range(items.n_blocks)])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = half(items.gg_schedules)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, ref)


# -- k-means Lloyd sweep --------------------------------------------------------


def _blob_points(rng, n, k, d, spread=10.0):
    means = rng.uniform(-spread, spread, (k, d))
    return (means[rng.integers(0, k, n)] + rng.standard_normal((n, d))) \
        .astype(np.float32), means.astype(np.float32)


def _sweep_against_plain(points, weights, centers, near_ties):
    """One launch of the kernel, held against its plain version by
    ``chip_smoke.sweep_check`` (its docstring states each tolerance)."""
    before = K.LAUNCHES["kmeans_assign_accumulate"]
    sweep_check(points, weights, centers, near_ties, "test")
    assert K.LAUNCHES["kmeans_assign_accumulate"] > before


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(700, 7, 5), (1013, 9, 9), (1, 3, 2),
                                   (5000, 256, 64), (20000, 1024, 128),
                                   (3000, 64, 300)])
def test_kmeans_kernel_matches_plain_on_planted_blobs(cuda_device, n, k, d):
    """Shapes off every tile, one point, the smoke's K and D, K·D past the
    shared-memory slab (the partial sums then live in device memory), and D
    past one 256-column walk pass."""
    rng = np.random.default_rng(SEED + n + k)
    pts, means = _blob_points(rng, n, k, d)
    weights = rng.uniform(0.5, 2.0, n).astype(np.float32)
    weights[rng.random(n) < 0.1] = 0.0
    if n == 1:
        weights[:] = 1.0
    t = [torch.from_numpy(a).to(cuda_device) for a in (pts, weights, means)]
    _sweep_against_plain(*t, near_ties=False)


def _blob_sweep_inputs(device, seed, n, k, d):
    rng = np.random.default_rng(seed)
    pts, means = _blob_points(rng, n, k, d)
    return [torch.from_numpy(a).to(device)
            for a in (pts, np.ones(n, np.float32), means)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 4, 63, 65])
def test_kmeans_kernel_at_ragged_widths(cuda_device, d):
    """D off the 4-float vectors (scalar loads) and around the 32-dimension
    stages and the walk's 32-thread column groups, at the smoke's K."""
    _sweep_against_plain(*_blob_sweep_inputs(cuda_device, SEED + d, 3000, 256, d),
                         near_ties=False)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [127, 128, 129])
def test_kmeans_kernel_around_one_tile(cuda_device, n):
    """N just under, at and over two of the assign launch's 64-point
    tiles."""
    _sweep_against_plain(*_blob_sweep_inputs(cuda_device, SEED + n, n, 256, 64),
                         near_ties=False)


@pytest.mark.cuda
def test_kmeans_kernel_takes_unaligned_rows(cuda_device):
    """Points and centres that start 4 bytes past a 16-byte boundary are
    read by the kernel's scalar loads, not sent to the plain version: the
    launch is counted and the bits equal the aligned inputs' bits."""
    pts, weights, centers = _blob_sweep_inputs(cuda_device, SEED + 5, 2000, 256, 64)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=cuda_device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    u_pts, u_centers = shifted(pts), shifted(centers)
    assert u_pts.is_contiguous() and u_pts.data_ptr() % 16 == 4
    assert not K.kmeans_vector_loads(u_pts, u_centers)
    assert K.kmeans_vector_loads(pts, centers)
    before = K.LAUNCHES["kmeans_assign_accumulate"]
    got = K.kmeans_assign_accumulate(u_pts, weights, u_centers)
    assert K.LAUNCHES["kmeans_assign_accumulate"] == before + 1
    want = K.kmeans_assign_accumulate(pts, weights, centers)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    _sweep_against_plain(u_pts, weights, u_centers, near_ties=False)


@pytest.mark.cuda
def test_kmeans_kernel_matches_plain_with_near_ties(cuda_device):
    rng = np.random.default_rng(SEED)
    pts = rng.standard_normal((200_000, 64), dtype=np.float32)
    centers = rng.standard_normal((256, 64), dtype=np.float32)
    t = [torch.from_numpy(a).to(cuda_device)
         for a in (pts, np.ones(len(pts), np.float32), centers)]
    _sweep_against_plain(*t, near_ties=True)


@pytest.mark.cuda
def test_kmeans_kernel_is_deterministic_and_ties_low(cuda_device):
    """The same inputs give the same bits; duplicated centres take no points
    (ties go to the lower index); weight-0 points contribute nothing."""
    rng = np.random.default_rng(SEED + 1)
    pts, means = _blob_points(rng, 30_000, 40, 16)
    means[7] = means[3]
    t = [torch.from_numpy(a).to(cuda_device)
         for a in (pts, np.ones(len(pts), np.float32), means)]
    a = K.kmeans_assign_accumulate(*t)
    b = K.kmeans_assign_accumulate(*t)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a[1][7]) == 0.0 and float(a[1][3]) > 0
    w = t[1].clone()
    w[::2] = 0.0
    half = K.kmeans_assign_accumulate(t[0][1::2].contiguous(), t[1][1::2].contiguous(),
                                      t[2])
    masked = K.kmeans_assign_accumulate(t[0], w, t[2])
    assert torch.equal(half[1], masked[1])
    assert torch.allclose(half[0], masked[0], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_kmeans_train_on_the_card_matches_the_cpu(cuda_device):
    """From the same injected centres on planted blobs: the card's sweep
    kernel and the CPU's plain version assign alike, so counts are exact and
    centres agree to 1e-4 after 6 iterations; seeded runs on the card launch
    the kernel runs × (iterations + 1) times."""
    rng = np.random.default_rng(SEED + 2)
    pts, means = _blob_points(rng, 20_000, 32, 16)
    c0 = pts[rng.choice(len(pts), 32, replace=False)]
    K.reset_launches()
    centers, counts = kmtrain.kmeans_train(pts, 32, iterations=6, runs=1,
                                           init_centers=c0)
    assert K.LAUNCHES["kmeans_assign_accumulate"] == 7
    c_centers, c_counts = kmtrain.kmeans_train(pts, 32, iterations=6, runs=1,
                                               init_centers=c0, device="cpu")
    np.testing.assert_array_equal(counts, c_counts)
    np.testing.assert_allclose(centers, c_centers, rtol=1e-4, atol=1e-4)
    for init in (kmtrain.INIT_KMEANS_PARALLEL, kmtrain.INIT_RANDOM):
        K.reset_launches()
        centers, counts = kmtrain.kmeans_train(
            pts, 32, iterations=3, runs=2, init=init,
            generator=torch.Generator().manual_seed(3))
        assert K.LAUNCHES["kmeans_assign_accumulate"] == 2 * 4
        assert centers.shape == (32, 16) and counts.sum() == len(pts)
        assert np.isfinite(centers).all()


def _als_lines(rng, n_users, n_items, per_user):
    """``user,item,1,ts`` lines: each user's top items under planted rank-3
    preferences, timestamps shuffled."""
    scores = rng.standard_normal((n_users, 3)) @ rng.standard_normal((3, n_items))
    pairs = [(u, i) for u in range(n_users)
             for i in np.argsort(-scores[u])[:per_user]]
    ts = rng.permutation(len(pairs)) * 1000
    return [f"u{u},i{i},1,{t}" for (u, i), t in zip(pairs, ts.tolist())]


@pytest.mark.cuda
def test_als_generation_on_the_card_matches_the_cpu(cuda_device, monkeypatch,
                                                    tmp_path):
    """One small ``ALSUpdate.run_update`` (two λ candidates, k = 50, 2
    iterations, 4 row blocks a side) on the card and with
    ``device="cpu"``, from the same test seed: the same keys, ids, order
    and known items; vectors within relative 1e-4 (the card-vs-CPU bound
    of the trainer test above); each candidate launched both ALS kernels
    once per row block per iteration. On the CPU the trainer takes the
    kernels' plain versions, as the card-vs-CPU trainer test does."""
    from oryx_tpu_torch.api.keymessage import KeyMessage
    from oryx_tpu_torch.common import config, rand
    from oryx_tpu_torch.models.als.update import ALSUpdate

    rng = np.random.default_rng(SEED + 3)
    msgs = [KeyMessage(None, ln) for ln in _als_lines(rng, 900, 400, 12)]
    conf = config.overlay_on(
        {"oryx.als.iterations": 2, "oryx.als.hyperparams.features": 50,
         "oryx.als.hyperparams.lambda": [0.1, 1.0],
         "oryx.ml.eval.candidates": 2,
         "oryx.ml.eval.hyperparam-search": "grid"}, config.get_default())
    monkeypatch.setattr(tr, "_even_block", lambda n, k, ndev, block: -(-n // 4))
    runs = {}
    for name, device in (("card", None), ("cpu", "cpu")):
        if device == "cpu":
            monkeypatch.setattr(tr, "_resolve_paths", lambda *a: (True, True))
        rand.use_test_seed()
        K.reset_launches()
        sent = []
        update = ALSUpdate(conf, device=device)
        producer = type("P", (), {"send": lambda self, k, m, headers=None:
                                  sent.append((k, m))})()
        update.run_update(None, 7, msgs, [], str(tmp_path / name), producer)
        runs[name] = (update.report, sent, dict(K.LAUNCHES))
    (report, sent, launches), (cpu_report, cpu_sent, cpu_launches) = (
        runs["card"], runs["cpu"])
    cands = report["candidates"].values()
    assert len(cands) == 2 and all("failed" not in c for c in cands)
    assert all(c["device"].startswith("cuda") for c in cands)
    want = sum(2 * (c["blocks"]["user"] + c["blocks"]["item"]) for c in cands)
    assert all(c["blocks"] == {"user": 4, "item": 4} for c in cands)
    for kernel in ("gather_gramian_accumulate", "spd_solve_batched"):
        assert launches[kernel] == want and cpu_launches[kernel] == 0
    assert report["combos"] == cpu_report["combos"]
    assert report["best"] == cpu_report["best"]
    assert [k for k, _ in sent] == [k for k, _ in cpu_sent]
    assert sent[0][0] == "MODEL" and len(sent) > 1000
    ups = [json.loads(m) for _, m in sent[1:]]
    cpu_ups = [json.loads(m) for _, m in cpu_sent[1:]]
    assert [u[:2] + u[3:] for u in ups] == [u[:2] + u[3:] for u in cpu_ups]
    for kind in ("X", "Y"):
        got = np.array([u[2] for u in ups if u[0] == kind])
        ref = np.array([u[2] for u in cpu_ups if u[0] == kind])
        assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.cuda
def test_incremental_snapshot_on_the_card_equals_a_whole_upload(cuda_device):
    """The store's device matrix after rounds of mixed point updates and
    appends: each round's matrix, taken incrementally, ``torch.equal`` to
    the store uploaded whole; a matrix once handed out is unchanged by
    later rounds."""
    from oryx_tpu_torch.models.als.vectors import FeatureVectorStore

    rng = np.random.default_rng(SEED + 5)
    store = FeatureVectorStore()
    n, k = 3000, 50
    store.bulk_load([f"i{j}" for j in range(n)],
                    rng.standard_normal((n, k)).astype(np.float32))
    _, first = store.materialize()
    held = first.clone()
    for r in range(4):
        for j in rng.choice(n, 200, replace=False).tolist():
            store.set_vector(f"i{j}", rng.standard_normal(k).astype(np.float32))
        for j in range(r * 30):
            store.set_vector(f"new{r}-{j}", rng.standard_normal(k).astype(np.float32))
        ids, mat = store.materialize()
        host_ids, host, _, _ = store.host_matrix()
        assert mat.device.type == "cuda" and list(ids[:mat.shape[0]]) == host_ids
        assert torch.equal(mat, torch.from_numpy(host).to(cuda_device))
    assert store.materializations == {"full": 1, "incremental": 4}
    assert torch.equal(first, held)
    vtv = store.get_vtv()  # on the card's matrix
    assert np.abs(vtv - host.T.astype(np.float64) @ host).max() < 1e-5 * np.abs(vtv).max()


@pytest.mark.cuda
def test_speed_updates_served_on_the_card_equal_the_cpu(cuda_device, tmp_path):
    """A generation's stream and a speed microbatch's UPs served by one
    manager on the card and one on the CPU: the same Y bytes on both
    devices (the card's taken incrementally) and the same top-10 ids, scores
    within 1e-5 (float32 products in another order)."""
    from oryx_tpu_torch.api.keymessage import KeyMessage
    from oryx_tpu_torch.common import config
    from oryx_tpu_torch.models.als import pmml_codec
    from oryx_tpu_torch.models.als.serving import ALSServingModelManager
    from oryx_tpu_torch.models.als.speed import ALSSpeedModelManager
    from oryx_tpu_torch.pmml import pmmlutils

    rng = np.random.default_rng(SEED + 6)
    k, n_users, n_items = 50, 400, 300
    x = (rng.standard_normal((n_users, k)) * 0.2).astype(np.float32)
    y = (rng.standard_normal((n_items, k)) * 0.2).astype(np.float32)
    users = [f"u{j}" for j in range(n_users)]
    items = [f"i{j}" for j in range(n_items)]
    pmml = pmml_codec.model_to_pmml(x, y, users, items, k, 0.1, 1.0, True, False,
                                    1e-5, tmp_path / "m")
    stream = [KeyMessage("MODEL", pmmlutils.to_string(pmml))]
    stream += [KeyMessage("UP", json.dumps(["Y", i, v.tolist()]))
               for i, v in zip(items, y)]
    stream += [KeyMessage("UP", json.dumps(["X", u, v.tolist(), [items[j % n_items]]]))
               for j, (u, v) in enumerate(zip(users, x))]
    conf = config.overlay_on({"oryx.als.hyperparams.features": k},
                             config.get_default())
    speed = ALSSpeedModelManager(conf)
    card = ALSServingModelManager(conf)
    cpu = ALSServingModelManager(conf, device="cpu")
    for mgr in (speed, card, cpu):
        mgr.consume(stream)
    card.get_model().y_snapshot()  # the whole upload, before the UPs
    lines = [f"u{rng.integers(0, n_users + 20)},i{rng.integers(0, n_items + 10)},1,{t}"
             for t in range(2000)]
    ups = list(speed.build_updates([KeyMessage(None, ln) for ln in lines]))
    assert len(ups) > 1000
    for mgr in (speed, card, cpu):
        mgr.consume(KeyMessage("UP", u) for u in ups)
    model, cpu_model = card.get_model(), cpu.get_model()
    snap, cpu_snap = model.y_snapshot(), cpu_model.y_snapshot()
    assert model.y.materializations == {"full": 1, "incremental": 1}
    assert torch.equal(snap.mat.cpu(), cpu_snap.mat)
    assert list(snap.ids[:snap.n]) == list(cpu_snap.ids[:cpu_snap.n])
    qs = np.stack([model.get_user_vector(u) for u in users[:64]])
    excluded = [model.get_known_items(u) for u in users[:64]]
    got = model.top_n_batch(qs, 10, excluded=excluded)
    want = cpu_model.top_n_batch(qs, 10, excluded=excluded)
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=0,
                                   atol=1e-5)
    got = model.top_n_cosine(qs[:3], 10)
    want = cpu_model.top_n_cosine(qs[:3], 10)
    assert [i for i, _ in got] == [i for i, _ in want]


@pytest.mark.cuda
def test_lambda_loop_on_the_card_emits_the_cpu_loop_updates(cuda_device, tmp_path):
    """The ALS lambda loop through ``memory:`` topics with the layers on the
    card (``platform`` null: ``chip_smoke.LambdaLoop`` at a small size):
    the batch layer trains on the card and launches both ALS kernels. The
    same loop with ``platform = "cpu"``, on its own broker, takes that
    generation's stream on its update topic, then both loops fold in the
    same two microbatches: the speed layers' ``UP`` streams are equal byte
    for byte (the fold-in is host float64 on either platform, so the same
    stream and lines give the same bytes), and the serving managers on the
    card and on the CPU give the same top-10 ids, scores within 1e-5. The
    generation itself, card against CPU, is held by
    ``test_als_generation_on_the_card_matches_the_cpu``."""
    from oryx_tpu_torch.transport import topic as tp
    from chip_smoke import LambdaLoop

    rng = np.random.default_rng(SEED + 7)
    lines = _als_lines(rng, 600, 300, 10)
    gen_lines, held_out = lines[:-1000], lines[-1000:]
    small = {"oryx.als.hyperparams.features": 8, "oryx.als.iterations": 2}
    tp.reset_memory_brokers()
    card = LambdaLoop(str(tmp_path / "card"), {**small, "oryx.id": "card"},
                      broker="memory:card")
    cpu = LambdaLoop(str(tmp_path / "cpu"), {
        **small, "oryx.id": "cpu",
        "oryx.batch.streaming.config.platform": "cpu",
        "oryx.speed.streaming.config.platform": "cpu"},
        broker="memory:cpu", serving_device="cpu")
    try:
        K.reset_launches()
        card.run_batch(gen_lines, 0.2, 0.5, 300)
        cands = card.update.report["candidates"].values()
        assert all(c["device"].startswith("cuda") for c in cands)
        assert card.batch.get_context().device.type == "cuda"
        want = sum(2 * (c["blocks"]["user"] + c["blocks"]["item"]) for c in cands)
        for kernel in ("gather_gramian_accumulate", "spd_solve_batched"):
            assert K.LAUNCHES[kernel] == want
        generation = card.broker.read(card.update_topic, 0, card.update_size())
        cpu.seed_updates(generation, 0.5)
        for b in range(2):
            mb_lines = held_out[b * 500:(b + 1) * 500]
            got = {}
            for name, loop in (("card", card), ("cpu", cpu)):
                loop.settle(60, f"{name} microbatch {b}")
                mb = loop.microbatch(mb_lines, f"{name} microbatch {b}", 60)
                got[name] = [km.message for km in mb["published"]]
            assert len(got["card"]) > 250 and got["card"] == got["cpu"]
        for loop in (card, cpu):
            loop.wait_applied(loop.served, loop.update_size(), 60, "serving")
    finally:
        card.close()
        cpu.close()
        tp.reset_memory_brokers()
    card.await_layers()
    cpu.await_layers()
    model, cpu_model = card.serving.get_model(), cpu.serving.get_model()
    assert model.y_snapshot().mat.device.type == "cuda"
    users = sorted(model.all_user_ids())[:64]
    qs = np.stack([model.get_user_vector(u) for u in users])
    excluded = [model.get_known_items(u) for u in users]
    assert excluded == [cpu_model.get_known_items(u) for u in users]
    got = model.top_n_batch(qs, 10, excluded=excluded)
    want = cpu_model.top_n_batch(qs, 10, excluded=excluded)
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=0,
                                   atol=1e-5)


@pytest.mark.cuda
def test_serving_layer_on_the_card_answers_as_on_the_cpu(cuda_device, tmp_path):
    """One ``MODEL`` + ``UP`` stream (seeded factors, five known items per
    user) into a serving layer on the card and one on the CPU, both on the
    same ``memory:`` update topic; 200 seeded ``/recommend`` requests to
    each through stdlib ``http.client``: ids equal (a near tie may order
    its ids either way) and scores within 1e-5 relative."""
    from chip_smoke import HttpClient, applied_messages, check_same_top_n, wait_until
    from oryx_tpu_torch.common import config as cfg
    from oryx_tpu_torch.common import ioutils
    from oryx_tpu_torch.models.als import pmml_codec
    from oryx_tpu_torch.pmml import pmmlutils
    from oryx_tpu_torch.serving.app import ServingLayer
    from oryx_tpu_torch.transport import topic as tp

    rng = np.random.default_rng(SEED)
    n_users, n_items, k = 2_000, 3_000, 16
    users = [f"u{j}" for j in range(n_users)]
    items = [f"i{j}" for j in range(n_items)]
    x = rng.standard_normal((n_users, k)).astype(np.float32)
    y = rng.standard_normal((n_items, k)).astype(np.float32)
    pmml = pmml_codec.model_to_pmml(x, y, users, items, k, 0.1, 1.0, True,
                                    False, 1e-5, tmp_path)
    tp.reset_memory_brokers()
    conf = cfg.overlay_on({
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.models.als.serving.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu_torch.serving.resources.als",
    }, cfg.get_default())
    tp.maybe_create_topics(conf, "input-topic", "update-topic")
    prod = tp.TopicProducerImpl("memory:", "OryxUpdate")
    prod.send("MODEL", pmmlutils.to_string(pmml))
    for id_, vec in pmml_codec.read_features(tmp_path / "Y"):
        prod.send("UP", json.dumps(["Y", id_, [float(v) for v in vec]]))
    for id_, vec in pmml_codec.read_features(tmp_path / "X"):
        known = [items[j] for j in rng.choice(n_items, 5, replace=False)]
        prod.send("UP", json.dumps(["X", id_, [float(v) for v in vec], known]))
    total = tp.get_broker("memory:").size("OryxUpdate")
    layers = []
    try:
        for device in (None, "cpu"):
            port = ioutils.choose_free_port()
            layer = ServingLayer(conf.with_values({"oryx.serving.api.port": port}),
                                 device=device)
            layers.append((layer, HttpClient(port)))
            layer.start()
        for layer, _ in layers:
            wait_until(lambda layer=layer: applied_messages(layer) >= total, 120,
                       "the layer's replay")
        card, cpu = (layer.manager.get_model() for layer, _ in layers)
        assert card.y_snapshot().mat.device.type == "cuda"
        assert cpu.y_snapshot().mat.device.type == "cpu"
        for u in rng.choice(users, 200, replace=False):
            path = f"/recommend/{u}?howMany=10"
            want = [(e["id"], e["value"]) for e in layers[1][1].json(path)]
            check_same_top_n(layers[0][1].json(path), want, path)
    finally:
        for layer, client in layers:
            client.close()
            layer.close()
        tp.reset_memory_brokers()


@pytest.mark.cuda
def test_deployment_serving_replica_on_the_card_over_tcp(cuda_device, tmp_path):
    """The CLI's broker and one serving replica, each a process
    (``python -m oryx_tpu_torch.cli``, ``chip_smoke.Deployment``), the
    replica on the card (``platform`` null); one ``MODEL`` + ``UP`` stream
    (seeded factors, five known items per user) produced over ``tcp:``
    from this process, whose own manager on the card consumes it too: 200
    seeded ``/recommend`` answers equal the manager's (ids; scores within
    1e-5 relative), ``/readyz`` 200 with the model loaded, the replica's
    build info on ``cuda``, and both processes exit 0 on SIGTERM."""
    from chip_smoke import Deployment, HttpClient, check_recommend
    from oryx_tpu_torch.models.als import pmml_codec
    from oryx_tpu_torch.pmml import pmmlutils
    from oryx_tpu_torch.transport import topic as tp

    rng = np.random.default_rng(SEED + 11)
    n_users, n_items, k = 2_000, 3_000, 16
    users = [f"u{j}" for j in range(n_users)]
    items = [f"i{j}" for j in range(n_items)]
    x = rng.standard_normal((n_users, k)).astype(np.float32)
    y = rng.standard_normal((n_items, k)).astype(np.float32)
    pmml = pmml_codec.model_to_pmml(x, y, users, items, k, 0.1, 1.0, True,
                                    False, 1e-5, tmp_path / "model")
    tp.reset_tcp_clients()
    dep = Deployment(str(tmp_path), {"oryx.als.hyperparams.features": k},
                     replicas=1)
    try:
        dep.start_broker()
        dep.start_replicas()
        dep.start_local()
        prod = tp.TopicProducerImpl(dep.url, dep.update_topic)
        prod.send("MODEL", pmmlutils.to_string(pmml))
        for id_, vec in pmml_codec.read_features(tmp_path / "model" / "Y"):
            prod.send("UP", json.dumps(["Y", id_, [float(v) for v in vec]]))
        for id_, vec in pmml_codec.read_features(tmp_path / "model" / "X"):
            known = [items[j] for j in rng.choice(n_items, 5, replace=False)]
            prod.send("UP", json.dumps(["X", id_, [float(v) for v in vec], known]))
        prod.close()
        total = dep.update_size()
        dep.wait_local(total, 120, "the local manager")
        dep.wait_replicas(total, 120, "the replica")
        model = dep.local.get_model()
        assert model.y_snapshot().mat.device.type == "cuda"
        client = HttpClient(dep.replica_ports[0])
        try:
            status, _, body = client.request("GET", "/readyz")
            assert status == 200 and json.loads(body)["model"] == "loaded"
            sample = [users[j] for j in rng.choice(n_users, 100, replace=False)]
            assert check_recommend(client, model, sample, None, "replica") == 200
        finally:
            client.close()
        info = dep.metrics(0)["oryx_build_info"]
        assert any('backend="cuda"' in key and v == 1.0 for key, v in info.items())
        for name in ("serving-0", "broker"):
            assert dep.terminate(name)["rc"] == 0
    except BaseException:
        print(dep.tails())
        raise
    finally:
        dep.close()
        tp.reset_tcp_clients()


def _planted_items(seed, n_centers=64, reps=200, k=32, noise=0.25):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, k)).astype(np.float32) * 2.0
    items = (np.repeat(centers, reps, axis=0)
             + rng.standard_normal((n_centers * reps, k)).astype(np.float32) * noise)
    qs = (centers[rng.integers(0, n_centers, 24)]
          + rng.standard_normal((24, k)).astype(np.float32) * noise)
    return items, qs, [f"i{j}" for j in range(len(items))]


def _serving_pair(device_dtype, sample_rate, items, ids, **kw):
    """The same model on the card and on the CPU (LSH drawn under the same
    test seed)."""
    from oryx_tpu_torch.common import rand
    from oryx_tpu_torch.models.als.serving import ALSServingModel

    out = []
    for dev in ("cuda", "cpu"):
        rand.use_test_seed()
        m = ALSServingModel(items.shape[1], True, sample_rate,
                            device_dtype=device_dtype, device=dev, **kw)
        m.bulk_load_items(ids, items)
        out.append(m)
    return out


def _ids(results):
    return [[i for i, _ in r] for r in results]


@pytest.mark.cuda
@pytest.mark.parametrize("device_dtype,sample_rate", [
    ("int8", 1.0), ("int8", 0.3), ("bfloat16", 1.0), ("bfloat16", 0.3),
    ("float32", 0.3)])
def test_serving_representations_on_the_card_answer_as_the_cpu(
        cuda_device, device_dtype, sample_rate):
    """int8 (exact rescore from the host slab: the same ids and the same
    score bits as the CPU's), bfloat16 (float32 output of a bf16 product on
    the card: the same ids, scores within 1e-3 relative of the CPU's
    bf16-rounded float32 product) and LSH masks (the same buckets) on the
    card against the port's own CPU results, with exclusions and a filter."""
    items, qs, ids = _planted_items(SEED + 11)
    card, cpu = _serving_pair(device_dtype, sample_rate, items, ids)
    rng = np.random.default_rng(SEED + 12)
    excluded = [[ids[j] for j in rng.choice(len(ids), 5, replace=False)]
                for _ in range(len(qs))]
    allowed = lambda i: int(i[1:]) % 4 != 0  # noqa: E731
    for kw in ({}, {"excluded": excluded},
               {"alloweds": [allowed] * len(qs), "excluded": excluded}):
        a, b = card.top_n_batch(qs, 10, **kw), cpu.top_n_batch(qs, 10, **kw)
        if device_dtype == "int8":
            assert a == b  # ids and exact scores
        else:
            assert _ids(a) == _ids(b)
            rel = 1e-3 if device_dtype == "bfloat16" else 1e-5
            np.testing.assert_allclose([s for r in a for _, s in r],
                                       [s for r in b for _, s in r], rtol=rel)
    if sample_rate < 1:
        snap_a, snap_b = card.y_snapshot(), cpu.y_snapshot()
        assert torch.equal(snap_a.buckets.cpu(), snap_b.buckets)
    assert _ids([card.top_n_cosine(qs[:3], 10)]) == _ids([cpu.top_n_cosine(qs[:3], 10)])
    assert _ids([card.top_n(qs[0], 10, allowed=allowed)]) == _ids(
        [cpu.top_n(qs[0], 10, allowed=allowed)])


@pytest.mark.cuda
def test_int8_scan_on_the_card_stays_in_its_chunks(cuda_device, monkeypatch):
    """With chunks forced to 4,096 rows the quantized candidate scan's
    transient stays below one float32 copy of the slab; its running top-r
    is the top-r of the whole score matrix (the same bits), and its values
    are the CPU's within 1e-5 relative."""
    from oryx_tpu_torch.models.als import serving

    items, qs, ids = _planted_items(SEED + 13, reps=800)
    monkeypatch.setattr(serving, "_SCAN_BYTES", 4 * (len(qs) + items.shape[1]) * 4096)
    card, cpu = _serving_pair("int8", 1.0, items, ids)
    snap_a, snap_b = card.y_snapshot(), cpu.y_snapshot()
    qa = torch.as_tensor(qs, device=cuda_device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    va, ia = serving._quant_candidates(snap_a, qa, 64)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < items.size * 4
    whole = serving._quant_masked_scores(snap_a, qa)
    assert torch.equal(va, torch.topk(whole, 64, dim=1).values)
    assert torch.equal(whole.gather(1, ia), va)
    vb, _ = serving._quant_candidates(snap_b, torch.as_tensor(qs), 64)
    np.testing.assert_allclose(va.cpu().numpy(), vb.numpy(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("sample_rate", [1.0, 0.3])
def test_ivf_on_the_card_answers_as_the_cpu_and_keeps_its_cells(cuda_device,
                                                                 sample_rate):
    """The IVF index built on the card from the same centroids as on the
    CPU: the same cell tables byte for byte, the same ids (and exact
    scores) for batches, single queries and cosine; after a burst of moved,
    rewritten and new rows the card's incremental snapshot equals a rebuild
    on the card with the same centroids, bit for bit, and the CPU's."""
    from oryx_tpu_torch.models.als import ivf

    items, qs, ids = _planted_items(SEED + 14)
    card, cpu = _serving_pair("int8", sample_rate, items, ids,
                              index_enabled=True, index_cells=64, index_probes=4)
    centroids = ivf.IVFSnapshot.build(
        *cpu.y.host_matrix()[:3], None, cpu.y.host_matrix()[3],
        cells=64, device="cpu").centroids_np
    for m in (card, cpu):
        i_, host, version, view = m.y.host_matrix()
        m._snapshot = ivf.IVFSnapshot.build(
            i_, host, version, m.lsh, view, centroids=centroids, probes=4,
            device=m.device)
    tables = ("cell_pos", "cell_q", "cell_scale", "cell_norms")
    sa, sb = card.y_snapshot(), cpu.y_snapshot()
    for name in tables:
        assert torch.equal(getattr(sa, name).cpu(), getattr(sb, name)), name
    excluded = [[ids[j] for j in range(b, 400, 37)] for b in range(len(qs))]
    assert card.top_n_batch(qs, 10, excluded=excluded) == cpu.top_n_batch(
        qs, 10, excluded=excluded)
    assert card.top_n(qs[1], 10) == cpu.top_n(qs[1], 10)
    assert _ids([card.top_n_cosine(qs[:2], 10)]) == _ids([cpu.top_n_cosine(qs[:2], 10)])
    rng = np.random.default_rng(SEED + 15)
    burst = [(f"i{j}", items[(j + 200 * 7) % len(items)]
              + rng.standard_normal(items.shape[1]).astype(np.float32) * 0.25)
             for j in rng.choice(len(items), 300, replace=False).tolist()]
    burst += [(f"new{j}", items[j * 50] * 1.01) for j in range(40)]
    for m in (card, cpu):
        for id_, v in burst:
            m.set_item_vector(id_, v)
    s1, c1 = card.y_snapshot(), cpu.y_snapshot()
    assert s1.centroids_np is sa.centroids_np and s1.n == len(items) + 40
    i_, host, version, view = card.y.host_matrix()
    rebuilt = ivf.IVFSnapshot.build(i_, host, version, card.lsh, view,
                                    centroids=centroids,
                                    cell_width=s1.cell_width, device=cuda_device)
    for name in tables:
        assert torch.equal(getattr(s1, name), getattr(rebuilt, name)), name
        assert torch.equal(getattr(s1, name).cpu(), getattr(c1, name)), name


@pytest.mark.cuda
def test_rdf_forest_on_the_card_matches_the_cpu(cuda_device):
    """``forest_train`` on the card against its CPU run from the same
    generator seed, on 4,000 covtype-shaped rows: classification (4 trees,
    depth 6) grows the same trees, node for node, or first differs at a
    near-tie (both best gains within 1e-6 relative: ``log`` may round
    apart on the two devices); regression (3 trees) gives equal bits on
    the card twice, equal to the CPU's. No kernel launches."""
    from chip_smoke import covtype_data, first_tree_difference
    from oryx_tpu_torch.models.rdf import train as rdftrain

    data = covtype_data(np.random.default_rng(SEED), 4_000)
    is_cat = [False] * 10 + [True] * 44
    n_cat = [0] * 10 + [2] * 44

    def grow(task, trees, device):
        levels = []
        forest, imp = rdftrain.forest_train(
            data["X"], data["cover"] if task == rdftrain.CLASSIFICATION else data["y"],
            is_cat, n_cat, task=task, n_classes=7, num_trees=trees, max_depth=6,
            max_split_candidates=32, min_node_size=4, min_info_gain_nats=0.0,
            rng=np.random.default_rng(SEED + 1), device=device, levels_out=levels)
        return forest, imp, levels

    K.reset_launches()
    card = grow(rdftrain.CLASSIFICATION, 4, None)
    cpu = grow(rdftrain.CLASSIFICATION, 4, "cpu")
    diff = first_tree_difference(card[0], cpu[0], card[2], cpu[2])
    assert diff is None or (diff["kind"] == "split" and diff["gain_rel"] <= 1e-6), diff
    runs = [grow(rdftrain.REGRESSION, 3, None) for _ in range(2)]
    reg_cpu = grow(rdftrain.REGRESSION, 3, "cpu")
    assert first_tree_difference(runs[0][0], runs[1][0], runs[0][2], runs[1][2]) is None
    assert np.array_equal(runs[0][1], runs[1][1])
    for a, b in zip(runs[0][2], runs[1][2]):
        for la, lb in zip(a, b):
            assert all(np.array_equal(la[k], lb[k]) for k in la)
    assert first_tree_difference(runs[0][0], reg_cpu[0], runs[0][2], reg_cpu[2]) is None
    assert not any(K.LAUNCHES.values())
