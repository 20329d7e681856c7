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
