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


def _gg_inputs(seed, k, t, block, n_slots, n_pad, n_factor_rows=40):
    """A sorted slotted layout over a random subset of the block's rows (so
    some rows are never visited), slots with 0..T valid entries, and pad
    slots owned by the spill row; weights zero past each slot's length."""
    rng = np.random.default_rng(seed)
    owners = np.sort(rng.choice(block, size=n_slots, replace=True))
    srow = np.concatenate([owners, np.full(n_pad, block)]).astype(np.int32)
    s = len(srow)
    slens = rng.integers(0, t + 1, s).astype(np.int32)
    slens[0] = t  # at least one full slot
    slens[n_slots:] = 0
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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 50, 240])
def test_spd_kernel_matches_plain(cuda_device, k):
    """Relative 1e-4, the reference's tolerance for the same algorithm."""
    a, rhs = _spd(np.random.default_rng(SEED + k), 33, k)
    ta, tb = (torch.from_numpy(v).to(cuda_device) for v in (a, rhs))
    before = K.LAUNCHES["spd_solve_batched"]
    x = K.spd_solve_batched(ta, tb)
    torch.cuda.synchronize()
    assert K.LAUNCHES["spd_solve_batched"] == before + 1
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
    cx, cy = tr.als_train(batch, k, 0.1, 1.0, True, 2, init_y=y0, block=256,
                          device="cpu", fused_gramian=True, spd_kernel=True)
    for got, ref in ((x.cpu(), cx), (y.cpu(), cy)):
        assert (got - ref).abs().max() / ref.abs().max() < 1e-4


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
                                   (5000, 256, 64), (20000, 1024, 128)])
def test_kmeans_kernel_matches_plain_on_planted_blobs(cuda_device, n, k, d):
    """Shapes off every tile, one point, the smoke's K and D, and K·D past
    the shared-memory slab (the partial sums then live in device memory)."""
    rng = np.random.default_rng(SEED + n + k)
    pts, means = _blob_points(rng, n, k, d)
    weights = rng.uniform(0.5, 2.0, n).astype(np.float32)
    weights[rng.random(n) < 0.1] = 0.0
    if n == 1:
        weights[:] = 1.0
    t = [torch.from_numpy(a).to(cuda_device) for a in (pts, weights, means)]
    _sweep_against_plain(*t, near_ties=False)


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
