"""The port's Lloyd-sweep kernel against the reference's Pallas kernel.

On the CPU :func:`oryx_tpu_torch.ops.kernels.kmeans_assign_accumulate` runs
its plain PyTorch version (the CUDA kernel exists only on the card), so
these tests pin the plain version — the arithmetic the kernel is held to on
the card — against the reference's ``pallas_kernels.kmeans_assign_accumulate``
in interpret mode, on the same inputs made from a seed with numpy. The
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from oryx_tpu.ops import pallas_kernels as pk
from oryx_tpu_torch.ops import kernels as K

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)


def _uniform():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((700, 5)), np.ones(700),
            rng.standard_normal((7, 5)))


def _padding_weights():
    rng = np.random.default_rng(1)
    weights = np.zeros(100)
    weights[:60] = 1.0  # the last 40 rows are padding
    return (rng.standard_normal((100, 3)), weights,
            rng.standard_normal((4, 3)))


def _ties():
    rng = np.random.default_rng(2)
    points = np.repeat(rng.standard_normal((50, 4)), 2, axis=0)
    return points, rng.uniform(0.5, 2.0, 100), points[:6].copy()


def _off_every_multiple():
    """N, D and K off the TPU kernel's 512 / 128 / 8 tiles, non-uniform
    weights with some zeros, and centres drawn from the points."""
    rng = np.random.default_rng(3)
    points = rng.standard_normal((1013, 9)) * 3.0
    weights = rng.uniform(0.0, 2.0, 1013)
    weights[rng.random(1013) < 0.1] = 0.0
    return points, weights, points[rng.choice(1013, 9, replace=False)]


# test_pallas.py's three cases and one off every TPU multiple
_CASES = {"uniform": _uniform, "padding_weights": _padding_weights,
          "ties": _ties, "off_every_multiple": _off_every_multiple}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_sweep_matches_pallas(case):
    """The same nearest centre for every point (these inputs hold no
    near-ties, and exact ties go to the lowest index in both): counts under
    unit weights are exact. Weighted counts rtol 1e-6, sums rtol/atol 1e-4
    and cost rel 1e-4: float32 sums of the same terms in another order."""
    points, weights, centers = (a.astype(np.float32) for a in _CASES[case]())
    r_sums, r_counts, r_cost = pk.kmeans_assign_accumulate(
        points, weights, centers, interpret=True)
    r_sums, r_counts = (np.asarray(a, dtype=np.float32)
                        for a in (r_sums, r_counts))
    before = dict(K.LAUNCHES)
    sums, counts, cost = K.kmeans_assign_accumulate(
        torch.from_numpy(points), torch.from_numpy(weights),
        torch.from_numpy(centers))
    assert K.LAUNCHES == before  # CPU tensors never reach a kernel
    assert sums.shape == centers.shape and counts.shape == (len(centers),)
    assert cost.shape == ()
    np.testing.assert_allclose(counts.numpy(), r_counts, rtol=1e-6)
    np.testing.assert_allclose(sums.numpy(), r_sums, rtol=1e-4, atol=1e-4)
    assert float(cost) == pytest.approx(float(r_cost), rel=1e-4)
    ones = np.ones_like(weights)
    _, u_counts, _ = pk.kmeans_assign_accumulate(points, ones, centers,
                                                 interpret=True)
    _, counts, _ = K.kmeans_assign_accumulate(
        torch.from_numpy(points), torch.from_numpy(ones),
        torch.from_numpy(centers))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(u_counts))


def test_ties_go_to_the_lowest_index():
    """Two identical centres: every point nearest them goes to the first."""
    points = np.array([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0]], np.float32)
    centers = np.array([[0.0, 0.0], [0.0, 0.0], [5.0, 5.0]], np.float32)
    _, counts, _ = K.kmeans_assign_accumulate(
        torch.from_numpy(points), torch.ones(3), torch.from_numpy(centers))
    assert counts.tolist() == [2.0, 0.0, 1.0]
    _, r_counts, _ = pk.kmeans_assign_accumulate(points, np.ones(3, np.float32),
                                                 centers, interpret=True)
    assert np.asarray(r_counts).tolist() == [2.0, 0.0, 1.0]


def test_parts_depend_on_the_shape_only():
    """The kernel's partial-slab count: one per 256 points, at most 1024,
    and a workspace of at most 2^26 floats."""
    assert K.kmeans_parts(1, 7, 5) == 1
    assert K.kmeans_parts(700, 7, 5) == 3
    assert K.kmeans_parts(1_000_000, 256, 64) == 1024
    slab = 1024 * 128 + 1024 + 1
    assert K.kmeans_parts(50_000, 1024, 128) == min(196, (1 << 26) // slab)
    assert K.kmeans_parts(10 ** 7, 100_000, 1000) == 1


def test_unsupported_device_raises():
    z = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.kmeans_assign_accumulate(z, torch.zeros(2, device="meta"), z)


# (N, K, D): one point, D off every multiple of 4 and of 32, the smoke's
# shapes, and K·D past the shared-memory slab
_PLAN_SHAPES = [(1, 3, 1), (700, 7, 5), (1013, 9, 130), (100_000, 256, 64),
                (1_000_000, 256, 64), (50_000, 1024, 128), (129, 1024, 3)]


@pytest.mark.parametrize("n,k,d", _PLAN_SHAPES)
def test_sweep_plan_gives_every_slab_entry_one_owner(n, k, d):
    """Every (centre, column) sum, every count and the cost is owned by
    exactly one walk thread, as the kernel assigns them."""
    plan = K.kmeans_sweep_plan(n, k, d)
    owners: dict = {}
    for thread in range(plan.walk_threads):
        for entry in plan.walk_entries(thread):
            owners.setdefault(entry, []).append(thread)
    want = ({("sum", c, col) for c in range(k) for col in range(d)}
            | {("count", c) for c in range(k)} | {("cost",)})
    assert set(owners) == want
    assert all(len(t) == 1 for t in owners.values())
    assert plan.slab_floats == len(want)


@pytest.mark.parametrize("n,k,d", _PLAN_SHAPES)
def test_sweep_plan_fits_the_card(n, k, d):
    """Each launch's shared bytes fit one H100 CTA (232,448); the walk's
    groups are whole warps within one CTA, and at most one group a centre;
    the tiles cover N; the parts are :func:`kmeans_parts`'s and cover N in
    order."""
    plan = K.kmeans_sweep_plan(n, k, d)
    for nbytes in (plan.assign_smem_bytes, plan.walk_smem_bytes,
                   plan.reduce_smem_bytes):
        assert 0 <= nbytes <= K.SMEM_BYTES == 232_448
    assert plan.assign_smem_bytes == 93_440
    tiles = 4 * 4 * 32 * (plan.walk_cols + 3)
    assert plan.walk_smem_bytes == tiles + (
        16 * -(-(k * d + k + 1) // 4) if plan.slab_in_smem else 0)
    if 4 * (k * d + k + 1) <= 60_000:
        assert plan.slab_in_smem
    if 4 * (k * d + k + 1) > K.KMEANS_SLAB_SMEM_BYTES:
        assert not plan.slab_in_smem
    assert plan.walk_cols % 32 == 0 and plan.walk_cols >= min(d, 256)
    assert plan.walk_threads <= K.KMEANS_WALK_THREADS
    assert 1 <= plan.walk_groups <= k
    assert plan.walk_groups & (plan.walk_groups - 1) == 0
    assert 2 * plan.walk_groups * plan.walk_cols > min(
        K.KMEANS_WALK_THREADS, k * plan.walk_cols)
    assert plan.parts == K.kmeans_parts(n, k, d)
    assert 0 < n <= plan.parts * plan.per
    assert (plan.tiles - 1) * K.KMEANS_TILE_POINTS < n \
        <= plan.tiles * K.KMEANS_TILE_POINTS


def test_sweep_plan_depends_on_the_shape_alone():
    """The same shape gives the same plan, with no device or data to read;
    the smoke's shapes get the geometry the kernel was measured with."""
    assert K.kmeans_sweep_plan(100_000, 256, 64) == \
        K.kmeans_sweep_plan(100_000, 256, 64)
    plan = K.kmeans_sweep_plan(1_000_000, 256, 64)
    assert (plan.tiles, plan.stages, plan.parts, plan.walk_cols,
            plan.walk_groups, plan.slab_in_smem) == (15625, 2, 1024, 64, 8, True)
    wide = K.kmeans_sweep_plan(50_000, 1024, 128)
    assert (wide.walk_cols, wide.walk_groups, wide.slab_in_smem) == \
        (128, 4, False)
    assert K.kmeans_sweep_plan(1, 3, 1).walk_groups == 2
    with pytest.raises(ValueError):
        K.kmeans_sweep_plan(0, 3, 1)
