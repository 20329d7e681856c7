"""The port's ALS trainer against the reference's, on the same inputs.

* the host pack is the reference's numpy code: bit-identical slabs;
* one half-iteration through the fused gather-Gramian + Gauss-Jordan path
  (the reference's Pallas kernels in interpret mode, the port's plain
  versions) agrees for implicit/explicit feedback and f32/bf16 inputs;
* a whole 2-iteration ``als_train`` agrees when both start from the
  reference's own Y₀, injected through ``oryx_tpu_torch.state``.
"""

from __future__ import annotations

import threading

import jax
import numpy as np
import pytest
import torch

from oryx_tpu.models.als import train as ref_tr
from oryx_tpu_torch import state
from oryx_tpu_torch.models.als import train as tr
from oryx_tpu_torch.models.als.data import RatingBatch
from oryx_tpu_torch.parallel.mesh import ShardedRows, make_mesh
from test_gramian_kernel import _skewed_batch

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)


def _port_batch(batch):
    """The same COO arrays and id maps as a port-side RatingBatch."""
    return RatingBatch(batch.rows, batch.cols, batch.vals, batch.users,
                       batch.items)


def test_make_blocked_side_is_bit_identical():
    batch, k = _skewed_batch(5)
    for rows, cols, n in ((batch.rows, batch.cols, len(batch.users)),
                          (batch.cols, batch.rows, len(batch.items))):
        ref = ref_tr.make_blocked_side(rows, cols, batch.vals, n, 64, None,
                                       None, features=k)
        got = tr.make_blocked_side(rows, cols, batch.vals, n, 64, None, None,
                                   features=k, device="cpu")
        for name in ("srows", "scols", "svals", "slens"):
            r = np.asarray(getattr(ref, name))
            g = getattr(got, name).numpy()
            assert g.dtype == r.dtype and g.shape == r.shape, name
            assert np.array_equal(g, r), name
        for name in ("n_rows", "block", "n_blocks", "slot_width",
                     "slot_chunk", "padded_rows"):
            assert getattr(got, name) == getattr(ref, name), name


def test_prepare_blocked_matches_reference_layout():
    batch, k = _skewed_batch(6)
    ref_u, ref_i = ref_tr.prepare_blocked(batch, k)
    got_u, got_i = tr.prepare_blocked(_port_batch(batch), k, device="cpu")
    for ref, got in ((ref_u, got_u), (ref_i, got_i)):
        assert (got.block, got.n_blocks, got.slot_width, got.slot_chunk) == (
            ref.block, ref.n_blocks, ref.slot_width, ref.slot_chunk)
        assert np.array_equal(got.scols.numpy(), np.asarray(ref.scols))
        assert np.array_equal(got.svals.numpy(), np.asarray(ref.svals))


@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_half_iteration_matches_reference_kernels(implicit, dtype):
    """Tolerance relative to the largest |factor|: 1e-4 in float32 (the
    same Gauss-Jordan, other summation order), 2e-2 in bfloat16 (the
    Pallas kernel rounds each weighted product to bf16)."""
    batch, k = _skewed_batch(3, explicit=not implicit)
    ref_u, ref_i = ref_tr.prepare_blocked(batch, k, block=64)
    y = np.asarray(ref_tr.init_item_factors(
        ref_i, len(batch.items), k, jax.random.PRNGKey(0)))
    ref = np.asarray(ref_tr.solve_side_blocked(
        y, ref_u.srows, ref_u.scols, ref_u.svals, ref_u.slens, 0.01, 1.3,
        block=ref_u.block, features=k, implicit=implicit,
        slot_chunk=ref_u.slot_chunk, dtype=dtype, spd_kernel=True,
        fused_gramian=True,
    ), dtype=np.float32)
    got_u, _ = tr.prepare_blocked(_port_batch(batch), k, block=64,
                                  device="cpu")
    got = tr.solve_side_blocked(
        state.init_y(y, device="cpu"), got_u.srows, got_u.scols, got_u.svals,
        got_u.slens, 0.01, 1.3, block=got_u.block, features=k,
        implicit=implicit, slot_chunk=got_u.slot_chunk,
        schedules=got_u.gg_schedules, dtype=dtype, spd_kernel=True,
        fused_gramian=True,
    ).numpy()
    assert got.shape == ref.shape
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert np.abs(got - ref).max() / np.abs(ref).max() < tol
    empty = np.flatnonzero(np.bincount(batch.rows, minlength=got.shape[0]) == 0)
    assert len(empty) and not got[empty].any()


def test_fused_and_unfused_paths_agree():
    """The port's own two formulations (plain kernel versions vs chunked
    einsum + Cholesky) on the CPU: relative 1e-4."""
    batch, k = _skewed_batch(4)
    b = _port_batch(batch)
    args = dict(iterations=2, device="cpu", block=64)
    x1, y1 = tr.als_train(b, k, 0.01, 1.0, True, generator=torch.Generator()
                          .manual_seed(3), fused_gramian=True,
                          spd_kernel=True, **args)
    x2, y2 = tr.als_train(b, k, 0.01, 1.0, True, generator=torch.Generator()
                          .manual_seed(3), fused_gramian=False,
                          spd_kernel=False, chunk=16, **args)
    for a, r in ((x1, x2), (y1, y2)):
        assert (a - r).abs().max() / r.abs().max() < 1e-4


@pytest.mark.parametrize("implicit", [True, False])
def test_als_train_matches_reference_from_injected_y0(implicit):
    """2 iterations from the reference's Y₀; factors within relative 1e-3
    (two alternations of float32 solves in another summation order)."""
    batch, k = _skewed_batch(7, explicit=not implicit)
    key = jax.random.PRNGKey(11)
    ref_x, ref_y = ref_tr.als_train(batch, k, 0.05, 1.0, implicit,
                                    iterations=2, key=key)
    block_i = ref_tr._even_block(len(batch.items), k, 1, None)
    y0 = ref_tr._init_factors(ref_tr._padded_rows_for(len(batch.items),
                                                      block_i),
                              len(batch.items), k, key)
    timings: dict = {}
    x, y = tr.als_train(_port_batch(batch), k, 0.05, 1.0, implicit,
                        iterations=2, init_y=state.init_y(y0, device="cpu"),
                        timings=timings, device="cpu")
    for got, ref in ((x, ref_x), (y, ref_y)):
        ref = np.asarray(ref, dtype=np.float32)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 1e-3
    assert len(timings["iter_s"]) == 2 and timings["pack_s"] >= 0.0
    # the pack worker is joined on return
    assert not any(t.name.startswith("oryx-als-pack")
                   for t in threading.enumerate())


def test_unported_arguments_raise():
    """``mesh`` with ``row_axis`` trains on the mesh (padded, row-sharded
    factors); either alone is ignored, as in the reference; a bad compute
    dtype still raises."""
    batch, k = _skewed_batch(8)

    def train(**kwargs):
        return tr.als_train(_port_batch(batch), k, 0.01, 1.0, True,
                            iterations=1, device="cpu",
                            generator=torch.Generator().manual_seed(1),
                            **kwargs)

    mesh = make_mesh(axes=("model",), devices=["cpu"] * 2)
    x1, y1 = train()
    x2, y2 = train(mesh=mesh, row_axis="model")
    assert isinstance(x2, ShardedRows) and x2.n_shards == 2
    assert torch.allclose(x2.full()[:x1.shape[0]], x1, rtol=2e-4, atol=2e-5)
    assert torch.allclose(y2.full()[:y1.shape[0]], y1, rtol=2e-4, atol=2e-5)
    for alone in ({"mesh": mesh}, {"row_axis": "model"}):
        assert torch.equal(train(**alone)[0], x1)
    with pytest.raises(ValueError, match="compute dtype"):
        tr.als_train(_port_batch(batch), k, 0.01, 1.0, True, dtype="bf16",
                     device="cpu")
