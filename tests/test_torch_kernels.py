"""The port's two trainer kernels against the reference's Pallas kernels.

On the CPU each wrapper in ``oryx_tpu_torch.ops.kernels`` runs its plain
PyTorch version (the CUDA kernels exist only on the card), so these tests
pin the plain versions — the arithmetic the kernels are held to on the card —
against the reference's Pallas kernels run in interpret mode, on the same
inputs made from a seed with numpy. The kernels themselves are checked
against these plain versions on the card by ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oryx_tpu.ops import pallas_kernels as pk
from oryx_tpu_torch.ops import kernels as K
from test_kernel_differential import _gg_reference
from test_torch_cuda import SEED, _gg_inputs, _spd, _torch_dtype

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

# (k, T, block, real slots, pad slots): the production k, a k that is not
# tile-round, a single-slot grid, and T = 16 as the user side packs it
_GG_CASES = [(50, 8, 24, 20, 4), (13, 16, 12, 9, 3), (8, 8, 6, 1, 0),
             (50, 16, 10, 14, 2)]


@pytest.mark.parametrize("k,t,block,n_slots,n_pad", _GG_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_gramian_plain_matches_pallas(k, t, block, n_slots, n_pad,
                                             dtype):
    """Tolerance, relative to the largest |value|: 1e-5 in float32 (only
    the summation order differs); 2e-2 in bfloat16 (the Pallas kernel
    rounds each w·y product to bf16, the port keeps it in f32)."""
    y, srow, scols, w, coef, slens = _gg_inputs(SEED + k * t + block, k, t,
                                                block, n_slots, n_pad)
    jy = jnp.asarray(y).astype(jnp.dtype(dtype))
    ra, rb = pk.gather_gramian_accumulate(
        jy, jnp.asarray(srow), jnp.asarray(scols), jnp.asarray(w),
        jnp.asarray(coef), jnp.asarray(slens), block=block, interpret=True,
    )
    ra = np.asarray(ra, dtype=np.float32)
    rb = np.asarray(rb, dtype=np.float32)
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
    assert 4 * 240 * 241 <= K.SPD_SMEM_BYTES < 4 * 241 * 242


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
