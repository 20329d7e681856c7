"""ALS incremental fold-in: the speed/serving update step.

A copy of the JAX package's ``oryx_tpu/models/als/foldin.py`` (host numpy,
no JAX), held equal to it by ``tests/test_torch_als_speed.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's ALSUtils (app/oryx-app-common/.../als/
ALSUtils.java:37-106): given a new interaction (u, i, value), compute the
target estimated strength Qui' (implicit: interpolate between current estimate
and 1/0 by strength; explicit: the new value), then the factor delta
dXu = solve(YtY, dQui·Yi) and Xu += dXu. The same math updates item vectors
from user vectors.

The solve itself is a tiny k×k backsubstitution against the cached Gramian
factorization (ops/solver.py). Aggregated interactions within a microbatch are
independent — each reads the pre-batch X/Y and updates only land when the
layer hears its own UP messages (as in the reference's parallelStream fold,
ALSSpeedModelManager.java:198-220) — so the whole microbatch collapses into
one stacked-RHS batched solve (compute_updated_batch); compute_updated_xu is
the single-interaction form used by serving fold-in.
"""

from __future__ import annotations

import math

import numpy as np

from oryx_tpu_torch.ops.solver import Solver


def compute_target_qui(implicit: bool, value: float, current_value: float) -> float:
    """Target estimated strength, or NaN for 'no change'
    (ALSUtils.computeTargetQui:37-59)."""
    if implicit:
        if value > 0.0 and current_value < 1.0:
            diff = 1.0 - max(0.0, current_value)
            return current_value + (value / (1.0 + value)) * diff
        if value < 0.0 and current_value > 0.0:
            diff = -min(1.0, current_value)
            return current_value + (value / (value - 1.0)) * diff
        return float("nan")
    return value


def compute_updated_xu(
    solver: Solver,
    value: float,
    xu: "np.ndarray | None",
    yi: "np.ndarray | None",
    implicit: bool,
) -> "np.ndarray | None":
    """New user vector, or None for no change (ALSUtils.computeUpdatedXu:75-106)."""
    if yi is None:
        return None
    no_xu = xu is None
    qui = 0.0 if no_xu else float(np.dot(xu, yi))
    # 0.5 reflects a "don't know" state
    target_qui = compute_target_qui(implicit, value, 0.5 if no_xu else qui)
    if math.isnan(target_qui):
        return None
    d_qui = target_qui - qui
    dxu = solver.solve_d_to_d(np.asarray(yi, dtype=np.float64) * d_qui)
    base = np.zeros(len(dxu), dtype=np.float32) if no_xu else np.asarray(xu, dtype=np.float32).copy()
    return base + dxu.astype(np.float32)


def compute_updated_batch(
    solver: Solver,
    values: np.ndarray,  # (B,)
    xus: np.ndarray,  # (B, k) f32, rows meaningless where ~has_xu
    has_xu: np.ndarray,  # (B,) bool
    yis: np.ndarray,  # (B, k) f32, rows meaningless where ~has_yi
    has_yi: np.ndarray,  # (B,) bool
    implicit: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized fold-in over a whole microbatch: the B k×k delta solves
    collapse into ONE batched solve (stacked-RHS matmul against the cached
    Gramian factorization), replacing the reference's per-interaction
    parallelStream loop (ALSSpeedModelManager.java:198-220) and the serial
    host loop it mapped to here.

    Aggregated interactions are independent within a microbatch (each reads
    the pre-batch X/Y; updates only land when the layer hears its own UPs),
    so batching preserves the serial path's semantics exactly.

    Returns (new_xu (B, k) float32, changed (B,) bool); rows where changed is
    False are not meaningful."""
    values = np.asarray(values, dtype=np.float64)
    qui = np.einsum("bk,bk->b", xus.astype(np.float32), yis.astype(np.float32))
    qui = np.where(has_xu, qui.astype(np.float64), 0.0)
    current = np.where(has_xu, qui, 0.5)  # 0.5 = "don't know"
    if implicit:
        target = np.full_like(values, np.nan)
        pos = (values > 0.0) & (current < 1.0)
        neg = (values < 0.0) & (current > 0.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            target = np.where(
                pos,
                current + (values / (1.0 + values)) * (1.0 - np.maximum(0.0, current)),
                target,
            )
            target = np.where(
                neg,
                current + (values / (values - 1.0)) * (-np.minimum(1.0, current)),
                target,
            )
    else:
        target = values
    changed = has_yi & ~np.isnan(target)
    d_qui = np.where(changed, target - qui, 0.0)
    rhs = yis.astype(np.float64) * d_qui[:, None]
    dxu = solver.solve(rhs)  # (B, k) in one stacked-RHS solve
    base = np.where(has_xu[:, None], xus, 0.0).astype(np.float32)
    return base + dxu.astype(np.float32), changed
