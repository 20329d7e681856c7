"""Linear-system solving over Gramians, with singularity detection.

A copy of the JAX package's ``oryx_tpu/ops/solver.py`` (host numpy, no
JAX), held equal to it by ``tests/test_torch_als_speed.py``. The speed
tier's and serving's fold-in solves stay on the host in float64, as in the
reference: the k×k Gramian is tiny, and float64 keeps the rank test exact.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's LinearSystemSolver / Solver / SolverCache
(framework/oryx-common/.../math/LinearSystemSolver.java:39-81, Solver.java:33-51;
app/oryx-app-common/.../als/SolverCache.java:36-120).

The reference RRQR-decomposes the packed Gramian and throws
``SingularMatrixSolverException`` with the apparent rank when the matrix is
singular past threshold 1e-5. Here the k×k Gramian (k ≤ a few hundred) is
SVD-factorized in float64 on host. ``Solver.solve`` maps one RHS vector or
a batch of stacked RHS rows in a single matmul.

``SolverCache`` keeps the reference's single-flight async-recompute semantics:
a dirty flag set on writes, one background recompute at a time, and a blocking
first ``get`` gated on a latch.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable

import numpy as np

log = logging.getLogger(__name__)

SINGULARITY_THRESHOLD = 1.0e-5  # LinearSystemSolver.java:34 (SINGULARITY_ERROR_TOLERANCE)


class SingularMatrixSolverException(Exception):
    """Carries apparent rank, like the reference's exception
    (math/SingularMatrixSolverException.java)."""

    def __init__(self, apparent_rank: int, message: str = ""):
        super().__init__(message or f"singular matrix; apparent rank {apparent_rank}")
        self.apparent_rank = apparent_rank


class Solver:
    """Wraps a factorized Gramian; solve() maps RHS → solution
    (math/Solver.java:33-51)."""

    def __init__(self, u: np.ndarray, s: np.ndarray, vt: np.ndarray):
        self._u = u
        self._s_inv = np.divide(1.0, s, out=np.zeros_like(s), where=s > 0)
        self._vt = vt

    def solve_d_to_d(self, b) -> np.ndarray:
        return np.asarray(self.solve(b), dtype=np.float64)

    def solve_f_to_f(self, b) -> np.ndarray:
        return np.asarray(self.solve(b), dtype=np.float32)

    def solve(self, b) -> np.ndarray:
        """Solve A x = b for one RHS vector or a batch of stacked RHS rows:
        x = V diag(1/s) U^T b."""
        b = np.asarray(b, dtype=np.float64)
        return (b @ self._u * self._s_inv) @ self._vt


def get_solver(gramian) -> Solver:
    """Factorize a symmetric k×k Gramian; raise SingularMatrixSolverException
    on rank deficiency (LinearSystemSolver.getSolver, :39-81)."""
    m = np.asarray(gramian, dtype=np.float64)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"not square: {m.shape}")
    u, s, vt = np.linalg.svd(m, full_matrices=False)
    max_s = float(s[0]) if s.size else 0.0
    if max_s <= 0.0:
        raise SingularMatrixSolverException(0)
    apparent_rank = int(np.sum(s > SINGULARITY_THRESHOLD * max_s))
    if apparent_rank < m.shape[0]:
        raise SingularMatrixSolverException(
            apparent_rank,
            f"apparent rank {apparent_rank} < dimension {m.shape[0]}; "
            "more data, or better data, is needed",
        )
    return Solver(u, s, vt)


class SolverCache:
    """Dirty-flag + single-flight async recompute of the Gramian solver
    (app/oryx-app-common/.../als/SolverCache.java:36-120).

    ``compute_fn`` returns the current Gramian (or None if no vectors yet).
    ``set_dirty`` is called whenever underlying vectors change; ``compute_now``
    triggers an async recompute if dirty; ``get(blocking)`` returns the latest
    solver, blocking first use until one exists.
    """

    def __init__(self, compute_fn: "Callable[[], np.ndarray | None]"):
        self._compute_fn = compute_fn
        self._solver: Solver | None = None
        self._dirty = True
        self._in_flight = False
        self._lock = threading.Lock()
        self._first_ready = threading.Event()

    def set_dirty(self) -> None:
        with self._lock:
            self._dirty = True

    def compute_now(self) -> None:
        self._maybe_launch(wait=False)

    def _maybe_launch(self, wait: bool) -> None:
        with self._lock:
            if not self._dirty or self._in_flight:
                launch = False
            else:
                self._dirty = False
                self._in_flight = True
                launch = True
        if not launch:
            return
        if wait:
            self._recompute()
        else:
            threading.Thread(target=self._recompute, name="OryxSolverCache", daemon=True).start()

    def _recompute(self) -> None:
        try:
            gramian = self._compute_fn()
            if gramian is not None:
                try:
                    solver = get_solver(gramian)
                except SingularMatrixSolverException as e:
                    log.warning("Gramian is singular (%s); keeping previous solver", e)
                    with self._lock:
                        solver = self._solver
                with self._lock:
                    self._solver = solver
        finally:
            # Unblock first-get waiters even on no-data/failure, like the
            # reference's finally { solverInitialized.countDown(); }
            self._first_ready.set()
            with self._lock:
                self._in_flight = False

    def get(self, blocking: bool = True) -> Solver | None:
        with self._lock:
            solver = self._solver
            dirty = self._dirty
        if solver is None:
            if not blocking:
                self._maybe_launch(wait=False)
                return None
            self._maybe_launch(wait=True)
            with self._lock:
                solver = self._solver
            if solver is None:
                # another thread may be computing; wait for first result
                self._first_ready.wait(timeout=60)
                with self._lock:
                    solver = self._solver
            return solver
        if dirty:
            self._maybe_launch(wait=False)  # serve stale while refreshing
        return solver
