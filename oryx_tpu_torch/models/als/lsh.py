"""Locality-sensitive hashing for approximate top-N (sample-rate semantics).

A copy of the JAX package's ``oryx_tpu/models/als/lsh.py`` (host numpy, no
JAX) on the port's ``common/rand``, held equal to it byte for byte by
``tests/test_torch_als_quant.py``: under the test seed both draw the same
hyperplanes, so buckets, candidate sets and lookup tables are the same.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's LocalitySensitiveHash
(app/oryx-app-serving/.../als/model/LocalitySensitiveHash.java:41-177):
``oryx.als.sample-rate`` < 1 trades recall for speed by only scoring items
whose sign-bit hash (under near-orthogonal random hyperplanes) lies within
``max_bits_differing`` of the query's hash. Hash count and allowed bit
difference are chosen so the candidate-bucket fraction approximates the
sample rate.

TPU re-design: the reference scans candidate *partitions* with a thread pool;
here items carry a bucket id, and top-N masks non-candidate rows to −∞ inside
the same single matmul+top_k device program — the knob preserves the
reference's approximation semantics, while TPU speed comes from the batched
matmul itself (serving.py).
"""

from __future__ import annotations

import math

import numpy as np

from oryx_tpu_torch.common import rand

MAX_HASHES = 16


def _candidate_fraction(n_hashes: int, max_bits_differing: int) -> float:
    total = sum(math.comb(n_hashes, d) for d in range(max_bits_differing + 1))
    return total / (1 << n_hashes)


def choose_hash_config(sample_rate: float) -> tuple[int, int]:
    """Smallest hash count + allowed differing bits whose candidate fraction
    is closest to (without exceeding much) the sample rate
    (LocalitySensitiveHash.java:41-74)."""
    if sample_rate >= 1.0:
        return 0, 0
    best = (1, 0)
    best_err = float("inf")
    for n in range(1, MAX_HASHES + 1):
        for d in range(n):
            frac = _candidate_fraction(n, d)
            if frac <= sample_rate:
                err = sample_rate - frac
                if err < best_err:
                    best_err = err
                    best = (n, d)
    return best


class LocalitySensitiveHash:
    def __init__(self, sample_rate: float, features: int):
        self.sample_rate = sample_rate
        self.features = features
        self.num_hashes, self.max_bits_differing = choose_hash_config(sample_rate)
        # LUT row cache allocated eagerly: get_candidate_lut runs on the
        # coalescer's executor threads concurrently, and lazy allocation
        # would race (one thread's fresh array clobbering another's fills).
        # Concurrent fills of the same row write identical values, and the
        # filled flag is set only AFTER its row, so readers are safe.
        self._popcounts: "np.ndarray | None" = None
        if 0 < self.num_hashes and self.num_buckets <= 8192:
            self._lut_rows = np.zeros(
                (self.num_buckets, self.num_buckets), dtype=bool
            )
            self._lut_filled = np.zeros(self.num_buckets, dtype=bool)
        else:
            self._lut_rows = None
            self._lut_filled = None
        rng = rand.get_random()
        if self.num_hashes:
            # near-orthogonal random hyperplanes (:80-105)
            m = rng.standard_normal((self.num_hashes, features)).astype(np.float32)
            q, _ = np.linalg.qr(m.T) if features >= self.num_hashes else (m.T, None)
            self.hyperplanes = np.ascontiguousarray(q.T[: self.num_hashes], dtype=np.float32)
        else:
            self.hyperplanes = np.zeros((0, features), dtype=np.float32)

    @property
    def num_buckets(self) -> int:
        return 1 << self.num_hashes

    def get_index_for(self, vector: np.ndarray) -> int:
        """Sign-bit hash (:142)."""
        if not self.num_hashes:
            return 0
        bits = (self.hyperplanes @ np.asarray(vector, dtype=np.float32)) > 0
        idx = 0
        for b in bits:
            idx = (idx << 1) | int(b)
        return idx

    def assign_buckets(self, matrix: np.ndarray) -> np.ndarray:
        """Bucket id per row, vectorized."""
        if not self.num_hashes:
            return np.zeros(len(matrix), dtype=np.int32)
        bits = (matrix @ self.hyperplanes.T) > 0  # (n, h)
        weights = (1 << np.arange(self.num_hashes - 1, -1, -1)).astype(np.int32)
        return (bits.astype(np.int32) @ weights).astype(np.int32)

    def _popcount_table(self) -> np.ndarray:
        """popcount of every bucket id, built once per instance (idempotent
        under concurrent builds: identical values)."""
        if self._popcounts is None:
            v = np.arange(self.num_buckets, dtype=np.int32)
            pc = np.zeros(self.num_buckets, dtype=np.int32)
            while v.any():
                pc += v & 1
                v = v >> 1
            self._popcounts = pc
        return self._popcounts

    def get_candidate_indices(self, vector: np.ndarray) -> np.ndarray:
        """All bucket ids within max_bits_differing of the query hash (:156-177)."""
        if not self.num_hashes:
            return np.asarray([0], dtype=np.int32)
        base = self.get_index_for(vector)
        all_ids = np.arange(self.num_buckets, dtype=np.int32)
        pc = self._popcount_table()[all_ids ^ base]
        return all_ids[pc <= self.max_bits_differing]

    def get_candidate_lut(self, qs: np.ndarray) -> np.ndarray:
        """(B, num_buckets) bool candidate table for a BATCH of queries.

        A query's row depends only on its bucket id, so rows memoize in a
        dense (num_buckets, num_buckets) bool table filled lazily per
        distinct base bucket (≤ 64 MB at 8192 buckets; beyond that the
        direct vectorized xor/popcount computation is used) — steady-state
        builds are then one row gather instead of per-query bit loops."""
        qs = np.atleast_2d(np.asarray(qs, dtype=np.float32))
        if not self.num_hashes:
            return np.ones((len(qs), 1), dtype=bool)
        base = self.assign_buckets(qs)  # (B,)
        n = self.num_buckets
        all_ids = np.arange(n, dtype=np.int32)
        pc = self._popcount_table()
        if self._lut_rows is None:  # table would exceed ~64 MB: direct
            return pc[base[:, None] ^ all_ids[None, :]] <= self.max_bits_differing
        missing = np.unique(base[~self._lut_filled[base]])
        if missing.size:
            self._lut_rows[missing] = (
                pc[missing[:, None] ^ all_ids[None, :]]
                <= self.max_bits_differing
            )
            self._lut_filled[missing] = True
        return self._lut_rows[base]
