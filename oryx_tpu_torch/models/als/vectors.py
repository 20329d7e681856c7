"""Host store of one side's feature vectors (id → float32 row).

The part of the reference's ``FeatureVectorStore`` (``models/als/vectors.py``)
that serving needs: whole-model handoff (:meth:`bulk_load`), point updates
(:meth:`set_vector`), lookups, and :meth:`host_matrix`, the row-aligned host
copy that one device copy of the matrix is built from; and the model
handoff's bookkeeping (FeatureVectorsPartition.java:55-131 in the original
Oryx): :meth:`reserve`, :meth:`remove_vector`, the set of recently written
ids, and :meth:`retain_recent_and_ids`. Every write bumps a version, so a
consumer can tell whether its device copy is stale. The reference's
delta/transition machinery (incremental device snapshots) is not ported
yet: a changed store is uploaded whole.
"""

from __future__ import annotations

import threading

import numpy as np


class FeatureVectorStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._ids: list[str] = []
        self._index: dict[str, int] = {}
        self._slab: "np.ndarray | None" = None  # (capacity, k) float32
        self._version = 0
        # ids written since the last retain_recent_and_ids
        self._recent: set[str] = set()
        self._reserve_rows = 0

    def _ensure(self, k: int, need: int) -> None:
        if self._slab is None:
            self._slab = np.zeros((max(need, 16, self._reserve_rows), k),
                                  dtype=np.float32)
        elif self._slab.shape[1] != k:
            raise ValueError(
                f"factor width changed: store holds {self._slab.shape[1]}-"
                f"feature rows, got {k}"
            )
        elif need > self._slab.shape[0]:
            grown = np.zeros((max(need, 2 * self._slab.shape[0]), k),
                             dtype=np.float32)
            grown[: len(self._ids)] = self._slab[: len(self._ids)]
            self._slab = grown

    def _row(self, id_: str) -> int:
        row = self._index.get(id_)
        if row is None:
            row = len(self._ids)
            self._ids.append(id_)
            self._index[id_] = row
        return row

    def set_vector(self, id_: str, vector) -> None:
        v = np.asarray(vector, dtype=np.float32)
        with self._lock:
            self._ensure(v.shape[0], len(self._ids) + 1)
            self._slab[self._row(id_)] = v
            self._recent.add(id_)
            self._version += 1

    def bulk_load(self, ids, matrix) -> None:
        """Set many vectors at once (the whole-model handoff). The matrix is
        copied: later point updates never write into the caller's array.
        A repeated id keeps its last row."""
        matrix = np.asarray(matrix, dtype=np.float32)
        ids = list(ids)
        if matrix.shape[0] != len(ids):
            raise ValueError(
                f"{len(ids)} ids for a matrix of {matrix.shape[0]} rows")
        if not ids:
            return
        with self._lock:
            self._ensure(matrix.shape[1], len(self._ids) + len(ids))
            if not self._ids and len(set(ids)) == len(ids):
                self._slab[: len(ids)] = matrix
                self._ids = ids
                self._index = {s: i for i, s in enumerate(ids)}
            else:
                for i, id_ in enumerate(ids):
                    self._slab[self._row(id_)] = matrix[i]
            self._recent.update(ids)
            self._version += 1

    def reserve(self, rows: int) -> None:
        """Presize for ``rows`` rows: a MODEL handoff knows its id count, and
        presizing skips the doubling-growth copies."""
        with self._lock:
            if self._slab is None:
                self._reserve_rows = max(self._reserve_rows, rows)
            elif rows > self._slab.shape[0]:
                grown = np.zeros((rows, self._slab.shape[1]), dtype=np.float32)
                grown[: len(self._ids)] = self._slab[: len(self._ids)]
                self._slab = grown

    def _repack(self, keep: "list[str]") -> None:
        """Keep only the ids in ``keep`` (in their row order) in a fresh
        slab; the caller holds the lock."""
        rows = np.asarray([self._index[i] for i in keep], dtype=np.int64)
        slab = np.zeros((max(len(keep), 16), self._slab.shape[1]),
                        dtype=np.float32)
        slab[: len(keep)] = self._slab[rows]
        self._slab = slab
        self._ids = keep
        self._index = {s: i for i, s in enumerate(keep)}

    def remove_vector(self, id_: str) -> None:
        """Drop one id; the survivors re-pack into a fresh slab (removals
        are rare: the reference removes only through model GC)."""
        with self._lock:
            self._version += 1
            if id_ in self._index:
                self._repack([i for i in self._ids if i != id_])
                self._recent.discard(id_)

    def retain_recent_and_ids(self, ids) -> None:
        """GC on new-model handoff: drop vectors neither written since the
        last call nor in ``ids``, the new model's (FeatureVectorsPartition.
        retainRecentAndIDs); the recent set starts again empty."""
        keep_ids = set(ids)
        with self._lock:
            self._version += 1
            if self._slab is not None:
                self._repack([i for i in self._ids
                              if i in self._recent or i in keep_ids])
            self._recent = set()

    def get_vector(self, id_: str) -> "np.ndarray | None":
        with self._lock:
            row = self._index.get(id_)
            return self._slab[row].copy() if row is not None else None

    def size(self) -> int:
        with self._lock:
            return len(self._ids)

    def ids(self) -> list:
        with self._lock:
            return list(self._ids)

    def version(self) -> int:
        with self._lock:
            return self._version

    def host_matrix(self) -> "tuple[list, np.ndarray, int]":
        """(ids, row-aligned float32 copy, version): the full host snapshot;
        the caller owns the copy."""
        with self._lock:
            n = len(self._ids)
            if self._slab is None:
                return [], np.zeros((0, 0), dtype=np.float32), self._version
            return list(self._ids), self._slab[:n].copy(), self._version
