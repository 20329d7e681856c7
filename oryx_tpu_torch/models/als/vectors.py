"""Host store of one side's feature vectors (id → float32 row), and its
device copy kept up to date incrementally.

The port of the reference's ``FeatureVectorStore`` (``models/als/vectors.py``)
for the speed tier and serving: whole-model handoff (:meth:`bulk_load`),
point updates (:meth:`set_vector`), lookups, the model handoff's
bookkeeping (FeatureVectorsPartition.java:55-131 in the original Oryx:
:meth:`reserve`, :meth:`remove_vector`, the set of recently written ids,
:meth:`retain_recent_and_ids`), and the device materialisation:

* every write bumps a version; a point update also marks its row pending
  and goes to a bounded write log; a bulk load, a removal or a retain is a
  *structural* change (``_rebuild_needed_at``);
* :meth:`materialize` returns ``(ids, device matrix)``. After point updates
  alone it builds the next matrix from the cached one with one host gather
  of the changed and appended rows, one scatter and one append — never a
  whole host→device upload — and records a :class:`Transition`; after a
  structural change it uploads the whole matrix, outside the store's lock;
* :meth:`delta_since` composes the transitions between two matrices, so a
  consumer can update state it derives per row for only the delta;
* :meth:`get_vtv` is the Gramian VᵀV: a product on the device matrix when
  that is current, else host BLAS on the rows (the speed tier's case).

Rows are stored in insertion order: a row's index is its position, and
removals re-pack the survivors, in order, into a fresh slab and a fresh id
list. So within one id list (an *order epoch*) ids are only ever appended:
the ids :meth:`materialize` returns are that list itself, shared with later
snapshots, and its first ``mat.shape[0]`` entries are the matrix's rows.

A device matrix, once returned, is never written again: the next one is a
new tensor, filled (the cached rows, the appended rows, the changed rows
scattered) before it is handed out, so a query thread, a background solver
recompute or :meth:`delta_since` may hold any earlier one.

The host snapshot API serves consumers that must never put a float32 copy
of the matrix on the device (the int8 and IVF serving snapshots):
:meth:`host_matrix` returns a host copy with the *pinned row view* beside
it, the slab object and the slab row of each snapshot position, for exact
rescore gathers that stay valid whatever the live store does afterwards (a
removal or a retain re-packs into a fresh slab; a growth copies into a
fresh slab too, rows in place); :meth:`delta_info` composes the write log
since a consumer's version into one :class:`HostDelta`.

Each store reports its slab's bytes and fill (live rows over capacity) to
the ``oryx_factor_arena_*`` gauges (:mod:`oryx_tpu_torch.common.profiling`).
Its capacity follows the reference's: a new slab holds
``oryx.serving.arena.initial-rows`` rows (or what a ``reserve`` or a first
bulk load asks for, if more), grows by doubling, and a re-pack after a
removal or a retain shrinks it back to ``initial-rows`` (doubled until the
survivors fit) when they fill ``oryx.serving.arena.min-fill`` of it or less
(:func:`configure`).
"""

from __future__ import annotations

import collections
import threading
import weakref

import numpy as np
import torch

from oryx_tpu_torch.common import profiling
from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.common.lockutils import AutoReadWriteLock

#: Process-wide arena sizing, set by :func:`configure` from
#: ``oryx.serving.arena.*``. Plain ints/floats: reads are atomic.
_DEFAULT_INITIAL_ROWS = 1024
_DEFAULT_MIN_FILL = 0.25

#: Bounded per-write log: (version, row, was_new).
_LOG_MAX = 65536


def configure(config) -> None:
    """Apply ``oryx.serving.arena.*`` process-wide, as the reference does:
    ``initial-rows`` (at least 1) seeds the slabs of stores made after the
    call, ``min-fill`` (clamped to [0, 1]) decides every later re-pack."""
    global _DEFAULT_INITIAL_ROWS, _DEFAULT_MIN_FILL
    _DEFAULT_INITIAL_ROWS = max(
        1, config.get_int("oryx.serving.arena.initial-rows", 1024)
    )
    _DEFAULT_MIN_FILL = min(
        1.0, max(0.0, config.get_float("oryx.serving.arena.min-fill", 0.25))
    )


def _host_gather(slab: np.ndarray, rows) -> np.ndarray:
    """One gather of slab rows about to cross to the device: a whole
    rebuild gathers every live row, a point-update batch only its delta.
    Tests count the rows through this seam."""
    return slab[np.asarray(rows, dtype=np.int64)]


class Transition:
    """One incremental materialisation step: ``new_mat`` is ``prev_mat`` with
    rows ``changed_idx`` rewritten and ``n_new`` rows appended.

    Both matrices are held by weak reference, so the log never keeps an old
    device matrix alive: once every consumer drops a generation, a chain
    through it breaks and its consumer rebuilds in full."""

    __slots__ = ("prev_ref", "new_ref", "changed_idx", "n_new")

    def __init__(self, prev_mat, new_mat, changed_idx: np.ndarray, n_new: int):
        self.prev_ref = weakref.ref(prev_mat)
        self.new_ref = weakref.ref(new_mat)
        self.changed_idx = changed_idx
        self.n_new = n_new


class SnapshotIndex:
    """The id → row map of a snapshot of one order epoch, shared by every
    device view of Y: an incremental snapshot extends its predecessor's map
    for the appended rows instead of rebuilding it. Every lookup goes
    through :meth:`index_of`, bounded by this snapshot's ``n``, so an older
    snapshot never names a row it does not hold."""

    ids: list
    n: int
    id_to_idx: dict

    def _index_ids(self, prev: "SnapshotIndex | None") -> None:
        """Build the map, or extend ``prev``'s (an incremental step of the
        same order epoch)."""
        if prev is not None:
            self.id_to_idx = prev.id_to_idx
            for i in range(prev.n, self.n):
                self.id_to_idx[self.ids[i]] = i
        else:
            self.id_to_idx = {self.ids[i]: i for i in range(self.n)}

    def index_of(self, id_: str) -> "int | None":
        i = self.id_to_idx.get(id_)
        return i if i is not None and i < self.n else None


class HostDelta:
    """Composed host-side delta between two store versions, for a consumer
    that keeps its own per-row state (the int8 and IVF snapshots): the
    changed ids of the consumer's rows with their current values, and the
    appended ids with theirs and their slab rows. Values are the slab's at
    the time of :meth:`FeatureVectorStore.delta_info` (newest wins)."""

    __slots__ = ("version", "changed_ids", "changed_vals", "appended_ids",
                 "appended_vals", "appended_rows", "slab")

    def __init__(self, version, changed_ids, changed_vals, appended_ids,
                 appended_vals, appended_rows=None, slab=None):
        self.version = version
        self.changed_ids = changed_ids        # list[str], the consumer's rows
        self.changed_vals = changed_vals      # (len(changed_ids), k) float32
        self.appended_ids = appended_ids      # list[str]
        self.appended_vals = appended_vals    # (len(appended_ids), k) float32
        self.appended_rows = appended_rows    # slab rows of the appended ids
        self.slab = slab                      # the CURRENT slab object: row
        # indices are stable within an order epoch (a growth copies rows in
        # place, and every change that moves a row is structural)


class FeatureVectorStore:
    def __init__(self, initial_rows: "int | None" = None):
        self._initial_rows = initial_rows or _DEFAULT_INITIAL_ROWS
        self._lock = AutoReadWriteLock()
        self._ids: list[str] = []
        self._index: dict[str, int] = {}
        self._slab: "np.ndarray | None" = None  # (capacity, k) float32
        self._version = 0
        # version of the last structural change: an incremental step is
        # sound only from a cached matrix at or after it
        self._rebuild_needed_at = 0
        self._pending: set[int] = set()  # rows point-updated since the cache
        self._log: collections.deque = collections.deque(maxlen=_LOG_MAX)
        # ids written since the last retain_recent_and_ids
        self._recent: set[str] = set()
        self._reserve_rows = 0
        # -- device materialisation cache ----------------------------------
        self._cache_lock = threading.Lock()
        self._cached_ids: "list | None" = None
        self._cached_matrix: "torch.Tensor | None" = None
        self._cached_version = -1
        self._cached_device: "torch.device | None" = None
        self._transitions: collections.deque = collections.deque(maxlen=8)
        #: materialisations so far, by kind ("full", "incremental")
        self.materializations = {"full": 0, "incremental": 0}
        # the arena-bytes/fill gauges read live stores at scrape time
        profiling.register_arena(self)

    # -- slab plumbing (callers hold the write lock) -------------------------
    def _ensure(self, k: int, need: int) -> None:
        """A slab of width ``k`` holding at least ``need`` rows."""
        # analyze: ignore[lock-discipline] -- runs only under self._lock.write(), taken by its callers
        if self._slab is None:
            self._slab = np.zeros(
                # analyze: ignore[lock-discipline] -- runs only under self._lock.write(), taken by its callers
                (max(self._initial_rows, self._reserve_rows, need, 1), k),
                dtype=np.float32)
        elif self._slab.shape[1] != k:
            raise ValueError(
                f"factor width changed: store holds {self._slab.shape[1]}-"
                f"feature rows, got {k}"
            )
        elif need > self._slab.shape[0]:
            self._grow(need)

    def _grow(self, need: int) -> None:
        """Double the capacity until ``need`` rows fit, rows in place."""
        # analyze: ignore[lock-discipline] -- runs only under self._lock.write(), taken by its callers
        cap = max(self._slab.shape[0], 1)
        while cap < need:
            cap *= 2
        if cap != self._slab.shape[0]:
            grown = np.zeros((cap, self._slab.shape[1]), dtype=np.float32)
            # analyze: ignore[lock-discipline] -- runs only under self._lock.write(), taken by its callers
            grown[: len(self._ids)] = self._slab[: len(self._ids)]
            self._slab = grown

    def _row(self, id_: str) -> "tuple[int, bool]":
        # analyze: ignore[lock-discipline] -- runs only under self._lock.write(), taken by its callers
        row = self._index.get(id_)
        if row is None:
            # analyze: ignore[lock-discipline] -- runs only under self._lock.write(), taken by its callers
            row = len(self._ids)
            # analyze: ignore[lock-discipline] -- runs only under self._lock.write(), taken by its callers
            if row >= self._slab.shape[0]:
                self._grow(row + 1)
            self._ids.append(id_)
            self._index[id_] = row
            return row, True
        return row, False

    def _structural(self) -> None:
        # analyze: ignore[lock-discipline] -- runs only under self._lock.write(), taken by its callers
        self._version += 1
        self._rebuild_needed_at = self._version
        # analyze: ignore[lock-discipline] -- runs only under self._lock.write(), taken by its callers
        self._pending.clear()

    def _repack(self, keep: "list[str]") -> None:
        """Keep only the ids in ``keep`` (in their row order) in a fresh
        slab and a fresh id list and index: snapshots holding the old ones
        stay valid."""
        # analyze: ignore[lock-discipline] -- runs only under self._lock.write(), taken by its callers
        rows = np.asarray([self._index[i] for i in keep], dtype=np.int64)
        # analyze: ignore[lock-discipline] -- runs only under self._lock.write(), taken by its callers
        cap = self._slab.shape[0]
        if len(keep) <= cap * _DEFAULT_MIN_FILL:
            cap = max(self._initial_rows, 1)
            while cap < len(keep):
                cap *= 2
        slab = np.zeros((cap, self._slab.shape[1]), dtype=np.float32)
        slab[: len(keep)] = self._slab[rows]
        self._slab = slab
        # analyze: ignore[lock-discipline] -- runs only under self._lock.write(), taken by its callers
        self._ids = keep
        self._index = {s: i for i, s in enumerate(keep)}

    # -- writes ----------------------------------------------------------------
    def set_vector(self, id_: str, vector) -> None:
        v = np.asarray(vector, dtype=np.float32)
        with self._lock.write():
            self._ensure(v.shape[0], 1)
            row, was_new = self._row(id_)
            self._slab[row] = v
            self._recent.add(id_)
            self._pending.add(row)
            self._version += 1
            self._log.append((self._version, row, was_new))

    def bulk_load(self, ids, matrix) -> None:
        """Set many vectors at once (the whole-model handoff; structural).
        The matrix is copied: later point updates never write into the
        caller's array. A repeated id keeps its last row."""
        matrix = np.asarray(matrix, dtype=np.float32)
        ids = list(ids)
        if matrix.shape[0] != len(ids):
            raise ValueError(
                f"{len(ids)} ids for a matrix of {matrix.shape[0]} rows")
        if not ids:
            return
        with self._lock.write():
            # one copy into an empty store; otherwise each new id takes a
            # row (growth by doubling counts only the ids not held yet)
            whole = not self._ids and len(set(ids)) == len(ids)
            self._ensure(matrix.shape[1], len(ids) if whole else 1)
            if whole:
                self._slab[: len(ids)] = matrix
                self._ids = ids
                self._index = {s: i for i, s in enumerate(ids)}
            else:
                for i, id_ in enumerate(ids):
                    row = self._row(id_)[0]  # may grow the slab
                    self._slab[row] = matrix[i]
            self._recent.update(ids)
            self._structural()

    def reserve(self, rows: int) -> None:
        """Presize for ``rows`` rows: a MODEL handoff knows its id count, and
        presizing skips the doubling-growth copies. It sizes the next
        allocation only: a re-pack still shrinks to ``initial-rows``."""
        with self._lock.write():
            if self._slab is None:
                self._reserve_rows = max(self._reserve_rows, rows)
            elif rows > self._slab.shape[0]:
                self._grow(rows)

    def remove_vector(self, id_: str) -> None:
        """Drop one id; the survivors re-pack into a fresh slab (removals
        are rare: the reference removes only through model GC)."""
        with self._lock.write():
            if id_ in self._index:
                self._repack([i for i in self._ids if i != id_])
                self._recent.discard(id_)
                self._structural()

    def retain_recent_and_ids(self, ids) -> None:
        """GC on new-model handoff: drop vectors neither written since the
        last call nor in ``ids``, the new model's (FeatureVectorsPartition.
        retainRecentAndIDs); the recent set starts again empty."""
        keep_ids = set(ids)
        with self._lock.write():
            self._structural()
            if self._slab is not None:
                self._repack([i for i in self._ids
                              if i in self._recent or i in keep_ids])
            self._recent = set()

    # -- reads -----------------------------------------------------------------
    def get_vector(self, id_: str) -> "np.ndarray | None":
        with self._lock.read():
            row = self._index.get(id_)
            return self._slab[row].copy() if row is not None else None

    def get_vectors(self, ids) -> list:
        """Batched lookup under one read lock (the speed tier's microbatch
        gather)."""
        with self._lock.read():
            index, slab = self._index, self._slab
            return [slab[row].copy() if (row := index.get(i)) is not None
                    else None for i in ids]

    def size(self) -> int:
        with self._lock.read():
            return len(self._ids)

    def ids(self) -> list:
        with self._lock.read():
            return list(self._ids)

    # -- arena telemetry (scrape-time gauges; see common/profiling.py) ------
    def arena_nbytes(self) -> int:
        """Host bytes of the slab (its capacity, filled or not)."""
        slab = self._slab  # analyze: ignore[lock-discipline] -- scrape-time advisory read; a torn sample skews one gauge scrape, never store state
        return int(slab.nbytes) if slab is not None else 0

    def arena_fill(self) -> float:
        """Live rows over the slab's capacity."""
        slab = self._slab  # analyze: ignore[lock-discipline] -- scrape-time advisory read (see arena_nbytes)
        if slab is None or slab.shape[0] == 0:
            return 0.0
        return len(self._ids) / slab.shape[0]  # analyze: ignore[lock-discipline] -- scrape-time advisory read (see arena_nbytes)

    def host_matrix(self) -> "tuple[list, np.ndarray, int, tuple]":
        """(ids, row-aligned float32 copy, version, (slab, rows)): the full
        host snapshot; the caller owns the copy. The trailing pair pins this
        order epoch for later exact-rescore gathers: ``slab[rows[i]]`` is
        position ``i``'s row for as long as the caller holds the pair,
        whatever the live store does (a structural change re-packs into a
        fresh slab and never writes this one's rows again; a point update
        into a captured row is visible, newer than the snapshot)."""
        with self._lock.read():
            n = len(self._ids)
            slab = self._slab
            rows = np.arange(n, dtype=np.int64)
            if slab is None:
                return ([], np.zeros((0, 0), dtype=np.float32), self._version,
                        (slab, rows))
            return list(self._ids), slab[:n].copy(), self._version, (slab, rows)

    def delta_info(self, since_version: int, since_len: int) -> "HostDelta | None":
        """Everything written since ``since_version`` for a consumer whose
        snapshot held the first ``since_len`` ids of the order, composed
        into one :class:`HostDelta`. ``None`` when a structural change
        happened since, or the bounded write log no longer covers the gap:
        the consumer then rebuilds from :meth:`host_matrix`."""
        with self._lock.read():
            if self._rebuild_needed_at > since_version:
                return None
            if self._version == since_version:
                return HostDelta(self._version, [], None, [], None)
            # every version bump since since_version is structural (caught
            # above) or a logged set_vector: a log starting past
            # since_version + 1 lost writes of the gap
            if not self._log or self._log[0][0] > since_version + 1:
                return None
            changed_rows: set = set()
            for v, row, _was_new in reversed(self._log):
                if v <= since_version:
                    break
                changed_rows.add(row)
            n = len(self._ids)
            # rows are positions in an order epoch: the appended rows are
            # the tail past the consumer's length
            changed = sorted(r for r in changed_rows if r < since_len)
            appended_rows = np.arange(since_len, n, dtype=np.int64)
            changed_vals = (self._slab[np.asarray(changed, dtype=np.int64)]
                            if changed else None)
            appended_vals = self._slab[since_len:n].copy() if n > since_len else None
            ids = self._ids
            return HostDelta(
                self._version, [ids[r] for r in changed], changed_vals,
                ids[since_len:n], appended_vals,
                appended_rows=appended_rows, slab=self._slab,
            )

    # -- device materialisation ---------------------------------------------
    def materialize(self, device=None) -> "tuple[list, torch.Tensor | None]":
        """``(ids, matrix)``: Y as one float32 matrix on ``device`` (``None``:
        the CUDA card), ``None`` while the store is empty. ``ids`` is the
        store's id list of this order epoch: its first ``matrix.shape[0]``
        entries name the rows; later appends may extend it.

        Incremental when only point updates happened since the cached
        matrix: one host gather of the changed and appended rows, then a
        new matrix from the cached one (scatter, append). Whole otherwise
        (first build, bulk load, removal, retain); that upload runs outside
        the store's lock so that writers are not held up by it."""
        dev = resolve(device)
        with self._lock.read(), self._cache_lock:
            version = self._version
            if self._cached_version == version and self._cached_device == dev:
                return self._cached_ids, self._cached_matrix
            pending, self._pending = self._pending, set()
            if (self._cached_matrix is not None and self._cached_device == dev
                    and self._rebuild_needed_at <= self._cached_version
                    and pending):
                prev = self._cached_matrix
                cached_len, n = prev.shape[0], len(self._ids)
                rows = np.fromiter(pending, dtype=np.int64, count=len(pending))
                changed = np.sort(rows[rows < cached_len])
                n_new = n - cached_len
                vals = torch.from_numpy(_host_gather(self._slab, np.concatenate(
                    [changed, np.arange(cached_len, n)]))).to(dev)
                # a new matrix, written before anyone else sees it: the
                # cached one stays as it was
                mat = torch.empty((n, prev.shape[1]), dtype=prev.dtype, device=dev)
                mat[:cached_len] = prev
                mat[cached_len:] = vals[len(changed):]
                if len(changed):
                    mat.index_copy_(0, torch.from_numpy(changed).to(dev),
                                    vals[: len(changed)])
                self._transitions.append(Transition(prev, mat, changed, n_new))
                self._cached_ids = self._ids
                self._cached_matrix = mat
                self._cached_version = version
                self.materializations["incremental"] += 1
                return self._cached_ids, mat
            ids = self._ids
            n = len(ids)
            host = _host_gather(self._slab, range(n)) if n else None
        mat = torch.from_numpy(host).to(dev) if host is not None else None
        with self._cache_lock:
            if version > self._cached_version or self._cached_device != dev:
                self._cached_ids = ids
                self._cached_matrix = mat
                self._cached_version = version
                self._cached_device = dev
                self._transitions.clear()
                self.materializations["full"] += 1
            return self._cached_ids, self._cached_matrix

    def delta_since(self, from_mat, to_mat) -> "tuple[np.ndarray, int] | None":
        """The recorded incremental steps from ``from_mat`` up to ``to_mat``,
        composed: (changed row indices within ``from_mat``'s rows, rows
        appended). ``None`` when the chain is broken (a whole rebuild, a
        generation no longer held, or either matrix unknown)."""
        with self._cache_lock:
            chain = list(self._transitions)
        if from_mat is to_mat:
            return np.empty(0, dtype=np.int64), 0
        start = next(
            (i for i, t in enumerate(chain) if t.prev_ref() is from_mat), None)
        if start is None:
            return None
        # each step's prev is the previous step's output and a whole
        # rebuild clears the log, so only the two ends need to be alive
        n_base = from_mat.shape[0]
        parts, n_new = [], 0
        for t in chain[start:]:
            # rows rewritten in the appended tail come with the tail
            parts.append(t.changed_idx[t.changed_idx < n_base])
            n_new += t.n_new
            if t.new_ref() is to_mat:
                return np.unique(np.concatenate(parts)), n_new
        return None

    def get_vtv(self) -> "np.ndarray | None":
        """The Gramian VᵀV in float32 (FeatureVectors.getVTV), ``None`` while
        empty. When the cached device matrix is current (serving keeps it
        so) the product runs there, with no lock held; otherwise host BLAS
        on a copy of the rows, so the speed tier never puts a matrix on the
        device for its solvers."""
        with self._lock.read():
            with self._cache_lock:
                mat = (self._cached_matrix
                       if self._cached_version == self._version else None)
            if mat is None:
                if not self._ids:
                    return None
                host = self._slab[: len(self._ids)].copy()
        if mat is not None:
            return (mat.T @ mat).cpu().numpy()
        return np.matmul(host.T, host)
