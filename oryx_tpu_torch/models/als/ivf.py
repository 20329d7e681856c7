"""Device-resident IVF (inverted-file) candidate generation over the item
factors: the sublinear serving scan.

The port of the JAX package's ``oryx_tpu/models/als/ivf.py``. The int8 flat
scan reads every item row per query batch; this module clusters the item
factors (``models/kmeans/train.fit_index_centroids``: a fixed seed, bounded
iterations, empty cells reseeded) and keeps the catalog on the device as

  * ``centroids``    (C, k)    float32 — one row per cell,
  * ``cell_pos``     (C, L)    int32   — snapshot positions, -1-padded,
  * ``cell_q``       (C, L, k) int8    — per-row-scaled int8 factors,
  * ``cell_scale``   (C, L)    float32 — the per-row scales,
  * ``cell_norms``   (C, L)    float32 — exact norms (cosine path),
  * ``cell_buckets`` (C, L)    int32   — LSH buckets (optional).

A query batch probes the top-P cells by centroid dot product (one (B, k) ×
(k, C) product and ``torch.topk``), reads ONLY those cells' int8 rows (one
probe column at a time, so the gather's transient is one (B, L, k) block),
scores them, and hands the top ``rescore-factor × how_many`` candidates to
the same exact float32 rescore from the store's slab that the flat int8
path uses. Per query the scan reads P·L·k bytes instead of n·k.

Cells are maintained incrementally from the store's write log
(``delta_info``): a microbatch requantizes and reassigns only the rows it
touched and rewrites only the affected cells, in NEW device tensors (a
query thread may hold the previous snapshot's), with the same bytes as a
full rebuild with the same centroids. A cell overflowing its padded width,
or the balance drifting past ``oryx.serving.index.rebalance-skew``, falls
back to a full re-cluster.

The reference compiles these programs with XLA from plain ``jnp`` (no
Pallas kernel), so they are plain torch here, with the four
``oryx_index_*`` metrics. A batched scan records one call of each program
under the reference's cost keys (:func:`probe_cost_key`,
:func:`scan_cost_key`) at an analytic cost, where the reference reads
XLA's: the probe reads the centroids (``4·C·k`` bytes, ``2·B·C·k`` FLOPs);
the cell scan reads the probed cells' int8 rows, scales and positions
(``min(B·P, C)·L·(k + 8)`` bytes, the most distinct cells one call can
read, plus the cells' buckets and the candidate table under LSH) and does
``2·B·P·L·k`` FLOPs.
"""

from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import profiling
from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.models.als.vectors import SnapshotIndex

log = logging.getLogger(__name__)

_INDEX_CELLS = metrics_mod.default_registry().counter(
    "oryx_index_cells_total",
    "IVF index cells created across index (re)builds",
)
_INDEX_PROBED = metrics_mod.default_registry().counter(
    "oryx_index_probed_cells_total",
    "IVF cells probed (batch size x probe width, per candidate scan)",
)
_INDEX_CANDIDATES = metrics_mod.default_registry().counter(
    "oryx_index_candidate_rows_total",
    "Candidate rows emitted by IVF scans for exact f32 rescore",
)
_INDEX_SKEW = metrics_mod.default_registry().gauge(
    "oryx_index_cell_skew",
    "Largest-cell occupancy over the mean (n/cells); the rebalance-skew "
    "bound triggers a re-cluster when this drifts past it",
)

#: Training subsample cap, per cell: k-means fits on at most
#: ``_TRAIN_PER_CELL * cells`` rows (deterministically sampled).
_TRAIN_PER_CELL = 64

#: Rows assigned to cells per device call during a full build: bounds the
#: (chunk, C) distance transient.
_ASSIGN_CHUNK = 1 << 16

_KMEANS_SEED = 0x0f1e


def _round_up_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def auto_cells(n: int) -> int:
    """Default cell count: the power of two nearest sqrt(n)."""
    if n <= 1:
        return 1
    return max(1, 1 << int(round(math.log2(math.sqrt(n)))))


# -- device programs ---------------------------------------------------------


def probe_cost_key(batch: int, cells: int, probes: int) -> str:
    """Cost-accounting signature of the centroid-probe program."""
    return f"als.ivf_probe/b{batch}/c{cells}/p{probes}"


def scan_cost_key(batch: int, cells: int, probes: int,
                  excl: bool, lsh: bool) -> str:
    """Cost-accounting signature of the probed-cell candidate scan."""
    return (f"als.ivf_scan/b{batch}/c{cells}/p{probes}"
            + ("+excl" if excl else "") + ("+lsh" if lsh else ""))


def _probe_cells(centroids: torch.Tensor, qs: torch.Tensor, probes: int):
    """(B, P) int64: the top ``probes`` cells of each query by centroid dot
    product — the scan's only work over every cell."""
    return torch.topk(qs @ centroids.T, probes, dim=1).indices


def _excluded_hits(pos: torch.Tensor, excl_sorted: torch.Tensor) -> torch.Tensor:
    """(B, L) booleans: ``pos[b, l]`` is among query b's exclusions. A
    sorted search per query (``excl_sorted`` (B, E), each row ascending),
    the same mask as comparing every slot with every exclusion without its
    B × L × E transient."""
    p = pos.to(excl_sorted.dtype).contiguous()
    at = torch.searchsorted(excl_sorted, p).clamp_(max=excl_sorted.shape[1] - 1)
    return excl_sorted.gather(1, at) == p


def _ivf_candidates(cell_pos, cell_q, cell_scale, qs, cells, excl, r: int,
                    cell_buckets=None, lut=None):
    """Quantized scores over the probed cells only, one probe column at a
    time (the transient is one (B, L, k) block), then the exact top-``r``
    of each query's (P·L) pool: (vals, snapshot positions). Padding slots
    (``cell_pos < 0``), LSH non-candidates (``lut`` (B, buckets) with
    ``cell_buckets``) and the (B, E) exclusions score -inf."""
    b, p = cells.shape
    width = cell_pos.shape[1]
    scores = torch.empty((b, p, width), dtype=torch.float32, device=qs.device)
    pos_all = torch.empty((b, p, width), dtype=cell_pos.dtype, device=qs.device)
    excl_sorted = torch.sort(excl, dim=1).values if excl is not None else None
    for j in range(p):
        col = cells[:, j]
        pos = cell_pos[col]                               # (B, L)
        s = torch.bmm(cell_q[col].float(), qs[:, :, None])[:, :, 0]
        s.mul_(cell_scale[col])
        valid = pos >= 0
        if lut is not None:
            valid &= torch.gather(lut, 1, cell_buckets[col].long())
        s.masked_fill_(~valid, -math.inf)
        if excl_sorted is not None:
            s.masked_fill_(_excluded_hits(pos, excl_sorted), -math.inf)
        scores[:, j] = s
        pos_all[:, j] = pos
    vals, ix = torch.topk(scores.reshape(b, -1), r, dim=1)
    return vals, pos_all.reshape(b, -1).gather(1, ix)


def _ivf_cosine_candidates(cell_pos, cell_q, cell_scale, cell_norms,
                           lut_union, cell_buckets, qs, q_norms, cells, r: int):
    """Mean-cosine candidates for ONE request's query-vector set: ``cells``
    is (P,), ``qs`` (Q, k). The norms are exact float32; only the dot is
    quantized."""
    pos = cell_pos[cells]                                 # (P, L)
    qm = cell_q[cells].float()                            # (P, L, k)
    dots = torch.einsum("qk,plk->pql", qs, qm) * cell_scale[cells][:, None, :]
    sims = dots / torch.clamp(
        cell_norms[cells][:, None, :] * q_norms[None, :, None], min=1e-12)
    s = torch.where(pos >= 0, sims.mean(dim=1), -math.inf)   # (P, L)
    if lut_union is not None:
        s = torch.where(lut_union[cell_buckets[cells].long()], s, -math.inf)
    vals, ix = torch.topk(s.reshape(-1), r)
    return vals, pos.reshape(-1)[ix]


def _assign_cells(rows: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid cell per row (squared Euclidean by the product
    expansion, float32), the build's and the maintenance's rule."""
    d2 = ((rows * rows).sum(dim=1, keepdim=True)
          - 2.0 * rows @ centroids.T
          + (centroids * centroids).sum(dim=1)[None, :])
    return torch.argmin(d2, dim=1).to(torch.int32)


def _assign_host(rows: np.ndarray, centroids: torch.Tensor) -> np.ndarray:
    """:func:`_assign_cells` of host rows, on the centroids' device."""
    return _assign_cells(
        torch.as_tensor(np.asarray(rows, dtype=np.float32),
                        device=centroids.device), centroids).cpu().numpy()


# -- snapshot ----------------------------------------------------------------


class IVFSnapshot(SnapshotIndex):
    """Immutable device view of Y as an inverted-file index (int8 cells +
    float32 centroids), plus the host mirrors (flat quantized rows, the
    assignment, the cell tables) that make incremental maintenance a
    rewrite of the affected cells instead of a rebuild.

    Shares the flat int8 snapshot's duck type where serving touches it:
    ``ids`` / ``index_of`` / ``n`` / ``version`` / ``gather_rows`` (the
    pinned slab rescore view); ``mat`` / ``score_mat`` / ``buckets`` stay
    None — no flat factor copy of any dtype is on the device."""

    def __init__(self, ids, version: int, *, centroids_np=None, assign=None,
                 q_np=None, scale_np=None, norms_np=None, buckets_np=None,
                 cell_pos_np=None, cell_len=None, cell_width: int = 0,
                 probes: int = 8, skew_bound: float = 4.0,
                 centroids=None, cell_pos=None, cell_q=None,
                 cell_scale=None, cell_norms=None, cell_buckets=None,
                 slab=None, slab_rows=None,
                 prev: "IVFSnapshot | None" = None,
                 appended: "list[str] | None" = None):
        self.ids = ids
        self.n = len(ids)
        self.version = version
        # host mirrors (maintenance only — the request path never reads them)
        self.centroids_np = centroids_np   # (C, k) float32
        self.assign = assign               # (n,) int32 position → cell
        self.q_np = q_np                   # (n, k) int8 flat quantized rows
        self.scale_np = scale_np           # (n,) float32
        self.norms_np = norms_np           # (n,) float32
        self.buckets_np = buckets_np       # (n,) int32 or None
        self.cell_pos_np = cell_pos_np     # (C, L) int32, -1 pad, ascending
        self.cell_len = cell_len           # (C,) int32
        self.cell_width = cell_width       # L (pow2)
        self.probes = probes               # default probe width P (pow2)
        self.skew_bound = float(skew_bound)
        # skew at (re)build time: the drift trigger fires past
        # max(bound, 1.25 x this), so an inherently skewed catalog does not
        # re-cluster on every microbatch
        self.base_skew = 1.0
        # device tensors (the scan's inputs)
        self.centroids = centroids         # (C, k) float32
        self.cell_pos = cell_pos           # (C, L) int32
        self.cell_q = cell_q               # (C, L, k) int8
        self.cell_scale = cell_scale       # (C, L) float32
        self.cell_norms = cell_norms       # (C, L) float32
        self.cell_buckets = cell_buckets   # (C, L) int32 or None
        self.slab = slab
        self.slab_rows = slab_rows
        self.mat = None
        self.score_mat = None
        self.buckets = None
        #: host seconds of a full build, by step (``build`` sets them)
        self.build_timings: dict = {}
        self._index_ids(prev if appended is not None else None)
        # the cost keys registered at this snapshot's shape, carried by a
        # successor with the same cell geometry
        self.cost_keys_attempted = (
            prev.cost_keys_attempted
            if prev is not None and prev.n == self.n
            and prev.cell_width == cell_width
            and prev.n_cells == (0 if centroids_np is None else len(centroids_np))
            else set())
        if cell_len is not None and len(ids):
            _INDEX_SKEW.set(self.skew())
        profiling.register_quantized(self)

    @property
    def n_cells(self) -> int:
        return 0 if self.centroids_np is None else len(self.centroids_np)

    def skew(self) -> float:
        """Largest cell occupancy over the mean (n / C)."""
        if self.cell_len is None or self.n == 0 or self.n_cells == 0:
            return 1.0
        return float(self.cell_len.max()) / max(self.n / self.n_cells, 1e-9)

    def quantized_nbytes(self) -> int:
        """Device bytes of the quantized cells (int8 rows and scales)."""
        return sum(a.numel() * a.element_size()
                   for a in (self.cell_q, self.cell_scale) if a is not None)

    def device_nbytes(self) -> int:
        """All device bytes the index holds."""
        return sum(a.numel() * a.element_size()
                   for a in (self.centroids, self.cell_pos, self.cell_q,
                             self.cell_scale, self.cell_norms,
                             self.cell_buckets) if a is not None)

    def gather_rows(self, positions: np.ndarray) -> np.ndarray:
        """Exact float32 rows for snapshot positions, off the pinned slab."""
        pos = np.clip(np.asarray(positions, dtype=np.int64), 0, self.n - 1)
        return self.slab[self.slab_rows[pos]]

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, ids, host: np.ndarray, version: int, lsh,
              row_view: tuple, prev: "IVFSnapshot | None" = None, *,
              cells: int = 0, probes: int = 8, skew_bound: float = 4.0,
              centroids: "np.ndarray | None" = None, cell_width: int = 0,
              device=None):
        """Full index build from one host matrix: quantize (chunked),
        cluster (the seeded k-means fit on a bounded subsample unless
        ``centroids`` are given), assign every row, lay the cells out
        sorted ascending and pow2-padded, and land the device tensors on
        ``device`` (None: the CUDA card). ``build_timings`` holds the host
        seconds of each step."""
        from oryx_tpu_torch.models.als.serving import _quantize_rows
        from oryx_tpu_torch.models.kmeans.train import fit_index_centroids

        dev = resolve(device)
        n = len(ids)
        slab, slab_rows = row_view
        if n == 0 or host.size == 0:
            return cls(list(ids), version, probes=probes, skew_bound=skew_bound)
        t0 = time.perf_counter()
        k = host.shape[1]
        q = np.empty((n, k), dtype=np.int8)
        scale = np.empty(n, dtype=np.float32)
        norms = np.empty(n, dtype=np.float32)
        chunk = 1 << 16
        for a in range(0, n, chunk):
            b = min(n, a + chunk)
            q[a:b], scale[a:b] = _quantize_rows(host[a:b])
            norms[a:b] = np.linalg.norm(host[a:b], axis=1)
        buckets_np = None
        if lsh and lsh.num_hashes:
            buckets_np = np.array(lsh.assign_buckets(host), dtype=np.int32)
        t1 = time.perf_counter()

        c = _round_up_pow2(max(1, cells if cells > 0 else auto_cells(n)))
        c = min(c, 1 << (n.bit_length() - 1))  # pow2, at most n
        assign = None
        if centroids is None:
            cap = max(_TRAIN_PER_CELL * c, 1 << 14)
            if n > cap:
                rng = np.random.default_rng(_KMEANS_SEED)
                sample = host[rng.choice(n, cap, replace=False)]
                centroids, _, _ = fit_index_centroids(
                    sample, c, seed=_KMEANS_SEED, device=dev)
            else:
                centroids, _, assign = fit_index_centroids(
                    host, c, seed=_KMEANS_SEED, device=dev)
        centroids = np.array(centroids, dtype=np.float32)
        c = len(centroids)
        cent_dev = torch.as_tensor(centroids, device=dev)
        t2 = time.perf_counter()
        if assign is not None:
            assign = np.array(assign, dtype=np.int32)  # writable copy
        else:
            assign = np.empty(n, dtype=np.int32)
            for a in range(0, n, _ASSIGN_CHUNK):
                b = min(n, a + _ASSIGN_CHUNK)
                assign[a:b] = _assign_host(host[a:b], cent_dev)
        t3 = time.perf_counter()
        cell_len = np.bincount(assign, minlength=c).astype(np.int32)
        width = cell_width if cell_width > 0 else _round_up_pow2(
            max(int(cell_len.max()) + (int(cell_len.max()) >> 2) + 4, 8))
        if cell_len.max() > width:
            raise ValueError(
                f"cell_width {width} overflows (largest cell "
                f"{int(cell_len.max())})")
        # canonical layout: members sorted ascending per cell (a stable
        # sort groups by cell, positions stay ascending) — the invariant
        # incremental maintenance keeps byte for byte
        order = np.argsort(assign, kind="stable")
        cell_pos_np = np.full((c, width), -1, dtype=np.int32)
        offsets = np.zeros(c + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(cell_len, dtype=np.int64)
        for j in range(c):
            members = order[offsets[j]:offsets[j + 1]]
            cell_pos_np[j, : len(members)] = members
        snap = cls(
            list(ids), version, centroids_np=centroids, assign=assign,
            q_np=q, scale_np=scale, norms_np=norms, buckets_np=buckets_np,
            cell_pos_np=cell_pos_np, cell_len=cell_len, cell_width=width,
            probes=max(1, min(_round_up_pow2(probes), c)),
            skew_bound=skew_bound, centroids=cent_dev,
            slab=slab, slab_rows=slab_rows, prev=prev,
        )
        snap._land_cells(np.arange(c, dtype=np.int64), full=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t4 = time.perf_counter()
        snap.base_skew = snap.skew()
        snap.build_timings = {"quantize_s": t1 - t0, "fit_s": t2 - t1,
                              "assign_s": t3 - t2, "land_s": t4 - t3}
        _INDEX_CELLS.inc(c)
        _INDEX_SKEW.set(snap.base_skew)
        return snap

    def _cell_block(self, cell_ids: np.ndarray):
        """Host (A, L[, k]) blocks for ``cell_ids`` from the flat mirrors,
        with the padding values the device tensors carry (pos -1, q 0,
        scale and norm 1): build and incremental maintenance share this, so
        their device bytes are the same by construction."""
        sub = self.cell_pos_np[cell_ids]                # (A, L)
        pad = sub < 0
        safe = np.clip(sub, 0, max(self.n - 1, 0))
        cq = self.q_np[safe]
        cq[pad] = 0
        cs = self.scale_np[safe]
        cs[pad] = 1.0
        cn = self.norms_np[safe]
        cn[pad] = 1.0
        cb = None
        if self.buckets_np is not None:
            cb = self.buckets_np[safe].astype(np.int32)
            cb[pad] = 0
        return sub, cq, cs, cn, cb

    def _land_cells(self, cell_ids: np.ndarray, full: bool = False) -> None:
        """Put ``cell_ids``' slices on the device: whole uploads on a full
        build; incrementally, NEW tensors with the cells' rows replaced
        (``index_copy`` out of place), so the previous snapshot's stay as
        they were."""
        dev = self.centroids.device
        sub, cq, cs, cn, cb = self._cell_block(cell_ids)
        blocks = [torch.as_tensor(a, device=dev) for a in (sub, cq, cs, cn)]
        b_t = torch.as_tensor(cb, device=dev) if cb is not None else None
        if full:
            self.cell_pos, self.cell_q, self.cell_scale, self.cell_norms = blocks
            self.cell_buckets = b_t
            return
        ix = torch.as_tensor(cell_ids, dtype=torch.int64, device=dev)
        self.cell_pos = self.cell_pos.index_copy(0, ix, blocks[0])
        self.cell_q = self.cell_q.index_copy(0, ix, blocks[1])
        self.cell_scale = self.cell_scale.index_copy(0, ix, blocks[2])
        self.cell_norms = self.cell_norms.index_copy(0, ix, blocks[3])
        if self.cell_buckets is not None and b_t is not None:
            self.cell_buckets = self.cell_buckets.index_copy(0, ix, b_t)

    @classmethod
    def from_delta(cls, prev: "IVFSnapshot", delta, lsh):
        """Incremental step off one composed store delta: requantize and
        reassign ONLY the touched rows, splice them through the host cell
        tables (ascending order kept), and rewrite only the affected cells
        on the device. None when a cell would overflow its padded width or
        the balance drifts past ``skew_bound``: the caller re-clusters."""
        from oryx_tpu_torch.models.als.serving import _quantize_rows

        n_prev = prev.n
        if prev.cell_q is None or prev.centroids_np is None:
            return None
        # the flat host mirrors: changed rows update in place (the request
        # path never reads them), appends extend by copy
        q_np, scale_np, norms_np, buckets_np = (
            prev.q_np, prev.scale_np, prev.norms_np, prev.buckets_np)
        assign = prev.assign
        cell_pos_np, cell_len = prev.cell_pos_np, prev.cell_len
        width = prev.cell_width
        affected: set[int] = set()

        changed_pos = np.asarray(
            [prev.id_to_idx[i] for i in delta.changed_ids if i in prev.id_to_idx],
            dtype=np.int64)
        if len(changed_pos):
            qc, sc = _quantize_rows(delta.changed_vals)
            q_np[changed_pos] = qc
            scale_np[changed_pos] = sc
            norms_np[changed_pos] = np.linalg.norm(delta.changed_vals, axis=1)
            if buckets_np is not None:
                buckets_np[changed_pos] = lsh.assign_buckets(delta.changed_vals)
            new_cells = _assign_host(delta.changed_vals, prev.centroids)
            for pos, nc in zip(changed_pos, new_cells):
                oc = int(assign[pos])
                affected.add(oc)
                if int(nc) != oc:
                    if not _splice(cell_pos_np, cell_len, oc, int(nc),
                                   int(pos), width):
                        return None
                    assign[pos] = nc
                    affected.add(int(nc))
        if delta.appended_ids:
            qa, sa = _quantize_rows(delta.appended_vals)
            q_np = np.concatenate([q_np, qa])
            scale_np = np.concatenate([scale_np, sa])
            norms_np = np.concatenate([
                norms_np, np.linalg.norm(delta.appended_vals, axis=1)])
            if buckets_np is not None:
                buckets_np = np.concatenate([
                    buckets_np,
                    np.asarray(lsh.assign_buckets(delta.appended_vals),
                               dtype=np.int32)])
            app_cells = _assign_host(delta.appended_vals, prev.centroids)
            assign = np.concatenate([assign, app_cells])
            for off, nc in enumerate(app_cells):
                if not _insert(cell_pos_np, cell_len, int(nc), n_prev + off,
                               width):
                    return None
                affected.add(int(nc))
        ids = prev.ids + delta.appended_ids
        slab_rows = (
            np.concatenate([prev.slab_rows,
                            np.asarray(delta.appended_rows, dtype=np.int64)])
            if len(delta.appended_ids) else prev.slab_rows)
        snap = cls(
            ids, delta.version, centroids_np=prev.centroids_np,
            assign=assign, q_np=q_np, scale_np=scale_np, norms_np=norms_np,
            buckets_np=buckets_np, cell_pos_np=cell_pos_np,
            cell_len=cell_len, cell_width=width, probes=prev.probes,
            skew_bound=prev.skew_bound, centroids=prev.centroids,
            cell_pos=prev.cell_pos, cell_q=prev.cell_q,
            cell_scale=prev.cell_scale, cell_norms=prev.cell_norms,
            cell_buckets=prev.cell_buckets, slab=delta.slab,
            slab_rows=slab_rows, prev=prev, appended=delta.appended_ids,
        )
        snap.base_skew = prev.base_skew
        if snap.skew() > max(snap.skew_bound, prev.base_skew * 1.25):
            log.info("IVF cell balance drifted past %.1fx (%.2fx) — "
                     "re-clustering", snap.skew_bound, snap.skew())
            return None
        if affected:
            snap._land_cells(np.fromiter(sorted(affected), dtype=np.int64))
        _INDEX_SKEW.set(snap.skew())
        return snap


def _splice(cell_pos_np, cell_len, old_cell: int, new_cell: int,
            pos: int, width: int) -> bool:
    """Move ``pos`` from one sorted cell row to another in place; False if
    the destination is full (the caller rebuilds)."""
    ln = int(cell_len[old_cell])
    row = cell_pos_np[old_cell]
    i = int(np.searchsorted(row[:ln], pos))
    if i < ln and row[i] == pos:
        row[i:ln - 1] = row[i + 1:ln]
        row[ln - 1] = -1
        cell_len[old_cell] = ln - 1
    return _insert(cell_pos_np, cell_len, new_cell, pos, width)


def _insert(cell_pos_np, cell_len, cell: int, pos: int, width: int) -> bool:
    ln = int(cell_len[cell])
    if ln >= width:
        return False
    row = cell_pos_np[cell]
    i = int(np.searchsorted(row[:ln], pos))
    row[i + 1:ln + 1] = row[i:ln]
    row[i] = pos
    cell_len[cell] = ln + 1
    return True


# -- serving entry points ----------------------------------------------------
# Called from ALSServingModel (models/als/serving.py) with the model as the
# first argument: exclusions, LSH tables, the exact rescore and the host
# collection are the model's flat-path helpers, so the IVF path differs ONLY
# in how candidates are generated.


def _candidate_width(model, snap: IVFSnapshot, probes: int, want: int) -> int:
    """Rescore width for one scan: ``rescore-factor x want`` rounded up to a
    pow2, capped by what the probed cells can surface."""
    cap = min(snap.n, probes * snap.cell_width)
    return max(1, min(cap, _round_up_pow2(
        max(int(model.rescore_factor * want), 16))))


def _register_scan_costs(model, snap: IVFSnapshot, b: int, probes: int,
                         pk: str, sk: str, lut) -> None:
    """The probe's and the cell scan's analytic costs (module docstring),
    on each key's first use at this snapshot's shape."""
    from oryx_tpu_torch.models.als.serving import register_cost

    c, width, k = snap.n_cells, snap.cell_width, model.features
    register_cost(snap, pk, 2.0 * b * c * k, 4.0 * c * k)
    cells_read = min(b * probes, c)
    nbytes = float(cells_read) * width * (k + 8)
    if lut is not None:
        nbytes += 4.0 * cells_read * width + lut.numel()
    register_cost(snap, sk, 2.0 * b * probes * width * k, nbytes)


def _scan(model, snap: IVFSnapshot, qs_host: np.ndarray, probes: int,
          r: int, excl, lut, register: bool = False):
    """One probe + candidate scan: (vals, positions) of width ``r``,
    quantized scores, on the host. ``register`` (the batched path) records
    one call of the probe and one of the scan in the cost accounting."""
    b = len(qs_host)
    qs = torch.as_tensor(qs_host, device=model.device)
    if register:
        pk = probe_cost_key(b, snap.n_cells, probes)
        sk = scan_cost_key(b, snap.n_cells, probes, excl is not None,
                           lut is not None)
        _register_scan_costs(model, snap, b, probes, pk, sk, lut)
    cells = _probe_cells(snap.centroids, qs, probes)
    vals, idx = _ivf_candidates(snap.cell_pos, snap.cell_q, snap.cell_scale,
                                qs, cells, excl, r, snap.cell_buckets, lut)
    if register:
        profiling.costs().record(pk)
        profiling.costs().record(sk)
    _INDEX_PROBED.inc(b * probes)
    _INDEX_CANDIDATES.inc(b * r)
    return vals.cpu().numpy(), idx.cpu().numpy()


def _lut(model, snap: IVFSnapshot, qs_host: np.ndarray):
    return (model._build_lut(qs_host)
            if model.lsh is not None and snap.cell_buckets is not None else None)


def top_n(model, snap: IVFSnapshot, q_host: np.ndarray, how_many: int,
          offset: int, allowed, rescore, excluded) -> list:
    """Single-query IVF top-N with widening: the rescore width doubles first
    (more candidates from the same probes), then the probe width (pow2)
    until the request is satisfied or the scan covers the whole catalog."""
    want = how_many + offset
    excl = model._excl_tensor(snap, [excluded], 1)
    lut = _lut(model, snap, q_host[None, :])
    probes = snap.probes
    r = _round_up_pow2(max(int(model.rescore_factor * want), 16))
    while True:
        cap = min(snap.n, probes * snap.cell_width)
        r_eff = min(r, cap)
        v, i = _scan(model, snap, q_host[None, :], probes, r_eff, excl, lut)
        vals, idx = model._rescore_exact(snap, q_host[None, :], v, i)
        out = model._collect(snap, vals[0], idx[0], want, allowed, rescore)
        if len(out) >= want or (probes >= snap.n_cells and r_eff >= snap.n):
            return out[offset:offset + how_many]
        if r_eff < cap:
            r = r_eff * 2  # widen the cut over the same probed cells
        else:
            probes = min(snap.n_cells, probes * 2)  # widen the probe set
            r = min(snap.n, r * 2)


def top_n_batch(model, snap: IVFSnapshot, qs_host: np.ndarray, how_many: int,
                alloweds, excluded, filtering: bool) -> list:
    """Batched IVF top-N: one probe product and one probed-cell scan for the
    whole batch, rescored exactly from the slab before the final cut; a
    query that host filtering starves falls back to :func:`top_n`."""
    excl = model._excl_tensor(snap, excluded, len(qs_host))
    r = _candidate_width(model, snap, snap.probes, how_many)
    v, i = _scan(model, snap, qs_host, snap.probes, r, excl,
                 _lut(model, snap, qs_host), register=True)
    vals, idx = model._rescore_exact(snap, qs_host, v, i)

    def single(q, how_many_, offset, allowed, rescore, excluded=None):
        return top_n(model, snap, q, how_many_, offset, allowed, rescore,
                     excluded)

    return model._batch_results(snap, qs_host, vals, idx, r, how_many,
                                alloweds, excluded, filtering, single)


def top_n_cosine(model, snap: IVFSnapshot, qs_host: np.ndarray,
                 q_norms_host: np.ndarray, how_many: int, offset: int,
                 allowed, rescore) -> list:
    """Mean-cosine IVF top-N for one request's query-vector set: the probes
    rank by the MEAN query direction, candidates are rescored exactly
    (cosine) from the slab; widening as :func:`top_n`."""
    want = how_many + offset
    dev = model.device
    qs = torch.as_tensor(qs_host, device=dev)
    q_norms = torch.as_tensor(np.asarray(q_norms_host, dtype=np.float32),
                              device=dev)
    lut_union = None
    if model.lsh is not None and snap.cell_buckets is not None:
        lu = np.zeros(model.lsh.num_buckets, dtype=bool)
        for qv in qs_host:
            lu[model.lsh.get_candidate_indices(qv)] = True
        lut_union = torch.as_tensor(lu, device=dev)
    probe_vec = torch.as_tensor(np.mean(qs_host, axis=0, keepdims=True),
                                device=dev)
    probes = snap.probes
    r = _round_up_pow2(max(int(model.rescore_factor * want), 16))
    while True:
        cap = min(snap.n, probes * snap.cell_width)
        r_eff = min(r, cap)
        cells = _probe_cells(snap.centroids, probe_vec, probes)
        v, i = _ivf_cosine_candidates(
            snap.cell_pos, snap.cell_q, snap.cell_scale, snap.cell_norms,
            lut_union, snap.cell_buckets, qs, q_norms, cells[0], r_eff)
        _INDEX_PROBED.inc(probes)
        _INDEX_CANDIDATES.inc(r_eff)
        vals, idx = model._rescore_exact(
            snap, qs_host, v.cpu().numpy()[None, :], i.cpu().numpy()[None, :],
            cosine=True)
        out = model._collect(snap, vals[0], idx[0], want, allowed, rescore)
        if len(out) >= want or (probes >= snap.n_cells and r_eff >= snap.n):
            return out[offset:offset + how_many]
        if r_eff < cap:
            r = r_eff * 2
        else:
            probes = min(snap.n_cells, probes * 2)
            r = min(snap.n, r * 2)
