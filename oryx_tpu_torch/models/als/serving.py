"""ALS serving model: device-resident item factors answering top-N queries.

The port of the reference's ``ALSServingModel`` and
``ALSServingModelManager`` (``models/als/serving.py``) on one device, with
every item representation the reference serves from
(``oryx.serving.device-dtype``):

* ``float32`` (and ``auto``, the reference's own rule off a TPU): Y lives on
  the device as one dense float32 matrix that the host store keeps current
  (``FeatureVectorStore.materialize``: a speed microbatch's point updates
  reach it as one scatter and one append, a model handoff as one whole
  upload), and a batch of queries is answered by ONE ``scores = Q @ Yᵀ``
  product, masking, and ``torch.topk``; the float32 product runs without
  TF32;
* ``bfloat16``: a bfloat16 scoring copy beside the float32 matrix (which
  keeps the exact dots and norms), scored with float32 output
  (``torch.mm(..., out_dtype=torch.float32)`` on the card; on the CPU the
  bf16-rounded operands in a float32 product), as the reference's
  ``preferred_element_type=float32``;
* ``int8`` (:class:`_QuantSnapshot`): only a per-row-scaled int8 slab, its
  scales and exact norms on the device. A scan converts the slab to float32
  one row chunk at a time (:func:`_scan_rows` bounds the transient; no
  float32 copy of the slab is ever made or kept) and keeps a running top-r
  over the chunks; the top ``rescore-factor × how_many`` candidates are
  rescored exactly in float32 on the host from the store's pinned slab
  view before the final cut. With ``oryx.serving.index.enabled`` the int8
  rows live in the IVF cells of :mod:`~oryx_tpu_torch.models.als.ivf`.

``oryx.als.sample-rate < 1`` masks every representation's scan with LSH
buckets (:mod:`~oryx_tpu_torch.models.als.lsh`), carried across incremental
snapshots. The reference leaves all of these scans to XLA outside any
Pallas kernel (matmul + ``approx_max_k``), so they are plain torch here
too; ``torch.topk`` is exact where ``approx_max_k`` is exact only off a
TPU.

The manager consumes the update topic as the reference's does: ``MODEL`` /
``MODEL-REF`` with new features builds a new model with its stores
presized and the expected ids set; with the same features it retains what
the new model names or what was written since the last handoff;
``UP ["X"|"Y", id, vector(, known items)]`` sets one vector. After each
message it starts the YᵀY factorisation in the background once the model is
loaded enough (rate-limited), so the first fold-in request does not wait
for it. It loads the ``oryx.als.rescorer-provider-class`` providers
(:mod:`~oryx_tpu_torch.models.als.rescorer`) for the resources.

The fold-in API the serving resources call is here too: the YᵀY solver
(``SolverCache`` over ``y.get_vtv``, host float64 as in the reference),
``build_temporary_user_vector``, ``dot_with_items``, the mean-cosine
``top_n_cosine`` on the device, and the known-item counts.

Generation handoffs double-buffer as the reference's do: with
``oryx.serving.compute.precompile-batches`` and ``oryx.compile.prewarm-swap``
on, a ``MODEL`` whose feature count differs builds the incoming generation
as the manager's STAGED model while the old one keeps answering; ``UP``s
fill the staged one, the serving layer's batch warmer runs its warm ladder
(which builds its device snapshot) off the request path and then promotes
it (``promote_staged``); a staged generation older than
``oryx.compile.swap-deadline-sec`` is promoted unwarmed by
:meth:`ALSServingModelManager.get_model`.

Each batched top-N records one call into the device cost accounting
(:mod:`oryx_tpu_torch.common.profiling`) under the reference's program
keys (:func:`_topn_cost_key`, and ``ivf.probe_cost_key`` /
``scan_cost_key``). The reference registers each key's cost from XLA's
``cost_analysis()`` of the compiled program; torch compiles nothing, so
here the cost is analytic, registered on the key's first use per snapshot
shape: ``2·B·n·k`` FLOPs, and as bytes the scanned representation read
once (``4nk`` float32, ``2nk`` bfloat16, ``nk + 4n`` int8 rows and
scales), plus the LSH buckets (``4n``) and the (B, buckets) candidate
table when LSH masks the scan. The int8 path's exact rescore runs on the
host and is not device work. ``warm_bucket`` runs each program once on a
zero batch.

Sharded serving (the reference's multi-device scan): with a ``mesh`` the
snapshot also holds the scoring copy row-sharded over ``shard_axis``
(:class:`~oryx_tpu_torch.parallel.mesh.ShardedRows`, rows padded to the
shard count) and the LSH buckets sharded the same way. A batch is scored
shard by shard, each on its device: the pad rows, the queries' LSH
candidate table and their excluded rows (global indices rebased to the
shard) are masked, a local top-k is taken, and the (B, shards·k)
candidates merge, in shard order, with one more top-k. Host-callable
filters fall back to the unsharded scan; point updates reach the sharded
copy with the next snapshot; int8 with a mesh degrades to bfloat16 with
the reference's warning. The manager reads ``oryx.serving.compute.
sharded`` and shards over every local device when there is more than one;
with one it logs and serves unsharded, as the reference does.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
import weakref
from typing import Callable, Sequence

import numpy as np
import torch

from oryx_tpu_torch.api.serving import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.common import lineage
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import profiling
from oryx_tpu_torch.common import spans
from oryx_tpu_torch.common.device import resolve, to_host
from oryx_tpu_torch.common.lockutils import RateLimitCheck
from oryx_tpu_torch.ml.mlupdate import read_pmml_from_update_key_message
from oryx_tpu_torch.models.als import foldin, pmml_codec
from oryx_tpu_torch.models.als import ivf as ivf_mod
from oryx_tpu_torch.models.als.lsh import LocalitySensitiveHash
from oryx_tpu_torch.models.als.rescorer import load_rescorer_providers
from oryx_tpu_torch.models.als.vectors import FeatureVectorStore, SnapshotIndex
from oryx_tpu_torch.ops.solver import SolverCache
from oryx_tpu_torch.parallel.mesh import (
    Mesh,
    local_devices,
    make_mesh,
    replicated,
    shard_rows,
)

log = logging.getLogger(__name__)

_TOPN_BATCH_SECONDS = metrics_mod.default_registry().histogram(
    "oryx_serving_topn_batch_seconds",
    "Host-observed latency of one batched top-N device call",
)
_TOPN_QUERIES = metrics_mod.default_registry().counter(
    "oryx_serving_topn_queries_total",
    "Queries answered through the batched top-N path",
)
_LOAD_FRACTION = metrics_mod.default_registry().gauge(
    "oryx_serving_model_load_fraction",
    "Fraction of expected model vectors loaded (evaluated at scrape time)",
)
_PREWARMED_SWAPS = metrics_mod.default_registry().counter(
    "oryx_serving_prewarmed_swaps_total",
    "Model-generation swaps promoted after off-path bucket warmup",
)
_DEADLINE_SWAPS = metrics_mod.default_registry().counter(
    "oryx_serving_swap_deadline_promotions_total",
    "Staged model generations promoted by the swap deadline, unwarmed",
)


def _load_fraction_fn(manager_ref):
    """Scrape-time gauge callback over a WEAK manager ref: a strong ref
    would pin a retired manager (and its factor matrices) for the process
    lifetime after a test or redeploy drops it."""

    def fn() -> float:
        manager = manager_ref()
        model = manager.get_model() if manager is not None else None
        return model.get_fraction_loaded() if model is not None else 0.0

    return fn


def _round_up_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _topn_cost_key(batch_size: int, excl: bool, quant: bool = False) -> str:
    """Cost-accounting program signature for one batched top-N variant (the
    reference's keys): batch size, exclusion-carrying, quantized."""
    return (f"als.top_n_batch/b{batch_size}"
            + ("+excl" if excl else "") + ("+int8" if quant else ""))


def _carry_cost_keys(snap, prev) -> None:
    """A snapshot's set of cost keys registered at its shape: an incremental
    successor with the same row count carries its predecessor's (the
    analytic cost depends on the row count), any other starts empty."""
    snap.cost_keys_attempted = (
        prev.cost_keys_attempted
        if prev is not None and prev.n == snap.n else set())


def register_cost(snap, key: str, flops: float, bytes_: float) -> None:
    """Register ``key``'s analytic per-call cost on its first use at this
    snapshot's shape (the reference registers XLA's cost once per compiled
    signature and generation)."""
    if (key in snap.cost_keys_attempted
            or not metrics_mod.default_registry().enabled):
        return
    snap.cost_keys_attempted.add(key)
    profiling.costs().register(key, flops, bytes_)


def _lsh_bytes(lsh, snap_n: int, batch: int) -> float:
    """Bytes an LSH-masked scan reads beyond the rows: the rows' int32
    buckets and the (B, buckets) boolean candidate table."""
    return 4.0 * snap_n + batch * lsh.num_buckets


#: Floor of the pow2-bucketed exclusion-mask width (the reference's value:
#: its compiled programs are keyed by this width, so the port keeps the
#: same (B, E) shapes).
_EXCL_PAD_MIN = 8

#: Valid values of ``oryx.serving.device-dtype`` (the reference's):
#: ``auto`` scores in float32 off a TPU, ``float32`` / ``bfloat16`` force
#: the scoring copy's dtype, ``int8`` holds only the per-row-scaled slab.
_DEVICE_DTYPES = ("auto", "float32", "bfloat16", "int8")

#: Device bytes one chunk of a quantized scan may take for its float32
#: transients (the converted rows and the chunk's scores): the int8 slab
#: is never converted whole.
_SCAN_BYTES = 64 << 20


def _score(qs: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """(B, n) float32 scores. A bfloat16 ``mat`` is scored with float32
    output: on the card one bf16 product with float32 accumulation and
    output; on the CPU the bf16-rounded operands in a float32 product (the
    same exact products, summed in float32)."""
    if mat.dtype != torch.bfloat16:
        return qs @ mat.T
    qb = qs.to(torch.bfloat16)
    if mat.device.type == "cuda":
        return torch.mm(qb, mat.T, out_dtype=torch.float32)
    return qb.float() @ mat.float().T


def _mask_excluded(scores: torch.Tensor, excl: torch.Tensor) -> torch.Tensor:
    """Per-query exclusion, in place: ``excl`` is (B, E) row indices,
    -1-padded. Out-of-range entries (the padding, or ids newer than the
    scores) must not touch any column. A scatter cannot drop an index, so
    each out-of-range entry is pointed at a column its row excludes anyway
    (writing -inf again), or, in a row that excludes nothing, at column 0
    with column 0's own score. No host synchronisation."""
    n = scores.shape[1]
    valid = (excl >= 0) & (excl < n)
    any_valid = valid.any(dim=1, keepdim=True)
    first = excl.gather(1, valid.int().argmax(dim=1, keepdim=True))
    fill = torch.where(any_valid, first, torch.zeros_like(first))
    idx = torch.where(valid, excl, fill)
    src = torch.where(
        any_valid, torch.full_like(scores[:, :1], -math.inf), scores[:, :1]
    ).expand(idx.shape)
    return scores.scatter_(1, idx, src)


def _masked_scores(mat, qs, valid=None, excl=None):
    """Scores with the optional masks: ``valid`` (n,) or (B, n) booleans
    (LSH candidates), ``excl`` the (B, E) exclusions."""
    scores = _score(qs, mat)
    if valid is not None:
        scores = torch.where(valid, scores, -math.inf)
    if excl is not None:
        scores = _mask_excluded(scores, excl)
    return scores


# -- quantized (int8) candidate scan ----------------------------------------
# The int8 scan reads a quarter of float32's bytes per row; its scores only
# CHOOSE candidates: the final ranking comes from an exact float32 rescore of
# the top ``rescore-factor × how_many`` rows from the host store's slab.


def _quantize_rows(mat: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """Per-row symmetric int8 quantization: scale_i = max|row_i| / 127.
    Zero rows get scale 1 (their dots are exactly 0 either way). Host
    numpy, a copy of the reference's: the same bytes."""
    if mat.size == 0:
        return (np.zeros(mat.shape, dtype=np.int8),
                np.ones(mat.shape[0], dtype=np.float32))
    amax = np.max(np.abs(mat), axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(mat / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def _scan_rows(batch: int, k: int) -> int:
    """Rows per chunk of a quantized scan of ``batch`` queries: the chunk's
    float32 rows (k floats a row) and its scores (``batch`` a row) within
    :data:`_SCAN_BYTES`."""
    return max(1024, _SCAN_BYTES // (4 * (batch + k)))


def _quant_chunk_scores(snap, qs, a: int, e: int, lut=None, valid=None,
                        excl=None) -> torch.Tensor:
    """(B, e - a) approximate masked scores of rows [a, e): the chunk's
    int8 rows converted to float32, one float32 product, the per-row scale
    as one broadcast multiply, then the masks (``lut`` (B, buckets) per
    query, ``valid`` (n,), ``excl`` (B, E) in snapshot rows). The scale and
    the masks apply in place: the chunk's transient is its rows and one
    (B, e - a) score block."""
    s = (qs @ snap.qmat[a:e].float().T).mul_(snap.qscale[a:e][None, :])
    if lut is not None:
        s.masked_fill_(~lut[:, snap.buckets[a:e]], -math.inf)
    if valid is not None:
        s.masked_fill_(~valid[a:e][None, :], -math.inf)
    if excl is not None:
        s = _mask_excluded(s, excl - a)
    return s


def _quant_masked_scores(snap, qs, valid=None, excl=None) -> torch.Tensor:
    """(B, n) approximate masked scores over the whole slab, built chunk by
    chunk (the single-query path keeps them to widen its top-k)."""
    n = snap.n
    out = torch.empty((qs.shape[0], n), dtype=torch.float32, device=qs.device)
    step = _scan_rows(qs.shape[0], qs.shape[1])
    for a in range(0, n, step):
        e = min(n, a + step)
        out[:, a:e] = _quant_chunk_scores(snap, qs, a, e, valid=valid, excl=excl)
    return out


def _quant_candidates(snap, qs, r: int, lut=None, valid=None, excl=None):
    """Top-``r`` CANDIDATES (approximate scores, snapshot rows) of each
    query: each row chunk's top-r merged into a running top-r, so the scan's
    transient stays one chunk's whatever the batch and the catalog."""
    n = snap.n
    step = _scan_rows(qs.shape[0], qs.shape[1])
    best_v = best_i = None
    for a in range(0, n, step):
        e = min(n, a + step)
        s = _quant_chunk_scores(snap, qs, a, e, lut=lut, valid=valid, excl=excl)
        v, i = torch.topk(s, min(r, e - a), dim=1)
        i = i + a
        if best_v is not None:
            v, j = torch.topk(torch.cat([best_v, v], dim=1), min(r, e), dim=1)
            i = torch.cat([best_i, i], dim=1).gather(1, j)
        best_v, best_i = v, i
    return best_v, best_i


def _quant_cosine_scores(snap, qs, q_norms, valid=None) -> torch.Tensor:
    """(n,) mean-cosine approximate scores off the int8 slab, by row chunk
    (the norms are the exact float32 ones)."""
    n = snap.n
    out = torch.empty(n, dtype=torch.float32, device=qs.device)
    step = _scan_rows(qs.shape[0], qs.shape[1])
    for a in range(0, n, step):
        e = min(n, a + step)
        sims = (qs @ snap.qmat[a:e].float().T).mul_(snap.qscale[a:e][None, :])
        sims.div_(torch.clamp(snap.norms[a:e][None, :] * q_norms[:, None],
                              min=1e-12))
        out[a:e] = sims.mean(dim=0)
    if valid is not None:
        out = torch.where(valid, out, -math.inf)
    return out


class _YSnapshot(SnapshotIndex):
    """Immutable device view of Y: the float32 matrix, its scoring copy
    (the matrix itself, or bfloat16), its row norms, LSH buckets, and ids.

    ``ids`` is the store's id list of the matrix's order epoch, shared with
    later snapshots of the same epoch: only its first ``n`` entries are this
    snapshot's. ``prev`` + ``delta`` (``FeatureVectorStore.delta_since``)
    build the snapshot after a speed microbatch without an O(n) host step:
    the id → row map is ``prev``'s, extended for the appended rows, and the
    LSH buckets are hashed again for only the changed and appended rows
    (new tensors: ``prev``'s are never written)."""

    def __init__(self, ids, mat: "torch.Tensor | None",
                 prev: "_YSnapshot | None" = None,
                 delta: "tuple[np.ndarray, int] | None" = None,
                 lsh: "LocalitySensitiveHash | None" = None,
                 device_dtype: str = "auto", mesh: "Mesh | None" = None,
                 shard_axis: str = "model"):
        self.ids = ids
        self.mat = mat  # (n, k) float32 on the serving device, or None
        self.n = 0 if mat is None else mat.shape[0]
        incremental = prev is not None and delta is not None
        self._index_ids(prev if incremental else None)
        _carry_cost_keys(self, prev if incremental else None)
        self.norms = self.score_mat = self.buckets = None
        # with a mesh: the scoring copy and the buckets row-sharded over
        # shard_axis (zero buckets without LSH, so every shard has some)
        self.sharded_mat = self.sharded_buckets = None
        if mat is None:
            return
        self.norms = torch.linalg.vector_norm(mat, dim=1)
        self.score_mat = (mat.to(torch.bfloat16) if device_dtype == "bfloat16"
                          else mat)
        if lsh is not None and lsh.num_hashes:
            dev = mat.device
            if incremental and prev.buckets is not None:
                buckets = prev.buckets
                changed, n_new = delta
                if len(changed):
                    ch = torch.as_tensor(changed, dtype=torch.int64, device=dev)
                    new_b = lsh.assign_buckets(mat[ch].cpu().numpy())
                    buckets = buckets.index_copy(
                        0, ch, torch.as_tensor(new_b, device=dev))
                if n_new:
                    tail = lsh.assign_buckets(mat[prev.n:].cpu().numpy())
                    buckets = torch.cat(
                        [buckets, torch.as_tensor(tail, device=dev)])
                self.buckets = buckets
            else:
                self.buckets = torch.as_tensor(
                    lsh.assign_buckets(mat.cpu().numpy()), device=dev)
        if mesh is not None:
            self.sharded_mat = shard_rows(self.score_mat, mesh, shard_axis)
            buckets = (self.buckets if self.buckets is not None else
                       torch.zeros(self.n, dtype=torch.int64, device=mat.device))
            self.sharded_buckets = shard_rows(buckets, mesh, shard_axis)

    def device_nbytes(self) -> int:
        arrays = [a for a in (self.mat,
                              self.score_mat if self.score_mat is not self.mat else None,
                              self.norms, self.buckets) if a is not None]
        # a shard on the scoring copy's own device is a view of it: counted
        # once; a padded or moved shard holds bytes of its own
        held = {a.untyped_storage().data_ptr() for a in arrays}
        for sharded in (self.sharded_mat, self.sharded_buckets):
            if sharded is not None:
                arrays.extend(t for t in sharded.shards
                              if t.untyped_storage().data_ptr() not in held)
        return sum(a.numel() * a.element_size() for a in arrays)


#: Host-side quantization chunk: bounds the transient float32 work while
#: building a full quantized snapshot.
_QUANT_CHUNK = 1 << 16


class _QuantSnapshot(SnapshotIndex):
    """Immutable int8 device view of Y (``device-dtype = int8``):
    per-row-scaled int8 factors, exact float32 norms and the optional LSH
    buckets. No float32 (or bfloat16) copy of Y is ever on the device.

    Built from the store's host snapshot (``host_matrix``) and kept current
    with composed host deltas (``delta_info``): a speed microbatch's point
    updates requantize only the changed and appended rows, landed in NEW
    tensors (a query thread may hold this one). ``version`` anchors the next
    delta; ``slab`` / ``slab_rows`` are the pinned exact-rescore view."""

    def __init__(self, ids, version: int, qmat, qscale, norms, buckets,
                 prev: "_QuantSnapshot | None" = None,
                 appended: "list[str] | None" = None,
                 slab=None, slab_rows=None):
        self.ids = ids
        self.n = len(ids)
        self.version = version
        self.qmat = qmat        # (n, k) int8 on the device
        self.qscale = qscale    # (n,) float32
        self.norms = norms      # (n,) float32, exact
        self.buckets = buckets  # (n,) int32 or None
        # this snapshot's slab object and the slab row of each position:
        # structural store changes replace the live slab and never write
        # this one; a point update into a captured row is visible here, and
        # the rescore then ranks with factors newer than the scan's (benign)
        self.slab = slab
        self.slab_rows = slab_rows
        self.mat = None
        self.score_mat = None
        self._index_ids(prev if appended is not None else None)
        _carry_cost_keys(self, prev)
        profiling.register_quantized(self)

    def quantized_nbytes(self) -> int:
        """Device bytes of the quantized factors: the int8 rows and their
        float32 scales."""
        return sum(a.numel() * a.element_size()
                   for a in (self.qmat, self.qscale) if a is not None)

    def device_nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.qmat, self.qscale, self.norms, self.buckets)
                   if a is not None)

    def gather_rows(self, positions: np.ndarray) -> np.ndarray:
        """Exact float32 rows for snapshot ``positions``, gathered from the
        pinned slab view (one fancy index)."""
        pos = np.clip(np.asarray(positions, dtype=np.int64), 0, self.n - 1)
        return self.slab[self.slab_rows[pos]]

    @classmethod
    def build(cls, ids, host: np.ndarray, version: int,
              lsh: "LocalitySensitiveHash | None", row_view: tuple,
              device: torch.device, prev: "_QuantSnapshot | None" = None):
        """Full quantized build from one host matrix, quantized in chunks so
        the host transient stays bounded."""
        n = len(ids)
        slab, slab_rows = row_view
        if n == 0 or host.size == 0:
            return cls(list(ids), version, None, None, None, None)
        k = host.shape[1]
        q = np.empty((n, k), dtype=np.int8)
        scale = np.empty(n, dtype=np.float32)
        norms = np.empty(n, dtype=np.float32)
        for a in range(0, n, _QUANT_CHUNK):
            b = min(n, a + _QUANT_CHUNK)
            q[a:b], scale[a:b] = _quantize_rows(host[a:b])
            norms[a:b] = np.linalg.norm(host[a:b], axis=1)
        buckets = None
        if lsh and lsh.num_hashes:
            buckets = torch.as_tensor(lsh.assign_buckets(host), device=device)
        return cls(list(ids), version, torch.as_tensor(q, device=device),
                   torch.as_tensor(scale, device=device),
                   torch.as_tensor(norms, device=device), buckets, prev=prev,
                   slab=slab, slab_rows=slab_rows)

    @classmethod
    def from_delta(cls, prev: "_QuantSnapshot", delta,
                   lsh: "LocalitySensitiveHash | None"):
        """Incremental step: requantize only the changed and appended rows
        and land them in new tensors (row scatters out of place, one
        append)."""
        qmat, qscale, norms, buckets = (
            prev.qmat, prev.qscale, prev.norms, prev.buckets)
        dev = qmat.device
        changed_pos = [prev.id_to_idx[i] for i in delta.changed_ids
                       if i in prev.id_to_idx]
        if changed_pos:
            pos = torch.as_tensor(changed_pos, dtype=torch.int64, device=dev)
            qc, sc = _quantize_rows(delta.changed_vals)
            qmat = qmat.index_copy(0, pos, torch.as_tensor(qc, device=dev))
            qscale = qscale.index_copy(0, pos, torch.as_tensor(sc, device=dev))
            norms = norms.index_copy(0, pos, torch.as_tensor(
                np.linalg.norm(delta.changed_vals, axis=1), device=dev))
            if buckets is not None:
                buckets = buckets.index_copy(0, pos, torch.as_tensor(
                    lsh.assign_buckets(delta.changed_vals), device=dev))
        if delta.appended_ids:
            qa, sa = _quantize_rows(delta.appended_vals)
            qmat = torch.cat([qmat, torch.as_tensor(qa, device=dev)])
            qscale = torch.cat([qscale, torch.as_tensor(sa, device=dev)])
            norms = torch.cat([norms, torch.as_tensor(
                np.linalg.norm(delta.appended_vals, axis=1), device=dev)])
            if buckets is not None:
                buckets = torch.cat([buckets, torch.as_tensor(
                    lsh.assign_buckets(delta.appended_vals), device=dev)])
        ids = prev.ids + delta.appended_ids
        # extend the pinned view: delta.slab is the CURRENT slab (a growth
        # copies rows in place, so prev's indices stay valid in it)
        slab_rows = (
            np.concatenate([prev.slab_rows,
                            np.asarray(delta.appended_rows, dtype=np.int64)])
            if len(delta.appended_ids) else prev.slab_rows
        )
        return cls(ids, delta.version, qmat, qscale, norms, buckets,
                   prev=prev, appended=delta.appended_ids,
                   slab=delta.slab, slab_rows=slab_rows)


class ALSServingModel(ServingModel):
    def __init__(self, features: int, implicit: bool, sample_rate: float = 1.0,
                 device_dtype: str = "auto", rescore_factor: float = 4.0,
                 index_enabled: bool = False, index_cells: int = 0,
                 index_probes: int = 8, index_skew: float = 4.0, device=None,
                 mesh: "Mesh | None" = None, shard_axis: str = "model"):
        if device_dtype not in _DEVICE_DTYPES:
            raise ValueError(
                f"oryx.serving.device-dtype must be one of {_DEVICE_DTYPES}, "
                f"not {device_dtype!r}")
        if device_dtype == "int8" and mesh is not None:
            # the sharded scan scores float32 / bfloat16 rows; degrade
            # loudly, never silently
            log.warning(
                "device-dtype=int8 is not supported with sharded serving; "
                "using bfloat16 for the sharded scoring copy")
            device_dtype = "bfloat16"
        if index_enabled and device_dtype != "int8":
            # the IVF cells ARE the int8 representation, and the rescore
            # rides the int8 mode's pinned slab view
            log.warning(
                "oryx.serving.index.enabled requires device-dtype=int8 "
                "(resolved %r); serving without the IVF index", device_dtype)
            index_enabled = False
        self.features = features
        self.implicit = implicit
        self.sample_rate = sample_rate
        self.device_dtype = device_dtype
        self.rescore_factor = max(1.0, float(rescore_factor))
        self.index_enabled = bool(index_enabled)
        self.index_cells = int(index_cells)
        self.index_probes = max(1, int(index_probes))
        self.index_skew = max(1.0, float(index_skew))
        self.device = resolve(device)
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.x = FeatureVectorStore()
        self.y = FeatureVectorStore()
        self.lsh = (LocalitySensitiveHash(sample_rate, features)
                    if sample_rate < 1.0 else None)
        self.known_items: dict[str, set[str]] = {}
        self._known_lock = threading.Lock()
        self.expected_user_ids: set[str] = set()
        self.expected_item_ids: set[str] = set()
        self.yty_cache = SolverCache(self.y.get_vtv)
        self._snapshot = None
        self._snap_lock = threading.Lock()

    # -- vector + known-item bookkeeping ------------------------------------
    def set_user_vector(self, user: str, vec) -> None:
        self.x.set_vector(user, vec)
        self.expected_user_ids.discard(user)

    def set_item_vector(self, item: str, vec) -> None:
        self.y.set_vector(item, vec)
        self.expected_item_ids.discard(item)
        self.yty_cache.set_dirty()

    def bulk_load_users(self, ids, matrix) -> None:
        """Whole-matrix X handoff."""
        self.x.bulk_load(ids, matrix)
        self.expected_user_ids.difference_update(ids)

    def bulk_load_items(self, ids, matrix) -> None:
        """Whole-matrix Y handoff."""
        self.y.bulk_load(ids, matrix)
        self.expected_item_ids.difference_update(ids)
        self.yty_cache.set_dirty()

    def get_user_vector(self, user: str):
        return self.x.get_vector(user)

    def get_item_vector(self, item: str):
        return self.y.get_vector(item)

    def add_known_items(self, user: str, items: Sequence[str]) -> None:
        with self._known_lock:
            self.known_items.setdefault(user, set()).update(items)

    def get_known_items(self, user: str) -> set[str]:
        with self._known_lock:
            return set(self.known_items.get(user, ()))

    def get_known_item_vectors_for_user(self, user: str) -> list[tuple[str, np.ndarray]]:
        """(ALSServingModel.getKnownItemVectorsForUser)"""
        out = []
        for item in self.get_known_items(user):
            v = self.y.get_vector(item)
            if v is not None:
                out.append((item, v))
        return out

    def item_counts(self) -> dict[str, int]:
        """How many users know each item (ALSServingModel.getItemCounts)."""
        counts: dict[str, int] = {}
        with self._known_lock:
            for items in self.known_items.values():
                for i in items:
                    counts[i] = counts.get(i, 0) + 1
        return counts

    def user_counts(self) -> dict[str, int]:
        """Known-item count per user (MostActiveUsers source)."""
        with self._known_lock:
            return {u: len(items) for u, items in self.known_items.items()}

    def all_user_ids(self) -> list:
        return self.x.ids()

    def all_item_ids(self) -> list:
        return self.y.ids()

    def retain_recent_and_user_ids(self, ids) -> None:
        self.x.retain_recent_and_ids(set(ids))

    def retain_recent_and_item_ids(self, ids) -> None:
        self.y.retain_recent_and_ids(set(ids))
        self.yty_cache.set_dirty()

    def retain_recent_and_known_items(self, users) -> None:
        keep = set(users)
        with self._known_lock:
            for u in list(self.known_items):
                if u not in keep:
                    del self.known_items[u]

    def get_fraction_loaded(self) -> float:  # ALSServingModel.java:396
        total = len(self.expected_user_ids) + len(self.expected_item_ids)
        total += self.x.size() + self.y.size()
        if total == 0:
            return 1.0
        return (self.x.size() + self.y.size()) / total

    # -- device snapshot ----------------------------------------------------
    def y_snapshot(self):
        """The current device view of Y: a :class:`_YSnapshot` (float32 /
        bfloat16), a :class:`_QuantSnapshot` (int8) or an
        :class:`~oryx_tpu_torch.models.als.ivf.IVFSnapshot` (int8 with the
        index). After point updates alone each is built from the previous
        one, across any number of store generations. One thread at a time:
        a snapshot is never replaced by an older one."""
        if self.device_dtype == "int8":
            if self.index_enabled:
                return self._ivf_snapshot()
            return self._quant_snapshot()
        with self._snap_lock:
            ids, mat = self.y.materialize(self.device)
            snap = self._snapshot
            if snap is None or snap.mat is not mat:
                delta = None
                if snap is not None and snap.mat is not None and mat is not None:
                    delta = self.y.delta_since(snap.mat, mat)
                self._snapshot = _YSnapshot(
                    ids, mat, prev=snap if delta is not None else None,
                    delta=delta, lsh=self.lsh, device_dtype=self.device_dtype,
                    mesh=self.mesh, shard_axis=self.shard_axis)
            return self._snapshot

    def _quant_snapshot(self) -> _QuantSnapshot:
        """Current int8 device view: incremental (requantize and land only
        the rows a speed microbatch touched) while the store's write log
        covers the gap, a full chunked build otherwise. The store's float32
        device cache is never engaged in this mode: its slab is the exact
        float32 source the rescore gathers from."""
        with self._snap_lock:
            prev = (self._snapshot if isinstance(self._snapshot, _QuantSnapshot)
                    else None)
            if prev is not None and prev.qmat is not None:
                delta = self.y.delta_info(prev.version, prev.n)
                if delta is not None:
                    if not delta.changed_ids and not delta.appended_ids:
                        return prev
                    self._snapshot = _QuantSnapshot.from_delta(prev, delta, self.lsh)
                    return self._snapshot
            ids, host, version, row_view = self.y.host_matrix()
            self._snapshot = _QuantSnapshot.build(
                ids, host, version, self.lsh, row_view, self.device, prev=prev)
            return self._snapshot

    def _ivf_snapshot(self) -> "ivf_mod.IVFSnapshot":
        """Current IVF device view: incremental (requantize and reassign only
        the touched rows, rewrite only the affected cells) while the write
        log covers the gap and the update neither overflows a cell nor
        drifts the balance past the skew bound; a full re-cluster
        otherwise."""
        with self._snap_lock:
            prev = (self._snapshot
                    if isinstance(self._snapshot, ivf_mod.IVFSnapshot) else None)
            if prev is not None and prev.cell_q is not None:
                delta = self.y.delta_info(prev.version, prev.n)
                if delta is not None:
                    if not delta.changed_ids and not delta.appended_ids:
                        return prev
                    nxt = ivf_mod.IVFSnapshot.from_delta(prev, delta, self.lsh)
                    if nxt is not None:
                        self._snapshot = nxt
                        return nxt
            ids, host, version, row_view = self.y.host_matrix()
            self._snapshot = ivf_mod.IVFSnapshot.build(
                ids, host, version, self.lsh, row_view, prev=prev,
                cells=self.index_cells, probes=self.index_probes,
                skew_bound=self.index_skew, device=self.device)
            return self._snapshot

    def device_factor_bytes(self) -> int:
        """Bytes the current Y snapshot holds on the device."""
        return self.y_snapshot().device_nbytes()

    # -- the exact rescore ---------------------------------------------------
    def _rescore_exact(self, snap, qs_host: np.ndarray, vals: np.ndarray,
                       idx: np.ndarray, cosine: bool = False
                       ) -> "tuple[np.ndarray, np.ndarray]":
        """Exact float32 rescore of a quantized scan's candidates: gather
        the candidate rows from the snapshot's pinned slab view, recompute
        exact scores on the host, and return the candidates ranked by them
        (a stable sort). Masked candidates (-inf from the scan) stay -inf.
        For ``cosine`` the batch dimension is the query-vector set of ONE
        request (mean cosine). Host numpy, as the reference's."""
        B, R = idx.shape
        rows = snap.gather_rows(idx.reshape(-1)).reshape(B, R, -1)
        if cosine:
            r = rows[0]
            rn = np.linalg.norm(r, axis=1)
            qn = np.linalg.norm(qs_host, axis=1)
            sims = (r @ qs_host.T) / np.maximum(rn[:, None] * qn[None, :], 1e-12)
            exact = np.mean(sims, axis=1, dtype=np.float32)[None, :]
        else:
            exact = np.einsum("bk,brk->br", qs_host, rows).astype(np.float32)
        exact = np.where(np.isfinite(vals), exact, -np.inf)
        order = np.argsort(-exact, axis=1, kind="stable")
        return (np.take_along_axis(exact, order, axis=1),
                np.take_along_axis(idx, order, axis=1))

    def _quant_scan(self, snap: _QuantSnapshot, qs_host: np.ndarray, r: int,
                    excl, lut=None):
        """One quantized candidate scan + exact rescore: (vals, idx) of
        width ``r``, ranked by exact float32 score."""
        qs = torch.as_tensor(qs_host, device=self.device)
        vals, idx = _quant_candidates(snap, qs, r, lut=lut, excl=excl)
        return self._rescore_exact(snap, qs_host, vals.cpu().numpy(),
                                   idx.cpu().numpy())

    # -- query primitives ----------------------------------------------------
    @staticmethod
    def _excluded_indices(snap, excluded, batch: int) -> np.ndarray:
        """(B, E) int64 of Y rows to mask out, -1-padded, E a pow2 floored at
        ``_EXCL_PAD_MIN``."""
        idx_lists: list[list[int]] = []
        max_e = 1
        for b in range(batch):
            ids = excluded[b] if excluded is not None else None
            ix = [j for i in ids if (j := snap.index_of(i)) is not None] if ids else []
            idx_lists.append(ix)
            max_e = max(max_e, len(ix))
        width = max(_EXCL_PAD_MIN, _round_up_pow2(max_e))
        out = np.full((batch, width), -1, dtype=np.int64)
        for b, ix in enumerate(idx_lists):
            out[b, : len(ix)] = ix
        return out

    def _excl_tensor(self, snap, excluded, batch: int):
        """The (B, E) exclusion tensor on the device, or None when no query
        excludes a row this snapshot holds."""
        if not excluded or not any(e for e in excluded):
            return None
        padded = self._excluded_indices(snap, excluded, batch)
        if not (padded >= 0).any():
            return None
        return torch.as_tensor(padded, device=self.device)

    def _build_lut(self, qs_host: np.ndarray) -> torch.Tensor:
        """(B, num_buckets) boolean LSH candidate table on the device, one
        row per query (``lsh.get_candidate_lut``)."""
        return torch.as_tensor(self.lsh.get_candidate_lut(qs_host),
                               device=self.device)

    def _candidate_mask(self, snap, query_vec: np.ndarray):
        """(n,) booleans: the rows whose LSH bucket is a candidate of
        ``query_vec``'s; None without LSH."""
        if self.lsh is None or snap.buckets is None:
            return None
        lut = np.zeros(self.lsh.num_buckets, dtype=bool)
        lut[self.lsh.get_candidate_indices(query_vec)] = True
        return torch.as_tensor(lut, device=self.device)[snap.buckets]

    def _sharded_query(self, snap: _YSnapshot, qs_host: np.ndarray,
                       want: int, excluded):
        """The multi-shard scan (the reference's ``_sharded_top_k_fn``):
        each shard scores its rows on its device and masks its pad rows,
        the queries' LSH candidates and their excluded rows (global
        indices rebased to the shard), then takes a local top-k; the (B,
        shards·k) candidates merge, in shard order, with one more top-k.
        Returns host (vals, idx) of width ``k_final``, idx global rows."""
        mats, buckets = snap.sharded_mat, snap.sharded_buckets
        n_local = mats.rows_per_shard
        want = min(want, snap.n)
        k = min(n_local, _round_up_pow2(max(want, 16)))
        k_final = min(mats.n_shards * k, _round_up_pow2(max(want, 16)))
        qs = torch.as_tensor(qs_host, device=self.device)
        lut = (self._build_lut(qs_host)
               if self.lsh is not None and snap.buckets is not None else None)
        excl = self._excl_tensor(snap, excluded, len(qs_host))
        devs = mats.devices
        lut_d = replicated(lut, devs) if lut is not None else [None] * len(devs)
        excl_d = replicated(excl, devs) if excl is not None else [None] * len(devs)
        vals, idx = [], []
        for s, (mat, bkt, q, lu, ex) in enumerate(zip(
                mats.shards, buckets.shards, replicated(qs, devs), lut_d,
                excl_d)):
            offset = s * n_local
            scores = _score(q, mat)
            scores[:, max(0, min(n_local, snap.n - offset)):] = -math.inf
            if lu is not None:
                scores.masked_fill_(~lu[:, bkt], -math.inf)
            if ex is not None:
                scores = _mask_excluded(scores, ex - offset)
            v, i = torch.topk(scores, k, dim=1)
            vals.append(v.to(self.device))
            idx.append(i.to(self.device) + offset)
        mvals, pos = torch.topk(torch.cat(vals, dim=1), k_final, dim=1)
        return (mvals.cpu().numpy(),
                torch.cat(idx, dim=1).gather(1, pos).cpu().numpy())

    def top_n(
        self,
        query_vec,
        how_many: int,
        offset: int = 0,
        allowed: "Callable[[str], bool] | None" = None,
        rescore: "Callable[[str, float], float] | None" = None,
        excluded: "Sequence[str] | None" = None,
    ) -> list[tuple[str, float]]:
        """Dot-product top-N over Y for one query. ``excluded`` ids are
        masked on the device; ``allowed``/``rescore`` host hooks filter the
        candidate stream, widening the top-k until enough survive."""
        snap = self.y_snapshot()
        if snap.n == 0:
            return []
        q_host = np.asarray(query_vec, dtype=np.float32)
        if isinstance(snap, ivf_mod.IVFSnapshot):
            return ivf_mod.top_n(self, snap, q_host, how_many, offset, allowed,
                                 rescore, excluded)
        if isinstance(snap, _QuantSnapshot):
            return self._quant_top_n(snap, q_host, how_many, offset, allowed,
                                     rescore, excluded)
        want = how_many + offset
        if snap.sharded_mat is not None:
            k = want if allowed is None and rescore is None else max(4 * want, 64)
            while True:
                vals, idx = self._sharded_query(
                    snap, q_host[None, :], k, [excluded] if excluded else None)
                out = self._collect(snap, vals[0], idx[0], want, allowed, rescore)
                if len(out) >= want or k >= snap.n:
                    return out[offset:offset + how_many]
                k = min(snap.n, k * 2)  # widen: host filter consumed candidates
        q = torch.as_tensor(q_host, device=self.device)
        valid = self._candidate_mask(snap, q_host)
        excl = self._excl_tensor(snap, [excluded], 1)
        # score once; widenings re-run only the top-k over the same scores
        scores = _masked_scores(snap.score_mat, q[None, :], valid, excl)
        k = min(snap.n, _round_up_pow2(max(4 * want, 64)))
        while True:
            vals, idx = torch.topk(scores, k, dim=1)
            out = self._collect(snap, vals[0].cpu().numpy(),
                                idx[0].cpu().numpy(), want, allowed, rescore)
            if len(out) >= want or k >= snap.n:
                return out[offset:offset + how_many]
            k = min(snap.n, k * 2)

    def _quant_top_n(self, snap: _QuantSnapshot, q_host: np.ndarray,
                     how_many: int, offset: int, allowed, rescore, excluded
                     ) -> list[tuple[str, float]]:
        """Single-query top-N on the int8 path: the quantized scores once
        (by row chunk), then top-r, exact rescore and host filtering,
        widening r over the same scores until enough survive."""
        want = how_many + offset
        excl = self._excl_tensor(snap, [excluded], 1)
        valid = self._candidate_mask(snap, q_host)
        qs = torch.as_tensor(q_host[None, :], device=self.device)
        scores = _quant_masked_scores(snap, qs, valid, excl)
        r = min(snap.n, _round_up_pow2(max(int(self.rescore_factor * want), 16)))
        while True:
            v, i = torch.topk(scores, r, dim=1)
            vals, idx = self._rescore_exact(snap, q_host[None, :],
                                            v.cpu().numpy(), i.cpu().numpy())
            out = self._collect(snap, vals[0], idx[0], want, allowed, rescore)
            if len(out) >= want or r >= snap.n:
                return out[offset:offset + how_many]
            r = min(snap.n, r * 2)

    def top_n_batch(
        self,
        query_vecs,
        how_many: int,
        alloweds: "Sequence[Callable[[str], bool] | None] | None" = None,
        excluded: "Sequence[Sequence[str] | None] | None" = None,
    ) -> list[list[tuple[str, float]]]:
        """Many queries in ONE scan + top-k on the device.
        ``excluded[b]`` ids are masked on the device; ``alloweds`` host
        callables filter after the scan (a query they starve falls back to
        the widening single-query path). One histogram observe + one
        counter add per CALL (not per query), as in the reference; the warm
        ladder's calls (:meth:`warm_bucket`) are calls too, where the
        reference's warmup compiles instead."""
        _TOPN_QUERIES.inc(len(query_vecs))
        t0 = time.perf_counter()
        try:
            return self._top_n_batch(query_vecs, how_many, alloweds, excluded)
        finally:
            # exemplar: the coalescer activates its device-call span around
            # this call, so a slow bucket points at that concrete trace
            _TOPN_BATCH_SECONDS.observe(
                time.perf_counter() - t0, exemplar=spans.current_trace_id())

    def _top_n_batch(self, query_vecs, how_many: int, alloweds=None,
                     excluded=None) -> list[list[tuple[str, float]]]:
        n_q = len(query_vecs)
        snap = self.y_snapshot()
        if snap.n == 0:
            return [[] for _ in range(n_q)]
        qs_host = np.asarray(query_vecs, dtype=np.float32)
        filtering = alloweds is not None and any(a is not None for a in alloweds)
        if isinstance(snap, ivf_mod.IVFSnapshot):
            return ivf_mod.top_n_batch(self, snap, qs_host, how_many, alloweds,
                                       excluded, filtering)
        if isinstance(snap, _QuantSnapshot):
            return self._quant_top_n_batch(snap, qs_host, how_many, alloweds,
                                           excluded, filtering)
        if snap.sharded_mat is not None and not filtering:
            # the sharded scan: its calls are counted, but no per-call cost
            # is registered for it, as in the reference
            profiling.costs().record(f"als.top_n_batch/b{n_q}+sharded")
            vals, idx = self._sharded_query(snap, qs_host, how_many, excluded)
            return self._batch_results(snap, qs_host, vals, idx, 0, how_many,
                                       alloweds, excluded, False, self.top_n)
        excl = self._excl_tensor(snap, excluded, n_q)
        qs = torch.as_tensor(qs_host, device=self.device)
        cost_key = _topn_cost_key(n_q, excl is not None)
        nbytes = float(snap.score_mat.element_size()) * snap.n * self.features
        if self.lsh is None or snap.buckets is None:
            k = min(snap.n, _round_up_pow2(
                max(2 * how_many, 64) if filtering else max(how_many, 16)))
            scores = _masked_scores(snap.score_mat, qs, None, excl)
        else:
            # per-query LSH candidates: the (B, buckets) table indexed by
            # each row's bucket on the device
            k = min(snap.n, _round_up_pow2(max(2 * how_many, 64)))
            valid = self._build_lut(qs_host)[:, snap.buckets]
            scores = _masked_scores(snap.score_mat, qs, valid, excl)
            nbytes += _lsh_bytes(self.lsh, snap.n, n_q)
        register_cost(snap, cost_key, 2.0 * n_q * snap.n * self.features,
                      nbytes)
        vals, idx = torch.topk(scores, k, dim=1)
        profiling.costs().record(cost_key)
        vals_np, idx_np = to_host(vals, idx)  # one synchronisation for both
        return self._batch_results(snap, qs_host, vals_np, idx_np, k, how_many,
                                   alloweds, excluded, filtering, self.top_n)

    def _batch_results(self, snap, qs_host, vals, idx, k, how_many, alloweds,
                       excluded, filtering, single) -> list:
        """The batch's answers from its top-k: cut to ``how_many``, or, when
        host filters apply, collected per query; a query they starve falls
        back to ``single`` (the widening single-query path)."""
        if not filtering:
            ids = snap.ids
            vb, ib = vals[:, :how_many], idx[:, :how_many]
            return [
                [(ids[int(i)], float(v)) for v, i in zip(vb[b], ib[b]) if np.isfinite(v)]
                for b in range(len(qs_host))
            ]
        out = []
        for b in range(len(qs_host)):
            allowed = alloweds[b] if alloweds else None
            got = self._collect(snap, vals[b], idx[b], how_many, allowed, None)[:how_many]
            if len(got) < how_many and k < snap.n:
                got = single(qs_host[b], how_many, 0, allowed, None,
                             excluded=excluded[b] if excluded else None)
            out.append(got)
        return out

    def _quant_top_n_batch(self, snap: _QuantSnapshot, qs_host: np.ndarray,
                           how_many: int, alloweds, excluded, filtering: bool
                           ) -> list[list[tuple[str, float]]]:
        """Batched top-N on the int8 path: ONE quantized scan of the whole
        batch returning ``rescore-factor × how_many`` candidates each,
        rescored exactly from the slab before the final cut."""
        n_q = len(qs_host)
        excl = self._excl_tensor(snap, excluded, n_q)
        r = min(snap.n,
                _round_up_pow2(max(int(self.rescore_factor * how_many), 16)))
        lut = (self._build_lut(qs_host)
               if self.lsh is not None and snap.buckets is not None else None)
        cost_key = _topn_cost_key(n_q, excl is not None, quant=True)
        nbytes = float(snap.n) * self.features + 4.0 * snap.n
        if lut is not None:
            nbytes += _lsh_bytes(self.lsh, snap.n, n_q)
        register_cost(snap, cost_key, 2.0 * n_q * snap.n * self.features,
                      nbytes)
        vals, idx = self._quant_scan(snap, qs_host, r, excl, lut=lut)
        profiling.costs().record(cost_key)

        def single(q, how_many_, offset, allowed, rescore, excluded=None):
            return self._quant_top_n(snap, q, how_many_, offset, allowed,
                                     rescore, excluded)

        return self._batch_results(snap, qs_host, vals, idx, r, how_many,
                                   alloweds, excluded, filtering, single)

    def warm_bucket(self, batch_size: int, how_many: int = 10) -> None:
        """One bucket of the serving layer's warmup ladder
        (``serving/app.py`` ``_BatchWarmer``): a zero batch of
        ``batch_size`` queries through ``top_n_batch`` on whichever
        representation serves (float32 / bfloat16, int8, the IVF index),
        once without exclusions and once with (the default ``/recommend``
        path always sends known-item exclusions; an id no snapshot holds
        pads to an all-(-1) mask of the floored width). Torch compiles
        nothing per shape: on the card this takes the caching allocator's
        first allocations and cuBLAS's kernel choice for this shape off the
        request path. Raises when the model has no items yet (the warmer
        retries later)."""
        if self.y_snapshot().n == 0:
            raise ValueError("no item factors to warm against yet")
        zeros = np.zeros((batch_size, self.features), dtype=np.float32)
        self.top_n_batch(zeros, how_many)
        self.top_n_batch(
            zeros, how_many,
            excluded=[("__warm__",)] + [None] * (batch_size - 1),
        )

    def top_n_cosine(
        self,
        query_vecs,
        how_many: int,
        offset: int = 0,
        allowed: "Callable[[str], bool] | None" = None,
        rescore: "Callable[[str, float], float] | None" = None,
    ) -> list[tuple[str, float]]:
        """Mean-cosine top-N for /similarity (CosineAverageFunction.java:67):
        each item's mean cosine to the query vectors, on the device; with
        LSH over the union of every query vector's candidate buckets."""
        snap = self.y_snapshot()
        if snap.n == 0:
            return []
        qs_host = np.atleast_2d(np.asarray(query_vecs, dtype=np.float32))
        if isinstance(snap, ivf_mod.IVFSnapshot):
            return ivf_mod.top_n_cosine(
                self, snap, qs_host, np.linalg.norm(qs_host, axis=1),
                how_many, offset, allowed, rescore)
        qs = torch.as_tensor(qs_host, device=self.device)
        q_norms = torch.linalg.vector_norm(qs, dim=1)
        valid = None
        for qv in qs_host:
            mask = self._candidate_mask(snap, qv)
            if mask is not None:
                valid = mask if valid is None else valid | mask
        want = how_many + offset
        if isinstance(snap, _QuantSnapshot):
            # quantized candidates (exact norms), exact mean-cosine rescore
            # from the slab before the final cut
            scores = _quant_cosine_scores(snap, qs, q_norms, valid)
            r = min(snap.n,
                    _round_up_pow2(max(int(self.rescore_factor * want), 16)))
            while True:
                v, i = torch.topk(scores, r)
                vals, idx = self._rescore_exact(
                    snap, qs_host, v.cpu().numpy()[None, :],
                    i.cpu().numpy()[None, :], cosine=True)
                out = self._collect(snap, vals[0], idx[0], want, allowed, rescore)
                if len(out) >= want or r >= snap.n:
                    return out[offset:offset + how_many]
                r = min(snap.n, r * 2)
        sims = (snap.mat @ qs.T) / torch.clamp(
            snap.norms[:, None] * q_norms[None, :], min=1e-12)
        scores = sims.mean(dim=1)
        if valid is not None:
            scores = torch.where(valid, scores, -math.inf)
        k = min(snap.n, _round_up_pow2(max(4 * want, 64)))
        while True:
            vals, idx = torch.topk(scores, k)
            out = self._collect(snap, vals.cpu().numpy(), idx.cpu().numpy(),
                                want, allowed, rescore)
            if len(out) >= want or k >= snap.n:
                return out[offset:offset + how_many]
            k = min(snap.n, k * 2)

    def dot_with_items(self, query_vec, item_ids: Sequence[str]) -> list[float]:
        q = np.asarray(query_vec, dtype=np.float32)
        return [
            float(np.dot(q, v)) if (v := self.y.get_vector(i)) is not None else 0.0
            for i in item_ids
        ]

    def get_yty_solver(self):
        return self.yty_cache.get(blocking=True)

    def precompute_solvers(self) -> None:
        self.yty_cache.compute_now()

    def build_temporary_user_vector(
        self, item_values: Sequence[tuple[str, float]], xu=None
    ) -> "np.ndarray | None":
        """Fold a context of (item, value) pairs into a temporary user vector
        (EstimateForAnonymous.buildTemporaryUserVector)."""
        solver = self.get_yty_solver()
        if solver is None:
            return None
        vec = None if xu is None else np.asarray(xu, dtype=np.float32)
        for item, value in item_values:
            yi = self.y.get_vector(item)
            new_vec = foldin.compute_updated_xu(solver, value, vec, yi, self.implicit)
            if new_vec is not None:
                vec = new_vec
        return vec

    @staticmethod
    def _collect(snap, vals, idx, want, allowed, rescore) -> list[tuple[str, float]]:
        out: list[tuple[str, float]] = []
        for v, i in zip(vals, idx):
            if not np.isfinite(v):
                break
            id_ = snap.ids[int(i)]
            if allowed is not None and not allowed(id_):
                continue
            score = float(v)
            if rescore is not None:
                score = rescore(id_, score)
                if math.isnan(score):
                    continue
            out.append((id_, score))
        if rescore is not None:
            out.sort(key=lambda t: -t[1])
        return out


class ALSServingModelManager(AbstractServingModelManager):
    """The update-topic consumer behind ALS serving; its model lives on
    ``device`` (``None``: the CUDA card)."""

    def __init__(self, config, device=None):
        super().__init__(config)
        self.sample_rate = config.get_float("oryx.als.sample-rate")
        self.min_model_load_fraction = config.get_float(
            "oryx.serving.min-model-load-fraction")
        # the item representation on the device: "auto" (float32 off a
        # TPU), "float32", "bfloat16", or "int8" (per-row-scaled slab +
        # exact float32 rescore of the top rescore-factor x n candidates)
        self.device_dtype = config.get_string("oryx.serving.device-dtype", "auto")
        if self.device_dtype not in _DEVICE_DTYPES:
            raise ValueError(
                f"oryx.serving.device-dtype must be one of {_DEVICE_DTYPES}, "
                f"not {self.device_dtype!r}")
        self.rescore_factor = config.get_float("oryx.serving.rescore-factor", 4.0)
        # the IVF index: engages only with device-dtype=int8
        self.index_enabled = config.get_bool("oryx.serving.index.enabled", False)
        self.index_cells = config.get_int("oryx.serving.index.cells", 0)
        self.index_probes = config.get_int("oryx.serving.index.probes", 8)
        self.index_skew = config.get_float("oryx.serving.index.rebalance-skew", 4.0)
        self.rescorer_provider = load_rescorer_providers(config)
        self.device = resolve(device)
        self.mesh: "Mesh | None" = None
        if config.get_bool("oryx.serving.compute.sharded", False):
            devices = local_devices(self.device.type)
            if len(devices) > 1:
                self.mesh = make_mesh(axes=("model",), devices=devices)
                log.info("serving Y sharded over %d devices", self.mesh.size)
            else:
                log.info("sharded serving requested but only one device")
        # the YᵀY pre-trigger's rate limit (ALSServingModelManager.java:95-105)
        self._solver_trigger_rate = RateLimitCheck(5)
        self.model: "ALSServingModel | None" = None
        # double-buffered generation handoff: with the batch warmer running,
        # a MODEL push with new shapes builds the incoming generation here
        # while the warm old generation keeps answering; the warmer warms
        # the staged model off the request path and then promotes it
        self._staged: "ALSServingModel | None" = None
        self._staged_at = 0.0
        self._swap_lock = threading.Lock()
        self._prewarm_swap = (
            config.get_bool("oryx.serving.compute.precompile-batches", False)
            and config.get_bool("oryx.compile.prewarm-swap", True)
        )
        self._swap_deadline = config.get_float(
            "oryx.compile.swap-deadline-sec", 120.0)
        _LOAD_FRACTION.set_function(_load_fraction_fn(weakref.ref(self)))

    def get_model(self) -> "ALSServingModel | None":
        # deadline valve on the request path: one None-check when no swap
        # is staged; a staged generation whose warmer died (or whose warm
        # keeps failing) must still land eventually. Lock-free reads: single
        # reference loads are atomic under the GIL, and the flip happens
        # under _swap_lock and re-checks there
        staged = self._staged  # analyze: ignore[lock-discipline] -- atomic reference load on the hot path; flip is under _swap_lock
        if staged is not None and self._swap_deadline > 0 and (
            time.monotonic() - self._staged_at > self._swap_deadline  # analyze: ignore[lock-discipline] -- _staged_at is written before _staged publishes
        ):
            if self._promote_staged(expected=staged, deadline=True):
                log.warning(
                    "promoting staged model generation unwarmed: swap "
                    "deadline (%gs) passed", self._swap_deadline)
        return self.model  # analyze: ignore[lock-discipline] -- atomic reference load on the hot path; flip is under _swap_lock

    def get_staged_model(self) -> "ALSServingModel | None":
        with self._swap_lock:
            return self._staged

    def promote_staged(self, expected=None) -> bool:
        """Atomically flip the warmed staged generation into service
        (called by the batch warmer after its ladder completes).
        ``expected`` guards against promoting a model the caller did not
        warm: if a later MODEL push replaced the staged generation while the
        ladder ran, the flip is refused and the warmer runs again."""
        return self._promote_staged(expected=expected, deadline=False)

    def _promote_staged(self, expected, deadline: bool) -> bool:
        with self._swap_lock:
            staged = self._staged
            if staged is None or (expected is not None and staged is not expected):
                return False
            self.model = staged
            self._staged = None
        (_DEADLINE_SWAPS if deadline else _PREWARMED_SWAPS).inc()
        # adoption timeline: the staged generation just went into service
        # (idempotent: the warmer and the deadline valve can both report it)
        lineage.tracker().mark_live()
        return True

    def _current_generation(self) -> "ALSServingModel | None":
        """The generation the update topic is describing NOW: the staged
        model once a MODEL handoff is in flight, else the serving one."""
        with self._swap_lock:
            return self._staged or self.model

    def consume_key_message(self, key: str, message: str) -> None:
        if key == "UP":
            model = self._current_generation()
            if model is None:
                return
            update = json.loads(message)
            kind, id_, vec = update[0], update[1], np.asarray(update[2], dtype=np.float32)
            if kind == "X":
                model.set_user_vector(id_, vec)
                if len(update) > 3:
                    model.add_known_items(id_, update[3])
            elif kind == "Y":
                model.set_item_vector(id_, vec)
            else:
                raise ValueError(f"bad update type: {kind}")
            self._maybe_trigger_solvers()
        elif key in ("MODEL", "MODEL-REF"):
            pmml = read_pmml_from_update_key_message(key, message)
            meta = pmml_codec.pmml_to_meta(pmml)
            features = meta["features"]
            current = self._current_generation()
            if current is None or current.features != features:
                new_model = ALSServingModel(
                    features, meta["implicit"], self.sample_rate,
                    device_dtype=self.device_dtype,
                    rescore_factor=self.rescore_factor,
                    index_enabled=self.index_enabled,
                    index_cells=self.index_cells,
                    index_probes=self.index_probes,
                    index_skew=self.index_skew, device=self.device,
                    mesh=self.mesh,
                )
                # the handoff meta names every expected row: presize the
                # stores so the fill skips doubling-growth copies
                new_model.x.reserve(len(meta["x_ids"]))
                new_model.y.reserve(len(meta["y_ids"]))
                new_model.expected_user_ids = set(meta["x_ids"])
                new_model.expected_item_ids = set(meta["y_ids"])
                with self._swap_lock:
                    staging = self.model is not None and self._prewarm_swap
                    if staging:
                        # keep serving the old generation; the warmer fills
                        # and warms this one off-path, then promotes it. The
                        # timestamp goes BEFORE the reference: the deadline
                        # valve reads both lock-free
                        self._staged_at = time.monotonic()
                        self._staged = new_model
                    else:
                        self.model = new_model
                        self._staged = None
                log.info("%s serving model generation (features=%d)",
                         "staging" if staging else "new", features)
            else:
                m = current
                m.retain_recent_and_user_ids(meta["x_ids"])
                m.retain_recent_and_item_ids(meta["y_ids"])
                m.retain_recent_and_known_items(meta["x_ids"])
                m.expected_user_ids = set(meta["x_ids"]) - set(m.x.ids())
                m.expected_item_ids = set(meta["y_ids"]) - set(m.y.ids())
            self._maybe_trigger_solvers()  # MODEL alone may cross the threshold
        else:
            raise ValueError(f"bad key: {key}")

    def _maybe_trigger_solvers(self) -> None:
        """Start the YᵀY factorisation in the background once the model
        passes the load fraction, so the first fold-in request does not
        wait for it (ALSServingModelManager.java:95-105). Rate-limited: the
        fraction test walks the expected-id sets, too costly per ``UP``;
        the launch is a no-op while the cache is clean. During a staged
        swap the UPs fill the staged model: its solver is the one to warm,
        or the first fold-in after the flip would wait for it."""
        model = self._current_generation()
        if model is None or not self._solver_trigger_rate.test():
            return
        if model.get_fraction_loaded() >= self.min_model_load_fraction:
            model.precompute_solvers()
