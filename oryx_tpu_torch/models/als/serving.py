"""ALS serving model: device-resident item factors answering top-N queries.

The port of the reference's ``ALSServingModel`` and
``ALSServingModelManager`` (``models/als/serving.py``) for float32 scoring on
one device: Y lives on the device as one dense float32 matrix, rebuilt from
the host store when the store changed, and a batch of queries is answered by
ONE ``scores = Q @ Yᵀ`` product, known-item masking, and ``torch.topk``. The
reference leaves this scan to XLA outside any Pallas kernel (matmul +
``approx_max_k``), so it is plain torch here too; the float32 product runs
without TF32. ``device_dtype="auto"`` resolves to float32, the reference's
own rule off a TPU.

The manager consumes the update topic as the reference's does: ``MODEL`` /
``MODEL-REF`` with new features builds a new model with its stores
presized and the expected ids set; with the same features it retains what
the new model names or what was written since the last handoff;
``UP ["X"|"Y", id, vector(, known items)]`` sets one vector.

Not ported yet: LSH sampling (``sample_rate < 1``), bfloat16 and int8
scoring copies, the IVF index, sharded serving, the staged double-buffer
swap (``precompile-batches`` with ``prewarm-swap``), the YᵀY solver
pre-trigger (it needs ``ops/solver.py``), the rescorer, and cost/metrics
accounting. The manager raises at construction on a setting that would
need one of them.
"""

from __future__ import annotations

import json
import logging
import math
import threading
from typing import Callable, Sequence

import numpy as np
import torch

from oryx_tpu_torch.api.serving import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.ml.mlupdate import read_pmml_from_update_key_message
from oryx_tpu_torch.models.als import pmml_codec
from oryx_tpu_torch.models.als.vectors import FeatureVectorStore

log = logging.getLogger(__name__)


def _round_up_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


#: Floor of the pow2-bucketed exclusion-mask width (the reference's value:
#: its compiled programs are keyed by this width, so the port keeps the
#: same (B, E) shapes).
_EXCL_PAD_MIN = 8


def _score(qs: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """(B, n) float32 scores."""
    return qs @ mat.T


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


def _masked_scores(mat, qs, excl):
    scores = _score(qs, mat)
    if excl is not None:
        scores = _mask_excluded(scores, excl)
    return scores


class _YSnapshot:
    """Immutable device view of Y: ids, their row index, and the matrix."""

    def __init__(self, ids: list, mat: torch.Tensor, version: int):
        self.ids = ids
        self.mat = mat  # (n, k) float32 on the serving device
        self.version = version
        self.id_to_idx = {s: i for i, s in enumerate(ids)}

    @property
    def n(self) -> int:
        return len(self.ids)


def _check_supported(sample_rate: float, device_dtype: str) -> None:
    """Raise on the serving settings the port does not have yet."""
    if sample_rate < 1.0:
        raise NotImplementedError(
            "LSH sampling (sample_rate < 1) is not ported yet")
    if device_dtype not in ("auto", "float32"):
        raise NotImplementedError(
            f"the port serves device_dtype 'auto' or 'float32' (both score "
            f"in float32), not {device_dtype!r}")


class ALSServingModel(ServingModel):
    def __init__(self, features: int, implicit: bool, sample_rate: float = 1.0,
                 device_dtype: str = "auto", device=None):
        _check_supported(sample_rate, device_dtype)
        self.features = features
        self.implicit = implicit
        self.device = resolve(device)
        self.x = FeatureVectorStore()
        self.y = FeatureVectorStore()
        self.known_items: dict[str, set[str]] = {}
        self._known_lock = threading.Lock()
        self.expected_user_ids: set[str] = set()
        self.expected_item_ids: set[str] = set()
        self._snapshot: "_YSnapshot | None" = None
        self._snap_lock = threading.Lock()

    # -- vector + known-item bookkeeping ------------------------------------
    def set_user_vector(self, user: str, vec) -> None:
        self.x.set_vector(user, vec)
        self.expected_user_ids.discard(user)

    def set_item_vector(self, item: str, vec) -> None:
        self.y.set_vector(item, vec)
        self.expected_item_ids.discard(item)

    def bulk_load_users(self, ids, matrix) -> None:
        """Whole-matrix X handoff."""
        self.x.bulk_load(ids, matrix)
        self.expected_user_ids.difference_update(ids)

    def bulk_load_items(self, ids, matrix) -> None:
        """Whole-matrix Y handoff."""
        self.y.bulk_load(ids, matrix)
        self.expected_item_ids.difference_update(ids)

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

    def all_user_ids(self) -> list:
        return self.x.ids()

    def all_item_ids(self) -> list:
        return self.y.ids()

    def retain_recent_and_user_ids(self, ids) -> None:
        self.x.retain_recent_and_ids(set(ids))

    def retain_recent_and_item_ids(self, ids) -> None:
        self.y.retain_recent_and_ids(set(ids))

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
    def y_snapshot(self) -> _YSnapshot:
        """The current device view of Y, uploaded anew when the store has
        changed since the last one."""
        with self._snap_lock:
            version = self.y.version()
            if self._snapshot is None or self._snapshot.version != version:
                ids, host, version = self.y.host_matrix()
                mat = torch.as_tensor(host, device=self.device)
                self._snapshot = _YSnapshot(ids, mat, version)
            return self._snapshot

    # -- query primitives ----------------------------------------------------
    @staticmethod
    def _excluded_indices(snap: _YSnapshot, excluded, batch: int) -> np.ndarray:
        """(B, E) int64 of Y rows to mask out, -1-padded, E a pow2 floored at
        ``_EXCL_PAD_MIN``."""
        idx_lists: list[list[int]] = []
        max_e = 1
        for b in range(batch):
            ids = excluded[b] if excluded is not None else None
            ix = (
                [snap.id_to_idx[i] for i in ids if i in snap.id_to_idx]
                if ids
                else []
            )
            idx_lists.append(ix)
            max_e = max(max_e, len(ix))
        width = max(_EXCL_PAD_MIN, _round_up_pow2(max_e))
        out = np.full((batch, width), -1, dtype=np.int64)
        for b, ix in enumerate(idx_lists):
            out[b, : len(ix)] = ix
        return out

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
        want = how_many + offset
        q = torch.as_tensor(np.asarray(query_vec, dtype=np.float32),
                            device=self.device)
        excl = None
        if excluded:
            padded = self._excluded_indices(snap, [excluded], 1)
            if (padded >= 0).any():
                excl = torch.as_tensor(padded, device=self.device)
        # score once; widenings re-run only the top-k over the same scores
        scores = _masked_scores(snap.mat, q[None, :], excl)
        k = min(snap.n, _round_up_pow2(max(4 * want, 64)))
        while True:
            vals, idx = torch.topk(scores, k, dim=1)
            out = self._collect(snap, vals[0].cpu().numpy(),
                                idx[0].cpu().numpy(), want, allowed, rescore)
            if len(out) >= want or k >= snap.n:
                return out[offset:offset + how_many]
            k = min(snap.n, k * 2)

    def top_n_batch(
        self,
        query_vecs,
        how_many: int,
        alloweds: "Sequence[Callable[[str], bool] | None] | None" = None,
        excluded: "Sequence[Sequence[str] | None] | None" = None,
    ) -> list[list[tuple[str, float]]]:
        """Many queries in ONE product + top-k on the device.
        ``excluded[b]`` ids are masked on the device; ``alloweds`` host
        callables filter after the scan (a query they starve falls back to
        the widening single-query path)."""
        n_q = len(query_vecs)
        snap = self.y_snapshot()
        if snap.n == 0:
            return [[] for _ in range(n_q)]
        qs_host = np.asarray(query_vecs, dtype=np.float32)
        filtering = alloweds is not None and any(a is not None for a in alloweds)
        use_excl = excluded is not None and any(e for e in excluded)
        excl = (
            torch.as_tensor(self._excluded_indices(snap, excluded, n_q),
                            device=self.device)
            if use_excl else None
        )
        k = min(
            snap.n,
            _round_up_pow2(max(2 * how_many, 64) if filtering else max(how_many, 16)),
        )
        scores = _masked_scores(snap.mat, torch.as_tensor(qs_host, device=self.device),
                                excl)
        vals, idx = torch.topk(scores, k, dim=1)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        if not filtering:
            ids = snap.ids
            vb, ib = vals[:, :how_many], idx[:, :how_many]
            return [
                [(ids[int(i)], float(v)) for v, i in zip(vb[b], ib[b]) if np.isfinite(v)]
                for b in range(n_q)
            ]
        out = []
        for b in range(n_q):
            allowed = alloweds[b] if alloweds else None
            got = self._collect(snap, vals[b], idx[b], how_many, allowed, None)[:how_many]
            if len(got) < how_many and k < snap.n:
                got = self.top_n(
                    qs_host[b], how_many, 0, allowed, None,
                    excluded=excluded[b] if excluded else None,
                )
            out.append(got)
        return out

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
        self.device_dtype = config.get_string("oryx.serving.device-dtype", "auto")
        _check_supported(self.sample_rate, self.device_dtype)
        for key, what in (
                ("oryx.serving.compute.sharded", "sharded serving"),
                ("oryx.serving.index.enabled", "the IVF index")):
            if config.get_bool(key, False):
                raise NotImplementedError(f"{key}: {what} is not ported yet")
        if (config.get_bool("oryx.serving.compute.precompile-batches", False)
                and config.get_bool("oryx.compile.prewarm-swap", True)):
            raise NotImplementedError(
                "oryx.serving.compute.precompile-batches with "
                "oryx.compile.prewarm-swap: the staged model swap is not "
                "ported yet")
        self.device = resolve(device)
        self.model: "ALSServingModel | None" = None

    def get_model(self) -> "ALSServingModel | None":
        return self.model

    def consume_key_message(self, key: str, message: str) -> None:
        if key == "UP":
            model = self.model
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
        elif key in ("MODEL", "MODEL-REF"):
            pmml = read_pmml_from_update_key_message(key, message)
            meta = pmml_codec.pmml_to_meta(pmml)
            features = meta["features"]
            current = self.model
            if current is None or current.features != features:
                new_model = ALSServingModel(
                    features, meta["implicit"], self.sample_rate,
                    device_dtype=self.device_dtype, device=self.device,
                )
                # the handoff meta names every expected row: presize the
                # stores so the fill skips doubling-growth copies
                new_model.x.reserve(len(meta["x_ids"]))
                new_model.y.reserve(len(meta["y_ids"]))
                new_model.expected_user_ids = set(meta["x_ids"])
                new_model.expected_item_ids = set(meta["y_ids"])
                self.model = new_model
                log.info("new serving model generation (features=%d)", features)
            else:
                m = current
                m.retain_recent_and_user_ids(meta["x_ids"])
                m.retain_recent_and_item_ids(meta["y_ids"])
                m.retain_recent_and_known_items(meta["x_ids"])
                m.expected_user_ids = set(meta["x_ids"]) - set(m.x.ids())
                m.expected_item_ids = set(meta["y_ids"]) - set(m.y.ids())
        else:
            raise ValueError(f"bad key: {key}")
