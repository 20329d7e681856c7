"""ALS speed tier: in-memory model + per-microbatch fold-in updates.

A copy of the JAX package's ``oryx_tpu/models/als/speed.py`` (host code, no
JAX), held equal to it by ``tests/test_torch_als_speed.py``: the ``UP``
strings it emits are the reference's, byte for byte. It takes no device:
its numbers are a k×k float64 SVD and (B, k)·(k, k) products, which the
reference keeps on the host for the exact rank test. The one addition is
``ALSSpeedModelManager.report``, the host seconds of the last
``build_updates`` by stage.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's ALSSpeedModel / ALSSpeedModelManager
(app/oryx-app/.../als/ALSSpeedModel.java:39-183,
ALSSpeedModelManager.java:51-233):

  * the model holds X and Y vector stores, expected-ID sets driving
    ``get_fraction_loaded``, and two single-flight SolverCaches (XᵀX, YᵀY);
  * ``MODEL``/``MODEL-REF`` messages start a new/retained model when the
    feature count changes, and set expectations + GC via retain-and-expect;
  * ``UP`` messages apply X/Y vectors (its own and the batch layer's);
  * ``build_updates`` gates on min-model-load-fraction, pre-warms solvers,
    sorts the microbatch by timestamp, aggregates with NaN-delete semantics,
    then folds in each interaction via the closed-form delta solve
    (foldin.compute_updated_xu) for both Xu and Yi, emitting
    ``["X", user, vec]`` / ``["Y", item, vec]`` JSON updates.
"""

from __future__ import annotations

import json
import logging
import time

import numpy as np

from oryx_tpu_torch.api.speed import AbstractSpeedModelManager, SpeedModel
from oryx_tpu_torch.common.lockutils import RateLimitCheck
from oryx_tpu_torch.ml.mlupdate import read_pmml_from_update_key_message
from oryx_tpu_torch.models.als import data as als_data
from oryx_tpu_torch.models.als import foldin
from oryx_tpu_torch.models.als import pmml_codec
from oryx_tpu_torch.models.als.vectors import FeatureVectorStore
from oryx_tpu_torch.ops.solver import SolverCache

log = logging.getLogger(__name__)


def _format_rows(vecs: np.ndarray) -> list[str]:
    """Comma-joined '%.9g' rendering of each row of a float32 matrix —
    one C-level format call per row (numpy's savetxt inner idiom), ~10×
    stdlib json for big update batches. '%.9g' is exact for float32.

    Rows containing non-finite values (an explicit-feedback overflow can
    push a fold-in to inf) fall back to json.dumps, whose
    'Infinity'/'NaN' tokens Python consumers parse — '%g' would render
    'inf', which json.loads rejects."""
    rows64 = np.asarray(vecs, dtype=np.float64)
    fmt = ",".join(["%.9g"] * vecs.shape[1])
    out = [fmt % tuple(row) for row in rows64]
    finite = np.isfinite(rows64).all(axis=1)
    if not finite.all():
        for b in np.flatnonzero(~finite).tolist():
            out[b] = json.dumps(rows64[b].tolist())[1:-1]
    return out


class ALSSpeedModel(SpeedModel):
    """X/Y stores + expected IDs + solver caches (ALSSpeedModel.java:39-183)."""

    def __init__(self, features: int, implicit: bool):
        self.features = features
        self.implicit = implicit
        self.x = FeatureVectorStore()
        self.y = FeatureVectorStore()
        self.expected_user_ids: set[str] = set()
        self.expected_item_ids: set[str] = set()
        self.xtx_cache = SolverCache(self.x.get_vtv)
        self.yty_cache = SolverCache(self.y.get_vtv)

    def set_user_vector(self, user: str, vec: np.ndarray) -> None:
        self.x.set_vector(user, vec)
        self.expected_user_ids.discard(user)
        self.xtx_cache.set_dirty()

    def set_item_vector(self, item: str, vec: np.ndarray) -> None:
        self.y.set_vector(item, vec)
        self.expected_item_ids.discard(item)
        self.yty_cache.set_dirty()

    def retain_recent_and_user_ids(self, ids) -> None:
        self.x.retain_recent_and_ids(set(ids))
        self.xtx_cache.set_dirty()

    def retain_recent_and_item_ids(self, ids) -> None:
        self.y.retain_recent_and_ids(set(ids))
        self.yty_cache.set_dirty()

    def get_fraction_loaded(self) -> float:  # ALSSpeedModel.java:158-171
        total = self.x.size() + self.y.size() + len(self.expected_user_ids) + len(
            self.expected_item_ids
        )
        if total == 0:
            return 1.0
        return (self.x.size() + self.y.size()) / total


class ALSSpeedModelManager(AbstractSpeedModelManager):
    def __init__(self, config):
        self.config = config
        self.implicit = config.get_bool("oryx.als.implicit")
        self.log_strength = config.get_bool("oryx.als.logStrength")
        self.epsilon = config.get_float("oryx.als.hyperparams.epsilon")
        self.min_model_load_fraction = config.get_float("oryx.speed.min-model-load-fraction")
        # ALSSpeedModelManager.java:223-231: updates carry the interaction's
        # other ID so serving can track known items live, unless disabled
        self.no_known_items = config.get_bool("oryx.als.no-known-items")
        self.model: ALSSpeedModel | None = None
        self._log_rate = RateLimitCheck(60)
        #: host seconds of the last build_updates that folded data in, by
        #: stage: prepare, solver get (both sides), vector gather, fold-in
        #: (both sides), formatting; and the updates emitted
        self.report: dict = {}

    # -- update-topic consumption (consumeKeyMessage:67-133) -----------------
    def consume_key_message(self, key: str, message: str) -> None:
        if key == "UP":
            if self.model is None:
                return  # ignore updates before the first model
            update = json.loads(message)
            kind, id_, vec = update[0], update[1], np.asarray(update[2], dtype=np.float32)
            if kind == "X":
                self.model.set_user_vector(id_, vec)
            elif kind == "Y":
                self.model.set_item_vector(id_, vec)
            else:
                raise ValueError(f"bad update type: {kind}")
        elif key in ("MODEL", "MODEL-REF"):
            pmml = read_pmml_from_update_key_message(key, message)
            meta = pmml_codec.pmml_to_meta(pmml)
            features = meta["features"]
            if self.model is None or self.model.features != features:
                log.info("new model (features=%d)", features)
                self.model = ALSSpeedModel(features, meta["implicit"])
                # presize the factor arenas: the handoff meta names every
                # expected row, so the fill skips doubling-growth copies
                self.model.x.reserve(len(meta["x_ids"]))
                self.model.y.reserve(len(meta["y_ids"]))
                self.model.expected_user_ids = set(meta["x_ids"])
                self.model.expected_item_ids = set(meta["y_ids"])
            else:
                self.model.retain_recent_and_user_ids(meta["x_ids"])
                self.model.retain_recent_and_item_ids(meta["y_ids"])
                self.model.expected_user_ids = set(meta["x_ids"]) - set(self.model.x.ids())
                self.model.expected_item_ids = set(meta["y_ids"]) - set(self.model.y.ids())
        else:
            raise ValueError(f"bad key: {key}")

    # -- microbatch fold-in (buildUpdates:135-221) ---------------------------
    def build_updates(self, new_data):
        model = self.model
        if model is None:
            return []
        fraction = model.get_fraction_loaded()
        if fraction < self.min_model_load_fraction:
            if self._log_rate.test():
                log.info("model not yet loaded enough (%.3f)", fraction)
            return []
        # pre-warm both solvers (precomputeSolvers :142)
        model.xtx_cache.compute_now()
        model.yty_cache.compute_now()

        # parse + aggregate through the (vectorized when plain-CSV) ingest
        # pipeline — identical semantics to aggregate() with no decay
        t0 = time.perf_counter()
        batch = als_data.prepare(
            [km.message for km in new_data], self.implicit,
            log_strength=self.log_strength, epsilon=self.epsilon,
        )
        if batch.nnz == 0:
            return []
        t1 = time.perf_counter()
        yty_solver = model.yty_cache.get(blocking=True)
        xtx_solver = model.xtx_cache.get(blocking=True)
        t2 = time.perf_counter()

        # gather the microbatch's vectors once (one read lock per store),
        # then fold in EVERY interaction with one batched solve per side —
        # B k×k solves collapse into two stacked-RHS matmuls instead of a
        # per-interaction host loop (the TPU answer to
        # ALSSpeedModelManager.java:198-220's parallelStream)
        u_ids, i_ids = batch.users.index_to_id, batch.items.index_to_id
        users_l = [u_ids[r] for r in batch.rows.tolist()]
        items_l = [i_ids[c] for c in batch.cols.tolist()]
        values = batch.vals.astype(np.float64)
        B, k = batch.nnz, model.features
        xus = np.zeros((B, k), dtype=np.float32)
        yis = np.zeros((B, k), dtype=np.float32)
        has_xu = np.zeros(B, dtype=bool)
        has_yi = np.zeros(B, dtype=bool)
        for b, xu in enumerate(model.x.get_vectors(users_l)):
            if xu is not None:
                xus[b], has_xu[b] = xu, True
        for b, yi in enumerate(model.y.get_vectors(items_l)):
            if yi is not None:
                yis[b], has_yi[b] = yi, True

        t3 = time.perf_counter()
        new_x = new_y = None
        changed_x = changed_y = None
        if yty_solver is not None:
            new_x, changed_x = foldin.compute_updated_batch(
                yty_solver, values, xus, has_xu, yis, has_yi, self.implicit
            )
        # symmetric item update (ALSSpeedModelManager.java:209-219)
        if xtx_solver is not None:
            new_y, changed_y = foldin.compute_updated_batch(
                xtx_solver, values, yis, has_yi, xus, has_xu, self.implicit
            )

        # wire format [matrix, ID, vector, [otherID]] — the 4th element feeds
        # serving's known-items live (ALSSpeedModelManager.java:223-231);
        # omitted entirely under oryx.als.no-known-items.
        # json.dumps per update was ~75% of the whole fold-in wall (2.8M
        # Python float serializations per 50k microbatch); the vectors are
        # formatted wholesale with one C-level '%.9g' pass per row instead
        # ('%.9g' round-trips float32 exactly; JSON accepts e-notation),
        # with IDs still json-escaped — they are arbitrary strings.
        t4 = time.perf_counter()
        updates: list[str] = []

        def emit(kind, new_v, changed, own_ids, other_ids):
            idx = np.flatnonzero(changed)
            if idx.size == 0:
                return
            rows = _format_rows(new_v[idx])
            for b, row in zip(idx.tolist(), rows):
                own = json.dumps(own_ids[b])
                if self.no_known_items:
                    updates.append(f'["{kind}",{own},[{row}]]')
                else:
                    other = json.dumps([other_ids[b]])
                    updates.append(f'["{kind}",{own},[{row}],{other}]')

        if new_x is not None:
            emit("X", new_x, changed_x, users_l, items_l)
        if new_y is not None:
            emit("Y", new_y, changed_y, items_l, users_l)
        self.report = {"prepare_s": t1 - t0, "solver_s": t2 - t1,
                       "gather_s": t3 - t2, "foldin_s": t4 - t3,
                       "format_s": time.perf_counter() - t4,
                       "interactions": B, "updates": len(updates)}
        return updates
