"""ALS batch update: the MLUpdate implementation for collaborative filtering.

The port of the JAX package's ``oryx_tpu/models/als/update.py`` (ALSUpdate.
java:82-343 in the original Oryx): hyperparameters from
``oryx.als.hyperparams.*`` (features, lambda, alpha, and epsilon iff
logStrength), time-decayed and NaN-aware-aggregated input, training on the
card (:func:`~oryx_tpu_torch.models.als.train.als_train`, whose block solves
are the gather-Gramian and SPD-solve kernels), evaluation (implicit: mean
AUC; explicit: −RMSE) on the factors read back from the part files,
time-ordered train/test split (splitNewDataToTrainTest:326-343),
pointer-PMML artifact, and publish_additional_model_data streaming every Y
then X row as ``"UP" ["Y"/"X", id, vector(, knownItems)]``
(ALSUpdate.java:286-319 — items first so user endpoints return complete
results once users arrive).

Device randomness: Y₀ comes from a ``torch.Generator`` of
:func:`~oryx_tpu_torch.common.rand.torch_generator` where the reference
splits ``rand.get_key()``. As in the reference, each updater keeps one
slotted-layout cache across its generations, and with
``oryx.batch.checkpoint.enabled`` each candidate's trainer checkpoints
under the generation's data fingerprint, which also names the published
generation (a crash-restarted generation resumes and keeps its id). When
the batch tier's context has a mesh of more than one device with a
``model`` axis, the factor rows shard over that axis
(``als_train(mesh=, row_axis="model")``), and the padded factors are cut
to their real rows at publish.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import checkpoint as ckpt_mod
from oryx_tpu_torch.common import rand
from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.ml import param as hp
from oryx_tpu_torch.ml.mlupdate import MLUpdate
from oryx_tpu_torch.models.als import data as als_data
from oryx_tpu_torch.models.als import evaluate as als_eval
from oryx_tpu_torch.models.als import pmml_codec
from oryx_tpu_torch.models.als import train as als_train_mod

log = logging.getLogger(__name__)


class ALSUpdate(MLUpdate):
    """Trains and evaluates on ``device`` (``None``: the CUDA card)."""

    def __init__(self, config, device=None):
        super().__init__(config, device=device)
        self.iterations = config.get_int("oryx.als.iterations")
        self.implicit = config.get_bool("oryx.als.implicit")
        self.log_strength = config.get_bool("oryx.als.logStrength")
        self.no_known_items = config.get_bool("oryx.als.no-known-items")
        self.decay_factor = config.get_float("oryx.als.decay.factor")
        self.decay_zero_threshold = config.get_float("oryx.als.decay.zero-threshold")
        self.compute_dtype = config.get_string("oryx.als.compute-dtype", "float32")
        self.hyper_params = [
            hp.from_config(config, "oryx.als.hyperparams.features"),
            hp.from_config(config, "oryx.als.hyperparams.lambda"),
            hp.from_config(config, "oryx.als.hyperparams.alpha"),
        ]
        if self.log_strength:
            self.hyper_params.append(hp.from_config(config, "oryx.als.hyperparams.epsilon"))
        # slotted-layout reuse across generations: when the next
        # generation's COO extends this one's (append-mostly input and no
        # decay rewriting historical strengths), the host pack collapses to
        # an incremental delta of the touched blocks. One cache per updater
        # (generations build sequentially on the batch tier); concurrent
        # hyperparameter candidates contend on the try-lock and simply pack
        # uncached rather than interleave the cache's generations. The
        # cache holds the last generation's slabs on the card: dropping
        # the updater frees them
        self._layout_cache = als_train_mod.BlockedLayoutCache()
        self._layout_cache_lock = threading.Lock()

    def get_hyper_parameter_values(self):
        return list(self.hyper_params)

    # -- train (buildModel:108-179) -----------------------------------------
    def build_model(self, context, train_data, hyper_parameters,
                    candidate_path: Path, device=None):
        features = int(hyper_parameters[0])
        lam = float(hyper_parameters[1])
        alpha = float(hyper_parameters[2])
        epsilon = float(hyper_parameters[3]) if self.log_strength else 1.0e-5
        if features <= 0 or lam < 0.0 or alpha <= 0.0:
            raise ValueError("features must be positive, lambda >= 0, alpha > 0")
        dev = resolve(self.device if device is None else device)
        record = self.candidate_record(candidate_path)

        t0 = time.perf_counter()
        batch = als_data.prepare(
            (km.message for km in train_data),
            implicit=self.implicit,
            decay_factor=self.decay_factor,
            decay_zero_threshold=self.decay_zero_threshold,
            log_strength=self.log_strength,
            epsilon=epsilon,
        )
        record["prepare_s"] = time.perf_counter() - t0
        if batch.nnz == 0 or len(batch.users) == 0 or len(batch.items) == 0:
            return None
        # factor rows shard over the mesh's model axis when the batch tier
        # runs on several devices (ComputeContext)
        mesh = row_axis = None
        ctx_mesh = getattr(context, "mesh", None)
        if (ctx_mesh is not None and ctx_mesh.size > 1
                and "model" in ctx_mesh.axis_names):
            mesh, row_axis = ctx_mesh, "model"
        # preemption tolerance: the checkpoint identity is the generation's
        # DATA fingerprint — input-topic offsets (stamped on the context by
        # the batch layer; None for direct/test callers), the candidate's
        # hyperparameters, the batch shapes, and a CRC of the actual COO
        # arrays — so a restarted generation resumes ONLY state built from
        # exactly the data and settings it is about to train on. The same
        # parts as the reference's, so both packages name the same file
        checkpointer = None
        if ckpt_mod.enabled(self.config):
            fp = ckpt_mod.fingerprint(
                kind="als",
                offsets=getattr(context, "input_offsets", None),
                features=features, lam=lam, alpha=alpha, epsilon=epsilon,
                implicit=self.implicit, iterations=self.iterations,
                dtype=self.compute_dtype,
                shape=[len(batch.users), len(batch.items), int(batch.nnz)],
                data_crc=ckpt_mod.data_crc(batch.rows, batch.cols,
                                           batch.vals),
            )
            checkpointer = self.make_checkpointer(fp)
        cache = (
            self._layout_cache
            if self._layout_cache_lock.acquire(blocking=False) else None
        )
        timings: dict = {}
        t0 = time.perf_counter()
        try:
            x, y = als_train_mod.als_train(
                batch,
                features=features,
                lam=lam,
                alpha=alpha,
                implicit=self.implicit,
                iterations=self.iterations,
                generator=rand.torch_generator(),
                dtype=self.compute_dtype,
                layout_cache=cache,
                timings=timings,
                checkpointer=checkpointer,
                device=dev,
                mesh=mesh,
                row_axis=row_axis,
            )
        finally:
            if cache is not None:
                self._layout_cache_lock.release()
        if mesh is not None:
            # mesh factors come back row-sharded and padded to the block
            # boundary: cut to the real rows
            x = x.full()[:len(batch.users)]
            y = y.full()[:len(batch.items)]
        x, y = x.cpu().numpy(), y.cpu().numpy()
        record.update(train_s=time.perf_counter() - t0, device=str(dev),
                      **timings)
        # lineage identity for the generation's provenance stamp: the
        # checkpoint fingerprint keeps the generation id stable across a
        # crash-restart (same uncommitted offsets → same fp), and origin
        # records whether this training resumed or started from scratch.
        # Parallel candidates race last-writer-wins; exact for candidates=1.
        # Direct/test callers pass context=None — nothing to stamp onto.
        if context is not None:
            context.lineage_fingerprint = (
                fp if checkpointer is not None else None
            )
            context.lineage_origin = (
                "resume"
                if checkpointer is not None and checkpointer.resumed_step
                else "scratch"
            )
        log.info(
            "ALS train: %d nnz, pack %.2fs on the critical path (user %.2fs"
            " + item wait %.2fs; modes %s)",
            batch.nnz, timings.get("pack_s", 0.0),
            timings.get("pack_user_s", 0.0), timings.get("pack_wait_s", 0.0),
            timings.get("pack_modes"),
        )
        t0 = time.perf_counter()
        pmml = pmml_codec.model_to_pmml(
            x,
            y,
            batch.users.index_to_id,
            batch.items.index_to_id,
            features,
            lam,
            alpha,
            self.implicit,
            self.log_strength,
            epsilon,
            candidate_path,
        )
        record["write_s"] = time.perf_counter() - t0
        return pmml

    # -- eval (evaluate:200-247) --------------------------------------------
    def evaluate(self, context, model, model_parent_path: Path, test_data, train_data):
        record = self.candidate_record(model_parent_path)
        dev = resolve(self.device)
        t0 = time.perf_counter()
        meta = pmml_codec.pmml_to_meta(model)
        users = als_data.IDIndexMapping(meta["x_ids"])
        items = als_data.IDIndexMapping(meta["y_ids"])
        x = _load_matrix(Path(model_parent_path) / meta["x_dir"], users, meta["features"])
        y = _load_matrix(Path(model_parent_path) / meta["y_dir"], items, meta["features"])
        x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        record["evaluate_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        test_batch = self._eval_batch(test_data, meta, users, items)
        if self.implicit:
            # rebuild the train known-set from the passed train data — stateless,
            # safe under concurrent candidate evaluation
            train_batch = self._eval_batch(train_data, meta, users, items)
            record["evaluate_parse_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            score = als_eval.area_under_curve(x, y, train_batch, test_batch)
            record["evaluate_score_s"] = time.perf_counter() - t0
            log.info("AUC = %s", score)
            return score
        record["evaluate_parse_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        score = -als_eval.rmse(x, y, test_batch)
        record["evaluate_score_s"] = time.perf_counter() - t0
        log.info("-RMSE = %s", score)
        return score

    def _eval_batch(self, data, meta, users, items):
        """Parse→decay→aggregate with the SAME pipeline as training, so eval
        scores compare like with like (reference routes test data through
        parsedToRatingRDD, which decays — ALSUpdate.java:219)."""
        interactions = als_data.decay(
            als_data.parse_lines([km.message for km in data]),
            self.decay_factor,
            self.decay_zero_threshold,
        )
        return als_data.build_rating_batch(
            als_data.aggregate(
                interactions, self.implicit, meta["logStrength"], meta["epsilon"]
            ),
            users,
            items,
        )

    # -- time-ordered split of NEW data (splitNewDataToTrainTest:326-343) ----
    def split_new_data_to_train_test(self, new_data: Sequence[KeyMessage]):
        if self.test_fraction <= 0:
            return list(new_data), []

        def ts(km: KeyMessage) -> int:
            try:
                return als_data.parse_line(km.message).timestamp_ms
            except ValueError:
                return 0

        ordered = sorted(new_data, key=ts)
        split = int(round(len(ordered) * (1.0 - self.test_fraction)))
        return ordered[:split], ordered[split:]

    # -- stream factors to serving/speed (publishAdditionalModelData:286-319) -
    def publish_additional_model_data(self, context, pmml, new_data, past_data, model_path, producer):
        meta = pmml_codec.pmml_to_meta(pmml)
        y_path = Path(model_path) / meta["y_dir"]
        x_path = Path(model_path) / meta["x_dir"]
        t0 = time.perf_counter()
        # items first (reference comment: more complete /recommend once users load)
        for id_, vec in pmml_codec.read_features(y_path):
            producer.send("UP", json.dumps(["Y", id_, [float(v) for v in vec]]))
        self.report["publish_y_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        known_items: dict[str, list[str]] = {}
        if not self.no_known_items:
            known_sets: dict[str, set[str]] = {}
            for km in list(new_data) + list(past_data):
                try:
                    it = als_data.parse_line(km.message)
                except ValueError:
                    continue
                known_sets.setdefault(it.user, set()).add(it.item)
            known_items = {u: sorted(s) for u, s in known_sets.items()}
        self.report["known_items_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for id_, vec in pmml_codec.read_features(x_path):
            if known_items:
                producer.send(
                    "UP",
                    json.dumps(["X", id_, [float(v) for v in vec], known_items.get(id_, [])]),
                )
            else:
                producer.send("UP", json.dumps(["X", id_, [float(v) for v in vec]]))
        self.report["publish_x_s"] = time.perf_counter() - t0


def _load_matrix(path: Path, mapping: als_data.IDIndexMapping, features: int) -> np.ndarray:
    m = np.zeros((len(mapping), features), dtype=np.float32)
    for id_, vec in pmml_codec.read_features(path):
        idx = mapping.id_to_index.get(id_)
        if idx is not None:
            m[idx] = vec
    return m
