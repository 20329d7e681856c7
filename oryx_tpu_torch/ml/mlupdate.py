"""MLUpdate: the train/tune/eval/publish harness behind every model family.

The port of the JAX package's ``oryx_tpu/ml/mlupdate.py`` (MLUpdate.java:
163-378 in the original Oryx): one batch generation = choose hyperparameter
combos → build+evaluate candidates in parallel → promote the best into a
timestamped model dir → publish MODEL (inline PMML when ≤ update-topic
max-size) or MODEL-REF (path) → optional additional model data (e.g. ALS
streams every factor row). ``read_pmml_from_update_key_message`` decodes
those messages for the speed and serving managers.

Candidate builds run through a host thread pool (``oryx.ml.eval.parallelism``,
ExecUtils.collectInParallel:255 equivalent), or with speculative backups
(``oryx.ml.eval.speculation.*``, the default). Each build gets its device
explicitly (``build_model(..., device=...)``): the updater's own device, or,
with ``eval.parallelism > 1``, several candidates and more than one CUDA
card, the cards in turn, as the reference round-robins its local devices.
Nothing relies on a global current device.

Beyond the reference, :attr:`MLUpdate.report` holds the host seconds of the
last ``run_update``'s stages (split, each candidate's build and evaluation,
promote, publish), so a caller can see where a generation's time went.
Checkpointing (``make_checkpointer``) is not ported: a model family that
would use it refuses the setting in its constructor.
"""

from __future__ import annotations

import logging
import math
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Sequence

import torch

from oryx_tpu_torch.api.batch import BatchLayerUpdate
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import executils, lineage, rand
from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.ml import param as hp
from oryx_tpu_torch.pmml import pmmlutils
from oryx_tpu_torch.store.datastore import ModelStore

log = logging.getLogger(__name__)

MODEL_FILE_NAME = "model.pmml"  # MLUpdate.java MODEL_FILE_NAME


class MissingModelError(Exception):
    """A ``MODEL-REF`` message names a path that does not exist."""


class MLUpdate(BatchLayerUpdate):
    """Subclasses implement build_model / evaluate (+ optional hooks).
    ``device`` (``None``: the CUDA card) is where candidates are built and
    evaluated."""

    def __init__(self, config, device=None):
        self.config = config
        self.device = device
        self.test_fraction = config.get_float("oryx.ml.eval.test-fraction")
        candidates = config.get_int("oryx.ml.eval.candidates")
        self.eval_parallelism = config.get_int("oryx.ml.eval.parallelism")
        self.threshold = config.get("oryx.ml.eval.threshold", None)
        self.hyperparam_search = config.get_string("oryx.ml.eval.hyperparam-search")
        self.max_message_size = config.get_int("oryx.update-topic.message.max-size")
        if self.test_fraction == 0.0 and candidates > 1:
            log.info("test-fraction = 0 so candidates is overridden to 1")
            candidates = 1
        self.candidates = candidates
        # speculative backup execution for straggling candidate builds
        # (reference spark.speculation, reference.conf:86)
        self.speculation = config.get_bool("oryx.ml.eval.speculation.enabled", True)
        self.speculation_multiplier = config.get_float(
            "oryx.ml.eval.speculation.multiplier", 1.5
        )
        self.speculation_min_runtime = config.get_float(
            "oryx.ml.eval.speculation.min-runtime-sec", 10.0
        )
        self.speculation_timeout = config.get(
            "oryx.ml.eval.speculation.timeout-sec", None
        )
        #: Host seconds of the last run_update's stages (see the module
        #: docstring); ``candidates`` maps each candidate dir's name ("0",
        #: "1", a backup "0.1") to its record.
        self.report: dict = {}
        self._report_lock = threading.Lock()

    # -- abstract surface (MLUpdate.java:113-157) ---------------------------
    def get_hyper_parameter_values(self) -> list[hp.HyperParamValues]:
        return []

    def build_model(
        self,
        context,
        train_data: Sequence[KeyMessage],
        hyper_parameters: list,
        candidate_path: Path,
        device=None,
    ):
        """Train and return a PMML Element for one candidate, on ``device``
        (``None``: this updater's own device)."""
        raise NotImplementedError

    def evaluate(
        self,
        context,
        model,  # PMML Element
        model_parent_path: Path,
        test_data: Sequence[KeyMessage],
        train_data: Sequence[KeyMessage],
    ) -> float:
        """Higher is better (MLUpdate.java:157)."""
        raise NotImplementedError

    def publish_additional_model_data(
        self, context, pmml, new_data, past_data, model_path: Path, producer
    ) -> None:
        """Hook (MLUpdate.java:139-146); default no-op."""

    def candidate_record(self, candidate_path) -> dict:
        """The report record of the candidate built in ``candidate_path``,
        where a subclass adds its own stage times."""
        name = Path(candidate_path).name
        with self._report_lock:
            return self.report.setdefault("candidates", {}).setdefault(name, {})

    # -- BatchLayerUpdate (runUpdate:163-248) --------------------------------
    def run_update(self, context, timestamp_ms, new_data, past_data, model_dir, producer):
        t_run = time.perf_counter()
        self.report = {"candidates": {}}
        # the device rule holds here, outside the candidate loop that skips
        # a candidate whose build fails: no card means no generation, loudly
        resolve(self.device)
        train_start_ms = int(time.time() * 1000)
        new_data = list(new_data)
        past_data = list(past_data)
        if not new_data and not past_data:
            log.info("no data to train on")
            return
        combos = hp.choose_hyper_parameter_combos(
            self.get_hyper_parameter_values(), self.candidates, self.hyperparam_search
        )
        self.report["combos"] = combos
        # test data is held out of NEW data only; past data always trains
        # (MLUpdate.java:306,342-376)
        t0 = time.perf_counter()
        train_new, test = self.split_new_data_to_train_test(new_data)
        train = list(train_new) + past_data
        self.report["split_s"] = time.perf_counter() - t0
        scratch = Path(tempfile.mkdtemp(prefix="oryx-candidates-"))
        try:
            best_path, best_eval = self._find_best_candidate_path(
                context, train, test, combos, scratch
            )
            if best_path is None:
                log.info("unable to build any model")
                return
            if self.threshold is not None and (
                best_eval is None
                or math.isnan(best_eval)
                or best_eval < float(self.threshold)
            ):
                log.info(
                    "best model eval %s does not exceed threshold %s; not publishing",
                    best_eval,
                    self.threshold,
                )
                return
            # promote best candidate into the model store (MLUpdate.java:201-207)
            t0 = time.perf_counter()
            store = ModelStore(model_dir)
            final_path = store.promote(best_path, timestamp_ms)
            self.report.update(best=best_path.name, best_eval=best_eval,
                               promote_s=time.perf_counter() - t0)
        finally:
            # drop the whole candidates scratch (fs.delete(candidatesPath))
            shutil.rmtree(scratch, ignore_errors=True)
        model_file = final_path / MODEL_FILE_NAME
        pmml = pmmlutils.read(model_file)
        pmml_string = pmmlutils.to_string(pmml)
        if producer is not None:
            # provenance stamp on the publish: generation id, the input
            # offsets/watermark the batch layer recorded on the context,
            # train timing, origin, row counts — every send below carries it
            if self.config.get_bool("oryx.lineage.enabled", True):
                stamp = lineage.make_stamp(
                    context, timestamp_ms,
                    train_start_ms=train_start_ms,
                    train_end_ms=int(time.time() * 1000),
                    new_rows=len(new_data), past_rows=len(past_data),
                )
                producer = lineage.StampedProducer(producer, stamp)
            # inline if small enough, else by reference (MLUpdate.java:219-233)
            t0 = time.perf_counter()
            if len(pmml_string) <= self.max_message_size:
                producer.send("MODEL", pmml_string)
                self.report["published"] = "MODEL"
            else:
                producer.send("MODEL-REF", str(model_file))
                self.report["published"] = "MODEL-REF"
            self.report["publish_model_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            self.publish_additional_model_data(
                context, pmml, new_data, past_data, final_path, producer
            )
            self.report["publish_additional_s"] = time.perf_counter() - t0
        self.report["run_update_s"] = time.perf_counter() - t_run

    # -- candidate search (findBestCandidatePath:250-292) --------------------
    def _candidate_devices(self, n_combos: int):
        """The cards to round-robin candidate builds over, or None: with
        several candidates built in parallel (SURVEY §2.14 EP-like fan-out)
        on an updater bound to the card but to no card in particular, and
        more than one card, each candidate takes the next card."""
        if self.eval_parallelism <= 1 or n_combos <= 1:
            return None
        dev = resolve(self.device)
        if dev.type != "cuda" or dev.index is not None:
            return None
        count = torch.cuda.device_count()
        return [torch.device("cuda", i) for i in range(count)] if count > 1 else None

    def _find_best_candidate_path(self, context, train, test, combos, scratch: Path):
        devices = self._candidate_devices(len(combos))

        def build_and_eval(i: int, attempt: int = 0):
            # a backup attempt writes to its own path and prefers a DIFFERENT
            # device than the original, mirroring Spark's speculative copies
            candidate_path = scratch / (f"{i}" if attempt == 0 else f"{i}.{attempt}")
            candidate_path.mkdir(parents=True, exist_ok=True)
            record = self.candidate_record(candidate_path)
            record["hyperparameters"] = combos[i]
            device = (devices[(i + attempt) % len(devices)]
                      if devices is not None else self.device)
            t0 = time.perf_counter()
            try:
                pmml = self.build_model(context, train, combos[i], candidate_path,
                                        device=device)
            except Exception as e:  # noqa: BLE001 - a failed candidate is skipped
                log.exception("candidate %d failed to build", i)
                record["failed"] = repr(e)
                return None
            finally:
                record["build_s"] = time.perf_counter() - t0
            if pmml is None:
                return None
            pmmlutils.write(pmml, candidate_path / MODEL_FILE_NAME)
            t0 = time.perf_counter()
            if self.test_fraction == 0.0 or not test:
                eval_result = None
            else:
                eval_result = self.evaluate(context, pmml, candidate_path, test, train)
            record.update(eval=eval_result, evaluate_s=time.perf_counter() - t0)
            log.info("candidate %d (%s) eval = %s", i, combos[i], eval_result)
            return candidate_path, eval_result

        if self.speculation:
            results = executils.collect_speculative(
                len(combos), build_and_eval, self.eval_parallelism,
                multiplier=self.speculation_multiplier,
                min_runtime_sec=self.speculation_min_runtime,
                abandon_sec=(
                    float(self.speculation_timeout)
                    if self.speculation_timeout is not None
                    else None
                ),
            )
        else:
            results = executils.collect_in_parallel(
                len(combos), build_and_eval, self.eval_parallelism
            )
        best = None
        for r in results:
            if r is None:
                continue
            if best is None or _better(r[1], best[1]):
                best = r
        return best if best is not None else (None, None)

    # -- train/test split (splitTrainTest:342-376) ---------------------------
    def split_new_data_to_train_test(self, new_data):
        """Default random split of the NEW data by test-fraction; subclasses
        may override with e.g. time-ordered splits (ALSUpdate.java:326-343)."""
        if self.test_fraction <= 0:
            return new_data, []
        rng = rand.get_random()
        mask = rng.random(len(new_data)) < self.test_fraction
        train = [d for d, m in zip(new_data, mask) if not m]
        test = [d for d, m in zip(new_data, mask) if m]
        return train, test


def _better(a, b) -> bool:
    """Candidate-score comparison where None and NaN are worse than any real
    score: 'real > nan' is False in IEEE terms, so a NaN-scored candidate
    evaluated first would otherwise survive every later comparison and be
    published as "best"."""
    a_bad = a is None or a != a  # self-inequality: NaN of ANY float-like
    b_bad = b is None or b != b  # (np.float32 NaN is not a python float)
    if a_bad:
        return False
    if b_bad:
        return True
    return a > b


def read_pmml_from_update_key_message(key: str, message: str):
    """Decode MODEL / MODEL-REF update messages into a PMML Element
    (AppPMMLUtils.readPMMLFromUpdateKeyMessage:234-259)."""
    if key == "MODEL":
        return pmmlutils.from_string(message)
    if key == "MODEL-REF":
        path = Path(message)
        if not path.exists():
            raise MissingModelError(f"MODEL-REF path does not exist: {message}")
        return pmmlutils.read(path)
    raise ValueError(f"not a model message: {key}")
