"""Durable trainer checkpoints: atomic, checksummed, versioned, resumable.

A copy of the JAX package's ``oryx_tpu/common/checkpoint.py`` with its
imports pointed at the port. The file format and its magic/version are the
reference's, so a checkpoint written by either package loads in the other
(``tests/test_torch_checkpoint.py``). One part differs: the writer fetches
torch tensors. A CUDA tensor is copied on a side stream that waits only on
an event recorded at :meth:`TrainerCheckpointer.submit`, so the fetch does
not queue behind the half-iterations the training loop dispatched after
the submit (see :func:`_fetch`).

The batch tier's recovery story used to be "the input topic is the
always-recomputable checkpoint" (lambda_rt/batch.py): a ``kill -9`` or
preemption mid-generation threw away every completed ALS iteration and
restarted the whole build next interval. This module is the mechanism
that makes a killed trainer lose at most one checkpoint interval instead
of the generation.

Three layers:

  * :class:`CheckpointStore` — an atomic, checksummed, versioned on-disk
    store. One file per checkpoint (``ckpt-<fingerprint>-<step>.oryx``):
    a magic header, a CRC-verified JSON manifest, then the raw array blobs
    each carrying its own CRC32. Writes go write-temp → fsync → rename
    (the ``ioutils.atomic_write_bytes`` discipline), so a writer killed at
    any instant leaves whole files only. Corrupt or partial checkpoints
    are **skipped with a warning, never trusted** — a bad newest file
    falls back to the next older one. Keep-last-N GC per fingerprint plus
    a total-file cap bound the directory across generations.
  * :func:`fingerprint` / :func:`data_crc` — the identity a checkpoint is
    keyed by: input offsets + hyperparameters + shapes (+ a CRC of the
    actual COO data), so a restarted generation only resumes state built
    from EXACTLY the data and settings it is about to train on.
  * :class:`TrainerCheckpointer` — the training-loop hook: interval-driven
    saves handed to a background writer thread so the device→host fetch
    and the file write overlap the next half-iteration (the same overlap
    discipline as the trainer's pack/compute split); ``wait_s`` records
    the time the device loop actually blocked on checkpointing, which the
    batch bench pins at ≈0. A failed save **degrades** (warning + counter)
    — checkpointing must never kill a generation.

Fault sites ``ckpt.save`` and ``ckpt.load`` ride the common/faults.py spec
grammar so chaos drills can prove the degradation story
(docs/robustness.md "Durability").
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import sys
import threading
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from oryx_tpu_torch.common import blackbox
from oryx_tpu_torch.common import faults
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import spans

log = spans.get_logger(__name__)

_SAVES = metrics_mod.default_registry().counter(
    "oryx_checkpoint_saves_total",
    "Trainer checkpoints written successfully",
)
_SAVE_FAILURES = metrics_mod.default_registry().counter(
    "oryx_checkpoint_save_failures_total",
    "Checkpoint saves that failed (training continued without them)",
)
_RESUMES = metrics_mod.default_registry().counter(
    "oryx_checkpoint_resumes_total",
    "Trainings that resumed from a valid checkpoint",
)
_BYTES = metrics_mod.default_registry().counter(
    "oryx_checkpoint_bytes_total",
    "Bytes written into successful checkpoints (manifest + blobs)",
)
_LAST_AGE = metrics_mod.default_registry().gauge(
    "oryx_checkpoint_last_age_seconds",
    "Seconds since this process last wrote a checkpoint (-1 = never)",
)

#: wall-clock of the last successful save in this process (the age gauge);
#: a plain float written under the GIL, read by the scrape callback
_last_save_ts: "float | None" = None
_LAST_AGE.set_function(
    lambda: (time.time() - _last_save_ts) if _last_save_ts else -1.0
)

_MAGIC = b"ORYXCKPT1"
_FILE_RE = re.compile(r"^ckpt-([0-9a-f]{16})-(\d{8})\.oryx$")


def fingerprint(**parts) -> str:
    """Stable 16-hex-digit identity of a training's inputs. Callers pass
    whatever defines "the same work": input-topic offsets, hyperparameters,
    shapes, a :func:`data_crc` of the COO arrays. JSON-canonicalized with
    sorted keys so dict ordering never perturbs the digest."""
    blob = json.dumps(parts, sort_keys=True, default=str).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:16]


def data_crc(*arrays) -> int:
    """Running CRC32 over the raw bytes of numpy arrays — the cheap exact
    data digest fed into :func:`fingerprint` (≈ O(nnz) memory walk; tens of
    milliseconds at 10M interactions)."""
    crc = 0
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc


@dataclass
class Checkpoint:
    """One validated checkpoint: step id, identity, user meta, host arrays."""

    step: int
    fingerprint: str
    meta: dict
    arrays: "dict[str, np.ndarray]" = field(default_factory=dict)
    path: "Path | None" = None


class CheckpointStore:
    """Atomic, checksummed checkpoint files under one directory.

    File layout (version 1)::

        ORYXCKPT1 <manifest_len> <manifest_crc32:08x>\\n
        <manifest json>            # step, fingerprint, meta, array table
        <blob 0><blob 1>...        # raw C-order array bytes, each CRC'd

    Every read path validates the magic, the manifest CRC, each blob's
    length and CRC, and the total file size — anything off means the file
    is skipped with a warning (and reported in the load result), never
    half-trusted. Writes are write-temp + fsync + ``os.replace`` with
    unique temp names, so concurrent candidate builds sharing a directory
    cannot tear each other's files (the last whole rename wins)."""

    def __init__(self, root: "str | Path", keep: int = 2):
        self.root = ioutils.mkdirs(root)
        self.keep = max(1, int(keep))
        # in-process serialization of save+GC; cross-process safety comes
        # from unique temp names + whole-file renames
        self._lock = threading.Lock()

    # -- paths ---------------------------------------------------------------
    def _path(self, fp: str, step: int) -> Path:
        return self.root / f"ckpt-{fp}-{step:08d}.oryx"

    def entries(self) -> "list[tuple[str, int, Path]]":
        """(fingerprint, step, path) for every well-NAMED file, step
        ascending (content is validated only at load time)."""
        out = []
        for p in self.root.iterdir():
            m = _FILE_RE.match(p.name)
            if m:
                out.append((m.group(1), int(m.group(2)), p))
        out.sort(key=lambda e: e[1])
        return out

    def steps(self, fp: str) -> "list[int]":
        return [step for f, step, _ in self.entries() if f == fp]

    # -- save ----------------------------------------------------------------
    def save(self, fp: str, step: int, arrays: "dict[str, np.ndarray]",
             meta: "dict | None" = None) -> Path:
        """Write one checkpoint atomically; raises on failure (callers that
        must degrade — the TrainerCheckpointer — catch and count)."""
        faults.maybe_fail("ckpt.save")
        blobs: list[bytes] = []
        table: list[dict] = []
        for name, arr in arrays.items():
            a = np.ascontiguousarray(arr)
            raw = a.tobytes()
            blobs.append(raw)
            table.append({
                "name": name,
                "dtype": a.dtype.str,
                "shape": list(a.shape),
                "nbytes": len(raw),
                "crc32": zlib.crc32(raw),
            })
        manifest = json.dumps(
            {"version": 1, "step": int(step), "fingerprint": fp,
             "meta": meta or {}, "arrays": table},
            separators=(",", ":"), sort_keys=True,
        ).encode("utf-8")
        header = b"%s %d %08x\n" % (_MAGIC, len(manifest), zlib.crc32(manifest))
        payload = b"".join([header, manifest, *blobs])
        path = self._path(fp, step)
        with self._lock:
            ioutils.atomic_write_bytes(path, payload)
            self._gc(fp)
        _SAVES.inc()
        _BYTES.inc(len(payload))
        global _last_save_ts
        _last_save_ts = time.time()
        return path

    def _gc(self, current_fp: str) -> None:
        """Keep the newest ``keep`` checkpoints of the current fingerprint;
        cap the whole directory at ``4 × keep`` files so superseded
        generations' checkpoints age out instead of accumulating forever
        (oldest steps first — monotonic step ids make age an ordering)."""
        entries = self.entries()
        mine = [e for e in entries if e[0] == current_fp]
        doomed = mine[: max(0, len(mine) - self.keep)]
        survivors = [e for e in entries if e not in doomed]
        total_cap = 4 * self.keep
        if len(survivors) > total_cap:
            others = [e for e in survivors if e[0] != current_fp]
            doomed += others[: len(survivors) - total_cap]
        for _, _, p in doomed:
            ioutils.delete_recursively(p)

    # -- load ----------------------------------------------------------------
    def load_latest(self, fp: str) -> "Checkpoint | None":
        """Newest VALID checkpoint for a fingerprint: candidates are tried
        newest-first, and any corrupt/partial/mis-fingerprinted file is
        skipped with a warning — never trusted, never fatal."""
        faults.maybe_fail("ckpt.load")
        for _, step, path in reversed(
            [e for e in self.entries() if e[0] == fp]
        ):
            try:
                ck = self._load_file(path)
            except (OSError, ValueError) as e:
                log.warning(
                    "skipping corrupt/partial checkpoint %s: %s", path.name, e
                )
                continue
            if ck.fingerprint != fp or ck.step != step:
                log.warning(
                    "skipping checkpoint %s: manifest identity mismatch",
                    path.name,
                )
                continue
            return ck
        return None

    def _load_file(self, path: Path) -> Checkpoint:
        data = path.read_bytes()
        if not data.startswith(_MAGIC + b" "):
            raise ValueError("bad magic")
        nl = data.find(b"\n")
        if nl < 0:
            raise ValueError("truncated header")
        try:
            _, len_s, crc_s = data[:nl].split(b" ")
            m_len, m_crc = int(len_s), int(crc_s, 16)
        except ValueError as e:
            raise ValueError(f"bad header: {e}") from e
        manifest_raw = data[nl + 1: nl + 1 + m_len]
        if len(manifest_raw) != m_len or zlib.crc32(manifest_raw) != m_crc:
            raise ValueError("manifest CRC/length mismatch")
        manifest = json.loads(manifest_raw)
        if manifest.get("version") != 1:
            raise ValueError(f"unknown version {manifest.get('version')!r}")
        arrays: dict[str, np.ndarray] = {}
        pos = nl + 1 + m_len
        for entry in manifest["arrays"]:
            raw = data[pos: pos + entry["nbytes"]]
            if len(raw) != entry["nbytes"] or zlib.crc32(raw) != entry["crc32"]:
                raise ValueError(f"blob CRC/length mismatch: {entry['name']}")
            arrays[entry["name"]] = np.frombuffer(
                raw, dtype=np.dtype(entry["dtype"])
            ).reshape(entry["shape"]).copy()
            pos += entry["nbytes"]
        if pos != len(data):
            raise ValueError("trailing bytes past the manifest's blob table")
        return Checkpoint(
            step=int(manifest["step"]),
            fingerprint=str(manifest["fingerprint"]),
            meta=manifest.get("meta") or {},
            arrays=arrays,
            path=path,
        )


class TrainerCheckpointer:
    """Interval-driven async checkpoint hook for an iterative trainer.

    The training loop calls :meth:`wants`/:meth:`submit` once per completed
    iteration; a submit hands the (still-device-resident) arrays to a
    background writer that fetches them to host and writes the store file
    while the device crunches the next half-iteration. One write is in
    flight at a time: submitting the next checkpoint first joins the
    previous write. Joins double as DISPATCH PACING — CUDA dispatch races
    arbitrarily far ahead of the device, so without them every interval's
    call site would fire within milliseconds — and they never idle the
    device: when a join returns, at least one interval of already-
    dispatched work is still queued. The checkpoint-attributable stall is
    therefore NOT the join wall (mostly waiting for the device to produce
    the factors, work a plain train does too) but the join time IN EXCESS
    of the writer's device-fetch wait — the host-I/O residue, accumulated
    in :attr:`wait_s` (the overlap evidence). The end-of-training join's
    full wall lands in :attr:`final_wait_s` (informational: it contains
    the last iteration's compute).

    Failure semantics: a failed save logs + counts
    ``oryx_checkpoint_save_failures_total`` and training continues; a
    failed restore logs and trains from scratch. Checkpointing degrades,
    never kills a generation."""

    def __init__(self, store: CheckpointStore, fp: str, interval: int,
                 meta: "dict | None" = None):
        self.store = store
        self.fingerprint = fp
        self.interval = max(1, int(interval))
        self.base_meta = dict(meta or {})
        self.resumed_step = 0
        self.wait_s = 0.0
        self.final_wait_s = 0.0
        self._pending: "threading.Thread | None" = None
        # device-fetch seconds of the pending write, recorded by the
        # writer thread; read only after join (happens-before via join)
        self._pending_fetch_s = 0.0
        # the writer's side stream on each card, reused save after save
        self._streams: dict = {}

    # -- resume ---------------------------------------------------------------
    def restore(self) -> "Checkpoint | None":
        """Newest valid checkpoint for this fingerprint, or None (from
        scratch). Load failures — including injected ``ckpt.load`` faults —
        degrade to a fresh start, never an exception. The resume is only
        COUNTED once the trainer accepts the state (:meth:`mark_resumed`):
        a candidate the shape guard rejects must not read as a resume in
        the metrics or the log."""
        try:
            return self.store.load_latest(self.fingerprint)
        except Exception:  # noqa: BLE001 — resume must degrade, not kill
            log.warning(
                "checkpoint restore failed; training from scratch",
                exc_info=True,
            )
            return None

    def mark_resumed(self, step: int) -> None:
        """The trainer accepted a restored checkpoint: record the step,
        count the resume, say so."""
        self.resumed_step = int(step)
        _RESUMES.inc()
        log.info(
            "resuming training from checkpoint step %d (%s)",
            step, self.fingerprint,
        )

    # -- save -----------------------------------------------------------------
    def wants(self, completed: int, total: int) -> bool:
        """Checkpoint after this iteration? Every ``interval`` iterations,
        plus the final one (so a crash between train end and publish costs
        zero redone iterations on resume)."""
        return completed == total or completed % self.interval == 0

    def submit(self, completed: int, arrays: dict,
               extra_meta: "dict | None" = None) -> None:
        """Queue one async save of ``arrays`` (torch tensors or numpy;
        fetched on the writer thread so the device→host copy overlaps
        device compute). A CUDA tensor is saved as it stands when this
        call is made: the caller must not write into it afterwards (the
        ALS trainer never does; each half-iteration makes new factors).
        Joins the previous write first; only the join's excess over that
        write's device-fetch time counts as checkpoint stall (wait_s)."""
        joined = self._join_pending()
        ready = _record_ready(arrays)
        self.wait_s += max(0.0, joined - self._pending_fetch_s)
        meta = dict(self.base_meta)
        meta.update(extra_meta or {})
        meta["completed"] = int(completed)
        meta["resumed_from"] = int(self.resumed_step)
        t = threading.Thread(
            target=self._write, args=(completed, dict(arrays), ready, meta),
            name="oryx-ckpt-write", daemon=True,
        )
        self._pending = t
        t.start()

    def _write(self, completed: int, arrays: dict, ready: dict,
               meta: dict) -> None:
        try:
            t0 = time.perf_counter()
            host = _fetch(arrays, ready, self._streams)
            self._pending_fetch_s = time.perf_counter() - t0
            self.store.save(self.fingerprint, completed, host, meta)
        except Exception as e:  # noqa: BLE001 — saves degrade, never kill training
            _SAVE_FAILURES.inc()
            blackbox.record_event(
                "ckpt.save_failure", severity="error", throttle_sec=1.0,
                step=completed, error=f"{type(e).__name__}: {e}",
            )
            log.warning(
                "checkpoint save at step %d failed; training continues "
                "without it", completed, exc_info=True,
            )

    def _join_pending(self) -> float:
        dt = 0.0
        if self._pending is not None:
            t0 = time.perf_counter()
            self._pending.join()
            dt = time.perf_counter() - t0
            self._pending = None
        return dt

    def finish(self) -> float:
        """Join the in-flight (usually final) write; its time is recorded
        as :attr:`final_wait_s`, not mid-train wait. Returns ``wait_s``."""
        self.final_wait_s += self._join_pending()
        return self.wait_s


def _cuda_tensors(arrays: dict) -> dict:
    """``{device: [name, ...]}`` for the arrays that are CUDA tensors. Torch
    is looked up, not imported: with torch not loaded nothing can be one."""
    torch = sys.modules.get("torch")
    out: dict = {}
    if torch is None:
        return out
    for name, v in arrays.items():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            out.setdefault(v.device, []).append(name)
    return out


def _record_ready(arrays: dict) -> dict:
    """``{device: event}``: an event recorded on each card's current stream
    at submit, after the work that produced the arrays and before any work
    dispatched later."""
    out = {}
    for dev in _cuda_tensors(arrays):
        ev = out[dev] = sys.modules["torch"].cuda.Event()
        ev.record(sys.modules["torch"].cuda.current_stream(dev))
    return out


def _fetch(arrays: dict, ready: dict, streams: dict) -> dict:
    """Host numpy copies of ``arrays``. A CUDA tensor is copied on a side
    stream of its card (``streams``) that waits only on its ``ready``
    event, and only that stream is synchronised: the fetch does not wait
    for the work the caller's stream queued after the submit. The copy
    goes to pageable memory: allocating page-locked memory would
    synchronise the card with every stream, the caller's queued work
    included."""
    torch = sys.modules.get("torch")
    out = {}
    for dev, names in _cuda_tensors(arrays).items():
        side = streams.get(dev)
        if side is None:
            side = streams[dev] = torch.cuda.Stream(device=dev)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            side.wait_event(ready[dev])
            for name in names:
                # a blocking copy on the side stream: it synchronises that
                # stream alone
                out[name] = arrays[name].to("cpu").numpy()
    for name, v in arrays.items():
        if name in out:
            continue
        if torch is not None and isinstance(v, torch.Tensor):
            out[name] = v.detach().numpy()
        else:
            out[name] = np.asarray(v)
    return out


def enabled(config) -> bool:
    """Cheap pre-check so callers skip fingerprint work (an O(nnz) data
    CRC) entirely when checkpointing is off — the default."""
    c = config.get_config("oryx.batch.checkpoint")
    return bool(c.get_bool("enabled", False) and c.get_string("dir", None))


def from_config(config, fp: str,
                meta: "dict | None" = None) -> "TrainerCheckpointer | None":
    """``oryx.batch.checkpoint.*`` → a checkpointer, or None when disabled
    (enabled=false or no dir). The single construction path MLUpdate's
    candidate loop and any future trainer share."""
    c = config.get_config("oryx.batch.checkpoint")
    if not c.get_bool("enabled", False):
        return None
    root = c.get_string("dir", None)
    if not root:
        log.warning("oryx.batch.checkpoint.enabled with no dir; disabled")
        return None
    return TrainerCheckpointer(
        CheckpointStore(root, keep=c.get_int("keep", 2)),
        fp,
        c.get_int("interval-iterations", 5),
        meta=meta,
    )
