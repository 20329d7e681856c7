"""Data/model store: timestamped segments on a filesystem.

A copy of the JAX package's ``oryx_tpu/store/datastore.py`` (host code, no
JAX), held equal to it by ``tests/test_torch_mlupdate.py``. Below, "the
reference" is the original Oryx that module was modelled on.

Replacement for the reference's HDFS layout
(lambda/batch/SaveToHDFSFunction.java, BatchUpdateFunction.java:103-130,
lambda/DeleteOldDataFn.java, ml/MLUpdate.java:191-207):

  * each batch interval's new data is persisted as a timestamped segment dir
    ``oryx-<millis>.data/part-00000.jsonl`` (skipping empty intervals to avoid
    small files);
  * past data is re-read by globbing ``*/part-*`` across all segments;
  * models live in timestamped dirs ``<model-dir>/<millis>/model.pmml`` plus
    side data (ALS X/ Y/ factor part-files);
  * TTL GC deletes segments/models older than max-age-hours.

Local paths work single-host; pointing data-dir/model-dir at a shared/network
filesystem gives the multi-host layout the reference gets from HDFS.
"""

from __future__ import annotations

import json
import re
import time
from pathlib import Path
from typing import Iterator

from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import ioutils

_DATA_SEGMENT_RE = re.compile(r"oryx-(\d+)\.data")
_MODEL_DIR_RE = re.compile(r"(\d+)")


def _delete_older_than(
    dirs, timestamp_of, max_age_hours: int, now_ms: "int | None"
) -> list[Path]:
    """Shared TTL-GC policy (DeleteOldDataFn.java); max_age_hours < 0 disables."""
    if max_age_hours < 0:
        return []
    now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
    cutoff = now_ms - max_age_hours * 3600 * 1000
    deleted = []
    for d in dirs:
        ts = timestamp_of(d)
        if ts is not None and ts < cutoff:
            ioutils.delete_recursively(d)
            deleted.append(d)
    return deleted


class DataStore:
    """Append/read/GC of timestamped data segments under one data-dir."""

    def __init__(self, data_dir: str):
        self._dir = Path(_strip_scheme(data_dir))

    @property
    def path(self) -> Path:
        return self._dir

    def write_segment(self, timestamp_ms: int, data: "list[KeyMessage]") -> Path | None:
        """Persist one interval's data; returns the segment dir or None if empty
        (SaveToHDFSFunction skips empty RDDs)."""
        if not data:
            return None
        seg = self._dir / f"oryx-{timestamp_ms}.data"
        ioutils.mkdirs(seg)
        part = seg / "part-00000.jsonl"
        with open(part, "w", encoding="utf-8") as f:
            for km in data:
                f.write(json.dumps({"k": km.key, "m": km.message}, separators=(",", ":")) + "\n")
        return seg

    def read_all(self) -> Iterator[KeyMessage]:
        """Glob `*/part-*` over all segments — the pastData read
        (BatchUpdateFunction.java:103-130)."""
        if not self._dir.exists():
            return
        for seg in sorted(self._dir.glob("oryx-*.data")):
            for part in sorted(seg.glob("part-*")):
                with open(part, "r", encoding="utf-8") as f:
                    for line in f:
                        if line.strip():
                            d = json.loads(line)
                            yield KeyMessage(d["k"], d["m"])

    def segments(self) -> list[Path]:
        return sorted(self._dir.glob("oryx-*.data")) if self._dir.exists() else []

    def delete_older_than(self, max_age_hours: int, now_ms: int | None = None) -> list[Path]:
        def ts_of(seg: Path):
            m = _DATA_SEGMENT_RE.fullmatch(seg.name)
            return int(m.group(1)) if m else None

        return _delete_older_than(self.segments(), ts_of, max_age_hours, now_ms)


class ModelStore:
    """Timestamped model dirs under one model-dir (MLUpdate.java:191-207)."""

    def __init__(self, model_dir: str):
        self._dir = Path(_strip_scheme(model_dir))

    @property
    def path(self) -> Path:
        return self._dir

    def new_model_dir(self, timestamp_ms: int) -> Path:
        d = self._dir / str(timestamp_ms)
        ioutils.mkdirs(d)
        return d

    def promote(self, candidate_dir: Path, timestamp_ms: int) -> Path:
        """Move the winning candidate into place (MLUpdate.java:201-207).
        shutil.move handles candidates on a different filesystem than the
        model dir (tmpfs scratch → shared storage)."""
        import shutil

        dest = self._dir / str(timestamp_ms)
        ioutils.mkdirs(dest.parent)
        shutil.move(str(candidate_dir), str(dest))
        return dest

    def model_dirs(self) -> list[Path]:
        if not self._dir.exists():
            return []
        return sorted(
            (d for d in self._dir.iterdir() if d.is_dir() and _MODEL_DIR_RE.fullmatch(d.name)),
            key=lambda d: int(d.name),
        )

    def latest(self) -> Path | None:
        dirs = self.model_dirs()
        return dirs[-1] if dirs else None

    def delete_older_than(self, max_age_hours: int, now_ms: int | None = None) -> list[Path]:
        return _delete_older_than(
            self.model_dirs(), lambda d: int(d.name), max_age_hours, now_ms
        )


def _strip_scheme(path: str) -> str:
    if path.startswith("file:"):
        return path[len("file:"):]
    return path
