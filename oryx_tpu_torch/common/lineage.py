"""Model lineage, the publish side: provenance stamps on a batch publish.

The publish half of the JAX package's ``oryx_tpu/common/lineage.py`` (host
code, no JAX), held equal to it by ``tests/test_torch_mlupdate.py``:
:func:`mint_generation_id`, :func:`make_stamp`, :func:`parse_stamp`,
:func:`parse_watermark` and :class:`StampedProducer`.

- **Provenance stamps.** The batch tier attaches a structured stamp to
  every published MODEL/MODEL-REF message (generation id, the
  per-partition input offsets the generation consumed, an input
  watermark, train start/end, checkpoint fingerprint, resume/scratch
  origin, row counts), riding the KeyMessage headers path.
- **Watermark headers.** The speed tier stamps each fold-in "UP" delta
  with the offsets/watermark it incorporated (:func:`parse_watermark`
  reads them).

Not ported yet: the serving side, the per-replica ``LineageTracker`` with
its adoption timeline, freshness watermark and metrics (ROADMAP Queue 1,
item 7, tooling). The port's serving managers do not read the stamps.

Generation ids are minted from the trainer's checkpoint fingerprint when
there is one (``g`` + 12 hex chars), so a crash-restarted generation keeps
its identity. Without a fingerprint (always, in the port: checkpointing is
not ported) each publish mints a fresh unique id.
"""

from __future__ import annotations

import inspect
import json
import secrets
import time

#: Full provenance stamp (JSON), attached to MODEL / MODEL-REF messages.
PROVENANCE_HEADER = "x-oryx-provenance"
#: Bare generation id, attached to every message of a stamped publish
#: (the per-factor-row "UP" stream stays cheap: one short header, not
#: the full stamp repeated thousands of times).
GENERATION_HEADER = "x-oryx-generation"
#: Speed-tier fold-in watermark (JSON ``{"offsets": …, "watermark_ms": …}``).
WATERMARK_HEADER = "x-oryx-watermark"


def mint_generation_id(fingerprint: "str | None" = None,
                       timestamp_ms: "int | None" = None) -> str:
    """Stable id from a checkpoint fingerprint when there is one (the
    crash-restart contract above), else a fresh unique mint."""
    if fingerprint:
        return "g" + str(fingerprint)[:12]
    ts = timestamp_ms if timestamp_ms is not None else int(time.time() * 1000)
    return f"g{ts:x}-{secrets.token_hex(3)}"


def make_stamp(context, timestamp_ms: int, train_start_ms: int,
               train_end_ms: int, new_rows: int, past_rows: int) -> dict:
    """Assemble the provenance stamp for one batch publish from what the
    batch layer already recorded on the compute context (every context
    read is defensive: direct/test callers of ``run_update`` pass bare
    contexts with none of these set)."""
    fingerprint = getattr(context, "lineage_fingerprint", None)
    offsets = getattr(context, "input_offsets", None)
    stamp = {
        "generation": mint_generation_id(fingerprint, timestamp_ms),
        "fingerprint": fingerprint,
        "origin": getattr(context, "lineage_origin", None) or "scratch",
        "offsets": {str(p): int(o) for p, o in offsets.items()}
        if offsets else None,
        "watermark_ms": getattr(context, "input_watermark_ms", None),
        "max_event_ms": getattr(context, "input_max_event_ms", None),
        "train_start_ms": int(train_start_ms),
        "train_end_ms": int(train_end_ms),
        "published_ms": int(time.time() * 1000),
        "new_rows": int(new_rows),
        "past_rows": int(past_rows),
    }
    return stamp


def parse_stamp(headers: "dict | None") -> "dict | None":
    raw = (headers or {}).get(PROVENANCE_HEADER)
    if not raw:
        return None
    try:
        stamp = json.loads(raw)
    except (TypeError, ValueError):
        return None
    return stamp if isinstance(stamp, dict) else None


def parse_watermark(headers: "dict | None") -> "dict | None":
    raw = (headers or {}).get(WATERMARK_HEADER)
    if not raw:
        return None
    try:
        wm = json.loads(raw)
    except (TypeError, ValueError):
        return None
    return wm if isinstance(wm, dict) else None


class StampedProducer:
    """Producer proxy that stamps lineage headers onto every send of one
    batch publish: the full provenance stamp on MODEL/MODEL-REF, the bare
    generation id on everything else (the additional-model-data "UP"
    stream). Lets ``publish_additional_model_data`` hooks stay
    signature-compatible while their rows still carry provenance."""

    def __init__(self, producer, stamp: dict):
        self._producer = producer
        self.stamp = stamp
        self._gen_header = {GENERATION_HEADER: stamp["generation"]}
        self._model_headers = {
            GENERATION_HEADER: stamp["generation"],
            PROVENANCE_HEADER: json.dumps(stamp, separators=(",", ":")),
        }
        # test doubles and pre-lineage producers may expose a bare
        # send(key, message) — publish still works there, just unstamped
        try:
            params = inspect.signature(producer.send).parameters
            self._takes_headers = "headers" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()
            )
        except (TypeError, ValueError):
            self._takes_headers = True

    def send(self, key, message, headers: "dict | None" = None):
        if not self._takes_headers:
            return self._producer.send(key, message)
        extra = (self._model_headers if key in ("MODEL", "MODEL-REF")
                 else self._gen_header)
        merged = dict(headers) if headers else {}
        merged.update(extra)
        return self._producer.send(key, message, headers=merged)

    def __getattr__(self, name):
        return getattr(self._producer, name)
