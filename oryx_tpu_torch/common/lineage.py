"""Model lineage: provenance stamps and the serving side's adoption timeline.

A copy of the JAX package's ``oryx_tpu/common/lineage.py`` (host code, no
JAX). The publish half (:func:`mint_generation_id`, :func:`make_stamp`,
:func:`parse_stamp`, :func:`parse_watermark`, :class:`StampedProducer`) is
held equal to it by ``tests/test_torch_mlupdate.py``, the serving half
(:class:`LineageTracker`, :func:`tracker`, :func:`configure`) by
``tests/test_torch_serving.py``.

- **Provenance stamps.** The batch tier attaches a structured stamp to
  every published MODEL/MODEL-REF message (generation id, the
  per-partition input offsets the generation consumed, an input
  watermark, train start/end, checkpoint fingerprint, resume/scratch
  origin, row counts), riding the KeyMessage headers path.
- **Watermark headers.** The speed tier stamps each fold-in "UP" delta
  with the offsets/watermark it incorporated, so the serving-side
  freshness watermark keeps advancing BETWEEN batch generations.
- **A per-replica :class:`LineageTracker`.** The serving update consumer
  feeds it; it records the publish → consume → warm → live → first-query
  adoption timeline per generation, computes the data-freshness
  watermark of what is actually serving, and backs the scrape-time
  gauges, the ``GET /lineage`` console endpoint, and the
  ``x-oryx-model-generation`` response header.

Generation ids are minted from the trainer's checkpoint fingerprint when
there is one (``g`` + 12 hex chars), so a crash-restarted generation keeps
its identity. Without a fingerprint (checkpointing off, the default) each
publish mints a fresh unique id.
"""

from __future__ import annotations

import inspect
import json
import secrets
import threading
import time

from oryx_tpu_torch.common import metrics as metrics_mod

#: Full provenance stamp (JSON), attached to MODEL / MODEL-REF messages.
PROVENANCE_HEADER = "x-oryx-provenance"
#: Bare generation id, attached to every message of a stamped publish
#: (the per-factor-row "UP" stream stays cheap: one short header, not
#: the full stamp repeated thousands of times).
GENERATION_HEADER = "x-oryx-generation"
#: Speed-tier fold-in watermark (JSON ``{"offsets": …, "watermark_ms": …}``).
WATERMARK_HEADER = "x-oryx-watermark"

_FRESHNESS = metrics_mod.default_registry().gauge(
    "oryx_model_data_freshness_seconds",
    "Now minus the input-data watermark covered by the live model plus "
    "consumed speed deltas (-1 until a stamped generation is live; "
    "scrape-time)",
)
_ADOPTION_LAG = metrics_mod.default_registry().gauge(
    "oryx_model_adoption_lag_seconds",
    "Publish-to-live adoption lag of the newest model generation; grows "
    "live while a consumed generation is still staged/warming (-1 before "
    "any generation was consumed; scrape-time)",
)
_GENERATION_INFO = metrics_mod.default_registry().gauge(
    "oryx_model_generation_info",
    "Publish unix time (seconds) of the LIVE model generation, on labels "
    "naming it — values are orderable across replicas, which is what the "
    "fleet table's generation-skew highlighting compares",
    ("generation", "fingerprint"),
)


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


def _find_record(generations: "list[dict]", gen_id: "str | None") -> "dict | None":
    """Newest record with this id; caller holds the tracker lock (state is
    passed in explicitly rather than read off the instance)."""
    if gen_id is None:
        return None
    return next((g for g in reversed(generations)
                 if g["generation"] == gen_id), None)


def _newest_record(generations: "list[dict]") -> "dict | None":
    """Last-consumed record; caller holds the tracker lock."""
    return generations[-1] if generations else None


def _set_info_gauge(generations: "list[dict]", rec: dict,
                    previous: "str | None") -> None:
    """Flip the generation-info gauge to the newly-live generation and zero
    the previous one; caller holds the tracker lock."""
    stamp = rec["stamp"] or {}
    published = stamp.get("published_ms")
    value = (published / 1000.0 if isinstance(published, (int, float))
             else rec["live_at"])
    fingerprint = stamp.get("fingerprint") or ""
    _GENERATION_INFO.labels(rec["generation"], fingerprint).set(value)
    if previous is not None and previous != rec["generation"]:
        old = _find_record(generations, previous)
        old_fp = ((old or {}).get("stamp") or {}).get("fingerprint") or ""
        _GENERATION_INFO.labels(previous, old_fp).set(0.0)


class LineageTracker:
    """Per-replica adoption timeline + freshness watermark.

    Fed by the serving update consumer (one writer thread) and read by
    scrape callbacks, the console endpoint and the request middleware;
    every access takes the tracker lock (uncontended in steady state —
    one writer, short critical sections)."""

    def __init__(self, history: int = 8):
        self._lock = threading.Lock()
        self._history = max(1, int(history))
        self._generations: "list[dict]" = []  # oldest → newest
        self._anon_count = 0
        self._live_id: "str | None" = None
        self._live_first_query_done = False
        self._watermark_ms: "float | None" = None
        self._delta = {"count": 0, "offsets": None, "watermark_ms": None}
        self._last_adoption_lag: "float | None" = None

    # -- consume-side transitions (serving update-consumer thread) --------

    def model_consumed(self, key: str, headers: "dict | None") -> str:
        """A MODEL/MODEL-REF arrived: open its adoption record. Unstamped
        models (direct test publishes, pre-lineage producers) still get a
        synthetic ``anon-N`` id so the timeline and the response header
        stay meaningful — full attributability needs the stamp."""
        stamp = parse_stamp(headers)
        now = time.time()
        with self._lock:
            if stamp is None:
                self._anon_count += 1
                gen_id = f"anon-{self._anon_count}"
            else:
                gen_id = str(stamp.get("generation") or "")
                existing = _find_record(self._generations, gen_id)
                if existing is not None:
                    # replay (consumer restart from earliest): refresh the
                    # consume time, keep the record
                    existing["consumed_at"] = now
                    return gen_id
            self._generations.append({
                "generation": gen_id,
                "stamp": stamp,
                "consumed_at": now,
                "staged_at": None,
                "warmed_at": None,
                "live_at": None,
                "first_query_at": None,
                "status": "consumed",
            })
            del self._generations[:-max(self._history, 2)]
        return gen_id

    def delta_consumed(self, headers: "dict | None") -> None:
        """A fold-in delta arrived: advance the freshness watermark with
        the offsets/watermark the speed tier stamped on it."""
        wm = parse_watermark(headers)
        if wm is None:
            return
        with self._lock:
            self._delta["count"] += 1
            offsets = wm.get("offsets")
            if isinstance(offsets, dict):
                self._delta["offsets"] = offsets
            watermark = wm.get("watermark_ms")
            if isinstance(watermark, (int, float)):
                self._delta["watermark_ms"] = float(watermark)
                self._advance_watermark(float(watermark))

    def mark_staged(self, gen_id: "str | None" = None) -> None:
        with self._lock:
            rec = (_find_record(self._generations, gen_id)
                   or _newest_record(self._generations))
            if rec is not None and rec["live_at"] is None:
                rec["staged_at"] = rec["staged_at"] or time.time()
                rec["status"] = "staged"

    def mark_warmed(self, gen_id: "str | None" = None) -> None:
        with self._lock:
            rec = (_find_record(self._generations, gen_id)
                   or _newest_record(self._generations))
            if rec is not None and rec["warmed_at"] is None:
                rec["warmed_at"] = time.time()
                if rec["live_at"] is None:
                    rec["status"] = "warmed"

    def mark_live(self, gen_id: "str | None" = None) -> None:
        """A generation went into service (in-place consume, prewarmed
        promote, or deadline promote). Idempotent per generation — the
        warmer and the deadline valve can both report the same flip."""
        from oryx_tpu_torch.common import blackbox

        event = None
        with self._lock:
            rec = (_find_record(self._generations, gen_id)
                   or _newest_record(self._generations))
            if rec is None or rec["live_at"] is not None:
                return
            now = time.time()
            rec["live_at"] = now
            rec["status"] = "live"
            lag = now - rec["consumed_at"]
            stamp = rec["stamp"]
            if stamp:
                published = stamp.get("published_ms")
                if isinstance(published, (int, float)):
                    lag = max(lag, now - published / 1000.0)
                watermark = stamp.get("watermark_ms")
                if isinstance(watermark, (int, float)):
                    self._advance_watermark(float(watermark))
            self._last_adoption_lag = lag
            previous = self._live_id
            self._live_id = rec["generation"]
            self._live_first_query_done = False
            _set_info_gauge(self._generations, rec, previous)
            event = {
                "generation": rec["generation"],
                "origin": (stamp or {}).get("origin"),
                "adoption_lag_sec": round(lag, 3),
                "freshness_sec": self._freshness_locked(),
            }
        if event is not None:
            blackbox.record_event("model.adopted", **event)

    # -- query-side (request middleware, hot path) ------------------------

    def note_query(self) -> "str | None":
        """The live generation id for the response header; records the
        generation's first served query on the way through. One uncontended
        lock acquire per request — the same budget the request counters
        already pay per event."""
        with self._lock:
            live = self._live_id
            if live is None or self._live_first_query_done:
                return live
            rec = _find_record(self._generations, live)
            if rec is not None and rec["first_query_at"] is None:
                rec["first_query_at"] = time.time()
            self._live_first_query_done = True
            return live

    # -- reads ------------------------------------------------------------

    def live_generation(self) -> "str | None":
        with self._lock:
            return self._live_id

    def watermark_ms(self) -> "float | None":
        with self._lock:
            return self._watermark_ms

    def freshness_seconds(self) -> float:
        """Now minus the covered-data watermark; -1 until one is known
        (no stamped generation live yet)."""
        with self._lock:
            f = self._freshness_locked()
        return -1.0 if f is None else f

    def adoption_lag_seconds(self) -> float:
        """Live while a consumed generation is not yet serving (now minus
        its consume time — a wedged warm ladder GROWS this), else the
        last completed adoption's lag; -1 before any consume."""
        with self._lock:
            newest = _newest_record(self._generations)
            if newest is not None and newest["live_at"] is None:
                return time.time() - newest["consumed_at"]
            if self._last_adoption_lag is not None:
                return self._last_adoption_lag
        return -1.0

    def snapshot(self) -> dict:
        """The ``GET /lineage`` payload: live + staged + history records,
        the delta watermark, and the derived freshness numbers."""
        with self._lock:
            gens = [dict(g) for g in self._generations]
            live = next((g for g in gens
                         if g["generation"] == self._live_id), None)
            staged = next(
                (g for g in reversed(gens)
                 if g["live_at"] is None and g is not live), None,
            )
            return {
                "live": live,
                "staged": staged,
                "generations": gens,
                "delta": dict(self._delta),
                "watermark_ms": self._watermark_ms,
                "freshness_seconds": self._freshness_locked(),
                "adoption_lag_seconds": self._last_adoption_lag,
            }

    # -- internals (callers hold self._lock) ------------------------------

    def _advance_watermark(self, watermark_ms: float) -> None:
        if self._watermark_ms is None or watermark_ms > self._watermark_ms:
            self._watermark_ms = watermark_ms

    def _freshness_locked(self) -> "float | None":
        if self._watermark_ms is None:
            return None
        return max(0.0, time.time() - self._watermark_ms / 1000.0)



_TRACKER: "LineageTracker | None" = None
_ENABLED = True
_configure_lock = threading.Lock()


def tracker() -> LineageTracker:
    """The process tracker. Lock-free on purpose: this sits on the request
    middleware's path inside the event loop, where a lock acquire would be
    a loop stall. ``configure()`` installs the real tracker at app startup
    (before traffic); the lazy branch only serves managers constructed
    outside a configured serving layer (tests, direct use), where a lost
    duplicate from a racing first call is benign — the global read/assign
    is a single atomic store either way."""
    global _TRACKER
    t = _TRACKER
    if t is None:
        t = LineageTracker()
        _wire_gauges(t)
        _TRACKER = t
    return t


def enabled() -> bool:
    return _ENABLED


def freshness_seconds() -> "float | None":
    """Module-level convenience for the SLO reader and the lag gauge:
    None while no watermark is known (distinct from 0 = perfectly fresh)."""
    t = _TRACKER
    if t is None:
        return None
    f = t.freshness_seconds()
    return None if f < 0 else f


def _wire_gauges(t: LineageTracker) -> None:
    _FRESHNESS.set_function(t.freshness_seconds)
    _ADOPTION_LAG.set_function(t.adoption_lag_seconds)


def configure(config) -> "LineageTracker | None":
    """Fresh tracker from ``oryx.lineage.*`` (idempotent per make_app,
    like metrics/slo configure). Disabling keeps a no-op tracker wired so
    call sites stay unconditional; the gauges then report -1/-1."""
    global _TRACKER, _ENABLED
    with _configure_lock:
        _ENABLED = config.get_bool("oryx.lineage.enabled", True)
        history = config.get_int("oryx.lineage.history", 8)
        _TRACKER = LineageTracker(history=history)
        _wire_gauges(_TRACKER)
        return _TRACKER
