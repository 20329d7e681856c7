"""Black-box flight recorder: a bounded ring of structured operational
events plus a one-file JSON postmortem bundle.

A copy of the JAX package's ``oryx_tpu/common/blackbox.py`` (host code, no
JAX). Its versions name ``oryx_tpu_torch`` and torch; its ``memory``
section is ``profiling.memory_snapshot()`` (host RSS, and each card's
allocated, peak and total bytes once the process has initialised CUDA).

The framework survives faults (retries, quarantine, breaker, supervised
restarts, torn-tail recovery), but a counter alone does not explain one —
when a replica is ``kill -9``'d its metrics, traces, and breaker history
die with it, and the on-call human reconstructs the incident from nothing.
This module is the flight recorder:

  * **event ring** — resilience sites call :func:`record_event` when
    something operationally interesting happens (breaker transition,
    quarantine, shed, consumer restart, torn-tail recovery, checkpoint
    save failure, SLO alert edge, model-generation swap), each event
    carrying the current trace id where one exists. The ring is BOUNDED
    (``oryx.blackbox.ring-size``): when full, the oldest event is evicted
    and counted in ``oryx_blackbox_events_dropped_total`` — the recorder
    can never grow a dying process's heap.
  * **bundle** — :func:`bundle` assembles ONE JSON artifact: the event
    ring, a metrics-registry snapshot, the slowest traces per route, the
    (redacted) config, device/host memory, SLO status, and versions.
    ``GET /debug/bundle`` (serving/resources/common.py) serves it live.
  * **auto-dump** — with ``oryx.blackbox.dump-dir`` set, the bundle is
    written to disk on SIGTERM, on dump-worthy event edges (breaker open,
    quarantine), and on a periodic flight-recorder tick
    (``dump-interval-sec``), so even a ``kill -9``'d replica leaves a
    bundle at most one tick stale. Dumps are atomic, rate-limited
    (``dump-min-interval-sec``), and GC'd to ``keep`` files per process.

Emission is cheap by construction: one lock acquire + one deque append per
event (gated ≤1% of a smoke device call next to the span/sanitizer gates in
tests/test_load_benchmark.py); the bundle/dump cost is paid by the reader
or the background dumper thread, never by the emitting hot path.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
import time
from collections import deque

from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import spans

log = logging.getLogger(__name__)

_EVENTS_TOTAL = metrics_mod.default_registry().counter(
    "oryx_blackbox_events_total",
    "Structured operational events recorded in the flight-recorder ring",
    ("kind",),
)
_DROPPED = metrics_mod.default_registry().counter(
    "oryx_blackbox_events_dropped_total",
    "Events evicted from the bounded flight-recorder ring (oldest first)",
)
_DUMPS = metrics_mod.default_registry().counter(
    "oryx_blackbox_dumps_total",
    "Flight-recorder bundles written to oryx.blackbox.dump-dir, by trigger",
    ("reason",),
)

#: Attribute values are truncated to this many characters so one enormous
#: exception repr cannot make the bounded ring unbounded in bytes.
_MAX_ATTR_CHARS = 400


class EventRing:
    """Bounded ring of event dicts; evictions are counted, never silent."""

    def __init__(self, size: int = 512):
        self._lock = threading.Lock()
        self._size = max(16, int(size))
        self._events: deque = deque()
        # kind -> (monotonic time of last kept event, that event dict):
        # the throttle state for high-volume kinds (sheds under overload)
        self._last_of_kind: dict[str, tuple] = {}

    def resize(self, size: int) -> None:
        with self._lock:
            self._size = max(16, int(size))
            while len(self._events) > self._size:
                self._events.popleft()
                _DROPPED.inc()

    def record(self, event: dict, throttle_sec: float = 0.0,
               throttle_key: "str | None" = None) -> bool:
        """Append one event; returns False when it was coalesced into the
        previous same-key event by the throttle window (its ``suppressed``
        count bumps instead — a shed storm is one event with a count, not
        a ring full of identical lines). The throttle key defaults to the
        kind; sites whose events differ meaningfully by an attribute (a
        retry site name) pass a finer key so distinct stories never
        coalesce."""
        kind = event["kind"]
        key = throttle_key or kind
        now = time.monotonic()
        with self._lock:
            if throttle_sec > 0.0:
                last = self._last_of_kind.get(key)
                if last is not None and now - last[0] < throttle_sec:
                    last[1]["suppressed"] = last[1].get("suppressed", 0) + 1
                    return False
            if len(self._events) >= self._size:
                self._events.popleft()
                _DROPPED.inc()
            self._events.append(event)
            self._last_of_kind[key] = (now, event)
        _EVENTS_TOTAL.labels(kind).inc()
        return True

    def snapshot(self, limit: "int | None" = None) -> list:
        """COPIES of the events: the throttle path keeps mutating the last
        event of each kind (its ``suppressed`` count), and handing out the
        live dicts would let a bundle's json serialization race a
        concurrent first-key insertion (dict-changed-size mid-iteration —
        precisely during the overload the recorder exists to capture)."""
        with self._lock:
            events = [dict(e) for e in self._events]
        return events[-limit:] if limit else events

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._last_of_kind.clear()


class _State:
    """Process-wide recorder state shaped by :func:`configure`."""

    def __init__(self):
        self.ring = EventRing()
        self.dump_dir: "str | None" = None
        self.dump_interval_sec = 60.0
        self.dump_min_interval_sec = 5.0
        self.keep = 8
        self.oryx_id: "str | None" = None
        self.config_props: "dict | None" = None
        self.last_dump_path: "str | None" = None
        self._last_dump_mono = 0.0
        # RLock: a SIGTERM handler runs on the main thread between
        # bytecodes, so a second SIGTERM landing while the first handler's
        # dump holds this lock would deadlock the process on a plain Lock
        self._dump_lock = threading.RLock()
        self._wake = threading.Event()
        self._pending_reason: "str | None" = None
        self._pending_history: "dict | None" = None
        self._dumper: "threading.Thread | None" = None
        self._sigterm_installed = False


_STATE = _State()


def ring() -> EventRing:
    return _STATE.ring


def record_event(kind: str, severity: str = "info", dump: bool = False,
                 throttle_sec: float = 0.0,
                 throttle_key: "str | None" = None, **attrs) -> None:
    """The hot-path hook: one bounded append. ``dump=True`` additionally
    wakes the background dumper (breaker-open / quarantine edges — the
    moments a postmortem will ask about); a same-key event inside
    ``throttle_sec`` coalesces into the previous one's ``suppressed``
    count instead of occupying a ring slot."""
    event: dict = {
        "ts": round(time.time(), 3),
        "kind": kind,
        "severity": severity,
    }
    trace_id = spans.current_trace_id()
    if trace_id:
        event["trace_id"] = trace_id
    for key, value in attrs.items():
        if value is None:
            continue
        if not isinstance(value, (int, float, bool)):
            value = str(value)[:_MAX_ATTR_CHARS]
        event[key] = value
    _STATE.ring.record(event, throttle_sec=throttle_sec,
                       throttle_key=throttle_key)
    if dump:
        trigger_dump(kind)


def events(limit: "int | None" = None) -> list:
    return _STATE.ring.snapshot(limit)


def _redacted_props(config) -> dict:
    out = {}
    for key, value in config.to_properties().items():
        low = key.lower()
        if "password" in low or "secret" in low:
            value = "*****"
        out[key] = value
    return out


def bundle(reason: str = "on-demand", history: "dict | None" = None) -> dict:
    """The one-call postmortem artifact: everything an on-call human wants
    from a dead (or misbehaving) replica, as a single JSON-able dict. Each
    section degrades independently — a broken gauge callback must never
    cost the event ring."""
    out: dict = {
        "reason": reason,
        "generated_at": round(time.time(), 3),
        "oryx_id": _STATE.oryx_id,
        "pid": os.getpid(),
        "versions": {
            "python": sys.version.split()[0],
        },
        "events": _STATE.ring.snapshot(),
    }
    try:
        import oryx_tpu_torch

        out["versions"]["oryx_tpu_torch"] = oryx_tpu_torch.__version__
    except Exception:  # noqa: BLE001 — versions are best-effort decoration
        pass
    torch = sys.modules.get("torch")
    if torch is not None:
        out["versions"]["torch"] = getattr(torch, "__version__", "?")
    try:
        out["metrics"] = metrics_mod.default_registry().snapshot()
    except Exception as e:  # noqa: BLE001 — a scrape bug must not kill the dump
        out["metrics_error"] = str(e)
    try:
        out["slowest_traces"] = {
            route: [s.to_dict() for s in kept]
            for route, kept in sorted(spans.default_recorder().slowest(3).items())
        }
    except Exception as e:  # noqa: BLE001
        out["traces_error"] = str(e)
    try:
        from oryx_tpu_torch.common import profiling

        out["memory"] = profiling.memory_snapshot()
    except Exception as e:  # noqa: BLE001
        out["memory_error"] = str(e)
    try:
        from oryx_tpu_torch.common import slo

        out["slo"] = slo.status()
    except Exception as e:  # noqa: BLE001
        out["slo_error"] = str(e)
    # pre-incident time series (common/tsdb.py): minutes of context for the
    # curated signals instead of one snapshot. ``history`` carries a window
    # captured at TRIGGER time (deferred edge dumps); live pulls read the
    # rings now. Omitted entirely while the tsdb engine is disabled.
    try:
        if history is None:
            from oryx_tpu_torch.common import tsdb

            history = tsdb.incident_window()
        if history is not None:
            out["history"] = history
    except Exception as e:  # noqa: BLE001
        out["history_error"] = str(e)
    if _STATE.config_props is not None:
        out["config"] = _STATE.config_props
    return out


def dump(reason: str, force: bool = False,
         history: "dict | None" = None) -> "str | None":
    """Write one bundle to ``dump-dir`` (atomic tmp+rename via ioutils) and
    GC old dumps down to ``keep``. Rate-limited by ``dump-min-interval-sec``
    unless ``force`` (SIGTERM is forced: the last words must land). Returns
    the path, or None when disabled/limited/failed — dumping degrades, it
    never raises into the caller."""
    dump_dir = _STATE.dump_dir
    if not dump_dir:
        return None
    with _STATE._dump_lock:
        now = time.monotonic()
        if not force and now - _STATE._last_dump_mono < _STATE.dump_min_interval_sec:
            return None
        _STATE._last_dump_mono = now
        tag = _STATE.oryx_id or f"pid{os.getpid()}"
        name = f"blackbox-{tag}-{int(time.time() * 1000)}-{reason}.json"
        path = os.path.join(dump_dir, name)
        try:
            from oryx_tpu_torch.common import ioutils

            os.makedirs(dump_dir, exist_ok=True)
            ioutils.atomic_write_text(
                path, json.dumps(bundle(reason, history=history))
            )
            _STATE.last_dump_path = path
            _DUMPS.labels(reason).inc()
            self_prefix = f"blackbox-{tag}-"
            mine = sorted(
                f for f in os.listdir(dump_dir)
                if f.startswith(self_prefix) and f.endswith(".json")
            )
            for stale in mine[:-max(1, _STATE.keep)]:
                try:
                    os.unlink(os.path.join(dump_dir, stale))
                except OSError:
                    pass
            return path
        except Exception:  # noqa: BLE001 — a full disk must not kill the layer
            log.warning("flight-recorder dump to %s failed", dump_dir,
                        exc_info=True)
            return None


def trigger_dump(reason: str) -> None:
    """Ask the background dumper for a dump (non-blocking; no-op without a
    dump-dir). Edge sites call this from under their own locks, so the
    file I/O must happen on the dumper thread, never inline. The series
    window is captured HERE, at trigger time — a dump deferred past the
    rate window must still carry the pre-incident context, not a snapshot
    diluted by the wait (tsdb.incident_window takes only leaf ring locks,
    so it is as safe under an edge site's lock as the flag-set itself)."""
    if not _STATE.dump_dir:
        return
    try:
        from oryx_tpu_torch.common import tsdb

        _STATE._pending_history = tsdb.incident_window()
    except Exception:  # noqa: BLE001 — context is decoration, never a veto
        _STATE._pending_history = None
    _STATE._pending_reason = reason
    _STATE._wake.set()


def _dumper_loop() -> None:
    deferred: "tuple[str, dict | None] | None" = None
    while True:
        interval = _STATE.dump_interval_sec
        if deferred is not None:
            # an edge dump is waiting out the rate window: retry on a
            # short cadence instead of the full periodic interval
            timeout = max(0.25, _STATE.dump_min_interval_sec / 4.0)
        else:
            timeout = interval if interval > 0 else 3600.0
        _STATE._wake.wait(timeout)
        # clear FIRST, then take the pending reason: a trigger landing
        # between the two re-sets the flag (at worst one spurious extra
        # wake), whereas the reverse order could consume a just-armed
        # edge dump without acting on it
        _STATE._wake.clear()
        reason, _STATE._pending_reason = _STATE._pending_reason, None
        history, _STATE._pending_history = _STATE._pending_history, None
        if reason is None and deferred is not None:
            # retrying a deferred edge dump: keep its TRIGGER-time series
            # window, not a fresh one — the incident context must not be
            # diluted by however long the rate limiter made it wait
            reason, history = deferred
        deferred = None
        if reason is not None:
            if dump(reason, history=history) is None and _STATE.dump_dir:
                # rate-limited (or a failed write): DEFER the edge dump,
                # never drop it — a breaker-open bundle must still land
                # even when it fired right after the startup dump, and a
                # kill before the next periodic tick must not erase it
                deferred = (reason, history)
        elif interval > 0:
            dump("interval")


def _install_sigterm() -> None:
    """Chain a dump in front of whatever SIGTERM behavior the process has
    (the CLI installs its sys.exit handler BEFORE constructing the layer,
    so the chain preserves it). Only the main thread may set handlers —
    configure() from a worker thread just skips this."""
    if _STATE._sigterm_installed:
        return
    if threading.current_thread() is not threading.main_thread():
        return
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            # dump on a FRESH thread with a bounded join, never inline: the
            # handler interrupts the main thread between bytecodes, and an
            # inline bundle() would re-acquire whatever non-reentrant lock
            # (event ring, a metrics family) the interrupted frame already
            # holds — a self-deadlock that turns graceful shutdown into a
            # hang. If the dump thread blocks on such a lock, the join
            # times out and the process still exits (dump lost, exit kept).
            t = threading.Thread(
                target=dump, args=("sigterm", True),
                name="OryxBlackboxSigtermDump", daemon=True,
            )
            t.start()
            t.join(timeout=10)
            if callable(prev):
                prev(signum, frame)
            elif prev != signal.SIG_IGN:
                # SIG_DFL, or None (a handler installed by non-Python code
                # that getsignal() cannot represent): fall back to the
                # default action so SIGTERM still TERMINATES — a dump must
                # never leave the process signal-immune
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, handler)
        _STATE._sigterm_installed = True
    except (ValueError, OSError):  # non-main thread raced, or exotic platform
        pass


def configure(config) -> None:
    """Apply ``oryx.blackbox.*`` (the same configure() idiom as metrics/
    spans/resilience — every layer entry point calls it). Captures the
    redacted config for bundles, resizes the ring, and — when a dump-dir
    is set — starts the periodic dumper and chains the SIGTERM dump."""
    _STATE.ring.resize(config.get_int("oryx.blackbox.ring-size", 512))
    _STATE.dump_interval_sec = config.get_float(
        "oryx.blackbox.dump-interval-sec", 60.0
    )
    _STATE.dump_min_interval_sec = config.get_float(
        "oryx.blackbox.dump-min-interval-sec", 5.0
    )
    _STATE.keep = config.get_int("oryx.blackbox.keep", 8)
    _STATE.oryx_id = config.get_string("oryx.id", None)
    try:
        _STATE.config_props = _redacted_props(config)
    except Exception:  # noqa: BLE001 — decoration only
        _STATE.config_props = None
    _STATE.dump_dir = config.get_string("oryx.blackbox.dump-dir", None)
    if _STATE.dump_dir:
        _install_sigterm()
        if _STATE._dumper is None or not _STATE._dumper.is_alive():
            _STATE._dumper = threading.Thread(
                target=_dumper_loop, name="OryxBlackboxDumper", daemon=True
            )
            _STATE._dumper.start()
        # the first tick should not wait a whole interval: a replica that
        # dies young must still leave evidence
        trigger_dump("startup")


def reset_for_tests() -> None:
    """Clear ring + dump wiring (the dumper thread, if started, idles
    against a None dump-dir). Test isolation only."""
    _STATE.ring.clear()
    _STATE.dump_dir = None
    _STATE.oryx_id = None
    _STATE.config_props = None
    _STATE.last_dump_path = None
    _STATE._pending_reason = None
    _STATE._pending_history = None
    _STATE._last_dump_mono = 0.0
