"""Event-loop stall watchdog: dump the offending stack while the loop is
actually blocked.

The port of the JAX package's ``oryx_tpu/tools/sanitize/loop.py`` (stdlib
only), held to it by ``tests/test_torch_sanitize.py``. One change:
:func:`install` refuses, and returns False, when ``Handle._run`` is no
longer asyncio's own: another sanitizer (the JAX package's, which the test
suite installs first) already watches this process's event loops.

Below, the reference's text.

asyncio's own debug mode logs a slow callback AFTER it finishes — by then
the interesting stack is gone. This watchdog patches
``asyncio.events.Handle._run`` to stamp (thread, start time, callback
label) into a table on entry, and a single daemon thread samples the table:
any callback still running past the stall threshold gets its thread's LIVE
stack captured via ``sys._current_frames()`` — the exact line the loop is
wedged on, not a post-hoc summary. Completion also records a stall for
blockages that start and end between two watchdog samples, so short-but-
over-threshold stalls are never missed; the (thread, start-time) pair
dedups the two paths.

Overhead per callback: two dict writes and two ``monotonic()`` reads
(~1 µs), paid only while installed; the watchdog thread wakes 4× per
threshold period. Suspension (the ``no_sanitize`` marker) skips recording
but keeps the patch in place.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
import traceback
from collections import deque

from oryx_tpu_torch.tools.sanitize import locks as _locks

# -- GC pause accounting -----------------------------------------------------
# A cyclic-GC pass runs inline on whichever thread tripped the allocation
# threshold; under full-suite memory churn that is routinely a 300-500 ms
# pause INSIDE an innocent loop callback. Gating CI on those creates
# unfixable flakes, so the watchdog subtracts GC time overlapping a
# stall's window and only reports what the CODE spent. gc.callbacks run
# synchronously around each collection (GIL-serialized), so plain globals
# suffice.
_GC_WINDOWS: "deque[tuple[float, float]]" = deque(maxlen=64)
_gc_started: "float | None" = None


def _gc_callback(phase, info) -> None:
    global _gc_started
    if phase == "start":
        _gc_started = time.monotonic()
    elif _gc_started is not None:
        _GC_WINDOWS.append((_gc_started, time.monotonic()))
        _gc_started = None


def _gc_overlap_ms(t0: float, t1: float) -> float:
    """GC pause time (ms) overlapping [t0, t1], including a collection
    still in progress."""
    total = 0.0
    for a, b in list(_GC_WINDOWS):
        lo, hi = max(a, t0), min(b, t1)
        if hi > lo:
            total += hi - lo
    started = _gc_started
    if started is not None:
        lo = max(started, t0)
        if t1 > lo:
            total += t1 - lo
    return total * 1000.0

#: Stall threshold (ms). ``sanitize.configure`` overrides from
#: ``oryx.sanitize.loop-stall-ms``; ORYX_SANITIZE_LOOP_STALL_MS wins over
#: both (a plain float read on the callback path — atomic under the GIL).
_stall_ms = 250.0

_MAX_REPORTS = 64


def _label(cb) -> str:
    """Human label for a callback, built only when a stall records."""
    if isinstance(cb, str):
        return cb
    try:
        return repr(cb)
    except Exception:  # noqa: BLE001 — labeling must never break a report
        return "<callback>"


class StallWatch:
    """The current-callback table + the stall report sink. Unit tests build
    a private one and point a watchdog at it; the installed patch records
    into the process-wide instance."""

    def __init__(self, stall_ms: "float | None" = None):
        self._mu = threading.Lock()
        self._current: dict = {}   # tid -> (t0, label)
        self._reported: set = set()  # (tid, t0) already reported
        self._stalls: list = []
        self._override_ms = stall_ms
        self.events = 0  # recorded callback entries (overhead gate)

    @property
    def stall_ms(self) -> float:
        return self._override_ms if self._override_ms is not None else _stall_ms

    # -- callback hooks ------------------------------------------------------
    def enter(self, cb) -> "tuple[int, float]":
        """``cb`` is the raw callback object (or a prebuilt str label): its
        repr is built LAZILY, only when a stall is actually recorded — an
        eager repr per callback would dominate the per-callback budget."""
        tid = threading.get_ident()
        t0 = time.monotonic()
        self._current[tid] = (t0, cb, threading.current_thread().name)
        self.events += 1
        return tid, t0

    def exit(self, token: "tuple[int, float]", cb) -> None:
        tid, t0 = token
        entry = self._current.pop(tid, None)
        now = time.monotonic()
        elapsed_ms = (now - t0) * 1000.0
        if elapsed_ms >= self.stall_ms:
            thread = entry[2] if entry else threading.current_thread().name
            self._record(tid, t0, _label(cb), elapsed_ms, stack="",
                         gc_ms=_gc_overlap_ms(t0, now), thread=thread)

    # -- watchdog ------------------------------------------------------------
    def sample(self) -> None:
        """One watchdog pass: capture the live stack of any in-flight
        callback past the threshold."""
        now = time.monotonic()
        for tid, (t0, cb, thread) in list(self._current.items()):
            elapsed_ms = (now - t0) * 1000.0
            if elapsed_ms < self.stall_ms:
                continue
            frame = sys._current_frames().get(tid)
            stack = (
                "".join(traceback.format_stack(frame)) if frame is not None
                else ""
            )
            # the STALLED thread's name (captured at enter), not the
            # watchdog's — the report must point at the wedged loop
            self._record(tid, t0, _label(cb), elapsed_ms, stack,
                         gc_ms=_gc_overlap_ms(t0, now), thread=thread)

    def _record(self, tid, t0, label, elapsed_ms, stack,
                gc_ms: float = 0.0, thread: "str | None" = None) -> None:
        # suspension gates REPORTING here exactly like the lock side: a
        # no_sanitize perf test may legitimately starve background loops,
        # and a callback that entered before the window began (or a
        # watchdog sample landing inside it) must not fail the session gate
        if _locks._suspend_depth:
            return
        # subtract GC pauses: what the CODE spent is what gates; a stall
        # that is all garbage collection reports nowhere (the gc_ms field
        # on surviving reports shows how much of them was GC)
        if elapsed_ms - gc_ms < self.stall_ms:
            return
        key = (tid, t0)
        with self._mu:
            if key in self._reported:
                # the watchdog saw it live; completion updates the duration
                for rec in self._stalls:
                    if rec.get("_key") == key:
                        rec["stalled_ms"] = max(
                            rec["stalled_ms"], round(elapsed_ms, 3)
                        )
                return
            self._reported.add(key)
            if len(self._stalls) < _MAX_REPORTS:
                self._stalls.append({
                    "_key": key,
                    "callback": label,
                    "stalled_ms": round(elapsed_ms, 3),
                    "gc_ms": round(gc_ms, 3),
                    "thread": (thread if thread is not None
                               else threading.current_thread().name),
                    "stack": stack,
                })

    def stalls(self) -> list:
        with self._mu:
            return [
                {k: v for k, v in rec.items() if k != "_key"}
                for rec in self._stalls
            ]

    def reset(self) -> None:
        with self._mu:
            self._stalls.clear()
            self._reported.clear()


_WATCH = StallWatch()


def watch() -> StallWatch:
    return _WATCH


def _swap_watch(new: StallWatch) -> StallWatch:
    global _WATCH
    old, _WATCH = _WATCH, new
    return old


def run_watchdog(watch_obj: StallWatch, stop: threading.Event,
                 period_sec: "float | None" = None) -> None:
    """Watchdog loop body (daemon thread target): sample until stopped."""
    while not stop.is_set():
        period = (
            period_sec if period_sec is not None
            else max(watch_obj.stall_ms / 4000.0, 0.01)
        )
        stop.wait(period)
        if not stop.is_set():
            watch_obj.sample()


_installed = False
_watchdog_stop: "threading.Event | None" = None


def replaced_elsewhere() -> bool:
    """True when ``asyncio.events.Handle._run`` is neither asyncio's own
    nor this module's: another sanitizer patched it first."""
    if _installed:
        return False
    import asyncio.events

    return getattr(asyncio.events.Handle._run, "__module__", None) != "asyncio.events"


def install() -> bool:
    """Patch ``Handle._run`` and start the process watchdog. Idempotent.
    Returns False, patching nothing, when another sanitizer got there
    first (:func:`replaced_elsewhere`)."""
    global _installed, _watchdog_stop
    if _installed:
        return True
    if replaced_elsewhere():
        return False
    _installed = True
    gc.callbacks.append(_gc_callback)  # GC-pause accounting (see above)

    import asyncio.events

    from oryx_tpu_torch.tools import sanitize as _san

    orig_run = asyncio.events.Handle._run

    def _run(self):
        if _san.is_suspended():
            return orig_run(self)
        w = _WATCH
        cb = self._callback  # repr'd lazily, only if a stall records
        token = w.enter(cb)
        try:
            return orig_run(self)
        finally:
            w.exit(token, cb)

    asyncio.events.Handle._run = _run

    _watchdog_stop = threading.Event()
    t = threading.Thread(
        # the proxy late-binds the watch so isolated() swaps are honored
        target=run_watchdog, args=(_WatchProxy(), _watchdog_stop),
        name="OryxLoopStallWatchdog", daemon=True,
    )
    t.start()
    return True


class _WatchProxy:
    """Forwards to the CURRENT process watch (sanitize.isolated swaps it)."""

    @property
    def stall_ms(self) -> float:
        return _WATCH.stall_ms

    def sample(self) -> None:
        _WATCH.sample()


def set_stall_ms(value: float) -> None:
    global _stall_ms
    _stall_ms = max(1.0, float(value))


def installed() -> bool:
    return _installed
