"""Concurrency helpers guarding the speed and serving models' stores.

A copy of the JAX package's ``oryx_tpu/common/lockutils.py`` (host code, no
JAX): the readers-writer lock the feature-vector stores take, and
``RateLimitCheck``, which throttles the speed tier's "not loaded yet" log
and the serving manager's solver pre-trigger, and :func:`close_at_shutdown`,
which the CLI registers each layer with. ``AutoLock`` is left out: nothing
in the port uses it. Held equal to the reference by
``tests/test_torch_als_speed.py`` and ``tests/test_torch_cli.py``.
Below, "the reference" is the original Oryx that module was modelled on
(framework/oryx-common/.../lang/AutoReadWriteLock.java,
RateLimitCheck.java).
"""

from __future__ import annotations

import atexit
import threading
import time
from typing import Any


class _RWState:
    __slots__ = ("readers", "writer", "cond")

    def __init__(self):
        self.readers = 0
        self.writer = False
        self.cond = threading.Condition()


class _ReadLock:
    def __init__(self, state: _RWState):
        self._s = state

    def __enter__(self):
        with self._s.cond:
            while self._s.writer:
                self._s.cond.wait()
            self._s.readers += 1
        return self

    def __exit__(self, *exc):
        with self._s.cond:
            self._s.readers -= 1
            if self._s.readers == 0:
                self._s.cond.notify_all()


class _WriteLock:
    def __init__(self, state: _RWState):
        self._s = state

    def __enter__(self):
        with self._s.cond:
            while self._s.writer or self._s.readers:
                self._s.cond.wait()
            self._s.writer = True
        return self

    def __exit__(self, *exc):
        with self._s.cond:
            self._s.writer = False
            self._s.cond.notify_all()


class AutoReadWriteLock:
    """Writer-preference-free readers-writer lock with context-manager handles
    (lang/AutoReadWriteLock.java). ``with lock.read():`` / ``with lock.write():``."""

    def __init__(self):
        self._state = _RWState()
        self._read = _ReadLock(self._state)
        self._write = _WriteLock(self._state)

    def read(self) -> _ReadLock:
        return self._read

    def write(self) -> _WriteLock:
        return self._write


class RateLimitCheck:
    """True at most once per interval — throttles log spam
    (lang/RateLimitCheck.java:39)."""

    def __init__(self, interval_sec: float):
        if interval_sec <= 0:
            raise ValueError("interval must be positive")
        self._interval = interval_sec
        self._next = time.monotonic()
        self._lock = threading.Lock()

    def test(self) -> bool:
        with self._lock:
            now = time.monotonic()
            if now >= self._next:
                self._next = now + self._interval
                return True
            return False


_shutdown_hook_items: list[Any] = []
_shutdown_lock = threading.Lock()
_hook_registered = False


def _run_shutdown_hook() -> None:
    with _shutdown_lock:
        items, _shutdown_hook_items[:] = list(_shutdown_hook_items), []
    # LIFO, mirroring OryxShutdownHook ordering
    for item in reversed(items):
        try:
            item.close()
        except Exception:  # noqa: BLE001 - best-effort teardown
            pass


def close_at_shutdown(closeable: Any) -> None:
    """Register orderly close at interpreter exit (JVMUtils.closeAtShutdown)."""
    global _hook_registered
    with _shutdown_lock:
        if not _hook_registered:
            atexit.register(_run_shutdown_hook)
            _hook_registered = True
        _shutdown_hook_items.append(closeable)
