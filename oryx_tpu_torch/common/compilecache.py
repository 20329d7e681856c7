"""Serving readiness: the batch-warmup ladder's progress behind ``/readyz``.

The readiness part of the JAX package's ``oryx_tpu/common/compilecache.py``
(host code, no JAX), held to it by ``tests/test_torch_serving.py``:
:class:`WarmupState`, :func:`warmup_state`, :func:`observe_warmup` and the
``oryx_warmup_*`` gauges. The serving layer's batch warmer
(``oryx.serving.compute.precompile-batches``) walks the coalescer's
power-of-two batch ladder through the serving model before the replica
turns ready, and ``/readyz`` holds until ``oryx.compile.ready-warm-fraction``
of it is done.

The reference's other half, XLA's persistent compilation cache and its
compile counters, has no counterpart in torch: nothing is compiled per
batch shape here. ``oryx.compile.cache-dir``, if set, is ignored, as the
key has no meaning in the port.
"""

from __future__ import annotations

import threading

from oryx_tpu_torch.common import metrics as metrics_mod

_WARMUP_SECONDS = metrics_mod.default_registry().histogram(
    "oryx_warmup_seconds",
    "Warmup durations: one observation per bucket and one per model ladder",
    ("scope",),
    buckets=metrics_mod.STEP_BUCKETS,
)


class WarmupState:
    """Progress of the serving tier's bucket-warmup ladder.

    ``arm()`` is called at layer start when warmup is configured: an armed
    state is NOT ready until a full ladder completes (otherwise the window
    between "model loaded" and "warmer picked it up" would flap /readyz).
    ``begin(total)`` starts a cycle, ``bucket_done()`` ticks it, and
    ``finish()`` marks the sticky completed bit once a cycle fully warms.
    Completion is sticky by design: a later model-generation swap re-runs
    the ladder off-path against the STAGED model while the already-warm old
    generation keeps serving, so readiness must not drop mid-swap."""

    def __init__(self):
        self._lock = threading.Lock()
        self.done = 0
        self.total = 0
        self._armed = False
        self._completed_once = False

    def reset(self) -> None:
        with self._lock:
            self.done = 0
            self.total = 0
            self._armed = False
            self._completed_once = False

    def arm(self) -> None:
        with self._lock:
            self._armed = True

    def begin(self, total: int) -> None:
        with self._lock:
            self.done = 0
            self.total = max(0, total)

    def bucket_done(self) -> None:
        with self._lock:
            self.done += 1

    def finish(self) -> None:
        with self._lock:
            if self.total and self.done >= self.total:
                self._completed_once = True

    def mark_trivial(self) -> None:
        """The served model has no batched path to warm (wordcount-style
        apps): warmup is trivially complete — never hold readiness."""
        with self._lock:
            self._completed_once = True

    def snapshot(self) -> dict:
        with self._lock:
            return {"done": self.done, "total": self.total}

    def warm_fraction(self) -> float:
        with self._lock:
            if self.total <= 0:
                return 1.0
            return self.done / self.total

    def ready(self, min_fraction: float) -> bool:
        """Readiness contribution for /readyz: unarmed states never gate
        (warmup not configured); armed states need ``min_fraction`` of the
        current ladder — or one fully completed ladder, ever."""
        with self._lock:
            if self._completed_once or not self._armed:
                return True
            if self.total <= 0:
                return False  # armed but the ladder has not started yet
            return (self.done / self.total) >= min_fraction


_WARMUP = WarmupState()


def warmup_state() -> WarmupState:
    """The process-wide warmup state the serving layer and /readyz share."""
    return _WARMUP


def observe_warmup(scope: str, seconds: float) -> None:
    """Record one warmup duration (``scope`` is ``bucket`` or ``model``)."""
    _WARMUP_SECONDS.labels(scope).observe(seconds)


_WARM_DONE = metrics_mod.default_registry().gauge(
    "oryx_warmup_buckets_done",
    "Batch buckets compiled in the current warmup cycle",
)
_WARM_TOTAL = metrics_mod.default_registry().gauge(
    "oryx_warmup_buckets_total",
    "Batch buckets the current warmup cycle will compile",
)
# scrape-time callbacks over the module singleton (it lives for the process,
# so no weakref dance is needed here)
_WARM_DONE.set_function(lambda: warmup_state().snapshot()["done"])
_WARM_TOTAL.set_function(lambda: warmup_state().snapshot()["total"])
