"""Per-step timing behind config flags.

The port of the JAX package's ``oryx_tpu/common/tracing.py`` (host code,
no JAX). Each layer wraps its generation/microbatch work in a
``StepTracer.step(...)`` that

  * records wall time and item counts per step (always into the metrics
    registry's ``oryx_step_*`` series while metrics are enabled),
  * with ``oryx.tracing.enabled``, logs a rate-limited one-line summary
    (mean/last duration, throughput).

Not ported: the reference's ``oryx.tracing.profile-dir`` capture, which
runs through its JAX-bound ``profiling`` module. A config that sets the key
is refused at construction, so a profile that was asked for never goes
missing in silence.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common.lockutils import RateLimitCheck

log = logging.getLogger(__name__)

# StepTracer → registry bridge: every timed step ALSO lands in the
# process-wide registry, labeled by (tier, step), so the /metrics view and
# the tracer's own counters are fed from the same measured (dt, n_items)
# at the same instant — they describe identical events by construction.
_STEP_SECONDS = metrics_mod.default_registry().histogram(
    "oryx_step_duration_seconds",
    "Wall time of one generation/microbatch step by tier",
    ("tier", "step"),
    buckets=metrics_mod.STEP_BUCKETS,
)
_STEP_ITEMS = metrics_mod.default_registry().counter(
    "oryx_step_items_total",
    "Items processed by generation/microbatch steps by tier",
    ("tier", "step"),
)


class StepTracer:
    def __init__(self, config, tier: str):
        if config.get_string("oryx.tracing.profile-dir", None) is not None:
            raise NotImplementedError(
                "oryx.tracing.profile-dir: step profiling is not ported yet")
        self.tier = tier
        self.enabled = config.get_bool("oryx.tracing.enabled", False)
        self._log_check = RateLimitCheck(
            config.get_float("oryx.tracing.log-interval-sec", 60.0)
        )
        self.steps = 0
        self.total_sec = 0.0
        self.total_items = 0
        self.last_sec = 0.0

    @contextmanager
    def step(self, name: str, n_items: int = 0):
        """Time one generation/microbatch; no-op-cheap when disabled.

        The step is ALSO recorded into the process registry
        (``oryx_step_duration_seconds{tier,step}`` / ``oryx_step_items_total``)
        whenever metrics are enabled — even with tracing off — from the very
        same ``dt``/``n_items``, so ``/metrics`` and :meth:`metrics` can
        never report different measurements for the same step."""
        record_metrics = metrics_mod.default_registry().enabled
        if not self.enabled and not record_metrics:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if record_metrics:
                _STEP_SECONDS.labels(self.tier, name).observe(dt)
                if n_items:
                    _STEP_ITEMS.labels(self.tier, name).inc(n_items)
            if self.enabled:  # no early return: a `return` in finally would
                # swallow an exception raised by the step body
                self.steps += 1
                self.total_sec += dt
                self.total_items += n_items
                self.last_sec = dt
                if self._log_check.test():
                    mean = self.total_sec / max(self.steps, 1)
                    rate = self.total_items / self.total_sec if self.total_sec > 0 else 0.0
                    log.info(
                        "[%s] %s: step %d took %.3fs (mean %.3fs, %d items, %.1f items/s cum)",
                        self.tier, name, self.steps, dt, mean, n_items, rate,
                    )

    def metrics(self) -> dict:
        """Counters for health/introspection endpoints (fed from the same
        measurements as the ``oryx_step_*`` registry series — see step())."""
        return {
            "steps": self.steps,
            "total_sec": round(self.total_sec, 4),
            "last_sec": round(self.last_sec, 4),
            "total_items": self.total_items,
        }

    def close(self) -> None:
        """Nothing to release: the port's tracer holds no profiler."""
