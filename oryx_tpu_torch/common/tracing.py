"""Per-step timing + optional device profiling, behind config flags.

The port of the JAX package's ``oryx_tpu/common/tracing.py`` (host code,
no JAX; torch only inside a capture). Each layer wraps its
generation/microbatch work in a ``StepTracer.step(...)`` that

  * records wall time and item counts per step (always into the metrics
    registry's ``oryx_step_*`` series while metrics are enabled),
  * with ``oryx.tracing.enabled``, logs a rate-limited one-line summary
    (mean/last duration, throughput),
  * with ``oryx.tracing.enabled`` and ``oryx.tracing.profile-dir`` set,
    captures a ``torch.profiler`` trace of the first ``profile-steps``
    steps into that directory (a Chrome trace, ``*.pt.trace.json``)
    through the process's shared :class:`profiling.ProfileSession`.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import profiling
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
        self.tier = tier
        self.enabled = config.get_bool("oryx.tracing.enabled", False)
        self.profile_dir = config.get_string("oryx.tracing.profile-dir", None)
        self.profile_steps = config.get_int("oryx.tracing.profile-steps", 5)
        self._log_check = RateLimitCheck(
            config.get_float("oryx.tracing.log-interval-sec", 60.0)
        )
        self.steps = 0
        self.total_sec = 0.0
        self.total_items = 0
        self.last_sec = 0.0
        self._profiling = False
        # set when the shared ProfileSession refused a capture (another
        # tracer or /debug/profile owns the profiler): retried only once
        # the session frees up, so a refusal does not log on every step
        self._profile_denied = False

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
        profile = (
            self.enabled
            and self.profile_dir is not None
            and self.steps < self.profile_steps
        )
        if profile:
            self._start_profiler()
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
                if profile and self.steps >= self.profile_steps:
                    self._stop_profiler()
                if self._log_check.test():
                    mean = self.total_sec / max(self.steps, 1)
                    rate = self.total_items / self.total_sec if self.total_sec > 0 else 0.0
                    log.info(
                        "[%s] %s: step %d took %.3fs (mean %.3fs, %d items, %.1f items/s cum)",
                        self.tier, name, self.steps, dt, mean, n_items, rate,
                    )

    @property
    def _owner(self) -> str:
        return f"steptracer-{self.tier}"

    def _start_profiler(self) -> None:
        """Begin this tracer's step capture through the SHARED
        :class:`profiling.ProfileSession`: two tracers in one process
        (batch + speed layers both enabled) are arbitrated by the session,
        and the loser quietly skips its capture. Unbounded duration on
        purpose: batch generations can run for hours, and the layer's close
        path stops the capture."""
        if self._profiling:
            return
        if self._profile_denied:
            # denied earlier; retry only once the session frees up — a
            # transient endpoint capture must not cost a long-running
            # layer its configured step capture
            if profiling.profile_session().busy():
                return
            self._profile_denied = False
        try:
            profiling.profile_session().start(
                self.profile_dir, owner=self._owner, max_seconds=None
            )
            self._profiling = True
            log.info("[%s] profiler trace started -> %s", self.tier, self.profile_dir)
        except profiling.ProfileBusyError as e:
            self._profile_denied = True
            log.info("[%s] profiler busy; skipping step capture (%s)",
                     self.tier, e)
        except Exception:  # noqa: BLE001 - profiling must never kill a layer
            log.exception("failed to start profiler trace")

    def _stop_profiler(self) -> None:
        """Stop OUR capture (owner-checked, so a tracer that never got the
        session cannot cut a sibling's capture short). Reached both from
        the step that completes the capture and from :meth:`close` — a
        layer stopped before ``profile-steps`` steps still writes its
        trace."""
        if not self._profiling:
            return
        try:
            if profiling.profile_session().stop(owner=self._owner) is not None:
                log.info("[%s] profiler trace written -> %s",
                         self.tier, self.profile_dir)
        except Exception:  # noqa: BLE001
            log.exception("failed to stop profiler trace")
        finally:
            self._profiling = False

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
        self._stop_profiler()
