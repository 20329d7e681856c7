"""Framework-wide resilience primitives: retry, circuit breaking, deadlines.

A copy of the JAX package's ``oryx_tpu/common/resilience.py`` (host code, no
JAX), held equal to it by ``tests/test_torch_lambda.py``.

The reference lambda architecture outsources fault handling to Kafka (delivery
retries) and Spark (task re-execution); this reproduction has neither, so the
three tiers share these primitives instead (docs/robustness.md has the failure
model per tier):

  * :class:`RetryPolicy` — exponential backoff with FULL jitter (delay drawn
    uniformly from [0, min(cap, base*2^n)]; the AWS-architecture result that
    de-synchronizes retry herds better than equal or decorrelated jitter),
    bounded by max-attempts AND a max-elapsed wall budget, gated by a
    retryable-exception predicate. Every attempt outcome is accounted in
    ``oryx_retries_total{site,outcome}``.
  * :class:`CircuitBreaker` — closed→open on consecutive failures,
    open→half-open after a reset timeout, half-open admits a bounded number
    of probes and closes on probe success. State is a scrape-time gauge
    (``oryx_circuit_breaker_state``) and every transition is counted, so an
    operator can see open→half-open→closed happen in ``GET /metrics``.
  * :class:`Deadline` — a per-request time budget carried by a contextvar
    (the same propagation channel as the span context: asyncio tasks and
    ``asyncio.to_thread`` copy it; explicit carriers cross bare executors,
    see the coalescer's ``_Pending``). Work that would start after expiry
    raises :class:`DeadlineExceeded`, mapped to HTTP 504 with the partial
    trace id by the serving error middleware.

Process-wide defaults come from ``oryx.resilience.*`` via :func:`configure`
(the same configure() idiom as metrics/spans/compilecache); call sites that
need different shapes construct their own policy.
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import threading
import time
import weakref

from oryx_tpu_torch.common import blackbox
from oryx_tpu_torch.common import metrics as metrics_mod

_RETRIES = metrics_mod.default_registry().counter(
    "oryx_retries_total",
    "Retryable-call outcomes by site: retry (one backed-off re-attempt), "
    "recovered (success after >=1 retry), exhausted (budget spent, raised), "
    "fatal (non-retryable, raised immediately)",
    ("site", "outcome"),
)
_BREAKER_STATE = metrics_mod.default_registry().gauge(
    "oryx_circuit_breaker_state",
    "Circuit-breaker state: 0=closed, 1=open, 2=half-open (scrape-time)",
    ("breaker",),
)
_BREAKER_TRANSITIONS = metrics_mod.default_registry().counter(
    "oryx_circuit_breaker_transitions_total",
    "Circuit-breaker state transitions by target state",
    ("breaker", "to"),
)


class DeadlineExceeded(Exception):
    """A request's time budget ran out before the work could finish."""


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------


def default_retryable(exc: BaseException) -> bool:
    """Transient by default: I/O errors (a flaky shared filesystem under the
    ``file:`` broker, a dropped tunnel) — never programming errors."""
    return isinstance(exc, OSError)


class RetryPolicy:
    """Bounded exponential backoff with full jitter.

    ``call(site, fn)`` runs ``fn`` until it succeeds, the exception is
    non-retryable, ``max_attempts`` total attempts were made, or
    ``max_elapsed_sec`` of wall time has been spent. Sleeps go through
    ``stop.wait`` when a stop event is given, so a closing layer never
    blocks on a retry sleep.
    """

    def __init__(self, max_attempts: int = 4, base_delay_sec: float = 0.05,
                 max_delay_sec: float = 2.0, max_elapsed_sec: float = 30.0,
                 retryable=None, rng: "random.Random | None" = None):
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay_sec = max(0.0, float(base_delay_sec))
        self.max_delay_sec = max(0.0, float(max_delay_sec))
        self.max_elapsed_sec = float(max_elapsed_sec)
        self.retryable = retryable if retryable is not None else default_retryable
        self._rng = rng if rng is not None else random.Random()

    @classmethod
    def from_config(cls, config, retryable=None) -> "RetryPolicy":
        r = config.get_config("oryx.resilience.retry")
        return cls(
            max_attempts=r.get_int("max-attempts", 4),
            base_delay_sec=r.get_float("base-delay-ms", 50.0) / 1000.0,
            max_delay_sec=r.get_float("max-delay-ms", 2000.0) / 1000.0,
            max_elapsed_sec=r.get_float("max-elapsed-sec", 30.0),
            retryable=retryable,
        )

    def backoff(self, attempt: int) -> float:
        """Full-jitter delay before re-attempt number ``attempt`` (0-based):
        uniform in [0, min(max_delay, base * 2**attempt)]."""
        cap = min(self.max_delay_sec, self.base_delay_sec * (2 ** max(0, attempt)))
        return self._rng.uniform(0.0, cap)

    def call(self, site: str, fn, retryable=None, stop=None):
        """Run ``fn()`` under this policy; outcomes accounted per ``site``."""
        is_retryable = retryable if retryable is not None else self.retryable
        start = time.monotonic()
        attempt = 0
        while True:
            try:
                result = fn()
            except Exception as e:  # noqa: BLE001 — classified below
                attempt += 1
                if not is_retryable(e):
                    _RETRIES.labels(site, "fatal").inc()
                    raise
                elapsed = time.monotonic() - start
                if (
                    attempt >= self.max_attempts
                    or elapsed >= self.max_elapsed_sec
                    or (stop is not None and stop.is_set())
                ):
                    _RETRIES.labels(site, "exhausted").inc()
                    # flight-recorder evidence: an exhausted retry budget is
                    # the moment a transient fault became a caller-visible
                    # failure (throttled — a broker outage exhausts many
                    # sites at once, and one event per second tells the
                    # story as well as hundreds)
                    blackbox.record_event(
                        "retry.exhausted", severity="error",
                        throttle_sec=1.0,
                        throttle_key=f"retry.exhausted:{site}",
                        site=site, attempts=attempt,
                        error=f"{type(e).__name__}: {e}",
                    )
                    raise
                _RETRIES.labels(site, "retry").inc()
                delay = self.backoff(attempt - 1)
                # never sleep past the elapsed budget
                delay = min(delay, max(0.0, self.max_elapsed_sec - elapsed))
                if stop is not None:
                    stop.wait(delay)
                elif delay > 0:
                    time.sleep(delay)
                continue
            if attempt:
                _RETRIES.labels(site, "recovered").inc()
                blackbox.record_event(
                    "retry.recovered", throttle_sec=1.0,
                    throttle_key=f"retry.recovered:{site}",
                    site=site, attempts=attempt + 1,
                )
            return result


_default_policy = RetryPolicy()
_default_lock = threading.Lock()


def default_policy() -> RetryPolicy:
    """The process-wide policy (transport retries ride this); shaped by the
    last :func:`configure` call, built-in defaults before that."""
    return _default_policy


def configure(config) -> None:
    """Adopt ``oryx.resilience.retry.*`` as the process-wide default policy
    (idempotent; every layer entry point calls this, like metrics/spans)."""
    global _default_policy
    with _default_lock:
        _default_policy = RetryPolicy.from_config(config)


# ---------------------------------------------------------------------------
# CircuitBreaker
# ---------------------------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_VALUES = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


def _state_gauge_fn(breaker_ref):
    """Scrape-time state callback over a WEAK breaker ref (same pattern as
    the serving lag gauges: a strong ref would pin a dead layer's breaker)."""

    def fn() -> float:
        breaker = breaker_ref()
        if breaker is None:
            return _STATE_VALUES[CLOSED]
        return _STATE_VALUES[breaker.state]

    return fn


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probe admission.

    ``allow()`` is the admission check (False while OPEN and the reset
    timeout has not elapsed; in HALF_OPEN it admits up to
    ``half_open_probes`` in-flight probes); callers report outcomes through
    ``record_success``/``record_failure``. Thread-safe; the monotonic clock
    is injectable for tests."""

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout_sec: float = 10.0, half_open_probes: int = 1,
                 clock=time.monotonic):
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout_sec = float(reset_timeout_sec)
        self.half_open_probes = max(1, int(half_open_probes))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self._probe_granted_at = 0.0
        _BREAKER_STATE.labels(name).set_function(
            _state_gauge_fn(weakref.ref(self))
        )

    @classmethod
    def from_config(cls, name: str, config) -> "CircuitBreaker":
        b = config.get_config("oryx.resilience.breaker")
        return cls(
            name,
            failure_threshold=b.get_int("failure-threshold", 5),
            reset_timeout_sec=b.get_float("reset-sec", 10.0),
            half_open_probes=b.get_int("half-open-probes", 1),
        )

    def _transition(self, to: str) -> None:
        # lock held by caller
        if self._state == to:
            return
        from_state = self._state
        self._state = to
        _BREAKER_TRANSITIONS.labels(self.name, to).inc()
        # flight-recorder evidence (and, on OPEN, a bundle dump trigger:
        # an open breaker is the edge a postmortem asks about). The event
        # append + dump wakeup are both non-blocking, so holding the
        # breaker lock across them is fine.
        blackbox.record_event(
            "breaker.transition",
            severity="error" if to == OPEN else "info",
            dump=(to == OPEN),
            breaker=self.name, from_state=from_state, to=to,
            failures=self._failures,  # analyze: ignore[lock-discipline] -- _transition runs only under self._lock, taken by its callers
        )

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        # lock held by caller (private helper: every call site locks first)
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.reset_timeout_sec  # analyze: ignore[lock-discipline] -- _maybe_half_open runs only under self._lock, taken by its callers
        ):
            self._transition(HALF_OPEN)
            self._probes_in_flight = 0  # analyze: ignore[lock-discipline] -- _maybe_half_open runs only under self._lock, taken by its callers

    def allow(self) -> bool:
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN:
                now = self._clock()
                if (
                    self._probes_in_flight >= self.half_open_probes
                    and now - self._probe_granted_at >= self.reset_timeout_sec
                ):
                    # a probe that never reported an outcome (its request
                    # was shed, deadline-dropped, or its caller died) must
                    # not wedge the breaker half-open forever: outstanding
                    # probe slots EXPIRE after another reset period
                    self._probes_in_flight = 0
                if self._probes_in_flight < self.half_open_probes:
                    self._probes_in_flight += 1
                    self._probe_granted_at = now
                    return True
                return False
            return False  # OPEN

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state == HALF_OPEN:
                self._transition(CLOSED)
                self._probes_in_flight = 0

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN:
                # a failed probe re-opens and re-arms the reset timer
                self._transition(OPEN)
                self._opened_at = self._clock()
                self._probes_in_flight = 0
            elif self._state == CLOSED and self._failures >= self.failure_threshold:
                self._transition(OPEN)
                self._opened_at = self._clock()


# ---------------------------------------------------------------------------
# Deadline
# ---------------------------------------------------------------------------


class Deadline:
    """An absolute expiry on the monotonic clock (durations stay correct
    across wall-clock adjustments)."""

    __slots__ = ("expires_at", "budget_sec")

    def __init__(self, budget_sec: float):
        self.budget_sec = float(budget_sec)
        self.expires_at = time.monotonic() + self.budget_sec

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "request") -> None:
        if self.expired():
            raise DeadlineExceeded(f"{what} exceeded its {self.budget_sec:.3f}s budget")


#: The current request's deadline. Rides the SAME propagation channel as the
#: current span (contextvars): copied into asyncio tasks and asyncio.to_thread
#: workers, carried explicitly across bare run_in_executor hops.
_CURRENT_DEADLINE: "contextvars.ContextVar[Deadline | None]" = (
    contextvars.ContextVar("oryx_deadline", default=None)
)


@contextlib.contextmanager
def deadline(budget_sec: "float | None"):
    """Set the current deadline for the enclosed work (None/<=0 = no-op)."""
    if budget_sec is None or budget_sec <= 0:
        yield None
        return
    dl = Deadline(budget_sec)
    token = _CURRENT_DEADLINE.set(dl)
    try:
        yield dl
    finally:
        _CURRENT_DEADLINE.reset(token)


def current_deadline() -> "Deadline | None":
    return _CURRENT_DEADLINE.get()


def remaining() -> "float | None":
    """Seconds left on the current deadline, None when no deadline is set."""
    dl = _CURRENT_DEADLINE.get()
    return None if dl is None else dl.remaining()
