"""Deterministic, seeded fault injection for chaos testing real code paths.

A copy of the JAX package's ``oryx_tpu/common/faults.py`` (host code, no
JAX), held equal to it by ``tests/test_torch_lambda.py``.

Named sites in the framework's hot paths ask this registry for permission —
``faults.maybe_fail("broker.append")`` — which is a single dict-is-None check
when disarmed (the production state: zero overhead, zero behavior change).
Armed, each site follows an exact, seeded schedule, so a chaos test can say
"the third and fourth appends fail, everything else succeeds" and assert the
retry/breaker/restart machinery absorbed exactly that.

Arming is config-driven (``oryx.faults.{enabled,seed,spec}``) so an operator
can run a game-day against a staging deployment from a conf file, or
programmatic (:func:`arm`) for tests. The spec grammar is
``site=mode[:arg];site=mode[:arg];...`` with modes:

  * ``fail:N``     — the first N calls at the site raise, later calls pass
                     (the retry-absorption schedule).
  * ``rate:P``     — each call fails with probability P, drawn from a
                     per-site RNG seeded with (seed, site) — the schedule is
                     identical for identical seeds.
  * ``latency:MS`` — every call sleeps MS milliseconds, then passes
                     (deadline/shed pressure without failures).

Injected failures raise :class:`InjectedFault` (an ``OSError`` subclass, so
the transport retry predicate classifies them as transient — exactly like
the real faults they stand in for). Known sites: ``broker.append``,
``broker.read``, ``broker.offset``, ``broker.fsync`` (fails/delays the
file broker's durability fsync — appends survive, durability degrades),
``ckpt.save`` / ``ckpt.load`` (fails trainer checkpoint writes/restores —
training must complete anyway, common/checkpoint.py),
``serving.update_consume``, ``serving.device_call``,
``serving.request`` (fails/delays HTTP requests inside the serving
middleware, probe/ops routes exempt — the SLO-burn game-day site), and
``batch.generation`` / ``speed.generation`` (fails a whole microbatch
generation through the quarantine machinery). docs/robustness.md has the
cookbook.
"""

from __future__ import annotations

import random
import threading
import time
import zlib

from oryx_tpu_torch.common import metrics as metrics_mod

_INJECTED = metrics_mod.default_registry().counter(
    "oryx_faults_injected_total",
    "Faults injected by site (0 unless oryx.faults is armed)",
    ("site",),
)


class InjectedFault(OSError):
    """A scheduled failure from the fault registry (transient by class)."""


class _Site:
    __slots__ = ("mode", "arg", "calls", "injected", "_rng")

    def __init__(self, site: str, mode: str, arg: float, seed: int):
        self.mode = mode
        self.arg = arg
        self.calls = 0
        self.injected = 0
        # per-site RNG seeded with (seed, site): the schedule at one site is
        # independent of how often OTHER sites are hit
        self._rng = random.Random((seed << 32) ^ zlib.crc32(site.encode()))

    def decide(self, site: str) -> "tuple[str, float] | None":
        """Advance the schedule one call (registry lock held) and return the
        action to take OUTSIDE the lock — a latency sleep performed under
        the shared lock would serialize every other site behind it, turning
        a per-site slowness drill into a global convoy."""
        self.calls += 1
        if self.mode == "fail":
            if self.calls <= self.arg:
                self.injected += 1
                _INJECTED.labels(site).inc()
                return ("raise", self.calls)
        elif self.mode == "rate":
            if self._rng.random() < self.arg:
                self.injected += 1
                _INJECTED.labels(site).inc()
                return ("raise", self.calls)
        elif self.mode == "latency":
            self.injected += 1
            _INJECTED.labels(site).inc()
            return ("sleep", self.arg / 1000.0)
        return None


#: site -> _Site when armed, None when disarmed. maybe_fail's fast path is a
#: single read of this global — no lock, no allocation.
_sites: "dict[str, _Site] | None" = None
_lock = threading.Lock()


def parse_spec(spec: str, seed: int = 0) -> "dict[str, _Site]":
    """``site=mode:arg;...`` -> site table (raises ValueError on bad specs —
    a typo'd chaos schedule must fail the test, not silently no-op)."""
    out: dict[str, _Site] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        site, sep, rhs = part.partition("=")
        if not sep or not site.strip() or not rhs.strip():
            raise ValueError(f"bad fault spec entry: {part!r}")
        mode, _, arg_s = rhs.strip().partition(":")
        mode = mode.strip()
        if mode not in ("fail", "rate", "latency"):
            raise ValueError(f"unknown fault mode {mode!r} in {part!r}")
        try:
            arg = float(arg_s) if arg_s else {"fail": 1.0, "rate": 1.0,
                                              "latency": 0.0}[mode]
        except ValueError as e:
            raise ValueError(f"bad fault arg in {part!r}") from e
        out[site.strip()] = _Site(site.strip(), mode, arg, seed)
    return out


def arm(spec: str, seed: int = 0) -> None:
    """Arm the registry with an exact schedule (tests; config uses configure)."""
    global _sites
    with _lock:
        _sites = parse_spec(spec, seed)


def disarm() -> None:
    global _sites
    with _lock:
        _sites = None


def armed() -> bool:
    return _sites is not None


def site_armed(site: str) -> bool:
    """True only when a schedule exists for THIS site — call sites that
    must pay setup cost to inject (the serving middleware's executor hop)
    check this instead of :func:`armed`, so a drill aimed at another site
    costs them nothing."""
    sites = _sites
    return sites is not None and site in sites


def configure(config) -> None:
    """Arm from ``oryx.faults.*`` when enabled with a spec; otherwise leave
    the current state alone (a layer starting in the same process as a test
    that armed programmatically must not silently disarm it)."""
    if not config.get_bool("oryx.faults.enabled", False):
        return
    spec = config.get_string("oryx.faults.spec", None)
    if spec:
        arm(spec, config.get_int("oryx.faults.seed", 0))


def maybe_fail(site: str) -> None:
    """The hot-path hook: no-op when disarmed, else run the site's schedule
    (raising :class:`InjectedFault` when the schedule says so). Schedule
    state advances under the registry lock; the injected effect (raise or
    sleep) happens outside it, so one slow site never convoys the others."""
    sites = _sites
    if sites is None:
        return
    s = sites.get(site)
    if s is None:
        return
    with _lock:
        action = s.decide(site)
    if action is None:
        return
    kind, arg = action
    if kind == "raise":
        raise InjectedFault(
            f"injected fault at {site} (call {int(arg)}, mode={s.mode})"
        )
    time.sleep(arg)


def stats() -> "dict[str, dict]":
    """Per-site {calls, injected} for test assertions."""
    sites = _sites
    if sites is None:
        return {}
    with _lock:
        return {
            name: {"calls": s.calls, "injected": s.injected}
            for name, s in sites.items()
        }
