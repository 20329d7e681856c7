"""In-process metrics time-series engine: history rings, incident windows,
and trend-aware early warning (docs/observability.md "Time series & trends").

A copy of the JAX package's ``oryx_tpu/common/tsdb.py`` (host code, no
JAX), held equal to it by ``tests/test_torch_observability.py``. The MFU,
HBM, factor-arena and RSS signals read the families that
``common/profiling`` registers; the sampler skips a missing family, as it
does in the reference.

Every other observability surface — /metrics, SLO burn, blackbox bundles,
fleet-status — is instantaneous: a scrape or a snapshot at one moment. This
module is the memory between those moments. A background sampler (daemon
thread, ``oryx.tsdb.sample-interval-sec``) walks the process-wide metrics
registry each tick and appends ``(ts, value)`` points for a curated signal
set — request rate and p99 from latency-histogram bucket deltas (ops routes
excluded, the same predicate the SLO engine uses), coalescer queue depth,
shed/breaker/retry counter rates, update lag, data freshness, MFU, HBM
bandwidth fraction, factor-arena bytes, and host RSS — into per-signal
:class:`SeriesRing` buffers.

Rings are bounded two ways: a wall-clock retention horizon and a point cap
with **tiered 2:1 decimation** — points newer than
``oryx.tsdb.full-resolution-sec`` are never thinned; past the cap the older
tier decimates 2:1 (repeatedly, so history coarsens gracefully: full
resolution for ~10 minutes, halving density per pass out to ~4 hours).
Appends are lock-cheap (one leaf lock, list slicing, no allocation beyond
the point itself); the sampler never holds a ring lock while touching the
registry. The SLO engine's sample history (slo.py) rides the same primitive
in "oldest half" mode, so burn windows and /metrics/history can never
diverge.

Consumers:

* ``GET /metrics/history`` (serving console; auth posture = /metrics) —
  JSON series with ``?signal=``/``?since=`` filters.
* Blackbox bundles embed :func:`incident_window` — minutes of pre-incident
  context instead of one snapshot; edge-triggered dumps capture the window
  at *trigger* time (common/blackbox.py).
* The trend evaluator (``oryx.tsdb.trend.*``): least-squares slope over the
  trailing window plus threshold-crossing ETA ("queue depth ramping such
  that max-queue-depth is reached within N sec", "freshness age
  accelerating past the SLO threshold"). Active rules raise
  ``oryx_trend_alert_active``, ride /readyz informationally, and record
  blackbox ``trend.alert`` events — early warning that fires *before* the
  SLO burn pages, because a slope needs seconds of evidence where a burn
  window needs minutes of damage.
"""

from __future__ import annotations

import logging
import threading
import time
from bisect import bisect_left, bisect_right

from oryx_tpu_torch.common import blackbox
from oryx_tpu_torch.common import metrics as metrics_mod

log = logging.getLogger(__name__)

_TICKS = metrics_mod.default_registry().counter(
    "oryx_tsdb_sampler_ticks_total",
    "Completed time-series sampler ticks (manual sample_once() calls "
    "included)",
)
_POINTS = metrics_mod.default_registry().counter(
    "oryx_tsdb_points_total",
    "Points appended to the in-process time-series rings, per signal",
    ("signal",),
)
_TREND_ACTIVE = metrics_mod.default_registry().gauge(
    "oryx_trend_alert_active",
    "1 while a trend rule projects its signal crossing its limit within "
    "the rule's horizon (early warning; fires before the SLO burn pages)",
    ("rule",),
)


class _NullLock:
    """No-op context manager for rings guarded by an external lock (the SLO
    engine serializes every touch under its own engine lock; a second leaf
    lock there would be pure overhead)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class SeriesRing:
    """Bounded ``(ts, value)`` history with tiered 2:1 decimation.

    Two retention modes share the one primitive:

    * ``full_resolution_sec=None`` — "oldest half" mode: past ``max_points``
      the oldest half of the ring thins 2:1. This is the SLO engine's
      historical behavior, kept bit-identical through the migration.
    * ``full_resolution_sec=N`` — sampler mode: points newer than N seconds
      are never thinned; past ``max_points`` only the older tier decimates
      2:1. Repeated passes coarsen old data geometrically — the tiering.

    Decimation SELECTS surviving points (list slicing); it never averages
    or interpolates, so every point still in the ring is an exact
    ``(ts, value)`` pair that was appended (the bit-accuracy property the
    tests pin). Appends also trim the ``retention_sec`` horizon, always
    keeping at least one point so "last known value" never disappears.
    """

    def __init__(self, retention_sec: float, max_points: int = 4096,
                 full_resolution_sec: "float | None" = None,
                 lock: bool = True):
        self.retention_sec = float(retention_sec)
        self.max_points = int(max_points)
        self.full_resolution_sec = (
            None if full_resolution_sec is None else float(full_resolution_sec)
        )
        self._lock = threading.Lock() if lock else _NullLock()
        self._times: list[float] = []
        self._values: list = []

    def append(self, ts: float, value) -> None:
        with self._lock:
            self._times.append(ts)
            self._values.append(value)
            horizon = ts - self.retention_sec
            if self._times[0] < horizon:
                cut = bisect_right(self._times, horizon)
                cut = min(cut, len(self._times) - 1)
                if cut > 0:
                    del self._times[:cut]
                    del self._values[:cut]
            if len(self._times) > self.max_points:
                if self.full_resolution_sec is None:
                    boundary = len(self._times) // 2
                else:
                    boundary = bisect_left(
                        self._times, ts - self.full_resolution_sec
                    )
                if boundary >= 2:
                    self._times[:boundary] = self._times[:boundary:2]
                    self._values[:boundary] = self._values[:boundary:2]
                else:
                    # the whole ring is inside the full-resolution window:
                    # the cap still wins (bounded beats pretty), drop oldest
                    del self._times[0]
                    del self._values[0]

    def points(self, since: "float | None" = None) -> list:
        """``(ts, value)`` pairs, oldest first; ``since`` keeps only points
        strictly newer than it (pollers pass the last ts they saw)."""
        with self._lock:
            if since is None:
                return list(zip(self._times, self._values))
            i = bisect_right(self._times, float(since))
            return list(zip(self._times[i:], self._values[i:]))

    def last(self):
        with self._lock:
            if not self._times:
                return None
            return (self._times[-1], self._values[-1])

    def __len__(self) -> int:
        with self._lock:
            return len(self._times)


# -- trend math ----------------------------------------------------------------

def crossing_eta(points, limit: float) -> "tuple[float, float]":
    """``(slope, eta_sec)`` for a series approaching ``limit``.

    ``slope`` is the least-squares fit over ``(ts, value)`` points, per
    second. ``eta_sec`` projects from the LAST observed value at that slope:
    0 when the series already sits at/over the limit, ``inf`` when the fit
    is flat or falling (no crossing ahead), else ``(limit - last) / slope``.
    """
    n = len(points)
    if n == 0:
        return 0.0, float("inf")
    current = points[-1][1]
    if n < 2:
        return 0.0, 0.0 if current >= limit else float("inf")
    mean_t = sum(t for t, _ in points) / n
    mean_v = sum(v for _, v in points) / n
    var = sum((t - mean_t) ** 2 for t, _ in points)
    cov = sum((t - mean_t) * (v - mean_v) for t, v in points)
    slope = cov / var if var > 0 else 0.0
    if current >= limit:
        return slope, 0.0
    if slope <= 0:
        return slope, float("inf")
    return slope, (limit - current) / slope


class TrendRule:
    """One slope/crossing-ETA rule over one signal's ring."""

    def __init__(self, name: str, signal: str, limit: float,
                 horizon_sec: float, window_sec: float = 120.0,
                 min_points: int = 6):
        self.name = name
        self.signal = signal
        self.limit = float(limit)
        self.horizon_sec = float(horizon_sec)
        self.window_sec = float(window_sec)
        self.min_points = int(min_points)

    def evaluate(self, ring: SeriesRing, now: float) -> "dict | None":
        """Rule state dict, or None while the trailing window holds fewer
        than ``min_points`` points (insufficient evidence = quiet — a rule
        must never page off two samples of noise)."""
        points = ring.points(since=now - self.window_sec)
        if len(points) < self.min_points:
            return None
        slope, eta = crossing_eta(points, self.limit)
        return {
            "rule": self.name,
            "signal": self.signal,
            "active": eta <= self.horizon_sec,
            "slope": slope,
            "eta_sec": eta,
            "current": points[-1][1],
            "limit": self.limit,
            "horizon_sec": self.horizon_sec,
        }


def _bucket_quantile(rows, count: float, q: float) -> float:
    """Quantile from ascending ``(upper_bound, cumulative_count)`` rows with
    linear interpolation inside the bucket; the +Inf overflow bucket clamps
    to the last finite bound (same convention as tools/trace_summary.py)."""
    if count <= 0:
        return float("nan")
    rank = q * count
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in rows:
        if cum >= rank:
            if bound == float("inf"):
                return prev_bound
            span = cum - prev_cum
            if span <= 0:
                return float(bound)
            return prev_bound + (bound - prev_bound) * (rank - prev_cum) / span
        prev_bound, prev_cum = float(bound), float(cum)
    return float(rows[-1][0]) if rows else float("nan")


# -- curated signals -----------------------------------------------------------

#: signal name -> display unit (the endpoint/bundle payload carries it so
#: renderers never guess).
SIGNAL_UNITS = {
    "request_rate": "req/s",
    "request_p99_ms": "ms",
    "queue_depth": "items",
    "shed_rate": "events/s",
    "breaker_degraded_rate": "events/s",
    "retry_rate": "events/s",
    "update_lag_sec": "sec",
    "freshness_sec": "sec",
    "mfu": "fraction",
    "hbm_fraction": "fraction",
    "arena_bytes": "bytes",
    "host_rss_bytes": "bytes",
}

CURATED_SIGNALS = tuple(SIGNAL_UNITS)

# gauges read as-is each tick (NaN from a dead callback skips the point;
# freshness reads -1 until lineage has a watermark — recorded as-is so the
# "unknown -> known" transition is visible in the series)
_GAUGE_SOURCES = (
    ("queue_depth", "oryx_coalescer_queue_depth"),
    ("update_lag_sec", "oryx_serving_update_lag_seconds"),
    ("freshness_sec", "oryx_model_data_freshness_seconds"),
    ("mfu", "oryx_device_mfu"),
    ("hbm_fraction", "oryx_device_hbm_bandwidth_fraction"),
    ("arena_bytes", "oryx_factor_arena_bytes"),
    ("host_rss_bytes", "oryx_host_rss_bytes"),
)

# monotonic counters turned into per-second rates from tick-to-tick deltas
_RATE_SOURCES = (
    ("shed_rate", "oryx_shed_requests_total"),
    ("breaker_degraded_rate", "oryx_breaker_degraded_requests_total"),
    ("retry_rate", "oryx_retries_total"),
)

_REQUEST_HISTOGRAM = "oryx_serving_request_latency_seconds"


class TsdbEngine:
    """The sampler + ring store + trend evaluator behind the module API."""

    def __init__(self, *, registry=None, interval_sec: float = 5.0,
                 retention_sec: float = 14400.0,
                 full_resolution_sec: float = 600.0,
                 max_points_per_signal: int = 512,
                 max_total_points: int = 8192,
                 incident_window_sec: float = 300.0,
                 signals=None, trend_rules=(), clock=None):
        self.registry = registry if registry is not None \
            else metrics_mod.default_registry()
        self.interval_sec = float(interval_sec)
        self.incident_window_sec = float(incident_window_sec)
        self._clock = clock if clock is not None else time.time
        names = [s for s in (signals or CURATED_SIGNALS)]
        unknown = [s for s in names if s not in SIGNAL_UNITS]
        if unknown:
            log.warning("oryx.tsdb.signals ignoring unknown signals %s "
                        "(known: %s)", unknown, ", ".join(CURATED_SIGNALS))
            names = [s for s in names if s in SIGNAL_UNITS]
        if not names:
            names = list(CURATED_SIGNALS)
        # the total cap is enforced as an even per-signal share so one
        # signal can never starve the others out of the budget
        per_cap = max(8, min(int(max_points_per_signal),
                             int(max_total_points) // len(names)))
        self.rings: dict[str, SeriesRing] = {
            name: SeriesRing(retention_sec, per_cap, full_resolution_sec)
            for name in names
        }
        self.trend_rules = [
            r for r in trend_rules if r.signal in self.rings and r.limit > 0
        ]
        # serializes ticks (background sampler + manual sample_once calls);
        # ring locks stay leaf — never held while walking the registry
        self._tick_lock = threading.Lock()
        self._prev: dict = {}
        self._prev_wall: "float | None" = None
        self._trend_active: dict[str, bool] = {}
        self._trend_state: dict[str, dict] = {}

    # -- sampling --------------------------------------------------------------

    def sample_once(self, now: "float | None" = None) -> dict:
        """One sampler tick: collect every signal's value from the registry,
        append points, evaluate trend rules. Returns the appended
        ``{signal: value}`` dict (tests and the overhead gate drive this
        directly). Edge events are recorded OUTSIDE the tick lock."""
        edges: list = []
        with self._tick_lock:
            wall = self._clock() if now is None else float(now)
            dt = None
            if self._prev_wall is not None and wall > self._prev_wall:
                dt = wall - self._prev_wall
            self._prev_wall = wall
            values = self._collect(dt)
            for name, v in values.items():
                self.rings[name].append(wall, v)
                _POINTS.labels(name).inc()
            _TICKS.inc()
            edges = self._evaluate_trends(wall)
        for kind, attrs in edges:
            blackbox.record_event(kind, **attrs)
        return values

    def _collect(self, dt: "float | None") -> dict:
        reg = self.registry
        out: dict = {}
        for name, metric in _GAUGE_SOURCES:
            if name not in self.rings:
                continue
            fam = reg.get(metric)
            if fam is None:
                continue
            try:
                v = float(fam.value)
            except Exception:  # noqa: BLE001 — one bad callback, not a tick
                continue
            if v != v:  # NaN: dead scrape callback -> no point
                continue
            out[name] = v
        for name, metric in _RATE_SOURCES:
            if name not in self.rings:
                continue
            fam = reg.get(metric)
            if fam is None:
                continue
            try:
                total = float(sum(v for _k, v in fam.samples()))
            except Exception:  # noqa: BLE001
                continue
            prev = self._prev.get(name)
            self._prev[name] = total
            if prev is not None and dt:
                out[name] = max(0.0, total - prev) / dt
        if "request_rate" in self.rings or "request_p99_ms" in self.rings:
            self._collect_requests(dt, out)
        return out

    def _collect_requests(self, dt: "float | None", out: dict) -> None:
        """Request rate and p99 from latency-histogram bucket deltas, ops
        routes (/metrics, /healthz, ...) excluded via the same predicate the
        SLO availability objective uses."""
        fam = self.registry.get(_REQUEST_HISTOGRAM)
        if fam is None or not hasattr(fam, "bucket_samples"):
            return
        from oryx_tpu_torch.common import slo as slo_mod  # lazy: slo imports us
        bounds = list(fam.buckets)
        agg = [0.0] * (len(bounds) + 1)
        count = 0.0
        try:
            rows = fam.bucket_samples()
        except Exception:  # noqa: BLE001
            return
        for key, counts, _sum, n in rows:
            route = key[0] if key else ""
            if slo_mod.is_ops_route(route):
                continue
            count += float(n)
            for i, c in enumerate(counts):
                if i < len(agg):
                    agg[i] += float(c)
        prev = self._prev.get("_request_hist")
        self._prev["_request_hist"] = (agg, count)
        if prev is None or not dt:
            return
        prev_agg, prev_count = prev
        if len(prev_agg) != len(agg):
            return  # bucket layout changed mid-flight: one silent tick
        d_count = max(0.0, count - prev_count)
        if "request_rate" in self.rings:
            out["request_rate"] = d_count / dt
        if d_count > 0 and "request_p99_ms" in self.rings:
            cum, drows = 0.0, []
            for i, b in enumerate(bounds):
                cum += max(0.0, agg[i] - prev_agg[i])
                drows.append((float(b), cum))
            drows.append((float("inf"), d_count))
            p99 = _bucket_quantile(drows, d_count, 0.99)
            if p99 == p99:
                out["request_p99_ms"] = p99 * 1000.0

    # -- trends ----------------------------------------------------------------

    def _evaluate_trends(self, now: float) -> list:
        """Evaluate every rule; flip gauges on edges and return the edge
        events to record once the tick lock is released (the blackbox ring
        lock must stay a leaf of nothing here)."""
        edges: list = []
        for rule in self.trend_rules:
            state = rule.evaluate(self.rings[rule.signal], now)
            active = bool(state and state["active"])
            if state is not None:
                self._trend_state[rule.name] = state
            was = self._trend_active.get(rule.name, False)
            if active != was:
                self._trend_active[rule.name] = active
                _TREND_ACTIVE.labels(rule.name).set(1.0 if active else 0.0)
                if active:
                    eta = state["eta_sec"]
                    edges.append(("trend.alert", {
                        "severity": "warning",
                        "rule": rule.name,
                        "signal": rule.signal,
                        "eta_sec": round(eta, 1) if eta != float("inf") else None,
                        "current": round(state["current"], 3),
                        "limit": rule.limit,
                    }))
                else:
                    edges.append(("trend.clear", {
                        "severity": "info", "rule": rule.name,
                        "signal": rule.signal,
                    }))
        return edges

    def trend_alerts(self) -> list:
        """Active rules as JSON-safe dicts (inf ETA -> None) — the /readyz
        informational entry and the history payload's ``trend_alerts``."""
        out = []
        for rule in self.trend_rules:
            if not self._trend_active.get(rule.name):
                continue
            state = dict(self._trend_state.get(rule.name) or {})
            eta = state.get("eta_sec")
            state["eta_sec"] = (
                None if eta is None or eta == float("inf") else round(eta, 1)
            )
            state.pop("active", None)
            out.append(state)
        return out

    # -- reads -----------------------------------------------------------------

    def history(self, signals=None, since: "float | None" = None) -> dict:
        """``{signal: {"unit", "points": [[ts, value], ...]}}``, points
        oldest first, ``since`` strictly-newer filtered."""
        wanted = None if signals is None else set(signals)
        out = {}
        for name, ring in self.rings.items():
            if wanted is not None and name not in wanted:
                continue
            out[name] = {
                "unit": SIGNAL_UNITS[name],
                "points": [[round(t, 3), v] for t, v in ring.points(since)],
            }
        return out

    def incident_window(self, window_sec: "float | None" = None) -> dict:
        """The pre-incident context blackbox bundles embed: the trailing
        ``oryx.tsdb.incident-window-sec`` of every ring plus active trend
        alerts. Takes only ring locks (all leaf) — safe to call from under
        a breaker/quarantine edge site's lock at trigger time."""
        now = self._clock()
        w = self.incident_window_sec if window_sec is None else float(window_sec)
        return {
            "window_sec": w,
            "captured_at": round(now, 3),
            "sample_interval_sec": self.interval_sec,
            "signals": self.history(since=now - w),
            "trend_alerts": self.trend_alerts(),
        }


class _Sampler(threading.Thread):
    """Daemon tick loop. Reads the module engine each tick, so a reconfigure
    swaps engines without a thread restart; ``stop_event`` is waited on
    OUTSIDE every lock, so shutdown can never deadlock against a tick."""

    def __init__(self, interval: float):
        super().__init__(name="OryxTsdbSampler", daemon=True)
        self.interval = float(interval)
        self.stop_event = threading.Event()
        self._warned = False

    def run(self) -> None:
        while not self.stop_event.wait(self.interval):
            eng = _ENGINE
            if eng is None:
                continue
            try:
                eng.sample_once()
            except Exception:  # noqa: BLE001 — the sampler must survive
                if not self._warned:
                    log.warning("tsdb sampler tick failed", exc_info=True)
                    self._warned = True


# -- module singleton ----------------------------------------------------------

_ENGINE: "TsdbEngine | None" = None
_SAMPLER: "_Sampler | None" = None
_configure_lock = threading.Lock()


def engine() -> "TsdbEngine | None":
    return _ENGINE


def enabled() -> bool:
    return _ENGINE is not None


def configure(config) -> "TsdbEngine | None":
    """(Re)build the engine from ``oryx.tsdb.*`` and (re)start the sampler.
    Called from every layer's construction path (serving make_app, lambda
    AbstractLayer); a reconfigure CARRIES ring history and rate state over
    so layers sharing a process never wipe each other's pre-incident
    window."""
    global _ENGINE
    with _configure_lock:
        if not config.get_bool("oryx.tsdb.enabled", True):
            _stop_sampler_locked()
            _ENGINE = None
            _zero_trend_gauges()
            return None
        interval = config.get_float("oryx.tsdb.sample-interval-sec", 5.0)
        rules: list[TrendRule] = []
        if config.get_bool("oryx.tsdb.trend.enabled", True):
            window = config.get_float("oryx.tsdb.trend.window-sec", 120.0)
            min_points = config.get_int("oryx.tsdb.trend.min-points", 6)
            if config.get_bool("oryx.tsdb.trend.queue-depth.enabled", True):
                limit = config.get_float("oryx.tsdb.trend.queue-depth.limit", 0.0)
                if limit <= 0:
                    # 0 = inherit the batcher's own bound; an unbounded
                    # queue (max-queue-depth 0) has nothing to cross
                    limit = float(config.get_int(
                        "oryx.serving.compute.max-queue-depth", 0))
                if limit > 0:
                    rules.append(TrendRule(
                        "queue_depth", "queue_depth", limit,
                        config.get_float(
                            "oryx.tsdb.trend.queue-depth.horizon-sec", 300.0),
                        window, min_points))
            if config.get_bool("oryx.tsdb.trend.freshness.enabled", True):
                limit = config.get_float("oryx.tsdb.trend.freshness.limit", 0.0)
                if limit <= 0:
                    limit = config.get_float(
                        "oryx.slo.freshness.threshold-sec", 600.0)
                if limit > 0:
                    rules.append(TrendRule(
                        "freshness", "freshness_sec", limit,
                        config.get_float(
                            "oryx.tsdb.trend.freshness.horizon-sec", 300.0),
                        window, min_points))
        signals = [str(s) for s in config.get_list("oryx.tsdb.signals", [])]
        new = TsdbEngine(
            interval_sec=interval,
            retention_sec=config.get_float("oryx.tsdb.retention-sec", 14400.0),
            full_resolution_sec=config.get_float(
                "oryx.tsdb.full-resolution-sec", 600.0),
            max_points_per_signal=config.get_int(
                "oryx.tsdb.max-points-per-signal", 512),
            max_total_points=config.get_int("oryx.tsdb.max-total-points", 8192),
            incident_window_sec=config.get_float(
                "oryx.tsdb.incident-window-sec", 300.0),
            signals=signals or None,
            trend_rules=rules,
        )
        old = _ENGINE
        if old is not None:
            for name, ring in old.rings.items():
                tgt = new.rings.get(name)
                if tgt is None:
                    continue
                pts = ring.points()
                with tgt._lock:
                    tgt._times = [t for t, _ in pts]
                    tgt._values = [v for _, v in pts]
            new._prev = dict(old._prev)
            new._prev_wall = old._prev_wall
        _ENGINE = new
        _ensure_sampler_locked(interval)
        return new


def _zero_trend_gauges() -> None:
    for key, _v in _TREND_ACTIVE.samples():
        _TREND_ACTIVE.labels(*key).set(0.0)


def _ensure_sampler_locked(interval: float) -> None:
    global _SAMPLER
    if (_SAMPLER is not None and _SAMPLER.is_alive()
            and abs(_SAMPLER.interval - interval) < 1e-9 and interval > 0):
        return
    _stop_sampler_locked()
    if interval > 0:
        _SAMPLER = _Sampler(interval)
        _SAMPLER.start()


def _stop_sampler_locked(join: bool = False) -> None:
    global _SAMPLER
    sampler, _SAMPLER = _SAMPLER, None
    if sampler is not None:
        sampler.stop_event.set()
        if join and sampler.is_alive():
            sampler.join(timeout=2.0)


def sample_once() -> "dict | None":
    """Manual tick against the live engine (tests, the overhead gate)."""
    eng = _ENGINE
    return None if eng is None else eng.sample_once()


def history_payload(signals=None, since: "float | None" = None) -> dict:
    """The GET /metrics/history response body (also what fleet-status and
    trace_summary --series consume)."""
    eng = _ENGINE
    if eng is None:
        return {"enabled": False, "signals": {}, "trend_alerts": []}
    return {
        "enabled": True,
        "sample_interval_sec": eng.interval_sec,
        "signals": eng.history(signals, since),
        "trend_alerts": eng.trend_alerts(),
    }


def incident_window(window_sec: "float | None" = None) -> "dict | None":
    """Pre-incident series context for blackbox bundles; None while the
    engine is disabled (the bundle section degrades, never raises)."""
    eng = _ENGINE
    return None if eng is None else eng.incident_window(window_sec)


def trend_alerts() -> list:
    eng = _ENGINE
    return [] if eng is None else eng.trend_alerts()


def reset_for_tests() -> None:
    global _ENGINE
    with _configure_lock:
        _stop_sampler_locked(join=True)
        _ENGINE = None
        _zero_trend_gauges()
