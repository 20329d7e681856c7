"""SLO burn-rate engine: objectives from config, multi-window burn-rate
alerting over the live metrics registry.

A copy of the JAX package's ``oryx_tpu/common/slo.py`` (host code, no
JAX), held equal to it by ``tests/test_torch_slo_tsdb.py``.

The low-latency serving work this framework benchmarks against
(PAPERS.md, arXiv:2007.05832) defines success as TAIL objectives —
"p99 under X ms", "99.9% available" — and Google's ads-training infra
(arXiv:2501.10546) treats fleet-level SLO monitoring as part of the
stack, not an afterthought. This module is the per-replica half of that:
objectives declared in ``oryx.slo.*`` are evaluated continuously over the
process metrics registry and exposed as three gauge families every tier
renders:

  * ``oryx_slo_burn_rate{slo,window}`` — how many times faster than
    sustainable the error budget is burning, per sliding window. Burn 1.0
    = exactly on budget; burn 14.4 over 5m = the whole 30-day budget in
    ~2 days (the classic Google SRE workbook framing).
  * ``oryx_slo_error_budget_remaining{slo}`` — fraction of the budget
    left over the objective's accounting window.
  * ``oryx_slo_alert_active{slo,severity}`` — multi-window alerts:
    ``page`` fires when BOTH the 5m and 1h burn rates exceed the fast
    threshold (default 14.4); ``ticket`` when BOTH 30m and 6h exceed the
    slow threshold (default 6). Requiring both windows kills the two
    classic false-alarm modes: a short blip (fails the long window) and a
    long-recovered incident (fails the short window).

Objectives (docs/slo.md has the grammar and the window math):

  * **availability** — fraction of non-probe HTTP requests that did not
    answer 5xx, read from ``oryx_serving_requests_total``.
  * **latency** — fraction of non-probe requests under ``threshold-ms``,
    read from the ``oryx_serving_request_latency_seconds`` buckets (the
    threshold snaps to the nearest bucket edge at or above it).

Evaluation is SCRAPE-DRIVEN: the gauges are registry callbacks, so every
``GET /metrics`` scrape (a Prometheus poller, ``cli fleet-status``, the
``--watch`` loop) advances the sliding windows — the same pull model as
every other scrape-time gauge, with one memoized evaluation per scrape.
``GET /readyz`` includes the active-alert list in its body (informational:
budget exhaustion must not rotate a healthy replica out of the balancer),
and alert EDGES are recorded in the flight recorder (common/blackbox.py).
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right

from oryx_tpu_torch.common import blackbox
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import tsdb

_BURN = metrics_mod.default_registry().gauge(
    "oryx_slo_burn_rate",
    "Error-budget burn rate per SLO and sliding window (1.0 = exactly on "
    "budget; evaluated at scrape time)",
    ("slo", "window"),
)
_BUDGET = metrics_mod.default_registry().gauge(
    "oryx_slo_error_budget_remaining",
    "Fraction of the SLO's error budget remaining over its accounting "
    "window (1.0 = untouched, 0.0 = exhausted; scrape-time)",
    ("slo",),
)
_ALERT = metrics_mod.default_registry().gauge(
    "oryx_slo_alert_active",
    "1 while a multi-window burn-rate alert is firing (page = fast 5m/1h "
    "pair, ticket = slow 30m/6h pair; scrape-time)",
    ("slo", "severity"),
)

#: Route-template suffixes excluded from SLO accounting: probe and
#: operator surfaces whose request rate is scrape cadence, not user
#: traffic (suffix match so context-path prefixes stay excluded too).
OPS_ROUTE_SUFFIXES = (
    "/metrics", "/trace", "/lineage", "/healthz", "/readyz", "/ready",
    "/error",
)
OPS_ROUTE_PARTS = ("/debug/",)


#: route -> classification memo. The readers run per scrape over every
#: label set of the request families, and the string checks dominated the
#: evaluation cost before this cache; bounded because route templates are
#: themselves cardinality-capped, with a hard cap for untrusted inputs
#: (federated expositions).
_OPS_CACHE: dict = {}
_OPS_CACHE_MAX = 4096


def is_ops_route(route: str) -> bool:
    hit = _OPS_CACHE.get(route)
    if hit is None:
        hit = route.endswith(OPS_ROUTE_SUFFIXES) or any(
            part in route for part in OPS_ROUTE_PARTS
        )
        if len(_OPS_CACHE) < _OPS_CACHE_MAX:
            _OPS_CACHE[route] = hit
    return hit


_is_ops_route = is_ops_route  # internal alias used below


def _window_label(seconds: float) -> str:
    seconds = int(seconds)
    if seconds % 3600 == 0:
        return f"{seconds // 3600}h"
    if seconds % 60 == 0:
        return f"{seconds // 60}m"
    return f"{seconds}s"


class Objective:
    """One declared SLO: a name, a good-fraction target, and a reader
    returning cumulative (good, total) event counts from the registry."""

    def __init__(self, name: str, objective_pct: float, window_sec: float,
                 reader):
        if not 0.0 < objective_pct < 100.0:
            raise ValueError(
                f"slo {name!r}: objective must be in (0, 100), "
                f"got {objective_pct}"
            )
        self.name = name
        self.objective_pct = float(objective_pct)
        self.budget = 1.0 - self.objective_pct / 100.0
        self.window_sec = float(window_sec)
        self.reader = reader


def _availability_reader(registry):
    """Cumulative (good, total) over oryx_serving_requests_total: good =
    everything except 5xx; cancelled client disconnects are not requests
    the server answered, so they count in neither. Per-label-set
    classification is memoized — the walk runs on every scrape, and label
    sets are cardinality-capped by the registry."""
    classify: dict = {}  # label tuple -> "x" excluded / "g" good / "b" bad

    def read() -> tuple:
        fam = registry.get("oryx_serving_requests_total")
        if fam is None:
            return 0.0, 0.0
        good = total = 0.0
        for key, value in fam.samples():
            c = classify.get(key)
            if c is None:
                if len(key) != 3:
                    c = "x"
                else:
                    route, _method, status = key
                    if _is_ops_route(route) or status == "cancelled":
                        c = "x"
                    elif status.startswith("5"):
                        c = "b"
                    else:
                        c = "g"
                if len(classify) < _OPS_CACHE_MAX:
                    classify[key] = c
            if c == "x":
                continue
            total += value
            if c == "g":
                good += value
        return good, total

    return read


def _latency_reader(registry, threshold_ms: float):
    """Cumulative (good, total) over the request-latency histogram: good =
    observations at or under the bucket edge nearest above threshold-ms
    (a documented snap — exact thresholds need an exact bucket edge)."""
    threshold_s = threshold_ms / 1000.0
    excluded: dict = {}  # label tuple -> bool (memoized, scrape-hot walk)
    edge_memo: dict = {}  # bucket bounds -> containing edge index

    def read() -> tuple:
        fam = registry.get("oryx_serving_request_latency_seconds")
        if fam is None:
            return 0.0, 0.0
        bounds = fam.buckets
        edge_i = edge_memo.get(bounds, -2)
        if edge_i == -2:
            edge_i = edge_memo[bounds] = next(
                (i for i, b in enumerate(bounds)
                 if b >= threshold_s - 1e-12), None,
            )
        good = total = 0.0
        for key, counts, _sum, n in fam.bucket_samples():
            skip = excluded.get(key)
            if skip is None:
                skip = _is_ops_route(key[0] if key else "")
                if len(excluded) < _OPS_CACHE_MAX:
                    excluded[key] = skip
            if skip:
                continue
            total += n
            if edge_i is None:
                good += n  # threshold above every bucket: all observations good
            else:
                good += sum(counts[: edge_i + 1])
        return good, total

    return read


def _freshness_reader(threshold_sec: float):
    """Cumulative (good, total) over the model-data-freshness watermark
    (common/lineage.py): each engine evaluation samples the live model's
    data age once — good when it is at or under ``threshold-sec``. No
    sample is taken while no watermark is known (a replica that never
    adopted a stamped generation is unknown, not stale), so the objective
    stays silent until lineage is actually flowing."""
    from oryx_tpu_torch.common import lineage

    state = {"good": 0.0, "total": 0.0}

    def read() -> tuple:
        freshness = lineage.freshness_seconds()
        if freshness is not None:
            state["total"] += 1.0
            if freshness <= threshold_sec:
                state["good"] += 1.0
        return state["good"], state["total"]

    return read


class SloEngine:
    """Sliding-window burn-rate evaluation over cumulative (good, total)
    readers.

    Each evaluation appends one (time, readings) sample to a bounded deque
    and computes windowed deltas against the newest sample at least W old
    (falling back to the OLDEST sample while history is shorter than W —
    a young replica's "5m" burn covers its whole life, which is exactly
    what an operator wants from it). Evaluations are memoized for
    ``min_eval_interval_sec`` so one scrape costs one evaluation no matter
    how many gauge callbacks it renders."""

    #: (window label pairs, severity, default threshold) for the two
    #: multi-window alert tiers (Google SRE workbook's 5m/1h + 30m/6h).
    FAST_WINDOWS = (300.0, 3600.0)
    SLOW_WINDOWS = (1800.0, 21600.0)

    #: Hard count bound on retained samples (the time horizon alone would
    #: let a fast probe cadence grow the history to the budget window ×
    #: the memoization rate); past it the oldest half decimates 2:1.
    MAX_SAMPLES = 4096

    def __init__(self, objectives: "list[Objective]",
                 fast_threshold: float = 14.4, slow_threshold: float = 6.0,
                 min_events: int = 10, min_eval_interval_sec: float = 0.5,
                 fast_windows: "tuple | None" = None,
                 slow_windows: "tuple | None" = None,
                 clock=time.monotonic):
        self.objectives = list(objectives)
        self.fast_threshold = float(fast_threshold)
        self.slow_threshold = float(slow_threshold)
        self.min_events = max(1, int(min_events))
        self.min_eval_interval_sec = float(min_eval_interval_sec)
        self.fast_windows = tuple(fast_windows or self.FAST_WINDOWS)
        self.slow_windows = tuple(slow_windows or self.SLOW_WINDOWS)
        self._clock = clock
        self._lock = threading.Lock()
        self._alerts: dict[tuple, bool] = {}
        self._cached: "dict | None" = None
        self._cached_at = float("-inf")
        self._max_window = max(
            *self.fast_windows, *self.slow_windows,
            *(o.window_sec for o in self.objectives), 0.0,
        )
        # precomputed (seconds, label) pairs and alert specs: evaluate()
        # runs per scrape, so no label string is ever rebuilt there
        self._windows_labeled = tuple(
            (w, _window_label(w))
            for w in sorted(set(self.fast_windows + self.slow_windows))
        )
        self._alert_specs = (
            ("page", tuple(_window_label(w) for w in self.fast_windows),
             self.fast_threshold),
            ("ticket", tuple(_window_label(w) for w in self.slow_windows),
             self.slow_threshold),
        )
        # sample history rides the shared series-ring primitive
        # (common/tsdb.py) in "oldest half" mode — the same horizon trim
        # and 2:1 count-bound decimation the private parallel arrays did,
        # now the ONE implementation /metrics/history is also built on, so
        # burn windows and recorded history can never diverge. lock=False:
        # every touch is already serialized under self._lock (windowing
        # bisects on the time column; a linear scan would walk hours of
        # scrape samples per evaluation).
        self._history = tsdb.SeriesRing(
            self._max_window + 60.0, self.MAX_SAMPLES,
            full_resolution_sec=None, lock=False,
        )
        # seed a baseline sample at BIRTH: while history is younger than a
        # window, deltas fall back to the oldest sample, and without this
        # seed that would be the FIRST EVALUATION's — anything counted
        # between engine construction and that first scrape would vanish
        # from every window at the second scrape (a burst erroring before
        # the first scrape must stay visible, and an alert it raised must
        # decay on window time, not on scrape cadence)
        self._history.append(
            self._clock(), {o.name: o.reader() for o in self.objectives}
        )

    @property
    def windows(self) -> "tuple[float, ...]":
        return tuple(w for w, _label in self._windows_labeled)

    # attribute-shaped views of the ring's columns: pre-migration tests and
    # tooling reach for eng._times / eng._readings directly
    @property
    def _times(self) -> "list[float]":
        return self._history._times

    @property
    def _readings(self) -> "list[dict]":
        return self._history._values

    def _delta(self, name: str, now: float, window_sec: float,
               current: tuple) -> tuple:
        """(good, total) accumulated over the trailing window: current
        cumulative minus the newest sample at least window_sec old (or the
        oldest sample available — see class docstring). One bisect over
        the time-ordered sample array."""
        times = self._times
        if not times:
            base = (0.0, 0.0)
        else:
            # newest index with t <= now - window_sec; -1 -> history is
            # younger than the window -> oldest sample covers it
            i = bisect_right(times, now - window_sec) - 1
            base = self._readings[max(0, i)].get(name, (0.0, 0.0))
        return max(0.0, current[0] - base[0]), max(0.0, current[1] - base[1])

    def _burn(self, objective: Objective, delta: tuple) -> float:
        good, total = delta
        if total < self.min_events:
            return 0.0
        bad_fraction = (total - good) / total
        return bad_fraction / objective.budget

    def evaluate(self, force: bool = False) -> dict:
        """One evaluation pass: sample, window, burn, alert edges. Returns
        {objective: {burn_rate: {label: x}, budget_remaining, alerts}}."""
        with self._lock:
            now = self._clock()
            if (not force and self._cached is not None
                    and now - self._cached_at < self.min_eval_interval_sec):
                return self._cached
            readings = {o.name: o.reader() for o in self.objectives}
            status: dict = {}
            for o in self.objectives:
                current = readings[o.name]
                burns = {}
                for w, label in self._windows_labeled:
                    burns[label] = self._burn(
                        o, self._delta(o.name, now, w, current)
                    )
                budget_good, budget_total = self._delta(
                    o.name, now, o.window_sec, current
                )
                if budget_total > 0:
                    consumed = ((budget_total - budget_good)
                                / (budget_total * o.budget))
                else:
                    consumed = 0.0
                alerts = {}
                for severity, pair_labels, threshold in self._alert_specs:
                    active = all(
                        burns[label] > threshold for label in pair_labels
                    )
                    alerts[severity] = active
                    key = (o.name, severity)
                    was = self._alerts.get(key, False)
                    if active != was:
                        self._alerts[key] = active
                        blackbox.record_event(
                            "slo.alert",
                            severity="error" if active else "info",
                            slo=o.name, alert_severity=severity,
                            active=active,
                            burn_rates={label: round(burns[label], 2)
                                        for label in pair_labels},
                        )
                status[o.name] = {
                    "objective_pct": o.objective_pct,
                    "burn_rate": burns,
                    "budget_remaining": max(0.0, min(1.0, 1.0 - consumed)),
                    "alerts": alerts,
                }
            # sample AFTER computing deltas: a window must never compare
            # the current reading against itself. The ring applies the
            # horizon trim (keep >= 1 sample) plus the MAX_SAMPLES
            # oldest-half 2:1 decimation — a 1s probe cadence against a
            # 24h budget window would otherwise retain ~170k samples, and
            # long-window bases only need coarse granularity back there
            # (window deltas stay correct, just snapped to a slightly
            # older base). max_points re-reads MAX_SAMPLES so per-instance
            # overrides keep working.
            self._history.max_points = int(self.MAX_SAMPLES)
            self._history.append(now, readings)
            self._cached = status
            self._cached_at = now
            return status

    def active_alerts(self) -> list:
        """[{slo, severity, burn rates}] for every firing alert — what
        /readyz embeds and the fleet table counts."""
        status = self.evaluate()
        out = []
        for name, s in status.items():
            for severity, active in s["alerts"].items():
                if active:
                    out.append({
                        "slo": name,
                        "severity": severity,
                        "burn_rate": s["burn_rate"],
                        "budget_remaining": s["budget_remaining"],
                    })
        return out

    def wire_gauges(self) -> None:
        """Point the oryx_slo_* gauge children at this engine (memoized
        evaluation: one real pass per scrape)."""
        for o in self.objectives:
            name = o.name
            for w in self.windows:
                label = _window_label(w)
                _BURN.labels(name, label).set_function(
                    lambda n=name, lb=label:
                        self.evaluate()[n]["burn_rate"][lb]
                )
            _BUDGET.labels(name).set_function(
                lambda n=name: self.evaluate()[n]["budget_remaining"]
            )
            for severity in ("page", "ticket"):
                _ALERT.labels(name, severity).set_function(
                    lambda n=name, sv=severity:
                        1.0 if self.evaluate()[n]["alerts"][sv] else 0.0
                )


def _reset_stale_gauges(active_slos: set) -> None:
    """Quiet the gauge children of objectives the new configuration no
    longer declares: without this, a reconfigure that drops an objective
    (or disables the engine) left its children evaluating through the OLD
    engine forever — stale exposition, and the superseded engine plus its
    sample history pinned alive by the callbacks."""
    for fam in (_BURN, _BUDGET, _ALERT):
        with fam._lock:
            children = list(fam._children.items())
        for key, child in children:
            if key and key[0] not in active_slos:
                child._reset()  # clears the callback and zeroes the value


_ENGINE: "SloEngine | None" = None
_configure_lock = threading.Lock()


def engine() -> "SloEngine | None":
    return _ENGINE


def configure(config) -> "SloEngine | None":
    """Build the process engine from ``oryx.slo.*`` and wire the gauges
    (idempotent; every layer entry point calls it like metrics.configure).
    Disabled or zero-objective configs leave the engine absent with every
    slo gauge child quieted; a reconfigure that drops one objective
    quiets just that objective's children."""
    global _ENGINE
    with _configure_lock:
        if not config.get_bool("oryx.slo.enabled", True):
            _ENGINE = None
            _reset_stale_gauges(set())
            return None
        registry = metrics_mod.default_registry()
        objectives: list[Objective] = []
        avail = config.get_config("oryx.slo.availability")
        if avail.get_bool("enabled", True):
            objectives.append(Objective(
                "availability",
                avail.get_float("objective", 99.9),
                avail.get_float("window-sec", 86400.0),
                _availability_reader(registry),
            ))
        lat = config.get_config("oryx.slo.latency")
        if lat.get_bool("enabled", False):
            objectives.append(Objective(
                "latency",
                lat.get_float("objective", 99.0),
                lat.get_float("window-sec", 86400.0),
                _latency_reader(registry, lat.get_float("threshold-ms", 500.0)),
            ))
        fresh = config.get_config("oryx.slo.freshness")
        if fresh.get_bool("enabled", False):
            # data-freshness objective: burn-rate alerting when the live
            # model's input-data age exceeds threshold-sec — the bounded-
            # staleness contract of the lambda architecture as an SLO
            objectives.append(Objective(
                "freshness",
                fresh.get_float("objective", 99.0),
                fresh.get_float("window-sec", 86400.0),
                _freshness_reader(fresh.get_float("threshold-sec", 600.0)),
            ))
        if not objectives:
            _ENGINE = None
            _reset_stale_gauges(set())
            return None
        burn = config.get_config("oryx.slo.burn-rate")
        _ENGINE = SloEngine(
            objectives,
            fast_threshold=burn.get_float("fast-threshold", 14.4),
            slow_threshold=burn.get_float("slow-threshold", 6.0),
            min_events=config.get_int("oryx.slo.min-events", 10),
        )
        _reset_stale_gauges({o.name for o in objectives})
        _ENGINE.wire_gauges()
        return _ENGINE


def status(force: bool = False) -> dict:
    """Current evaluation ({} when no engine) — what bundles embed."""
    eng = _ENGINE
    return eng.evaluate(force=force) if eng is not None else {}


def active_alerts() -> list:
    """Firing alerts ([] when no engine) — what /readyz embeds."""
    eng = _ENGINE
    return eng.active_alerts() if eng is not None else []
