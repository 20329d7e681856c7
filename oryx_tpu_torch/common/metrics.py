"""Framework-wide metrics registry with Prometheus text exposition.

A copy of the JAX package's ``oryx_tpu/common/metrics.py`` (host code, no
JAX), held equal to it by ``tests/test_torch_lambda.py``. One change: the
build-info gauge names the torch device the process runs on (its type and
``torch.cuda.get_device_name``), set by :class:`~oryx_tpu_torch.parallel.
mesh.ComputeContext` once it resolves the device, and ``unknown`` until then.

The reference leaned on the Spark UI and JMX for runtime visibility (SURVEY
§5.1: ``oryx.batch.ui.port``/``oryx.speed.ui.port``, ``spark.logConf=true``);
the TPU-native runtime replaces both with ONE dependency-free registry that
every tier writes into and ``GET /metrics`` on the serving layer renders in
Prometheus text-exposition format (docs/observability.md has the catalog).

Design constraints, in order:

  * **hot-path budget ~O(100ns)/event.** A counter increment is one enabled
    check + one short-lived lock acquire + one float add (~0.5–1.3 µs
    end-to-end on the busy CPU test container, Python call + lock
    dominated; see docs/observability.md "Overhead"). Call sites therefore
    instrument unconditionally — no per-site config plumbing.
  * **thread-safe via a single lock per metric family.** Children share the
    family's lock; the critical sections are a few arithmetic ops. There is
    no per-event allocation: histogram buckets are preallocated lists and
    label lookup is one dict probe on a frozen tuple.
  * **bounded label cardinality.** A family stops minting children at the
    registry's ``max_label_cardinality``; excess label sets route to a
    shared no-op child and are counted in
    ``oryx_metrics_dropped_label_sets_total`` so the leak is visible
    instead of unbounded.
  * **registration is idempotent** — modules declare their instruments at
    import time against the process-wide default registry; re-importing or
    re-declaring with an identical signature returns the same family, a
    conflicting signature raises.

Config (``oryx.metrics.*`` in reference_conf, read by :func:`configure`):
``enabled`` (default true — the master kill switch checked per event),
``max-label-cardinality``, and ``require-auth`` (read by the serving app:
whether ``GET /metrics`` sits behind the API's auth).
"""

from __future__ import annotations

import math
import threading
import time
from bisect import bisect_left
from typing import Callable, Iterable

#: Content-Type for the text exposition format (Prometheus scrapers send
#: Accept for 0.0.4; the default answer).
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: Content-Type for the OpenMetrics exposition — the only text format that
#: carries exemplars. GET /metrics answers with it (and renders exemplars)
#: when the scraper's Accept header asks for openmetrics.
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

#: Fixed log-scale latency buckets (seconds): 0.5 ms – 10 s, the serving
#: request/device-call range. Sub-bucket resolution follows the usual
#: 1-2.5-5 decade split.
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)

#: Wider log-scale buckets (seconds) for generation/microbatch steps, which
#: range from milliseconds (empty speed microbatch) to hours (batch retrain).
STEP_BUCKETS = (
    0.005, 0.025, 0.1, 0.5, 2.5, 10.0, 60.0, 300.0, 1800.0, 7200.0,
)

#: Power-of-two buckets for batch-size distributions — the coalescer pads
#: flushes to pow2, so these edges land exactly on the real sizes.
POW2_BUCKETS = tuple(float(1 << i) for i in range(11))  # 1 .. 1024


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value: float) -> str:
    """Prometheus sample value: integral floats render without a dot."""
    if value != value:  # NaN
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def _label_str(labelnames: tuple, labelvalues: tuple) -> str:
    return ",".join(
        f'{n}="{_escape_label(v)}"' for n, v in zip(labelnames, labelvalues)
    )


def _exemplar_suffix(ex: "tuple | None") -> str:
    """OpenMetrics exemplar: `` # {trace_id="…"} value timestamp``. Only the
    openmetrics render emits these — the 0.0.4 text parser would reject the
    suffix."""
    if ex is None:
        return ""
    trace_id, value, ts = ex
    return (f' # {{trace_id="{_escape_label(str(trace_id))}"}} '
            f"{_fmt(value)} {ts:.3f}")


class _NullChild:
    """Sink for label sets past the cardinality cap: accepts every update,
    stores nothing (the drop already got counted)."""

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def set_function(self, fn: "Callable[[], float] | None") -> None:
        pass

    def observe(self, value: float, exemplar: "str | None" = None) -> None:
        pass


_NULL_CHILD = _NullChild()


class _CounterChild:
    __slots__ = ("_lock", "_reg", "_value")

    def __init__(self, lock: threading.Lock, reg: "MetricsRegistry"):
        self._lock = lock
        self._reg = reg
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class _GaugeChild:
    __slots__ = ("_lock", "_reg", "_value", "_fn")

    def __init__(self, lock: threading.Lock, reg: "MetricsRegistry"):
        self._lock = lock
        self._reg = reg
        self._value = 0.0
        # callback gauges: _fn is written by one plain assignment and read
        # by one plain load (both atomic under the GIL), never under the
        # family lock — set_function may be called from consumer threads
        # while a scrape renders
        self._fn: "Callable[[], float] | None" = None

    def inc(self, amount: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set(self, value: float) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value = float(value)

    def set_function(self, fn: "Callable[[], float] | None") -> None:
        """Lazily-evaluated gauge: ``fn()`` is called at scrape time (so a
        costly readout — e.g. a model-load-fraction walk — costs nothing
        per event). Exceptions render as NaN; never let them kill a scrape."""
        self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:  # noqa: BLE001 — a scrape must never 500
                return float("nan")
        with self._lock:
            return self._value

    def _reset(self) -> None:
        self._fn = None
        with self._lock:
            self._value = 0.0


class _HistogramChild:
    __slots__ = ("_lock", "_reg", "_bounds", "_counts", "_sum", "_count",
                 "_exemplars")

    def __init__(self, lock: threading.Lock, reg: "MetricsRegistry",
                 bounds: tuple):
        self._lock = lock
        self._reg = reg
        self._bounds = bounds  # ascending upper bounds, +Inf implicit
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0
        # bucket index -> (trace_id, value, walltime): the LAST exemplar
        # per bucket, so a bad latency bucket points at a concrete trace
        # (common/spans.py). Lazily allocated — most histograms never see one.
        self._exemplars: "dict[int, tuple] | None" = None

    def observe(self, value: float, exemplar: "str | None" = None) -> None:
        if not self._reg.enabled:
            return
        # bucket search outside the lock: bounds are immutable
        i = bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if exemplar:
                if self._exemplars is None:
                    self._exemplars = {}
                self._exemplars[i] = (exemplar, value, time.time())

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _snapshot(self) -> tuple:
        with self._lock:
            return (
                list(self._counts), self._sum, self._count,
                dict(self._exemplars) if self._exemplars else {},
            )

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self._bounds) + 1)
            self._sum = 0.0
            self._count = 0
            self._exemplars = None


class _Family:
    """One named metric family: children keyed by frozen label-value tuples,
    all sharing a single lock."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, labelnames: tuple,
                 registry: "MetricsRegistry"):
        self.name = name
        self.help = help_
        self.labelnames = labelnames
        self._registry = registry
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}
        # label-less families get their one child eagerly so call sites can
        # use the family itself as the instrument (fam.inc() / fam.observe())
        self._default = self._make_child() if not labelnames else None

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *labelvalues):
        """Child for one frozen label-value tuple; past the registry's
        cardinality cap, a shared no-op child (the drop is counted)."""
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {labelvalues!r}"
            )
        if not self.labelnames:
            return self._default
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self._registry.max_label_cardinality:
                    dropped = self._registry._dropped
                    if dropped is not None:
                        dropped.inc()
                    return _NULL_CHILD
                child = self._children[key] = self._make_child()
            return child

    def _items(self) -> list:
        with self._lock:
            items = list(self._children.items())
        if self._default is not None:
            items.append(((), self._default))
        return sorted(items, key=lambda kv: kv[0])

    def reset(self) -> None:
        for _, child in self._items():
            child._reset()

    # label-less convenience: delegate to the eager default child
    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    def render_samples(self, out: list, exemplars: bool = False) -> None:
        raise NotImplementedError

    def snapshot_into(self, out: dict) -> None:
        raise NotImplementedError


class Counter(_Family):
    kind = "counter"

    def _make_child(self) -> _CounterChild:
        return _CounterChild(self._lock, self._registry)

    @property
    def value(self) -> float:
        return self._default.value

    def samples(self) -> "list[tuple[tuple, float]]":
        """(label-values, value) pairs, unordered — the programmatic read
        the SLO engine and health surfaces use instead of re-parsing
        exposition. ONE lock acquisition for the whole family (children
        share the family lock, so per-child ``.value`` reads would pay a
        lock round-trip each — this walk runs on every scrape)."""
        with self._lock:
            out = [
                (key, child._value) for key, child in self._children.items()
            ]
            if self._default is not None:
                out.append(((), self._default._value))
        return out

    def render_samples(self, out: list, exemplars: bool = False) -> None:
        for key, child in self._items():
            ls = _label_str(self.labelnames, key)
            out.append(f"{self.name}{{{ls}}} {_fmt(child.value)}" if ls
                       else f"{self.name} {_fmt(child.value)}")

    def snapshot_into(self, out: dict) -> None:
        out[self.name] = {
            _label_str(self.labelnames, key): child.value
            for key, child in self._items()
        }


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild(self._lock, self._registry)

    def dec(self, amount: float = 1.0) -> None:
        self._default.dec(amount)

    def set(self, value: float) -> None:
        self._default.set(value)

    def set_function(self, fn: "Callable[[], float] | None") -> None:
        self._default.set_function(fn)

    @property
    def value(self) -> float:
        return self._default.value

    def samples(self) -> "list[tuple[tuple, float]]":
        """(label-values, value) pairs, callback gauges evaluated now."""
        return [(key, child.value) for key, child in self._items()]

    def render_samples(self, out: list, exemplars: bool = False) -> None:
        for key, child in self._items():
            ls = _label_str(self.labelnames, key)
            out.append(f"{self.name}{{{ls}}} {_fmt(child.value)}" if ls
                       else f"{self.name} {_fmt(child.value)}")

    def snapshot_into(self, out: dict) -> None:
        out[self.name] = {
            _label_str(self.labelnames, key): child.value
            for key, child in self._items()
        }


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help_, labelnames, registry,
                 buckets: Iterable = LATENCY_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"{name}: buckets must be strictly ascending")
        if bounds and math.isinf(bounds[-1]):
            bounds = bounds[:-1]  # +Inf is implicit
        self.buckets = bounds
        super().__init__(name, help_, labelnames, registry)

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self._lock, self._registry, self.buckets)

    def observe(self, value: float, exemplar: "str | None" = None) -> None:
        self._default.observe(value, exemplar)

    @property
    def count(self) -> int:
        return self._default.count

    @property
    def sum(self) -> float:
        return self._default.sum

    def bucket_samples(self) -> "list[tuple[tuple, list, float, int]]":
        """(label-values, per-bucket raw counts with the +Inf overflow
        last, sum, count) per child, unordered — the bounds are
        :attr:`buckets`. The SLO engine's latency objective reads
        cumulative under-threshold counts from this instead of parsing
        its own exposition; like :meth:`Counter.samples`, one lock
        acquisition covers the whole family."""
        with self._lock:
            out = [
                (key, list(child._counts), child._sum, child._count)
                for key, child in self._children.items()
            ]
            if self._default is not None:
                d = self._default
                out.append(((), list(d._counts), d._sum, d._count))
        return out

    def render_samples(self, out: list, exemplars: bool = False) -> None:
        for key, child in self._items():
            counts, total, n, exs = child._snapshot()
            base = _label_str(self.labelnames, key)
            cum = 0
            for i, (bound, c) in enumerate(zip(self.buckets, counts)):
                cum += c
                ls = f"{base},le=\"{_fmt(bound)}\"" if base else f'le="{_fmt(bound)}"'
                out.append(f"{self.name}_bucket{{{ls}}} {cum}"
                           + _exemplar_suffix(exs.get(i) if exemplars else None))
            cum += counts[-1]
            ls = f'{base},le="+Inf"' if base else 'le="+Inf"'
            out.append(f"{self.name}_bucket{{{ls}}} {cum}"
                       + _exemplar_suffix(
                           exs.get(len(self.buckets)) if exemplars else None))
            out.append(f"{self.name}_sum{{{base}}} {_fmt(total)}" if base
                       else f"{self.name}_sum {_fmt(total)}")
            out.append(f"{self.name}_count{{{base}}} {n}" if base
                       else f"{self.name}_count {n}")

    def snapshot_into(self, out: dict) -> None:
        counts = out.setdefault(f"{self.name}_count", {})
        sums = out.setdefault(f"{self.name}_sum", {})
        for key, child in self._items():
            _, total, n, _exs = child._snapshot()
            ls = _label_str(self.labelnames, key)
            counts[ls] = n
            sums[ls] = total


_FAMILY_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Process-wide metric store: named families, text exposition, snapshot.

    ``enabled`` is the master kill switch checked per event (a plain
    attribute read — deliberately not under any lock, written only by
    :func:`configure` / tests). ``max_label_cardinality`` bounds children
    per family."""

    def __init__(self, max_label_cardinality: int = 512, enabled: bool = True):
        self.enabled = enabled
        self.max_label_cardinality = max_label_cardinality
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        self._dropped: "Counter | None" = None  # set below; checked in labels()
        self._dropped = self.counter(
            "oryx_metrics_dropped_label_sets_total",
            "Label sets dropped by the per-family cardinality cap",
        )

    # -- registration (idempotent) -------------------------------------------
    def _register(self, kind: str, name: str, help_: str, labelnames,
                  buckets=None) -> _Family:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames or (
                    buckets is not None
                    and tuple(float(b) for b in buckets) != fam.buckets
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames} — conflicting re-registration"
                    )
                return fam
            if kind == "histogram":
                fam = Histogram(name, help_, labelnames, self,
                                buckets if buckets is not None else LATENCY_BUCKETS)
            else:
                fam = _FAMILY_KINDS[kind](name, help_, labelnames, self)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str, labelnames=()) -> Counter:
        return self._register("counter", name, help_, labelnames)

    def gauge(self, name: str, help_: str, labelnames=()) -> Gauge:
        return self._register("gauge", name, help_, labelnames)

    def histogram(self, name: str, help_: str, labelnames=(),
                  buckets: Iterable = LATENCY_BUCKETS) -> Histogram:
        return self._register("histogram", name, help_, labelnames, buckets)

    def get(self, name: str) -> "_Family | None":
        """Registered family by name (health probes read gauges this way
        instead of importing every instrumenting module)."""
        with self._lock:
            return self._families.get(name)

    # -- output ---------------------------------------------------------------
    def render(self, exemplars: bool = False) -> str:
        """Prometheus text exposition (format 0.0.4), families sorted by
        name, children by label values — deterministic for golden tests.
        ``exemplars=True`` renders OpenMetrics instead: same samples plus
        per-bucket trace-id exemplars and the ``# EOF`` terminator."""
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        out: list[str] = []
        for fam in fams:
            family = fam.name
            if exemplars and fam.kind == "counter" and family.endswith("_total"):
                # OpenMetrics names the counter FAMILY without the suffix
                # and its samples '<family>_total'; announcing the family
                # as 'x_total' makes strict parsers (Prometheus negotiates
                # this format by default) reject the whole scrape
                family = family[: -len("_total")]
            out.append(f"# HELP {family} {_escape_help(fam.help)}")
            out.append(f"# TYPE {family} {fam.kind}")
            fam.render_samples(out, exemplars=exemplars)
        if exemplars:
            out.append("# EOF")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """JSON-able flat view — sample name -> {label string: value};
        histograms contribute ``_count``/``_sum`` only (buckets stay in
        :meth:`render`). This is what ``bench.py`` embeds in BENCH_*.json."""
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        out: dict = {}
        for fam in fams:
            fam.snapshot_into(out)
        return out

    def reset(self) -> None:
        """Zero every child (families and label sets stay registered) —
        test isolation for the process-wide default registry."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            fam.reset()


_DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every module instruments against."""
    return _DEFAULT_REGISTRY


# -- standard process metrics (registered at registry init, so every tier
# and the fleet table get them for free) ------------------------------------

_PROCESS_START_TIME = _DEFAULT_REGISTRY.gauge(
    "oryx_process_start_time_seconds",
    "Unix time this process's metrics registry initialized "
    "(uptime = scrape time minus this)",
)
_PROCESS_START_TIME.set(time.time())

_BUILD_INFO = _DEFAULT_REGISTRY.gauge(
    "oryx_build_info",
    "Always 1 on the labels describing this process: framework version, "
    "torch device type, and device kind (unknown until a compute context "
    "resolves its device)",
    ("version", "backend", "device_kind"),
)


def _framework_version() -> str:
    try:
        import oryx_tpu_torch

        return oryx_tpu_torch.__version__
    except Exception:  # noqa: BLE001 — partial-init import orders
        return "unknown"


def set_build_info(backend: str = "unknown",
                   device_kind: str = "unknown") -> None:
    """(Re-)point the build-info sample. Called once at import with the
    backend unknown, and again by a compute context once its torch device
    is resolved (the Prometheus info-metric idiom: superseded label sets
    drop to 0, the current one reads 1)."""
    version = _framework_version()
    for key, _value in _BUILD_INFO.samples():
        _BUILD_INFO.labels(*key).set(0.0)
    _BUILD_INFO.labels(version, str(backend), str(device_kind)).set(1.0)


set_build_info()


def configure(config, registry: "MetricsRegistry | None" = None) -> MetricsRegistry:
    """Apply ``oryx.metrics.*`` config to a registry (the default one unless
    given). Called by the serving app factory and the layer runtimes, so any
    entry point honors the declared keys."""
    reg = registry if registry is not None else _DEFAULT_REGISTRY
    reg.enabled = config.get_bool("oryx.metrics.enabled", True)
    reg.max_label_cardinality = config.get_int(
        "oryx.metrics.max-label-cardinality", 512
    )
    return reg
