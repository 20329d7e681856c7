"""Per-request distributed tracing: spans, trace propagation, ring buffer.

A copy of the JAX package's ``oryx_tpu/common/spans.py`` (host code, no
JAX), held equal to it by ``tests/test_torch_lambda.py``.

The metrics registry (``common/metrics.py``) answers *aggregate* questions —
"what is p99?" — but cannot attribute ONE slow request to queue wait in
the coalescer vs a pow2-padding recompile vs device RTT. This module is
the per-request side: a dependency-free tracing core in the shape serving
dataflows use (Cloudburst, arXiv:2007.05832, instruments exactly this
request path; arXiv:2501.10546 makes the tier-crossing case):

  * **ids**: 128-bit trace ids / 64-bit span ids, W3C ``traceparent``
    compatible (``00-<32hex>-<16hex>-<2hex>``), so context rides HTTP
    headers and topic-message headers unchanged through any intermediary.
  * **current span** is carried in a :mod:`contextvars` ContextVar —
    asyncio tasks inherit it for free; executor hops do NOT on this
    Python (``loop.run_in_executor`` never copies context), so thread
    handoffs either go through ``asyncio.to_thread`` (which does) or
    carry an explicit :class:`SpanContext` (the coalescer stores one
    per queued request).
  * **fan-in is a span link, not a parent**: one coalesced device call
    serves many requests from many traces; the device-call span parents
    into the FIRST waiter's trace and *links* to every waiter
    (OpenTelemetry link semantics), with batch-size/pad-waste recorded
    as attributes so a padding-induced recompile is visible on the span.
  * **bounded ring buffer, lock-free reads**: finished spans land in a
    preallocated ring (one short writer lock; readers snapshot the list
    without any lock — slot stores are atomic under the GIL). Retention
    is reservoir-style: the ring holds the most recent spans, and a
    per-route min-heap *always* keeps the slowest N per route even after
    the ring has wrapped — the p99 outlier survives until a slower one
    displaces it.
  * ``GET /trace`` (serving/resources/common.py) renders both views;
    ``python -m oryx_tpu_torch.tools.trace_summary <url> --trace-id <id>``
    prints one trace as a tree.

Config (``oryx.tracing.spans.*``): ``enabled`` (default true; a disabled
recorder costs one attribute read per would-be span), ``ring-size``,
``slowest-per-route``. Distinct from ``oryx.tracing.enabled``, which
drives the StepTracer's *logging/profiling* side.
"""

from __future__ import annotations

import contextvars
import dataclasses
import heapq
import itertools
import logging
import threading
import time
from contextlib import contextmanager

#: Response/request header and topic-message header key (W3C Trace Context).
TRACEPARENT = "traceparent"

_rand = __import__("random").SystemRandom()


def new_trace_id() -> str:
    return f"{_rand.getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_rand.getrandbits(64):016x}"


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """The propagatable identity of a span (what rides a header)."""

    trace_id: str  # 32 lowercase hex chars
    span_id: str  # 16 lowercase hex chars
    sampled: bool = True

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"


def parse_traceparent(value: "str | None") -> "SpanContext | None":
    """W3C traceparent -> SpanContext; None on any malformation (a broken
    header must start a fresh trace, never crash the request)."""
    if not value:
        return None
    parts = value.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if version == "ff" or len(version) != 2:
        return None
    if version == "00" and len(parts) != 4:
        # version 00 defines exactly 4 fields; trailing data is malformed
        # (future versions may append fields, so only 00 is strict)
        return None
    if len(trace_id) != 32 or len(span_id) != 16 or len(flags) != 2:
        return None
    try:
        int(version, 16)
        int(flags, 16)
        if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
            return None
    except ValueError:
        return None
    return SpanContext(trace_id, span_id, sampled=bool(int(flags, 16) & 1))


class Span:
    """One timed operation. Mutable while open; :meth:`end` freezes duration
    and hands it to the recorder. Attribute writes after end are ignored."""

    __slots__ = (
        "name", "context", "parent_id", "start_walltime", "duration",
        "attributes", "links", "status", "_start_perf", "_ended",
    )

    def __init__(self, name: str, context: SpanContext,
                 parent_id: "str | None" = None,
                 links: "tuple[SpanContext, ...]" = (),
                 attributes: "dict | None" = None):
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.start_walltime = time.time()
        self._start_perf = time.perf_counter()
        self.duration = 0.0
        self.attributes: dict = dict(attributes) if attributes else {}
        self.links: list[SpanContext] = list(links)
        self.status = "ok"
        self._ended = False

    def set_attribute(self, key: str, value) -> None:
        if not self._ended:
            self.attributes[key] = value

    def record_exception(self, exc: BaseException) -> None:
        if not self._ended:
            self.status = f"error: {type(exc).__name__}"

    def end(self) -> None:
        if self._ended:
            return
        self.duration = time.perf_counter() - self._start_perf
        self._ended = True

    @property
    def trace_id(self) -> str:
        return self.context.trace_id

    @property
    def span_id(self) -> str:
        return self.context.span_id

    def to_dict(self) -> dict:
        return {
            "trace_id": self.context.trace_id,
            "span_id": self.context.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": round(self.start_walltime, 6),
            "duration_ms": round(self.duration * 1000.0, 3),
            "status": self.status,
            "attributes": self.attributes,
            "links": [
                {"trace_id": c.trace_id, "span_id": c.span_id}
                for c in self.links
            ],
        }


class _NoopSpan:
    """Returned by :func:`start_span` when recording is disabled: accepts
    every mutation, records nothing, carries no context."""

    __slots__ = ()
    context = None
    trace_id = ""
    span_id = ""

    def set_attribute(self, key: str, value) -> None:
        pass

    def record_exception(self, exc) -> None:
        pass

    def end(self) -> None:
        pass


NOOP_SPAN = _NoopSpan()

#: The current span for this task/thread. asyncio tasks snapshot it at task
#: creation; threads each see their own (executor hops use
#: asyncio.to_thread or an explicit SpanContext).
_CURRENT: "contextvars.ContextVar[Span | None]" = contextvars.ContextVar(
    "oryx_current_span", default=None
)


class SpanRecorder:
    """Bounded ring of finished spans + slowest-N-per-route retention.

    Writers serialize on one short lock (a slot store, a counter bump, at
    most one heap push/replace). Readers never take it: they snapshot the
    ring with ``list(...)`` — safe because each slot is replaced by a
    single atomic-under-the-GIL store — so a scrape of ``GET /trace``
    can never stall the request path."""

    def __init__(self, ring_size: int = 2048, slowest_per_route: int = 5):
        self.ring_size = max(16, int(ring_size))
        self.slowest_per_route = max(1, int(slowest_per_route))
        self._slots: "list[Span | None]" = [None] * self.ring_size
        self._next = 0
        self._recorded = 0
        self._lock = threading.Lock()
        self._tiebreak = itertools.count()
        # route -> min-heap of (duration, tiebreak, span); the heap root is
        # the FASTEST of the kept-slowest, so one heapreplace keeps the
        # invariant "always the slowest N per route"
        self._slowest: dict[str, list] = {}

    def record(self, span: Span) -> None:
        route = str(span.attributes.get("route", span.name))
        with self._lock:
            self._slots[self._next] = span
            self._next = (self._next + 1) % self.ring_size
            self._recorded += 1
            heap = self._slowest.setdefault(route, [])
            entry = (span.duration, next(self._tiebreak), span)
            if len(heap) < self.slowest_per_route:
                heapq.heappush(heap, entry)
            elif span.duration > heap[0][0]:
                heapq.heapreplace(heap, entry)

    # -- lock-free reads ------------------------------------------------------
    def spans(self, trace_id: "str | None" = None,
              limit: "int | None" = None) -> "list[Span]":
        """Most-recent-first snapshot; ``trace_id`` filters to one trace.

        The by-id lookup ALSO searches the slowest-per-route reservoir: the
        retention contract is that a p99 outlier survives ring wrap, and an
        id copied out of ``slowest_by_route`` (or a bench record) must stay
        resolvable after the ring has long since recycled its slot."""
        # analyze: ignore[lock-discipline] -- lock-free read BY DESIGN: slot stores are single atomic-under-GIL assignments, a torn snapshot only mis-orders the newest entry, and /trace must never contend with the hot path
        slots = list(self._slots)
        # analyze: ignore[lock-discipline] -- same deliberate lock-free read: a stale _next mis-rotates the recency ordering by at most the writes in flight
        next_ = self._next
        ordered = [s for s in slots[next_:] + slots[:next_] if s is not None]
        ordered.reverse()
        if trace_id:
            hits = [s for s in ordered if s.context.trace_id == trace_id]
            seen = {s.context.span_id for s in hits}
            with self._lock:  # heaps mutate in place; not on the hot path
                kept = [e[2] for heap in self._slowest.values() for e in heap]
            for s in kept:
                if (s.context.trace_id == trace_id
                        and s.context.span_id not in seen):
                    hits.append(s)
                    seen.add(s.context.span_id)
            return hits[:limit] if limit else hits
        return ordered[:limit] if limit else ordered

    def slowest(self, n: "int | None" = None) -> "dict[str, list[Span]]":
        """route -> kept-slowest spans, slowest first."""
        with self._lock:  # heaps mutate in place; snapshot under the lock
            items = {r: list(h) for r, h in self._slowest.items()}
        return {
            route: [e[2] for e in sorted(heap, key=lambda e: -e[0])][:n]
            for route, heap in items.items()
        }

    def stats(self) -> dict:
        return {
            # analyze: ignore[lock-discipline] -- advisory counter; an off-by-in-flight read is fine and /trace must not contend with writers
            "recorded": self._recorded,
            "ring_size": self.ring_size,
            "slowest_per_route": self.slowest_per_route,
        }

    def reset(self) -> None:
        with self._lock:
            self._slots = [None] * self.ring_size
            self._next = 0
            self._recorded = 0
            self._slowest.clear()


class _TracingState:
    """Process-wide switchboard (mirrors metrics.default_registry())."""

    def __init__(self):
        self.enabled = True
        self.recorder = SpanRecorder()


_STATE = _TracingState()


def default_recorder() -> SpanRecorder:
    return _STATE.recorder


def enabled() -> bool:
    return _STATE.enabled


def configure(config) -> None:
    """Apply ``oryx.tracing.spans.*``; called by the serving app factory and
    the layer runtimes next to metrics.configure()."""
    _STATE.enabled = config.get_bool("oryx.tracing.spans.enabled", True)
    ring = config.get_int("oryx.tracing.spans.ring-size", 2048)
    keep = config.get_int("oryx.tracing.spans.slowest-per-route", 5)
    rec = _STATE.recorder
    if ring != rec.ring_size or keep != rec.slowest_per_route:
        _STATE.recorder = SpanRecorder(ring, keep)


def set_enabled(value: bool) -> None:
    """Test/bench hook — production goes through :func:`configure`."""
    _STATE.enabled = bool(value)


# ---------------------------------------------------------------------------
# Current-span plumbing
# ---------------------------------------------------------------------------


def current_span() -> "Span | None":
    return _CURRENT.get()


def current_context() -> "SpanContext | None":
    span = _CURRENT.get()
    return span.context if span is not None else None


def current_traceparent() -> "str | None":
    ctx = current_context()
    return ctx.to_traceparent() if ctx is not None else None


def current_trace_id() -> "str | None":
    """Trace id of the current span (exemplar plumbing for histograms)."""
    ctx = current_context()
    return ctx.trace_id if ctx is not None else None


def inject_headers(headers: "dict | None" = None) -> "dict | None":
    """Add the current traceparent to ``headers`` (creating the dict when a
    span is current); returns ``headers`` unchanged otherwise."""
    tp = current_traceparent() if _STATE.enabled else None
    if tp is None:
        return headers
    out = dict(headers) if headers else {}
    out[TRACEPARENT] = tp
    return out


def _resolve_parent(parent) -> "SpanContext | None":
    if parent is None:
        return None
    if isinstance(parent, SpanContext):
        return parent
    if isinstance(parent, Span):
        return parent.context
    if isinstance(parent, str):
        return parse_traceparent(parent)
    return None


_USE_CURRENT = object()


def start_span(name: str, parent=_USE_CURRENT, links=(),
               attributes: "dict | None" = None) -> "Span | _NoopSpan":
    """Open a span (NOT set as current — use :func:`span` for that).

    ``parent`` defaults to the current span; pass an explicit
    :class:`SpanContext` / traceparent string for cross-thread or
    cross-process continuation, or None to force a new root."""
    if not _STATE.enabled:
        return NOOP_SPAN
    if parent is _USE_CURRENT:
        parent_ctx = current_context()
    else:
        parent_ctx = _resolve_parent(parent)
    if parent_ctx is not None:
        ctx = SpanContext(parent_ctx.trace_id, new_span_id(),
                          parent_ctx.sampled)
        parent_id = parent_ctx.span_id
    else:
        ctx = SpanContext(new_trace_id(), new_span_id())
        parent_id = None
    return Span(name, ctx, parent_id,
                links=tuple(links), attributes=attributes)


def finish_span(span) -> None:
    """End + record (noop-safe)."""
    span.end()
    if isinstance(span, Span):
        _STATE.recorder.record(span)


@contextmanager
def span(name: str, parent=_USE_CURRENT, links=(),
         attributes: "dict | None" = None):
    """Context manager: open a span, make it current, record on exit.
    Exceptions mark the span status and propagate."""
    sp = start_span(name, parent=parent, links=links, attributes=attributes)
    if sp is NOOP_SPAN:
        yield sp
        return
    token = _CURRENT.set(sp)
    try:
        yield sp
    except BaseException as e:
        sp.record_exception(e)
        raise
    finally:
        _CURRENT.reset(token)
        finish_span(sp)


@contextmanager
def activate(sp: "Span | None"):
    """Make an ALREADY-open span current for a scope without ending it
    (the coalescer's executor thread activates the device-call span so
    producer sends inside the model code inherit the trace)."""
    token = _CURRENT.set(sp)
    try:
        yield sp
    finally:
        _CURRENT.reset(token)


def trace_consumed(updates, name: str, route: "str | None" = None,
                   attributes: "dict | None" = None):
    """Wrap a KeyMessage iterator so each message bearing a ``traceparent``
    header is processed under a span continuing that trace.

    The span opens when the message is yielded and closes the moment the
    consumer asks for the NEXT message — BEFORE the blocking broker pop —
    so it times the consumer's processing of the message, never the
    iterator's idle wait (an update topic can sit quiet for hours; folding
    that into the span would flood the slowest-per-route reservoir with
    fake outliers). The span is made current for the consuming thread, so
    anything the consumer publishes (e.g. the speed tier's "UP" updates)
    inherits the trace."""

    def gen():
        it = iter(updates)
        open_span = None
        token = None

        def close():
            nonlocal open_span, token
            if open_span is not None:
                try:
                    _CURRENT.reset(token)
                except ValueError:
                    # generator finalized from a different context (GC or a
                    # cross-thread close on layer shutdown) — the span still
                    # gets recorded, only the contextvar restore is moot
                    pass
                finish_span(open_span)
                open_span = token = None

        try:
            while True:
                # the consumer is back for more: ITS work on the previous
                # message is done — end that span before blocking on the pop
                close()
                try:
                    km = next(it)
                except StopIteration:
                    return
                headers = getattr(km, "headers", None)
                if _STATE.enabled and headers and TRACEPARENT in headers:
                    attrs = {"route": route or name, "key": km.key}
                    if attributes:
                        attrs.update(attributes)
                    open_span = start_span(
                        name, parent=headers[TRACEPARENT], attributes=attrs
                    )
                    token = _CURRENT.set(open_span)
                yield km
        finally:
            close()

    return gen()


# ---------------------------------------------------------------------------
# Structured logging adapter: log lines correlate with traces
# ---------------------------------------------------------------------------


class TraceLogAdapter(logging.LoggerAdapter):
    """LoggerAdapter appending ``[trace=... span=...]`` to every message
    emitted under an active span, so a log line found by grep leads straight
    to ``GET /trace?trace_id=...``. Library hot paths use
    :func:`get_logger` instead of bare ``logging.getLogger(__name__)``
    (enforced by the ``log-discipline`` oryx-analyze checker)."""

    def process(self, msg, kwargs):
        sp = _CURRENT.get()
        if sp is not None and sp.context is not None:
            msg = f"{msg} [trace={sp.trace_id} span={sp.span_id}]"
        return msg, kwargs


def get_logger(name: str) -> TraceLogAdapter:
    """The structured logger for library hot paths: a drop-in for
    ``logging.getLogger(name)`` whose lines carry trace/span ids."""
    return TraceLogAdapter(logging.getLogger(name), {})
