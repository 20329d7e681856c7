"""Serving runtime: HTTP app factory + layer lifecycle.

The port of the JAX package's ``oryx_tpu/serving/app.py`` (host code, no
JAX) on the same aiohttp, held to it over HTTP by
``tests/test_torch_serving.py``. Two changes:

  * :func:`make_app` configures only the hooks the port has (metrics,
    spans, resilience, faults, blackbox, the SLO engine, the tsdb sampler,
    lineage, the ``tcp:`` client defaults, the file broker's fsync policy,
    profiling, the factor arena's sizing, the sanitizer's thresholds). The
    reference's compile cache has no torch counterpart.
  * ``ServingLayer(config, device=None)`` serves a model on ``device``:
    None means the CUDA card. ``start()`` resolves it before it creates a
    topic, a thread, a producer or a socket, so on a host without a card it
    raises with nothing started; a manager class whose constructor takes a
    ``device`` keyword is built on that device. A configured
    ``oryx.als.rescorer-provider-class`` is loaded at construction, so a
    class that cannot be loaded, or is not the port's ``RescorerProvider``,
    raises before anything starts; the ALS manager loads it again for the
    resources.

Equivalent of the reference's ServingLayer + ModelManagerListener +
OryxApplication (framework/oryx-lambda-serving/.../ServingLayer.java:121-337,
ModelManagerListener.java:81-225, OryxApplication.java:54-96): where the
reference embeds Tomcat and reflection-scans JAX-RS resources, this builds an
aiohttp application, imports the configured ``application-resources`` modules
and calls their ``register(app)`` hooks, wires the model-manager lifecycle
(update-topic consumer thread from ``earliest``, input producer unless
read-only), and serves with optional basic auth, TLS, and a context path.
"""

from __future__ import annotations

import asyncio
import base64
import concurrent.futures
import contextlib
import hashlib
import hmac
import importlib
import os
import re
import secrets
import ssl
import sys
import threading
import time
import traceback

import torch
from aiohttp import web

from oryx_tpu_torch.api.serving import ServingModelManager
from oryx_tpu_torch.common import blackbox
from oryx_tpu_torch.common import classutils
from oryx_tpu_torch.common import compilecache
from oryx_tpu_torch.common import faults
from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.common import lineage
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import profiling
from oryx_tpu_torch.common import resilience
from oryx_tpu_torch.common import slo
from oryx_tpu_torch.common import spans
from oryx_tpu_torch.common import tsdb
from oryx_tpu_torch.models.als.rescorer import load_rescorer_providers
from oryx_tpu_torch.serving import resource as rsrc
from oryx_tpu_torch.transport import netbroker
from oryx_tpu_torch.transport import topic as tp
from oryx_tpu_torch.transport.topic import (
    ConsumeDataIterator,
    TopicProducerImpl,
    get_broker,
    offset_op as tp_offset_op,
)

log = spans.get_logger(__name__)

DEFAULT_RESOURCES = ["oryx_tpu_torch.serving.resources.common"]

_REQUESTS = metrics_mod.default_registry().counter(
    "oryx_serving_requests_total",
    "HTTP requests by route template, method, and response status",
    ("route", "method", "status"),
)
_REQUEST_LATENCY = metrics_mod.default_registry().histogram(
    "oryx_serving_request_latency_seconds",
    "End-to-end HTTP request latency by route template",
    ("route",),
)
_IN_FLIGHT = metrics_mod.default_registry().gauge(
    "oryx_serving_requests_in_flight",
    "HTTP requests currently being handled",
)
_UPDATES_CONSUMED = metrics_mod.default_registry().counter(
    "oryx_serving_updates_consumed_total",
    "Update-topic messages consumed by the serving layer",
)
_UPDATE_LAG_MESSAGES = metrics_mod.default_registry().gauge(
    "oryx_serving_update_lag_messages",
    "Update-topic messages behind the broker head (consumer lag)",
)
_UPDATE_LAG_SECONDS = metrics_mod.default_registry().gauge(
    "oryx_serving_update_lag_seconds",
    "Seconds since the update consumer last made progress; while idle on "
    "an empty topic it reports the lineage watermark's data age instead "
    "(0 when no watermark is known)",
)
_CONSUMER_RESTARTS = metrics_mod.default_registry().counter(
    "oryx_serving_consumer_restarts_total",
    "Supervised restarts of the update-consumer thread after a crash",
)

#: Healthy consumption this long refunds the consumer restart budget and
#: resets its backoff: supervisor semantics are restarts-per-unhealthy-WINDOW,
#: not per process lifetime — isolated weekly crashes must never accumulate
#: into a max-restarts give-up months later.
_CONSUMER_HEALTHY_RESET_SEC = 60.0


def _route_template(request: web.Request) -> str:
    """Matched route template (bounded label cardinality — never the raw
    path, which would mint one label set per user/item id)."""
    resource = getattr(request.match_info.route, "resource", None)
    return getattr(resource, "canonical", None) or "unmatched"


def _attach_generation(response, route: str) -> None:
    """Stamp ``x-oryx-model-generation`` on every model-backed response
    (all four app families flow through this middleware), so any served
    answer is attributable to a model generation after the fact. Probe and
    ops routes are exempt — a /readyz poll is not a model query, and must
    not count as one in the adoption timeline."""
    if slo.is_ops_route(route):
        return
    gen = lineage.tracker().note_query()
    if gen and "x-oryx-model-generation" not in response.headers:
        response.headers["x-oryx-model-generation"] = gen


@web.middleware
async def _metrics_middleware(request, handler):
    """Outermost middleware: per-route request count/latency/status plus an
    in-flight gauge, and the request's INGRESS SPAN. Counts what the client
    saw — auth 401s, mapped errors, and 404s included.

    Tracing: an incoming W3C ``traceparent`` header continues the caller's
    trace, otherwise a fresh trace is minted; the span is current for the
    whole handler (asyncio carries the contextvar; executor hops go through
    asyncio.to_thread, which copies it). The response echoes the trace via
    ``traceparent``/``x-oryx-trace-id`` so a slow client call can be pulled
    up by id from ``GET /trace``, and the request-latency histogram records
    the trace id as its bucket exemplar — a bad bucket points at a trace.

    Chaos: an armed ``serving.request`` fault schedule fires HERE (inside
    the accounting, so injected 500s land in the SLO's availability counts
    — the game-day site that drives a burn-rate alert on one replica).
    Probe/ops routes are exempt: sabotaging /readyz or /metrics would blind
    the very observability a drill exercises. The disarmed cost is one
    global read per request; latency mode runs in a worker thread so an
    injected sleep never stalls the event loop."""
    record = metrics_mod.default_registry().enabled
    tracing = spans.enabled()
    route = _route_template(request)

    async def _handle():
        # site_armed, not armed(): a drill aimed at broker.append must not
        # tax every HTTP request with the injection's executor hop
        if faults.site_armed("serving.request") and not slo.is_ops_route(route):
            await asyncio.to_thread(faults.maybe_fail, "serving.request")
        return await handler(request)

    if not record and not tracing:
        response = await _handle()
        _attach_generation(response, route)
        return response
    if record:
        _IN_FLIGHT.inc()
    t0 = time.perf_counter()
    status = 500
    trace_id = None
    try:
        with spans.span(
            f"http {request.method} {route}",
            parent=spans.parse_traceparent(
                request.headers.get(spans.TRACEPARENT)
            ),
            attributes={"route": route, "method": request.method},
        ) as sp:
            trace_id = sp.trace_id or None
            response = await _handle()
            status = response.status
            sp.set_attribute("status", status)
            if trace_id:
                response.headers[spans.TRACEPARENT] = sp.context.to_traceparent()
                response.headers["x-oryx-trace-id"] = trace_id
            _attach_generation(response, route)
            return response
    except web.HTTPException as e:
        status = e.status
        if trace_id:
            # errors are exactly the responses an operator wants to pull up
            # by id — the 404/401/4xx must carry the trace like any 200
            e.headers[spans.TRACEPARENT] = sp.context.to_traceparent()
            e.headers["x-oryx-trace-id"] = trace_id
        _attach_generation(e, route)
        raise
    except asyncio.CancelledError:
        # client disconnect/timeout cancels the handler task: no response
        # was ever produced, so counting it as 500 would fake a 5xx spike
        status = "cancelled"
        raise
    finally:
        if record:
            _IN_FLIGHT.dec()
            _REQUEST_LATENCY.labels(route).observe(
                time.perf_counter() - t0, exemplar=trace_id
            )
            _REQUESTS.labels(route, request.method, str(status)).inc()


def _lag_seconds_fn(metered_ref):
    """Scrape-time gauge callback over a WEAK iterator ref: a strong ref
    (or a bound method) would pin a closed layer's iterator/broker for the
    process lifetime and keep reporting lag for a consumer that no longer
    exists — same pattern as the ALS load-fraction gauge."""

    def fn() -> float:
        metered = metered_ref()
        if metered is None:
            return 0.0
        if metered._waiting:
            # blocked in the broker pop = healthy and idle, not WEDGED — but
            # "0 forever" also hid a stalled batch tier. With a provenance
            # watermark known, idle reports the age of the data actually
            # serving (the speed tier's stamped deltas keep it advancing
            # between batch generations); without one (no stamped model
            # yet), quiet stays 0 as before. /readyz is unaffected either
            # way: stale additionally requires messages waiting behind the
            # head, and an idle consumer has none.
            freshness = lineage.freshness_seconds()
            return freshness if freshness is not None else 0.0
        return max(0.0, time.time() - metered._last_walltime)

    return fn


def _lag_messages_fn(metered_ref):
    """Scrape-time messages-behind-head callback (weak ref, as above). The
    broker probe runs at READ time, never on the consumer hot path — and a
    WEDGED consumer still reports a live backlog, which an at-consume-time
    ``set()`` could never do (its last value froze with the consumer)."""

    def fn() -> float:
        metered = metered_ref()
        if metered is None:
            return 0.0
        try:
            # lag from the iterator's own read positions, not a consumed
            # count: a "committed" consumer starts mid-topic, so
            # total - consumed would report the whole history as backlog
            # forever on a healthy caught-up replica
            lag = metered._iterator.messages_behind(
                metered._broker.total_size(metered._topic)
            )
        except Exception:  # noqa: BLE001  # analyze: ignore[swallowed-exception] -- scrape-time lag probe is advisory; a log line per scrape would flood
            return 0.0
        return float(max(0, lag))

    return fn


class _MeteredUpdates:
    """Iterator bridge feeding consumer-lag metrics from the update-consumer
    thread: messages consumed, plus two scrape-time gauge callbacks —
    messages behind the broker head and seconds since the consumer last
    made progress (consumer start until the first message). Both evaluate
    at READ time, so they stay truthful for a wedged consumer and /readyz
    works even with the metrics kill switch off.

    ``broker`` must be the SAME instance the iterator consumes from (for
    ``file:`` brokers a fresh instance would rebuild a duplicate line index
    just to answer total_size).

    ``commit`` (optional, the ``update-resume = "committed"`` path) runs at
    the TOP of each ``__next__`` — the moment the manager asks for more is
    the proof it finished the previous message, which is exactly when
    UpdateOffsetsFn semantics say the position may be persisted. A commit
    that ran any earlier could lose a generation to a crash mid-apply."""

    def __init__(self, updates, broker, topic: str, commit=None):
        import weakref

        # the raw ConsumeDataIterator: the lag gauge reads its per-partition
        # positions (messages_behind), which stay truthful in BOTH resume
        # modes — a consumed count would misread "committed" starts
        self._iterator = updates
        # trace continuation: a consumed message bearing a traceparent header
        # is processed under a span continuing the trace minted at ingress
        # (the span closes when the manager asks for the next message)
        self._updates = iter(spans.trace_consumed(
            updates, "serving.consume_update", route="update-topic",
            attributes={"topic": topic},
        ))
        self._broker = broker
        self._topic = topic
        self._commit = commit
        self._consumed = 0
        # baseline at consumer start: "seconds since progress" must grow for
        # a consumer that wedges before its FIRST message, not read 0 forever
        self._last_walltime: float = time.time()
        # True while blocked in the broker pop: healthy-idle, not lagging
        # (plain bool, single-store/single-load atomic under the GIL)
        self._waiting: bool = False
        ref = weakref.ref(self)
        _UPDATE_LAG_SECONDS.set_function(_lag_seconds_fn(ref))
        _UPDATE_LAG_MESSAGES.set_function(_lag_messages_fn(ref))

    def __iter__(self) -> "_MeteredUpdates":
        return self

    def __next__(self):
        # offset-keyed resume: persist the position past everything already
        # processed (BEFORE the chaos hook — an injected consumer crash
        # must never un-commit finished work)
        if self._commit is not None:
            self._commit()
        # chaos hook: an armed "serving.update_consume" schedule crashes the
        # consumer HERE, through the exact path a poison update or broker
        # fault would take (the supervised restart loop absorbs it)
        faults.maybe_fail("serving.update_consume")
        # entering = the manager finished the previous message: progress.
        # The timestamps are NOT behind the metrics kill switch — /readyz
        # derives staleness from them, and readiness must not depend on
        # metrics. What still reads as stale is a consumer stuck INSIDE
        # one message with more queued — size ready-max-lag-sec above the
        # worst-case model-apply time.
        self._last_walltime = time.time()
        self._waiting = True
        try:
            km = next(self._updates)  # blocks on the consumer thread, never the loop
        finally:
            self._waiting = False
        self._consumed += 1
        self._last_walltime = time.time()
        if metrics_mod.default_registry().enabled:
            _UPDATES_CONSUMED.inc()
        return km


def _deadline_middleware(config):
    """Per-request deadline (``oryx.serving.api.request-timeout-sec``): the
    budget is set as the request's :class:`resilience.Deadline` contextvar
    (downstream code — the coalescer dispatch — refuses to START work past
    it) and enforced at this level with ``asyncio.wait_for``. A blown
    budget answers 504 carrying the PARTIAL trace id: every span the
    request recorded before cancellation is already in the ring, so the
    operator can see exactly where the time went. None when disabled."""
    budget = config.get_float("oryx.serving.api.request-timeout-sec", 0.0)
    if budget <= 0:
        return None

    @web.middleware
    async def deadline_mw(request, handler):
        with resilience.deadline(budget):
            try:
                return await asyncio.wait_for(handler(request), timeout=budget)
            except asyncio.TimeoutError:
                return web.json_response({
                    "error": f"request exceeded its {budget:.3f}s budget",
                    "status": 504,
                    "trace_id": spans.current_trace_id(),
                }, status=504)

    return deadline_mw


@web.middleware
async def _compression_middleware(request, handler):
    """Negotiated gzip/deflate response bodies (the reference registers
    Jersey EncodingFilter+Gzip/DeflateEncoder, OryxApplication.java:88-93)."""
    response = await handler(request)
    try:
        if response.body is not None and len(response.body) >= 512:
            response.enable_compression()
    except AttributeError:  # streaming/file responses
        pass
    return response


def make_app(config, manager, input_producer=None) -> web.Application:
    """Build the aiohttp application with resources from config
    (OryxApplication.java:54-96)."""
    metrics_mod.configure(config)
    spans.configure(config)
    # not ported: the XLA compile cache (no counterpart in torch; the
    # readiness state lives on in common/compilecache)
    resilience.configure(config)
    faults.configure(config)
    # flight recorder (event ring, dump-dir, SIGTERM dump) and the SLO
    # burn-rate engine (scrape-evaluated objectives; /readyz embeds the
    # active-alert list) — both per-process, like the metrics registry
    blackbox.configure(config)
    slo.configure(config)
    # time-series sampler (oryx.tsdb.*): history rings behind
    # GET /metrics/history, the pre-incident window in blackbox bundles,
    # and the trend-alert early warning (docs/observability.md)
    tsdb.configure(config)
    # model-lineage tracker (adoption timeline + freshness watermark behind
    # GET /lineage, the freshness gauges and the x-oryx-model-generation
    # response header)
    lineage.configure(config)
    # tcp client knobs (oryx.broker.tcp.*) for any get_broker below
    netbroker.configure(config)
    tp.configure(config)  # file-broker fsync durability policy
    # factor-arena sizing (oryx.serving.arena.*): new vector stores built by
    # model handoffs in this process pick the slab seed/compaction knobs up
    from oryx_tpu_torch.models.als import vectors as als_vectors

    als_vectors.configure(config)
    # roofline peaks + device-memory gauges + the profiler session config
    # (after the others; the device half wires once CUDA is initialised)
    profiling.configure(config)
    # concurrency-sanitizer thresholds (oryx.sanitize.*): install happened
    # at import when ORYX_SANITIZE was set; this only tunes thresholds
    from oryx_tpu_torch.tools import sanitize

    sanitize.configure(config)
    middlewares = [_metrics_middleware, rsrc.error_middleware, _compression_middleware]
    dl_mw = _deadline_middleware(config)
    if dl_mw is not None:
        # inside metrics (the 504 must be counted + span-stamped), outside
        # the error mapper (the budget covers handler + error rendering)
        middlewares.insert(1, dl_mw)
    auth_mw = _auth_middleware(config)
    if auth_mw is not None:
        middlewares.append(auth_mw)
    app = web.Application(middlewares=middlewares)
    app[rsrc.CONFIG_KEY] = config
    app[rsrc.MANAGER_KEY] = manager
    app[rsrc.INPUT_PRODUCER_KEY] = input_producer

    window_ms = config.get_float("oryx.serving.compute.coalesce-window-ms", 1.0)
    if window_ms > 0:
        from oryx_tpu_torch.serving.batcher import TopNCoalescer

        app[rsrc.COALESCER_KEY] = TopNCoalescer(
            window_ms,
            config.get_int("oryx.serving.compute.coalesce-max-batch", 256),
            config.get_int("oryx.serving.compute.coalesce-inflight", 2),
            config.get_float("oryx.serving.compute.coalesce-deadline-ms", 250.0),
            max_queue_depth=config.get_int(
                "oryx.serving.compute.max-queue-depth", 0
            ),
            # device-call breaker: batched-call failures open it and route
            # requests to uncoalesced per-request scans until a probe heals
            breaker=resilience.CircuitBreaker.from_config(
                "serving.device_call", config
            ),
        )

    modules = list(DEFAULT_RESOURCES)
    configured = config.get("oryx.serving.application-resources", None)
    if configured:
        if isinstance(configured, str):
            configured = [m.strip() for m in configured.split(",") if m.strip()]
        modules.extend(configured)
    for module_name in modules:
        module = importlib.import_module(module_name)
        if not hasattr(module, "register"):
            raise ValueError(f"resource module {module_name} has no register(app)")
        module.register(app)
        log.info("registered resources from %s", module_name)

    context_path = config.get_string("oryx.serving.api.context-path", "/") or "/"
    if context_path not in ("", "/"):
        # the outer shell carries NO middlewares: aiohttp runs the outer
        # app's chain and then the subapp's, so listing them on both made
        # auth and compression run twice per request (and would have
        # double-counted every metric)
        outer = web.Application()
        outer.add_subapp(context_path, app)
        return outer
    return app


_AUTH_REALM = "Oryx"


def _exempt_canonicals(config) -> frozenset:
    """Route templates exempt from API auth — each listed bare plus
    context-path-prefixed (subapp resources report their canonical WITH the
    prefix). Matching on the matched template, not the raw path, means a
    crafted path can never spoof the exemption.

    ``/healthz``/``/readyz`` are ALWAYS exempt (load balancers cannot speak
    digest, and the probes leak nothing beyond up/down); ``/metrics``,
    ``/metrics/history``, ``/trace``, ``/lineage``, ``/debug/profile`` and
    ``/debug/bundle`` share one auth story — exempt unless
    ``oryx.metrics.require-auth``."""
    templates = {"/healthz", "/readyz"}
    if not config.get_bool("oryx.metrics.require-auth", False):
        templates |= {"/metrics", "/metrics/history", "/trace", "/lineage",
                      "/debug/profile", "/debug/bundle"}
    context_path = config.get_string("oryx.serving.api.context-path", "/") or "/"
    prefix = context_path.rstrip("/")
    return frozenset(templates | {prefix + t for t in templates})


def _is_exempt_route(request: web.Request, canonicals: frozenset) -> bool:
    resource = getattr(request.match_info.route, "resource", None)
    return getattr(resource, "canonical", None) in canonicals


def _auth_middleware(config):
    """Optional HTTP auth behind oryx.serving.api.{user-name,password}:
    DIGEST by default for wire parity with the reference's single-user
    InMemoryRealm (ServingLayer.java:293-321); ``auth-scheme = basic`` opts
    into basic-over-TLS. GET /metrics and /trace are exempt unless
    ``oryx.metrics.require-auth`` (Prometheus scrapers rarely speak digest);
    the /healthz & /readyz probes are always exempt."""
    user = config.get_string("oryx.serving.api.user-name", None)
    if not user:
        return None
    exempt = _exempt_canonicals(config)
    password = config.get_string("oryx.serving.api.password", None) or ""
    scheme = config.get_string("oryx.serving.api.auth-scheme", "digest").lower()
    if scheme == "basic":
        return _basic_auth_middleware(user, password, exempt)
    if scheme != "digest":
        raise ValueError(f"unknown oryx.serving.api.auth-scheme: {scheme}")
    return _digest_auth_middleware(user, password, exempt)


def _basic_auth_middleware(user: str, password: str,
                           exempt: frozenset = frozenset()):
    expected = base64.b64encode(f"{user}:{password}".encode()).decode()

    @web.middleware
    async def auth(request, handler):
        if exempt and _is_exempt_route(request, exempt):
            return await handler(request)
        header = request.headers.get("Authorization", "")
        if not hmac.compare_digest(header, f"Basic {expected}"):
            return web.Response(
                status=401,
                headers={"WWW-Authenticate": f'Basic realm="{_AUTH_REALM}"'},
            )
        return await handler(request)

    return auth


_DIGEST_FIELD_RE = re.compile(r'(\w+)=(?:"([^"]*)"|([^\s,]+))')
_NONCE_TTL_SEC = 300


def _digest_auth_middleware(user: str, password: str,
                            exempt: frozenset = frozenset()):
    """RFC 7616/2617 digest challenge-response (MD5 and SHA-256, qop=auth).

    Nonces are self-validating HMAC(timestamp) tokens — no server-side nonce
    table — and expire after 5 minutes with ``stale=true`` so clients reauth
    without re-prompting."""
    server_key = secrets.token_bytes(16)

    def make_nonce() -> str:
        ts = str(int(time.time()))
        sig = hmac.new(server_key, ts.encode(), hashlib.sha256).hexdigest()[:16]
        return f"{ts}.{sig}"

    def nonce_fresh(nonce: str) -> bool:
        ts, _, sig = nonce.partition(".")
        if not ts.isdigit():
            return False
        want = hmac.new(server_key, ts.encode(), hashlib.sha256).hexdigest()[:16]
        return hmac.compare_digest(sig, want) and time.time() - int(ts) < _NONCE_TTL_SEC

    def challenge(stale: bool = False) -> web.Response:
        headers = []
        for alg in ("SHA-256", "MD5"):  # RFC 7616: strongest first
            h = (
                f'Digest realm="{_AUTH_REALM}", qop="auth", algorithm={alg}, '
                f'nonce="{make_nonce()}", charset=UTF-8'
            )
            if stale:
                h += ", stale=true"
            headers.append(("WWW-Authenticate", h))
        resp = web.Response(status=401)
        for k, v in headers:
            resp.headers.add(k, v)
        return resp

    @web.middleware
    async def auth(request, handler):
        if exempt and _is_exempt_route(request, exempt):
            return await handler(request)
        header = request.headers.get("Authorization", "")
        if not header.startswith("Digest "):
            return challenge()
        fields = {
            m.group(1).lower(): m.group(2) if m.group(2) is not None else m.group(3)
            for m in _DIGEST_FIELD_RE.finditer(header[len("Digest "):])
        }
        try:
            username = fields["username"]
            realm = fields["realm"]
            nonce = fields["nonce"]
            uri = fields["uri"]
            response = fields["response"]
        except KeyError:
            return challenge()
        if username != user or realm != _AUTH_REALM:
            return challenge()
        if not nonce_fresh(nonce):
            return challenge(stale=True)
        algorithm = fields.get("algorithm", "MD5").upper()
        if algorithm in ("MD5", "MD5-SESS"):
            digest = lambda s: hashlib.md5(s.encode()).hexdigest()  # noqa: E731,S324
        elif algorithm in ("SHA-256", "SHA-256-SESS"):
            digest = lambda s: hashlib.sha256(s.encode()).hexdigest()  # noqa: E731
        else:
            return challenge()
        ha1 = digest(f"{user}:{realm}:{password}")
        if algorithm.endswith("-SESS"):
            ha1 = digest(f"{ha1}:{nonce}:{fields.get('cnonce', '')}")
        ha2 = digest(f"{request.method}:{uri}")
        qop = fields.get("qop")
        if qop == "auth":
            expected = digest(
                f"{ha1}:{nonce}:{fields.get('nc', '')}:"
                f"{fields.get('cnonce', '')}:auth:{ha2}"
            )
        elif qop is None:
            expected = digest(f"{ha1}:{nonce}:{ha2}")
        else:
            return challenge()  # qop=auth-int unsupported
        if not hmac.compare_digest(response.lower(), expected):
            return challenge()
        return await handler(request)

    return auth


def _ssl_context(config) -> "ssl.SSLContext | None":
    """TLS from config: keystore-file = PEM cert chain, key-alias = key file
    (ServingLayer.makeConnector TLS knobs, :202-255)."""
    cert = config.get_string("oryx.serving.api.keystore-file", None)
    if not cert:
        return None
    key = config.get_string("oryx.serving.api.key-alias", None)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key or None, config.get_string("oryx.serving.api.keystore-password", None))
    return ctx


class _BatchWarmer(threading.Thread):
    """Runs the batched top-N at every coalescer batch size when a model
    becomes ready.

    The coalescer pads batches to powers of two (the reference's stable jit
    signatures; there, each signature's FIRST occurrence pays an XLA
    compile). On the card a first call at a new shape pays the caching
    allocator's first allocations and cuBLAS's kernel choice instead. When
    ``oryx.serving.compute.precompile-batches`` is on, this thread watches
    for a new ready model and walks the shared pow2 bucket ladder
    (``batcher.pow2_buckets``, SMALLEST first so the replica turns ready
    incrementally and the warm-fraction readiness gate can trip early)
    through each model's ``warm_bucket`` hook, one real execution per
    signature family. Progress feeds ``compilecache.warmup_state()``
    (readyz gating + the oryx_warmup_* metrics) and each ladder is traced
    as a ``serving.warmup`` span with per-bucket children.

    Generation handoffs double-buffer through the manager's STAGED model
    (``oryx.compile.prewarm-swap``, the default): the warmer warms a staged
    generation first, off the request path, then promotes it with
    ``promote_staged(expected=...)``. A warm ladder runs every signature
    once, so the incoming generation's device state (its float32 or
    bfloat16 matrix, int8 snapshot or IVF index) is built here, never by
    the first query after the flip. Models without a
    batched top-N (k-means) mark warmup trivially complete. Each bucket
    warms BOTH signature families — exclusion-free and exclusion-carrying
    (the default ``/recommend`` path always sends known-item exclusions,
    padded to a floored width)."""

    # the reference API's default howMany — warms the top-k width the
    # common request hits
    WARM_HOW_MANY = 10

    def __init__(self, manager, min_fraction: float, max_batch: int,
                 stop_event: threading.Event):
        super().__init__(name="OryxServingBatchWarmer", daemon=True)
        self.manager = manager
        self.min_fraction = min_fraction
        # the shared bucket enumeration: warming a size real flushes never
        # produce would waste the biggest compile, and a flushed size that
        # was never warmed would compile on-path — one list rules both
        from oryx_tpu_torch.serving.batcher import pow2_buckets

        self.buckets = pow2_buckets(max_batch)  # ascending: smallest first
        # NOT named _stop: threading.Thread.join() calls an internal
        # self._stop() when the thread finishes, and an Event attribute of
        # that name shadows it (TypeError on the first join)
        self._stop_event = stop_event
        self.warmed_models: int = 0  # observability + tests
        self.promoted_models: int = 0

    def run(self) -> None:
        import time as _time
        import weakref

        # weakref: a strong reference here would pin a RETIRED model
        # generation (hundreds of MB of factors) for as long as its
        # successor keeps failing to warm
        last_warmed: "weakref.ref | None" = None
        not_before = 0.0  # fraction walks are costly: back off between tries
        failures = 0
        while not self._stop_event.wait(0.25):
            # a staged (incoming) generation warms FIRST: the serving model
            # is warm already, and the staged one blocks a pending swap
            staged = self.manager.get_staged_model()
            model = staged if staged is not None else self.manager.get_model()
            if model is None or (
                last_warmed is not None and last_warmed() is model
            ):
                continue
            if not hasattr(model, "top_n_batch") or not hasattr(model, "features"):
                # nothing batched to warm on this app family — readiness
                # must not wait on a ladder that will never run
                compilecache.warmup_state().mark_trivial()
                last_warmed = weakref.ref(model)
                continue
            now = _time.monotonic()
            if now < not_before:
                continue
            if model.get_fraction_loaded() < self.min_fraction:
                # the fraction test walks the expected-ID sets (see
                # _maybe_trigger_solvers' rate limit) — don't hammer it
                not_before = now + 2.0
                continue
            if self._warm_model(model):
                last_warmed = weakref.ref(model)
                self.warmed_models += 1
                failures = 0
                # adoption timeline: ladder complete for the newest consumed
                # generation (promote below flips it live)
                lineage.tracker().mark_warmed()
                # expected= guards the flip: a newer MODEL push may have
                # replaced the staged generation while this ladder ran, and
                # that replacement is unwarmed — leave it for the next pass
                if staged is not None and self.manager.promote_staged(
                    expected=model
                ):
                    self.promoted_models += 1
                    log.info("promoted prewarmed model generation")
            else:
                # retry the SAME model later: items may simply not have
                # arrived yet, and a silent skip would strand the feature
                failures += 1
                not_before = _time.monotonic() + min(10.0, 2.0 * failures)

    def _warm_model(self, model) -> bool:
        """One bucket ladder, smallest first; progress into the shared
        warmup state so /readyz (warm-fraction gate) tracks it live."""
        import time as _time

        import numpy as np

        state = compilecache.warmup_state()
        state.begin(len(self.buckets))
        t_model = _time.perf_counter()
        with spans.span(
            "serving.warmup", parent=None,
            attributes={"route": "serving.warmup",
                        "buckets": len(self.buckets)},
        ):
            for b in self.buckets:
                if self._stop_event.is_set():
                    return False
                t0 = _time.perf_counter()
                try:
                    with spans.span(
                        "serving.warmup.bucket",
                        attributes={"route": "serving.warmup",
                                    "batch.size": b},
                    ):
                        if hasattr(model, "warm_bucket"):
                            model.warm_bucket(b, self.WARM_HOW_MANY)
                        else:
                            model.top_n_batch(
                                np.zeros((b, model.features), dtype=np.float32),
                                self.WARM_HOW_MANY,
                            )
                except Exception:  # noqa: BLE001 — e.g. no items yet
                    log.debug("batch warm at size %d failed", b, exc_info=True)
                    return False
                compilecache.observe_warmup(
                    "bucket", _time.perf_counter() - t0
                )
                state.bucket_done()
        compilecache.observe_warmup("model", _time.perf_counter() - t_model)
        state.finish()
        return True


def _warn_if_alive(thread: threading.Thread, waited_s: float) -> None:
    """Log a thread that outlived its join in :meth:`ServingLayer.close`,
    with the stack it is blocked in: a daemon thread still running when the
    interpreter finalizes can take the process down with it, and the stack
    is the one clue to why it did not stop."""
    if not thread.is_alive():
        return
    frame = sys._current_frames().get(thread.ident)
    stack = "".join(traceback.format_stack(frame)) if frame is not None else "?"
    log.warning("%s did not stop within %gs; blocked in:\n%s", thread.name,
                waited_s, stack)


class ServingLayer:
    """Lifecycle: model manager + update consumer + HTTP server
    (ServingLayer.start/await/close:121-178, ModelManagerListener:102-145).
    The model lives on ``device`` (None: the CUDA card; ``"cpu"`` must be
    asked for)."""

    def __init__(self, config, device=None):
        self.config = config
        # a provider that cannot be built refuses the layer here, not at
        # the first request
        load_rescorer_providers(config)
        # tcp client knobs must be adopted BEFORE the first get_broker()
        # (start() resolves brokers well before make_app re-configures)
        netbroker.configure(config)
        tp.configure(config)
        self._device_arg = device
        self.device = None  # resolved by start()
        self.id = config.get_string("oryx.id", None)
        self.update_broker = config.get_string("oryx.update-topic.broker")
        self.update_topic = config.get_string("oryx.update-topic.message.topic")
        self.input_broker = config.get_string("oryx.input-topic.broker")
        self.input_topic = config.get_string("oryx.input-topic.message.topic")
        self.read_only = config.get_bool("oryx.serving.api.read-only", False)
        # "earliest" (reference parity: full replay) or "committed"
        # (offset-keyed resume: commit after processing, restart from the
        # stored position — the multi-host fleet's cheap-restart mode)
        self.update_resume = config.get_string(
            "oryx.serving.update-resume", "earliest"
        )
        if self.update_resume not in ("earliest", "committed"):
            raise ValueError(
                f"oryx.serving.update-resume must be 'earliest' or "
                f"'committed', not {self.update_resume!r}"
            )
        if self.update_resume == "committed" and not self.id:
            raise ValueError(
                "oryx.serving.update-resume='committed' requires oryx.id "
                "(it keys this replica's stored offsets)"
            )
        # TLS listens on secure-port, plaintext on port — the reference's
        # connector split (ServingLayer.makeConnector:202-255); before this
        # the secure-port key was declared but never read (oryx-analyze:
        # config-key-drift)
        self.port = config.get_int("oryx.serving.api.port")
        self.secure_port = config.get_int("oryx.serving.api.secure-port")
        self.manager: ServingModelManager | None = None
        self._update_iterator: ConsumeDataIterator | None = None
        self._metered_updates: "_MeteredUpdates | None" = None
        self.consumer_restarts = 0  # observability + tests
        self._consumer_thread: threading.Thread | None = None
        self._server_thread: threading.Thread | None = None
        self._warmer: _BatchWarmer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._started = threading.Event()
        self._stopped = threading.Event()
        self._failure: BaseException | None = None

    def start(self) -> None:
        # the device first: without the card this raises before any topic,
        # thread, producer or socket exists
        self.device = resolve(self._device_arg)
        # the build-info sample names the device the model serves from
        # (profiling sets it again once CUDA is initialised; a CPU layer
        # has only this one)
        metrics_mod.set_build_info(
            self.device.type, torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else "cpu")
        # retry shapes + fault schedules must be live before the update
        # consumer below takes its first message (make_app runs after it)
        resilience.configure(self.config)
        faults.configure(self.config)
        # topics must exist (ModelManagerListener.contextInitialized:107-127)
        if not self.config.get_bool("oryx.serving.no-init-topics", False):
            for burl, bt in ((self.input_broker, self.input_topic),
                             (self.update_broker, self.update_topic)):
                broker = get_broker(burl)
                if not broker.topic_exists(bt):
                    broker.create_topic(bt)
        producer = None
        if not self.read_only:
            producer = TopicProducerImpl(self.input_broker, self.input_topic)
        self.manager = self._load_manager()
        # the app (and with it every hook make_app configures) before the
        # consumer's first message: lineage.configure installs a fresh
        # tracker, and a MODEL consumed before it would be lost from the
        # adoption timeline and the x-oryx-model-generation header (the
        # reference builds the app after starting the consumer)
        app = make_app(self.config, self.manager, producer)
        update_broker = get_broker(self.update_broker)
        offset_group = f"serving-{self.id}" if self.id else None
        committed_mode = self.update_resume == "committed"
        last_committed: dict[int, int] = {}

        def _commit_processed():
            # persist only positions that moved since the last commit; the
            # PROCESSED offsets, never the read positions (the prefetch
            # buffer may hold messages the manager has not applied yet).
            # tp.offset_op is the shared commit-path retry contract (site
            # broker.offset, same as the lambda tiers' UpdateOffsetsFn path)
            for p, off in self._update_iterator.processed_offsets.items():
                if last_committed.get(p) != off:
                    tp_offset_op(
                        lambda p=p, off=off: update_broker.set_offset(
                            offset_group, self.update_topic, off, p
                        ),
                        stop=self._stopped,
                    )
                    last_committed[p] = off

        def _new_update_pipeline():
            iterator = ConsumeDataIterator(
                update_broker, self.update_topic,
                "committed" if committed_mode else "earliest",
                offset_group=offset_group,
            )
            metered = _MeteredUpdates(
                iterator, update_broker, self.update_topic,
                commit=_commit_processed if committed_mode else None,
            )
            return iterator, metered

        self._update_iterator, self._metered_updates = _new_update_pipeline()
        restart_cfg = self.config.get_config("oryx.resilience.consumer-restart")
        max_restarts = restart_cfg.get_int("max-restarts", -1)
        base_delay = restart_cfg.get_float("base-delay-ms", 100.0) / 1000.0
        max_delay = restart_cfg.get_float("max-delay-ms", 5000.0) / 1000.0

        def consume():
            # SUPERVISED: before this loop existed, one crash (or one poison
            # update) silently ended the consumer thread — the layer kept
            # serving an ever-staler model until /readyz noticed. Now each
            # crash restarts consumption from "earliest" (full state replay:
            # exactly how a fresh replica builds its model, so correct by
            # construction) after a bounded-exponential delay, while the
            # HTTP side keeps answering from the current in-memory model.
            restarts = 0
            need_rebuild = False
            while not self._stopped.is_set():
                attempt_started = time.monotonic()
                try:
                    if need_rebuild:
                        # the rebuild runs INSIDE the supervised try: the
                        # iterator constructor performs broker RPCs
                        # (num_partitions, stored offsets), and a broker
                        # still down at restart time used to raise out of
                        # the except handler below and kill this thread
                        # permanently — a replica that serves forever but
                        # never consumes again (the fleet SPOF drill's
                        # "never drained" stall)
                        ioutils.close_quietly(self._update_iterator)
                        # committed mode restarts from the stored positions
                        # (offset-keyed resume); earliest replays in full
                        self._update_iterator, self._metered_updates = (
                            _new_update_pipeline()
                        )
                        need_rebuild = False
                        if self._stopped.is_set():
                            # close() raced the rebuild: it closed the OLD
                            # iterator before the assignment above landed,
                            # so this fresh one is ours to close — without
                            # this re-check the consumer would block in
                            # consume() on an iterator nothing ever closes
                            ioutils.close_quietly(self._update_iterator)
                            return
                    self.manager.consume(self._metered_updates)
                    return  # iterator closed: clean shutdown
                except Exception as e:  # noqa: BLE001 — supervised
                    if self._stopped.is_set():
                        return
                    if (
                        time.monotonic() - attempt_started
                        >= _CONSUMER_HEALTHY_RESET_SEC
                    ):
                        restarts = 0  # budget is per unhealthy window
                    restarts += 1
                    self.consumer_restarts += 1  # lifetime-cumulative (tests)
                    _CONSUMER_RESTARTS.inc()
                    blackbox.record_event(
                        "consumer.restart", severity="error",
                        restart=restarts,
                        error=f"{type(e).__name__}: {e}",
                    )
                    if 0 <= max_restarts < restarts:
                        log.exception(
                            "update consumer failed %d times; giving up and "
                            "closing the layer", restarts,
                        )
                        self._failure = e
                        self.close()
                        return
                    delay = min(max_delay, base_delay * (2 ** (restarts - 1)))
                    log.exception(
                        "update consumer crashed (restart %d); restarting "
                        "from %s in %.2fs", restarts, self.update_resume,
                        delay,
                    )
                    if self._stopped.wait(delay):
                        return
                    need_rebuild = True
                    # the loop re-checks _stopped before rebuilding, and the
                    # rebuild re-checks it again after installing the fresh
                    # iterator (closing it when close() raced) — so a
                    # close() at any point cannot strand a consumer blocked
                    # on a just-created iterator; a rebuild that fails
                    # (broker still down) lands back here with the next
                    # backoff step instead of ending the thread

        self._consumer_thread = threading.Thread(
            target=consume, name="OryxServingLayerUpdateConsumerThread", daemon=True
        )
        self._consumer_thread.start()

        # this layer owns the process's serving warmup state: reset leftovers
        # from a previous layer in the same process, then arm when warmup is
        # configured so /readyz holds until the first ladder completes
        warm_state = compilecache.warmup_state()
        warm_state.reset()
        if self.config.get_bool(
            "oryx.serving.compute.precompile-batches", False
        ):
            warm_state.arm()
            self._warmer = _BatchWarmer(
                self.manager,
                self.config.get_float("oryx.serving.min-model-load-fraction"),
                self.config.get_int(
                    "oryx.serving.compute.coalesce-max-batch", 256
                ),
                self._stopped,
            )
            self._warmer.start()

        sslctx = _ssl_context(self.config)
        bind_port = self.secure_port if sslctx is not None else self.port

        def serve():
            loop = asyncio.new_event_loop()
            self._loop = loop
            asyncio.set_event_loop(loop)
            # pre-started default executor: the lazily-created one spawns
            # its worker threads on FIRST use, and Thread.start() blocks
            # until the OS schedules the new thread — under CPU contention
            # that is a several-hundred-ms EVENT-LOOP stall on the first
            # coalescer dispatch per worker (caught live by the sanitizer's
            # loop watchdog). Spawning here, off the request path, makes
            # every later run_in_executor hop a queue push.
            executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, (os.cpu_count() or 4)),
                thread_name_prefix="oryx-serving-exec",
            )
            barrier = threading.Barrier(executor._max_workers + 1)
            for _ in range(executor._max_workers):
                executor.submit(barrier.wait, 10)
            with contextlib.suppress(threading.BrokenBarrierError):
                barrier.wait(10)  # all workers alive before serving starts
            loop.set_default_executor(executor)
            runner = web.AppRunner(app)
            loop.run_until_complete(runner.setup())
            site = web.TCPSite(runner, "0.0.0.0", bind_port, ssl_context=sslctx)
            loop.run_until_complete(site.start())
            log.info("serving layer listening on :%d%s", bind_port,
                     " (TLS)" if sslctx is not None else "")
            self._started.set()
            try:
                loop.run_forever()
            finally:
                loop.run_until_complete(runner.cleanup())
                # wait: no thread of a closed layer outlives close()
                executor.shutdown(wait=True, cancel_futures=True)
                loop.close()

        self._server_thread = threading.Thread(target=serve, name="OryxServingLayer", daemon=True)
        self._server_thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError("serving layer failed to start")

    def _load_manager(self) -> ServingModelManager:
        """The configured manager; a constructor that takes a ``device``
        keyword gets the layer's."""
        name = self.config.get_string("oryx.serving.model-manager-class")
        if not name:
            raise ValueError("no class configured at oryx.serving.model-manager-class")
        return classutils.load_instance_on(name, ServingModelManager, self.config,
                                           self.device)

    def await_termination(self, timeout: float | None = None) -> None:
        self._stopped.wait(timeout)
        if self._failure is not None:
            raise self._failure

    def close(self) -> None:
        self._stopped.set()
        if self._update_iterator is not None:
            self._update_iterator.close()
        if (
            self._warmer is not None
            and self._warmer is not threading.current_thread()
        ):
            # join BEFORE closing the manager: a leaked warmer thread would
            # keep poking get_model()/top_n_batch on a closed manager (and
            # leak across tests); the timeout bounds a warm mid-compile
            self._warmer.join(timeout=10)
            if self._warmer.is_alive():
                log.warning("batch warmer did not stop within 10s")
        if self.manager is not None:
            self.manager.close()
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._server_thread is not None and self._server_thread is not threading.current_thread():
            self._server_thread.join(timeout=10)
            _warn_if_alive(self._server_thread, 10)
        if (
            self._consumer_thread is not None
            and self._consumer_thread is not threading.current_thread()
        ):
            self._consumer_thread.join(timeout=5)
            _warn_if_alive(self._consumer_thread, 5)
        # this layer armed the process-global warmup state at start; a
        # closed layer must not keep gating /readyz of whatever serves
        # next in this process (an armed-but-dead state read "cold"
        # forever and 503'd later bare make_app() apps)
        compilecache.warmup_state().reset()
