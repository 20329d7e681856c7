"""Framework-level endpoints: /ready, /error, /metrics, /trace and probes.

A copy of the JAX package's ``oryx_tpu/serving/resources/common.py`` (host
code, no JAX). ``POST /debug/profile`` captures a ``torch.profiler`` trace
(a Chrome trace file) where the reference captures a ``jax.profiler`` one.

Equivalent of the reference's Ready (app/oryx-app-serving/.../Ready.java:33)
and ErrorResource (framework/oryx-lambda-serving/.../ErrorResource.java:35);
/metrics is the Prometheus exposition of the process-wide registry
(docs/observability.md) — the stand-in for the reference's Spark-UI/JMX
visibility (SURVEY §5.1); /metrics/history serves the in-process
time-series rings behind it (common/tsdb.py). /trace renders the span ring
buffer
(common/spans.py): recent spans, the kept-slowest per route, or one whole
trace by id. /healthz (liveness) and /readyz (readiness: model loaded +
update-consumer lag under ``oryx.serving.ready-max-lag-sec``) are the
load-balancer probe pair — always auth-exempt.
"""

from __future__ import annotations

import asyncio

from aiohttp import web

from oryx_tpu_torch.api.serving import OryxServingException
from oryx_tpu_torch.common import blackbox
from oryx_tpu_torch.common import compilecache
from oryx_tpu_torch.common import lineage
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import profiling
from oryx_tpu_torch.common import slo as slo_mod
from oryx_tpu_torch.common import spans
from oryx_tpu_torch.common import tsdb
from oryx_tpu_torch.serving import resource as rsrc


async def ready(request: web.Request) -> web.Response:
    """200 when the model is loaded enough, 503 otherwise (HEAD or GET)."""
    try:
        rsrc.get_serving_model(request)
        return web.Response(status=200)
    except OryxServingException as e:
        return web.Response(status=e.status)


async def healthz(request: web.Request) -> web.Response:
    """Liveness: the process is up and the event loop is serving requests.
    Deliberately model-agnostic — a layer mid-model-load is alive (restart
    nothing), it is just not READY (send no traffic: that is /readyz)."""
    return web.json_response({"status": "ok"})


def _gauge_value(name: str) -> float:
    gauge = metrics_mod.default_registry().get(name)
    value = float(gauge.value) if gauge is not None else 0.0
    return 0.0 if value != value else value  # NaN (dead callback) -> unknown


async def readyz(request: web.Request) -> web.Response:
    """Readiness for load balancers: 200 only when (a) the model has passed
    ``min-model-load-fraction`` (the PR-2 load-fraction gate) and (b) the
    update consumer is not stale. Stale means BOTH gauges agree: messages
    are waiting behind the broker head (``…update_lag_messages``, probed
    live at read time) AND the consumer has made no progress for more than
    ``oryx.serving.ready-max-lag-sec`` (0 disables the lag check) — a
    quiet topic with nothing to consume is healthy however long it stays
    quiet, while a wedged consumer with a backlog keeps serving the OLD
    model silently, and this gate lets the balancer rotate that replica
    out before users notice. Both gauges are scrape-time callbacks, so the
    probe works even with ``oryx.metrics.enabled = false``.

    With batch-bucket warmup configured (``precompile-batches``), a third
    condition gates readiness: at least ``oryx.compile.ready-warm-fraction``
    of the pow2 bucket ladder must be compiled (default 1.0), so load
    balancers never route into a replica that would answer its first burst
    with XLA compiles. The ``warmup`` detail reports {done, total} buckets;
    once one ladder fully completes, warm-readiness is sticky — a staged
    generation re-warming off-path must not drop the replica out."""
    detail: dict = {}
    ok = True
    try:
        rsrc.get_serving_model(request)
        detail["model"] = "loaded"
    except OryxServingException:
        detail["model"] = "not loaded"
        ok = False
    config = request.app[rsrc.CONFIG_KEY]
    warm = compilecache.warmup_state()
    detail["warmup"] = warm.snapshot()
    warm_fraction = config.get_float("oryx.compile.ready-warm-fraction", 1.0)
    if not warm.ready(warm_fraction):
        detail["warmup_status"] = "cold"
        ok = False
    max_lag = config.get_float("oryx.serving.ready-max-lag-sec", 600.0)
    detail["ready_max_lag_sec"] = max_lag
    if max_lag > 0:
        lag_sec = _gauge_value("oryx_serving_update_lag_seconds")
        lag_msgs = _gauge_value("oryx_serving_update_lag_messages")
        detail["update_lag_sec"] = round(lag_sec, 3)
        detail["update_lag_messages"] = int(lag_msgs)
        if lag_msgs > 0 and lag_sec > max_lag:
            detail["update_consumer"] = "stale"
            ok = False
    # active SLO burn-rate alerts ride the probe body (docs/slo.md) so
    # anything watching /readyz sees budget exhaustion — INFORMATIONAL
    # only: a replica burning budget is exactly the replica that must NOT
    # be rotated out of the balancer (less capacity burns faster). The
    # evaluation takes the engine lock + registry family locks, so it
    # hops to a worker thread like every other blocking probe read.
    detail["slo_alerts"] = await asyncio.to_thread(slo_mod.active_alerts)
    # trend alerts (common/tsdb.py) ride the same way and are equally
    # INFORMATIONAL: a replica whose queue depth is ramping toward its cap
    # needs traffic shifted TO its peers, not a readiness failure
    detail["trend_alerts"] = tsdb.trend_alerts()
    detail["status"] = "ready" if ok else "unavailable"
    return web.json_response(detail, status=200 if ok else 503)


async def error(request: web.Request) -> web.Response:
    """Error page aggregating status/message (ErrorResource)."""
    status = request.query.get("status", "500")
    message = request.query.get("message", "error")
    return web.json_response({"status": int(status), "error": message}, status=int(status))


async def metrics(request: web.Request) -> web.Response:
    """Prometheus text exposition of the process-wide metrics registry.
    Exempt from API auth unless ``oryx.metrics.require-auth``. An Accept
    header asking for OpenMetrics gets that format WITH trace-id exemplars
    on the latency histograms (the 0.0.4 text parser would reject them)."""
    openmetrics = "application/openmetrics-text" in request.headers.get(
        "Accept", ""
    )
    body = metrics_mod.default_registry().render(
        exemplars=openmetrics
    ).encode("utf-8")
    content_type = (
        metrics_mod.OPENMETRICS_CONTENT_TYPE if openmetrics
        else metrics_mod.CONTENT_TYPE
    )
    return web.Response(body=body, headers={"Content-Type": content_type})


async def metrics_history(request: web.Request) -> web.Response:
    """JSON time series from the in-process tsdb rings (common/tsdb.py,
    docs/observability.md "Time series & trends"): per-signal
    ``{unit, points: [[ts, value], ...]}`` plus active trend alerts.
    ``?signal=a,b`` keeps only the named signals; ``?since=<unix-ts>``
    keeps only points strictly newer (pollers — fleet-status --watch —
    pass the last ts they saw). Walking the rings takes their locks, so
    the read hops to a worker thread like every other blocking probe.
    Auth story = /metrics (exempt unless ``oryx.metrics.require-auth``)."""
    signal = request.query.get("signal")
    signals = None
    if signal:
        signals = {s for s in signal.replace(",", " ").split() if s}
    since = None
    raw_since = request.query.get("since")
    if raw_since:
        try:
            since = float(raw_since)
        except ValueError as e:
            raise OryxServingException(400, "bad since") from e
    payload = await asyncio.to_thread(tsdb.history_payload, signals, since)
    return web.json_response(payload)


async def trace(request: web.Request) -> web.Response:
    """JSON view of the span ring buffer (auth story identical to /metrics).

    ``?trace_id=<32hex>`` returns every buffered span of one trace (what
    ``python -m oryx_tpu_torch.tools.trace_summary --trace-id`` renders as a
    tree); otherwise the most recent ``?limit=`` spans (default 100) plus
    the kept-slowest spans per route — the p99 outliers survive ring wrap
    by design."""
    recorder = spans.default_recorder()
    trace_id = request.query.get("trace_id")
    if trace_id:
        hits = recorder.spans(trace_id=trace_id)
        return web.json_response({
            "trace_id": trace_id,
            "spans": [s.to_dict() for s in hits],
        })
    try:
        limit = max(1, int(request.query.get("limit", "100")))
    except ValueError as e:
        raise OryxServingException(400, "bad limit") from e
    return web.json_response({
        "enabled": spans.enabled(),
        "stats": recorder.stats(),
        "recent": [s.to_dict() for s in recorder.spans(limit=limit)],
        "slowest_by_route": {
            route: [s.to_dict() for s in slow]
            for route, slow in sorted(recorder.slowest().items())
        },
    })


async def lineage_view(request: web.Request) -> web.Response:
    """Model lineage console (docs/observability.md "Model lineage &
    freshness"): the provenance chain of the live and staged generations —
    generation id, checkpoint fingerprint, resume/scratch origin, the
    per-partition input offsets each generation trained through, its
    publish→consume→warm→live→first-query adoption timeline — plus the
    speed-tier delta watermark and the derived freshness numbers. This is
    the attributability loop closer: take ``x-oryx-model-generation`` off
    any response, look its offsets up here, and you know exactly which
    input data produced that answer. Auth story = /metrics (exempt unless
    ``oryx.metrics.require-auth``)."""
    snapshot = await asyncio.to_thread(lineage.tracker().snapshot)
    snapshot["enabled"] = lineage.enabled()
    return web.json_response(snapshot)


async def debug_profile(request: web.Request) -> web.Response:
    """On-demand device profiling of the live process:
    ``POST /debug/profile?seconds=N`` captures a ``torch.profiler`` trace
    for N seconds (refused past ``oryx.profiling.max-capture-sec``) and
    answers with the trace directory, which holds one Chrome trace
    (``*.pt.trace.json``: ``python -m oryx_tpu_torch.tools.trace_summary``
    prints its kernels by self time; Perfetto or ``chrome://tracing`` read
    it too).
    Exactly ONE capture may be in flight per process: a concurrent request,
    or one arriving while another torch profiler runs in the process,
    answers 409 naming the current owner. The capture runs in a worker
    thread (``asyncio.to_thread``) so the event loop keeps serving —
    profiling a replica must not stall its traffic. Auth story = /metrics
    (exempt unless ``oryx.metrics.require-auth``)."""
    config = request.app[rsrc.CONFIG_KEY]
    try:
        seconds = float(request.query.get("seconds", "3"))
    except ValueError as e:
        raise OryxServingException(400, "bad seconds") from e
    max_seconds = config.get_float("oryx.profiling.max-capture-sec", 60.0)
    rsrc.check(seconds > 0, "seconds must be positive")
    rsrc.check(seconds <= max_seconds,
               f"seconds capped at {max_seconds:g} "
               "(oryx.profiling.max-capture-sec)")
    session = profiling.profile_session()
    if session.busy():
        # fast-path refusal; the start() inside capture() still guards the
        # race where two requests pass this check together
        raise OryxServingException(
            409, f"profiler capture already in flight "
                 f"(owner={session.owner()!r})"
        )
    try:
        # dir creation + capture are ONE worker-thread hop: both block, and
        # neither may stall the loop of the replica being profiled
        trace_dir = await asyncio.to_thread(
            profiling.timed_capture,
            config.get_string("oryx.profiling.profile-dir", None),
            seconds, "debug-endpoint",
        )
    except profiling.ProfileBusyError as e:
        raise OryxServingException(409, str(e)) from e
    return web.json_response({
        "trace_dir": trace_dir,
        "seconds": seconds,
        "hint": f"python -m oryx_tpu_torch.tools.trace_summary {trace_dir} "
                f"(or open {trace_dir}/*.pt.trace.json in Perfetto)",
    })


async def debug_bundle(request: web.Request) -> web.Response:
    """The black-box flight recorder's one-call postmortem artifact
    (common/blackbox.py): event ring + metrics snapshot + slowest traces
    + SLO status + series window + redacted config + versions, as a
    single JSON document. Assembly walks the registry and the span
    reservoir, so it runs in a worker thread — a postmortem pull must not
    stall the replica being diagnosed. Auth
    story = /metrics (exempt unless ``oryx.metrics.require-auth``).
    The same bundle auto-dumps to ``oryx.blackbox.dump-dir`` on SIGTERM,
    breaker-open/quarantine edges, and the periodic flight-recorder tick
    — this endpoint is the live view of what a dead replica would have
    left on disk."""
    payload = await asyncio.to_thread(blackbox.bundle, "endpoint")
    return web.json_response(payload)


def register(app: web.Application) -> None:
    app.router.add_route("GET", "/ready", ready)
    app.router.add_route("HEAD", "/ready", ready)
    app.router.add_route("GET", "/healthz", healthz)
    app.router.add_route("HEAD", "/healthz", healthz)
    app.router.add_route("GET", "/readyz", readyz)
    app.router.add_route("HEAD", "/readyz", readyz)
    app.router.add_route("GET", "/error", error)
    app.router.add_route("GET", "/metrics", metrics)
    app.router.add_route("GET", "/metrics/history", metrics_history)
    app.router.add_route("GET", "/trace", trace)
    app.router.add_route("GET", "/lineage", lineage_view)
    app.router.add_route("POST", "/debug/profile", debug_profile)
    app.router.add_route("GET", "/debug/bundle", debug_bundle)
