"""Fleet-wide metrics federation: scrape N replicas, merge soundly, render.

A copy of the JAX package's ``oryx_tpu/common/federation.py``
(host code, no JAX), held equal to it by ``tests/test_torch_federation.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Every observability surface of a serving replica is per-process: an
operator of N replicas has no fleet error rate and no single place to ask
"are we burning budget right now" without this module, the
dependency-free aggregator behind ``python -m oryx_tpu_torch.cli
fleet-status``: it scrapes each replica's ``/metrics``, ``/readyz``, and
``/trace`` over plain ``urllib`` (concurrently, each under its own
timeout), merges the expositions with TYPE-aware semantics, and renders
either a merged Prometheus ``fleet`` exposition or a one-shot/``--watch``
operator table.

Merge rules (the soundness contract — docs/slo.md "Runbook"):

  * **counters sum** across replicas per label set.
  * **histograms add bucket-wise** — only when every replica's bucket
    edges for that family match exactly. A mismatch (mid-rollout bucket
    change) falls back to per-replica rows with a ``replica`` label;
    never a silent mis-merge.
  * **gauges keep per-replica rows** (``replica`` label) plus
    ``<name>:fleet_min`` / ``:fleet_max`` / ``:fleet_sum`` rollups (the
    recording-rule naming idiom) — summing two replicas' MFU would be
    nonsense, so gauges are never collapsed.
  * **down replicas are reported down** (``oryx_fleet_replica_up`` 0 and
    an ``error`` string), excluded from the merge, and never poison it.

The replica set comes from ``oryx.fleet.replicas`` (config) or CLI args;
entries are ``host:port`` or full ``http(s)://`` base URLs (an optional
context path rides along: ``host:port/api``).
"""

from __future__ import annotations

import concurrent.futures
import json
import time
import urllib.error
import urllib.request
from collections import defaultdict

# the table's qps/error/latency columns exclude probe/scrape routes with
# the SAME predicate the SLO engine uses — one contract, two surfaces
from oryx_tpu_torch.common.slo import is_ops_route as _is_ops_route
from oryx_tpu_torch.common.textutils import sparkline
from oryx_tpu_torch.tools.trace_summary import bucket_quantile, parse_metrics_text

DEFAULT_TIMEOUT_SEC = 5.0


def normalize_url(entry: str) -> str:
    entry = entry.strip().rstrip("/")
    if not entry.startswith(("http://", "https://")):
        entry = f"http://{entry}"
    return entry


def _fetch(url: str, timeout: float) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as resp:  # noqa: S310 — operator-listed replica
        return resp.read()


class ReplicaScrape:
    """One replica's scrape result: exposition + readyz + trace stats, or
    ``up = False`` with the error string."""

    def __init__(self, url: str):
        self.url = url
        self.up = False
        self.error: "str | None" = None
        self.types: dict[str, str] = {}
        self.histograms: dict = {}
        self.scalars: list = []
        self.readyz: "dict | None" = None
        self.ready = False
        self.trace_stats: "dict | None" = None
        # /metrics/history payload — None on a replica without that
        # endpoint; every consumer falls back to client-side deltas
        self.history: "dict | None" = None

    @property
    def name(self) -> str:
        return self.url.split("://", 1)[-1]


_TYPE_PREFIX = "# TYPE "


def parse_types(text: str) -> dict:
    """{family name: kind} from the exposition's # TYPE headers."""
    out = {}
    for line in text.splitlines():
        if line.startswith(_TYPE_PREFIX):
            parts = line[len(_TYPE_PREFIX):].split()
            if len(parts) >= 2:
                out[parts[0]] = parts[1]
    return out


def scrape_one(base_url: str, timeout: float = DEFAULT_TIMEOUT_SEC) -> ReplicaScrape:
    """Scrape one replica. /metrics failing marks the replica down;
    /readyz and /trace degrade independently (a 503 readyz body still
    parses — that is the probe WORKING, reporting unready)."""
    scrape = ReplicaScrape(base_url)
    try:
        text = _fetch(f"{base_url}/metrics", timeout).decode(
            "utf-8", errors="replace"
        )
        scrape.types = parse_types(text)
        scrape.histograms, scrape.scalars = parse_metrics_text(text)
        scrape.up = True
    except Exception as e:  # noqa: BLE001 — down replicas are data, not errors
        scrape.error = f"{type(e).__name__}: {e}"
        return scrape
    try:
        body = _fetch(f"{base_url}/readyz", timeout)
        scrape.readyz = json.loads(body)
        scrape.ready = scrape.readyz.get("status") == "ready"
    except urllib.error.HTTPError as e:  # readyz 503 still carries the body
        try:
            scrape.readyz = json.loads(e.read())
        except Exception:  # noqa: BLE001
            scrape.readyz = {"status": f"http {e.code}"}
    except Exception as e:  # noqa: BLE001
        scrape.readyz = {"status": f"unreachable: {type(e).__name__}"}
    try:
        payload = json.loads(_fetch(f"{base_url}/trace?limit=1", timeout))
        scrape.trace_stats = payload.get("stats")
    except Exception:  # noqa: BLE001 — tracing may be disabled; optional
        scrape.trace_stats = None
    try:
        # server-side time series: optional — a 404 or a body
        # without a signals dict is simply a replica that predates the
        # endpoint, and the client-side delta path covers it
        payload = json.loads(_fetch(f"{base_url}/metrics/history", timeout))
        if isinstance(payload, dict) and isinstance(
                payload.get("signals"), dict):
            scrape.history = payload
    except Exception:  # noqa: BLE001 — history is optional
        scrape.history = None
    return scrape


def _history_points(scrape: ReplicaScrape, signal: str) -> list:
    """``[ts, value]`` pairs for one signal from a scrape's history payload
    (empty on a replica without the endpoint or an unknown signal)."""
    hist = getattr(scrape, "history", None) or {}
    sig = (hist.get("signals") or {}).get(signal) or {}
    points = sig.get("points") or []
    return [p for p in points
            if isinstance(p, (list, tuple)) and len(p) == 2]


class FleetSnapshot:
    def __init__(self, replicas: "list[ReplicaScrape]"):
        self.replicas = replicas
        self.time = time.time()

    @property
    def up(self) -> "list[ReplicaScrape]":
        return [r for r in self.replicas if r.up]


def scrape_fleet(urls: "list[str]",
                 timeout: float = DEFAULT_TIMEOUT_SEC) -> FleetSnapshot:
    """Scrape every replica concurrently (one slow replica must not serialize
    the fleet view behind its timeout)."""
    urls = [normalize_url(u) for u in urls]
    if not urls:
        return FleetSnapshot([])
    with concurrent.futures.ThreadPoolExecutor(
        max_workers=min(16, len(urls))
    ) as pool:
        return FleetSnapshot(list(pool.map(
            lambda u: scrape_one(u, timeout), urls
        )))


# ---------------------------------------------------------------------------
# Merge
# ---------------------------------------------------------------------------


class MergedFleet:
    """TYPE-aware merge of the up replicas' expositions."""

    def __init__(self):
        self.types: dict[str, str] = {}
        # counters: name -> {labelkey: summed value}
        self.counters: dict = defaultdict(lambda: defaultdict(float))
        # gauges/untyped: name -> {labelkey: {replica: value}}
        self.gauges: dict = defaultdict(lambda: defaultdict(dict))
        # histograms with matching edges: name -> {labelkey:
        #   {"buckets": [(le, cum)], "sum": float, "count": float}}
        self.histograms: dict = {}
        # bucket-mismatched families: name -> {(replica, labelkey): data}
        self.histogram_fallback: dict = {}


def _kind_of(name: str, types: dict) -> str:
    kind = types.get(name)
    if kind:
        return kind
    # untyped input (a foreign exporter): the _total convention is the
    # only safe signal for summing
    return "counter" if name.endswith("_total") else "gauge"


def merge(snapshot: FleetSnapshot) -> MergedFleet:
    out = MergedFleet()
    up = snapshot.up
    for r in up:
        out.types.update(r.types)
    for r in up:
        for name, labelkey, value in r.scalars:
            kind = _kind_of(name, out.types)
            if kind == "counter":
                out.counters[name][labelkey] += value
            else:
                out.gauges[name][labelkey][r.name] = value
    # histograms: same edges everywhere -> bucket-wise add; else fallback
    hist_names = {name for r in up for name in r.histograms}
    for name in hist_names:
        edge_sets = set()
        for r in up:
            for _key, h in r.histograms.get(name, {}).items():
                edge_sets.add(tuple(le for le, _c in h["buckets"]))
        if len(edge_sets) > 1:
            fallback = {}
            for r in up:
                for key, h in r.histograms.get(name, {}).items():
                    fallback[(r.name, key)] = h
            out.histogram_fallback[name] = fallback
            continue
        merged: dict = {}
        for r in up:
            for key, h in r.histograms.get(name, {}).items():
                slot = merged.setdefault(key, {
                    "buckets": [[le, 0.0] for le, _ in h["buckets"]],
                    "sum": 0.0, "count": 0.0,
                })
                for i, (_le, cum) in enumerate(h["buckets"]):
                    slot["buckets"][i][1] += cum
                slot["sum"] += h["sum"]
                slot["count"] += h["count"]
        out.histograms[name] = {
            key: {"buckets": [tuple(b) for b in h["buckets"]],
                  "sum": h["sum"], "count": h["count"]}
            for key, h in merged.items()
        }
    return out


# ---------------------------------------------------------------------------
# Prometheus-text `fleet` exposition
# ---------------------------------------------------------------------------


def _fmt(value: float) -> str:
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def _labelstr(labelkey: tuple, extra: "tuple | None" = None) -> str:
    pairs = list(labelkey)
    if extra:
        pairs.append(extra)
    return ",".join(f'{k}="{v}"' for k, v in sorted(pairs))


def render_prom(snapshot: FleetSnapshot, merged: "MergedFleet | None" = None) -> str:
    """Merged fleet exposition: summed counters/histograms under their own
    names, per-replica gauges with a ``replica`` label plus
    ``:fleet_min``/``:fleet_max``/``:fleet_sum`` rollups, and
    ``oryx_fleet_replica_up`` per target."""
    m = merged if merged is not None else merge(snapshot)
    out: list[str] = []
    out.append("# HELP oryx_fleet_replica_up 1 when the replica's /metrics "
               "scrape succeeded")
    out.append("# TYPE oryx_fleet_replica_up gauge")
    for r in snapshot.replicas:
        out.append(
            f'oryx_fleet_replica_up{{replica="{r.name}"}} {1 if r.up else 0}'
        )
    for name in sorted(m.counters):
        out.append(f"# TYPE {name} counter")
        for key, value in sorted(m.counters[name].items()):
            ls = _labelstr(key)
            out.append(f"{name}{{{ls}}} {_fmt(value)}" if ls
                       else f"{name} {_fmt(value)}")
    for name in sorted(m.gauges):
        out.append(f"# TYPE {name} gauge")
        rollup: dict[tuple, list] = defaultdict(list)
        for key, by_replica in sorted(m.gauges[name].items()):
            for replica, value in sorted(by_replica.items()):
                out.append(
                    f"{name}{{{_labelstr(key, ('replica', replica))}}} "
                    f"{_fmt(value)}"
                )
                rollup[key].append(value)
        for agg, fn in (("fleet_min", min), ("fleet_max", max),
                        ("fleet_sum", sum)):
            for key, values in sorted(rollup.items()):
                ls = _labelstr(key)
                out.append(f"{name}:{agg}{{{ls}}} {_fmt(fn(values))}" if ls
                           else f"{name}:{agg} {_fmt(fn(values))}")
    for name in sorted(m.histograms):
        out.append(f"# TYPE {name} histogram")
        for key, h in sorted(m.histograms[name].items()):
            base = _labelstr(key)
            for le, cum in h["buckets"]:
                le_s = "+Inf" if le == float("inf") else _fmt(le)
                ls = f'{base},le="{le_s}"' if base else f'le="{le_s}"'
                out.append(f"{name}_bucket{{{ls}}} {_fmt(cum)}")
            out.append(f"{name}_sum{{{base}}} {_fmt(h['sum'])}" if base
                       else f"{name}_sum {_fmt(h['sum'])}")
            out.append(f"{name}_count{{{base}}} {_fmt(h['count'])}" if base
                       else f"{name}_count {_fmt(h['count'])}")
    for name in sorted(m.histogram_fallback):
        out.append(f"# TYPE {name} histogram")
        out.append("# fleet: bucket edges differ across replicas; "
                   "per-replica rows (never mis-merged)")
        for (replica, key), h in sorted(m.histogram_fallback[name].items()):
            base = _labelstr(key, ("replica", replica))
            for le, cum in h["buckets"]:
                le_s = "+Inf" if le == float("inf") else _fmt(le)
                out.append(f'{name}_bucket{{{base},le="{le_s}"}} {_fmt(cum)}')
            out.append(f"{name}_sum{{{base}}} {_fmt(h['sum'])}")
            out.append(f"{name}_count{{{base}}} {_fmt(h['count'])}")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# Operator table
# ---------------------------------------------------------------------------


def _scalar_sum(scrape: ReplicaScrape, name: str, want=None) -> float:
    total = 0.0
    for n, key, value in scrape.scalars:
        if n == name and (want is None or want(dict(key))):
            total += value
    return total


def _scalar_max(scrape: ReplicaScrape, name: str) -> "float | None":
    values = [v for n, _k, v in scrape.scalars if n == name]
    return max(values) if values else None


def _latency_quantiles(scrape: ReplicaScrape,
                       prev: "ReplicaScrape | None") -> tuple:
    """(p50_ms, p99_ms) over non-ops routes from the request-latency
    buckets — windowed against ``prev`` in --watch mode, lifetime-cumulative
    one-shot."""
    fam = scrape.histograms.get("oryx_serving_request_latency_seconds", {})
    prev_fam = (prev.histograms.get(
        "oryx_serving_request_latency_seconds", {}) if prev else {})
    merged: dict[float, float] = {}
    count = 0.0
    for key, h in fam.items():
        labels = dict(key)
        if _is_ops_route(labels.get("route", "")):
            continue
        prev_h = prev_fam.get(key)
        for i, (le, cum) in enumerate(h["buckets"]):
            prev_cum = (prev_h["buckets"][i][1]
                        if prev_h and i < len(prev_h["buckets"]) else 0.0)
            merged[le] = merged.get(le, 0.0) + max(0.0, cum - prev_cum)
        count += h["count"] - (prev_h["count"] if prev_h else 0.0)
    if not merged or count <= 0:
        return None, None
    rows = sorted(merged.items())
    return (1000.0 * bucket_quantile(rows, count, 0.50),
            1000.0 * bucket_quantile(rows, count, 0.99))


def _requests(scrape: ReplicaScrape) -> tuple:
    """(total, errors) over non-ops routes."""
    total = errors = 0.0
    for n, key, value in scrape.scalars:
        if n != "oryx_serving_requests_total":
            continue
        labels = dict(key)
        if _is_ops_route(labels.get("route", "")):
            continue
        status = labels.get("status", "")
        if status == "cancelled":
            continue  # client disconnects: not answered requests (SLO parity)
        total += value
        if status.startswith("5"):
            errors += value
    return total, errors


def replica_row(scrape: ReplicaScrape, prev: "ReplicaScrape | None" = None,
                interval_s: "float | None" = None) -> dict:
    """One operator-table row. With a previous scrape and an interval, the
    rate columns are windowed deltas; one-shot they stay None and the
    table shows cumulative counts instead."""
    row: dict = {"replica": scrape.name, "up": scrape.up,
                 "ready": scrape.ready, "error": scrape.error}
    if not scrape.up:
        return row
    total, errors = _requests(scrape)
    row["requests_total"] = total
    row["errors_total"] = errors
    row["error_pct"] = 100.0 * errors / total if total else 0.0
    if prev is not None and prev.up and interval_s and interval_s > 0:
        p_total, p_errors = _requests(prev)
        d_total = max(0.0, total - p_total)
        d_errors = max(0.0, errors - p_errors)
        row["qps"] = d_total / interval_s
        row["error_pct"] = 100.0 * d_errors / d_total if d_total else 0.0
        # raw window deltas for the FLEET summary row: its error rate must
        # aggregate the same window the per-replica cells show, never mix
        # a lifetime ratio into a column of windowed ones
        row["_d_total"] = d_total
        row["_d_errors"] = d_errors
    else:
        row["qps"] = None
    # server-side rate: a replica offering /metrics/history
    # reports its own sampled request rate — steadier than a client-side
    # delta and available on the very FIRST scrape. The delta path above
    # stays the fallback for replicas without it in a mixed fleet.
    rate_points = _history_points(scrape, "request_rate")
    if rate_points:
        row["qps"] = float(rate_points[-1][1])
        row["qps_source"] = "server"
    else:
        row["qps_source"] = "client" if row["qps"] is not None else None
    row["qps_spark"] = sparkline([v for _t, v in rate_points]) or None
    fresh_points = _history_points(scrape, "freshness_sec")
    row["fresh_spark"] = sparkline(
        [v for _t, v in fresh_points if v is not None and v >= 0]
    ) or None
    p50, p99 = _latency_quantiles(scrape, prev)
    row["p50_ms"] = p50
    row["p99_ms"] = p99
    row["shed"] = _scalar_sum(scrape, "oryx_shed_requests_total")
    row["degraded"] = _scalar_sum(
        scrape, "oryx_breaker_degraded_requests_total")
    row["breaker_open"] = _scalar_max(
        scrape, "oryx_circuit_breaker_state") or 0.0
    row["lag_messages"] = _scalar_sum(
        scrape, "oryx_serving_update_lag_messages")
    row["lag_sec"] = _scalar_sum(scrape, "oryx_serving_update_lag_seconds")
    row["mfu"] = _scalar_max(scrape, "oryx_device_mfu")
    row["hbm_bytes"] = _scalar_sum(scrape, "oryx_device_memory_bytes_in_use")
    worst_burn = _scalar_max(scrape, "oryx_slo_burn_rate")
    row["worst_burn_rate"] = worst_burn
    row["slo_alerts"] = int(_scalar_sum(scrape, "oryx_slo_alert_active"))
    budget = [v for n, _k, v in scrape.scalars
              if n == "oryx_slo_error_budget_remaining"]
    row["budget_remaining"] = min(budget) if budget else None
    warm = (scrape.readyz or {}).get("warmup") or {}
    if warm.get("total"):
        row["warmup"] = f"{warm.get('done', 0)}/{warm.get('total', 0)}"
    else:
        row["warmup"] = "-"
    fresh = _scalar_max(scrape, "oryx_model_data_freshness_seconds")
    # the gauge reports -1 until a stamped generation goes live; the table
    # shows "-" (unknown) rather than a misleading negative age
    row["fresh_s"] = fresh if fresh is not None and fresh >= 0 else None
    gen, gen_ts = None, None
    for n, key, value in scrape.scalars:
        if n != "oryx_model_generation_info" or value <= 0:
            continue  # zeroed children are past generations
        if gen_ts is None or value > gen_ts:
            gen, gen_ts = dict(key).get("generation"), value
    row["generation"] = gen
    # publish unix-seconds of the live generation: orderable across
    # replicas, so table_rows can flag the laggards (generation skew)
    row["_gen_ts"] = gen_ts
    return row


def table_rows(snapshot: FleetSnapshot,
               prev: "FleetSnapshot | None" = None) -> list:
    """Per-replica rows plus one trailing ``fleet`` summary row."""
    prev_by_url = {r.url: r for r in prev.replicas} if prev else {}
    interval = snapshot.time - prev.time if prev else None
    rows = [
        replica_row(r, prev_by_url.get(r.url), interval)
        for r in snapshot.replicas
    ]
    up_rows = [r for r in rows if r.get("up")]
    fleet: dict = {
        "replica": "FLEET",
        "up": bool(up_rows),
        "ready": all(r.get("ready") for r in up_rows) and bool(up_rows),
        "n_up": len(up_rows),
        "n_total": len(rows),
    }
    for col in ("requests_total", "errors_total", "shed", "degraded",
                "lag_messages", "hbm_bytes"):
        fleet[col] = sum(r.get(col) or 0.0 for r in up_rows)
    qps_vals = [r["qps"] for r in up_rows if r.get("qps") is not None]
    fleet["qps"] = sum(qps_vals) if qps_vals else None
    windowed = [r for r in up_rows if "_d_total" in r]
    if windowed:
        # watch mode: the fleet error rate aggregates the same window as
        # the per-replica cells (lifetime ratios would read as a live
        # fleet-wide error source long after every replica recovered)
        d_total = sum(r["_d_total"] for r in windowed)
        d_errors = sum(r["_d_errors"] for r in windowed)
        fleet["error_pct"] = 100.0 * d_errors / d_total if d_total else 0.0
    else:
        fleet["error_pct"] = (
            100.0 * fleet["errors_total"] / fleet["requests_total"]
            if fleet["requests_total"] else 0.0
        )
    p99s = [r["p99_ms"] for r in up_rows if r.get("p99_ms") is not None]
    p50s = [r["p50_ms"] for r in up_rows if r.get("p50_ms") is not None]
    fleet["p99_ms"] = max(p99s) if p99s else None
    fleet["p50_ms"] = max(p50s) if p50s else None
    burns = [r["worst_burn_rate"] for r in up_rows
             if r.get("worst_burn_rate") is not None]
    fleet["worst_burn_rate"] = max(burns) if burns else None
    fleet["slo_alerts"] = sum(r.get("slo_alerts") or 0 for r in up_rows)
    budgets = [r["budget_remaining"] for r in up_rows
               if r.get("budget_remaining") is not None]
    fleet["budget_remaining"] = min(budgets) if budgets else None
    mfus = [r["mfu"] for r in up_rows if r.get("mfu")]
    fleet["mfu"] = max(mfus) if mfus else None
    fleet["breaker_open"] = max(
        (r.get("breaker_open") or 0.0 for r in up_rows), default=0.0)
    fleet["warmup"] = "-"
    fresh_vals = [r["fresh_s"] for r in up_rows
                  if r.get("fresh_s") is not None]
    fleet["fresh_s"] = max(fresh_vals) if fresh_vals else None
    # generation skew: a replica still serving an OLDER generation than the
    # newest one adopted anywhere in the fleet gets flagged — that is the
    # rollout laggard an operator wants to see at a glance
    gen_ts_vals = [r["_gen_ts"] for r in up_rows
                   if r.get("_gen_ts") is not None]
    newest_ts = max(gen_ts_vals) if gen_ts_vals else None
    newest = [r for r in up_rows if r.get("_gen_ts") == newest_ts]
    fleet["generation"] = newest[0].get("generation") if newest else None
    fleet["generation_skew"] = False
    for r in up_rows:
        r["generation_skew"] = (
            newest_ts is not None
            and r.get("_gen_ts") is not None
            and r["_gen_ts"] < newest_ts
        )
        fleet["generation_skew"] = (
            fleet["generation_skew"] or r["generation_skew"])
    for r in rows:  # internal window-delta scratch never leaves the API
        r.pop("_d_total", None)
        r.pop("_d_errors", None)
        r.pop("_gen_ts", None)
    rows.append(fleet)
    return rows


def _cell(value, fmt: str, width: int, dash: str = "-") -> str:
    if value is None:
        return dash.rjust(width)
    return fmt.format(value)


def render_table(rows: list) -> str:
    """Fixed-width operator table (docs/slo.md "Runbook" reads one)."""
    out = [
        f"{'replica':<24} {'up':>3} {'rdy':>3} {'warm':>7} {'reqs':>9} "
        f"{'qps':>8} {'qps~':>8} {'err%':>6} {'p50ms':>8} {'p99ms':>8} "
        f"{'shed':>6} {'degr':>6} {'brk':>3} {'lag':>6} {'mfu%':>6} "
        f"{'hbm_mb':>8} {'burn':>7} {'alrt':>4} {'budget':>6} "
        f"{'fresh_s':>8} {'fresh~':>8} {'generation':>15}"
    ]
    for r in rows:
        if not r.get("up"):
            out.append(
                f"{r['replica']:<24} {'no':>3} {'-':>3}"
                + f"  DOWN: {r.get('error') or 'scrape failed'}"
            )
            continue
        mfu = r.get("mfu")
        out.append(
            f"{r['replica']:<24} {'yes':>3} "
            f"{'yes' if r.get('ready') else 'no':>3} "
            f"{str(r.get('warmup', '-')):>7} "
            f"{_cell(r.get('requests_total'), '{:9.0f}', 9)} "
            f"{_cell(r.get('qps'), '{:8.1f}', 8)} "
            # sparkline of the replica's server-side history ('-' when the
            # replica predates /metrics/history)
            f"{(r.get('qps_spark') or '-'):>8} "
            f"{_cell(r.get('error_pct'), '{:6.2f}', 6)} "
            f"{_cell(r.get('p50_ms'), '{:8.1f}', 8)} "
            f"{_cell(r.get('p99_ms'), '{:8.1f}', 8)} "
            f"{_cell(r.get('shed'), '{:6.0f}', 6)} "
            f"{_cell(r.get('degraded'), '{:6.0f}', 6)} "
            f"{_cell(r.get('breaker_open'), '{:3.0f}', 3)} "
            f"{_cell(r.get('lag_messages'), '{:6.0f}', 6)} "
            f"{_cell(100.0 * mfu if mfu is not None else None, '{:6.2f}', 6)} "
            f"{_cell((r.get('hbm_bytes') or 0.0) / (1 << 20), '{:8.1f}', 8)} "
            f"{_cell(r.get('worst_burn_rate'), '{:7.2f}', 7)} "
            f"{_cell(r.get('slo_alerts'), '{:4d}', 4)} "
            f"{_cell(r.get('budget_remaining'), '{:6.3f}', 6)} "
            f"{_cell(r.get('fresh_s'), '{:8.1f}', 8)} "
            f"{(r.get('fresh_spark') or '-'):>8} "
            # a trailing '*' flags generation skew: this replica serves an
            # older generation than the fleet's newest
            f"{(r.get('generation') or '-') + ('*' if r.get('generation_skew') else ''):>15}"
        )
    return "\n".join(out) + "\n"


def to_json(snapshot: FleetSnapshot,
            prev: "FleetSnapshot | None" = None) -> dict:
    """Machine-readable fleet view: per-replica scrape summary + table
    rows + merged counters (what tests and scripts consume)."""
    m = merge(snapshot)
    return {
        "time": snapshot.time,
        "replicas": [
            {
                "url": r.url,
                "up": r.up,
                "ready": r.ready,
                "error": r.error,
                "readyz": r.readyz,
                "trace_stats": r.trace_stats,
            }
            for r in snapshot.replicas
        ],
        "table": table_rows(snapshot, prev),
        "fleet": {
            "counters": {
                name: {_labelstr(key): value
                       for key, value in sorted(children.items())}
                for name, children in sorted(m.counters.items())
            },
        },
    }
