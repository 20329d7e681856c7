"""Prometheus text-exposition readers for the fleet console.

The functions of the JAX package's ``oryx_tpu/tools/trace_summary.py``
that :mod:`oryx_tpu_torch.common.federation` needs, copied (host code, no
JAX, no torch) and held equal to them by ``tests/test_torch_federation.py``:
:func:`parse_metrics_text` and :func:`bucket_quantile`; and
:func:`device_perf_rows`, the device-performance view of a metrics dump
(``common/profiling``'s series), held to the reference's test by
``tests/test_torch_profiling.py``. The rest of that tool (profiler traces,
perf history) is not ported.
"""

from __future__ import annotations

import re
from collections import defaultdict

_SAMPLE_RE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$"
)
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')



def parse_metrics_text(text: str) -> tuple:
    """Returns (histograms, scalars).

    ``histograms``: {base name: {label tuple: {"buckets": [(le, cumulative)],
    "sum": float, "count": float}}} — ``le`` ascending, +Inf last.
    ``scalars``: [(name, label tuple, value)] for counters/gauges."""
    buckets: dict = defaultdict(dict)
    aux: dict = defaultdict(dict)  # (base, key) -> {"sum":, "count":}
    scalars: list = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labelblob, value_raw = m.groups()
        labels = dict(_LABEL_RE.findall(labelblob or ""))
        try:
            value = float(value_raw.replace("+Inf", "inf").replace("Inf", "inf"))
        except ValueError:
            continue
        if name.endswith("_bucket") and "le" in labels:
            le_raw = labels.pop("le")
            le = float("inf") if "Inf" in le_raw else float(le_raw)
            key = tuple(sorted(labels.items()))
            buckets[name[: -len("_bucket")]].setdefault(key, []).append((le, value))
        elif name.endswith("_sum") or name.endswith("_count"):
            base, _, kind = name.rpartition("_")
            key = tuple(sorted(labels.items()))
            aux[(base, key)][kind] = value
        else:
            scalars.append((name, tuple(sorted(labels.items())), value))
    histograms: dict = {}
    for base, by_key in buckets.items():
        histograms[base] = {}
        for key, bs in by_key.items():
            side = aux.pop((base, key), {})
            histograms[base][key] = {
                "buckets": sorted(bs),
                "sum": side.get("sum", 0.0),
                "count": side.get("count", 0.0),
            }
    # _sum/_count without buckets (summaries, foreign exporters) → scalars
    for (base, key), side in aux.items():
        for kind, value in side.items():
            scalars.append((f"{base}_{kind}", key, value))
    return histograms, scalars



def bucket_quantile(bucket_rows: list, count: float, q: float) -> float:
    """Estimate the q-quantile from cumulative buckets with the standard
    Prometheus linear interpolation inside the containing bucket (an upper-
    bound-biased estimate — exactly what histogram_quantile() reports).

    Edge cases the cumulative walk must survive (regression-tested):

      * an EMPTY containing bucket (``cum == prev_cum``) divides by zero
        without the span guard — report the bucket's upper edge;
      * a first bucket with ``le <= 0``: the walk's synthetic lower edge is
        0.0, which sits ABOVE the bucket — interpolating from it would walk
        the wrong direction, so report the upper edge like Prometheus does;
      * non-monotone cumulative counts (a torn multi-line scrape): clamp
        the interpolation fraction to [0, 1] so the estimate stays inside
        the containing bucket instead of extrapolating past its edges.
    """
    if count <= 0:
        return float("nan")
    target = q * count
    prev_le, prev_cum = 0.0, 0.0
    first = True
    for le, cum in bucket_rows:
        if cum >= target:
            if le == float("inf"):
                return prev_le  # open-ended bucket: report its lower edge
            if first and le <= 0.0:
                return le  # no meaningful lower edge below zero
            span = cum - prev_cum
            frac = (target - prev_cum) / span if span > 0 else 1.0
            frac = min(1.0, max(0.0, frac))
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = le, cum
        first = False
    return bucket_rows[-1][0] if bucket_rows else float("nan")


#: Metric-name prefixes of the device-performance view.
_DEVICE_PERF_PREFIXES = ("oryx_device_", "oryx_host_")

#: Renderings for the headline device-perf gauges (value -> display).
_DEVICE_PERF_FMT = {
    "oryx_device_mfu": lambda v: f"{100.0 * v:.3f}% MFU",
    "oryx_device_hbm_bandwidth_fraction":
        lambda v: f"{100.0 * v:.2f}% of HBM peak",
    "oryx_device_flops_per_second": lambda v: f"{v / 1e12:.4f} TFLOP/s",
    "oryx_device_bytes_per_second": lambda v: f"{v / 1e9:.3f} GB/s",
}


def device_perf_rows(scalars: list) -> list:
    """(series, value, pretty) rows for the device-performance section of a
    metrics dump: cost-accounting counters/rates, MFU/bandwidth fractions,
    and device/host memory gauges."""
    rows = []
    for name, key, value in scalars:
        if not name.startswith(_DEVICE_PERF_PREFIXES):
            continue
        label = ",".join(f"{k}={v}" for k, v in key)
        series = f"{name}{{{label}}}" if label else name
        fmt = _DEVICE_PERF_FMT.get(name)
        if fmt is not None:
            pretty = fmt(value)
        elif name.endswith("_bytes") or "memory" in name:
            pretty = f"{value / (1024.0 ** 2):.1f} MiB"
        else:
            pretty = f"{value:,.0f}"
        rows.append((series, value, pretty))
    rows.sort(key=lambda r: r[0])
    return rows
