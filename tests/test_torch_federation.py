"""The port's fleet console (``common/federation``, ``cli fleet-status``),
held against the reference's.

The eleven cases of ``tests/test_federation.py`` run with their bodies
rebound to the port's ``federation`` (``_mirror``). Parity: the same
expositions, readiness bodies and history through both packages' parse,
merge and render give the same results, as do the copied metrics-text
readers and ``sparkline``. Last, ``python -m oryx_tpu_torch.cli
fleet-status --format json`` against two port serving replicas, each a CLI
process on the CPU over one ``file:`` update topic, checked as
``chip_smoke.py``'s deployment phase checks it (``fleet_status_check``).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from oryx_tpu.common import federation as ref_fed
from oryx_tpu.common import textutils as ref_textutils
from oryx_tpu.tools import trace_summary as ref_trace_summary
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import federation as fed
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.common import textutils
from oryx_tpu_torch.models.rdf import pmml_codec
from oryx_tpu_torch.models.rdf import train as rdftrain
from oryx_tpu_torch.models.schema import CategoricalValueEncodings, InputSchema
from oryx_tpu_torch.pmml import pmmlutils
from oryx_tpu_torch.tools import trace_summary
from oryx_tpu_torch.transport import topic as tp
from test_torch_observability import _mirror

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FED = _mirror("test_federation.py", {"fed": fed})

_CASES = [
    "test_counters_sum_histograms_add_bucketwise_gauges_stay_per_replica",
    "test_bucket_mismatch_falls_back_per_replica_never_mismerges",
    "test_down_replica_reported_not_poisoning",
    "test_table_excludes_ops_routes_and_counts_errors",
    "test_watch_mode_rates_come_from_deltas",
    "test_scrape_one_against_live_http_server",
    "test_normalize_url",
    "test_freshness_and_generation_columns_with_skew_marker",
    "test_replica_without_lineage_gauges_has_blank_columns",
    "test_server_side_history_beats_client_deltas_and_sparklines_render",
    "test_server_history_unknown_freshness_is_filtered_from_sparkline",
]


def test_every_reference_case_is_mirrored():
    assert sorted(_CASES) == sorted(n for n in _FED if n.startswith("test_"))


@pytest.mark.parametrize("case", _CASES)
def test_reference_case_on_the_port(case):
    _FED[case]()


_LINEAGE = (
    "# TYPE oryx_model_data_freshness_seconds gauge\n"
    "oryx_model_data_freshness_seconds 12.5\n"
    "# TYPE oryx_model_generation_info gauge\n"
    'oryx_model_generation_info{fingerprint="f1",generation="gaaa"} 1000\n'
    "# TYPE oryx_shed_requests_total counter\n"
    'oryx_shed_requests_total{route="/r"} 3\n'
    "# TYPE oryx_slo_burn_rate gauge\n"
    'oryx_slo_burn_rate{objective="availability",window="5m"} 0.25\n'
    "# TYPE oryx_summary_seconds summary\n"
    "oryx_summary_seconds_sum 4.5\n"
    "oryx_summary_seconds_count 9\n"
)
_HISTORY = {"enabled": True, "signals": {
    "request_rate": {"unit": "req/s", "points": [[100.0, 2.0], [105.0, 7.0],
                                                 [110.0, 3.0]]},
    "freshness_sec": {"unit": "sec", "points": [[100.0, -1.0], [110.0, 30.0]]},
}, "trend_alerts": []}


def _snapshot(mod, texts, history=None):
    scrapes = []
    for i, text in enumerate(texts):
        r = mod.ReplicaScrape(f"http://h{i}:{8000 + i}")
        if text is None:
            r.error = "URLError: refused"
        else:
            r.up = True
            r.types = mod.parse_types(text)
            r.histograms, r.scalars = mod.parse_metrics_text(text)
            r.readyz = {"status": "ok", "warmup": {"done": i, "total": 2}}
            r.ready = True
            r.history = history if i == 0 else None
        scrapes.append(r)
    snap = mod.FleetSnapshot(scrapes)
    snap.time = 1000.0
    return snap


def test_merge_render_and_table_equal_the_reference():
    base = _FED["T_BASE"]
    texts = [base + _LINEAGE, base.replace('le="0.1"', 'le="0.25"'), None,
             base.replace("} 10", "} 40")]
    for history in (None, _HISTORY):
        ours, theirs = _snapshot(fed, texts, history), _snapshot(ref_fed, texts, history)
        assert fed.render_prom(ours) == ref_fed.render_prom(theirs)
        rows, ref_rows = fed.table_rows(ours), ref_fed.table_rows(theirs)
        assert rows == ref_rows
        assert fed.render_table(rows) == ref_fed.render_table(ref_rows)
        later = [t if t is None else t.replace("} 12", "} 52") for t in texts]
        ours2, theirs2 = _snapshot(fed, later, history), _snapshot(ref_fed, later, history)
        ours2.time = theirs2.time = 1010.0
        assert fed.to_json(ours2, ours) == ref_fed.to_json(theirs2, theirs)


def test_metrics_readers_and_sparkline_equal_the_reference():
    text = _FED["T_BASE"] + _LINEAGE + 'odd{le="x"} not-a-number\nbare 7\n'
    assert trace_summary.parse_metrics_text(text) == \
        ref_trace_summary.parse_metrics_text(text)
    hists, _ = trace_summary.parse_metrics_text(text)
    rows = hists["oryx_serving_request_latency_seconds"][(("route", "/r"),)]["buckets"]
    edge_cases = [(rows, 12.0), ([(-1.0, 3.0), (1.0, 3.0)], 3.0),
                  ([(0.5, 4.0), (1.0, 2.0)], 4.0), ([], 0.0), ([(1.0, 0.0)], 5.0)]
    for bucket_rows, count in edge_cases:
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            got = trace_summary.bucket_quantile(bucket_rows, count, q)
            want = ref_trace_summary.bucket_quantile(bucket_rows, count, q)
            assert got == want or (got != got and want != want)
    for values in ([], [1.0], [3, 3, 3], [1, 5, float("nan"), 2, "x", True, 9],
                   list(range(20))):
        for width in (4, 8):
            assert textutils.sparkline(values, width) == \
                ref_textutils.sparkline(values, width)


# -- fleet-status against two port replicas ----------------------------------


def _rdf_model_text() -> str:
    conf = cfg.overlay_on({
        "oryx.input-schema.feature-names": ["a", "b", "label"],
        "oryx.input-schema.categorical-features": ["label"],
        "oryx.input-schema.target-feature": "label",
    }, cfg.get_default())
    rng = np.random.default_rng(3)
    X = rng.uniform(-5, 5, size=(200, 2))
    y = (X[:, 0] > X[:, 1]).astype(np.int64)
    trees, imp = rdftrain.forest_train(
        X, y, [False, False], [0, 0], task=rdftrain.CLASSIFICATION,
        n_classes=2, num_trees=3, max_depth=4, max_split_candidates=16,
        rng=np.random.default_rng(4), device="cpu")
    pmml = pmml_codec.forest_to_pmml(
        trees, imp, InputSchema(conf), CategoricalValueEncodings({2: ["hi", "lo"]}),
        max_depth=4, max_split_candidates=16, impurity="entropy")
    return pmmlutils.to_string(pmml)


def _get(port: int, path: str) -> int:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as resp:
            resp.read()
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code
    except OSError:
        return 0


def test_fleet_status_json_against_two_port_replicas(tmp_path):
    """Two ``python -m oryx_tpu_torch.cli serving`` processes on the CPU
    serve an RDF model from one ``file:`` update topic; after a few
    ``/predict`` (and one unmatched) requests on each, ``fleet-status
    --format json`` exits 0 with both up, and each replica's non-ops
    request total equals its own ``/metrics`` (less the console's own
    ``/metrics/history`` request)."""
    from chip_smoke import fleet_status_check, hocon

    broker = f"file:{tmp_path / 'topics'}"
    settings = {
        "oryx.id": "fleet-test",
        "oryx.input-topic.broker": broker,
        "oryx.update-topic.broker": broker,
        "oryx.input-schema.feature-names": ["a", "b", "label"],
        "oryx.input-schema.categorical-features": ["label"],
        "oryx.input-schema.target-feature": "label",
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.models.rdf.serving.RDFServingModelManager",
        "oryx.serving.application-resources":
            "oryx_tpu_torch.serving.resources.classreg",
        "oryx.default-compute-config.platform": "cpu",
    }
    conf = cfg.overlay_on(settings, cfg.get_default())
    tp.maybe_create_topics(conf, "input-topic", "update-topic")
    producer = tp.TopicProducerImpl(broker, "OryxUpdate")
    producer.send("MODEL", _rdf_model_text())
    producer.close()
    ports = [ioutils.choose_free_port() for _ in range(2)]
    procs = []
    with contextlib.ExitStack() as stack:
        for port in ports:
            path = tmp_path / f"serving-{port}.conf"
            path.write_text(hocon({**settings, "oryx.serving.api.port": port}))
            log = stack.enter_context(open(tmp_path / f"serving-{port}.log", "w"))
            proc = subprocess.Popen(
                [sys.executable, "-m", "oryx_tpu_torch.cli", "serving",
                 "--conf", str(path)], cwd=REPO, stdout=log,
                stderr=subprocess.STDOUT)
            procs.append(proc)
            stack.callback(proc.kill)
        deadline = time.monotonic() + 90
        for port, proc in zip(ports, procs):
            while _get(port, "/ready") != 200:
                assert proc.poll() is None, (tmp_path / f"serving-{port}.log").read_text()
                assert time.monotonic() < deadline, "a replica never became ready"
                time.sleep(0.1)
        for r, port in enumerate(ports):
            for _ in range(3 + r):
                assert _get(port, "/predict/4.0,-4.0,") == 200
            assert _get(port, "/nope") == 404
        out = fleet_status_check(ports, "fleet-status test")
        assert [v["requests_total"] for v in out["replicas"].values()] == [4.0, 5.0]
        assert out["fleet_requests_total"] == 9.0
