"""The port's ``tools/trace_summary``, held to the reference's tool.

* Parity: every view's standard output (and exit code) equals the
  reference's, byte for byte, on the same input: a metrics dump (a fixed
  one and the port's live registry), a ``GET /trace`` body (one trace, and
  a whole dump with the slowest-by-route reservoir), a ``/metrics/history``
  body in its three shapes, ``bench_batch`` records, the committed
  ``BENCH_r0*.json`` rounds and the reference's history fixtures, and a
  ``jax.profiler`` trace in the reference's layout (default tracks and a
  ``--track`` filter).
* Mirrors: ``tests/test_bench_history_gate.py`` through :func:`_mirror`;
  ``tests/test_metrics.py::test_trace_summary_reads_metrics_dump_and_url``
  and ``tests/test_spans.py::test_trace_summary_span_tree_mode`` restated
  on the port's modules (their bodies import the reference's tool inside
  the function); ``tests/test_aux.py::test_trace_summary_finds_device_ops``
  restated as a ``torch.profiler`` capture on the CPU read with ``--track``
  at the host thread.
* The trace mode on Kineto's layout: a synthetic trace with two CUDA
  streams, nested and overlapping ``gpu_user_annotation`` spans, kernels,
  a copy and a set: kernel self times and counts as computed by hand, the
  annotations only in the windows section; the CLI as a process.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import subprocess
import sys
import threading
import time

import httpx
import numpy as np
import pytest
import torch

from oryx_tpu.tools import trace_summary as ref_ts
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import spans
from oryx_tpu_torch.tools import trace_summary as ts
from oryx_tpu_torch.transport import topic as tp
from test_torch_observability import _mirror

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def _both(argv: list, capsys) -> tuple:
    """``main(argv)`` of the reference, then of the port: the same exit code
    and the same standard output (and standard error, but for the usage
    text). Returns the port's (exit code, output)."""
    rc_ref = ref_ts.main(list(argv))
    ref = capsys.readouterr()
    rc = ts.main(list(argv))
    got = capsys.readouterr()
    assert rc == rc_ref, (argv, rc, rc_ref)
    assert got.out == ref.out, argv
    if rc != 2:
        assert got.err == ref.err, argv
    return rc, got.out


def _write(path, payload) -> str:
    path.write_text(payload if isinstance(payload, str) else json.dumps(payload))
    return str(path)


# -- parity: metrics dumps ---------------------------------------------------

_DUMP = """# HELP oryx_serving_request_latency_seconds Request latency.
# TYPE oryx_serving_request_latency_seconds histogram
oryx_serving_request_latency_seconds_bucket{route="/recommend/{userID}",le="0.005"} 3
oryx_serving_request_latency_seconds_bucket{route="/recommend/{userID}",le="0.01"} 9
oryx_serving_request_latency_seconds_bucket{route="/recommend/{userID}",le="0.1"} 12
oryx_serving_request_latency_seconds_bucket{route="/recommend/{userID}",le="+Inf"} 13
oryx_serving_request_latency_seconds_sum{route="/recommend/{userID}"} 0.4125
oryx_serving_request_latency_seconds_count{route="/recommend/{userID}"} 13
oryx_step_duration_seconds_bucket{step="generation",le="1"} 0
oryx_step_duration_seconds_bucket{step="generation",le="10"} 2
oryx_step_duration_seconds_bucket{step="generation",le="+Inf"} 2
oryx_step_duration_seconds_sum{step="generation"} 7.5
oryx_step_duration_seconds_count{step="generation"} 2
rpc_seconds_sum 4.0
rpc_seconds_count 8
# TYPE oryx_serving_requests_total counter
oryx_serving_requests_total{route="/recommend/{userID}",status="200"} 13
oryx_serving_requests_total{route="/pref/{userID}/{itemID}",status="400"} 2
oryx_device_mfu 0.01234
oryx_device_hbm_bandwidth_fraction 0.4567
oryx_device_flops_per_second 8.9e11
oryx_device_bytes_per_second 1.53e12
oryx_device_memory_bytes_in_use{device="cuda:0"} 123456789
oryx_device_memory_peak_bytes{device="cuda:0"} 223456789
oryx_host_rss_bytes 987654321
oryx_device_calls_total{program="als.top_n_batch/b256"} 4000
garbage line that does not parse
oryx_bad_value{a="b"} notanumber
"""


@pytest.mark.parametrize("flags", [[], ["--metrics"], ["--top", "3"]])
def test_metrics_dump_views_equal_the_reference(tmp_path, capsys, flags):
    dump = _write(tmp_path / "metrics.txt", _DUMP)
    rc, out = _both([dump, *flags], capsys)
    assert rc == 0
    assert "device performance" in out and "1.234% MFU" in out


def test_live_registry_dump_equals_the_reference(tmp_path, capsys):
    """The live registry holds whatever the tests before this one in the
    same process recorded: ask for a ``--top`` that lists every series of
    the dump, so the counter shows whatever else is there."""
    reg = metrics_mod.default_registry()
    reg.counter("oryx_trace_summary_test_total", "a test counter").inc(3)
    text = reg.render()
    series = sum(1 for ln in text.splitlines() if ln and not ln.startswith("#"))
    dump = _write(tmp_path / "live.prom", text)
    rc, out = _both([dump, "--top", str(series)], capsys)
    assert rc == 0 and "oryx_trace_summary_test_total" in out


# -- parity: span trees ------------------------------------------------------


def _span_payloads() -> tuple:
    """A ``GET /trace?trace_id=`` body and a whole ``GET /trace`` body of
    spans recorded by the port's recorder."""
    rec = spans.default_recorder()
    rec.reset()
    with spans.span("http GET /recommend/{userID}",
                    attributes={"route": "/recommend/{userID}", "status": 200}):
        with spans.span("coalescer.queue_wait",
                        attributes={"queue_wait_ms": 1.25, "other": "x"}):
            pass
        with spans.span("coalescer.device_call",
                        attributes={"batch.size": 3, "batch.padded": 4,
                                    "pad.waste_rows": 1}) as call:
            call.status = "error"
    root = next(s for s in rec.spans() if s.name.startswith("http"))
    orphan = spans.SpanContext(root.trace_id, spans.new_span_id())
    with spans.span("late child", parent=orphan, attributes={"items": 7}):
        pass
    other = spans.SpanContext(spans.new_trace_id(), spans.new_span_id())
    with spans.span("speed.apply", parent=None, links=(other,),
                    attributes={"key": "UP"}):
        pass
    one = {"trace_id": root.trace_id,
           "spans": [s.to_dict() for s in rec.spans(trace_id=root.trace_id)]}
    whole = {"recent": [s.to_dict() for s in rec.spans()],
             "slowest_by_route": {r: [s.to_dict() for s in slow]
                                  for r, slow in sorted(rec.slowest().items())}}
    return root.trace_id, one, whole


def test_span_tree_views_equal_the_reference(tmp_path, capsys):
    tid, one, whole = _span_payloads()
    for name, payload in (("one.json", one), ("whole.json", whole)):
        path = _write(tmp_path / name, payload)
        rc, out = _both([path, "--trace-id", tid], capsys)
        assert rc == 0 and "late child" in out and "!error" in out
        rc, out = _both([path, "--trace-id", "f" * 32], capsys)
        assert rc == 1 and "no spans buffered" in out


# -- parity: series, batch records, history ----------------------------------

_SIGNALS = {
    "request_rate": {"unit": "req/s", "points": [[1.0, 10.0], [2.0, 12.5], [3.0, 9.0]]},
    "mfu": {"unit": "ratio", "points": [[1.0, 0.01], [2.0, "bad"], [3.0, 0.02]]},
    "empty": {"unit": "B", "points": []},
    "odd": "not a dict",
}
_ALERTS = [{"rule": "queue_depth_ramp", "signal": "queue_depth", "current": 12,
            "limit": 64, "eta_sec": 30.5}, "not a dict"]


@pytest.mark.parametrize("shape", ["body", "bundle", "bare", "empty"])
def test_series_view_equals_the_reference(tmp_path, capsys, shape):
    payload = {
        "body": {"signals": _SIGNALS, "trend_alerts": _ALERTS},
        "bundle": {"history": {"signals": _SIGNALS, "trend_alerts": _ALERTS}},
        "bare": {k: v for k, v in _SIGNALS.items() if isinstance(v, dict)},
        "empty": {"nothing": 1},
    }[shape]
    rc, out = _both([_write(tmp_path / "h.json", payload), "--series"], capsys)
    assert rc == (2 if shape == "empty" else 0)


def _bench_parsed(n: int) -> dict:
    with open(os.path.join(REPO, f"BENCH_r0{n}.json")) as f:
        return json.load(f)["parsed"]


def test_batch_view_equals_the_reference(tmp_path, capsys):
    full = {
        "metric": "als batch train", "backend": "gpu", "device_kind": "H100",
        "value": 1.5e7, "mfu": 0.05, "useful_tflops_per_s": 3.2,
        "fused_gramian": True, "unit": "ratings/s",
        "unfused_f32": {"value": 9e6, "mfu": 0.03},
        "bf16": {"value": 2e7}, "fused_speedup": 1.7,
        "phase_split": {"gather_s": 1.0, "einsum_s": 2.0, "scatter_s": 0.5,
                        "solve_s": 0.25},
        "kernels": [{"kernel": "gather_gramian", "grid": "(8, 4)",
                     "vmem_bytes": 65536, "hbm_bytes_per_step": 4096},
                    {"kernel": "spd_solve", "vmem_expr": "k*k*4"},
                    {"not": "a kernel"}],
        "train_e2e": {"gen1": {"elapsed_s": 10.0, "pack_s": 2.0,
                               "pack_lt_elapsed": True,
                               "pack_modes": {"user": "cached"}}},
    }
    for name, payload in (("full.json", full), ("wrapped.json", {"batch": full}),
                          ("r06.json", _bench_parsed(6)["batch"]),
                          ("r01.json", _bench_parsed(1))):
        rc, out = _both([_write(tmp_path / name, payload), "--batch"], capsys)
        assert rc == 0


def test_history_views_equal_the_reference(tmp_path, capsys):
    rounds = sorted(glob.glob(os.path.join(REPO, "BENCH_r0*.json")))
    fixtures = sorted(glob.glob(os.path.join(DATA, "BENCH_hist_*.json")))
    broken = _write(tmp_path / "BENCH_broken_9.json", "{not json")
    for argv in (["--history", *rounds],
                 ["--history", os.path.join(REPO, "BENCH_r0*.json"),
                  "--regress-pct", "25"],
                 ["--history", *fixtures],
                 ["--history", *fixtures, "--regress-pct", "150"],
                 ["--history", *fixtures[:2], broken, "--regress-pct", "0"],
                 ["--history", "--bogus", *rounds],
                 ["--history"]):
        _both(argv, capsys)
    rc, out = _both(["--history", *rounds, "--regress-pct", "25"], capsys)
    assert rc == 0 and "no regression" in out


# -- parity: a trace in the reference's layout ------------------------------


@pytest.fixture(scope="module")
def jax_trace_dir(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    path = tmp_path_factory.mktemp("jax-trace")
    with jax.profiler.trace(str(path)):
        x = jnp.ones((256, 256))
        (x @ x).block_until_ready()
    return str(path)


def test_trace_mode_on_the_reference_layout_equals_the_reference(jax_trace_dir, capsys):
    (trace,) = glob.glob(os.path.join(jax_trace_dir, "**", "*.trace.json.gz"),
                         recursive=True)
    assert ts.find_trace_file(jax_trace_dir) == ref_ts.find_trace_file(jax_trace_dir)
    assert ts.summarize(jax_trace_dir, 30) == ref_ts.summarize(jax_trace_dir, 30)
    for argv in ([jax_trace_dir], [trace, "--top", "30"],
                 [jax_trace_dir, "--track", "python"]):
        rc, out = _both(argv, capsys)
        assert rc == 0 and "windows" not in out


# -- mirrors -----------------------------------------------------------------

_GATE = _mirror("test_bench_history_gate.py", {"ts": ts})
test_committed_bench_history_has_no_regression = _GATE[
    "test_committed_bench_history_has_no_regression"]


def test_trace_summary_span_tree_mode(tmp_path, capsys):
    """``tests/test_spans.py``'s case on the port's recorder and tool."""
    spans.default_recorder().reset()
    with spans.span("http GET /recommend/{userID}",
                    attributes={"route": "/recommend/{userID}"}):
        with spans.span("coalescer.queue_wait",
                        attributes={"queue_wait_ms": 1.5}):
            pass
        with spans.span("coalescer.device_call",
                        attributes={"batch.size": 3, "batch.padded": 4,
                                    "pad.waste_rows": 1}):
            pass
    rec = spans.default_recorder()
    root = [s for s in rec.spans() if s.name.startswith("http")][0]
    payload = {
        "trace_id": root.trace_id,
        "spans": [s.to_dict() for s in rec.spans(trace_id=root.trace_id)],
    }
    dump = tmp_path / "trace.json"
    dump.write_text(json.dumps(payload))
    assert ts.main([str(dump), "--trace-id", root.trace_id]) == 0
    out = capsys.readouterr().out
    assert "http GET /recommend/{userID}" in out
    assert "coalescer.queue_wait" in out and "coalescer.device_call" in out
    assert "batch.size=3" in out and "pad.waste_rows=1" in out
    lines = out.splitlines()
    root_line = next(i for i, l in enumerate(lines) if "http GET" in l)
    child_line = next(i for i, l in enumerate(lines) if "queue_wait" in l)
    assert child_line > root_line
    assert ts.main([str(dump), "--trace-id", "f" * 32]) == 1


def test_trace_summary_reads_metrics_dump_and_url(tmp_path, capsys):
    """``tests/test_metrics.py``'s case against a live port layer (the
    word-count app on the CPU): the URL mode straight off its registry,
    then a saved dump sniffed without ``--metrics``; beside it, the
    ``--trace-id`` mode fetched from the same layer's ``/trace``."""
    from oryx_tpu_torch.serving.app import ServingLayer

    tp.reset_memory_brokers()
    port = ioutils.choose_free_port()
    config = cfg.overlay_on({
        "oryx.serving.api.port": port,
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.example.wordcount.ExampleServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu_torch.example.resources",
    }, cfg.get_default())
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    tp.TopicProducerImpl("memory:", "OryxUpdate").send("MODEL", json.dumps({"a": 1}))
    layer = ServingLayer(config, device="cpu")
    layer.start()
    base = f"http://127.0.0.1:{port}"
    try:
        with httpx.Client(base_url=base, timeout=30) as client:
            deadline = time.monotonic() + 30
            while client.get("/ready").status_code != 200:
                assert time.monotonic() < deadline, "never ready"
                time.sleep(0.05)
            tid = spans.new_trace_id()
            r = client.get("/distinct/a", headers={
                "traceparent": f"00-{tid}-{spans.new_span_id()}-01"})
            assert r.status_code == 200
            capsys.readouterr()
            assert ts.main([f"{base}/metrics", "--top", "5"]) == 0
            out = capsys.readouterr().out
            assert "oryx_serving_request_latency_seconds" in out
            assert "histograms" in out
            dump = tmp_path / "metrics.txt"
            dump.write_text(client.get("/metrics").text)
            assert ts.main([str(dump)]) == 0
            out = capsys.readouterr().out
            assert "oryx_step_duration_seconds" in out or "oryx_serving" in out
            assert ts.main([base, "--trace-id", tid]) == 0
            out = capsys.readouterr().out
            assert f"trace {tid}" in out and "http GET /distinct/{word}" in out
    finally:
        layer.close()
        tp.reset_memory_brokers()


def test_trace_summary_finds_host_ops_of_a_torch_profiler_capture(tmp_path, capsys):
    """``tests/test_aux.py::test_trace_summary_finds_device_ops`` on the
    port: a ``torch.profiler`` capture on the CPU (no device track, so the
    default view lists no ops) read with ``--track`` at the host thread."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x = torch.ones((256, 256))
        (x @ x).sum()
    prof.export_chrome_trace(str(tmp_path / "cap.pt.trace.json"))
    host = f"thread {threading.get_native_id()}"
    track_rows, op_rows = ts.summarize(str(tmp_path), top=30, track_filter=host)
    assert track_rows, "no tracks parsed"
    names = " ".join(n for n, _, _ in op_rows)
    assert "aten::mm" in names, names
    assert ts.summarize(str(tmp_path), top=30)[1] == []
    assert ts.main([str(tmp_path), "--track", host]) == 0
    assert "aten::mm" in capsys.readouterr().out


# -- the trace mode on Kineto's layout ---------------------------------------

GPU, CPU = 0, 4242


def _meta(name: str, pid: int, tid: int, value: str) -> dict:
    key = "labels" if name == "process_labels" else "name"
    return {"ph": "M", "name": name, "pid": pid, "tid": tid, "ts": 0,
            "args": {key: value}}


def _x(cat: str, name: str, pid: int, tid: int, ts_us: float, dur_us: float) -> dict:
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts_us, "dur": dur_us, "args": {}}


def _kineto_trace() -> dict:
    """Two streams; on stream 7 an annotation that starts after one kernel
    began and ends before another ends, a nested annotation inside a kernel,
    and an annotation on stream 13 overlapping a set; host ops and runtime
    calls on the CPU thread."""
    return {"schemaVersion": 1, "traceEvents": [
        _meta("process_name", GPU, 0, "python 4242"),
        _meta("process_labels", GPU, 0, "GPU 0"),
        _meta("thread_name", GPU, 7, "stream 7 "),
        _meta("thread_name", GPU, 13, "stream 13 "),
        _meta("process_name", CPU, 0, "python"),
        _meta("thread_name", CPU, CPU, "thread 4242 (python)"),
        _x("user_annotation", "chip_smoke.window:0", CPU, CPU, 0.0, 100.0),
        _x("cpu_op", "aten::mm", CPU, CPU, 10.0, 20.0),
        _x("cuda_runtime", "cudaLaunchKernel", CPU, CPU, 12.0, 5.0),
        _x("gpu_user_annotation", "chip_smoke.window:0", GPU, 7, 5.0, 60.0),
        _x("gpu_user_annotation", "inner", GPU, 7, 20.0, 10.0),
        _x("kernel", "void gemm_a<float>(float const*)", GPU, 7, 0.0, 10.0),
        _x("kernel", "void gemm_a<float>(float const*)", GPU, 7, 15.0, 20.5),
        _x("kernel", "reduce_b", GPU, 7, 50.0, 25.0),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", GPU, 7, 80.0, 4.0),
        _x("kernel", "void gemm_a<float>(float const*)", GPU, 13, 3.0, 7.0),
        _x("gpu_memset", "Memset (Device)", GPU, 13, 40.0, 2.0),
        _x("gpu_user_annotation", "chip_smoke.window:1", GPU, 13, 30.0, 30.0),
        {"ph": "s", "id": 1, "pid": CPU, "tid": CPU, "ts": 12.0, "cat": "ac2g",
         "name": "ac2g"},
        {"ph": "i", "s": "t", "pid": CPU, "tid": CPU, "ts": 1.0, "name": "mark"},
    ]}


def test_kineto_layout_kernel_self_times_by_hand(tmp_path, capsys):
    path = tmp_path / "x.pt.trace.json"
    path.write_text(json.dumps(_kineto_trace()))
    windows: list = []
    track_rows, op_rows = ts.summarize(str(tmp_path), top=15, windows=windows)
    got = {n: (pytest.approx(ms, abs=1e-12), c) for n, ms, c in op_rows}
    assert {n: (ms, c) for n, ms, c in op_rows} == {
        "void gemm_a<float>(float const*)": got["void gemm_a<float>(float const*)"],
        "reduce_b": got["reduce_b"],
        "Memcpy HtoD (Pageable -> Device)": got["Memcpy HtoD (Pageable -> Device)"],
        "Memset (Device)": got["Memset (Device)"]}
    by_hand = {"void gemm_a<float>(float const*)": ((10.0 + 20.5 + 7.0) / 1e3, 3),
               "reduce_b": (25.0 / 1e3, 1),
               "Memcpy HtoD (Pageable -> Device)": (4.0 / 1e3, 1),
               "Memset (Device)": (2.0 / 1e3, 1)}
    assert [(n, c) for n, _, c in op_rows] == sorted(
        ((n, c) for n, (_, c) in by_hand.items()), key=lambda t: -by_hand[t[0]][0])
    for n, ms, c in op_rows:
        assert ms == pytest.approx(by_hand[n][0], rel=1e-12) and c == by_hand[n][1]
    assert windows == [("chip_smoke.window:0", pytest.approx(0.060), 1),
                       ("chip_smoke.window:1", pytest.approx(0.030), 1),
                       ("inner", pytest.approx(0.010), 1)]
    tracks = dict(track_rows)
    assert tracks["python 4242 / stream 7 "] == pytest.approx(0.0595)
    assert tracks["python 4242 / stream 13 "] == pytest.approx(0.009)
    assert tracks["python / thread 4242 (python)"] == pytest.approx(0.125)
    # the reference's stack takes the annotations for parents: it buries
    # kernel time under them
    ref_rows = {n: ms for n, ms, _ in ref_ts.summarize(str(path), 15)[1]}
    assert ref_rows["void gemm_a<float>(float const*)"] < by_hand[
        "void gemm_a<float>(float const*)"][0]
    # --track at the host thread: its ops nest as in the reference
    _, host_rows = ts.summarize(str(tmp_path), track_filter="thread 4242")
    assert {n: c for n, _, c in host_rows} == {
        "chip_smoke.window:0": 1, "aten::mm": 1, "cudaLaunchKernel": 1}
    assert dict((n, ms) for n, ms, _ in host_rows)["aten::mm"] == pytest.approx(0.015)

    assert ts.main([str(tmp_path), "--top", "2"]) == 0
    out = capsys.readouterr().out
    ops = out.split("top 2 ops")[1].split("windows")[0]
    assert "gemm_a" in ops and "reduce_b" in ops and "window" not in ops
    assert "windows (gpu_user_annotation spans: total ms, count):" in out
    assert "chip_smoke.window:0" in out.split("windows (")[1]


def test_find_trace_file_takes_either_layout(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    old = tmp_path / "a" / "host.trace.json.gz"
    with gzip.open(old, "wt") as f:
        json.dump({"traceEvents": []}, f)
    new = tmp_path / "b" / "oryx-1-2.pt.trace.json"
    new.write_text(json.dumps(_kineto_trace()))
    assert ts.find_trace_file(str(tmp_path)) == str(new)
    assert ts.find_trace_file(str(tmp_path / "a")) == str(old)
    assert ts.find_trace_file(str(new)) == str(new)
    with pytest.raises(FileNotFoundError, match="trace.json"):
        ts.find_trace_file(str(tmp_path / "a" / "..") + "/nothing-here")


def test_cli_as_a_process(tmp_path):
    (tmp_path / "x.pt.trace.json").write_text(json.dumps(_kineto_trace()))
    cmd = [sys.executable, "-m", "oryx_tpu_torch.tools.trace_summary"]
    proc = subprocess.run([*cmd, str(tmp_path), "--top", "20"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "reduce_b" in proc.stdout and "windows" in proc.stdout
    proc = subprocess.run([*cmd, str(tmp_path), "--top"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "oryx_tpu_torch.tools.trace_summary" in proc.stderr
    np.testing.assert_equal(proc.stdout, "")


# -- chip_smoke's read-back of the profiled session, on a synthetic trace -------

_OWN = {
    "void (anonymous namespace)::gather_gramian_kernel<float>(float const*, int)": (4, 10.0),
    "void (anonymous namespace)::gather_gramian_reduce(float const*, int)": (1, 1.5),
    "void (anonymous namespace)::spd_solve_warp_kernel<16>(float const*, int)": (4, 6.0),
    "void (anonymous namespace)::assign_kernel<true>(float const*, int)": (2, 30.0),
    "void (anonymous namespace)::partial_kernel<true>(float const*, int)": (2, 3.0),
    "void (anonymous namespace)::reduce_kernel(float const*, int)": (2, 0.5),
    "void at::native::reduce_kernel<512, 1>(float*)": (3, 2.0),
}


def _smoke_export(tmp_path) -> dict:
    """A Kineto-layout trace holding the hand-written kernels (and a
    PyTorch reduction of a like name) under three smoke windows, with the
    profiler's sums and the wrappers' launches ``device_profiles`` would
    report for it."""
    events = [_meta("process_name", GPU, 0, "python 4242"),
              _meta("thread_name", GPU, 7, "stream 7 ")]
    t = 0.0
    for w in range(3):
        events.append(_x("gpu_user_annotation", f"chip_smoke.window:{w}", GPU, 7,
                         t, 1000.0))
        t += 1000.0
    t = 1.0
    for name, (count, us) in _OWN.items():
        for _ in range(count):
            events.append(_x("kernel", name, GPU, 7, t, us))
            t += us + 1.0
    path = tmp_path / "smoke.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return {"dir": str(tmp_path), "trace": str(path), "export_s": 0.25,
            "bytes": path.stat().st_size,
            "device_events": {n: [c, c * us] for n, (c, us) in _OWN.items()},
            "launches": {"gather_gramian_accumulate": 4,
                         "gather_gramian_accumulate.reduce": 1,
                         "spd_solve_batched": 4, "kmeans_assign_accumulate": 2}}


def test_smoke_tools_trace_on_a_synthetic_session(tmp_path):
    """``chip_smoke.tools_trace`` on a trace in the session's layout: the
    kernels' rows against the profiler's sums and the launches, the
    windows kept out of the op rows, the CLI's top rows equal to the
    in-process ones. A count, a self time 2% off, or a launch more fails
    it."""
    import chip_smoke as cs

    export = _smoke_export(tmp_path)
    out = cs.tools_trace(dict(export), 3)
    assert out["kernels"]["gather_gramian_kernel"] == {
        "rows": 1, "count": 4, "self_ms": pytest.approx(0.04),
        "profiler_ms": pytest.approx(0.04), "launches": 4}
    assert out["kernels"]["reduce_kernel"]["count"] == 2
    assert set(out["windows"]) == {f"chip_smoke.window:{w}" for w in range(3)}
    assert out["op_rows"] == len(_OWN) and out["trace_bytes"] == export["bytes"]
    name = next(iter(_OWN))
    for bad in ({"device_events": {**export["device_events"], name: [5, 40.0]}},
                {"device_events": {**export["device_events"], name: [4, 40.0 * 1.02]}},
                {"launches": {**export["launches"], "kmeans_assign_accumulate": 3}}):
        with pytest.raises(cs.SmokeFailure):
            cs.tools_trace({**export, **bad}, 3)
    with pytest.raises(cs.SmokeFailure, match="windows"):
        cs.tools_trace(dict(export), 4)
