"""The word-count example app and the traffic generator on the port.

* The nine cases of ``tests/test_example_cli.py``: eight run the reference
  test file's own bodies through :func:`_mirror`, rebound to the port's
  example classes, CLI, config, broker and layers; the HTTP loop
  (``test_wordcount_end_to_end``) is restated with the port's class names
  set by override and both layers on the CPU.
* ``tests/test_cli_processes.py::test_cli_multiprocess_wordcount`` on
  ``python -m oryx_tpu_torch.cli`` (``oryx.default-compute-config.platform
  = "cpu"``).
* ``tests/test_aux.py::test_traffic_runner_smoke`` on the port's
  ``ServingLayer`` and ``TrafficRunner``, and the runner's transport: a
  refused connection counts as an exception, a replica closing its
  keep-alive connections costs none.
* Parity: the example and the reference give equal counts, equal published
  ``MODEL`` JSON, equal speed ``UP`` strings and equal served maps on the
  same lines.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import httpx
import numpy as np
import pytest

from oryx_tpu.api.keymessage import KeyMessage as RefKeyMessage
from oryx_tpu.common import config as ref_cfg
from oryx_tpu.example import wordcount as ref_wordcount
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.cli.main import main as cli_main
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.example import wordcount
from oryx_tpu_torch.lambda_rt.batch import BatchLayer
from oryx_tpu_torch.serving.app import ServingLayer
from oryx_tpu_torch.tools import traffic
from oryx_tpu_torch.transport import topic as tp
from test_torch_observability import _mirror

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "oryx_tpu_torch.cli"]
#: the port's classes for the example, set by override
EXAMPLE = {
    "oryx.batch.update-class": "oryx_tpu_torch.example.wordcount.ExampleBatchLayerUpdate",
    "oryx.speed.model-manager-class":
        "oryx_tpu_torch.example.wordcount.ExampleSpeedModelManager",
    "oryx.serving.model-manager-class":
        "oryx_tpu_torch.example.wordcount.ExampleServingModelManager",
    "oryx.serving.application-resources": "oryx_tpu_torch.example.resources",
}


@pytest.fixture(autouse=True)
def _fresh_brokers():
    tp.reset_memory_brokers()
    yield
    tp.reset_memory_brokers()


_REF = _mirror("test_example_cli.py", {
    "KeyMessage": KeyMessage, "cli_main": cli_main, "cfg": cfg,
    "ioutils": ioutils, "tp": tp, "BatchLayer": BatchLayer,
    "ServingLayer": ServingLayer,
    "ExampleBatchLayerUpdate": wordcount.ExampleBatchLayerUpdate,
    "ExampleServingModelManager": wordcount.ExampleServingModelManager,
    "ExampleSpeedModelManager": wordcount.ExampleSpeedModelManager,
    "count_distinct_other_words": wordcount.count_distinct_other_words,
})
for _name in (
    "test_count_distinct_other_words",
    "test_batch_update_publishes_model",
    "test_speed_manager_approximate_counts",
    "test_serving_manager_merges_model_and_ups",
    "test_cli_topic_setup_and_input",
    "test_cli_rejects_unknown_command",
    "test_example_confs_parse",
    "test_serving_manager_word_with_comma",
):
    globals()[_name] = _REF[_name]


def _wait(cond, timeout: float, what: str, poll: float = 0.1) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"{what} after {timeout} s")
        time.sleep(poll)


def test_wordcount_end_to_end(tmp_path):
    """The reference's HTTP loop on the port: a line POSTed to ``/add``
    reaches the input topic, the batch layer counts it, and ``/distinct``
    serves the published map (past data kept under ``tmp_path``)."""
    port = ioutils.choose_free_port()
    config = cfg.overlay_on(
        {**EXAMPLE, "oryx.serving.api.port": port,
         "oryx.default-compute-config.platform": "cpu",
         "oryx.batch.storage.data-dir": f"{tmp_path}/data/",
         "oryx.batch.storage.model-dir": f"{tmp_path}/model/"},
        cfg.get_default(),
    )
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    batch = BatchLayer(config)
    batch.start(interval_sec=0.5)
    serving = ServingLayer(config, device="cpu")
    serving.start()
    client = httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=30)
    try:
        assert client.post("/add/a b c").status_code == 204
        _wait(lambda: client.get("/ready").status_code == 200, 30, "never ready")
        _wait(lambda: client.get("/distinct").json().get("a") == 2, 30,
              "the batch never counted the line")
        assert client.get("/distinct").json() == {"a": 2, "b": 2, "c": 2}
        assert client.get("/distinct/a").text.strip() == "2"
        assert client.get("/distinct/zzz").status_code == 400
        assert client.post("/add", content="d e\n\nf").status_code == 204
        _wait(lambda: client.get("/distinct").json().get("f") == 0, 30,
              "the body's lines never counted")
        assert client.get("/distinct").json() == {
            "a": 2, "b": 2, "c": 2, "d": 1, "e": 1, "f": 0}
    finally:
        client.close()
        serving.close()
        batch.close()


def test_cli_multiprocess_wordcount(tmp_path):
    """``tests/test_cli_processes.py``'s case: batch and serving as CLI
    processes of the port over a ``file:`` broker, driven over HTTP."""
    port = ioutils.choose_free_port()
    conf = tmp_path / "app.conf"
    conf.write_text(f"""
oryx {{
  id = "cli-it"
  input-topic.broker = "file://{tmp_path}/topics"
  update-topic.broker = "file://{tmp_path}/topics"
  default-compute-config.platform = "cpu"
  batch {{
    streaming.generation-interval-sec = 1
    update-class = "{EXAMPLE['oryx.batch.update-class']}"
    storage {{
      data-dir = "{tmp_path}/data/"
      model-dir = "{tmp_path}/model/"
    }}
  }}
  serving {{
    api.port = {port}
    model-manager-class = "{EXAMPLE['oryx.serving.model-manager-class']}"
    application-resources = "{EXAMPLE['oryx.serving.application-resources']}"
  }}
}}
""")
    procs = []

    def spawn(cmd):
        p = subprocess.Popen([*CLI, cmd, "--conf", str(conf)], cwd=REPO,
                             stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
        procs.append(p)
        return p

    try:
        subprocess.run([*CLI, "topic-setup", "--conf", str(conf)], cwd=REPO,
                       check=True, capture_output=True, timeout=60)
        spawn("batch")
        spawn("serving")
        with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=30) as client:
            deadline = time.monotonic() + 60
            while True:
                try:
                    client.get("/ready")
                    break
                except httpx.TransportError:
                    assert all(p.poll() is None for p in procs), "a process exited"
                    if time.monotonic() > deadline:
                        pytest.fail("serving process never opened its port")
                    time.sleep(0.25)
            assert client.post("/add/a b c").status_code == 204
            _wait(lambda: client.get("/ready").status_code == 200
                  and client.get("/distinct").json().get("a") == 2, 60,
                  "model never flowed batch -> update topic -> serving", 0.25)
            assert client.get("/distinct").json() == {"a": 2, "b": 2, "c": 2}
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            assert p.wait(timeout=20) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def _start_wordcount_layer():
    port = ioutils.choose_free_port()
    config = cfg.overlay_on({**EXAMPLE, "oryx.serving.api.port": port},
                            cfg.get_default())
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    layer = ServingLayer(config, device="cpu")
    layer.start()
    return layer, port


def test_traffic_runner_smoke():
    """``tests/test_aux.py``'s case: the generator drives HTTP load at the
    port's layer and aggregates outcomes (the word-count app serves no ALS
    path: every request is some outcome)."""
    layer, port = _start_wordcount_layer()
    runner = traffic.TrafficRunner(
        [f"127.0.0.1:{port}"], traffic.build_als_endpoints(10, 10),
        interval_ms=0, threads=2, duration_sec=1.0,
    )
    t = threading.Thread(target=runner.run, daemon=True)
    t.start()
    time.sleep(1.2)
    runner.stop()
    t.join(timeout=10)
    layer.close()
    assert runner.requests > 0
    assert runner.client_errors + runner.server_errors + runner.exceptions <= runner.requests
    # no model: 503s from the read routes, 404s from the ALS paths
    assert runner.server_errors + runner.client_errors == runner.requests
    assert runner.exceptions == 0


def test_traffic_runner_counts_refused_connections_and_survives_closes():
    """A host nothing listens on: every request an exception, none a
    response. A layer that closes a worker's idle keep-alive connection:
    the next request reconnects without an exception."""
    dead = f"127.0.0.1:{ioutils.choose_free_port()}"
    runner = traffic.TrafficRunner(
        [dead], [traffic._Endpoint("x", 1.0, lambda rng: ("GET", "/", None))],
        interval_ms=0, threads=1, duration_sec=0.3)
    runner.run()
    assert runner.exceptions > 0 and runner.requests == 0

    layer, port = _start_wordcount_layer()
    try:
        conns: dict = {}
        host = f"127.0.0.1:{port}"
        assert traffic._request(conns, host, "GET", "/distinct", None) == 503
        first = conns[host]
        first.sock.shutdown(0)  # as a server closing an idle connection
        assert traffic._closed_by_peer(first)
        assert traffic._request(conns, host, "POST", "/add/x y", "") == 204
        assert conns[host] is not first
        assert traffic._request(conns, host, "GET", "/distinct", None) == 503
        for c in conns.values():
            c.close()
    finally:
        layer.close()


def test_traffic_main_parses_its_flags(monkeypatch):
    seen = {}

    class _Runner:
        def __init__(self, hosts, endpoints, interval_ms, threads, duration_sec):
            seen.update(hosts=hosts, names=[e.name for e in endpoints],
                        interval_ms=interval_ms, threads=threads,
                        duration_sec=duration_sec)

        def run(self):
            seen["ran"] = True

    monkeypatch.setattr(traffic, "TrafficRunner", _Runner)
    assert traffic.main(["h1:1,h2:2", "--interval-ms", "0", "--threads", "3",
                         "--duration-sec", "2", "--users", "5"]) == 0
    assert seen == {"hosts": ["h1:1", "h2:2"],
                    "names": ["recommend", "similarity", "estimate", "pref"],
                    "interval_ms": 0.0, "threads": 3, "duration_sec": 2.0,
                    "ran": True}


def test_endpoint_mix_equals_the_reference():
    from oryx_tpu.tools import traffic as ref_traffic

    mine = traffic.build_als_endpoints(100, 50)
    theirs = ref_traffic.build_als_endpoints(100, 50)
    assert [(e.name, e.relative_prob) for e in mine] == [
        (e.name, e.relative_prob) for e in theirs]
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(20):
        for e, r in zip(mine, theirs):
            assert e.make_request(a) == r.make_request(b)


# -- parity with the reference's example --------------------------------------


def _lines(rng, n: int) -> list:
    words = [f"w{i}" for i in range(30)] + ["a,b", "x"]
    return [" ".join(rng.choice(words, size=rng.integers(1, 6))) for _ in range(n)]


class _Producer:
    def __init__(self):
        self.sent = []

    def send(self, key, message):
        self.sent.append((key, message))


def test_counts_models_updates_and_served_maps_equal_the_reference():
    rng = np.random.default_rng(11)
    new, past, micro = _lines(rng, 60), _lines(rng, 40), _lines(rng, 25)
    assert (wordcount.count_distinct_other_words(new + past)
            == ref_wordcount.count_distinct_other_words(new + past))
    sent = []
    for mod, km in ((wordcount, KeyMessage), (ref_wordcount, RefKeyMessage)):
        producer = _Producer()
        mod.ExampleBatchLayerUpdate().run_update(
            None, 0, [km(None, ln) for ln in new], [km(None, ln) for ln in past],
            None, producer)
        sent.append(producer.sent)
    assert sent[0] == sent[1] and sent[0][0][0] == "MODEL"
    model = sent[0][0][1]
    ups = []
    for mod, km in ((wordcount, KeyMessage), (ref_wordcount, RefKeyMessage)):
        speed = mod.ExampleSpeedModelManager()
        speed.consume_key_message("MODEL", model)
        ups.append(list(speed.build_updates([km(None, ln) for ln in micro])))
    assert ups[0] == ups[1] and ups[0]
    served = []
    for mod, c in ((wordcount, cfg), (ref_wordcount, ref_cfg)):
        manager = mod.ExampleServingModelManager(c.get_default())
        manager.consume_key_message("MODEL", model)
        for up in ups[0]:
            manager.consume_key_message("UP", up)
        served.append(manager.get_model().get_words())
    assert served[0] == served[1] and served[0]["a,b"] == served[1]["a,b"]
