"""Multi-host serving fleet IT over the ``tcp:`` network broker, on the port.

The three cases of ``tests/test_fleet.py``, restated on the port's CLI
(their bodies name the reference's module paths): N serving replicas run
as REAL subprocesses (``python -m oryx_tpu_torch.cli serving`` with
``oryx.default-compute-config.platform = "cpu"``, the manager of
``tests/test_torch_fleet_app.py``) consuming ONE update topic from a
``python -m oryx_tpu_torch.cli broker`` server — no shared filesystem
between them and the broker state — behind the ``/readyz`` gate. Traffic
spreads across the fleet through the port's tools/traffic.py. One replica
is ``kill -9``ed MID-STREAM while generations keep flowing, then restarted
with the same ``oryx.id``: running ``update-resume = "committed"`` it must
resume from its broker-committed offset (not a full replay), recover
``/readyz`` on its own, and its durable generation ledger must read
exactly 1..N each once — zero lost, zero duplicated generations. The
other two cases: the fleet console and the SLO burn of a replica under
injected faults, and a ``kill -9`` of the broker itself. Every wait is
bounded by its own deadline, as in the reference.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import httpx
import pytest

from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.transport import topic as tp

N_REPLICAS = 3
UPDATE_TOPIC = "OryxUpdate"
GEN_INTERVAL_SEC = 0.025


def _wait_tcp(port: int, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            time.sleep(0.1)
    pytest.fail(f"nothing listening on 127.0.0.1:{port} after {timeout}s")


def _replica_conf(tmp_path, rid: str, http_port: int, broker_url: str,
                  extra: str = "") -> str:
    conf = tmp_path / f"{rid}.conf"
    conf.write_text(f"""
oryx {{
  id = "{rid}"
  default-compute-config.platform = "cpu"
  input-topic.broker = "{broker_url}"
  update-topic.broker = "{broker_url}"
  serving {{
    api.port = {http_port}
    api.read-only = true
    model-manager-class = "tests.test_torch_fleet_app.FleetServingModelManager"
    application-resources = "tests.test_torch_fleet_app"
    update-resume = "committed"
  }}
  {extra}
}}
""")
    return str(conf)


def _spawn(cmd: list, env: dict, log) -> subprocess.Popen:
    """A CLI process whose output is appended to the file ``log``: a file,
    never an undrained pipe, which would freeze a chatty replica mid-write
    (the SPOF drill's lesson), and a failed wait can show it."""
    with open(log, "ab") as out:
        return subprocess.Popen(cmd, env=env, stdout=out,
                                stderr=subprocess.STDOUT, cwd=os.getcwd())


def _tail(log, n: int = 4000) -> str:
    return log.read_bytes()[-n:].decode(errors="replace") if log.exists() else ""


def _ledger(fleet_dir, rid: str) -> list:
    path = fleet_dir / f"{rid}.ledger"
    if not path.exists():
        return []
    return [int(line) for line in path.read_text().splitlines() if line]


def _wait_ready(port: int, proc: subprocess.Popen, log,
                deadline_sec: float = 90.0) -> None:
    deadline = time.monotonic() + deadline_sec
    with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=10) as c:
        while time.monotonic() < deadline:
            try:
                if c.get("/readyz").status_code == 200:
                    return
            except httpx.TransportError:
                pass
            if proc.poll() is not None:
                pytest.fail(f"replica on :{port} exited {proc.returncode}:\n"
                            f"{_tail(log)}")
            time.sleep(0.25)
    pytest.fail(f"replica on :{port} never reached /readyz 200:\n{_tail(log)}")


def test_fleet_kill9_offset_keyed_resume(tmp_path):
    broker_port = ioutils.choose_free_port()
    broker_dir = tmp_path / "broker"
    fleet_dir = tmp_path / "fleet"
    fleet_dir.mkdir()
    env = dict(os.environ, ORYX_FLEET_DIR=str(fleet_dir))
    broker_url = f"tcp://127.0.0.1:{broker_port}"
    http_ports = [ioutils.choose_free_port() for _ in range(N_REPLICAS)]
    rids = [f"fleet-r{i}" for i in range(N_REPLICAS)]
    procs: dict = {}
    stop_publishing = threading.Event()
    published = {"n": 0}

    broker_proc = _spawn(
        [sys.executable, "-m", "oryx_tpu_torch.cli", "broker",
         "--port", str(broker_port), "--dir", str(broker_dir)],
        env, tmp_path / "broker.log",
    )
    try:
        _wait_tcp(broker_port)
        tp.reset_tcp_clients()
        client = tp.get_broker(broker_url)
        client.create_topic(UPDATE_TOPIC)
        client.create_topic("OryxInput")

        # continuous generation stream: each GEN is a complete model (like
        # a MODEL push), seq starting at 1 == broker offset + 1
        producer = tp.TopicProducerImpl(broker_url, UPDATE_TOPIC)

        def publish():
            while not stop_publishing.is_set():
                seq = published["n"] + 1
                producer.send("GEN", json.dumps(
                    {"seq": seq, "words": {"gen": seq, "w": seq % 7}}
                ))
                published["n"] = seq
                stop_publishing.wait(GEN_INTERVAL_SEC)

        publisher = threading.Thread(target=publish, daemon=True)
        publisher.start()

        for rid, port in zip(rids, http_ports):
            procs[rid] = _spawn(
                [sys.executable, "-m", "oryx_tpu_torch.cli", "serving",
                 "--conf", _replica_conf(tmp_path, rid, port, broker_url)],
                env, tmp_path / f"{rid}.log",
            )
        for rid, port in zip(rids, http_ports):
            _wait_ready(port, procs[rid], tmp_path / f"{rid}.log")

        # fleet-wide traffic through the real traffic generator (pins
        # tools/traffic.py against tcp-backed replicas): random host per
        # request over all replicas, runs through the kill below
        from oryx_tpu_torch.tools import traffic

        endpoint = traffic._Endpoint(
            "state", 1.0, lambda rng: ("GET", "/fleet/state", None)
        )
        runner = traffic.TrafficRunner(
            [f"127.0.0.1:{p}" for p in http_ports], [endpoint],
            interval_ms=10.0, threads=2, duration_sec=120.0,
        )
        traffic_thread = threading.Thread(target=runner.run, daemon=True)
        traffic_thread.start()

        # let the victim apply a healthy prefix, then kill -9 MID-STREAM
        # (the publisher never pauses)
        victim = rids[1]
        deadline = time.monotonic() + 60
        while len(_ledger(fleet_dir, victim)) < 30:
            assert time.monotonic() < deadline, "victim ledger never grew"
            time.sleep(0.05)
        procs[victim].send_signal(signal.SIGKILL)
        assert procs[victim].wait(timeout=10) is not None

        # survivors keep serving while the victim is down
        for port in (http_ports[0], http_ports[2]):
            with httpx.Client(
                base_url=f"http://127.0.0.1:{port}", timeout=10
            ) as c:
                assert c.get("/fleet/state").status_code == 200

        # let generations accumulate past the kill, then read the victim's
        # committed offset — the position an offset-keyed resume must
        # continue from
        kill_seq = published["n"]
        deadline = time.monotonic() + 30
        while published["n"] < kill_seq + 20:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        off_at_restart = client.get_offset(f"serving-{victim}", UPDATE_TOPIC)
        assert off_at_restart is not None and off_at_restart > 0, (
            "victim committed no offsets before the kill"
        )

        # restart with the same oryx.id: /readyz must self-heal (snapshot
        # restores the model before the first redelivered message)
        procs[victim] = _spawn(
            [sys.executable, "-m", "oryx_tpu_torch.cli", "serving",
             "--conf", _replica_conf(
                 tmp_path, victim, http_ports[1], broker_url
             )],
            env, tmp_path / f"{victim}.log",
        )
        _wait_ready(http_ports[1], procs[victim], tmp_path / f"{victim}.log")

        # stop the stream at N and wait for every replica to drain to it
        stop_publishing.set()
        publisher.join(timeout=10)
        n_total = published["n"]
        assert n_total > kill_seq + 20
        deadline = time.monotonic() + 60
        for rid in rids:
            while True:
                ledger = _ledger(fleet_dir, rid)
                if ledger and ledger[-1] == n_total:
                    break
                assert time.monotonic() < deadline, (
                    f"{rid} never drained to seq {n_total}: at "
                    f"{ledger[-1] if ledger else 0}"
                )
                time.sleep(0.1)
        runner.stop()
        traffic_thread.join(timeout=15)

        # THE acceptance assertion: exactly-once generation accounting
        # across a kill -9 — zero lost, zero duplicated, in order
        for rid in rids:
            assert _ledger(fleet_dir, rid) == list(range(1, n_total + 1)), rid

        # arithmetic proof the resume was offset-keyed, not a full replay:
        # the restarted incarnation consumed exactly the messages past its
        # committed offset
        snap = json.loads((fleet_dir / f"{victim}.snapshot.json").read_text())
        assert snap["incarnation_consumed"] == n_total - off_at_restart, (
            snap, off_at_restart, n_total,
        )

        # the fleet served throughout: traffic flowed, and nothing answered
        # a 5xx (the killed replica's downtime surfaces as connection
        # errors, never as server errors)
        assert runner.requests > 0
        assert runner.server_errors == 0, (
            f"{runner.server_errors} server errors under fleet traffic"
        )

        for rid in rids:
            procs[rid].send_signal(signal.SIGTERM)
        for rid in rids:
            assert procs[rid].wait(timeout=20) is not None
        producer.close()
    finally:
        stop_publishing.set()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        if broker_proc.poll() is None:
            broker_proc.kill()
        tp.reset_tcp_clients()


def _fleet_status_json(replica_urls: "list[str]") -> dict:
    """Run the REAL `cli fleet-status --format json` as a subprocess and
    parse its output — zero aggregator exceptions is part of the contract
    (a down replica is data, not a crash)."""
    proc = subprocess.run(
        [sys.executable, "-m", "oryx_tpu_torch.cli", "fleet-status",
         "--replicas", ",".join(replica_urls), "--format", "json",
         "--timeout", "10"],
        env=dict(os.environ),
        capture_output=True, text=True, timeout=120, cwd=os.getcwd(),
    )
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    return json.loads(proc.stdout)


def test_fleet_observability_slo_burn_blackbox_and_status(tmp_path):
    """The fleet console end to end: a 3-replica fleet under traffic —

    * `cli fleet-status` shows a merged view whose summed request
      counters equal the exact traffic the test generated;
    * an armed ``serving.request`` fault schedule on ONE replica drives
      that replica's fast-window burn rate far past 1 with
      ``oryx_slo_alert_active`` firing, and the alert edge appears in its
      ``/debug/bundle``;
    * ``kill -9``ing it leaves a flight-recorder dump on disk (the
      periodic tick — no signal ever fires), flips it to down in the
      fleet table with ZERO aggregator exceptions, and the survivors
      stay green."""
    broker_port = ioutils.choose_free_port()
    broker_dir = tmp_path / "broker"
    fleet_dir = tmp_path / "fleet"
    dump_dir = tmp_path / "blackbox"
    fleet_dir.mkdir()
    env = dict(os.environ, ORYX_FLEET_DIR=str(fleet_dir))
    broker_url = f"tcp://127.0.0.1:{broker_port}"
    http_ports = [ioutils.choose_free_port() for _ in range(N_REPLICAS)]
    urls = [f"127.0.0.1:{p}" for p in http_ports]
    rids = [f"obs-r{i}" for i in range(N_REPLICAS)]
    victim_i = 1
    procs: dict = {}

    def spawn_quiet(cmd: list, name: str) -> subprocess.Popen:
        # a log file: the injected 500s log one traceback each
        return _spawn(cmd, env, tmp_path / f"{name}.log")

    blackbox_conf = f"""blackbox {{
    dump-dir = "{dump_dir}"
    dump-interval-sec = 1
    dump-min-interval-sec = 0
  }}"""
    victim_conf = blackbox_conf + """
  faults {
    enabled = true
    spec = "serving.request=rate:0.6"
    seed = 13
  }"""

    broker_proc = spawn_quiet(
        [sys.executable, "-m", "oryx_tpu_torch.cli", "broker",
         "--port", str(broker_port), "--dir", str(broker_dir)], "broker",
    )
    try:
        _wait_tcp(broker_port)
        tp.reset_tcp_clients()
        client = tp.get_broker(broker_url)
        client.create_topic(UPDATE_TOPIC)
        client.create_topic("OryxInput")
        producer = tp.TopicProducerImpl(broker_url, UPDATE_TOPIC)
        for seq in range(1, 4):  # a few generations so /fleet/state is 200
            producer.send("GEN", json.dumps(
                {"seq": seq, "words": {"gen": seq}}
            ))

        for i, (rid, port) in enumerate(zip(rids, http_ports)):
            procs[rid] = spawn_quiet(
                [sys.executable, "-m", "oryx_tpu_torch.cli", "serving",
                 "--conf", _replica_conf(
                     tmp_path, rid, port, broker_url,
                     extra=victim_conf if i == victim_i else blackbox_conf,
                 )], rid,
            )
        for rid, port in zip(rids, http_ports):
            _wait_ready(port, procs[rid], tmp_path / f"{rid}.log")

        # known traffic: exactly N_REQ /fleet/state requests per replica
        # (the victim answers ~60% of its share with injected 500s)
        N_REQ = 80
        status_counts: dict[str, int] = {}
        for port in http_ports:
            with httpx.Client(
                base_url=f"http://127.0.0.1:{port}", timeout=30
            ) as c:
                for _ in range(N_REQ):
                    r = c.get("/fleet/state")
                    status_counts[str(r.status_code)] = (
                        status_counts.get(str(r.status_code), 0) + 1
                    )
        assert status_counts.get("200", 0) > 0
        assert status_counts.get("500", 0) > 0, (
            "fault schedule never fired", status_counts
        )

        # scrape the victim twice, past the engine's 0.5s evaluation memo:
        # the periodic blackbox dumper also evaluates, and a first scrape
        # landing within the memo window could render a pre-traffic result
        # (a real scraper's 15s cadence never notices; this assertion
        # must). With a 0.1% budget and ~60% errors the fast-window burn
        # is ~600.
        victim_base = f"http://127.0.0.1:{http_ports[victim_i]}"
        with httpx.Client(base_url=victim_base, timeout=30) as c:
            c.get("/metrics")
            time.sleep(0.6)
            text = c.get("/metrics").text
            burn = next(
                float(line.rsplit(" ", 1)[1])
                for line in text.splitlines()
                if line.startswith("oryx_slo_burn_rate")
                and 'window="5m"' in line
            )
            assert burn > 1.0, f"victim fast-window burn rate {burn}"
            alert = next(
                float(line.rsplit(" ", 1)[1])
                for line in text.splitlines()
                if line.startswith("oryx_slo_alert_active")
                and 'severity="page"' in line
            )
            assert alert == 1.0, "page alert did not fire on the victim"
            # the probe body carries the alert list (informational)
            readyz = c.get("/readyz")
            assert readyz.status_code == 200  # alerts never flip readiness
            assert readyz.json()["slo_alerts"], readyz.text
            # the alert EDGE is in the victim's flight recorder, with the
            # injected-fault evidence in the bundled metrics snapshot
            bundle = c.get("/debug/bundle").json()
            edges = [e for e in bundle["events"]
                     if e["kind"] == "slo.alert" and e.get("active")]
            assert edges and edges[-1]["slo"] == "availability"
            injected = bundle["metrics"].get(
                "oryx_faults_injected_total", {}
            ).get('site="serving.request"', 0)
            assert injected > 0

        # merged fleet view: summed request counters equal the exact
        # traffic this test generated, per status class
        doc = _fleet_status_json(urls)
        counters = doc["fleet"]["counters"]["oryx_serving_requests_total"]
        by_status: dict[str, float] = {}
        total = 0.0
        for labels, value in counters.items():
            if 'route="/fleet/state"' not in labels:
                continue
            total += value
            status = labels.split('status="')[1].split('"')[0]
            by_status[status] = by_status.get(status, 0.0) + value
        assert total == N_REQ * N_REPLICAS, (total, counters)
        assert by_status == {
            k: float(v) for k, v in status_counts.items()
        }, (by_status, status_counts)
        victim_row = next(
            r for r in doc["table"]
            if r["replica"] == urls[victim_i]
        )
        assert victim_row["slo_alerts"] >= 1
        assert victim_row["worst_burn_rate"] > 1.0

        # kill -9 the victim: the periodic flight-recorder tick already
        # left dumps on disk — a dead replica leaves evidence
        procs[rids[victim_i]].send_signal(signal.SIGKILL)
        assert procs[rids[victim_i]].wait(timeout=10) == -signal.SIGKILL
        victim_dumps = sorted(
            f for f in os.listdir(dump_dir)
            if f.startswith(f"blackbox-{rids[victim_i]}-")
        )
        assert victim_dumps, sorted(os.listdir(dump_dir))
        last = json.loads((dump_dir / victim_dumps[-1]).read_text())
        assert last["oryx_id"] == rids[victim_i]
        assert "metrics" in last and "events" in last

        # the fleet table flips the victim to down — no exception, and
        # the survivors stay green
        doc = _fleet_status_json(urls)
        rows = {r["replica"]: r for r in doc["table"]
                if r["replica"] != "FLEET"}
        assert rows[urls[victim_i]]["up"] is False
        assert rows[urls[victim_i]]["error"]
        for i, url in enumerate(urls):
            if i != victim_i:
                assert rows[url]["up"] is True and rows[url]["ready"] is True
        fleet_row = next(r for r in doc["table"] if r["replica"] == "FLEET")
        assert fleet_row["n_up"] == N_REPLICAS - 1

        for i, rid in enumerate(rids):
            if i != victim_i:
                procs[rid].send_signal(signal.SIGTERM)
                # exit code 0, not just "exited": the chained SIGTERM dump
                # handler must hand control back to the cli's clean exit
                assert procs[rid].wait(timeout=20) == 0, rid
        producer.close()
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        if broker_proc.poll() is None:
            broker_proc.kill()
        tp.reset_tcp_clients()


def test_fleet_broker_kill9_fleet_self_heals(tmp_path):
    """Broker SPOF drill: kill -9 the ``cli broker``
    process mid-traffic and restart it on the same port + dir. The fleet
    must self-heal with no operator action: producers ride lazy reconnect
    + the retry policy through the outage, consumers resume, the 3-replica
    ledger reads exactly 1..N (zero lost, zero duplicated — idempotence
    tokens + seq dedup absorb the crash-overlap window), and traffic sees
    zero server errors (replicas serve their in-memory model throughout)."""
    broker_port = ioutils.choose_free_port()
    broker_dir = tmp_path / "broker"
    fleet_dir = tmp_path / "fleet"
    fleet_dir.mkdir()
    env = dict(os.environ, ORYX_FLEET_DIR=str(fleet_dir))
    broker_url = f"tcp://127.0.0.1:{broker_port}"
    http_ports = [ioutils.choose_free_port() for _ in range(N_REPLICAS)]
    rids = [f"spof-r{i}" for i in range(N_REPLICAS)]
    procs: dict = {}
    stop_publishing = threading.Event()
    published = {"n": 0}

    def spawn_quiet(cmd: list, name: str) -> subprocess.Popen:
        # a log file, not a PIPE: the outage makes every replica log retry
        # warnings at volume, and an undrained 64K pipe buffer would
        # FREEZE the replica mid-write — a test-harness deadlock that
        # reads exactly like the recovery failure this drill hunts
        return _spawn(cmd, env, tmp_path / f"{name}.log")

    def spawn_broker() -> subprocess.Popen:
        p = spawn_quiet(
            [sys.executable, "-m", "oryx_tpu_torch.cli", "broker",
             "--port", str(broker_port), "--dir", str(broker_dir)], "broker",
        )
        _wait_tcp(broker_port)
        return p

    broker_proc = spawn_broker()
    try:
        tp.reset_tcp_clients()
        client = tp.get_broker(broker_url)
        client.create_topic(UPDATE_TOPIC)
        client.create_topic("OryxInput")

        producer = tp.TopicProducerImpl(broker_url, UPDATE_TOPIC)

        def publish():
            # blocks on each seq until the send SUCCEEDS: an outage longer
            # than the retry budget surfaces here as a caught failure and
            # the same seq is re-sent (the fleet app dedups the
            # crash-overlap case where the first append actually applied)
            while not stop_publishing.is_set():
                seq = published["n"] + 1
                try:
                    producer.send("GEN", json.dumps(
                        {"seq": seq, "words": {"gen": seq, "w": seq % 7}}
                    ))
                except Exception:
                    stop_publishing.wait(0.2)
                    continue
                published["n"] = seq
                stop_publishing.wait(GEN_INTERVAL_SEC)

        publisher = threading.Thread(target=publish, daemon=True)
        publisher.start()

        for rid, port in zip(rids, http_ports):
            procs[rid] = spawn_quiet(
                [sys.executable, "-m", "oryx_tpu_torch.cli", "serving",
                 "--conf", _replica_conf(tmp_path, rid, port, broker_url)], rid,
            )
        for rid, port in zip(rids, http_ports):
            _wait_ready(port, procs[rid], tmp_path / f"{rid}.log")

        from oryx_tpu_torch.tools import traffic

        endpoint = traffic._Endpoint(
            "state", 1.0, lambda rng: ("GET", "/fleet/state", None)
        )
        runner = traffic.TrafficRunner(
            [f"127.0.0.1:{p}" for p in http_ports], [endpoint],
            interval_ms=10.0, threads=2, duration_sec=120.0,
        )
        traffic_thread = threading.Thread(target=runner.run, daemon=True)
        traffic_thread.start()

        # healthy prefix applied everywhere, then kill -9 THE BROKER
        deadline = time.monotonic() + 60
        while any(len(_ledger(fleet_dir, rid)) < 20 for rid in rids):
            assert time.monotonic() < deadline, "fleet never applied prefix"
            time.sleep(0.05)
        broker_proc.send_signal(signal.SIGKILL)
        assert broker_proc.wait(timeout=10) is not None
        kill_seq = published["n"]

        # replicas keep SERVING through the outage (in-memory model; the
        # broker is the data plane, not the request path)
        for port in http_ports:
            with httpx.Client(
                base_url=f"http://127.0.0.1:{port}", timeout=10
            ) as c:
                assert c.get("/fleet/state").status_code == 200

        # restart the broker on the same port over the same durable dir
        broker_proc = spawn_broker()

        # the stream resumes THROUGH the same producer (lazy reconnect):
        # wait for real post-outage progress
        deadline = time.monotonic() + 60
        while published["n"] < kill_seq + 20:
            assert time.monotonic() < deadline, (
                f"publisher never recovered past the outage "
                f"(at {published['n']}, kill at {kill_seq})"
            )
            time.sleep(0.05)

        # stop at N and wait for the whole fleet to drain to it
        stop_publishing.set()
        publisher.join(timeout=10)
        n_total = published["n"]
        deadline = time.monotonic() + 60
        for rid in rids:
            while True:
                ledger = _ledger(fleet_dir, rid)
                if ledger and ledger[-1] == n_total:
                    break
                assert time.monotonic() < deadline, (
                    f"{rid} never drained to {n_total}: at "
                    f"{ledger[-1] if ledger else 0}"
                )
                time.sleep(0.1)
        runner.stop()
        traffic_thread.join(timeout=15)

        # exactly-once across the broker kill: zero lost, zero duplicated
        for rid in rids:
            assert _ledger(fleet_dir, rid) == list(range(1, n_total + 1)), rid

        # zero 5xx: the outage cost availability of the data plane only
        assert runner.requests > 0
        assert runner.server_errors == 0, (
            f"{runner.server_errors} server errors across the broker outage"
        )

        for rid in rids:
            procs[rid].send_signal(signal.SIGTERM)
        for rid in rids:
            assert procs[rid].wait(timeout=20) is not None
        producer.close()
    finally:
        stop_publishing.set()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        if broker_proc.poll() is None:
            broker_proc.kill()
        tp.reset_tcp_clients()
