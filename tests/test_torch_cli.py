"""The port's ``oryx-run`` CLI, ``python -m oryx_tpu_torch.cli``, as
processes.

Mirrors ``tests/test_cli_processes.py`` on the port: ``config-dump``, and
the topic tools over a ``tcp:`` broker process. In place of the wordcount
loop (the reference's ``example`` package is not ported), the ALS lambda
loop as four processes on the CPU — broker, batch, speed and one serving
replica over ``tcp:`` — driven by ``chip_smoke.Deployment``, the smoke's
own harness: the replica's ``/recommend`` answers equal an in-test
manager's fed from the same update topic, and a microbatch reaches them.
Then the port's own rules: the layer commands refuse to start without a
card unless ``cpu`` is asked for, before any topic, thread or socket;
``analyze`` exits 2 (``fleet-status`` is held to the reference by
``tests/test_torch_federation.py``); the single-host half of
``parallel.distributed``; the shutdown hook of ``common.lockutils``.

Every test that spawns a process has a deadline and kills what it started.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from oryx_tpu.common import lockutils as ref_lockutils
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.common import lockutils
from oryx_tpu_torch.common import metrics
from oryx_tpu_torch.parallel import distributed
from oryx_tpu_torch.parallel.mesh import ComputeContext
from oryx_tpu_torch.transport import netbroker
from oryx_tpu_torch.transport import topic as tp

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "oryx_tpu_torch.cli"]


def _run(*argv, timeout=120, **kwargs):
    return subprocess.run([*CLI, *argv], cwd=REPO, capture_output=True, text=True,
                          timeout=timeout, **kwargs)


def _wait_listening(port, proc, deadline_s=60):
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "the broker never listened"
            time.sleep(0.1)


def test_cli_config_dump(tmp_path, capsys):
    from oryx_tpu_torch.cli.main import main as cli_main

    conf = tmp_path / "app.conf"
    conf.write_text('oryx.id = "dump-test"\n')
    assert cli_main(["config-dump", "--conf", str(conf)]) == 0
    out = capsys.readouterr().out
    assert "oryx.id=dump-test" in out
    assert "oryx.serving.api.port=8080" in out


def test_cli_topic_tools_over_tcp(tmp_path):
    """The topic tools are URL-scheme uniform: ``topic-setup``,
    ``topic-input`` and ``topic-tail`` work unchanged against a
    ``tcp://host:port`` broker served by ``python -m oryx_tpu_torch.cli
    broker``; SIGTERM stops the broker with exit 0."""
    broker_port = ioutils.choose_free_port()
    conf = tmp_path / "app.conf"
    conf.write_text(f"""
oryx {{
  id = "tcp-smoke"
  input-topic.broker = "tcp://127.0.0.1:{broker_port}"
  update-topic.broker = "tcp://127.0.0.1:{broker_port}"
}}
""")

    def run_tool(cmd, *extra, stdin=None):
        done = _run(cmd, "--conf", str(conf), *extra, input=stdin, timeout=60)
        assert done.returncode == 0, done.stderr
        return done

    broker_proc = subprocess.Popen(
        [*CLI, "broker", "--port", str(broker_port), "--dir", str(tmp_path / "topics")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        _wait_listening(broker_port, broker_proc)
        setup = run_tool("topic-setup")
        assert "created topic" in setup.stdout
        # a second setup is idempotent
        assert "exists" in run_tool("topic-setup").stdout
        run_tool("topic-input", stdin="hello world\nsecond line\n")
        tail = run_tool("topic-tail", "--which", "input", "--max-messages", "2")
        lines = tail.stdout.strip().splitlines()
        assert [ln.split("\t", 1)[1] for ln in lines] == [
            "hello world", "second line",
        ]
        # the log the broker wrote is the file: broker's
        assert [km.message for km in tp.FileBroker(str(tmp_path / "topics")).read(
            "OryxInput", 0)] == ["hello world", "second line"]
        broker_proc.send_signal(signal.SIGTERM)
        assert broker_proc.wait(timeout=30) == 0
    finally:
        if broker_proc.poll() is None:
            broker_proc.kill()
            broker_proc.wait(10)


def test_cli_transport_commands_import_no_torch():
    """``broker`` and the topic tools are pure transport and
    ``fleet-status`` pure HTTP, as in the reference: the CLI module, the
    broker, the topic code and the fleet console load without torch."""
    code = ("import sys; import oryx_tpu_torch.cli.main, "
            "oryx_tpu_torch.transport.netbroker, "
            "oryx_tpu_torch.common.federation; "
            "sys.exit(1 if 'torch' in sys.modules else 0)")
    assert subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          timeout=60).returncode == 0


N_USERS, N_ITEMS, N_LINES = 300, 120, 4_000


def _loop_lines(seed=11):
    """``user,item,1,ts`` lines: each user picks items by a planted rank-2
    preference, timestamps are positions."""
    rng = np.random.default_rng(seed)
    u_f = rng.standard_normal((N_USERS, 2))
    i_f = rng.standard_normal((N_ITEMS, 2))
    p = np.exp(u_f @ i_f.T)
    p /= p.sum(axis=1, keepdims=True)
    users = rng.integers(0, N_USERS, N_LINES)
    return [f"u{u},i{rng.choice(N_ITEMS, p=p[u])},1,{t}"
            for t, u in enumerate(users.tolist())]


def test_cli_als_loop_as_processes(tmp_path):
    """Broker, batch, speed and one serving replica, each a CLI process on
    the CPU (``oryx.default-compute-config.platform = "cpu"``, the one key
    for the whole deployment), over ``tcp:``; the 4,000 lines bulk-loaded
    into the input log. ``deployment_run`` checks the replica's
    ``/recommend`` for every user, with and without known items, against a
    manager in this process on the same update topic (ids and scores within
    1e-5, the batch generation's header on every answer), sends the
    hold-out's lines as a microbatch over ``tcp:`` and checks the touched
    users again, then stops each process with SIGTERM (exit 0, no failure
    counted in any tier's flight-recorder bundle). The processes run
    sanitized by the port's sanitizer, as the smoke runs them: each
    prints its report at exit, and none may hold a lock-order cycle."""
    from chip_smoke import Deployment, deployment_run, sanitizer_summary

    lines = _loop_lines()
    tp.reset_tcp_clients()
    dep = Deployment(str(tmp_path), {
        "oryx.default-compute-config.platform": "cpu",
        "oryx.als.hyperparams.features": 4,
        "oryx.als.iterations": 2,
        "oryx.batch.streaming.generation-interval-sec": 0.5,
        "oryx.speed.streaming.generation-interval-sec": 0.5,
    }, replicas=1, local_device="cpu")
    try:
        out = deployment_run(dep, lines, np.random.default_rng(3), timeout=120)
    except BaseException:
        print(dep.tails())
        raise
    finally:
        dep.close()
        tp.reset_tcp_clients()
    # long holds from 1 ms: the processes that report any ran the port's
    # wrappers (a report's header names its modes)
    sanitized = sanitizer_summary(dep.sanitizer_reports(), "cli deployment")
    reporting = {name: p["modes"] for name, p in sanitized["processes"].items()
                 if name not in sanitized["no_report"]}
    assert reporting and set(reporting.values()) == {"locks,loop"}, sanitized
    model = dep.local.get_model()
    assert len(model.all_user_ids()) == N_USERS
    gen = out["generation"]
    assert gen["messages"] == 1 + N_ITEMS + N_USERS
    assert out["answers"][0]["recommend_checked"] == 2 * N_USERS
    assert out["answers"][0]["build_info"] == [
        'version="0.1.0",backend="cpu",device_kind="cpu"']
    mb = out["microbatch"]
    assert mb["lines"] == 400 - mb["probe_lines"] and mb["ups"] > mb["lines"]
    assert mb["touched_checked"] > 0 and mb["ticks"] >= 1
    # the plain versions run on the CPU: no kernel launched in the batch
    # process; the family holds only the trainer's cost accounting, one
    # call a half per iteration (2) of each generation it ran
    calls = out["launches"]["by_program"]
    assert set(calls) == {'program="als.train.user_half"',
                          'program="als.train.item_half"'}
    assert len(set(calls.values())) == 1 and next(iter(calls.values())) % 2 == 0
    assert set(out["exits"]) == {"batch", "speed", "serving-0", "broker"}
    assert out["failures"] == {}
    # the microbatch's last line is among the known items of the model the
    # replica's answers were held to after the microbatch
    u, i = lines[-1].split(",")[:2]
    assert i in model.get_known_items(u)


@pytest.mark.parametrize("tier", ["batch", "speed", "serving"])
def test_cli_layers_refuse_to_start_without_the_card(tmp_path, tier):
    """Without a card, and without ``cpu`` asked for, each layer command
    exits non-zero from ``start()`` naming the missing device, before it
    touches a topic, opens a socket or binds its port: the broker it is
    pointed at sees no connection and holds no topic."""
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a host without a CUDA card")
    server = netbroker.NetBrokerServer(str(tmp_path / "topics"), host="127.0.0.1",
                                       port=0).start_background()
    api_port = ioutils.choose_free_port()
    conf = tmp_path / "app.conf"
    conf.write_text(f"""
oryx.id = "nocard"
oryx.input-topic.broker = "tcp://127.0.0.1:{server.port}"
oryx.update-topic.broker = "tcp://127.0.0.1:{server.port}"
oryx.batch.update-class = "oryx_tpu_torch.models.als.update.ALSUpdate"
oryx.batch.storage.data-dir = "{tmp_path}/data"
oryx.batch.storage.model-dir = "{tmp_path}/model"
oryx.speed.model-manager-class = "oryx_tpu_torch.models.als.speed.ALSSpeedModelManager"
oryx.serving.model-manager-class = "oryx_tpu_torch.models.als.serving.ALSServingModelManager"
oryx.serving.application-resources = "oryx_tpu_torch.serving.resources.als"
oryx.serving.api.port = {api_port}
""")
    connections = metrics.default_registry().get("oryx_netbroker_connections_total")
    before = connections.value
    try:
        done = _run(tier, "--conf", str(conf))
    finally:
        server.close()
    assert done.returncode != 0
    assert "no CUDA device is available" in done.stderr
    assert connections.value == before
    assert not [p for p in (tmp_path / "topics").iterdir() if p.is_dir()]
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", api_port))


def test_default_compute_platform_reaches_every_tier():
    """``oryx.default-compute-config.platform`` is the fallback of each
    tier's own ``platform``; a tier's own value wins."""
    conf = cfg.overlay_on({"oryx.default-compute-config.platform": "cpu"},
                          cfg.get_default())
    for tier in ("batch", "speed"):
        assert ComputeContext(conf, tier).device == torch.device("cpu")
    with pytest.raises(ValueError, match="default-compute-config.platform"):
        ComputeContext(cfg.overlay_on({"oryx.default-compute-config.platform": "tpu"},
                                      cfg.get_default()), "batch")
    with pytest.raises(ValueError, match="batch.streaming.config.platform"):
        ComputeContext(conf.with_values({"oryx.batch.streaming.config.platform": "tpu"}),
                       "batch")


@pytest.mark.parametrize("command,message", [("analyze", "item 7")])
def test_cli_unported_commands_exit_2(command, message):
    done = _run(command, "--replicas", "127.0.0.1:1", timeout=60)
    assert done.returncode == 2
    assert "not ported yet" in done.stderr and message in done.stderr


def test_distributed_is_single_host_only():
    """No coordinator starts nothing; a configured one joins a
    ``torch.distributed`` group (here a one-rank ``gloo`` group, the CPU
    platform's backend), idempotently, until ``shutdown``."""
    assert distributed.initialize_from_config(cfg.get_default()) is False
    assert distributed.is_initialized() is False
    conf = cfg.overlay_on({"oryx.distributed.coordinator":
                           f"127.0.0.1:{ioutils.choose_free_port()}",
                           "oryx.distributed.num-processes": 1,
                           "oryx.distributed.process-id": 0,
                           "oryx.default-compute-config.platform": "cpu"},
                          cfg.get_default())
    try:
        assert distributed.initialize_from_config(conf) is True
        assert distributed.is_initialized() is True
        assert distributed.initialize_from_config(conf) is True
        assert torch.distributed.get_world_size() == 1
        assert torch.distributed.get_backend() == "gloo"
    finally:
        distributed.shutdown()
    assert distributed.is_initialized() is False


class _Closeable:
    def __init__(self, name, log):
        self.name, self.log = name, log

    def close(self):
        self.log.append(self.name)
        if self.name == "bad":
            raise RuntimeError("a failing close must not stop the others")


@pytest.mark.parametrize("mod", [lockutils, ref_lockutils], ids=["port", "reference"])
def test_close_at_shutdown_closes_in_reverse_order(mod, monkeypatch):
    """The hook closes what was registered, last first, past a failing
    close, once; the CLI registers each layer with it."""
    monkeypatch.setattr(mod, "_shutdown_hook_items", [])
    registered = []
    monkeypatch.setattr(mod.atexit, "register", registered.append)
    monkeypatch.setattr(mod, "_hook_registered", False)
    log = []
    for name in ("a", "bad", "c"):
        mod.close_at_shutdown(_Closeable(name, log))
    assert registered == [mod._run_shutdown_hook]
    mod._run_shutdown_hook()
    mod._run_shutdown_hook()
    assert log == ["c", "bad", "a"]


def test_layer_process_dumps_its_launch_counter_on_sigterm(tmp_path):
    """A layer process started by the CLI with ``oryx.blackbox.dump-dir``
    writes a bundle on SIGTERM and exits 0; its metrics snapshot holds the
    kernels' ``oryx_device_calls_total`` family (empty on the CPU, where the
    plain versions count nothing)."""
    server = netbroker.NetBrokerServer(str(tmp_path / "topics"), host="127.0.0.1",
                                       port=0).start_background()
    conf = tmp_path / "app.conf"
    url = f"tcp://127.0.0.1:{server.port}"
    conf.write_text(f"""
oryx.id = "dump"
oryx.input-topic.broker = "{url}"
oryx.update-topic.broker = "{url}"
oryx.default-compute-config.platform = "cpu"
oryx.batch.update-class = "oryx_tpu_torch.models.als.update.ALSUpdate"
oryx.batch.storage.data-dir = "{tmp_path}/data"
oryx.batch.storage.model-dir = "{tmp_path}/model"
oryx.blackbox.dump-dir = "{tmp_path}/bb"
""")
    proc = None
    log = tmp_path / "batch.log"
    try:
        assert _run("topic-setup", "--conf", str(conf)).returncode == 0
        with open(log, "wb") as out:
            proc = subprocess.Popen([*CLI, "batch", "--conf", str(conf)], cwd=REPO,
                                    stdout=out, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 60
        # start() has loaded the update class (and with it the kernels)
        while "starting batch layer" not in log.read_text():
            assert proc.poll() is None, log.read_text()
            assert time.monotonic() < deadline, "the batch layer never started"
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(10)
        server.close()
    (bundle,) = (tmp_path / "bb").glob("*-sigterm.json")
    snapshot = json.loads(bundle.read_text())["metrics"]
    assert snapshot["oryx_device_calls_total"] == {}
