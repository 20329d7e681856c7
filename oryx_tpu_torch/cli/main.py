"""oryx-run CLI: launch layers and manage topics from the command line.

The port of the JAX package's ``oryx_tpu/cli/main.py`` (which is unchanged:
``python -m oryx_tpu.cli`` still runs the reference), held to it by
``tests/test_torch_cli.py``. Changes:

  * The device: ``batch`` and ``speed`` take theirs from
    ``oryx.{batch,speed}.streaming.config.platform``, falling back to
    ``oryx.default-compute-config.platform``
    (:class:`~oryx_tpu_torch.parallel.mesh.ComputeContext`); ``serving``
    builds its layer on the device that shared key names. Null, ``gpu`` or
    ``cuda`` mean the CUDA card and ``cpu`` the CPU, so the one key asks a
    whole deployment for the CPU, as ``JAX_PLATFORMS=cpu`` does for the
    reference. Without a card and without ``cpu`` a layer command exits
    non-zero from ``start()``, before any topic, thread or socket. There
    is no ``JAX_PLATFORMS`` block.
  * ``analyze`` runs the port's static analyser
    (:mod:`oryx_tpu_torch.tools.analyze`) over ``oryx_tpu_torch/`` against
    ``conf/analyze-baseline-torch.json``, with the reference's ``--cost``
    / ``--bind`` and ``--protocol`` modes (``--cost`` without the Pallas
    kernel rows). ``ORYX_SANITIZE=locks,loop`` sanitizes every command.
  * ``broker``, the topic tools and ``fleet-status`` import no torch:
    they are pure transport or pure HTTP, as in the reference.
  * ``python -m oryx_tpu_torch.cli`` ends its process through
    :func:`run`: the exit handlers run and the output is flushed, and then
    the process exits without CPython's interpreter finalization, which
    aborts a process (SIGABRT) whose daemon thread is inside torch's
    native code at that moment. The reference's original, a JVM, stops
    daemon threads at exit.

Below, the reference's text.

Equivalent of the reference's deploy tier (deploy/oryx-{batch,speed,serving}
Main.java:30-37 and deploy/bin/oryx-run.sh:16-36): commands
``batch | speed | serving | broker | topic-setup | topic-tail |
topic-input``. Each layer command constructs its layer from the
(default-overlaid) config file, registers shutdown close, starts, and awaits
termination; the topic commands mirror ``kafka-setup`` / ``kafka-tail`` /
``kafka-input``; ``broker`` runs the ``tcp:`` network broker server (the
Kafka-broker-process equivalent, transport/netbroker.py).

Usage::

    python -m oryx_tpu_torch.cli batch --conf myapp.conf
    python -m oryx_tpu_torch.cli broker --port 2181 --dir /var/oryx/topics
    python -m oryx_tpu_torch.cli topic-tail --conf myapp.conf --which update
    echo "a b c" | python -m oryx_tpu_torch.cli topic-input --conf myapp.conf
"""

from __future__ import annotations

import argparse
import atexit
import logging
import os
import signal
import sys
import traceback

from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common.lockutils import close_at_shutdown
from oryx_tpu_torch.transport import topic as tp

log = logging.getLogger(__name__)


def _load_config(path: "str | None"):
    if path:
        return cfg.Config.parse_file(path).overlay_on(cfg.get_default())
    return cfg.get_default()


def _run_layer(layer_cls_path: str, config, **kwargs) -> int:
    """Main.java pattern: construct, close-at-shutdown, start, await.
    ``kwargs`` go to the layer's constructor (the serving layer's
    ``device``)."""
    from oryx_tpu_torch.parallel.distributed import initialize_from_config

    initialize_from_config(config)
    module_name, cls_name = layer_cls_path.rsplit(".", 1)
    import importlib

    layer_cls = getattr(importlib.import_module(module_name), cls_name)
    log.info("config:\n%s", config.pretty_print())
    # the exit handler installs BEFORE the layer constructs: layer
    # construction runs blackbox.configure, which (with a dump-dir set)
    # CHAINS a flight-recorder dump in front of whatever SIGTERM handler
    # exists — installing ours afterwards would silently drop the dump
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    layer = layer_cls(config, **kwargs)
    close_at_shutdown(layer)
    layer.start()
    try:
        layer.await_termination()
    except KeyboardInterrupt:
        pass
    finally:
        layer.close()
    return 0


def _topics(config) -> dict[str, tuple[str, str]]:
    return {
        "input": (
            config.get_string("oryx.input-topic.broker"),
            config.get_string("oryx.input-topic.message.topic"),
        ),
        "update": (
            config.get_string("oryx.update-topic.broker"),
            config.get_string("oryx.update-topic.message.topic"),
        ),
    }


def cmd_topic_setup(config, args) -> int:
    """Create both topics if absent (oryx-run.sh kafka-setup)."""
    for which, (broker_url, name) in _topics(config).items():
        broker = tp.get_broker(broker_url)
        if broker.topic_exists(name):
            print(f"{which}: topic {name} exists")
        else:
            broker.create_topic(name)
            print(f"{which}: created topic {name}")
    return 0


def cmd_topic_tail(config, args) -> int:
    """Stream a topic's messages to stdout (oryx-run.sh kafka-tail).
    ``--max-messages N`` exits after N messages instead of tailing forever
    (scriptable inspection; the tcp smoke tests ride this)."""
    remaining = args.max_messages
    if remaining is not None and remaining <= 0:
        return 0  # nothing asked for: exit before the blocking iterator
    broker_url, name = _topics(config)[args.which]
    broker = tp.get_broker(broker_url)
    it = tp.ConsumeDataIterator(broker, name, "earliest")
    try:
        for km in it:
            print(f"{km.key}\t{km.message}", flush=True)
            if remaining is not None:
                remaining -= 1
                if remaining <= 0:
                    break
    except KeyboardInterrupt:
        pass
    finally:
        it.close()
    return 0


def cmd_broker(argv: "list[str]") -> int:
    """Run the ``tcp:`` network broker server (transport/netbroker.py): one
    process owns ``--dir`` durably (wrapping the file broker locally — the
    single-writer design that retires the shared-FS constraint) and serves
    it to any number of hosts on ``--port``. Foreground; SIGTERM/SIGINT
    stop it cleanly. Runbook: docs/admin.md "Broker selection"."""
    import threading

    parser = argparse.ArgumentParser(
        prog="oryx-run broker", description="Oryx TCP broker server"
    )
    parser.add_argument("--port", type=int, required=True,
                        help="TCP port to listen on (0 = ephemeral)")
    parser.add_argument("--dir", required=True,
                        help="topic storage directory this server owns")
    parser.add_argument("--host", default=None,
                        help="bind host (default: oryx.broker.tcp.server.host)")
    parser.add_argument("--group-ttl-sec", type=float, default=None,
                        help="consumer-group heartbeat TTL (default 30)")
    parser.add_argument("--conf", help="HOCON config file overlaid on defaults")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    config = _load_config(args.conf)
    from oryx_tpu_torch.transport import netbroker

    netbroker.configure(config)
    # the server's inner FileBroker honors oryx.broker.file.* (fsync
    # durability policy, torn-tail recovery) exactly like a local file:
    tp.configure(config)
    server_cfg = config.get_config("oryx.broker.tcp.server")
    host = args.host or server_cfg.get_string("host", "0.0.0.0")
    stats_interval = server_cfg.get_float("stats-interval-sec", 60.0)
    server = netbroker.NetBrokerServer(
        args.dir, host=host, port=args.port,
        group_ttl_sec=args.group_ttl_sec,
        stats_interval_sec=stats_interval,
    )
    server.start_background()
    print(f"broker listening on {host}:{server.port} dir={args.dir}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.wait(3600):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


def cmd_fleet_status(argv: "list[str]") -> int:
    """Fleet-wide observability console (common/federation.py): scrape N
    replicas' ``/metrics`` + ``/readyz`` + ``/trace`` +
    ``/metrics/history``, merge them soundly (counters sum, histograms add
    bucket-wise, gauges keep per-replica labels, down replicas report
    down), and render an operator table, a merged Prometheus ``fleet``
    exposition, or JSON. Rate columns prefer a replica's own server-side
    series from ``/metrics/history`` (with qps/freshness sparkline
    columns); ``--watch`` re-scrapes on an interval and keeps client-side
    delta derivation as the fallback for pre-history replicas in a mixed
    fleet. Replica list from ``--replicas`` (comma-separated, repeatable)
    or ``oryx.fleet.replicas``. Runbook: docs/slo.md."""
    parser = argparse.ArgumentParser(
        prog="oryx-run fleet-status",
        description="Oryx fleet observability console",
    )
    parser.add_argument(
        "--replicas", action="append", default=[],
        help="comma-separated replica targets (host:port or http URLs); "
             "repeatable; default: oryx.fleet.replicas",
    )
    parser.add_argument("--conf", help="HOCON config file overlaid on defaults")
    parser.add_argument(
        "--watch", type=float, default=0.0, metavar="SEC",
        help="re-scrape every SEC seconds (rate columns prefer server-side "
             "/metrics/history series, else scrape deltas); 0 = one shot",
    )
    parser.add_argument(
        "--format", choices=["table", "prom", "json"], default="table",
        help="table (operator view), prom (merged fleet exposition), json",
    )
    parser.add_argument("--timeout", type=float, default=None,
                        help="per-replica scrape budget (default: "
                             "oryx.fleet.scrape-timeout-sec)")
    args = parser.parse_args(argv)
    config = _load_config(args.conf)
    replicas = [
        entry.strip()
        for chunk in args.replicas for entry in chunk.split(",")
        if entry.strip()
    ]
    if not replicas:
        replicas = [str(r) for r in config.get_list("oryx.fleet.replicas", [])]
    if not replicas:
        print("fleet-status: no replicas (pass --replicas or set "
              "oryx.fleet.replicas)", file=sys.stderr)
        return 2
    timeout = args.timeout if args.timeout is not None else config.get_float(
        "oryx.fleet.scrape-timeout-sec", 5.0
    )
    from oryx_tpu_torch.common import federation

    prev = None
    try:
        while True:
            snap = federation.scrape_fleet(replicas, timeout=timeout)
            if args.format == "prom":
                print(federation.render_prom(snap), end="")
            elif args.format == "json":
                import json as _json

                print(_json.dumps(federation.to_json(snap, prev)))
            else:
                rows = federation.table_rows(snap, prev)
                print(federation.render_table(rows), end="", flush=True)
            if args.watch <= 0:
                return 0
            prev = snap
            import time as _time

            _time.sleep(args.watch)
            print()
    except KeyboardInterrupt:
        return 0


def cmd_analyze(argv: "list[str]") -> int:
    """Static analysis of the port's own sources (``analyze --help``)."""
    from oryx_tpu_torch.tools.analyze.cli import main as analyze_main

    return analyze_main(argv)


def cmd_topic_input(config, args) -> int:
    """Feed stdin lines to the input topic (oryx-run.sh kafka-input)."""
    broker_url, name = _topics(config)["input"]
    producer = tp.TopicProducerImpl(broker_url, name)
    n = 0
    for line in sys.stdin:
        line = line.rstrip("\n")
        if line:
            producer.send(None, line)
            n += 1
    producer.close()
    print(f"sent {n} messages to {name}", file=sys.stderr)
    return 0


def main(argv: "list[str] | None" = None) -> int:
    args_in = sys.argv[1:] if argv is None else list(argv)
    if args_in and args_in[0] == "analyze":
        return cmd_analyze(args_in[1:])
    if args_in and args_in[0] == "broker":
        # the tcp broker server is a pure-transport process: its own option
        # surface (--port/--dir/...), and it must never pay a torch import
        return cmd_broker(args_in[1:])
    if args_in and args_in[0] == "fleet-status":
        # the fleet aggregator is a pure-HTTP observer: its own option
        # surface (--replicas/--watch/--format), never a torch import
        return cmd_fleet_status(args_in[1:])
    parser = argparse.ArgumentParser(
        prog="oryx-run",
        description="Oryx runner on PyTorch/CUDA (oryx-run.sh equivalent)"
    )
    parser.add_argument("command", choices=[
        "batch", "speed", "serving", "topic-setup", "topic-tail", "topic-input",
        "config-dump",
    ])
    parser.add_argument("--conf", help="HOCON config file overlaid on defaults")
    parser.add_argument(
        "--which", choices=["input", "update"], default="update",
        help="which topic for topic-tail",
    )
    parser.add_argument(
        "--max-messages", type=int, default=None,
        help="topic-tail: exit after this many messages (default: tail forever)",
    )
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    config = _load_config(args.conf)
    # the topic tools talk to brokers directly (no layer construction runs
    # configure for them): adopt oryx.broker.tcp.* before any get_broker
    from oryx_tpu_torch.transport import netbroker

    netbroker.configure(config)
    tp.configure(config)
    if args.command == "batch":
        return _run_layer("oryx_tpu_torch.lambda_rt.batch.BatchLayer", config)
    if args.command == "speed":
        return _run_layer("oryx_tpu_torch.lambda_rt.speed.SpeedLayer", config)
    if args.command == "serving":
        from oryx_tpu_torch.parallel import mesh

        device = mesh.platform_device(mesh.default_platform(config),
                                      mesh.DEFAULT_COMPUTE_KEY)
        return _run_layer("oryx_tpu_torch.serving.app.ServingLayer", config,
                          device=device)
    if args.command == "topic-setup":
        return cmd_topic_setup(config, args)
    if args.command == "topic-tail":
        return cmd_topic_tail(config, args)
    if args.command == "config-dump":
        # resolved config as key=value properties (ConfigToProperties,
        # settings/ConfigToProperties.java:60 / oryx-run.sh:88)
        for key, value in sorted(config.to_properties().items()):
            print(f"{key}={value}")
        return 0
    return cmd_topic_input(config, args)


def run(argv: "list[str] | None" = None) -> None:
    """:func:`main` as a process: its exit code (a ``SystemExit``'s, as
    Python reads it; 1 after an uncaught exception, whose traceback is
    printed) ends the process through :func:`_halt`."""
    try:
        code = main(argv)
    except SystemExit as e:
        code = e.code
    except BaseException:  # noqa: BLE001 — printed, then exit 1 as Python would
        traceback.print_exc()
        code = 1
    if code is None:
        code = 0
    elif not isinstance(code, int):
        print(code, file=sys.stderr)
        code = 1
    _halt(code)


def _halt(code: int) -> None:
    """Run the exit handlers (the close-at-shutdown hook, the sanitizer's
    report, logging's flush), flush stdout and stderr, and exit at once.
    Interpreter finalization is skipped on purpose: a layer's daemon
    threads (the flight recorder's dumper, a SIGTERM dump that outlived its
    join, the update consumer, the HTTP server's loop) may be inside
    torch's native code then, and CPython 3.12 ends such a thread by
    unwinding it through C++ frames, which calls ``std::terminate``: the
    process would die of SIGABRT after a clean shutdown."""
    atexit._run_exitfuncs()
    for stream in (sys.stdout, sys.stderr):
        try:
            stream.flush()
        except (OSError, ValueError):
            pass
    os._exit(code)


if __name__ == "__main__":  # pragma: no cover
    run()
