#!/usr/bin/env python3
"""Time the port's ``tcp:`` broker from a client on the same host.

    python3 netbroker_rpc.py [--n 20000] [--consumers 4]

Starts ``python -m oryx_tpu_torch.cli broker`` in a process of its own on a
fresh directory, then times from this process, one op after another:
``ping``, ``Broker.append``, ``TopicProducerImpl.send`` (``--n`` of each)
and paged ``read`` of the appended messages, 4,096 a page. Then the same
``send`` while ``--consumers`` ``topic-tail`` processes follow the topic
from ``earliest`` (each parked in the broker's ``wait_for_data`` long-poll
between reads, as every consumer of a deployment is). Prints the host's
``nvidia-smi --query-gpu=name,power.limit,compute_mode`` line where there
is one, the CPU count, and one JSON line of microseconds per op. Imports
no torch and no JAX: the broker and its clients are pure transport.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.transport import netbroker
from oryx_tpu_torch.transport import topic as tp

ROOT = Path(__file__).resolve().parent
CLI = [sys.executable, "-m", "oryx_tpu_torch.cli"]


def gpu_line() -> "str | None":
    if shutil.which("nvidia-smi") is None:
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def per_op_us(fn, n: int) -> float:
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=20_000)
    parser.add_argument("--consumers", type=int, default=4)
    args = parser.parse_args()
    smi = gpu_line()
    if smi is not None:
        print(smi, flush=True)
    port = ioutils.choose_free_port()
    url = f"tcp://127.0.0.1:{port}"
    procs = []
    with tempfile.TemporaryDirectory(prefix="oryx-rpc-") as tmp:
        try:
            procs.append(subprocess.Popen(
                [*CLI, "broker", "--port", str(port), "--dir", f"{tmp}/topics",
                 "--host", "127.0.0.1"], cwd=ROOT,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
            client = netbroker.NetBrokerClient("127.0.0.1", port)
            deadline = time.monotonic() + 60
            while True:
                try:
                    client.ping()
                    break
                except OSError:
                    if time.monotonic() > deadline or procs[0].poll() is not None:
                        raise
                    time.sleep(0.05)
            for topic in ("A", "B", "C"):
                client.create_topic(topic)
            line = "u12345,i6789,1,1760000000000"
            out = {"n": args.n, "cpus": os.cpu_count(), "nvidia_smi": smi}
            out["ping_us"] = per_op_us(lambda i: client.ping(), args.n)
            out["append_us"] = per_op_us(lambda i: client.append("A", None, line), args.n)
            producer = tp.TopicProducerImpl(url, "B")
            out["send_us"] = per_op_us(lambda i: producer.send(None, line), args.n)
            t0 = time.perf_counter()
            read = 0
            while read < args.n:
                read += len(client.read("A", read, 4096))
            out["read_us_per_message"] = (time.perf_counter() - t0) / args.n * 1e6
            # the same sends with consumers in processes of their own
            conf = Path(tmp) / "tail.conf"
            conf.write_text(f'oryx.input-topic.broker = "{url}"\n'
                            f'oryx.input-topic.message.topic = "C"\n')
            for _ in range(args.consumers):
                procs.append(subprocess.Popen(
                    [*CLI, "topic-tail", "--conf", str(conf), "--which", "input"],
                    cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
            time.sleep(5.0)  # the consumers import and park in their long-polls
            client.append("C", None, line)
            producer_c = tp.TopicProducerImpl(url, "C")
            out["consumers"] = args.consumers
            out["send_with_consumers_us"] = per_op_us(
                lambda i: producer_c.send(None, line), args.n)
            print(json.dumps(out), flush=True)
        finally:
            for p in reversed(procs):
                p.terminate()
            for p in procs:
                try:
                    p.wait(30)
                except subprocess.TimeoutExpired:
                    p.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
