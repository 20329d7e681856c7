"""Traffic generator: sustained randomized load against a serving cluster.

A port of the JAX package's ``oryx_tpu/tools/traffic.py`` (host code, no
device), itself the equivalent of the reference's TrafficUtil + ALSEndpoint
(app/oryx-app-serving/src/test/java/.../traffic/TrafficUtil.java:56-150,
als/ALSEndpoint.java): N worker threads send requests to random hosts at
exponentially-distributed intervals, choosing a random weighted endpoint per
request (ALS mix: /recommend, /similarity, /estimate, /pref), and report
request counts, error counts, and latency percentiles once a minute.

Only the transport differs: each worker holds one keep-alive stdlib
``http.client.HTTPConnection`` per host. A connection the server has closed
while it sat idle is replaced before its next request; after any failed
request the connection is dropped and the next one to that host connects
anew. A refused or reset connection counts as an exception.

Usage::

    python -m oryx_tpu_torch.tools.traffic host1:8080,host2:8080 \\
        --interval-ms 10 --threads 4 --users 1000 --items 5000
"""

from __future__ import annotations

import argparse
import http.client
import logging
import select
import threading
import time
from urllib.parse import quote

import numpy as np

log = logging.getLogger(__name__)


class _Endpoint:
    def __init__(self, name: str, relative_prob: float, make_request):
        self.name = name
        self.relative_prob = relative_prob
        self.make_request = make_request
        self.count = 0
        self.latencies_ms: list[float] = []

    def record(self, ms: float) -> None:
        self.count += 1
        self.latencies_ms.append(ms)
        if len(self.latencies_ms) > 100_000:
            del self.latencies_ms[: 50_000]


def build_als_endpoints(n_users: int, n_items: int) -> list[_Endpoint]:
    """The reference's ALS endpoint mix (ALSEndpoint.buildALSEndpoints)."""

    def recommend(rng):
        return "GET", f"/recommend/u{rng.integers(n_users)}", None

    def similarity(rng):
        return "GET", f"/similarity/i{rng.integers(n_items)}", None

    def estimate(rng):
        return "GET", f"/estimate/u{rng.integers(n_users)}/i{rng.integers(n_items)}", None

    def pref(rng):
        return (
            "POST",
            f"/pref/u{rng.integers(n_users)}/i{rng.integers(n_items)}",
            str(rng.integers(1, 5)),
        )

    return [
        _Endpoint("recommend", 0.6, recommend),
        _Endpoint("similarity", 0.2, similarity),
        _Endpoint("estimate", 0.1, estimate),
        _Endpoint("pref", 0.1, pref),
    ]


def _closed_by_peer(conn: http.client.HTTPConnection) -> bool:
    """An idle keep-alive socket that reads as ready has been closed (or
    sent something unasked): it must not carry the next request."""
    if conn.sock is None:
        return False
    try:
        return bool(select.select([conn.sock], [], [], 0)[0])
    except (OSError, ValueError):
        return True


#: What a path keeps unquoted (RFC 3986 reserved characters and ``%``):
#: spaces and other characters a request line cannot hold are
#: percent-encoded, as httpx encodes them.
_PATH_SAFE = "/%:@!$&'()*+,;=?#[]~"


def _request(conns: dict, host: str, method: str, path: str, body) -> int:
    """One request on the worker's keep-alive connection to ``host``;
    returns the status. On any failure the connection is dropped."""
    conn = conns.get(host)
    if conn is not None and _closed_by_peer(conn):
        conn.close()
        conn = None
    if conn is None:
        conn = conns[host] = http.client.HTTPConnection(host, timeout=30)
    try:
        conn.request(method, quote(path, safe=_PATH_SAFE),
                     body=body.encode() if isinstance(body, str) else body)
        resp = conn.getresponse()
        resp.read()
        return resp.status
    except BaseException:
        conns.pop(host, None)
        conn.close()
        raise


class TrafficRunner:
    def __init__(self, hosts, endpoints, interval_ms: float, threads: int, duration_sec: float | None = None):
        self.hosts = hosts
        self.endpoints = endpoints
        self.interval_ms = interval_ms
        self.threads = threads
        self.duration_sec = duration_sec
        self.requests = 0
        self.client_errors = 0
        self.server_errors = 0
        self.exceptions = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()

    def run(self) -> None:
        probs = np.asarray([e.relative_prob for e in self.endpoints])
        probs = probs / probs.sum()
        per_client_interval = self.threads * self.interval_ms

        def worker(i: int):
            rng = np.random.default_rng(i ^ int(time.time()))
            conns: dict[str, http.client.HTTPConnection] = {}
            try:
                while not self._stop.is_set():
                    if per_client_interval > 0:
                        self._stop.wait(rng.exponential(per_client_interval) / 1000.0)
                        if self._stop.is_set():
                            break
                    host = self.hosts[rng.integers(len(self.hosts))]
                    endpoint = self.endpoints[rng.choice(len(self.endpoints), p=probs)]
                    method, path, body = endpoint.make_request(rng)
                    t0 = time.perf_counter()
                    try:
                        status = _request(conns, host, method, path, body)
                        ms = 1000 * (time.perf_counter() - t0)
                        with self._lock:
                            self.requests += 1
                            if status >= 500:
                                self.server_errors += 1
                            elif status >= 400:
                                self.client_errors += 1
                            else:
                                endpoint.record(ms)
                    except Exception:  # noqa: BLE001 - traffic must keep flowing
                        with self._lock:
                            self.exceptions += 1
            finally:
                for conn in conns.values():
                    conn.close()

        workers = [
            threading.Thread(target=worker, args=(i,), daemon=True)
            for i in range(self.threads)
        ]
        start = time.monotonic()
        for w in workers:
            w.start()
        try:
            while not self._stop.is_set():
                wait = 60.0
                if self.duration_sec is not None:
                    wait = min(wait, self.duration_sec - (time.monotonic() - start))
                if wait > 0:
                    self._stop.wait(wait)
                self.report()
                if self.duration_sec and time.monotonic() - start >= self.duration_sec:
                    break
        except KeyboardInterrupt:
            pass
        finally:
            self._stop.set()
            for w in workers:
                w.join(timeout=5)
            self.report()

    def stop(self) -> None:
        self._stop.set()

    def report(self) -> None:
        with self._lock:
            log.info(
                "requests=%d clientErrors=%d serverErrors=%d exceptions=%d",
                self.requests, self.client_errors, self.server_errors, self.exceptions,
            )
            for e in self.endpoints:
                if e.latencies_ms:
                    lat = np.asarray(e.latencies_ms)
                    log.info(
                        "  %-12s n=%-7d p50=%.1fms p90=%.1fms p99=%.1fms",
                        e.name, e.count,
                        np.percentile(lat, 50), np.percentile(lat, 90),
                        np.percentile(lat, 99),
                    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Oryx traffic generator")
    parser.add_argument("hosts", help="comma-separated host:port pairs")
    parser.add_argument("--interval-ms", type=float, default=10.0)
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--duration-sec", type=float, default=None)
    parser.add_argument("--users", type=int, default=1000)
    parser.add_argument("--items", type=int, default=5000)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    runner = TrafficRunner(
        args.hosts.split(","),
        build_als_endpoints(args.users, args.items),
        args.interval_ms,
        args.threads,
        args.duration_sec,
    )
    runner.run()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
