"""``tcp:`` network broker: the transport's cross-host backend.

A copy of the JAX package's ``oryx_tpu/transport/netbroker.py`` (stdlib
only, no JAX) with its imports changed, held to it by
``tests/test_torch_netbroker.py``: the same frames on the wire, so a client
of either package talks to a server of the other, and the same segment
bytes on disk. Below, the reference's text.

The ``memory:``/``file:`` brokers coordinate through process memory or a
shared filesystem, which walls every cross-host story (replica fleets,
rolling restarts) behind NFS (docs/admin.md, the v0 decision). This module
is the wall coming down: an asyncio TCP **server** that owns a topic
directory by wrapping a local :class:`~oryx_tpu_torch.transport.topic.FileBroker`
— one process is the single writer, which also retires the file broker's
NFS append-atomicity caveat — plus a thread-safe **client** registered
under ``tcp://host:port`` in :func:`~oryx_tpu_torch.transport.topic.get_broker`,
implementing the entire :class:`~oryx_tpu_torch.transport.topic.Broker` contract:
create/delete/exists/num_partitions, key-hash-routed append with headers
(traceparent propagation unchanged), offset-paged reads, truncation, atomic
offset commits, and consumer-group sessions with **server-side** heartbeat
TTL so ``partitions_for_member`` rebalance works across hosts.

Wire protocol: length-prefixed JSON frames (4-byte big-endian length +
UTF-8 JSON body). Requests are ``{"id": n, "op": ..., <args>}``; responses
``{"id": n, "ok": true, "result": ...}`` or ``{"id": n, "ok": false,
"error": ..., "transient": bool}`` — server-side ``TopicException``s cross
the wire TYPED, so a client sees the same exception class (and transience
flag) it would from an in-process broker, and the existing
``resilience.default_policy()``/``transient_transport_error`` retry
contract carries over unchanged. Connection failures surface as plain
``OSError`` (transient by predicate); the client drops its per-thread
socket on any error and reconnects on the next call, so a broker restart
costs one retried RPC, never a stuck consumer.

Push wakeup: ``wait_for_data`` is a server-side long-poll — the caller
parks on an asyncio condition until an append (or an explicit ``wake``)
notifies it, so an idle ``tcp:`` consumer receives new data at network RTT
while a ``file:`` consumer sleeps out its poll backoff (the sub-ms state
propagation pattern of low-latency serverless dataflows, PAPERS.md
arXiv:2007.05832). Run the server with ``python -m oryx_tpu_torch.cli broker
--port N --dir D``; counters (connections, frames, bytes, per-RPC latency
histogram) live in the process metrics registry, scrapeable over the wire
through the ``metrics`` RPC (``NetBrokerClient.server_metrics()``).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import socket
import struct
import threading
import time
from collections import OrderedDict

from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import spans
from oryx_tpu_torch.transport import topic as tp

log = spans.get_logger(__name__)

#: Header bytes on every frame: big-endian unsigned length of the JSON body.
_LEN = struct.Struct(">I")

#: Server-side cap on one long-poll park (clients re-issue; a lost client
#: must never pin a waiter task forever).
_MAX_WAIT_SEC = 60.0

#: Extra client-socket patience on top of a long-poll's requested timeout.
_WAIT_GRACE_SEC = 5.0

#: Producer idempotence window: recently-applied append tokens kept for
#: retry dedup (a retry after a lost response must not double-append).
_MAX_APPLIED_TOKENS = 8192

#: Headroom reserved for the response envelope when packing read results
#: into one frame (the rest of max_frame_bytes is message budget).
_READ_FRAME_MARGIN = 65536


class _OversizeRequest(Exception):
    """A request frame over the server cap: drained and answered TYPED
    (non-transient) instead of cutting the socket — a cut would read as
    transient to the client and fuel a pointless retry storm."""

_CONNECTIONS = metrics_mod.default_registry().counter(
    "oryx_netbroker_connections_total",
    "TCP connections ever accepted by the broker server",
)
_ACTIVE = metrics_mod.default_registry().gauge(
    "oryx_netbroker_connections_active",
    "TCP connections currently open on the broker server",
)
_FRAMES = metrics_mod.default_registry().counter(
    "oryx_netbroker_frames_total",
    "RPC frames handled by the broker server, by op",
    ("op",),
)
_BYTES = metrics_mod.default_registry().counter(
    "oryx_netbroker_bytes_total",
    "Bytes moved over broker connections by direction (in=requests, "
    "out=responses)",
    ("direction",),
)
_RPC_LATENCY = metrics_mod.default_registry().histogram(
    "oryx_netbroker_rpc_latency_seconds",
    "Server-side handling latency per RPC op (frame decoded to response "
    "written)",
    ("op",),
)

#: Process defaults for tcp clients, shaped by :func:`configure` from
#: ``oryx.broker.tcp.*`` (the same configure() idiom as resilience/metrics).
_DEFAULTS = {
    "connect_timeout_sec": 10.0,
    "request_timeout_sec": 30.0,
    "max_frame_bytes": tp.MAX_REQUEST_SIZE,
}
_defaults_lock = threading.Lock()


def configure(config) -> None:
    """Adopt ``oryx.broker.tcp.*`` as process-wide client defaults
    (idempotent; every layer entry point calls this, like resilience)."""
    t = config.get_config("oryx.broker.tcp")
    with _defaults_lock:
        _DEFAULTS["connect_timeout_sec"] = t.get_float("connect-timeout-sec", 10.0)
        _DEFAULTS["request_timeout_sec"] = t.get_float("request-timeout-sec", 30.0)
        _DEFAULTS["max_frame_bytes"] = t.get_int(
            "max-frame-bytes", tp.MAX_REQUEST_SIZE
        )


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class NetBrokerServer:
    """Asyncio TCP broker server owning one topic directory.

    All durable state delegates to an inner :class:`FileBroker` — every
    blocking file op hops off the event loop through ``asyncio.to_thread``,
    and per-connection frames are handled strictly in order, so one
    connection's appends keep their order while connections stay
    independent. Consumer-group membership is held in server memory with a
    monotonic heartbeat TTL (``group_ttl_sec``): a member whose process
    died simply stops heartbeating and drops out of ``group_members`` after
    the TTL, triggering client-side rebalance — no coordinator, no shared
    filesystem, works across hosts.
    """

    def __init__(self, root: str, host: str = "0.0.0.0", port: int = 0,
                 group_ttl_sec: "float | None" = None,
                 max_frame_bytes: "int | None" = None,
                 stats_interval_sec: float = 0.0):
        self._inner = tp.FileBroker(root)
        self.root = str(root)
        self.host = host
        self.port = port  # 0 = ephemeral; resolved once serving
        self.group_ttl_sec = (
            float(group_ttl_sec) if group_ttl_sec is not None
            else tp.GROUP_MEMBER_TTL_SEC
        )
        self.max_frame_bytes = int(
            max_frame_bytes if max_frame_bytes is not None
            else _DEFAULTS["max_frame_bytes"]
        )
        self.stats_interval_sec = float(stats_interval_sec)
        # loop-confined state (touched only from the server's event loop)
        self._groups: dict[tuple[str, str], dict[str, float]] = {}
        self._conds: dict[str, asyncio.Condition] = {}
        self._wake_epoch: dict[str, int] = {}
        self._applied_tokens: "OrderedDict[str, None]" = OrderedDict()
        self._server: "asyncio.base_events.Server | None" = None
        self._loop: "asyncio.AbstractEventLoop | None" = None
        self._thread: "threading.Thread | None" = None
        self._closed = threading.Event()
        # plain tallies for the periodic stats log line (loop-confined)
        self._n_connections = 0
        self._n_frames = 0
        self._n_bytes_in = 0
        self._n_bytes_out = 0

    # -- lifecycle -----------------------------------------------------------
    async def start_serving(self) -> None:
        """Bind and start accepting (call from the owning event loop)."""
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        if self.stats_interval_sec > 0:
            self._loop.create_task(self._stats_loop())
        log.info("netbroker serving %s on %s:%d", self.root, self.host, self.port)

    def start_background(self) -> "NetBrokerServer":
        """Run the server on its own thread+loop (tests, benches, and the
        ``cli broker`` foreground both ride this)."""
        started = threading.Event()
        failure: list[BaseException] = []

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            try:
                loop.run_until_complete(self.start_serving())
            except BaseException as e:  # noqa: BLE001
                log.exception("netbroker failed to bind %s:%d",
                              self.host, self.port)
                failure.append(e)  # re-raised by the starting thread below
                started.set()
                loop.close()
                return
            started.set()
            try:
                loop.run_forever()
            finally:
                self._server.close()
                # connection handlers (and parked long-polls) still pending
                # get a clean cancel — never destroyed with the loop. The
                # cancel comes BEFORE wait_closed(): since Python 3.12.1 it
                # waits for every open connection, so a client still
                # connected would hold close() to its 10 s join timeout
                # (the reference waits first and stalls so)
                pending = asyncio.all_tasks(loop)
                for task in pending:
                    task.cancel()
                if pending:
                    loop.run_until_complete(
                        asyncio.gather(*pending, return_exceptions=True)
                    )
                loop.run_until_complete(self._server.wait_closed())
                loop.close()

        self._thread = threading.Thread(
            target=run, name="OryxNetBrokerServer", daemon=True
        )
        self._thread.start()
        if not started.wait(15):
            raise RuntimeError("netbroker server failed to start within 15s")
        if failure:
            raise failure[0]
        return self

    def close(self) -> None:
        self._closed.set()
        if self._loop is not None:
            with contextlib.suppress(RuntimeError):  # loop already closed
                self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                log.warning("netbroker server thread did not stop within 10s")

    # -- connection handling ---------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        _CONNECTIONS.inc()
        _ACTIVE.inc()
        self._n_connections += 1
        try:
            while True:
                try:
                    frame = await self._read_frame(reader)
                except _OversizeRequest as e:
                    # the oversize body was drained, so the stream is still
                    # in sync: answer typed (unaddressed — the client maps
                    # it onto its in-flight request) and keep serving
                    body = json.dumps(
                        {"id": None, "ok": False, "error": str(e),
                         "transient": False},
                        separators=(",", ":"),
                    ).encode("utf-8")
                    writer.write(_LEN.pack(len(body)) + body)
                    await writer.drain()
                    continue
                if frame is None:
                    return  # peer closed cleanly
                t0 = time.perf_counter()
                op = frame.get("op", "?")
                resp = await self._dispatch(frame, op)
                body = json.dumps(resp, separators=(",", ":")).encode("utf-8")
                writer.write(_LEN.pack(len(body)) + body)
                await writer.drain()
                self._n_frames += 1
                self._n_bytes_out += len(body) + _LEN.size
                _FRAMES.labels(op).inc()
                _BYTES.labels("out").inc(len(body) + _LEN.size)
                _RPC_LATENCY.labels(op).observe(time.perf_counter() - t0)
        except (asyncio.IncompleteReadError, ConnectionError, TimeoutError):
            log.debug("netbroker connection dropped mid-frame", exc_info=True)
        except Exception:  # noqa: BLE001 — one bad connection must not kill accept
            log.exception("netbroker connection handler failed")
        finally:
            _ACTIVE.dec()
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _read_frame(self, reader: asyncio.StreamReader) -> "dict | None":
        try:
            head = await reader.readexactly(_LEN.size)
        except asyncio.IncompleteReadError as e:
            if not e.partial:
                return None  # clean EOF between frames
            raise
        (length,) = _LEN.unpack(head)
        if length > self.max_frame_bytes:
            # drain the refused body so the next frame parses cleanly
            remaining = length
            while remaining:
                chunk = await reader.read(min(remaining, 1 << 20))
                if not chunk:
                    raise asyncio.IncompleteReadError(b"", remaining)
                remaining -= len(chunk)
            raise _OversizeRequest(
                f"request frame of {length} bytes exceeds server max "
                f"{self.max_frame_bytes}"
            )
        body = await reader.readexactly(length)
        self._n_bytes_in += length + _LEN.size
        _BYTES.labels("in").inc(length + _LEN.size)
        return json.loads(body)

    async def _dispatch(self, frame: dict, op: str) -> dict:
        rid = frame.get("id")
        handler = self._OPS.get(op)
        try:
            if handler is None:
                raise tp.TopicException(f"unknown broker op: {op!r}")
            result = await handler(self, frame)
            return {"id": rid, "ok": True, "result": result}
        except tp.TopicException as e:
            # typed over the wire: the client re-raises the same class with
            # the same transience, so retry classification is identical to
            # an in-process broker
            return {"id": rid, "ok": False, "error": str(e),
                    "transient": bool(e.transient)}
        except OSError as e:
            log.warning("netbroker op %s hit I/O error: %s", op, e)
            return {"id": rid, "ok": False,
                    "error": f"{type(e).__name__}: {e}", "transient": True}
        except Exception as e:  # noqa: BLE001 — a server bug answers typed, not a cut socket
            log.exception("netbroker op %s failed", op)
            return {"id": rid, "ok": False,
                    "error": f"{type(e).__name__}: {e}", "transient": False}

    # -- ops -------------------------------------------------------------------
    async def _op_ping(self, f: dict) -> dict:
        return {"dir": self.root, "group_ttl_sec": self.group_ttl_sec}

    async def _op_create_topic(self, f: dict) -> None:
        await asyncio.to_thread(
            self._inner.create_topic, f["topic"], int(f.get("partitions", 1))
        )

    async def _op_delete_topic(self, f: dict) -> None:
        await asyncio.to_thread(self._inner.delete_topic, f["topic"])
        await self._notify(f["topic"], wake=True)

    async def _op_topic_exists(self, f: dict) -> bool:
        return await asyncio.to_thread(self._inner.topic_exists, f["topic"])

    async def _op_num_partitions(self, f: dict) -> int:
        return await asyncio.to_thread(self._inner.num_partitions, f["topic"])

    async def _op_append(self, f: dict) -> "dict | None":
        # producer idempotence: a retried append bearing a token the server
        # already applied (response lost in flight) is acknowledged, not
        # re-appended — retries over the wire stay duplicate-free like the
        # in-process brokers, where a failed append never applied at all
        token = f.get("token")
        if token is not None and token in self._applied_tokens:
            return {"dup": True}
        await asyncio.to_thread(
            self._inner.append, f["topic"], f.get("key"), f.get("message"),
            f.get("headers"),
        )
        if token is not None:
            self._applied_tokens[token] = None
            while len(self._applied_tokens) > _MAX_APPLIED_TOKENS:
                self._applied_tokens.popitem(last=False)
        await self._notify(f["topic"])
        return None

    async def _op_read(self, f: dict) -> list:
        def read_bounded() -> list:
            msgs = self._inner.read(
                f["topic"], int(f["offset"]),
                int(f.get("max_items", 1024)), int(f.get("partition", 0)),
            )
            # byte-bound the response to the frame cap (minus envelope
            # headroom): 1024 near-cap messages would otherwise build a
            # frame the client must refuse, wedging that offset forever —
            # a trimmed read just means the next poll continues from where
            # this one stopped. At least one message always goes through
            # (any message that ARRIVED through this broker fit in an
            # append frame, so it fits here too).
            budget = self.max_frame_bytes - _READ_FRAME_MARGIN
            out: list = []
            used = 0
            for km in msgs:
                item = (
                    {"corrupt": True} if km is tp.CORRUPT_RECORD
                    else {"k": km.key, "m": km.message, "h": km.headers}
                )
                size = len(json.dumps(item, separators=(",", ":")))
                if out and used + size > budget:
                    break
                out.append(item)
                used += size
            return out

        return await asyncio.to_thread(read_bounded)

    async def _op_size(self, f: dict) -> int:
        return await asyncio.to_thread(
            self._inner.size, f["topic"], int(f.get("partition", 0))
        )

    async def _op_total_size(self, f: dict) -> int:
        return await asyncio.to_thread(self._inner.total_size, f["topic"])

    async def _op_truncate(self, f: dict) -> None:
        await asyncio.to_thread(
            self._inner.truncate, f["topic"], int(f["before_offset"]),
            int(f.get("partition", 0)),
        )

    async def _op_get_offset(self, f: dict) -> "int | None":
        return await asyncio.to_thread(
            self._inner.get_offset, f["group"], f["topic"],
            int(f.get("partition", 0)),
        )

    async def _op_set_offset(self, f: dict) -> None:
        await asyncio.to_thread(
            self._inner.set_offset, f["group"], f["topic"], int(f["offset"]),
            int(f.get("partition", 0)),
        )

    async def _op_join_group(self, f: dict) -> None:
        # server-side session: the heartbeat clock is THIS process's
        # monotonic time, so membership works across hosts with no shared
        # filesystem and no client clock agreement
        key = (f["group"], f["topic"])
        self._groups.setdefault(key, {})[f["member_id"]] = time.monotonic()

    async def _op_leave_group(self, f: dict) -> None:
        self._groups.get((f["group"], f["topic"]), {}).pop(f["member_id"], None)

    async def _op_group_members(self, f: dict) -> list:
        now = time.monotonic()
        members = self._groups.get((f["group"], f["topic"]), {})
        live = sorted(m for m, hb in members.items()
                      if now - hb < self.group_ttl_sec)
        # drop expired sessions eagerly so the table stays bounded
        for m in list(members):
            if now - members[m] >= self.group_ttl_sec:
                del members[m]
        return live

    async def _op_wait_for_data(self, f: dict) -> dict:
        """Long-poll: parked on the topic's condition until an append (or an
        explicit wake) notifies, the timeout lapses, or the cap trips. The
        push path that makes ``tcp:`` wakeups land at RTT instead of the
        file broker's sleep backoff."""
        name = f["topic"]
        seen = int(f["seen_total"])
        timeout = min(max(float(f.get("timeout", 0.0)), 0.0), _MAX_WAIT_SEC)
        cond = self._cond(name)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            # epoch BEFORE the size check: every notify bumps it, so an
            # append that lands between the total_size below and the
            # cond acquisition flips the epoch and the re-check under the
            # lock skips the wait — no lost wakeup, no timeout-length stall
            epoch = self._wake_epoch.get(name, 0)
            total = await asyncio.to_thread(self._inner.total_size, name)
            if total > seen or self._wake_epoch.get(name, 0) != epoch:
                return {"woken": True, "total": total}
            remaining = deadline - loop.time()
            if remaining <= 0:
                return {"woken": False, "total": total}
            async with cond:
                if self._wake_epoch.get(name, 0) != epoch:
                    continue
                try:
                    await asyncio.wait_for(cond.wait(), remaining)
                except (asyncio.TimeoutError, TimeoutError):
                    return {"woken": False, "total": total}

    async def _op_wake(self, f: dict) -> None:
        await self._notify(f["topic"], wake=True)

    async def _op_metrics(self, f: dict) -> dict:
        return {"text": metrics_mod.default_registry().render()}

    _OPS = {
        "ping": _op_ping,
        "create_topic": _op_create_topic,
        "delete_topic": _op_delete_topic,
        "topic_exists": _op_topic_exists,
        "num_partitions": _op_num_partitions,
        "append": _op_append,
        "read": _op_read,
        "size": _op_size,
        "total_size": _op_total_size,
        "truncate": _op_truncate,
        "get_offset": _op_get_offset,
        "set_offset": _op_set_offset,
        "join_group": _op_join_group,
        "leave_group": _op_leave_group,
        "group_members": _op_group_members,
        "wait_for_data": _op_wait_for_data,
        "wake": _op_wake,
        "metrics": _op_metrics,
    }

    # -- wakeup plumbing -------------------------------------------------------
    def _cond(self, name: str) -> asyncio.Condition:
        cond = self._conds.get(name)
        if cond is None:
            cond = self._conds[name] = asyncio.Condition()
        return cond

    async def _notify(self, name: str, wake: bool = False) -> None:
        # every notify bumps the epoch (append, delete, explicit wake):
        # parked waiters distinguish "something happened while I was between
        # my size check and cond.wait" from a quiet topic (loop-confined)
        self._wake_epoch[name] = self._wake_epoch.get(name, 0) + 1
        cond = self._cond(name)
        async with cond:
            cond.notify_all()

    async def _stats_loop(self) -> None:
        while True:
            await asyncio.sleep(self.stats_interval_sec)
            log.info(
                "netbroker stats: connections=%d active=%d frames=%d "
                "bytes_in=%d bytes_out=%d",
                self._n_connections, int(_ACTIVE.value), self._n_frames,
                self._n_bytes_in, self._n_bytes_out,
            )


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class NetBrokerClient(tp.Broker):
    """Thread-safe ``tcp://`` broker client.

    One lazily-connected socket per calling thread (a consumer's long-poll
    never blocks a producer's append), strictly sequential request/response
    per socket. Any transport failure drops that thread's socket and
    surfaces as ``OSError`` (transient by ``transient_transport_error``);
    the next call reconnects — so the producer/consumer retry wrappers
    absorb broker restarts without new machinery. Typed server errors
    re-raise as :class:`TopicException` with the server's transience flag.
    """

    def __init__(self, host: str, port: int,
                 connect_timeout_sec: "float | None" = None,
                 request_timeout_sec: "float | None" = None,
                 max_frame_bytes: "int | None" = None):
        self.host = host
        self.port = int(port)
        # explicit overrides win; otherwise the PROCESS defaults are read
        # at call time, not snapshotted here — get_broker caches clients
        # forever, and a client built before configure() ran must still
        # honor the config once it has (layer startup order varies)
        self._connect_timeout_override = connect_timeout_sec
        self._request_timeout_override = request_timeout_sec
        self._max_frame_override = max_frame_bytes
        self._local = threading.local()

    @property
    def connect_timeout_sec(self) -> float:
        if self._connect_timeout_override is not None:
            return float(self._connect_timeout_override)
        with _defaults_lock:
            return float(_DEFAULTS["connect_timeout_sec"])

    @property
    def request_timeout_sec(self) -> float:
        if self._request_timeout_override is not None:
            return float(self._request_timeout_override)
        with _defaults_lock:
            return float(_DEFAULTS["request_timeout_sec"])

    @property
    def max_frame_bytes(self) -> int:
        if self._max_frame_override is not None:
            return int(self._max_frame_override)
        with _defaults_lock:
            return int(_DEFAULTS["max_frame_bytes"])

    # -- socket plumbing -------------------------------------------------------
    def _sock(self) -> socket.socket:
        s = getattr(self._local, "sock", None)
        if s is None:
            s = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout_sec
            )
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(self.request_timeout_sec)
            self._local.sock = s
            self._local.rid = 0
        return s

    def _drop(self) -> None:
        s = getattr(self._local, "sock", None)
        self._local.sock = None
        if s is not None:
            with contextlib.suppress(OSError):
                s.close()

    @staticmethod
    def _recv_exactly(s: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("broker closed the connection")
            buf += chunk
        return bytes(buf)

    def _rpc(self, op: str, sock_timeout: "float | None" = None, **args):
        """One request/response round trip on this thread's socket."""
        payload = {"op": op, **args}
        try:
            s = self._sock()
            rid = self._local.rid = self._local.rid + 1
            payload["id"] = rid
            body = json.dumps(payload, separators=(",", ":")).encode("utf-8")
            if len(body) > self.max_frame_bytes:
                raise tp.TopicException(
                    f"request frame of {len(body)} bytes exceeds max "
                    f"{self.max_frame_bytes}"
                )
            # per-call timeout: re-read every RPC so a configure() after
            # this client was cached still takes effect
            s.settimeout(
                sock_timeout if sock_timeout is not None
                else self.request_timeout_sec
            )
            s.sendall(_LEN.pack(len(body)) + body)
            head = self._recv_exactly(s, _LEN.size)
            (length,) = _LEN.unpack(head)
            if length > self.max_frame_bytes:
                raise tp.TopicException(
                    f"response frame of {length} bytes exceeds max "
                    f"{self.max_frame_bytes}", transient=True,
                )
            resp = json.loads(self._recv_exactly(s, length))
        except (tp.TopicException, OSError):
            self._drop()
            raise
        except ValueError as e:
            # undecodable response = protocol desync: reconnect and retry
            self._drop()
            raise tp.TopicException(
                f"broker protocol error: {e}", transient=True
            ) from e
        if resp.get("id") != payload["id"]:
            if resp.get("id") is None and not resp.get("ok", True):
                # unaddressed error frame: the server refused the request
                # before it could parse an id (frame over the server cap).
                # Requests are strictly sequential per socket and the body
                # was drained server-side, so it applies to THIS request
                # and the stream is still in sync — typed raise, keep the
                # socket, honor the server's transience verdict
                raise tp.TopicException(
                    str(resp.get("error")),
                    transient=bool(resp.get("transient")),
                )
            self._drop()
            raise tp.TopicException(
                f"broker response id mismatch ({resp.get('id')!r} != "
                f"{payload['id']!r})", transient=True,
            )
        if not resp.get("ok"):
            raise tp.TopicException(
                str(resp.get("error")), transient=bool(resp.get("transient"))
            )
        return resp.get("result")

    # -- Broker interface ------------------------------------------------------
    def ping(self) -> dict:
        return self._rpc("ping")

    def create_topic(self, name: str, partitions: int = 1) -> None:
        self._rpc("create_topic", topic=name, partitions=partitions)

    def delete_topic(self, name: str) -> None:
        self._rpc("delete_topic", topic=name)

    def topic_exists(self, name: str) -> bool:
        return bool(self._rpc("topic_exists", topic=name))

    def num_partitions(self, name: str) -> int:
        return int(self._rpc("num_partitions", topic=name))

    def append(self, topic: str, key, message, headers: "dict | None" = None,
               token: "str | None" = None) -> None:
        if isinstance(message, (bytes, bytearray)):
            # JSON frames carry str payloads only — fail typed and local,
            # like the file broker, not with json.dumps's TypeError
            raise tp.TopicException(
                "bytes messages are not supported by the tcp: broker "
                "(JSON frame format); encode to str first"
            )
        args = {"topic": topic, "key": key, "message": message,
                "headers": headers}
        if token is not None:
            # idempotence token (one per logical send, TopicProducerImpl):
            # the server dedups a retried append whose response was lost
            args["token"] = token
        self._rpc("append", **args)

    def read(self, topic: str, offset: int, max_items: int = 1024,
             partition: int = 0) -> list:
        records = self._rpc("read", topic=topic, offset=offset,
                            max_items=max_items, partition=partition)
        return [
            tp.CORRUPT_RECORD if r.get("corrupt")
            else tp.KeyMessage(r.get("k"), r.get("m"), r.get("h"))
            for r in records
        ]

    def size(self, topic: str, partition: int = 0) -> int:
        return int(self._rpc("size", topic=topic, partition=partition))

    def total_size(self, topic: str) -> int:
        return int(self._rpc("total_size", topic=topic))

    def truncate(self, topic: str, before_offset: int, partition: int = 0) -> None:
        self._rpc("truncate", topic=topic, before_offset=before_offset,
                  partition=partition)

    def get_offset(self, group: str, topic: str, partition: int = 0) -> "int | None":
        result = self._rpc("get_offset", group=group, topic=topic,
                           partition=partition)
        return None if result is None else int(result)

    def set_offset(self, group: str, topic: str, offset: int, partition: int = 0) -> None:
        self._rpc("set_offset", group=group, topic=topic, offset=offset,
                  partition=partition)

    def join_group(self, group: str, topic: str, member_id: str) -> None:
        self._rpc("join_group", group=group, topic=topic, member_id=member_id)

    def leave_group(self, group: str, topic: str, member_id: str) -> None:
        self._rpc("leave_group", group=group, topic=topic, member_id=member_id)

    def group_members(self, group: str, topic: str) -> list:
        return list(self._rpc("group_members", group=group, topic=topic))

    def wait_for_data(self, topic: str, seen_total: int, timeout: float,
                      stop=None) -> None:
        """Server-side long-poll with idempotent re-subscribe: each call is
        a fresh subscription, so a reconnect (or a restarted server) costs
        nothing to re-establish. Errors degrade to a short local wait — the
        consumer's read path (which rides the retry policy) is where a dead
        broker becomes loud, never the advisory wait."""
        if stop is not None and stop.is_set():
            return
        try:
            self._rpc(
                "wait_for_data",
                # socket patience covers the server-side park plus RTT
                sock_timeout=min(timeout, _MAX_WAIT_SEC) + _WAIT_GRACE_SEC,
                topic=topic, seen_total=seen_total, timeout=timeout,
            )
        except (tp.TopicException, OSError):
            log.debug("tcp wait_for_data degraded to local wait", exc_info=True)
            # brief local wait so a down broker doesn't hot-spin the poll loop
            pause = min(max(timeout, 0.0), 0.05)
            if stop is not None:
                stop.wait(pause)
            elif pause > 0:
                time.sleep(pause)

    def wake(self, topic: str) -> None:
        try:
            self._rpc("wake", topic=topic)
        except (tp.TopicException, OSError):
            log.debug("tcp wake failed (best-effort)", exc_info=True)

    def server_metrics(self) -> str:
        """The server process's Prometheus text exposition, over the wire
        (the ``/metrics``-equivalent for a broker with no HTTP surface)."""
        return str(self._rpc("metrics")["text"])

    def close(self) -> None:
        """Drop this THREAD's socket (others close lazily on next error)."""
        self._drop()


def client_from_url(url: str) -> NetBrokerClient:
    """``tcp://host:port`` -> client (get_broker's tcp hook)."""
    rest = url[len("tcp://"):]
    host, sep, port_s = rest.rpartition(":")
    if not sep or not host or not port_s.isdigit():
        raise tp.TopicException(f"bad tcp broker url: {url} "
                                "(expected tcp://host:port)")
    return NetBrokerClient(host, int(port_s))
