"""Topic transport: the framework's data plane.

A copy of the JAX package's ``oryx_tpu/transport/topic.py`` (host code, no
JAX), held to it by ``tests/test_torch_transport.py``: the same framing
bytes, so a ``file:`` log or offset store written by either package is read
whole by the other. A ``tcp://host:port`` URL resolves to a cached
client of the port's network broker
(:mod:`oryx_tpu_torch.transport.netbroker`), as in the reference.

TPU-native replacement for the reference's Kafka/ZooKeeper messaging layer
(framework/kafka-util/.../KafkaUtils.java:63-188 and
ConsumeDataIterator.java:30-77). Two backends behind one URL scheme:

  * ``memory:`` — in-process broker (a process-wide registry of append-only
    logs with condition-variable wakeup). The default for tests and
    single-process deployments, standing in for the reference ITs'
    LocalKafkaBroker.
  * ``file:<dir>`` — durable broker: each topic is an append-only JSONL log
    on disk, readable by other processes on the same filesystem; offsets are
    line indices. This is the host-side pub-sub that rides shared storage —
    cross-host deployments point it at a network filesystem (DCN transport),
    while device-side collectives stay inside pjit programs.

Semantics kept from the reference:
  * topics are append-only logs; consumers track offsets; layers persist
    consumed positions through the broker's OffsetStore *after* processing
    each batch (UpdateOffsetsFn semantics — see AbstractLayer), keyed by
    ``oryx.id``;
  * consuming from ``earliest`` replays the whole log (how speed/serving
    rebuild model state, SpeedLayer.java:108-110);
  * a blocking consume iterator with exponential poll backoff 1→1000 ms and
    wakeup-based close (ConsumeDataIterator.java:30-77);
  * producers enforce a transport-level max message size (Kafka
    max.request.size = 1<<26); topics support prefix truncation in lieu of
    Kafka retention.

FileBroker writes each record as one flock-guarded O_APPEND write (atomic
between cooperating local processes; NFS append atomicity is not guaranteed —
use one writer per topic there). Records use a **versioned framing** — magic
+ length prefix + CRC32 ahead of the JSON payload — so truncation and
bit-flips are detected, not silently consumed; legacy bare-JSON logs read
back-compatibly. Durability is policy-driven (``oryx.broker.file.fsync`` =
``never``/``interval``/``always``), and the first touch of each partition
runs **torn-tail recovery**: a trailing partial record (a writer killed
mid-append, or a crash under a lazy fsync policy) is scanned, truncated,
and counted (``oryx_broker_torn_tail_records_total``) before any new
append can splice into it. The ``tcp:`` netbroker wraps FileBroker as its
single writer, so it inherits all of this for free.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import uuid
import zlib
from pathlib import Path
from typing import Iterator

try:
    import fcntl
except ImportError:  # pragma: no cover — non-posix fallback (no flock)
    fcntl = None

from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import blackbox
from oryx_tpu_torch.common import faults
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import resilience
from oryx_tpu_torch.common import spans

log = spans.get_logger(__name__)

_PRODUCED = metrics_mod.default_registry().counter(
    "oryx_topic_produced_total",
    "Messages produced to a topic",
    ("topic",),
)
_SEND_FAILURES = metrics_mod.default_registry().counter(
    "oryx_topic_send_failures_total",
    "Producer sends that raised (oversize or broker append failure)",
    ("topic",),
)
_CONSUMED = metrics_mod.default_registry().counter(
    "oryx_topic_consumed_total",
    "Messages handed to consumers from a topic",
    ("topic",),
)
_FSYNCS = metrics_mod.default_registry().counter(
    "oryx_broker_fsyncs_total",
    "Log fsyncs issued by the file broker (oryx.broker.file.fsync policy)",
)
_TORN_TAIL = metrics_mod.default_registry().counter(
    "oryx_broker_torn_tail_records_total",
    "Partial trailing records truncated by open-time log recovery",
    ("topic",),
)
# same family the microbatch pump counts into (idempotent re-registration);
# the consumer iterator counts skipped corrupt records under tier="transport"
_CORRUPT_CONSUMED = metrics_mod.default_registry().counter(
    "oryx_corrupt_records_total",
    "Corrupt input-topic records dropped by the microbatch pump",
    ("tier",),
)


def configure(config) -> None:
    """Adopt ``oryx.broker.file.*`` process-wide (the resilience idiom:
    layers, the serving app, and the broker CLI all call this, so the fsync
    policy applies to every FileBroker instance — including the one inside
    a ``tcp:`` netbroker server — without per-instance plumbing)."""
    global _fsync_policy, _fsync_interval_sec
    policy = config.get_string("oryx.broker.file.fsync", "never")
    if policy not in ("never", "interval", "always"):
        raise TopicException(
            f"oryx.broker.file.fsync must be never/interval/always, "
            f"got {policy!r}"
        )
    interval_ms = config.get_float("oryx.broker.file.fsync-interval-ms", 100.0)
    _fsync_interval_sec = max(0.0, interval_ms) / 1000.0
    _fsync_policy = policy


#: process-wide fsync policy for FileBroker appends (see configure);
#: plain module globals written under the GIL, read per append
_fsync_policy = "never"
_fsync_interval_sec = 0.1


def _flock(fd: int, op: int) -> None:
    if fcntl is not None:
        fcntl.flock(fd, op)


class TopicException(Exception):
    """Transport-level failure. ``transient=True`` marks conditions a retry
    can reasonably outlast (broker briefly unreachable); the default False
    covers the permanent ones (topic missing, oversized message)."""

    def __init__(self, *args, transient: bool = False):
        super().__init__(*args)
        self.transient = transient


def transient_transport_error(exc: BaseException) -> bool:
    """The transport retry predicate: I/O errors (shared-FS hiccups under
    the ``file:`` broker, injected faults) and explicitly-transient
    TopicExceptions. Missing topics and oversize sends stay fatal."""
    if isinstance(exc, TopicException):
        return exc.transient
    return isinstance(exc, OSError)


def offset_op(fn, stop: "threading.Event | None" = None):
    """One offset-store read/write under the transport retry contract:
    fault site ``broker.offset``, transient failures retried by the process
    policy. THE shared commit-path wrapper — the lambda tiers, the serving
    layer's committed-resume loop, and the consumer's stored-offset lookup
    all ride this one definition, so the retry contract cannot silently
    diverge between tiers."""

    def _do():
        faults.maybe_fail("broker.offset")
        return fn()

    return resilience.default_policy().call(
        "broker.offset", _do, retryable=transient_transport_error, stop=stop,
    )


#: Seconds after which a consumer-group member with no heartbeat is dropped
#: from partition assignment (Kafka session.timeout.ms equivalent).
GROUP_MEMBER_TTL_SEC = 30.0


def partition_for_key(key, n_partitions: int, fallback: int = 0) -> int:
    """Stable key→partition routing (Kafka's hash-partitioner equivalent):
    same key always lands on the same partition, so per-key ordering holds.
    ``fallback`` routes None keys (callers pass a round-robin counter)."""
    if n_partitions <= 1:
        return 0
    if key is None:
        return fallback % n_partitions
    return zlib.crc32(str(key).encode("utf-8")) % n_partitions


def partitions_for_member(member_id: str, members: list[str], n_partitions: int) -> list[int]:
    """Deterministic round-robin partition assignment over the sorted live
    membership (the stand-in for Kafka's group rebalance protocol)."""
    if not members or member_id not in members:
        return []
    rank = sorted(members).index(member_id)
    return [p for p in range(n_partitions) if p % len(members) == rank]


#: Placeholder returned for a corrupt log record so offsets stay aligned;
#: ConsumeDataIterator filters it out by identity.
CORRUPT_RECORD = KeyMessage(None, None)


# ---------------------------------------------------------------------------
# FileBroker record framing (version 1)
# ---------------------------------------------------------------------------

#: v1 frame: ``O1 <payload_len> <crc32:08x> <json payload>\n``. The length
#: prefix catches truncation/splices, the CRC catches bit-flips, and the
#: line stays newline-terminated so the byte index and offset model are
#: unchanged. Legacy logs (bare ``{...}`` JSON lines) read back-compatibly.
_FRAME_MAGIC = b"O1 "


def frame_record(payload: bytes) -> bytes:
    """One framed, newline-terminated log line for a JSON payload."""
    return b"O1 %d %08x " % (len(payload), zlib.crc32(payload)) + payload + b"\n"


def decode_record(raw: bytes, topic: str = "?") -> KeyMessage:
    """One log line (no trailing newline) → KeyMessage, or CORRUPT_RECORD.

    v1 frames are validated (length prefix AND CRC32) before the JSON is
    trusted; bare ``{`` lines take the legacy path. Anything else — torn
    splices, flipped bits, foreign garbage — maps to CORRUPT_RECORD so
    offsets stay aligned and consumers skip exactly the bad record."""
    payload = raw
    if raw.startswith(_FRAME_MAGIC):
        parts = raw.split(b" ", 3)
        if len(parts) != 4:
            log.warning("corrupt framed record in topic %s (bad header)", topic)
            return CORRUPT_RECORD
        _, len_s, crc_s, payload = parts
        try:
            want_len, want_crc = int(len_s), int(crc_s, 16)
        except ValueError:
            log.warning("corrupt framed record in topic %s (bad header)", topic)
            return CORRUPT_RECORD
        if len(payload) != want_len or zlib.crc32(payload) != want_crc:
            log.warning(
                "corrupt framed record in topic %s (CRC/length mismatch)",
                topic,
            )
            return CORRUPT_RECORD
    try:
        d = json.loads(payload)
        return KeyMessage(d["k"], d["m"], d.get("h"))
    except (json.JSONDecodeError, KeyError, UnicodeDecodeError, TypeError):
        log.warning("skipping corrupt record in topic %s", topic)
        return CORRUPT_RECORD


# ---------------------------------------------------------------------------
# Broker interface + registry
# ---------------------------------------------------------------------------


class Broker:
    """create/delete/exists + partitioned log access for one transport
    endpoint (KafkaUtils equivalent). Topics are sets of append-only partition
    logs; producers route by key hash (partition_for_key), consumers read
    per-partition offsets. Single-partition topics (the default) behave as one
    plain log."""

    def create_topic(self, name: str, partitions: int = 1) -> None:
        raise NotImplementedError

    def delete_topic(self, name: str) -> None:
        raise NotImplementedError

    def topic_exists(self, name: str) -> bool:
        raise NotImplementedError

    def num_partitions(self, name: str) -> int:
        raise NotImplementedError

    def append(self, topic: str, key, message, headers: "dict | None" = None,
               token: "str | None" = None) -> None:
        """Route by key hash to a partition and append (None key round-robins).
        ``headers`` is transport metadata delivered back on the KeyMessage
        (trace context rides here, never inside the payload). ``token`` is an
        optional idempotence token: retry wrappers pass ONE token per logical
        send, and a broker MAY dedup repeated appends bearing it (the tcp
        broker does — a retry after a lost response must not double-append).
        In-process/file brokers ignore it: their 'failed' appends never
        applied, so retries are naturally safe."""
        raise NotImplementedError

    def read(
        self, topic: str, offset: int, max_items: int = 1024, partition: int = 0
    ) -> list[KeyMessage]:
        raise NotImplementedError

    def size(self, topic: str, partition: int = 0) -> int:
        """Latest offset of one partition (messages ever appended to it)."""
        raise NotImplementedError

    def total_size(self, topic: str) -> int:
        """Sum of all partition sizes (poll-wakeup bookkeeping)."""
        return sum(self.size(topic, p) for p in range(self.num_partitions(topic)))

    def truncate(self, topic: str, before_offset: int, partition: int = 0) -> None:
        """Drop messages below the given offset (retention stand-in). Offsets
        are stable: reads below the new base return nothing."""
        raise NotImplementedError

    def wait_for_data(self, topic: str, seen_total: int, timeout: float, stop=None) -> None:
        """Block until the topic's total size may exceed ``seen_total``,
        timeout elapses, or ``stop`` (a threading.Event) is set."""
        if stop is not None:
            stop.wait(timeout)
        else:
            time.sleep(timeout)

    def wake(self, topic: str) -> None:
        """Wake blocked wait_for_data callers (consumer.wakeup())."""

    # offset store (ZK-equivalent control plane, KafkaUtils.java:120-188)
    def get_offset(self, group: str, topic: str, partition: int = 0) -> int | None:
        raise NotImplementedError

    def set_offset(self, group: str, topic: str, offset: int, partition: int = 0) -> None:
        raise NotImplementedError

    # consumer groups (partition fan-out across cooperating consumers,
    # KafkaUtils.java:63-107 / Kafka group membership equivalent)
    def join_group(self, group: str, topic: str, member_id: str) -> None:
        """Register/heartbeat a member; call at least every GROUP_MEMBER_TTL_SEC."""
        raise NotImplementedError

    def leave_group(self, group: str, topic: str, member_id: str) -> None:
        raise NotImplementedError

    def group_members(self, group: str, topic: str) -> list[str]:
        """Live (heartbeat within TTL) member ids, sorted."""
        raise NotImplementedError


_memory_brokers: dict[str, "MemoryBroker"] = {}
_memory_lock = threading.Lock()
_tcp_clients: dict[str, Broker] = {}
_tcp_lock = threading.Lock()


def get_broker(url: str) -> Broker:
    """Resolve a broker from a config URL: ``memory:[name]`` (in-process),
    ``file:<dir>`` (shared-filesystem durable log), or ``tcp://host:port``
    (network broker server — transport/netbroker.py)."""
    if url.startswith("memory:"):
        name = url[len("memory:"):] or "default"
        with _memory_lock:
            b = _memory_brokers.get(name)
            if b is None:
                b = _memory_brokers[name] = MemoryBroker()
            return b
    if url.startswith("tcp://"):
        # one shared client per URL: threads each get their own socket
        # inside it, and every producer/consumer in the process reuses the
        # same connection pool instead of minting new ones per component
        from oryx_tpu_torch.transport import netbroker

        with _tcp_lock:
            c = _tcp_clients.get(url)
            if c is None:
                c = _tcp_clients[url] = netbroker.client_from_url(url)
            return c
    if url.startswith("file:"):
        return FileBroker(url[len("file:"):])
    raise TopicException(f"unknown broker url: {url}")


def reset_memory_brokers() -> None:
    """Drop all in-process brokers (test isolation)."""
    with _memory_lock:
        _memory_brokers.clear()


def reset_tcp_clients() -> None:
    """Drop cached tcp clients (test isolation across server restarts)."""
    with _tcp_lock:
        _tcp_clients.clear()


class _MemoryPartition:
    __slots__ = ("log", "base")

    def __init__(self):
        self.log: list[KeyMessage] = []
        self.base = 0  # offset of log[0]; advances on truncate


class _MemoryTopic:
    __slots__ = ("partitions", "cond", "rr")

    def __init__(self, n_partitions: int):
        self.partitions = [_MemoryPartition() for _ in range(n_partitions)]
        self.cond = threading.Condition()  # one condition per topic
        self.rr = itertools.count()  # round-robin for None keys


class MemoryBroker(Broker):
    def __init__(self):
        self._topics: dict[str, _MemoryTopic] = {}
        self._offsets: dict[tuple[str, str, int], int] = {}
        self._groups: dict[tuple[str, str], dict[str, float]] = {}
        self._lock = threading.Lock()

    def _topic(self, name: str) -> _MemoryTopic:
        with self._lock:
            t = self._topics.get(name)
            if t is None:
                raise TopicException(f"topic does not exist: {name}")
            return t

    def _partition(self, name: str, partition: int) -> "tuple[_MemoryTopic, _MemoryPartition]":
        """Topic + bounds-checked partition. Every partitioned accessor
        routes through here so an out-of-range partition raises a TYPED
        TopicException, never a bare IndexError — the tcp server maps these
        onto the wire as typed errors, not stack traces."""
        t = self._topic(name)
        if not 0 <= partition < len(t.partitions):
            raise TopicException(f"no partition {partition} in topic {name}")
        return t, t.partitions[partition]

    def create_topic(self, name: str, partitions: int = 1) -> None:
        with self._lock:
            self._topics.setdefault(name, _MemoryTopic(max(1, partitions)))

    def delete_topic(self, name: str) -> None:
        with self._lock:
            self._topics.pop(name, None)

    def topic_exists(self, name: str) -> bool:
        with self._lock:
            return name in self._topics

    def num_partitions(self, name: str) -> int:
        return len(self._topic(name).partitions)

    def append(self, topic: str, key, message, headers: "dict | None" = None,
               token: "str | None" = None) -> None:
        t = self._topic(topic)
        with t.cond:
            p = partition_for_key(key, len(t.partitions), next(t.rr))
            t.partitions[p].log.append(KeyMessage(key, message, headers))
            t.cond.notify_all()

    def read(
        self, topic: str, offset: int, max_items: int = 1024, partition: int = 0
    ) -> list[KeyMessage]:
        t, part = self._partition(topic, partition)
        with t.cond:
            lo = max(offset - part.base, 0)
            return part.log[lo:lo + max_items]

    def size(self, topic: str, partition: int = 0) -> int:
        t, part = self._partition(topic, partition)
        with t.cond:
            return part.base + len(part.log)

    def total_size(self, topic: str) -> int:
        t = self._topic(topic)
        with t.cond:
            return sum(p.base + len(p.log) for p in t.partitions)

    def truncate(self, topic: str, before_offset: int, partition: int = 0) -> None:
        t, part = self._partition(topic, partition)
        with t.cond:
            drop = min(max(before_offset - part.base, 0), len(part.log))
            if drop:
                del part.log[:drop]
                part.base += drop

    def wait_for_data(self, topic: str, seen_total: int, timeout: float, stop=None) -> None:
        t = self._topic(topic)
        with t.cond:
            total = sum(p.base + len(p.log) for p in t.partitions)
            if total <= seen_total and not (stop is not None and stop.is_set()):
                t.cond.wait(timeout)

    def wake(self, topic: str) -> None:
        try:
            t = self._topic(topic)
        except TopicException:
            return
        with t.cond:
            t.cond.notify_all()

    def get_offset(self, group: str, topic: str, partition: int = 0) -> int | None:
        with self._lock:
            return self._offsets.get((group, topic, partition))

    def set_offset(self, group: str, topic: str, offset: int, partition: int = 0) -> None:
        with self._lock:
            self._offsets[(group, topic, partition)] = offset

    def join_group(self, group: str, topic: str, member_id: str) -> None:
        with self._lock:
            self._groups.setdefault((group, topic), {})[member_id] = time.monotonic()

    def leave_group(self, group: str, topic: str, member_id: str) -> None:
        with self._lock:
            self._groups.get((group, topic), {}).pop(member_id, None)

    def group_members(self, group: str, topic: str) -> list[str]:
        now = time.monotonic()
        with self._lock:
            members = self._groups.get((group, topic), {})
            return sorted(
                m for m, hb in members.items() if now - hb < GROUP_MEMBER_TTL_SEC
            )


class FileBroker(Broker):
    """Append-only framed-record logs (one per partition) under a directory.

    Appends are flock-guarded O_APPEND writes of v1-framed lines (magic +
    length prefix + CRC32 + JSON; legacy bare-JSON lines read
    back-compatibly), with durability set by ``oryx.broker.file.fsync``.
    Reads keep a per-partition byte index that extends incrementally, so
    polling cost is O(new bytes), not O(log size). The first touch of a
    partition runs torn-tail recovery (truncate + count a trailing partial
    record); an in-flight writer's partial line is protected by the append
    flock and simply left for the next read; corrupt interior lines map to
    CORRUPT_RECORD with offsets aligned. Consumer-group membership rides
    heartbeat files (.groups/) with an mtime TTL, so cooperating processes
    see each other without a coordinator.
    """

    def __init__(self, root: str):
        self._root = Path(root)
        ioutils.mkdirs(self._root)
        self._lock = threading.Lock()
        # (topic, partition) -> line-start byte offsets incl. next-append pos
        self._index: dict[tuple[str, int], list[int]] = {}
        self._rr = itertools.count()  # per-process round-robin for None keys
        # partitions whose tail this instance already recovered (first
        # touch runs torn-tail truncation once; later partials belong to
        # live flock-holding writers and are left alone). Values are
        # completion events: a second thread racing the first touch WAITS
        # for recovery instead of appending past a still-torn tail (its
        # record would splice onto the partial and read back corrupt).
        self._recovered: dict[tuple[str, int], threading.Event] = {}
        # (topic, partition) -> monotonic time of the last fsync (the
        # "interval" policy's due-date bookkeeping)
        self._fsync_last: dict[tuple[str, int], float] = {}

    def _log_path(self, name: str, partition: int = 0) -> Path:
        return self._root / name / f"{partition:05d}.jsonl"

    def create_topic(self, name: str, partitions: int = 1) -> None:
        d = self._root / name
        ioutils.mkdirs(d)
        for p in range(max(1, partitions)):
            self._log_path(name, p).touch(exist_ok=True)

    def delete_topic(self, name: str) -> None:
        ioutils.delete_recursively(self._root / name)
        with self._lock:
            for key in [k for k in self._index if k[0] == name]:
                del self._index[key]
            for key in [k for k in self._recovered if k[0] == name]:
                del self._recovered[key]

    def topic_exists(self, name: str) -> bool:
        return self._log_path(name, 0).exists()

    def num_partitions(self, name: str) -> int:
        d = self._root / name
        if not d.is_dir():
            raise TopicException(f"topic does not exist: {name}")
        return max(1, len(list(d.glob("[0-9]*.jsonl"))))

    def append(self, topic: str, key, message, headers: "dict | None" = None,
               token: "str | None" = None) -> None:
        if isinstance(message, (bytes, bytearray)):
            # the JSONL record format carries str payloads only; fail TYPED
            # (and permanent) instead of leaking json.dumps's TypeError —
            # memory: accepts bytes, but anything durable/wire must not
            raise TopicException(
                "bytes messages are not supported by the file:/tcp: "
                "brokers (JSON record format); encode to str first"
            )
        n_parts = self.num_partitions(topic)
        part = partition_for_key(key, n_parts, next(self._rr))
        p = self._log_path(topic, part)
        if not p.exists():
            raise TopicException(f"topic does not exist: {topic}")
        self._ensure_recovered(topic, part, p)
        record = {"k": key, "m": message}
        if headers:
            record["h"] = headers
        data = frame_record(
            json.dumps(record, separators=(",", ":")).encode("utf-8")
        )
        fd = os.open(p, os.O_WRONLY | os.O_APPEND)
        try:
            # the whole record writes under an exclusive flock: a short-write
            # loop can no longer interleave with another process's append,
            # and open-time recovery (which also takes the lock) can never
            # truncate a LIVE writer's half-written record
            _flock(fd, fcntl.LOCK_EX if fcntl else 0)
            written = os.write(fd, data)
            while written < len(data):
                written += os.write(fd, data[written:])
            self._maybe_fsync(fd, topic, part)
        finally:
            if fcntl is not None:
                _flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def _maybe_fsync(self, fd: int, topic: str, part: int) -> None:
        """Apply the configured durability policy after one append. An
        fsync failure (disk error, injected ``broker.fsync`` fault) costs
        durability for that window, never availability: the append already
        landed in the page cache, so raising here would make the producer's
        retry DOUBLE-append a record that was never lost."""
        policy = _fsync_policy
        if policy == "never":
            return
        if policy == "interval":
            now = time.monotonic()
            with self._lock:
                last = self._fsync_last.get((topic, part), 0.0)
                if now - last < _fsync_interval_sec:
                    return
                self._fsync_last[(topic, part)] = now
        try:
            faults.maybe_fail("broker.fsync")
            os.fsync(fd)
        except OSError:
            log.warning(
                "log fsync failed for %s/%d (durability degraded for this "
                "window; append already applied)", topic, part, exc_info=True,
            )
            return
        _FSYNCS.inc()

    # -- torn-tail recovery ---------------------------------------------------
    def _ensure_recovered(self, topic: str, part: int, p: Path) -> None:
        key = (topic, part)
        with self._lock:
            done = self._recovered.get(key)
            if done is None:
                done = self._recovered[key] = threading.Event()
                owner = True
            else:
                owner = False
        if owner:
            try:
                self._recover_tail(topic, part, p)
            finally:
                done.set()
        else:
            # block until the owner truncated the tail: appending before
            # that would splice a good record onto the torn partial
            done.wait()

    def _recover_tail(self, topic: str, part: int, p: Path) -> None:
        """Open-time crash recovery: scan the log tail and truncate a
        trailing PARTIAL record (no terminating newline — a writer killed
        mid-append, or a post-crash torn page under a lazy fsync policy),
        counting what it dropped. Complete-but-corrupt interior records are
        deliberately NOT touched here: they surface as CORRUPT_RECORD with
        offsets aligned, so a mid-log bit-flip never costs the records
        after it. Runs under the append flock, so an in-flight writer's
        unfinished record is invisible to it."""
        try:
            fd = os.open(p, os.O_RDWR)
        except FileNotFoundError:
            return
        try:
            _flock(fd, fcntl.LOCK_EX if fcntl else 0)
            size = os.lseek(fd, 0, os.SEEK_END)
            if size == 0:
                return
            # scan backwards for the last newline (chunked: a partial
            # record can be as large as the max message size)
            pos, last_nl, chunk = size, -1, 1 << 16
            while pos > 0 and last_nl < 0:
                lo = max(0, pos - chunk)
                os.lseek(fd, lo, os.SEEK_SET)
                buf = os.read(fd, pos - lo)
                nl = buf.rfind(b"\n")
                if nl >= 0:
                    last_nl = lo + nl
                pos = lo
            cut = last_nl + 1  # 0 when the whole file is one partial record
            if cut == size:
                return  # clean, newline-terminated tail
            os.ftruncate(fd, cut)
            os.fsync(fd)
            _TORN_TAIL.labels(topic).inc()
            blackbox.record_event(
                "broker.torn_tail", severity="warning",
                topic=topic, partition=part, truncated_bytes=size - cut,
            )
            log.warning(
                "torn-tail recovery on %s/%d: truncated %d byte(s) of "
                "partial trailing record", topic, part, size - cut,
            )
        except OSError:
            log.warning(
                "torn-tail recovery failed on %s/%d (reads still stop "
                "before the partial tail)", topic, part, exc_info=True,
            )
        finally:
            if fcntl is not None:
                _flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def _refresh_index(self, topic: str, partition: int = 0) -> list[int]:
        """Extend the line index over bytes appended since the last call."""
        p = self._log_path(topic, partition)
        if not p.exists():
            raise TopicException(f"topic/partition does not exist: {topic}/{partition}")
        self._ensure_recovered(topic, partition, p)
        with self._lock:
            idx = self._index.setdefault((topic, partition), [0])
            scanned = idx[-1]
            file_size = p.stat().st_size
            if file_size <= scanned:
                return idx
            with open(p, "rb") as f:
                f.seek(scanned)
                data = f.read(file_size - scanned)
            pos = 0
            while True:
                nl = data.find(b"\n", pos)
                if nl == -1:
                    break  # partial trailing line stays unindexed
                idx.append(scanned + nl + 1)
                pos = nl + 1
            return idx

    def read(
        self, topic: str, offset: int, max_items: int = 1024, partition: int = 0
    ) -> list[KeyMessage]:
        idx = self._refresh_index(topic, partition)
        n = len(idx) - 1  # complete lines
        if offset >= n:
            return []
        end = min(offset + max_items, n)
        p = self._log_path(topic, partition)
        out: list[KeyMessage] = []
        with open(p, "rb") as f:
            f.seek(idx[offset])
            blob = f.read(idx[end] - idx[offset])
        lines = blob.split(b"\n")
        if lines and not lines[-1]:
            lines.pop()  # trailing newline artifact only; blank interior
            # lines must still produce CORRUPT_RECORD to keep offsets aligned
        for raw in lines:
            if not raw.strip():
                out.append(CORRUPT_RECORD)
                continue
            out.append(decode_record(raw, topic))  # keeps offsets aligned
        return out[: end - offset]

    def size(self, topic: str, partition: int = 0) -> int:
        return len(self._refresh_index(topic, partition)) - 1

    def truncate(self, topic: str, before_offset: int, partition: int = 0) -> None:
        """Rewrite the partition log without the truncated prefix. Offsets
        shift to 0-based on disk but this broker instance keeps serving stable
        offsets only for fresh reads; cross-process readers should truncate
        during quiet periods (retention maintenance)."""
        idx = self._refresh_index(topic, partition)
        n = len(idx) - 1
        cut = min(max(before_offset, 0), n)
        if cut == 0:
            return
        p = self._log_path(topic, partition)
        with open(p, "rb") as f:
            f.seek(idx[cut])
            rest = f.read()
        # atomic rename (unique temp + fsync): a retention pass killed
        # mid-rewrite must never leave a truncated half-log behind
        ioutils.atomic_write_bytes(p, rest)
        with self._lock:
            self._index.pop((topic, partition), None)

    def _offset_path(self, group: str, topic: str, partition: int) -> Path:
        # partition 0 keeps the legacy filename so old deployments resume
        suffix = "" if partition == 0 else f"__p{partition}"
        return self._root / ".offsets" / f"{group}__{topic}{suffix}.json"

    def get_offset(self, group: str, topic: str, partition: int = 0) -> int | None:
        p = self._offset_path(group, topic, partition)
        if not p.exists():
            return None
        return json.loads(p.read_text())["offset"]

    def set_offset(self, group: str, topic: str, offset: int, partition: int = 0) -> None:
        # write-temp + fsync + os.replace (unique temp name): a replica
        # killed mid-commit leaves the old offset intact, never a torn JSON
        # that would corrupt resume positions for the whole group — and two
        # concurrent committers cannot interleave bytes in one temp file
        p = self._offset_path(group, topic, partition)
        ioutils.mkdirs(p.parent)
        ioutils.atomic_write_text(p, json.dumps({"offset": offset}))

    def _group_dir(self, group: str, topic: str) -> Path:
        return self._root / ".groups" / f"{group}__{topic}"

    def join_group(self, group: str, topic: str, member_id: str) -> None:
        d = self._group_dir(group, topic)
        ioutils.mkdirs(d)
        (d / f"{member_id}.hb").touch()

    def leave_group(self, group: str, topic: str, member_id: str) -> None:
        try:
            (self._group_dir(group, topic) / f"{member_id}.hb").unlink()
        except FileNotFoundError:
            pass

    def group_members(self, group: str, topic: str) -> list[str]:
        d = self._group_dir(group, topic)
        if not d.is_dir():
            return []
        now = time.time()
        return sorted(
            p.name[: -len(".hb")]
            for p in d.glob("*.hb")
            if now - p.stat().st_mtime < GROUP_MEMBER_TTL_SEC
        )


# ---------------------------------------------------------------------------
# Producer + consume iterator (TopicProducer / ConsumeDataIterator)
# ---------------------------------------------------------------------------

#: Fixed transport-level message cap (TopicProducerImpl.java sets Kafka
#: max.request.size = 1<<26). The *configured* update-topic max-size only
#: drives MLUpdate's inline-vs-MODEL-REF decision, not producer enforcement.
MAX_REQUEST_SIZE = 1 << 26


class TopicProducerImpl:
    """Producer for one topic (framework/oryx-lambda/.../TopicProducerImpl.java).
    Enforces the transport cap; oversized sends raise, and callers fall back to
    the MODEL-REF by-reference protocol (ml/MLUpdate publish path)."""

    def __init__(self, broker_url: str, topic: str, max_size: int | None = MAX_REQUEST_SIZE):
        self._broker_url = broker_url
        self._topic = topic
        self._max_size = max_size
        self._broker: Broker | None = None  # lazy, like the reference
        # set by close(): aborts an in-flight send's retry backoff sleeps so
        # teardown never waits out the retry budget against a dead broker
        self._closed = threading.Event()

    def get_update_broker(self) -> str:
        return self._broker_url

    def get_topic(self) -> str:
        return self._topic

    def send(self, key, message, headers: "dict | None" = None) -> None:
        if self._broker is None:
            self._broker = get_broker(self._broker_url)
            self._closed.clear()  # a send after close() reopens (lazy, as ever)
        # trace propagation: the producer injects the caller's current span
        # as a traceparent header (W3C format), so a trace minted at HTTP
        # ingress crosses the topic hop into whichever tier consumes this
        headers = spans.inject_headers(headers)
        # ONE idempotence token per logical send, OUTSIDE the retry: a
        # network broker that applied the append but lost the response
        # dedups the retried attempt instead of double-appending
        token = uuid.uuid4().hex

        def _append():
            faults.maybe_fail("broker.append")
            self._broker.append(self._topic, key, message, headers,
                                token=token)

        try:
            # bytes payloads must honor the cap exactly like str ones — the
            # str-only check let arbitrarily large bytes blobs bypass the
            # transport limit entirely (and blow the tcp broker's frame cap
            # downstream instead of failing typed at the producer)
            if (
                self._max_size is not None
                and isinstance(message, (str, bytes, bytearray))
                and len(message) > self._max_size
            ):
                raise TopicException(
                    f"message of {len(message)} bytes exceeds max {self._max_size}"
                )
            # transient append failures (file-broker I/O, injected faults)
            # retry under the process policy; a send raises only once the
            # budget is spent — retries are visible in oryx_retries_total
            resilience.default_policy().call(
                "broker.append", _append, retryable=transient_transport_error,
                stop=self._closed,
            )
        except Exception:
            _SEND_FAILURES.labels(self._topic).inc()
            raise
        _PRODUCED.labels(self._topic).inc()

    def close(self) -> None:
        self._closed.set()
        self._broker = None


class ConsumeDataIterator(Iterator[KeyMessage]):
    """Blocking iterator over a topic's partitions from starting offsets, with
    exponential poll backoff 1→1000 ms and wakeup-based close
    (kafka-util/.../ConsumeDataIterator.java:30-77).

    ``start_offset``: "earliest" (0), "latest" (current end), "committed"
    (per-partition positions stored in the broker's offset store under
    ``offset_group`` — falling back to ``group`` — looked up LAZILY when a
    partition is first touched, so partitions acquired mid-flight by a
    rebalance resume from the group's committed position instead of
    re-delivering from 0), an int (only valid when consuming exactly one
    partition), or a {partition: offset} dict. ``partitions`` restricts
    consumption to a fixed subset; ``group`` joins a consumer group instead
    — the broker's live membership splits the topic's partitions
    round-robin (partitions_for_member), re-evaluated every poll so
    consumers that join/leave rebalance without a coordinator.

    Offset *persistence* is deliberately not done here: layers commit consumed
    positions after processing (UpdateOffsetsFn semantics) via
    Broker.set_offset. Commit :attr:`processed_offsets` — the position past
    the last message HANDED OUT — never :attr:`offsets` (the read position,
    which runs ahead of processing by whatever sits in the prefetch buffer;
    committing it would silently skip buffered-but-unprocessed messages on
    a crash-resume).
    """

    _MIN_BACKOFF = 0.001
    _MAX_BACKOFF = 1.0
    _HEARTBEAT_SEC = 1.0

    def __init__(
        self,
        broker: Broker | str,
        topic: str,
        start_offset: "int | str | dict" = "earliest",
        partitions: "list[int] | None" = None,
        group: "str | None" = None,
        member_id: "str | None" = None,
        offset_group: "str | None" = None,
    ):
        self._broker = get_broker(broker) if isinstance(broker, str) else broker
        self._topic = topic
        self._group = group
        self._member_id = member_id or f"consumer-{os.getpid()}-{id(self):x}"
        self._n_parts = self._broker.num_partitions(topic)
        self._partitions = partitions
        if group is not None:
            self._broker.join_group(group, topic, self._member_id)
        self._last_heartbeat = time.monotonic()
        self._start = start_offset
        self._offset_group = offset_group if offset_group is not None else group
        self._offsets: dict[int, int] = {}
        if isinstance(start_offset, dict):
            self._offsets.update({int(p): int(o) for p, o in start_offset.items()})
        elif start_offset == "latest":
            # pin "latest" at subscribe time, for every partition — anything
            # produced after construction must be seen even if the first poll
            # is slow to schedule
            for p in range(self._n_parts):
                self._offsets[p] = self._broker.size(topic, p)
        elif start_offset == "committed":
            # positions resolve lazily per partition in _offset_of, so a
            # partition inherited from a dead group member resumes from the
            # group's committed offset, not from 0
            if not self._offset_group:
                raise TopicException(
                    "start_offset='committed' needs an offset_group (or "
                    "group) naming the stored positions"
                )
        elif start_offset != "earliest":
            static = partitions if partitions is not None else list(range(self._n_parts))
            if group is None and len(static) == 1:
                self._offsets[static[0]] = int(start_offset)
            elif group is None and self._n_parts == 1:
                self._offsets[0] = int(start_offset)
            else:
                raise TopicException(
                    "int start_offset is ambiguous over multiple partitions; "
                    "pass a {partition: offset} dict"
                )
        # prefetched messages with provenance: (message, partition, offset
        # AFTER this message) — __next__ pops one and advances _processed
        self._buffer: list[tuple[KeyMessage, int, int]] = []
        self._processed: dict[int, int] = {}
        self._closed = threading.Event()
        # last assignment actually used (rebalance-hysteresis baseline)
        self._last_assigned: "list[int] | None" = None

    # -- partition assignment -------------------------------------------------
    def _assigned(self) -> list[int]:
        if self._group is not None:
            now = time.monotonic()
            if now - self._last_heartbeat >= self._HEARTBEAT_SEC:
                self._broker.join_group(self._group, self._topic, self._member_id)
                self._last_heartbeat = now
            assigned = self._assignment_from_view()
            if (
                self._last_assigned is not None
                and set(assigned) - set(self._last_assigned)
                and self._closed.is_set()
            ):
                # a CLOSING consumer must never claim new partitions — in
                # any window. close() racing a peer's leave_group used to
                # take the raw expanded view here (the hysteresis below
                # was skipped exactly because closed was set), re-read the
                # departed member's partitions from 0, and hand out
                # duplicates before StopIteration landed.
                assigned = [
                    p for p in assigned if p in set(self._last_assigned)
                ]
            elif (
                self._last_assigned is not None
                and set(assigned) - set(self._last_assigned)
            ):
                # rebalance hysteresis: GROWING the assignment on
                # a single membership read is how a transient view (a
                # heartbeat racing the TTL sweep, a blipped members RPC)
                # turns into duplicate consumption — this member would claim
                # partitions a live peer is still draining, and in earliest
                # mode replay them from 0. Expansion must survive a second
                # read one beat later; shrinking (a peer JOINED) stays
                # immediate so two growers cannot overlap. Genuine takeover
                # of a dead member's partitions just lands ~50 ms later.
                self._closed.wait(0.05)
                if self._closed.is_set():
                    # a CLOSING consumer must never claim new partitions:
                    # close() racing a peer's leave_group used to let the
                    # expansion proceed here, re-reading the departed
                    # member's partitions from 0 and handing out duplicate
                    # messages in the teardown window before StopIteration
                    assigned = [
                        p for p in assigned if p in set(self._last_assigned)
                    ]
                else:
                    confirm = self._assignment_from_view()
                    if set(confirm) - set(self._last_assigned):
                        assigned = confirm
                    else:
                        assigned = [p for p in assigned if p in set(confirm)]
            self._last_assigned = assigned
            # rebalance hygiene: a partition lost to another member leaves
            # no residue — a stale _processed entry would let this member's
            # commit loop clobber the new owner's (higher) committed offset,
            # and in committed mode a stale read position would shadow the
            # store's offset if the partition ever came back
            for p in [p for p in self._processed if p not in assigned]:
                del self._processed[p]
            if self._start == "committed":
                for p in [p for p in self._offsets if p not in assigned]:
                    del self._offsets[p]
            return assigned
        if self._partitions is not None:
            return list(self._partitions)
        return list(range(self._n_parts))

    def _assignment_from_view(self) -> list[int]:
        """One membership read -> this member's partition list (static
        ``partitions=`` filter applied)."""
        members = self._broker.group_members(self._group, self._topic)
        assigned = partitions_for_member(self._member_id, members, self._n_parts)
        if self._partitions is not None:
            assigned = [p for p in assigned if p in self._partitions]
        return assigned

    def _offset_of(self, partition: int) -> int:
        off = self._offsets.get(partition)
        if off is None:
            if self._start == "committed":
                stored = self._stored_offset(partition)
                off = stored if stored is not None else 0
            else:
                off = 0
            self._offsets[partition] = off
        return off

    def _stored_offset(self, partition: int) -> "int | None":
        """Committed position lookup (first touch of a partition in
        "committed" mode) — the shared offset-op retry contract."""
        return offset_op(
            lambda: self._broker.get_offset(
                self._offset_group, self._topic, partition
            ),
            stop=self._closed,
        )

    def _read_with_retry(self, partition: int, offset: int) -> list:
        """One partition poll, retried through transient broker failures
        (stop-aware: a close() mid-backoff aborts the sleep). Exhausting the
        budget raises out of the consumer — supervised consumers restart."""

        def _read():
            faults.maybe_fail("broker.read")
            return self._broker.read(self._topic, offset, partition=partition)

        return resilience.default_policy().call(
            "broker.read", _read, retryable=transient_transport_error,
            stop=self._closed,
        )

    @property
    def offset(self) -> int:
        """Single-partition position (back-compat for 1-partition topics)."""
        return self._offset_of(0)

    @property
    def offsets(self) -> dict[int, int]:
        """READ positions (they run ahead of processing by the prefetch
        buffer — commit :attr:`processed_offsets`, not these)."""
        return dict(self._offsets)

    @property
    def processed_offsets(self) -> dict[int, int]:
        """Per-partition position past the last message HANDED OUT by
        ``__next__`` — the safe value for after-processing offset commits
        (UpdateOffsetsFn semantics): resuming from it neither re-delivers a
        processed message nor skips a prefetched-but-unprocessed one.
        Partitions lost to a group rebalance drop out on the next poll, so
        a commit loop writing these wholesale never clobbers the new
        owner's position."""
        return dict(self._processed)

    def messages_behind(self, total: int) -> int:
        """Advisory consumer lag against a topic-total snapshot: messages
        not yet handed out (read positions rolled back by the prefetch
        buffer). Correct in every start mode — a "committed" consumer's
        positions resolve on its first poll, so a caught-up restarted
        replica reads ~0 here, not the topic length. Before the first poll
        (no positions resolved) this reads 0: the backlog is unknown, and
        a replica that has not polled yet is covered by the lag-seconds
        gauge, not this one. A CLOSED iterator reads 0: it is being torn
        down (its supervised replacement re-registers the gauges), and a
        stale scrape callback must not report a dead pipeline's backlog."""
        if self._closed.is_set() or not self._offsets:
            return 0
        read = sum(self._offsets.values())
        return max(0, int(total) - read + len(self._buffer))

    def __iter__(self) -> "ConsumeDataIterator":
        return self

    def __next__(self) -> KeyMessage:
        backoff = self._MIN_BACKOFF
        while not self._buffer:
            if self._closed.is_set():
                raise StopIteration
            progressed = False
            for p in self._assigned():
                off = self._offset_of(p)
                batch = self._read_with_retry(p, off)
                if batch:
                    self._offsets[p] = off + len(batch)
                    n_corrupt = sum(1 for km in batch if km is CORRUPT_RECORD)
                    if n_corrupt:
                        # each corrupt offset is consumed (skipped) exactly
                        # once per consumer — counted here, not in read(),
                        # where re-polls would inflate the count
                        _CORRUPT_CONSUMED.labels("transport").inc(n_corrupt)
                    self._buffer.extend(
                        (km, p, off + i + 1)
                        for i, km in enumerate(batch)
                        if km is not CORRUPT_RECORD
                    )
                    progressed = True
            if self._buffer:
                break
            if progressed:
                continue  # consumed only corrupt records; poll again
            # total_size rides the retry policy too: an idle consumer must
            # not crash (and in earliest mode trigger a full replay) because
            # the broker blipped between two polls — the same contract the
            # read path already has (no fault hook: this probe is advisory)
            total = resilience.default_policy().call(
                "broker.read",
                lambda: self._broker.total_size(self._topic),
                retryable=transient_transport_error, stop=self._closed,
            )
            self._broker.wait_for_data(
                self._topic, total, backoff, stop=self._closed,
            )
            backoff = min(backoff * 2, self._MAX_BACKOFF)
        _CONSUMED.labels(self._topic).inc()
        km, p, next_off = self._buffer.pop(0)
        self._processed[p] = next_off
        return km

    def close(self) -> None:
        """Wake up and terminate a blocked iteration (consumer.wakeup())."""
        self._closed.set()
        if self._group is not None:
            try:
                self._broker.leave_group(self._group, self._topic, self._member_id)
            except Exception:  # noqa: BLE001 — best-effort on teardown
                log.debug("leave_group failed on close", exc_info=True)
        self._broker.wake(self._topic)


def maybe_create_topics(config, *topic_keys: str) -> None:
    """Assert/create the configured topics with their configured partition
    counts (AbstractSparkLayer.java:178-185 + oryx-run.sh kafka-setup:345-358).
    topic_keys like 'input-topic', 'update-topic'."""
    for tk in topic_keys:
        broker = get_broker(config.get_string(f"oryx.{tk}.broker"))
        name = config.get_string(f"oryx.{tk}.message.topic")
        if not broker.topic_exists(name):
            parts = config.get_int(f"oryx.{tk}.message.partitions", 1) or 1
            broker.create_topic(name, parts)
