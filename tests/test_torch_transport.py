"""The port's topic transport, held to the reference's contract.

Mirrors every case of ``tests/test_transport_store.py`` on
``oryx_tpu_torch.transport.topic`` and ``oryx_tpu_torch.transport.netbroker``
(the broker contract suite over ``["memory", "file", "tcp"]``, a live port
netbroker server per ``tcp`` case, the non-parametrised cases, the
``test_tcp_*`` cases, and both halves of the ``scheme`` cases). The
subprocess consumer imports the port, not the reference. Wire and segment
parity with the reference's netbroker is ``tests/test_torch_netbroker.py``.

Then the cross-package parity cases: ``frame_record`` / ``decode_record``
give the same bytes and records in both packages; a ``file:`` log and
offset store written by either package's ``FileBroker`` are read back whole
by the other's, and are byte-equal when both write the same records; a torn
tail and a bit-flipped frame are recovered the same way by both.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from oryx_tpu.transport import topic as ref_tp
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.store.datastore import DataStore, ModelStore
from oryx_tpu_torch.transport import netbroker
from oryx_tpu_torch.transport import topic as tp

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ALL_BROKERS = ["memory", "file", "tcp"]


@pytest.fixture(autouse=True)
def _fresh_brokers():
    tp.reset_memory_brokers()
    tp.reset_tcp_clients()
    ref_tp.reset_memory_brokers()
    yield
    tp.reset_memory_brokers()
    tp.reset_tcp_clients()
    ref_tp.reset_memory_brokers()


@pytest.fixture(params=ALL_BROKERS)
def broker_url(request, tmp_path):
    """One URL per broker backend; tcp spins a real port netbroker server."""
    if request.param == "memory":
        yield "memory:"
    elif request.param == "file":
        yield f"file:{tmp_path}/broker"
    else:
        server = netbroker.NetBrokerServer(
            str(tmp_path / "tcpbroker"), host="127.0.0.1", port=0
        ).start_background()
        try:
            yield f"tcp://127.0.0.1:{server.port}"
        finally:
            server.close()


def test_roundtrip(broker_url):
    broker = tp.get_broker(broker_url)
    broker.create_topic("T")
    assert broker.topic_exists("T")
    prod = tp.TopicProducerImpl(broker_url, "T")
    for i in range(5):
        prod.send(f"k{i}", f"m{i}")
    it = tp.ConsumeDataIterator(broker, "T", "earliest")
    got = [next(it) for _ in range(5)]
    assert got == [KeyMessage(f"k{i}", f"m{i}") for i in range(5)]
    it.close()
    broker.delete_topic("T")
    assert not broker.topic_exists("T")


def test_headers_roundtrip(broker_url):
    """Transport headers (the traceparent channel) survive every backend."""
    from oryx_tpu_torch.common import spans

    broker = tp.get_broker(broker_url)
    broker.create_topic("T")
    prod = tp.TopicProducerImpl(broker_url, "T")
    with spans.span("test.headers", parent=None,
                    attributes={"route": "test"}) as sp:
        trace_id = sp.trace_id
        prod.send("k", "m", headers={"custom": "value"})
    it = tp.ConsumeDataIterator(broker, "T", "earliest")
    km = next(it)
    it.close()
    assert km.headers is not None
    assert km.headers["custom"] == "value"
    assert trace_id in km.headers[spans.TRACEPARENT]


def test_blocking_consume_wakes_on_produce():
    broker = tp.get_broker("memory:")
    broker.create_topic("T")
    it = tp.ConsumeDataIterator(broker, "T", "earliest")
    got = []

    def consume():
        got.append(next(it))

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.05)
    tp.TopicProducerImpl("memory:", "T").send("k", "v")
    t.join(timeout=5)
    assert got == [KeyMessage("k", "v")]


def test_close_unblocks_consumer():
    broker = tp.get_broker("memory:")
    broker.create_topic("T")
    it = tp.ConsumeDataIterator(broker, "T", "latest")
    done = threading.Event()

    def consume():
        with pytest.raises(StopIteration):
            next(it)
        done.set()

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.05)
    it.close()
    assert done.wait(timeout=5)


def test_latest_skips_existing():
    broker = tp.get_broker("memory:")
    broker.create_topic("T")
    tp.TopicProducerImpl("memory:", "T").send("old", "old")
    it = tp.ConsumeDataIterator(broker, "T", "latest")
    tp.TopicProducerImpl("memory:", "T").send("new", "new")
    assert next(it).key == "new"


def test_offsets_resume(broker_url):
    broker = tp.get_broker(broker_url)
    broker.create_topic("T")
    prod = tp.TopicProducerImpl(broker_url, "T")
    for i in range(4):
        prod.send(str(i), str(i))
    it = tp.ConsumeDataIterator(broker, "T", "earliest")
    for _ in range(4):
        next(it)
    # consumer commits after processing (UpdateOffsetsFn semantics)
    broker.set_offset("g1", "T", it.offset)
    stored = broker.get_offset("g1", "T")
    assert stored == 4
    prod.send("4", "4")
    it2 = tp.ConsumeDataIterator(broker, "T", stored)
    assert next(it2).key == "4"
    it.close()
    it2.close()


def test_committed_start_resumes_from_stored_offsets(broker_url):
    """start_offset="committed": a fresh consumer continues from the
    group's stored positions — and processed_offsets (the safe commit
    value) trails the read position by whatever sits in the prefetch
    buffer."""
    broker = tp.get_broker(broker_url)
    broker.create_topic("T")
    prod = tp.TopicProducerImpl(broker_url, "T")
    for i in range(6):
        prod.send(str(i), f"m{i}")
    it = tp.ConsumeDataIterator(broker, "T", "earliest")
    for _ in range(3):
        next(it)
    # one poll prefetched everything: reads ran ahead of processing
    assert it.offsets[0] == 6
    assert it.processed_offsets == {0: 3}
    # commit the PROCESSED position, as a crash-safe consumer must
    broker.set_offset("g1", "T", it.processed_offsets[0])
    it.close()
    it2 = tp.ConsumeDataIterator(
        broker, "T", "committed", offset_group="g1"
    )
    assert [next(it2).key for _ in range(3)] == ["3", "4", "5"]
    it2.close()
    # no stored offset for this group -> earliest
    it3 = tp.ConsumeDataIterator(
        broker, "T", "committed", offset_group="never-committed"
    )
    assert next(it3).key == "0"
    it3.close()


def test_committed_start_requires_offset_group():
    broker = tp.get_broker("memory:")
    broker.create_topic("T")
    with pytest.raises(tp.TopicException):
        tp.ConsumeDataIterator(broker, "T", "committed")


def test_truncate_retention(broker_url):
    broker = tp.get_broker(broker_url)
    broker.create_topic("T")
    prod = tp.TopicProducerImpl(broker_url, "T")
    for i in range(6):
        prod.send(str(i), str(i))
    broker.truncate("T", 4)
    # the retention contract everywhere: the truncated prefix is gone,
    # the suffix survives in order
    assert [km.key for km in broker.read("T", 0)] == ["4", "5"]
    if broker_url == "memory:":
        # in-process logs additionally keep offsets STABLE across truncate
        # (durable logs rebase on disk; their readers truncate during quiet
        # periods — FileBroker.truncate docstring)
        assert broker.size("T") == 6
        assert [km.key for km in broker.read("T", 5)] == ["5"]
    else:
        assert broker.size("T") == 2


def test_file_broker_recovers_torn_tail_and_tolerates_inflight(tmp_path):
    """First touch of a partition truncates a killed writer's partial
    trailing record (torn-tail recovery, counted); AFTER recovery, a live
    in-flight writer's partial line is simply left unindexed until its
    newline lands — and a completed legacy (bare-JSON) line still reads."""
    from oryx_tpu_torch.common import metrics as metrics_mod

    def torn_count() -> float:
        snap = metrics_mod.default_registry().snapshot()
        return snap.get(
            "oryx_broker_torn_tail_records_total", {}
        ).get('topic="T"', 0.0)

    url = f"file:{tmp_path}/broker"
    broker = tp.get_broker(url)
    broker.create_topic("T")
    tp.TopicProducerImpl(url, "T").send("a", "1")
    # a writer killed -9 mid-append: partial line, no newline
    log = tmp_path / "broker" / "T" / "00000.jsonl"
    clean_size = log.stat().st_size
    with open(log, "a") as f:
        f.write('{"k":"b","m":"2')
    before = torn_count()
    # first touch (this instance) runs recovery: partial truncated + counted
    assert broker.size("T") == 1
    assert torn_count() == before + 1
    assert log.stat().st_size == clean_size
    assert [km.key for km in broker.read("T", 0)] == ["a"]
    # appends continue cleanly at the recovered tail
    broker.append("T", "b", "2")
    assert [km.key for km in broker.read("T", 0)] == ["a", "b"]
    # in-flight writer AFTER recovery: the partial stays unindexed (reads
    # stop before it), and once the newline lands the record is consumable
    # — including via the legacy bare-JSON framing
    with open(log, "a") as f:
        f.write('{"k":"c","m":"3')
    assert broker.size("T") == 2
    with open(log, "a") as f:
        f.write('"}\n')
    assert broker.size("T") == 3
    assert [km.key for km in broker.read("T", 2)] == ["c"]
    assert torn_count() == before + 1  # no further recovery ran


def test_file_broker_skips_corrupt_interior_line(tmp_path):
    url = f"file:{tmp_path}/broker"
    broker = tp.get_broker(url)
    broker.create_topic("T")
    prod = tp.TopicProducerImpl(url, "T")
    prod.send("a", "1")
    log = tmp_path / "broker" / "T" / "00000.jsonl"
    with open(log, "a") as f:
        f.write("NOT JSON AT ALL\n")
    prod.send("c", "3")
    it = tp.ConsumeDataIterator(broker, "T", "earliest")
    assert next(it).key == "a"
    assert next(it).key == "c"  # corrupt record silently skipped
    assert it.offset == 3  # but offsets stay aligned


def test_max_size_enforced():
    broker = tp.get_broker("memory:")
    broker.create_topic("T")
    prod = tp.TopicProducerImpl("memory:", "T", max_size=10)
    with pytest.raises(tp.TopicException):
        prod.send("k", "x" * 100)
    prod.send("k", "small")  # under limit fine


def test_max_size_enforced_for_bytes():
    """bytes payloads honor the producer cap exactly like str ones — the
    str-only isinstance check used to let any bytes blob sail through."""
    broker = tp.get_broker("memory:")
    broker.create_topic("T")
    prod = tp.TopicProducerImpl("memory:", "T", max_size=10)
    with pytest.raises(tp.TopicException) as ei:
        prod.send("k", b"x" * 100)
    assert not ei.value.transient  # oversize stays permanent, never retried
    with pytest.raises(tp.TopicException):
        prod.send("k", bytearray(b"y" * 100))
    prod.send("k", b"small")  # under limit fine
    assert broker.size("T") == 1


def test_bytes_messages_rejected_typed_on_durable_brokers(tmp_path):
    """memory: accepts bytes, but the JSON-record brokers (file:, tcp:)
    must refuse them TYPED — a raw json.dumps TypeError would escape the
    transport contract (and the retry predicate)."""
    fb = tp.get_broker(f"file:{tmp_path}/b")
    fb.create_topic("T")
    with pytest.raises(tp.TopicException) as ei:
        fb.append("T", "k", b"payload")
    assert not ei.value.transient
    fb.append("T", "k", "str is fine")
    assert fb.size("T") == 1
    server = netbroker.NetBrokerServer(
        str(tmp_path / "tcpb"), host="127.0.0.1", port=0
    ).start_background()
    try:
        tb = tp.get_broker(f"tcp://127.0.0.1:{server.port}")
        tb.create_topic("T")
        with pytest.raises(tp.TopicException):
            tb.append("T", "k", b"payload")
        tb.append("T", "k", "str is fine")
        assert tb.size("T") == 1
    finally:
        server.close()


def test_tcp_append_retry_with_same_token_does_not_duplicate(tmp_path):
    """Producer idempotence over the wire: a retried append carrying the
    same token (the lost-response case) is acknowledged without appending
    again — tcp keeps the in-process brokers' no-duplicate retry story."""
    server = netbroker.NetBrokerServer(
        str(tmp_path / "b"), host="127.0.0.1", port=0
    ).start_background()
    try:
        broker = tp.get_broker(f"tcp://127.0.0.1:{server.port}")
        broker.create_topic("T")
        broker.append("T", "k", "once", token="tok-1")
        broker.append("T", "k", "once", token="tok-1")  # the "retry"
        broker.append("T", "k", "other", token="tok-2")
        assert [km.message for km in broker.read("T", 0)] == ["once", "other"]
        # the producer path threads a fresh token through each send
        prod = tp.TopicProducerImpl(f"tcp://127.0.0.1:{server.port}", "T")
        prod.send("k", "via-producer")
        assert broker.size("T") == 3
    finally:
        server.close()


def test_tcp_read_responses_are_byte_bounded(tmp_path):
    """A backlog whose full read response would blow the frame cap is
    paged into smaller frames instead of wedging the consumer: every
    message still arrives, in order, over several RPCs."""
    cap = 96 * 1024  # budget after the 64KiB envelope margin: 32KiB
    server = netbroker.NetBrokerServer(
        str(tmp_path / "b"), host="127.0.0.1", port=0, max_frame_bytes=cap
    ).start_background()
    try:
        broker = netbroker.NetBrokerClient("127.0.0.1", server.port,
                                           max_frame_bytes=cap)
        broker.create_topic("T")
        payload = "x" * 4096
        for i in range(20):
            broker.append("T", f"k{i}", f"{i}:{payload}")
        # one read RPC returns a trimmed page, never an over-cap frame
        first = broker.read("T", 0)
        assert 1 <= len(first) < 20
        # the blocking iterator drains the whole backlog across pages
        it = tp.ConsumeDataIterator(broker, "T", "earliest")
        got = [next(it).message.split(":", 1)[0] for _ in range(20)]
        it.close()
        assert got == [str(i) for i in range(20)]
    finally:
        server.close()


def test_tcp_oversize_request_answers_typed_not_cut_socket(tmp_path):
    """A request frame over the SERVER's cap (mismatched per-host configs)
    comes back as a typed non-transient TopicException — not a cut socket
    that reads as transient and fuels a retry storm — and the connection
    stays usable for the next RPC."""
    server = netbroker.NetBrokerServer(
        str(tmp_path / "b"), host="127.0.0.1", port=0, max_frame_bytes=4096
    ).start_background()
    try:
        # client believes in a much larger cap, so its local pre-check passes
        client = netbroker.NetBrokerClient("127.0.0.1", server.port,
                                           max_frame_bytes=1 << 26)
        client.create_topic("T")
        with pytest.raises(tp.TopicException) as ei:
            client.append("T", "k", "y" * 10_000)
        assert not ei.value.transient
        assert "exceeds server max" in str(ei.value)
        # same socket, next RPC fine
        assert client.topic_exists("T")
        assert client.size("T") == 0  # nothing half-applied
    finally:
        server.close()


def test_tcp_client_defaults_apply_after_configure():
    """A cached tcp client built BEFORE netbroker.configure() ran still
    honors oryx.broker.tcp.* afterwards: defaults resolve at call time,
    not at construction (layer startup order must not eat the config)."""
    from oryx_tpu_torch.common import config as cfg

    client = netbroker.NetBrokerClient("127.0.0.1", 1)
    try:
        config = cfg.overlay_on(
            {"oryx.broker.tcp.request-timeout-sec": 3.5,
             "oryx.broker.tcp.connect-timeout-sec": 1.5,
             "oryx.broker.tcp.max-frame-bytes": 1024},
            cfg.get_default(),
        )
        netbroker.configure(config)
        assert client.request_timeout_sec == 3.5
        assert client.connect_timeout_sec == 1.5
        assert client.max_frame_bytes == 1024
        # explicit constructor overrides still win over process defaults
        pinned = netbroker.NetBrokerClient("127.0.0.1", 1, request_timeout_sec=9.0)
        assert pinned.request_timeout_sec == 9.0
    finally:
        netbroker.configure(cfg.get_default())


def test_rebalance_drops_lost_partition_state():
    """A partition lost to another member leaves no residue: its
    processed_offsets entry disappears on the next poll (a commit loop
    writing them wholesale must never clobber the new owner's position),
    and in committed mode its read position re-resolves from the store."""
    broker = _partitioned_broker("memory:", n=4)
    for i in range(40):
        broker.append("P", f"k{i}", f"m{i}")
    it_a = tp.ConsumeDataIterator(
        broker, "P", "committed", group="g", member_id="a", offset_group="g"
    )
    # alone in the group: a owns all 4 partitions; drain everything
    for _ in range(40):
        next(it_a)
    assert set(it_a.processed_offsets) == {0, 1, 2, 3}
    # b joins: a's assignment shrinks to partitions 0 and 2
    it_b = tp.ConsumeDataIterator(
        broker, "P", "committed", group="g", member_id="b", offset_group="g"
    )
    assert tp.partitions_for_member("a", ["a", "b"], 4) == [0, 2]
    # a's next poll observes the rebalance and sheds the lost partitions
    key0 = next(k for i in range(100)
                for k in [f"x{i}"] if tp.partition_for_key(k, 4) == 0)
    broker.append("P", key0, "for-a")
    assert next(it_a).message == "for-a"
    assert set(it_a.processed_offsets) <= {0, 2}
    assert set(it_a.offsets) <= {0, 2}
    it_a.close()
    it_b.close()


def test_messages_behind_tracks_unprocessed():
    """Advisory lag from read positions: correct for a committed-mode
    consumer that starts mid-topic (total - consumed would report the
    whole history as backlog forever)."""
    broker = tp.get_broker("memory:")
    broker.create_topic("T")
    prod = tp.TopicProducerImpl("memory:", "T")
    for i in range(6):
        prod.send(str(i), f"m{i}")
    broker.set_offset("g", "T", 3)
    it = tp.ConsumeDataIterator(broker, "T", "committed", offset_group="g")
    assert it.messages_behind(broker.total_size("T")) == 0  # not polled yet
    next(it)  # resolves position 3, prefetches 3..6, hands out one
    assert it.messages_behind(broker.total_size("T")) == 2
    next(it)
    next(it)
    assert it.messages_behind(broker.total_size("T")) == 0  # caught up
    prod.send("6", "m6")
    assert it.messages_behind(broker.total_size("T")) == 1  # new backlog
    it.close()


def test_memory_partition_validation_is_typed():
    """Out-of-range partitions raise TopicException from every partitioned
    accessor — never a bare IndexError (the tcp server must answer these
    as typed wire errors, not stack traces)."""
    broker = _partitioned_broker("memory:", n=2)
    broker.append("P", "k", "m")
    for op in (
        lambda: broker.read("P", 0, partition=5),
        lambda: broker.size("P", partition=9),
        lambda: broker.truncate("P", 0, partition=2),
        lambda: broker.read("P", 0, partition=-1),
    ):
        with pytest.raises(tp.TopicException):
            op()
    # in-range still works
    assert broker.size("P", partition=0) + broker.size("P", partition=1) == 1


def test_maybe_create_topics():
    from oryx_tpu_torch.common import config as cfg

    c = cfg.get_default()
    tp.maybe_create_topics(c, "input-topic", "update-topic")
    b = tp.get_broker("memory:")
    assert b.topic_exists("OryxInput") and b.topic_exists("OryxUpdate")


# -- datastore ----------------------------------------------------------


# ---------------------------------------------------------------------------
# Partitions + consumer groups (KafkaUtils.java:63-107,
# oryx-run.sh:345 input topic = 4 partitions)
# ---------------------------------------------------------------------------


def _partitioned_broker(url, n=4):
    broker = tp.get_broker(url)
    broker.create_topic("P", partitions=n)
    return broker


def test_key_hash_partition_routing(broker_url):
    broker = _partitioned_broker(broker_url)
    assert broker.num_partitions("P") == 4
    for i in range(40):
        broker.append("P", f"k{i}", f"m{i}")
    sizes = [broker.size("P", p) for p in range(4)]
    assert sum(sizes) == 40
    assert sum(1 for s in sizes if s > 0) >= 2  # really spread out
    # same key always lands on the same partition (per-key ordering)
    broker.append("P", "k0", "again")
    p0 = tp.partition_for_key("k0", 4)
    msgs = [km.message for km in broker.read("P", 0, 100, partition=p0)]
    assert "m0" in msgs and "again" in msgs
    assert msgs.index("m0") < msgs.index("again")


def test_two_consumer_group_fanout(broker_url):
    """Two consumers in one group split a 4-partition topic: every message is
    seen exactly once across the pair."""
    broker = _partitioned_broker(broker_url)
    for i in range(60):
        broker.append("P", f"k{i}", f"m{i}")
    it1 = tp.ConsumeDataIterator(broker, "P", "earliest", group="g", member_id="c1")
    it2 = tp.ConsumeDataIterator(broker, "P", "earliest", group="g", member_id="c2")
    assert broker.group_members("g", "P") == ["c1", "c2"]
    assert sorted(
        tp.partitions_for_member("c1", ["c1", "c2"], 4)
        + tp.partitions_for_member("c2", ["c1", "c2"], 4)
    ) == [0, 1, 2, 3]

    # The iterator is blocking by design (ConsumeDataIterator.java:30-77), so
    # each consumer drains on its own thread; close() wakes them with
    # StopIteration once everything has been seen.
    got1, got2 = [], []

    def drain(it, got):
        # STOP CONSUMING once the pair has everything, BEFORE any close():
        # closing it1 while it2 still polls is a genuine rebalance — the
        # survivor takes over the departed member's partitions from 0
        # (correct at-least-once takeover in earliest mode with no
        # commits) and would hand out re-read duplicates in the teardown
        # window, flaking the exactly-once assertion below
        try:
            for km in it:
                got.append(km.message)
                if len(got1) + len(got2) >= 60:
                    break
        except Exception:  # noqa: BLE001 — surfaces via the count assert below
            pass

    t1 = threading.Thread(target=drain, args=(it1, got1), daemon=True)
    t2 = threading.Thread(target=drain, args=(it2, got2), daemon=True)
    t1.start()
    t2.start()
    deadline = time.time() + 10
    while len(got1) + len(got2) < 60 and time.time() < deadline:
        time.sleep(0.01)
    it1.close()
    it2.close()
    t1.join(5)
    t2.join(5)
    assert sorted(got1 + got2) == sorted(f"m{i}" for i in range(60))
    assert got1 and got2  # both consumers actually shared the work
    assert not (set(got1) & set(got2))  # no duplicates


def test_group_rebalance_on_leave(broker_url):
    """When a member leaves, the survivor picks up its partitions."""
    broker = _partitioned_broker(broker_url)
    it1 = tp.ConsumeDataIterator(broker, "P", "earliest", group="g", member_id="a")
    it2 = tp.ConsumeDataIterator(broker, "P", "earliest", group="g", member_id="b")
    assert tp.partitions_for_member("a", ["a", "b"], 4) == [0, 2]
    it2.close()  # leaves the group
    assert broker.group_members("g", "P") == ["a"]
    assert tp.partitions_for_member("a", ["a"], 4) == [0, 1, 2, 3]
    for i in range(8):
        broker.append("P", f"k{i}", f"m{i}")
    got = sorted(next(it1).message for _ in range(8))  # sees ALL partitions now
    assert got == sorted(f"m{i}" for i in range(8))
    it1.close()


def test_assignment_expansion_needs_a_stable_view(monkeypatch):
    """Rebalance hysteresis: a consumer must not GROW its
    partition set on a single membership read — a transient view missing a
    live peer (a heartbeat racing the TTL sweep, a blipped RPC) would make
    it claim partitions the peer is still draining and, in earliest mode,
    replay them from offset 0 (duplicate consumption). Expansion must
    survive a second read one beat later; a genuine takeover still lands."""
    broker = _partitioned_broker("memory:")
    it1 = tp.ConsumeDataIterator(broker, "P", "earliest", group="g", member_id="c1")
    it2 = tp.ConsumeDataIterator(broker, "P", "earliest", group="g", member_id="c2")
    assert it1._assigned() == [0, 2]  # steady state

    real = broker.group_members
    calls = {"n": 0}

    def one_bad_view(group, topic):
        calls["n"] += 1
        if calls["n"] == 1:
            return ["c1"]  # transient: c2 missing for exactly one read
        return real(group, topic)

    monkeypatch.setattr(broker, "group_members", one_bad_view)
    # the blip is rejected: the confirming read still shows c2, so the
    # assignment stays put instead of expanding over c2's partitions
    assert it1._assigned() == [0, 2]
    assert calls["n"] >= 2  # a confirming read actually happened

    # a REAL takeover (c2 leaves; absent on BOTH reads) lands normally
    it2.close()
    assert it1._assigned() == [0, 1, 2, 3]
    it1.close()


_REBALANCE_CONSUMER = """
import json, sys
from oryx_tpu_torch.transport import topic as tp

url, topic, member, out_path, ttl = sys.argv[1:6]
tp.GROUP_MEMBER_TTL_SEC = float(ttl)  # file broker reads this at call time
broker = tp.get_broker(url)
it = tp.ConsumeDataIterator(
    broker, topic, "committed", group="g", member_id=member, offset_group="g"
)
out = open(out_path, "a")
for km in it:
    out.write(json.dumps({"key": km.key, "member": member}) + "\\n")
    out.flush()
    # commit the PROCESSED position after handling each message
    for p, off in it.processed_offsets.items():
        broker.set_offset("g", topic, off, p)
"""

_REBALANCE_TTL_SEC = 2.5


@pytest.mark.parametrize("scheme", ["file", "tcp"])
def test_group_rebalance_across_processes(scheme, tmp_path):
    """Cross-process consumer-group rebalance: two REAL subprocess members
    split a 4-partition topic; one is SIGKILLed, its heartbeat TTLs out,
    and the survivor picks up the orphaned partitions resuming from the
    group's committed offsets — every message consumed exactly once, none
    skipped, none re-delivered."""
    if scheme == "file":
        url = f"file:{tmp_path}/broker"
        server = None
    else:
        server = netbroker.NetBrokerServer(
            str(tmp_path / "tcpbroker"), host="127.0.0.1", port=0,
            group_ttl_sec=_REBALANCE_TTL_SEC,
        ).start_background()
        url = f"tcp://127.0.0.1:{server.port}"
    broker = tp.get_broker(url)
    broker.create_topic("P", partitions=4)

    def append_batch(tag: str, n: int) -> list:
        keys = [f"{tag}{i}" for i in range(n)]
        for k in keys:
            broker.append("P", k, f"m-{k}")
        # the batch really covers every partition, so the takeover below is
        # only proven when the survivor consumes ORPHANED partitions too
        assert {tp.partition_for_key(k, 4) for k in keys} == {0, 1, 2, 3}
        return keys

    script = tmp_path / "consumer.py"
    script.write_text(_REBALANCE_CONSUMER)
    ledgers = {m: tmp_path / f"{m}.ledger" for m in ("a", "b")}

    def read_ledger(member: str) -> list:
        if not ledgers[member].exists():
            return []
        return [json.loads(line)["key"]
                for line in ledgers[member].read_text().splitlines() if line]

    # the script lives under tmp_path: python puts the SCRIPT's dir on
    # sys.path, so the repo root must ride PYTHONPATH for oryx_tpu_torch
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = {}
    try:
        for member in ("a", "b"):
            procs[member] = subprocess.Popen(
                [sys.executable, str(script), url, "P", member,
                 str(ledgers[member]), str(_REBALANCE_TTL_SEC)],
                env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
        # produce only once BOTH members are visible: this protocol has no
        # rebalance barrier, so appending while membership is still growing
        # would race a shrinking member's commits against the grower's
        # first-touch offset lookups (steady group -> death is the scenario
        # under test)
        deadline = time.monotonic() + 30
        while set(broker.group_members("g", "P")) < {"a", "b"}:
            assert time.monotonic() < deadline, broker.group_members("g", "P")
            time.sleep(0.1)
        phase1 = append_batch("one-", 24)
        deadline = time.monotonic() + 60
        while len(read_ledger("a")) + len(read_ledger("b")) < 24:
            assert time.monotonic() < deadline, (
                read_ledger("a"), read_ledger("b")
            )
            time.sleep(0.1)
        # both members really shared the work before the failure
        assert read_ledger("a") and read_ledger("b")
        time.sleep(0.3)  # let both commit their last processed offsets

        procs["a"].send_signal(signal.SIGKILL)
        procs["a"].wait(timeout=10)
        phase2 = append_batch("two-", 24)
        deadline = time.monotonic() + 45
        while not set(phase2) <= set(read_ledger("b")):
            assert time.monotonic() < deadline, sorted(
                set(phase2) - set(read_ledger("b"))
            )
            time.sleep(0.1)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        if server is not None:
            server.close()

    got_a, got_b = read_ledger("a"), read_ledger("b")
    everything = sorted(got_a + got_b)
    # exactly once across the pair: zero lost, zero re-delivered — the
    # survivor resumed the dead member's partitions from committed offsets
    assert everything == sorted(phase1 + phase2), everything
    # and the survivor really took over partitions it did not start with:
    # phase-2 keys cover all 4 partitions and all landed in b's ledger
    b_partitions = {tp.partition_for_key(k, 4) for k in got_b if k in phase2}
    assert b_partitions == {0, 1, 2, 3}


def test_per_partition_offset_store(tmp_path):
    broker = tp.get_broker(f"file:{tmp_path}/b")
    broker.create_topic("P", partitions=3)
    for p, off in ((0, 5), (1, 7), (2, 9)):
        broker.set_offset("g", "P", off, partition=p)
    assert [broker.get_offset("g", "P", p) for p in range(3)] == [5, 7, 9]
    # partition 0 keeps the legacy single-partition filename
    assert (tmp_path / "b" / ".offsets" / "g__P.json").exists()


def test_int_start_offset_rejected_on_multipartition():
    broker = _partitioned_broker("memory:")
    with pytest.raises(tp.TopicException):
        tp.ConsumeDataIterator(broker, "P", 3)
    # but a per-partition dict works
    it = tp.ConsumeDataIterator(broker, "P", {0: 0, 1: 0, 2: 0, 3: 0})
    it.close()


def test_datastore_write_read_gc(tmp_path):
    ds = DataStore(str(tmp_path / "data"))
    assert ds.write_segment(1000, []) is None  # empty interval skipped
    ds.write_segment(1000, [KeyMessage("a", "1"), KeyMessage("b", "2")])
    ds.write_segment(2000, [KeyMessage("c", "3")])
    got = list(ds.read_all())
    assert [km.key for km in got] == ["a", "b", "c"]
    # GC with cutoff between segments
    deleted = ds.delete_older_than(1, now_ms=2000 + 3600 * 1000)
    assert len(deleted) == 1
    assert [km.key for km in ds.read_all()] == ["c"]
    # disabled GC
    assert ds.delete_older_than(-1) == []


def test_modelstore_promote_latest_gc(tmp_path):
    ms = ModelStore(str(tmp_path / "model"))
    cand = tmp_path / "cand"
    cand.mkdir()
    (cand / "model.pmml").write_text("<PMML/>")
    d1 = ms.promote(cand, 1000)
    assert (d1 / "model.pmml").exists()
    d2 = ms.new_model_dir(2000)
    assert ms.latest() == d2
    deleted = ms.delete_older_than(1, now_ms=2000 + 3600 * 1000)
    assert deleted == [d1]
    assert ms.model_dirs() == [d2]


# ---------------------------------------------------------------------------
# Durable-log integrity: framing, bit-flips, torn tails, fsync policy
# (the log the checkpoint can trust)
# ---------------------------------------------------------------------------


def _metric(name: str, label: str = "") -> float:
    from oryx_tpu_torch.common import metrics as metrics_mod

    snap = metrics_mod.default_registry().snapshot()
    return snap.get(name, {}).get(label, 0.0)


def test_file_broker_writes_versioned_crc_frames(tmp_path):
    """New appends carry the v1 framing: magic + length prefix + CRC32
    ahead of the JSON payload, one newline-terminated line per record."""
    import zlib

    url = f"file:{tmp_path}/broker"
    broker = tp.get_broker(url)
    broker.create_topic("T")
    broker.append("T", "k1", "hello world", {"h": "v"})
    raw = (tmp_path / "broker" / "T" / "00000.jsonl").read_bytes()
    assert raw.startswith(b"O1 ") and raw.endswith(b"\n")
    _, len_s, crc_s, payload = raw[:-1].split(b" ", 3)
    assert len(payload) == int(len_s)
    assert zlib.crc32(payload) == int(crc_s, 16)
    d = json.loads(payload)
    assert d == {"k": "k1", "m": "hello world", "h": {"h": "v"}}
    # and the decoder round-trips it
    km = tp.decode_record(raw[:-1], "T")
    assert (km.key, km.message, km.headers) == ("k1", "hello world", {"h": "v"})


def test_legacy_bare_json_log_reads_back_compatibly(tmp_path):
    """A pre-framing log (bare JSON lines) written by an old deployment
    reads through the new broker unchanged — records, headers, offsets."""
    d = tmp_path / "broker" / "T"
    d.mkdir(parents=True)
    with open(d / "00000.jsonl", "w") as f:
        f.write('{"k":"a","m":"1"}\n')
        f.write('{"k":"b","m":"2","h":{"traceparent":"00-x-y-01"}}\n')
    broker = tp.get_broker(f"file:{tmp_path}/broker")
    msgs = broker.read("T", 0)
    assert [(km.key, km.message) for km in msgs] == [("a", "1"), ("b", "2")]
    assert msgs[1].headers == {"traceparent": "00-x-y-01"}
    # new appends interleave with legacy lines in the same log
    broker.append("T", "c", "3")
    assert [km.key for km in broker.read("T", 0)] == ["a", "b", "c"]


@pytest.mark.parametrize("scheme", ["file", "tcp"])
def test_corrupt_log_bitflip_and_torn_tail_exactly_once(tmp_path, scheme):
    """THE corrupt-log fixture: flip a byte inside a
    committed record and truncate mid-record at the tail. The consumer
    skips exactly the flipped record (counted), torn-tail recovery
    truncates the partial (counted), offsets stay consistent, and a
    resume-after-restart from committed offsets reads everything else
    exactly once — on both file: and tcp:."""
    root = tmp_path / "broker"
    seed = tp.get_broker(f"file:{root}")
    seed.create_topic("T")
    for i in range(6):
        seed.append("T", str(i), f"m{i}")
    log = root / "T" / "00000.jsonl"
    lines = log.read_bytes().split(b"\n")
    # bit-flip inside committed record 2's JSON payload
    flipped = lines[2][:-1] + bytes([lines[2][-1] ^ 0x01])
    lines[2] = flipped
    log.write_bytes(b"\n".join(lines))
    # torn write at the tail: half of a framed record, no newline
    partial = tp.frame_record(b'{"k":"torn","m":"lost"}')[: 12]
    with open(log, "ab") as f:
        f.write(partial)

    server = None
    if scheme == "tcp":
        server = netbroker.NetBrokerServer(
            str(root), host="127.0.0.1", port=0
        ).start_background()
        broker = tp.get_broker(f"tcp://127.0.0.1:{server.port}")
    else:
        broker = tp.get_broker(f"file:{root}")  # fresh instance: recovery runs
    torn_before = _metric("oryx_broker_torn_tail_records_total", 'topic="T"')
    corrupt_before = _metric("oryx_corrupt_records_total", 'tier="transport"')
    try:
        # size sees 6 committed records (torn tail truncated, flipped one
        # still occupying its offset)
        assert broker.size("T") == 6
        assert _metric(
            "oryx_broker_torn_tail_records_total", 'topic="T"'
        ) == torn_before + 1
        # recovery leaves flight-recorder evidence (byte count included)
        from oryx_tpu_torch.common import blackbox

        torn_events = [e for e in blackbox.events()
                       if e["kind"] == "broker.torn_tail" and e["topic"] == "T"]
        assert torn_events and torn_events[-1]["truncated_bytes"] > 0
        it = tp.ConsumeDataIterator(broker, "T", "earliest")
        got = [next(it).key for _ in range(5)]
        assert got == ["0", "1", "3", "4", "5"]  # exactly the bad one skipped
        assert it.offset == 6  # offsets aligned across the corrupt slot
        assert _metric(
            "oryx_corrupt_records_total", 'tier="transport"'
        ) == corrupt_before + 1
        # commit after processing record "3" (position 4), restart: the
        # resumed consumer re-reads exactly the rest, once
        broker.set_offset("g", "T", 4)
        it.close()
        it2 = tp.ConsumeDataIterator(broker, "T", "committed", group="g")
        assert [next(it2).key for _ in range(2)] == ["4", "5"]
        it2.close()
        # the recovered log is healthy: appends land and read back
        broker.append("T", "post", "alive")
        assert [km.key for km in broker.read("T", 6)] == ["post"]
    finally:
        if server is not None:
            server.close()


def test_fsync_policy_counters_and_validation(tmp_path):
    from oryx_tpu_torch.common import config as cfg

    url = f"file:{tmp_path}/broker"
    broker = tp.get_broker(url)
    broker.create_topic("T")
    base = cfg.get_default()
    try:
        tp.configure(cfg.overlay_on({"oryx.broker.file.fsync": "always"}, base))
        before = _metric("oryx_broker_fsyncs_total")
        for i in range(4):
            broker.append("T", str(i), "x")
        assert _metric("oryx_broker_fsyncs_total") == before + 4
        # interval: one fsync per window per partition (window >> test)
        tp.configure(cfg.overlay_on(
            {"oryx.broker.file.fsync": "interval",
             "oryx.broker.file.fsync-interval-ms": 60_000}, base))
        fresh = tp.get_broker(url)  # fresh instance: no fsync bookkeeping yet
        before = _metric("oryx_broker_fsyncs_total")
        for i in range(4):
            fresh.append("T", str(i), "x")
        assert _metric("oryx_broker_fsyncs_total") == before + 1
        # never: no fsyncs at all
        tp.configure(cfg.overlay_on({"oryx.broker.file.fsync": "never"}, base))
        before = _metric("oryx_broker_fsyncs_total")
        broker.append("T", "n", "x")
        assert _metric("oryx_broker_fsyncs_total") == before
        with pytest.raises(tp.TopicException):
            tp.configure(cfg.overlay_on(
                {"oryx.broker.file.fsync": "sometimes"}, base))
    finally:
        tp.configure(base)


def test_fsync_fault_degrades_durability_not_availability(tmp_path):
    """broker.fsync=fail:2 under fsync=always: appends still succeed (no
    raise, no duplicate-inducing retry), the injections are visible, and
    later fsyncs land."""
    from oryx_tpu_torch.common import config as cfg
    from oryx_tpu_torch.common import faults

    url = f"file:{tmp_path}/broker"
    broker = tp.get_broker(url)
    broker.create_topic("T")
    base = cfg.get_default()
    tp.configure(cfg.overlay_on({"oryx.broker.file.fsync": "always"}, base))
    before = _metric("oryx_broker_fsyncs_total")
    faults.arm("broker.fsync=fail:2", seed=0)
    try:
        for i in range(4):
            broker.append("T", str(i), "x")
        stats = faults.stats()["broker.fsync"]
        assert stats["injected"] == 2
    finally:
        faults.disarm()
        tp.configure(base)
    assert broker.size("T") == 4  # every append applied
    assert _metric("oryx_broker_fsyncs_total") == before + 2  # 2 of 4 landed


# ---------------------------------------------------------------------------
# Cross-package parity: the file: log is the shared format
# ---------------------------------------------------------------------------

_RECORDS = [
    ("k0", "plain"),
    (None, "no key"),
    ("ü-key", "ünïcödé ☃ and \"quotes\"\nnewline"),
    ("UP", json.dumps(["Y", "i1", [0.5, -1.25e-7, 3.0]])),
    ("MODEL", "<PMML " + "x" * 5000 + "/>"),
]
_HEADERS = [None, {"traceparent": "00-abc-def-01"}, {"x-oryx-watermark": "{}"},
            None, {"a": "1", "b": "ü"}]


def _payloads():
    for (k, m), h in zip(_RECORDS, _HEADERS):
        d = {"k": k, "m": m}
        if h:
            d["h"] = h
        yield json.dumps(d).encode("utf-8")


def test_frame_and_decode_match_the_reference():
    for payload in _payloads():
        framed = tp.frame_record(payload)
        assert framed == ref_tp.frame_record(payload)
        line = framed[:-1]
        flipped = line[:-1] + bytes([line[-1] ^ 0x01])
        for raw in (line, flipped, line[:12], payload, b"NOT JSON", b"O1 x y z"):
            got, want = tp.decode_record(raw, "T"), ref_tp.decode_record(raw, "T")
            if want is ref_tp.CORRUPT_RECORD:
                assert got is tp.CORRUPT_RECORD, raw
            else:
                assert (got.key, got.message, got.headers) == (
                    want.key, want.message, want.headers)


def _write(mod, root, partitions=3):
    broker = mod.FileBroker(str(root))
    broker.create_topic("T", partitions=partitions)
    for i, ((k, m), h) in enumerate(zip(_RECORDS * 3, _HEADERS * 3)):
        broker.append("T", k, f"{i}:{m}", h)
    for p in range(partitions):
        broker.set_offset("g", "T", broker.size("T", p) - 1, p)
    return broker


def _read_all(broker, partitions=3):
    return [[(km.key, km.message, km.headers)
             for km in broker.read("T", 0, partition=p)]
            for p in range(partitions)]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_file_log_and_offsets_read_whole_by_the_other_package(tmp_path, writer):
    w_mod, r_mod = (ref_tp, tp) if writer == "reference" else (tp, ref_tp)
    written = _write(w_mod, tmp_path / "b")
    reader = r_mod.FileBroker(str(tmp_path / "b"))
    assert reader.topic_exists("T") and reader.num_partitions("T") == 3
    assert _read_all(reader) == _read_all(written)
    assert sum(len(p) for p in _read_all(reader)) == 3 * len(_RECORDS)
    for p in range(3):
        assert reader.get_offset("g", "T", p) == written.get_offset("g", "T", p)
    # and the reader's consumer resumes from the writer's stored offsets
    it = r_mod.ConsumeDataIterator(reader, "T", "committed", offset_group="g")
    got = sorted(next(it).message for _ in range(3))
    it.close()
    assert got == sorted(m[-1][1] for m in _read_all(written))


def test_both_packages_write_the_same_log_bytes(tmp_path):
    _write(ref_tp, tmp_path / "ref")
    _write(tp, tmp_path / "port")
    files = sorted(p.relative_to(tmp_path / "ref")
                   for p in (tmp_path / "ref").rglob("*") if p.is_file())
    assert any(f.suffix == ".jsonl" for f in files)
    assert any(".offsets" in f.parts for f in files)
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (
            tmp_path / "ref" / f).read_bytes(), f


def test_torn_tail_and_bitflip_recovered_alike(tmp_path):
    seed = ref_tp.FileBroker(str(tmp_path / "seed"))
    seed.create_topic("T")
    for i in range(6):
        seed.append("T", str(i), f"m{i}")
    log = tmp_path / "seed" / "T" / "00000.jsonl"
    lines = log.read_bytes().split(b"\n")
    lines[2] = lines[2][:-1] + bytes([lines[2][-1] ^ 0x01])
    log.write_bytes(b"\n".join(lines))
    with open(log, "ab") as f:
        f.write(tp.frame_record(b'{"k":"torn","m":"lost"}')[:12])
    shutil.copytree(tmp_path / "seed", tmp_path / "ref")
    shutil.copytree(tmp_path / "seed", tmp_path / "port")
    ref_b = ref_tp.FileBroker(str(tmp_path / "ref"))
    port_b = tp.FileBroker(str(tmp_path / "port"))
    assert port_b.size("T") == ref_b.size("T") == 6
    got = [km if km is tp.CORRUPT_RECORD else (km.key, km.message)
           for km in port_b.read("T", 0)]
    want = [tp.CORRUPT_RECORD if km is ref_tp.CORRUPT_RECORD else (km.key, km.message)
            for km in ref_b.read("T", 0)]
    assert got == want and got[2] is tp.CORRUPT_RECORD
    recovered = (tmp_path / "port" / "T" / "00000.jsonl").read_bytes()
    assert recovered == (tmp_path / "ref" / "T" / "00000.jsonl").read_bytes()
    assert len(recovered) < len(log.read_bytes())
    port_b.append("T", "post", "alive")
    ref_b.append("T", "post", "alive")
    assert (tmp_path / "port" / "T" / "00000.jsonl").read_bytes() == (
        tmp_path / "ref" / "T" / "00000.jsonl").read_bytes()


def test_memory_brokers_are_separate_and_tcp_waits(tmp_path):
    """Each package keeps its own memory: registry (a parity test never
    shares one), and a tcp:// URL resolves to one cached port client per
    URL, which reset_tcp_clients drops (the next get_broker builds anew)."""
    tp.get_broker("memory:").create_topic("T")
    assert not ref_tp.get_broker("memory:").topic_exists("T")
    url = "tcp://127.0.0.1:1"
    client = tp.get_broker(url)
    assert isinstance(client, netbroker.NetBrokerClient)
    assert (client.host, client.port) == ("127.0.0.1", 1)
    assert tp.get_broker(url) is client
    assert tp.get_broker("tcp://127.0.0.1:2") is not client
    tp.reset_tcp_clients()
    assert tp.get_broker(url) is not client
    with pytest.raises(tp.TopicException, match="bad tcp broker url"):
        tp.get_broker("tcp://nohost")
