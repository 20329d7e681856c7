"""The port's ``tcp:`` broker against the reference's, on the wire and on
disk.

* A client of either package against a server of the other: create, an
  append with headers and a retry token (the duplicate is answered, not
  appended), paged reads under a small server frame cap, offsets, a
  consumer group that rebalances when a member leaves, and a typed
  non-transient error for a request over the server's cap.
* The same appends through each package's server leave byte-equal segment
  and offset files.
* The frames the port's client writes for a sequence of calls equal the
  reference client's, captured on a socket pair.
"""

import json
import socket
import threading

import pytest
import torch

from oryx_tpu.transport import netbroker as ref_nb
from oryx_tpu.transport import topic as ref_tp
from oryx_tpu_torch.transport import netbroker as port_nb
from oryx_tpu_torch.transport import topic as port_tp

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

PACKAGES = {"reference": (ref_nb, ref_tp), "port": (port_nb, port_tp)}
# the server's frame cap: a 32 KiB read budget after the 64 KiB envelope
# margin, so twenty 4 KiB messages take several reads
SERVER_CAP = 96 * 1024


@pytest.fixture(autouse=True)
def _fresh_clients():
    for _, tp in PACKAGES.values():
        tp.reset_tcp_clients()
    yield
    for _, tp in PACKAGES.values():
        tp.reset_tcp_clients()


def _serve(nb, root):
    return nb.NetBrokerServer(str(root), host="127.0.0.1", port=0,
                              max_frame_bytes=SERVER_CAP).start_background()


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("reference", "port"), ("port", "reference")])
def test_client_against_the_other_package_server(tmp_path, server_pkg, client_pkg):
    server_nb, _ = PACKAGES[server_pkg]
    client_nb, client_tp = PACKAGES[client_pkg]
    server = _serve(server_nb, tmp_path / "b")
    try:
        client = client_nb.NetBrokerClient("127.0.0.1", server.port,
                                           max_frame_bytes=1 << 26)
        assert client.ping() == {"dir": str(tmp_path / "b"),
                                 "group_ttl_sec": server.group_ttl_sec}
        client.create_topic("T")
        assert client.topic_exists("T") and client.num_partitions("T") == 1
        # an append with headers, retried under the same token
        client.append("T", "k0", "m0", headers={"traceparent": "00-ab-cd-01"},
                      token="tok-0")
        client.append("T", "k0", "m0", headers={"traceparent": "00-ab-cd-01"},
                      token="tok-0")
        assert client.size("T") == 1
        first = client.read("T", 0)[0]
        assert (first.key, first.message, first.headers) == (
            "k0", "m0", {"traceparent": "00-ab-cd-01"})
        # paged reads: a 4 KiB payload twenty times over a 32 KiB budget
        payload = "x" * 4096
        for i in range(1, 21):
            client.append("T", f"k{i}", f"{i}:{payload}", token=f"tok-{i}")
        page = client.read("T", 1)
        assert 1 <= len(page) < 20
        it = client_tp.ConsumeDataIterator(client, "T", "earliest")
        got = [next(it).key for _ in range(21)]
        it.close()
        assert got == [f"k{i}" for i in range(21)]
        # offsets
        assert client.get_offset("g", "T") is None
        client.set_offset("g", "T", 7)
        assert client.get_offset("g", "T") == 7
        # a durable log rebases on truncation
        client.truncate("T", 5)
        assert client.size("T") == 16 and client.read("T", 0)[0].key == "k5"
        # a group of two on four partitions; the survivor takes all four
        client.create_topic("P", partitions=4)
        it1 = client_tp.ConsumeDataIterator(client, "P", "earliest", group="g",
                                            member_id="a")
        it2 = client_tp.ConsumeDataIterator(client, "P", "earliest", group="g",
                                            member_id="b")
        assert client.group_members("g", "P") == ["a", "b"]
        assert it1._assigned() == [0, 2]
        it2.close()
        assert client.group_members("g", "P") == ["a"]
        for i in range(8):
            client.append("P", f"k{i}", f"m{i}")
        assert sorted(next(it1).message for _ in range(8)) == [f"m{i}" for i in range(8)]
        it1.close()
        # over the server's cap: typed, not transient, and the socket lives on
        with pytest.raises(client_tp.TopicException) as ei:
            client.append("T", "big", "y" * (2 * SERVER_CAP))
        assert not ei.value.transient
        assert "exceeds server max" in str(ei.value)
        assert client.size("T") == 16
        assert "oryx_netbroker_frames_total" in client.server_metrics()
        client.delete_topic("T")
        assert not client.topic_exists("T")
        client.close()
    finally:
        server.close()


def _appends(client):
    client.create_topic("T")
    client.create_topic("P", partitions=3)
    for i in range(12):
        client.append("T", f"k{i}", json.dumps({"i": i, "s": "é∑"}),
                      headers={"h": str(i)} if i % 2 else None, token=f"t{i}")
        client.append("P", f"p{i}", f"m{i}")
    client.append("T", "k0", "dup", token="t0")  # answered, not appended
    client.set_offset("g", "T", 5)
    client.set_offset("g", "P", 2, partition=1)


def test_both_servers_leave_the_same_segment_bytes(tmp_path):
    for name, (nb, _) in PACKAGES.items():
        server = _serve(nb, tmp_path / name)
        try:
            _appends(port_nb.NetBrokerClient("127.0.0.1", server.port))
        finally:
            server.close()
    ref_files = sorted(p.relative_to(tmp_path / "reference")
                       for p in (tmp_path / "reference").rglob("*") if p.is_file())
    port_files = sorted(p.relative_to(tmp_path / "port")
                        for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert ref_files == port_files and len(ref_files) >= 5
    for rel in ref_files:
        assert (tmp_path / "port" / rel).read_bytes() == (
            tmp_path / "reference" / rel).read_bytes(), rel


_RESULTS = {"ping": {"dir": "d", "group_ttl_sec": 30.0}, "topic_exists": True,
            "num_partitions": 1, "read": [{"k": "k", "m": "m", "h": None}],
            "size": 3, "total_size": 3, "get_offset": 2, "group_members": ["a"],
            "wait_for_data": {"woken": True, "total": 3}, "metrics": {"text": ""}}


def _capture(nb):
    """Every byte a client of ``nb`` writes for one sequence of calls, on a
    socket pair whose other end answers each frame in order."""
    mine, theirs = socket.socketpair()
    sent = bytearray()

    def answer():
        while True:
            head = theirs.recv(4, socket.MSG_WAITALL)
            if len(head) < 4:
                return
            body = theirs.recv(int.from_bytes(head, "big"), socket.MSG_WAITALL)
            sent.extend(head + body)
            frame = json.loads(body)
            resp = json.dumps({"id": frame["id"], "ok": True,
                               "result": _RESULTS.get(frame["op"])},
                              separators=(",", ":")).encode()
            theirs.sendall(len(resp).to_bytes(4, "big") + resp)

    t = threading.Thread(target=answer, daemon=True)
    t.start()
    client = nb.NetBrokerClient("127.0.0.1", 1)
    client._local.sock, client._local.rid = mine, 0
    client.ping()
    client.create_topic("T", partitions=2)
    client.topic_exists("T")
    client.num_partitions("T")
    client.append("T", "k", "m", headers={"traceparent": "00-1-2-01"}, token="tok")
    client.append("T", None, "é∑ \"q\"")
    client.read("T", 0, max_items=7, partition=1)
    client.size("T", 1)
    client.total_size("T")
    client.truncate("T", 1)
    client.get_offset("g", "T")
    client.set_offset("g", "T", 2, partition=1)
    client.join_group("g", "T", "a")
    client.group_members("g", "T")
    client.leave_group("g", "T", "a")
    client.wait_for_data("T", 3, 0.5)
    client.wake("T")
    client.server_metrics()
    client.delete_topic("T")
    mine.close()
    t.join(5)
    theirs.close()
    return bytes(sent)


def test_client_frames_equal_the_reference_clients():
    port, ref = _capture(port_nb), _capture(ref_nb)
    assert port == ref and ref.count(b'"op":') == 19
