"""The port's lambda runtime, held to the reference's.

* The four cases of ``tests/test_lambda.py`` on the port's ``BatchLayer``
  and ``SpeedLayer`` over ``memory:`` topics, configured for the CPU
  (``oryx.<tier>.streaming.config.platform = "cpu"``).
* Quarantine and ``fatal-on-error``, with a fault armed at
  ``batch.generation`` through the port's ``faults``.
* Both packages' ``BatchLayer`` and ``SpeedLayer`` run side by side, each
  on its own ``memory:`` broker or ``file:`` log, with the same update and
  manager classes and the same input (a poison generation, corrupt
  records): what they publish, store and count is the reference's.
* The whole ALS loop at a small size (``BatchLayer`` → update topic →
  ``SpeedLayer`` → a serving manager, on the CPU through the compute
  context): the speed layer's ``UP`` stream is, byte for byte, what the
  port's ``ALSSpeedModelManager`` emits when it is called directly on the
  same ``MODEL`` + ``UP`` stream and the same lines, and a serving manager
  fed by the topic gives the top-N of one fed by hand.
* The copied hook modules against the reference on the same inputs:
  ``resilience.RetryPolicy``'s backoff with a seeded jitter and its retry
  accounting, ``faults``' schedule parsing and firing, the ``metrics``
  text rendering of a registry, ``spans``' traceparent injection and
  parsing, and ``classutils``; then the port's own changes: the
  one-device ``ComputeContext``, ``StepTracer``'s ``profile-dir``
  (taken, captured only with tracing enabled), and the flight recorder's
  bundle.
"""

from __future__ import annotations

import json
import random
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from oryx_tpu.api import batch as ref_api_batch
from oryx_tpu.api import speed as ref_api_speed
from oryx_tpu.common import blackbox as ref_blackbox
from oryx_tpu.common import classutils as ref_classutils
from oryx_tpu.common import config as ref_cfg
from oryx_tpu.common import faults as ref_faults
from oryx_tpu.common import lineage as ref_lineage
from oryx_tpu.common import metrics as ref_metrics
from oryx_tpu.common import resilience as ref_resilience
from oryx_tpu.common import spans as ref_spans
from oryx_tpu.lambda_rt import batch as ref_batch
from oryx_tpu.lambda_rt import speed as ref_speed
from oryx_tpu.transport import topic as ref_tp
from oryx_tpu_torch.api.batch import BatchLayerUpdate
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.api.speed import AbstractSpeedModelManager
from oryx_tpu_torch.common import blackbox
from oryx_tpu_torch.common import classutils
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import faults
from oryx_tpu_torch.common import lineage
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import rand
from oryx_tpu_torch.common import resilience
from oryx_tpu_torch.common import spans
from oryx_tpu_torch.common.tracing import StepTracer
from oryx_tpu_torch.lambda_rt.batch import BatchLayer
from oryx_tpu_torch.lambda_rt.speed import SpeedLayer
from oryx_tpu_torch.models.als.serving import ALSServingModelManager
from oryx_tpu_torch.models.als.speed import ALSSpeedModelManager
from oryx_tpu_torch.parallel.mesh import ComputeContext
from oryx_tpu_torch.transport import topic as tp
from chip_smoke import LambdaLoop, settle_solvers, wait_until

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_brokers():
    for mod in (tp, ref_tp):
        mod.reset_memory_brokers()
    for mod in (faults, ref_faults):
        mod.disarm()
    yield
    for mod in (faults, ref_faults):
        mod.disarm()
    for mod in (tp, ref_tp):
        mod.reset_memory_brokers()


def _counter(name: str, label: str = "") -> float:
    snap = metrics_mod.default_registry().snapshot()
    return snap.get(name, {}).get(label, 0.0)


# -- the four cases of tests/test_lambda.py ------------------------------------------

RECORDED = {}


class MockBatchUpdate(BatchLayerUpdate):
    """Records calls (reference MockBatchUpdate)."""

    def __init__(self, config=None):
        pass

    def run_update(self, context, timestamp_ms, new_data, past_data, model_dir, producer):
        RECORDED.setdefault("calls", []).append(
            {
                "ts": timestamp_ms,
                "new": [km.message for km in new_data],
                "past": [km.message for km in past_data],
                "device": str(context.device),
            }
        )
        producer.send("MODEL", f"model-at-{timestamp_ms}")


class MockSpeedManager(AbstractSpeedModelManager):
    def __init__(self, config=None):
        self.consumed = []

    def consume_key_message(self, key, message):
        self.consumed.append((key, message))
        RECORDED.setdefault("speed-consumed", []).append((key, message))

    def build_updates(self, new_data):
        return [f"count,{len(new_data)}"]


def _conf(tmp_path, tier_class_key, clazz, extra=None):
    over = {
        "oryx.id": "test",
        tier_class_key: clazz,
        "oryx.batch.storage.data-dir": str(tmp_path / "data"),
        "oryx.batch.storage.model-dir": str(tmp_path / "model"),
        "oryx.batch.streaming.config.platform": "cpu",
        "oryx.speed.streaming.config.platform": "cpu",
        "oryx.resilience.retry.base-delay-ms": 1,
        "oryx.resilience.retry.max-delay-ms": 5,
    }
    over.update(extra or {})
    return cfg.overlay_on(over, cfg.get_default())


def test_batch_layer_end_to_end(tmp_path):
    RECORDED.clear()
    config = _conf(tmp_path, "oryx.batch.update-class", f"{__name__}.MockBatchUpdate")
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    producer = tp.TopicProducerImpl("memory:", "OryxInput")

    layer = BatchLayer(config)
    layer.start(interval_sec=0.2)
    try:
        producer.send("k1", "a,1")
        producer.send("k2", "b,2")

        # the two sends can straddle a 0.2 s tick: poll the CUMULATIVE
        # new-data view, as the reference's test does
        def new_seen():
            return [m for c in RECORDED.get("calls", []) for m in c["new"]]

        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and len(new_seen()) < 2:
            time.sleep(0.05)
        assert new_seen() == ["a,1", "b,2"]
        assert RECORDED["calls"][0]["past"] == []
        assert RECORDED["calls"][0]["device"] == "cpu"

        producer.send("k3", "c,3")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and "c,3" not in new_seen():
            time.sleep(0.05)
        third = next((c for c in RECORDED["calls"] if "c,3" in c["new"]),
                     None)
        assert third is not None, f"c,3 never consumed: {RECORDED['calls']}"
        assert third["new"] == ["c,3"]
        assert sorted(third["past"]) == ["a,1", "b,2"]

        b = tp.get_broker("memory:")
        updates = b.read("OryxUpdate", 0)
        assert [km.key for km in updates][:2] == ["MODEL", "MODEL"]
        deadline = time.monotonic() + 5
        while (time.monotonic() < deadline
               and len(list(layer.data_store.segments()))
               < len(RECORDED["calls"])):
            time.sleep(0.05)
        assert (len(list(layer.data_store.segments()))
                == len(RECORDED["calls"]))
    finally:
        layer.close()


def test_batch_layer_skips_empty_generation(tmp_path):
    RECORDED.clear()
    config = _conf(tmp_path, "oryx.batch.update-class", f"{__name__}.MockBatchUpdate")
    layer = BatchLayer(config)
    layer.start(interval_sec=0.1)
    try:
        time.sleep(0.4)
        assert not RECORDED.get("calls")
    finally:
        layer.close()


def test_speed_layer_end_to_end(tmp_path):
    RECORDED.clear()
    config = _conf(tmp_path, "oryx.speed.model-manager-class", f"{__name__}.MockSpeedManager")
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    b = tp.get_broker("memory:")
    tp.TopicProducerImpl("memory:", "OryxUpdate").send("MODEL", "mock-model")

    layer = SpeedLayer(config)
    layer.start(interval_sec=0.2)
    try:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not RECORDED.get("speed-consumed"):
            time.sleep(0.05)
        assert ("MODEL", "mock-model") in RECORDED.get("speed-consumed", [])

        tp.TopicProducerImpl("memory:", "OryxInput").send("k", "x,1")
        deadline = time.monotonic() + 5
        up = None
        while time.monotonic() < deadline and up is None:
            msgs = b.read("OryxUpdate", 0)
            ups = [km for km in msgs if km.key == "UP"]
            up = ups[0] if ups else None
            time.sleep(0.05)
        assert up is not None and up.message == "count,1"
        # the fold-in provenance header: the offsets and watermark it read
        wm = lineage.parse_watermark(up.headers)
        assert wm["offsets"] == {"0": 1}
        assert wm["watermark_ms"] == layer.current_input_watermark_ms
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and ("UP", "count,1") not in RECORDED["speed-consumed"]:
            time.sleep(0.05)
        assert ("UP", "count,1") in RECORDED["speed-consumed"]
    finally:
        layer.close()


def test_offsets_resume_batch(tmp_path):
    """Restarted layer with same oryx.id does not re-process consumed input."""
    RECORDED.clear()
    config = _conf(tmp_path, "oryx.batch.update-class", f"{__name__}.MockBatchUpdate")
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    producer = tp.TopicProducerImpl("memory:", "OryxInput")
    layer = BatchLayer(config)
    layer.start(interval_sec=0.15)
    producer.send("k", "first")
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not RECORDED.get("calls"):
        time.sleep(0.05)
    layer.close()
    n_calls = len(RECORDED["calls"])

    layer2 = BatchLayer(config)
    layer2.start(interval_sec=0.15)
    try:
        producer.send("k", "second")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and len(RECORDED["calls"]) <= n_calls:
            time.sleep(0.05)
        newest = RECORDED["calls"][-1]
        assert newest["new"] == ["second"]  # "first" not re-delivered as new
    finally:
        layer2.close()


# -- quarantine and fatal-on-error, through the port's faults ---------------------------


def test_batch_generation_fault_quarantines_and_the_layer_lives(tmp_path):
    """``batch.generation=fail:2`` with one retry: the first generation (the
    poison line) fails twice and is quarantined, its offsets advance past
    it, its data is not persisted, and the next generation runs."""
    RECORDED.clear()
    config = _conf(tmp_path, "oryx.batch.update-class", f"{__name__}.MockBatchUpdate",
                   {"oryx.resilience.generation.max-retries": 1})
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    broker = tp.get_broker("memory:")
    producer = tp.TopicProducerImpl("memory:", "OryxInput")
    producer.send("k", "poison")
    broker.set_offset("OryxGroup-batch-test", "OryxInput", 0)
    before = _counter("oryx_quarantined_generations_total", 'tier="batch"')
    faults.arm("batch.generation=fail:2", seed=0)
    layer = BatchLayer(config)
    layer.start(interval_sec=0.1)
    try:
        wait_until(lambda: _counter("oryx_quarantined_generations_total",
                                    'tier="batch"') - before == 1,
                   5, "the generation was never quarantined")
        assert faults.stats()["batch.generation"]["injected"] == 2
        assert not layer.stopped
        assert not RECORDED.get("calls")  # the update never saw the poison
        wait_until(lambda: broker.get_offset("OryxGroup-batch-test", "OryxInput") == 1,
                   5, "offsets never advanced past the quarantined generation")
        producer.send("k", "good")
        wait_until(lambda: RECORDED.get("calls"), 5, "no generation after it")
        assert RECORDED["calls"][0]["new"] == ["good"]
        assert RECORDED["calls"][0]["past"] == []  # the poison was not persisted
        quarantines = [e for e in blackbox.events() if e["kind"] == "quarantine"
                       and e.get("tier") == "batch"]
        assert quarantines and quarantines[-1]["items"] == 1
    finally:
        layer.close()


def test_batch_fatal_on_error_kills_the_layer_once(tmp_path):
    RECORDED.clear()
    config = _conf(tmp_path, "oryx.batch.update-class", f"{__name__}.MockBatchUpdate",
                   {"oryx.batch.streaming.fatal-on-error": True})
    failures_before = _counter("oryx_layer_failures_total", 'tier="batch"')
    quarantined_before = _counter("oryx_quarantined_generations_total", 'tier="batch"')
    faults.arm("batch.generation=fail:1", seed=0)
    layer = BatchLayer(config)
    layer.start(interval_sec=0.05)
    try:
        wait_until(lambda: layer.stopped, 5, "fatal-on-error never killed the layer")
        assert faults.stats()["batch.generation"] == {"calls": 1, "injected": 1}
        with pytest.raises(faults.InjectedFault):
            layer.await_termination(timeout=5)
        layer.await_termination(timeout=1)  # raised once, then a clean return
        assert _counter("oryx_layer_failures_total",
                        'tier="batch"') - failures_before == 1
        assert _counter("oryx_quarantined_generations_total",
                        'tier="batch"') == quarantined_before
    finally:
        layer.close()


# -- the runtime beside the reference's, each package on its own brokers -----------------

PARITY: dict = {}  # package label -> the calls its update class saw


class _ParityUpdate:
    """A batch update whose output is a function of its input: one ``MODEL``
    naming the new and past lines, stamped from the context through the
    package's ``lineage``, then one ``UP`` per new line."""

    stamps = label = None

    def __init__(self, config=None):
        pass

    def run_update(self, context, timestamp_ms, new_data, past_data, model_dir, producer):
        new = [km.message for km in new_data]
        past = [km.message for km in past_data]
        PARITY[self.label].append({"new": new, "past": past,
                                   "offsets": dict(context.input_offsets)})
        stamped = self.stamps.StampedProducer(producer, self.stamps.make_stamp(
            context, timestamp_ms, 0, 0, len(new), len(past)))
        stamped.send("MODEL", json.dumps({"new": new, "past": past}))
        for m in new:
            stamped.send("UP", f"batch,{m}")


class PortParityUpdate(_ParityUpdate, BatchLayerUpdate):
    stamps, label = lineage, "port"


class RefParityUpdate(_ParityUpdate, ref_api_batch.BatchLayerUpdate):
    stamps, label = ref_lineage, "ref"


class _ParityManager:
    """A speed manager that keeps what it consumes and turns each line into
    one update."""

    def __init__(self, config=None):
        self.consumed = []

    def consume_key_message(self, key, message):
        self.consumed.append((key, message))

    def build_updates(self, new_data):
        return [f"speed,{km.key},{km.message}" for km in new_data]


class PortParityManager(_ParityManager, AbstractSpeedModelManager):
    pass


class RefParityManager(_ParityManager, ref_api_speed.AbstractSpeedModelManager):
    pass


_RUNTIMES = {
    "ref": SimpleNamespace(label="ref", cfg=ref_cfg, tp=ref_tp,
                           faults=ref_faults, metrics=ref_metrics,
                           blackbox=ref_blackbox,
                           BatchLayer=ref_batch.BatchLayer,
                           SpeedLayer=ref_speed.SpeedLayer,
                           update=f"{__name__}.RefParityUpdate",
                           manager=f"{__name__}.RefParityManager"),
    "port": SimpleNamespace(label="port", cfg=cfg, tp=tp, faults=faults,
                            metrics=metrics_mod, blackbox=blackbox,
                            BatchLayer=BatchLayer, SpeedLayer=SpeedLayer,
                            update=f"{__name__}.PortParityUpdate",
                            manager=f"{__name__}.PortParityManager"),
}
#: input slices: the poison generation, two batch generations, one speed
#: generation; on a ``file:`` log the second line of A and of C is
#: bit-flipped on disk before a layer reads it (a corrupt record)
_POISON = ["u0,i0,1,0", "u1,i1,1,1"]
_A = [f"u{j},i{j % 3},1,{10 + j}" for j in range(4)]
_B = [f"u{j},i{j % 2},1,{20 + j}" for j in range(3)]
_C = [f"u{j},i{j % 4},1,{30 + j}" for j in range(5)]
_WALL_CLOCK = ("watermark_ms", "max_event_ms", "published_ms")


def _masked(headers):
    """Headers with what depends on the wall clock or on a random id
    replaced by its type, so the two runs compare."""
    out = {}
    for key, value in (headers or {}).items():
        if key in (lineage.PROVENANCE_HEADER, lineage.WATERMARK_HEADER):
            d = json.loads(value)
            for f in _WALL_CLOCK + ("generation",):
                if f in d:
                    d[f] = type(d[f]).__name__
            value = d
        elif key in (lineage.GENERATION_HEADER, spans.TRACEPARENT):
            value = type(value).__name__
        out[key] = value
    return out


def _flip_record(log_path, index: int) -> None:
    """Change one byte of record ``index``'s payload in place: its CRC no
    longer matches, and every offset stays where it was."""
    raw = log_path.read_bytes().split(b"\n")
    line = raw[index]
    at = line.rindex(b",1,")  # inside the message text
    raw[index] = line[:at] + b";" + line[at + 1:]
    log_path.write_bytes(b"\n".join(raw))


def _run_runtime(pkg, root, scheme: str) -> dict:
    """Drive one package's BatchLayer and SpeedLayer through the slices
    above. Each slice is appended while no layer runs and its layer is then
    started on a stored offset, so every generation reads exactly its
    slice, whatever the host's load."""
    url = f"file:{root / 'topics'}" if scheme == "file" else "memory:parity"
    conf = pkg.cfg.overlay_on({
        "oryx.id": "parity",
        "oryx.input-topic.broker": url,
        "oryx.update-topic.broker": url,
        "oryx.batch.update-class": pkg.update,
        "oryx.speed.model-manager-class": pkg.manager,
        "oryx.batch.storage.data-dir": str(root / "data"),
        "oryx.batch.storage.model-dir": str(root / "model"),
        "oryx.batch.streaming.config.platform": "cpu",
        "oryx.speed.streaming.config.platform": "cpu",
        "oryx.resilience.generation.max-retries": 1,
        "oryx.resilience.retry.base-delay-ms": 1,
        "oryx.resilience.retry.max-delay-ms": 5,
    }, pkg.cfg.get_default())
    tp_ = pkg.tp
    tp_.maybe_create_topics(conf, "input-topic", "update-topic")
    broker = tp_.get_broker(url)
    producer = tp_.TopicProducerImpl(url, "OryxInput")
    registry = pkg.metrics.default_registry()
    before = registry.snapshot()

    def append(lines, corrupt=None):
        start = broker.size("OryxInput")
        for ln in lines:
            producer.send("k", ln)
        if corrupt is not None and scheme == "file":
            _flip_record(root / "topics" / "OryxInput" / "00000.jsonl",
                         start + corrupt)
        return start

    def generation(layer, group):
        end = broker.size("OryxInput")
        layer.start(interval_sec=0.05)
        try:
            wait_until(lambda: broker.get_offset(group, "OryxInput") == end, 10,
                       f"{group} never committed {end}", layers=(layer,))
        finally:
            layer.close()
        layer.await_termination(timeout=0)
        return layer

    broker.set_offset("OryxGroup-batch-parity", "OryxInput", append(_POISON))
    pkg.faults.arm("batch.generation=fail:2", seed=0)
    try:
        generation(pkg.BatchLayer(conf), "OryxGroup-batch-parity")
    finally:
        pkg.faults.disarm()
    append(_A, corrupt=1)
    generation(pkg.BatchLayer(conf), "OryxGroup-batch-parity")
    append(_B)
    batch = generation(pkg.BatchLayer(conf), "OryxGroup-batch-parity")
    broker.set_offset("OryxGroup-speed-parity", "OryxInput", append(_C, corrupt=1))
    speed = pkg.SpeedLayer(conf)
    speed.start(interval_sec=0.05)
    try:
        end = broker.size("OryxInput")
        wait_until(lambda: broker.get_offset("OryxGroup-speed-parity", "OryxInput")
                   == end, 10, "the speed generation", layers=(speed,))
        wait_until(lambda: len(speed.model_manager.consumed)
                   == broker.size("OryxUpdate"), 10,
                   "the speed manager hears the update topic", layers=(speed,))
    finally:
        speed.close()
    speed.await_termination(timeout=0)
    producer.close()

    after = registry.snapshot()

    def delta(name, labels):
        return after.get(name, {}).get(labels, 0.0) - before.get(name, {}).get(labels, 0.0)

    updates = broker.read("OryxUpdate", 0, broker.size("OryxUpdate"))
    quarantines = [e for e in pkg.blackbox.events()
                   if e["kind"] == "quarantine" and e.get("tier") == "batch"]
    return {
        "updates": [(km.key, km.message, _masked(km.headers)) for km in updates],
        "offsets": {g: broker.get_offset(g, "OryxInput") for g in (
            "OryxGroup-batch-parity", "OryxGroup-speed-parity")},
        "segments": [(seg / "part-00000.jsonl").read_bytes()
                     for seg in batch.data_store.segments()],
        "calls": PARITY[pkg.label],
        "consumed": speed.model_manager.consumed,
        "counts": {f"{name}{{{tier}}}": delta(name, f'tier="{tier}"')
                   for name in ("oryx_quarantined_generations_total",
                                "oryx_corrupt_records_total",
                                "oryx_layer_failures_total")
                   for tier in ("batch", "speed")},
        "speed_ups": delta("oryx_speed_updates_published_total", ""),
        "quarantined_items": quarantines[-1]["items"] if quarantines else None,
    }


@pytest.mark.parametrize("scheme", ["memory", "file"])
def test_runtime_publishes_what_the_reference_runtime_publishes(scheme, tmp_path):
    """Both packages' ``BatchLayer`` and ``SpeedLayer``, each on its own
    ``memory:`` broker or ``file:`` log, the same update and manager
    classes, the same input: a poison generation (a fault armed at
    ``batch.generation`` past its one retry), two batch generations and one
    speed generation, with a bit-flipped record in the first batch slice
    and in the speed slice on the ``file:`` log. The update topics (keys,
    messages, headers with the wall-clock fields masked: the lineage stamp's
    offsets, origin and row counts, the watermark header's offsets), the
    stored offsets, the data segments' bytes, the calls the update saw, what
    the speed manager consumed, and the quarantine and corrupt-record counts
    are the reference's."""
    PARITY.clear()
    PARITY.update(ref=[], port=[])
    got = {pkg.label: _run_runtime(pkg, tmp_path / pkg.label, scheme)
           for pkg in _RUNTIMES.values()}
    port, ref = got["port"], got["ref"]
    for key in ref:
        assert port[key] == ref[key], key

    corrupt = 1 if scheme == "file" else 0
    a_kept = [m for j, m in enumerate(_A) if not (corrupt and j == 1)]
    c_kept = [m for j, m in enumerate(_C) if not (corrupt and j == 1)]
    n_a, n_b = len(_POISON) + len(_A), len(_POISON) + len(_A) + len(_B)
    assert port["calls"] == [{"new": a_kept, "past": [], "offsets": {0: n_a}},
                             {"new": _B, "past": a_kept, "offsets": {0: n_b}}]
    assert port["offsets"] == {"OryxGroup-batch-parity": n_b,
                               "OryxGroup-speed-parity": n_b + len(_C)}
    # the poison generation published nothing and persisted nothing
    assert [s.decode().splitlines() for s in port["segments"]] == [
        [json.dumps({"k": "k", "m": m}, separators=(",", ":")) for m in kept]
        for kept in (a_kept, _B)]
    assert port["quarantined_items"] == len(_POISON)
    assert port["counts"] == {
        "oryx_quarantined_generations_total{batch}": 1,
        "oryx_quarantined_generations_total{speed}": 0,
        "oryx_corrupt_records_total{batch}": corrupt,
        "oryx_corrupt_records_total{speed}": corrupt,
        "oryx_layer_failures_total{batch}": 0,
        "oryx_layer_failures_total{speed}": 0}
    updates = port["updates"]
    assert [(k, m) for k, m, _ in updates] == (
        [("MODEL", json.dumps({"new": a_kept, "past": []}))]
        + [("UP", f"batch,{m}") for m in a_kept]
        + [("MODEL", json.dumps({"new": _B, "past": a_kept}))]
        + [("UP", f"batch,{m}") for m in _B]
        + [("UP", f"speed,k,{m}") for m in c_kept])
    assert port["consumed"] == [(k, m) for k, m, _ in updates]
    assert port["speed_ups"] == len(c_kept)
    model_stamp = updates[0][2][lineage.PROVENANCE_HEADER]
    assert model_stamp["offsets"] == {"0": n_a}
    assert (model_stamp["new_rows"], model_stamp["past_rows"]) == (len(a_kept), 0)
    assert model_stamp["watermark_ms"] == "int"
    assert updates[-1][2][lineage.WATERMARK_HEADER] == {
        "offsets": {"0": n_b + len(_C)}, "watermark_ms": "int"}


# -- the whole ALS loop at a small size --------------------------------------------------

N_USERS, N_ITEMS, N_LINES, MICROBATCH = 300, 120, 4_000, 400


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


_LOOP = {
    "oryx.id": "loop",
    "oryx.batch.streaming.config.platform": "cpu",
    "oryx.speed.streaming.config.platform": "cpu",
    "oryx.als.hyperparams.features": 4,
    "oryx.als.iterations": 2,
}


def test_als_loop_through_topics_emits_the_direct_updates(tmp_path):
    """Input topic → BatchLayer (ALSUpdate on the CPU) → update topic →
    SpeedLayer → UPs on the update topic, and a serving manager consuming
    the topic: ``chip_smoke.LambdaLoop``, the smoke's own loop, at a small
    size. Each microbatch is appended just after an idle speed tick, once
    both managers have applied every message and the speed manager's solver
    caches are current, so exactly one speed generation reads it."""
    lines = _loop_lines()
    gen_lines = lines[:N_LINES - 2 * MICROBATCH]
    held_out = lines[N_LINES - 2 * MICROBATCH:]
    loop = LambdaLoop(str(tmp_path), _LOOP, broker="memory:", serving_device="cpu")
    try:
        loop.run_batch(gen_lines, 0.2, 0.5, 120)
        n_gen = loop.update_size()
        generation = loop.broker.read(loop.update_topic, 0, n_gen)
        assert generation[0].key == "MODEL" and n_gen > N_USERS
        context = loop.batch.get_context()
        assert context.device == torch.device("cpu")
        stamp = lineage.parse_stamp(generation[0].headers)
        assert stamp["offsets"] == {"0": len(gen_lines)}
        assert stamp["watermark_ms"] == context.input_watermark_ms
        assert len(loop.batch.data_store.segments()) == 1
        assert loop.broker.get_offset(loop.batch_group, loop.input_topic) == len(gen_lines)

        direct = ALSSpeedModelManager(loop.conf)
        by_hand = ALSServingModelManager(loop.conf, device="cpu")
        for mgr in (direct, by_hand):
            mgr.consume(KeyMessage(km.key, km.message) for km in generation)
        for b in range(2):
            label = f"microbatch {b}"
            loop.settle(30, label)
            settle_solvers([direct.model.xtx_cache, direct.model.yty_cache])
            mb_lines = held_out[b * MICROBATCH:(b + 1) * MICROBATCH]
            mb = loop.microbatch(mb_lines, label, 30)
            want = list(direct.build_updates([KeyMessage(None, ln) for ln in mb_lines]))
            assert len(want) > MICROBATCH // 2
            assert [km.message for km in mb["published"]] == want
            for mgr in (direct, by_hand):
                mgr.consume(KeyMessage("UP", u) for u in want)
        loop.wait_applied(loop.served, loop.update_size(), 30, "serving")
        assert not loop.speed.stopped
    finally:
        loop.close()
    loop.await_layers()
    model, want_model = loop.serving.get_model(), by_hand.get_model()
    users = sorted(model.all_user_ids())
    assert users == sorted(want_model.all_user_ids())
    assert model.all_item_ids() == want_model.all_item_ids()
    qs = np.stack([model.get_user_vector(u) for u in users])
    excluded = [model.get_known_items(u) for u in users]
    assert excluded == [want_model.get_known_items(u) for u in users]
    assert model.top_n_batch(qs, 5, excluded=excluded) == \
        want_model.top_n_batch(qs, 5, excluded=excluded)


def test_smoke_chaos_phase_on_a_small_loop(tmp_path):
    """``chip_smoke.chaos_phase`` on the loop above (300 users x 120 items)
    on the CPU: the generation's update stream bulk-loaded under a ``tcp:``
    broker, a serving layer replaying it, then the breaker's open and
    close, shedding with ``Retry-After``, the 504 with its trace, the
    outage across consumer restarts, the warm window and the close during
    the rebuild storm, every answer held against the loop's model."""
    import chip_smoke as cs

    lines = _loop_lines()[:N_LINES - 2 * MICROBATCH]
    loop = LambdaLoop(str(tmp_path), {**_LOOP, "oryx.id": "chaos"},
                      broker="memory:", serving_device="cpu")
    try:
        # the generation's split and Y₀ from a fixed seed, whatever ran
        # before in this process: the drill needs every sampled user's 10th
        # score positive, which a random Y₀ on this loop misses about one
        # time in eight
        with rand.seeded(cs.SEED):
            loop.run_batch(lines, 0.2, 0.5, 120)
        loop.settle(30, "before the chaos phase")
        out = cs.chaos_phase(loop, np.random.default_rng(5), device="cpu")
        assert not loop.speed.stopped
    finally:
        loop.close()
    loop.await_layers()
    assert out["update_messages"] == loop.update_size() > N_USERS
    breaker = out["breaker"]
    assert breaker["answers_checked"] >= breaker["degraded_requests"] >= 3
    assert all(n >= 1 for n in breaker["transitions"].values())
    shed = out["shed"]
    assert shed["shed"] == shed["shed_counted"] > 0
    assert set(shed["statuses"]) <= {200, 503} and len(shed["statuses"]) == cs.CHAOS_BURST
    assert out["deadline"]["status"] == 504
    outage = out["outage"]
    assert outage["restarts_while_down"] >= 2 and outage["resume_s"] < 30
    assert out["warm"]["shed"] == 0 and out["warm"]["requests"] == 48
    assert out["close_in_storm"]["join_s"] < cs.CHAOS_JOIN_S
    assert out["close_in_storm"]["threads_left"] == []
    # the coalesced answers, each fault step's, the outage's and the warm
    # window's, all against the loop's model
    assert out["answers_checked"] >= 2 * cs.CHAOS_USERS + 3 + 48
    assert not any(out["launches"].values())


def test_smoke_observability_phase_on_a_small_loop(tmp_path):
    """``chip_smoke.observability_phase`` on the loop above on the CPU: 100
    traced ``/recommend`` from one connection and 25 from each of 16, each
    trace held to the reference's coverage rule; the scrape's exact deltas
    and an OpenMetrics exemplar resolved; one ``/pref`` continued in the
    loop's speed layer; the flight recorder's bundle."""
    import chip_smoke as cs

    lines = _loop_lines()[:N_LINES - 2 * MICROBATCH]
    loop = LambdaLoop(str(tmp_path), {**_LOOP, "oryx.id": "observability"},
                      broker="memory:", serving_device="cpu")
    try:
        with rand.seeded(cs.SEED):
            loop.run_batch(lines, 0.2, 0.5, 120)
        loop.settle(30, "before the observability phase")
        total = loop.update_size()
        out = cs.observability_phase(loop, np.random.default_rng(5), device="cpu")
        assert not loop.speed.stopped
    finally:
        loop.close()
    loop.await_layers()
    sent = sum(c * n for c, n in cs.OBS_LEVELS)
    assert sent == 500
    for (concurrency, per_conn), (key, level) in zip(cs.OBS_LEVELS,
                                                     out["spans"]["levels"].items()):
        assert key == str(concurrency)
        assert level["requests"] == level["checked"] == concurrency * per_conn
        assert 0 <= level["wait_ms"]["p50"] <= level["ingress_ms"]["p99"]
    assert out["spans"]["levels"]["1"]["linked"] == 0
    sizes = out["spans"]["levels"]["16"]["batch_sizes"]
    assert sum(int(b) * n for b, n in sizes.items()) == 400
    scrape = out["scrape"]
    assert scrape["requests_total"] == scrape["batch_size_sum"] == sent
    assert scrape["topn_queries"] >= sent and scrape["queue_depth"] == 0
    assert len(scrape["exemplar"]["trace_id"]) == 32
    hop = out["speed_hop"]
    assert "speed.consume_input" in hop["spans"]
    assert hop["to_consume_input_s"] < cs.OBS_SPEED_S
    assert out["update_messages"] == total and hop["ups"] >= 2
    assert out["bundle"]["versions"]["oryx_tpu_torch"]
    assert out["bundle"]["requests_total"] >= sent
    assert out["threads_left"] == []
    assert not any(out["launches"].values())


# -- the copied hook modules against the reference ------------------------------------


def test_retry_backoff_and_accounting_match_the_reference():
    ours = resilience.RetryPolicy(base_delay_sec=0.1, max_delay_sec=1.0,
                                  rng=random.Random(7))
    ref = ref_resilience.RetryPolicy(base_delay_sec=0.1, max_delay_sec=1.0,
                                     rng=random.Random(7))
    for attempt in range(8):
        cap = min(1.0, 0.1 * 2 ** attempt)
        got = [ours.backoff(attempt) for _ in range(300)]
        assert got == [ref.backoff(attempt) for _ in range(300)]
        assert all(0.0 <= s <= cap for s in got)
        assert min(got) < 0.25 * cap and max(got) > 0.75 * cap

    def flaky(n, exc):
        state = {"calls": 0}

        def fn():
            state["calls"] += 1
            if state["calls"] <= n:
                raise exc("wobble")
            return state["calls"]
        return fn, state

    for mod in (resilience, ref_resilience):
        policy = mod.RetryPolicy(max_attempts=4, base_delay_sec=0.0)
        fn, state = flaky(2, OSError)
        assert policy.call("t.site", fn) == 3
        fn, state = flaky(9, OSError)
        with pytest.raises(OSError):
            policy.call("t.site", fn)
        assert state["calls"] == 4
        fn, state = flaky(1, ValueError)  # not retryable by default
        with pytest.raises(ValueError):
            policy.call("t.site", fn)
        assert state["calls"] == 1
    conf = cfg.overlay_on({"oryx.resilience.retry.max-attempts": 6,
                           "oryx.resilience.retry.base-delay-ms": 3},
                          cfg.get_default())
    p = resilience.RetryPolicy.from_config(conf)
    assert (p.max_attempts, p.base_delay_sec, p.max_delay_sec,
            p.max_elapsed_sec) == (6, 0.003, 2.0, 30.0)


@pytest.mark.parametrize("spec", [
    "t.site=fail:2", "t.rate=rate:0.5", "a=fail;b=rate:0.25;c=latency:1",
    "broker.append=fail:3;serving.device_call=rate:0.1"])
def test_fault_schedules_fire_as_the_reference(spec):
    sites = list(ref_faults.parse_spec(spec))
    assert list(faults.parse_spec(spec)) == sites

    def run(mod, seed):
        mod.arm(spec, seed=seed)
        fired = []
        try:
            for _ in range(64):
                for site in sites + ["unscheduled.site"]:
                    try:
                        mod.maybe_fail(site)
                        fired.append(False)
                    except mod.InjectedFault:
                        fired.append(True)
            return fired, mod.stats()
        finally:
            mod.disarm()

    for seed in (0, 3):
        assert run(faults, seed) == run(ref_faults, seed)
    for bad in ("t.conf=explode:1", "justasite", "=fail:1", "t=fail:x"):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)
        with pytest.raises(ValueError):
            ref_faults.parse_spec(bad)
    faults.maybe_fail(sites[0])  # disarmed: a no-op


def _fill(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("oryx_req_total", "Requests handled", ("route", "status"))
    c.labels("/r", "200").inc(3)
    c.labels('/q"x"\n', "500").inc()
    g = reg.gauge("oryx_inflight", "In flight")
    g.set(2)
    h = reg.histogram("oryx_lat_seconds", "Latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 1.0, 7.0):
        h.observe(v)
    s = reg.histogram("oryx_step_seconds", "Steps", ("tier",),
                      buckets=mod.STEP_BUCKETS)
    s.labels("batch").observe(12.5)
    reg.gauge("oryx_fn", "Function gauge").set_function(lambda: 4.25)

    def boom():
        raise RuntimeError("scrape must survive")

    reg.gauge("oryx_nan", "Failing gauge").set_function(boom)
    return reg


def test_metrics_rendering_matches_the_reference():
    ours, ref = _fill(metrics_mod), _fill(ref_metrics)
    assert ours.render() == ref.render()
    # NaN != NaN: compare the snapshots as JSON text (NaN renders as NaN)
    assert json.dumps(ours.snapshot(), sort_keys=True) == json.dumps(
        ref.snapshot(), sort_keys=True)
    assert ours.render().startswith(
        "# HELP oryx_fn Function gauge\n# TYPE oryx_fn gauge\noryx_fn 4.25\n")
    assert 'oryx_req_total{route="/q\\"x\\"\\n",status="500"} 1\n' in ours.render()
    assert "oryx_nan NaN\n" in ours.render()
    assert metrics_mod.STEP_BUCKETS == ref_metrics.STEP_BUCKETS


def test_spans_traceparent_injection_and_parsing_match_the_reference():
    good = spans.SpanContext(spans.new_trace_id(), spans.new_span_id())
    cases = [
        good.to_traceparent(), good.to_traceparent()[:-2] + "00",
        None, "", "junk", "00-short-short-01",
        "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
        "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
        "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
        "00-" + "g" * 32 + "-" + "b" * 16 + "-01",
        "00-" + "a" * 32 + "-" + "b" * 16 + "-01-extra",
        "01-" + "a" * 32 + "-" + "b" * 16 + "-01-extra",
        " 00-" + "A" * 32 + "-" + "B" * 16 + "-01 ",
    ]
    for value in cases:
        got, want = spans.parse_traceparent(value), ref_spans.parse_traceparent(value)
        assert (got is None) == (want is None), value
        if got is not None:
            assert (got.trace_id, got.span_id, got.sampled) == (
                want.trace_id, want.span_id, want.sampled)
            assert got.to_traceparent() == want.to_traceparent()
    assert spans.inject_headers({"a": "1"}) == {"a": "1"}  # no current span
    with spans.span("test.inject", parent=None, attributes={"route": "t"}) as sp:
        headers = spans.inject_headers({"a": "1"})
    assert headers["a"] == "1"
    parsed = ref_spans.parse_traceparent(headers[spans.TRACEPARENT])
    assert (parsed.trace_id, parsed.span_id) == (sp.trace_id, sp.span_id)
    assert spans.TRACEPARENT == ref_spans.TRACEPARENT


def test_classutils_load_as_the_reference():
    for mod in (classutils, ref_classutils):
        km = mod.load_instance_of("oryx_tpu_torch.api.keymessage.KeyMessage",
                                  None, "k", "m")
        assert (km.key, km.message) == ("k", "m")
        # no (config) constructor: falls back to no-arg
        assert mod.load_instance_of("collections.OrderedDict", None, {}) == {}
        for bad in ("", "NoModule", "no.such.module.C", "json.NoSuchClass"):
            with pytest.raises(ValueError):
                mod.load_class(bad)
        with pytest.raises(TypeError):
            mod.load_instance_of("collections.OrderedDict", BatchLayerUpdate)
        assert mod.class_exists("json.JSONDecoder")


# -- the port's own changes -----------------------------------------------------------------


def test_compute_context_is_one_device_and_refuses_a_mesh():
    def ctx(**over):
        conf = cfg.overlay_on({f"oryx.batch.streaming.config.{k}": v
                               for k, v in over.items()}, cfg.get_default())
        return ComputeContext(conf, "batch")

    c = ctx(platform="cpu")
    assert c.device == torch.device("cpu") and c.num_devices == 1
    assert (c.input_offsets, c.input_watermark_ms, c.lineage_origin) == (None, None, None)
    assert _counter("oryx_build_info", 'version="0.1.0",backend="cpu",device_kind="cpu"') == 1
    assert ctx(platform="cpu", **{"mesh-shape": [1, 1]}).num_devices == 1
    assert c.mesh.shape == {"data": 1, "model": 1}
    # the reference's refusal of a mesh larger than the local devices
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        ctx(platform="cpu", **{"mesh-shape": [2, 1]})
    with pytest.raises(ValueError, match="platform"):
        ctx(platform="tpu")
    for platform in (None, "gpu", "cuda"):
        if torch.cuda.is_available():
            assert ctx(platform=platform).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ctx(platform=platform)


def test_step_tracer_refuses_profile_dir_and_feeds_the_registry(tmp_path):
    """The tracer feeds the registry. It used to refuse
    ``oryx.tracing.profile-dir``; it now takes it, and captures its steps
    only with tracing enabled (the reference's rule)."""
    quiet = StepTracer(cfg.overlay_on(
        {"oryx.tracing.profile-dir": str(tmp_path / "p")}, cfg.get_default()),
        "batch")
    assert quiet.profile_dir == str(tmp_path / "p") and not quiet.enabled
    with quiet.step("generation"):
        pass
    assert not (tmp_path / "p").exists()
    quiet.close()
    key = 'tier="batch",step="generation"'
    before = _counter("oryx_step_items_total", key)
    tracer = StepTracer(cfg.overlay_on({"oryx.tracing.enabled": True},
                                       cfg.get_default()), "batch")
    with tracer.step("generation", n_items=3):
        pass
    with pytest.raises(RuntimeError):
        with tracer.step("generation"):
            raise RuntimeError("must not be swallowed by the finally")
    assert _counter("oryx_step_items_total", key) == before + 3
    assert tracer.metrics()["steps"] == 2 and tracer.metrics()["total_items"] == 3
    tracer.close()


def test_flight_recorder_bundle_names_the_port():
    blackbox.record_event("test.event", severity="info", tier="batch", n=3)
    events = [e for e in blackbox.events() if e["kind"] == "test.event"]
    assert events[-1]["n"] == 3 and events[-1]["tier"] == "batch"
    bundle = blackbox.bundle("test")
    assert bundle["versions"]["oryx_tpu_torch"] == "0.1.0"
    assert bundle["versions"]["torch"] == torch.__version__
    assert "metrics" in bundle and "slowest_traces" in bundle
    # the SLO status and the series window came with common/{slo,tsdb},
    # the memory section with common/profiling
    assert "slo" in bundle and bundle["memory"]["host_rss_bytes"] > 0
    assert not {"memory_error", "slo_error", "history_error"} & set(bundle)
    json.dumps(bundle)
