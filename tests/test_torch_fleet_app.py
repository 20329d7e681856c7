"""Fleet IT support app on the port: a serving model manager with durable
exactly-once generation accounting.

A copy of ``tests/fleet_app.py`` with the manager and its resource on the
port's ``api.serving`` and ``serving.resource``; it holds no tests. The
port's fleet IT (tests/test_torch_fleet.py) runs several REAL serving
replicas (``python -m oryx_tpu_torch.cli serving``, loading this module by
its dotted name ``tests.test_torch_fleet_app``) against one update topic on a
``tcp:`` broker, then ``kill -9``s one mid-stream. This manager makes the
resulting delivery guarantees *measurable*: every applied generation lands
in a per-replica append-only ledger (one fsync'd line per seq), the current
model persists as an atomic snapshot (so a restarted replica is /readyz-
ready from disk before its first redelivered message), and redeliveries in
the crash-overlap window — a generation applied but whose offset commit the
kill preempted — are deduplicated by seq. With the layer running
``oryx.serving.update-resume = "committed"``, the ledger across a kill must
read exactly 1..N, each once, in order: zero lost, zero duplicated.

Update-topic protocol: key ``"GEN"``, message = JSON
``{"seq": n, "words": {...}}`` (each generation is a complete model, like a
MODEL push). HTTP surface: ``GET /fleet/state`` -> the served generation.

Config/env: ``oryx.id`` names the replica; ``ORYX_FLEET_DIR`` holds the
ledger + snapshot files.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path

from aiohttp import web

from oryx_tpu_torch.api.serving import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.common import ioutils


class FleetModel(ServingModel):
    def __init__(self, seq: int, words: dict):
        self.seq = seq
        self.words = words

    def get_fraction_loaded(self) -> float:
        return 1.0


class FleetServingModelManager(AbstractServingModelManager):
    def __init__(self, config):
        super().__init__(config)
        base = Path(os.environ["ORYX_FLEET_DIR"])
        rid = config.get_string("oryx.id")
        self._ledger_path = base / f"{rid}.ledger"
        self._snapshot_path = base / f"{rid}.snapshot.json"
        self._lock = threading.Lock()
        self._model: "FleetModel | None" = None
        self._last_seq = 0
        # messages consumed by THIS incarnation, dup-skips included — the IT
        # asserts it equals (final seq - committed offset at restart), the
        # arithmetic proof the resume was offset-keyed, not a full replay
        self._incarnation_consumed = 0
        if self._snapshot_path.exists():
            snap = json.loads(self._snapshot_path.read_text())
            self._last_seq = int(snap["seq"])
            self._model = FleetModel(self._last_seq, snap["words"])
        # the ledger is the authoritative applied-set: a kill between the
        # ledger fsync and the snapshot write leaves the ledger one seq
        # ahead, and deduping off the snapshot alone would re-append that
        # seq on redelivery (the model itself catches up on the next
        # generation — each is a complete model)
        if self._ledger_path.exists():
            lines = self._ledger_path.read_text().splitlines()
            if lines:
                self._last_seq = max(self._last_seq, int(lines[-1]))

    def consume_key_message(self, key: str, message: str) -> None:
        if key != "GEN":
            raise ValueError(f"bad fleet update key {key!r}")
        gen = json.loads(message)
        seq = int(gen["seq"])
        with self._lock:
            self._incarnation_consumed += 1
            if seq <= self._last_seq:
                # crash-overlap redelivery (applied, offset commit
                # preempted by the kill): exactly-once = at-least-once
                # delivery + idempotent apply
                return
            # durable ledger line BEFORE the snapshot and long before the
            # offset commit (which happens when we ask for the next
            # message) — a kill at any point leaves either an uncommitted
            # applied generation (redelivered, deduped above) or nothing
            with open(self._ledger_path, "a") as f:
                f.write(f"{seq}\n")
                f.flush()
                os.fsync(f.fileno())
            ioutils.atomic_write_text(self._snapshot_path, json.dumps({
                "seq": seq,
                "words": gen["words"],
                "incarnation_consumed": self._incarnation_consumed,
            }))
            self._last_seq = seq
            self._model = FleetModel(seq, gen["words"])

    def get_model(self) -> "FleetModel | None":
        with self._lock:
            return self._model


def register(app: web.Application) -> None:
    from oryx_tpu_torch.serving import resource as rsrc

    async def state(request: web.Request) -> web.Response:
        model = rsrc.get_serving_model(request)  # 503 until a model exists
        return web.json_response({"seq": model.seq, "words": model.words})

    app.router.add_get("/fleet/state", state)
