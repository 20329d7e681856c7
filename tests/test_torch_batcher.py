"""The port's request coalescer, held to the reference's tests.

The ten cases of ``tests/test_batcher.py`` that drive ``TopNCoalescer``
directly run here with the reference test's own bodies, rebound to the
port's ``TopNCoalescer`` (:func:`_mirror`): the same fake model, the same
assertions. The eleventh, 24 concurrent HTTP ``/recommend`` requests
sharing few device calls, runs on the port's layer and model
(``device="cpu"``), its answers held against the model's own ``top_n``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import threading
import time
import types

import httpx
import numpy as np
import pytest
import torch

from oryx_tpu.models.als import data as ref_data
from oryx_tpu.models.als import pmml_codec as ref_als_codec
from oryx_tpu.models.als import train as ref_train
from oryx_tpu.pmml import pmmlutils as ref_pmmlutils
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.models.als.serving import ALSServingModel
from oryx_tpu_torch.serving import batcher
from oryx_tpu_torch.serving.app import ServingLayer
from oryx_tpu_torch.transport import topic as tp

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)


def _mirror(ref_test: str, swap: dict) -> dict:
    """The namespace of the reference test file ``ref_test`` with its
    module-level functions rebound to globals in which ``swap`` replaces
    the reference's modules and classes by the port's: each test body and
    helper then runs unchanged against the port."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), ref_test)
    spec = importlib.util.spec_from_file_location(
        "_reference_" + ref_test[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    ns = dict(vars(module))
    ns.update(swap)
    for name, fn in vars(module).items():
        if isinstance(fn, types.FunctionType) and fn.__module__ == module.__name__:
            rebound = types.FunctionType(fn.__code__, ns, name, fn.__defaults__,
                                         fn.__closure__)
            rebound.__dict__.update(fn.__dict__)
            ns[name] = rebound
    return ns


_REF = _mirror("test_batcher.py", {"TopNCoalescer": batcher.TopNCoalescer})
test_concurrent_requests_coalesce_into_one_call = _REF[
    "test_concurrent_requests_coalesce_into_one_call"]
test_offset_and_how_many_are_per_request = _REF[
    "test_offset_and_how_many_are_per_request"]
test_exclusions_and_allowed_ride_along = _REF[
    "test_exclusions_and_allowed_ride_along"]
test_max_batch_flushes_early = _REF["test_max_batch_flushes_early"]
test_closed_loop_clients_batch_while_busy = _REF[
    "test_closed_loop_clients_batch_while_busy"]
test_inflight_cap_holds_across_model_groups = _REF[
    "test_inflight_cap_holds_across_model_groups"]
test_deadline_bounds_queue_wait_behind_inflight_batches = _REF[
    "test_deadline_bounds_queue_wait_behind_inflight_batches"]
test_deadline_disabled_keeps_strict_inflight_cap = _REF[
    "test_deadline_disabled_keeps_strict_inflight_cap"]
test_device_call_failure_fails_only_that_batch = _REF[
    "test_device_call_failure_fails_only_that_batch"]
test_dispatch_failure_releases_inflight_and_fails_futures = _REF[
    "test_dispatch_failure_releases_inflight_and_fails_futures"]


def test_mirrored_cases_run_the_ports_coalescer():
    """Each mirrored case runs the reference's body on the port's
    ``TopNCoalescer``; every reference case but the HTTP one (below) is
    mirrored."""
    mirrored = {n for n, v in globals().items()
                if n.startswith("test_") and v is _REF.get(n)}
    for name in mirrored:
        assert globals()[name].__globals__["TopNCoalescer"] is batcher.TopNCoalescer
    assert {n for n in _REF if n.startswith("test_")} - mirrored == {
        "test_http_concurrent_recommends_share_device_calls"}


def test_http_concurrent_recommends_share_device_calls(monkeypatch, tmp_path):
    """End-to-end: 24 concurrent HTTP /recommend requests must produce far
    fewer top_n_batch device calls, with correct per-user answers."""
    tp.reset_memory_brokers()
    rng = np.random.default_rng(1)
    scores = rng.standard_normal((24, 3)) @ rng.standard_normal((3, 30))
    lines = [
        f"u{u:02d},i{i},1,{u * 100 + int(i)}"
        for u in range(24)
        for i in np.argsort(-scores[u])[:5]
    ]
    batch = ref_data.prepare(lines, implicit=True)
    x, y = ref_train.als_train(batch, features=4, lam=0.001, alpha=1.0,
                               implicit=True, iterations=3, chunk=256)
    pmml = ref_als_codec.model_to_pmml(
        np.asarray(x), np.asarray(y), batch.users.index_to_id,
        batch.items.index_to_id, 4, 0.001, 1.0, True, False, 1e-5, tmp_path,
    )

    calls = {"n": 0, "sizes": []}
    orig = ALSServingModel.top_n_batch

    def counting(self, qs, how_many, alloweds=None, excluded=None):
        calls["n"] += 1
        calls["sizes"].append(len(qs))
        return orig(self, qs, how_many, alloweds, excluded)

    monkeypatch.setattr(ALSServingModel, "top_n_batch", counting)

    port = ioutils.choose_free_port()
    config = cfg.overlay_on(
        {
            "oryx.serving.api.port": port,
            "oryx.serving.model-manager-class":
                "oryx_tpu_torch.models.als.serving.ALSServingModelManager",
            "oryx.serving.application-resources":
                "oryx_tpu_torch.serving.resources.als",
            "oryx.serving.compute.coalesce-window-ms": 5.0,
        },
        cfg.get_default(),
    )
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    prod = tp.TopicProducerImpl("memory:", "OryxUpdate")
    prod.send("MODEL", ref_pmmlutils.to_string(pmml))
    for id_, vec in ref_als_codec.read_features(tmp_path / "Y"):
        prod.send("UP", json.dumps(["Y", id_, [float(v) for v in vec]]))
    for id_, vec in ref_als_codec.read_features(tmp_path / "X"):
        prod.send("UP", json.dumps(["X", id_, [float(v) for v in vec]]))
    layer = ServingLayer(config, device="cpu")
    layer.start()
    try:
        base = f"http://127.0.0.1:{port}"
        with httpx.Client(base_url=base, timeout=30) as client:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if client.get("/ready").status_code == 200:
                    break
                time.sleep(0.1)
            else:
                pytest.fail("serving layer never became ready")
            assert client.get("/recommend/u00").status_code == 200

        calls["n"], calls["sizes"] = 0, []
        answers: dict[str, list] = {}
        # pre-open connections and release all requests together: the test
        # is about coalescing CONCURRENT arrivals, not thread-start stagger
        barrier = threading.Barrier(24, timeout=30)

        def fetch(u: str):
            with httpx.Client(base_url=base, timeout=60) as client:
                client.get("/ready")
                barrier.wait()
                r = client.get(f"/recommend/{u}?howMany=4")
                assert r.status_code == 200
                answers[u] = r.json()

        threads = [
            threading.Thread(target=fetch, args=(f"u{u:02d}",))
            for u in range(24)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(answers) == 24
        # far fewer device calls than requests (perfect coalescing would be
        # 1; scheduling jitter allows a few flushes)
        assert calls["n"] <= 12, (calls["n"], calls["sizes"])
        # batches pad to powers of two, so the model saw >= 24 rows in
        # pow2-sized batches
        assert sum(calls["sizes"]) >= 24
        assert all(s & (s - 1) == 0 for s in calls["sizes"]), calls["sizes"]
        # answers are per-user correct: compare against the direct model path
        model = layer.manager.get_model()
        for u in ("u00", "u11", "u23"):
            uv = model.get_user_vector(u)
            want = model.top_n(uv, 4, excluded=model.get_known_items(u))
            got = [e["id"] for e in answers[u]]
            assert got == [i for i, _ in want]
    finally:
        layer.close()
        tp.reset_memory_brokers()
