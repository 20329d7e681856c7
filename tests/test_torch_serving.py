"""The port's serving layer over real HTTP, held against the reference's.

Mirrors the thirteen cases of ``tests/test_serving.py`` on the port's
``ServingLayer`` (``device="cpu"``) with the same tiny model (trained by
the reference, published as the same ``MODEL`` + ``UP`` stream), and
``test_kmeans_endpoints`` of ``tests/test_kmeans.py``. Then parity: one
stream into both packages' layers, each on its own ``memory:`` broker and
port, and one list of requests over every ALS route (JSON and CSV, paging,
known items, unknown ids, bad arguments, the writes with gzip and
multipart bodies), compared for status, content type, body (ids equal,
scores within 1e-5 relative in float32), the model-generation header and
what each layer wrote to its input topic; ``/readyz`` before and after the
model; and the k-means routes on both. Last, the port's own rules:
``/debug/profile``, the probes, and a closed layer leaves no thread.
"""

from __future__ import annotations

import gzip
import json
import math
import os
import subprocess
import threading
import time

import httpx
import numpy as np
import pytest
import torch

from oryx_tpu.common import config as ref_cfg
from oryx_tpu.common import ioutils as ref_ioutils
from oryx_tpu.models.als import data as ref_data
from oryx_tpu.models.als import pmml_codec as ref_als_codec
from oryx_tpu.models.als import train as ref_train
from oryx_tpu.models.kmeans import pmml_codec as ref_km_codec
from oryx_tpu.models.kmeans.model import ClusterInfo as RefClusterInfo
from oryx_tpu.models.schema import InputSchema as RefInputSchema
from oryx_tpu.pmml import pmmlutils as ref_pmmlutils
from oryx_tpu.serving.app import ServingLayer as RefServingLayer
from oryx_tpu.transport import topic as ref_tp
from oryx_tpu_torch.common import compilecache
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.models.als.serving import ALSServingModel
from oryx_tpu_torch.serving.app import ServingLayer
from oryx_tpu_torch.transport import topic as tp

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

ALS_MANAGER = "oryx_tpu_torch.models.als.serving.ALSServingModelManager"
ALS_RESOURCES = "oryx_tpu_torch.serving.resources.als"
REF_ALS_MANAGER = "oryx_tpu.models.als.serving.ALSServingModelManager"
REF_ALS_RESOURCES = "oryx_tpu.serving.resources.als"
KM_MANAGER = "oryx_tpu_torch.models.kmeans.serving.KMeansServingModelManager"
KM_RESOURCES = "oryx_tpu_torch.serving.resources.kmeans"
REF_KM_MANAGER = "oryx_tpu.models.kmeans.serving.KMeansServingModelManager"
REF_KM_RESOURCES = "oryx_tpu.serving.resources.kmeans"
REL = 1e-5


# -- the tiny model and its stream (tests/test_serving.py:24-50) --------------


def _train_tiny(tmp_path):
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((25, 3)) @ rng.standard_normal((3, 15))
    lines = []
    for u in range(25):
        for i in np.argsort(-scores[u])[:5]:
            lines.append(f"u{u},i{i},1,{u * 100 + int(i)}")
    batch = ref_data.prepare(lines, implicit=True)
    x, y = ref_train.als_train(batch, features=4, lam=0.001, alpha=1.0,
                               implicit=True, iterations=3, chunk=256)
    pmml = ref_als_codec.model_to_pmml(
        np.asarray(x), np.asarray(y), batch.users.index_to_id,
        batch.items.index_to_id, 4, 0.001, 1.0, True, False, 1e-5, tmp_path,
    )
    known = {}
    for it in ref_data.parse_lines(lines):
        known.setdefault(it.user, []).append(it.item)
    return pmml, batch, known


def _stream(pmml, tmp_path, known) -> list:
    """The ``(key, message)`` stream ``_publish_to_topic`` sends."""
    out = [("MODEL", ref_pmmlutils.to_string(pmml))]
    for id_, vec in ref_als_codec.read_features(tmp_path / "Y"):
        out.append(("UP", json.dumps(["Y", id_, [float(v) for v in vec]])))
    for id_, vec in ref_als_codec.read_features(tmp_path / "X"):
        out.append(("UP", json.dumps(["X", id_, [float(v) for v in vec],
                                      known.get(id_, [])])))
    return out


def _publish(topic_mod, stream, topic: str = "OryxUpdate") -> None:
    prod = topic_mod.TopicProducerImpl("memory:", topic)
    for key, message in stream:
        prod.send(key, message)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("als-model")
    pmml, batch, known = _train_tiny(tmp_path)
    return _stream(pmml, tmp_path, known), batch, known


def _config(port, extra=None, manager=ALS_MANAGER, resources=ALS_RESOURCES):
    return cfg.overlay_on({
        "oryx.serving.api.port": port,
        "oryx.serving.model-manager-class": manager,
        "oryx.serving.application-resources": resources,
        **(extra or {}),
    }, cfg.get_default())


def _wait_ready(client, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if client.get("/ready").status_code == 200:
            return
        time.sleep(0.05)
    pytest.fail("serving layer never became ready")


def _wait_consumed(layer, n: int, timeout: float = 30.0) -> None:
    """Until the layer's consumer has applied ``n`` update-topic messages
    (the manager asks for the next one only after applying the last)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        metered = layer._metered_updates
        if metered is not None and metered._consumed >= n and metered._waiting:
            return
        time.sleep(0.02)
    pytest.fail(f"serving layer did not consume {n} messages")


@pytest.fixture(scope="module")
def serving(tiny):
    stream, batch, known = tiny
    tp.reset_memory_brokers()
    port = ioutils.choose_free_port()
    config = _config(port)
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    _publish(tp, stream)
    layer = ServingLayer(config, device="cpu")
    layer.start()
    client = httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=30)
    _wait_ready(client)
    yield client, layer, batch, known
    client.close()
    layer.close()
    tp.reset_memory_brokers()


# -- tests/test_serving.py, on the port -----------------------------------------


def test_ready_and_unknown_route(serving):
    client = serving[0]
    assert client.get("/ready").status_code == 200
    assert client.get("/nope").status_code == 404


def test_recommend_json_and_csv(serving):
    client, _, batch, known = serving
    user = batch.users.index_to_id[0]
    r = client.get(f"/recommend/{user}")
    assert r.status_code == 200
    recs = r.json()
    assert len(recs) == 10 and {"id", "value"} <= set(recs[0])
    # known items excluded by default
    assert set(known[user]).isdisjoint({x["id"] for x in recs})
    # considerKnownItems=true allows them back
    r2 = client.get(f"/recommend/{user}?considerKnownItems=true&howMany=15")
    ids2 = {x["id"] for x in r2.json()}
    assert set(known[user]) & ids2
    # CSV rendering
    r3 = client.get(f"/recommend/{user}", headers={"Accept": "text/csv"})
    assert r3.status_code == 200
    first = r3.text.splitlines()[0].split(",")
    assert len(first) == 2 and float(first[1])


def test_recommend_params_and_errors(serving):
    client, _, batch, _ = serving
    user = batch.users.index_to_id[0]
    top2 = client.get(f"/recommend/{user}?howMany=2").json()
    paged = client.get(f"/recommend/{user}?howMany=1&offset=1").json()
    assert paged[0]["id"] == top2[1]["id"]
    assert client.get(f"/recommend/{user}?howMany=0").status_code == 400
    assert client.get("/recommend/no-such-user").status_code == 404


def test_recommend_to_many_and_anonymous(serving):
    client, _, batch, _ = serving
    u0, u1 = batch.users.index_to_id[:2]
    r = client.get(f"/recommendToMany/{u0}/{u1}")
    # both users' known items excluded; tiny catalog may not fill howMany
    assert r.status_code == 200 and 0 < len(r.json()) <= 10
    i0, i1 = batch.items.index_to_id[:2]
    r2 = client.get(f"/recommendToAnonymous/{i0}=2/{i1}")
    assert r2.status_code == 200
    ids = {x["id"] for x in r2.json()}
    assert i0 not in ids and i1 not in ids  # context items excluded
    r3 = client.get(f"/recommendWithContext/{u0}/{i0}")
    assert r3.status_code == 200


def test_similarity_and_estimates(serving):
    client, _, batch, _ = serving
    i0, i1 = batch.items.index_to_id[:2]
    u0 = batch.users.index_to_id[0]
    sim = client.get(f"/similarity/{i0}/{i1}")
    assert sim.status_code == 200 and len(sim.json()) > 0
    s2i = client.get(f"/similarityToItem/{i0}/{i1}").json()
    assert len(s2i) == 1 and -1.001 <= s2i[0]["value"] <= 1.001
    est = client.get(f"/estimate/{u0}/{i0}/{i1}").json()
    assert len(est) == 2
    efa = client.get(f"/estimateForAnonymous/{i0}/{i1}=1.5")
    assert efa.status_code == 200
    assert isinstance(efa.json(), float)


def test_because_surprising_known_popular(serving):
    client, _, batch, known = serving
    u0 = batch.users.index_to_id[0]
    some_item = known[u0][0]
    because = client.get(f"/because/{u0}/{some_item}").json()
    assert because and because[0]["id"] in known[u0]
    surprising = client.get(f"/mostSurprising/{u0}").json()
    assert surprising and surprising[0]["id"] in known[u0]
    ki = client.get(f"/knownItems/{u0}").json()
    assert sorted(known[u0]) == ki
    pop = client.get("/mostPopularItems").json()
    assert pop and pop[0]["count"] >= pop[-1]["count"]
    active = client.get("/mostActiveUsers?howMany=3").json()
    assert len(active) == 3
    rep = client.get("/popularRepresentativeItems").json()
    assert len(rep) == 4  # one per feature


def test_all_ids(serving):
    client, _, batch, _ = serving
    users = client.get("/user/allIDs").json()
    items = client.get("/item/allIDs").json()
    assert set(users) == set(batch.users.index_to_id)
    assert set(items) == set(batch.items.index_to_id)


def test_pref_and_ingest_write_input_topic(serving):
    client = serving[0]
    broker = tp.get_broker("memory:")
    before = broker.size("OryxInput")
    assert client.post("/pref/uX/iY", content="3.0").status_code == 200
    assert client.delete("/pref/uX/iY").status_code == 200
    msgs = broker.read("OryxInput", before)
    assert len(msgs) == 2
    assert msgs[0].message.startswith("uX,iY,3.0,")
    assert msgs[1].message.startswith("uX,iY,,")
    assert client.post("/pref/uX/iY", content="junk").status_code == 400
    # bulk ingest incl. gzip
    before = broker.size("OryxInput")
    assert client.post("/ingest", content="a,b,1\nc,d,2\n").status_code == 200
    gz = gzip.compress(b"e,f,3\n")
    assert client.post(
        "/ingest", content=gz, headers={"Content-Encoding": "gzip"}
    ).status_code == 200
    msgs = broker.read("OryxInput", before)
    assert [m.message for m in msgs] == ["a,b,1", "c,d,2", "e,f,3"]


def test_503_before_model_loaded():
    tp.reset_memory_brokers()
    port = ioutils.choose_free_port()
    layer = ServingLayer(_config(port), device="cpu")
    layer.start()
    try:
        with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=10) as c:
            assert c.get("/ready").status_code == 503
            assert c.get("/recommend/u1").status_code == 503
    finally:
        layer.close()
        tp.reset_memory_brokers()


def test_read_only_and_auth():
    tp.reset_memory_brokers()
    port = ioutils.choose_free_port()
    config = _config(port, {
        "oryx.serving.api.read-only": True,
        "oryx.serving.api.user-name": "oryx",
        "oryx.serving.api.password": "pass",
        "oryx.serving.api.auth-scheme": "basic",
    })
    layer = ServingLayer(config, device="cpu")
    layer.start()
    try:
        base = f"http://127.0.0.1:{port}"
        with httpx.Client(base_url=base, timeout=10) as c:
            assert c.post("/ingest", content="a,b,1").status_code == 401  # no auth
        with httpx.Client(base_url=base, timeout=10, auth=("oryx", "pass")) as c:
            assert c.post("/ingest", content="a,b,1").status_code == 403  # read-only
    finally:
        layer.close()
        tp.reset_memory_brokers()


def test_digest_auth():
    """RFC 7616 digest challenge/response, the default scheme."""
    tp.reset_memory_brokers()
    port = ioutils.choose_free_port()
    config = _config(port, {"oryx.serving.api.user-name": "oryx",
                            "oryx.serving.api.password": "pass"})
    layer = ServingLayer(config, device="cpu")
    layer.start()
    try:
        base = f"http://127.0.0.1:{port}"
        with httpx.Client(base_url=base, timeout=10) as c:
            r = c.get("/ready")
            assert r.status_code == 401  # no credentials
            challenges = r.headers.get_list("WWW-Authenticate")
            assert any(ch.startswith("Digest ") for ch in challenges)
            assert any('qop="auth"' in ch for ch in challenges)
            # basic credentials must NOT satisfy a digest realm
            assert c.get("/ready", auth=("oryx", "pass")).status_code == 401
        with httpx.Client(
            base_url=base, timeout=10, auth=httpx.DigestAuth("oryx", "pass")
        ) as c:
            assert c.get("/ready").status_code in (200, 503)  # authed through
        with httpx.Client(
            base_url=base, timeout=10, auth=httpx.DigestAuth("oryx", "WRONG")
        ) as c:
            assert c.get("/ready").status_code == 401
    finally:
        layer.close()
        tp.reset_memory_brokers()


def test_tls_serving(tmp_path, tiny):
    """HTTPS via keystore-file/key-alias config, on a self-signed
    certificate made here (the reference's case serves its word-count
    example, which the port does not have: this one serves the ALS app)."""
    cert = tmp_path / "cert.pem"
    key = tmp_path / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=localhost"],
        check=True, capture_output=True,
    )
    stream, batch, _ = tiny
    tp.reset_memory_brokers()
    port = ioutils.choose_free_port()
    config = _config(port, {
        # TLS binds secure-port (ServingLayer connector split)
        "oryx.serving.api.secure-port": port,
        "oryx.serving.api.keystore-file": str(cert),
        "oryx.serving.api.key-alias": str(key),
    })
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    _publish(tp, stream)
    layer = ServingLayer(config, device="cpu")
    layer.start()
    try:
        with httpx.Client(base_url=f"https://127.0.0.1:{port}", verify=False,
                          timeout=30) as client:
            _wait_ready(client)
            r = client.get(f"/recommend/{batch.users.index_to_id[0]}")
            assert r.status_code == 200 and len(r.json()) == 10
        with pytest.raises(httpx.HTTPError):  # no plaintext on the TLS port
            httpx.get(f"http://127.0.0.1:{port}/ready", timeout=5)
    finally:
        layer.close()
        tp.reset_memory_brokers()


def test_precompile_batches_warms_pow2_ladder(tiny, monkeypatch):
    """With precompile-batches on, a ready model's batched top-N runs in the
    background at pow2 sizes, smallest first, each size without and with
    exclusions. prewarm-swap is off here, so the warmer warms the serving
    generation in place (the staged swap's cases are in
    ``tests/test_torch_staged_swap.py``)."""
    sizes = []
    orig = ALSServingModel.top_n_batch

    def recording(self, qs, how_many, alloweds=None, excluded=None):
        sizes.append(len(qs))
        return orig(self, qs, how_many, alloweds, excluded)

    monkeypatch.setattr(ALSServingModel, "top_n_batch", recording)
    stream = tiny[0]
    tp.reset_memory_brokers()
    config = _config(ioutils.choose_free_port(), {
        "oryx.serving.compute.precompile-batches": True,
        "oryx.compile.prewarm-swap": False,
        "oryx.serving.compute.coalesce-max-batch": 16,
    })
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    _publish(tp, stream)
    layer = ServingLayer(config, device="cpu")
    layer.start()
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if layer._warmer is not None and layer._warmer.warmed_models:
                break
            time.sleep(0.1)
        else:
            pytest.fail("warmer never warmed a model")
        assert sizes[:10] == [1, 1, 2, 2, 4, 4, 8, 8, 16, 16], sizes
        assert compilecache.warmup_state().ready(1.0)
        assert compilecache.warmup_state().snapshot() == {"done": 5, "total": 5}
    finally:
        layer.close()
        tp.reset_memory_brokers()


# -- tests/test_kmeans.py::test_kmeans_endpoints, on the port -------------------


def _km_extra(port) -> dict:
    return {
        "oryx.serving.api.port": port,
        "oryx.input-schema.num-features": 2,
        "oryx.input-schema.categorical-features": [],
        "oryx.kmeans.hyperparams.k": 3,
    }


def _km_model_message(updates: bool = False) -> list:
    """The k-means ``MODEL`` of ``tests/test_kmeans.py`` (two clusters), and
    with ``updates`` two speed ``UP``s after it."""
    schema = RefInputSchema(ref_cfg.overlay_on(_km_extra(0), ref_cfg.get_default()))
    clusters = [RefClusterInfo(0, np.asarray([0.0, 0.0]), 10),
                RefClusterInfo(1, np.asarray([10.0, 10.0]), 10)]
    out = [("MODEL", ref_pmmlutils.to_string(
        ref_km_codec.clustering_model_to_pmml(clusters, schema)))]
    if updates:
        out += [("UP", "[0, [0.5, -0.25], 12]"), ("UP", "[1, [9.0, 11.5], 14]")]
    return out


def test_kmeans_endpoints():
    tp.reset_memory_brokers()
    port = ioutils.choose_free_port()
    config = _config(port, _km_extra(port), KM_MANAGER, KM_RESOURCES)
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    _publish(tp, _km_model_message())
    layer = ServingLayer(config, device="cpu")
    layer.start()
    try:
        with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=30) as client:
            _wait_ready(client)
            assert client.get("/assign/9.5,9.5").text == "1"
            r = client.post("/assign", content="0.1,0.1\n10.1,10.1\n")
            assert r.text.splitlines() == ["0", "1"]
            d = float(client.get("/distanceToNearest/10,11").text)
            assert d == pytest.approx(1.0)
            assert client.get("/assign/bad,datum").status_code == 400
            # /add writes to the input topic
            assert client.post("/add/1.0,2.0").status_code == 204
            assert client.post("/add", content="3,4\n5,6\n").status_code == 204
            broker = tp.get_broker("memory:")
            msgs = [km.message for km in broker.read("OryxInput", 0, 100)]
            assert msgs == ["1.0,2.0", "3,4", "5,6"]
    finally:
        layer.close()
        tp.reset_memory_brokers()


# -- parity with the reference's layer -----------------------------------------


class _Pair:
    """Both packages' layers, each on its own ``memory:`` registry and port."""

    def __init__(self, extra=None, km: bool = False):
        ref_tp.reset_memory_brokers()
        tp.reset_memory_brokers()
        self.ports = (ref_ioutils.choose_free_port(), ioutils.choose_free_port())
        over = dict(_km_extra(0) if km else {})
        over.update(extra or {})
        over.pop("oryx.serving.api.port", None)
        ref_conf = ref_cfg.overlay_on({
            **over, "oryx.serving.api.port": self.ports[0],
            "oryx.serving.model-manager-class":
                REF_KM_MANAGER if km else REF_ALS_MANAGER,
            "oryx.serving.application-resources":
                REF_KM_RESOURCES if km else REF_ALS_RESOURCES,
        }, ref_cfg.get_default())
        conf = _config(self.ports[1], over,
                       KM_MANAGER if km else ALS_MANAGER,
                       KM_RESOURCES if km else ALS_RESOURCES)
        ref_tp.maybe_create_topics(ref_conf, "input-topic", "update-topic")
        tp.maybe_create_topics(conf, "input-topic", "update-topic")
        self.layers = (RefServingLayer(ref_conf), ServingLayer(conf, device="cpu"))
        self.clients = []

    def __enter__(self):
        for layer, port in zip(self.layers, self.ports):
            layer.start()
            self.clients.append(httpx.Client(base_url=f"http://127.0.0.1:{port}",
                                             timeout=30))
        return self

    def __exit__(self, *exc):
        for client in self.clients:
            client.close()
        for layer in self.layers:
            layer.close()
        ref_tp.reset_memory_brokers()
        tp.reset_memory_brokers()

    def publish(self, stream) -> None:
        _publish(ref_tp, stream)
        _publish(tp, stream)
        for layer in self.layers:
            _wait_consumed(layer, len(stream))

    def both(self, method: str, path: str, **kw) -> tuple:
        return tuple(c.request(method, path, **kw) for c in self.clients)

    def inputs(self) -> tuple:
        return tuple([(km.key, km.message) for km in mod.get_broker("memory:").read(
            "OryxInput", 0, 1000)] for mod in (ref_tp, tp))


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=REL, abs_tol=1e-6)


def _same_ranking(a: list, b: list, what: str) -> None:
    """Lists of ``{"id", "value"|"count"}``: scores within ``REL``, and ids
    equal wherever neighbouring scores are not near-ties (a near tie may
    order its ids either way; the group's ids must still match)."""
    assert len(a) == len(b), (what, a, b)
    field = "value" if a and "value" in a[0] else "count"
    sa = [float(e[field]) for e in a]
    sb = [float(e[field]) for e in b]
    assert all(_close(x, y) for x, y in zip(sa, sb)), (what, a, b)
    start = 0
    for i in range(1, len(a) + 1):
        if i == len(a) or not _close(sa[i], sa[i - 1]):
            assert ({e["id"] for e in a[start:i]}
                    == {e["id"] for e in b[start:i]}), (what, a, b)
            start = i


def _same_body(a, b, what: str) -> None:
    if isinstance(a, list) and a and isinstance(a[0], dict) and "id" in a[0]:
        _same_ranking(a, b, what)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (what, a, b)
        for x, y in zip(a, b):
            _same_body(x, y, what)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (what, a, b)
        for k in a:
            _same_body(a[k], b[k], what)
    elif isinstance(a, float) or isinstance(b, float):
        assert _close(float(a), float(b)), (what, a, b)
    else:
        assert a == b, (what, a, b)


def _csv_rows(text: str) -> list:
    """A CSV body's rows: ``id,score`` pairs as ``{"id", "value"}``, a bare
    number as a float, anything else as its text."""
    rows = []
    for line in text.splitlines():
        fields = line.split(",")
        if len(fields) == 2:
            rows.append({"id": fields[0], "value": float(fields[1])})
            continue
        try:
            rows.append(float(line))
        except ValueError:
            rows.append(line)
    return rows


def _same_response(ref, port, what: str, generation: bool) -> None:
    assert ref.status_code == port.status_code, (what, ref.text, port.text)
    ct = ref.headers.get("content-type", "").split(";")[0]
    assert ct == port.headers.get("content-type", "").split(";")[0], what
    if ct == "application/json":
        _same_body(ref.json(), port.json(), what)
    elif ct == "text/csv":
        _same_body(_csv_rows(ref.text), _csv_rows(port.text), what)
    else:
        try:
            assert _close(float(ref.text), float(port.text)), (what, ref.text, port.text)
        except ValueError:
            assert ref.text == port.text, (what, ref.text, port.text)
    present = ("x-oryx-model-generation" in ref.headers,
               "x-oryx-model-generation" in port.headers)
    assert present[0] == present[1], (what, present)
    assert present[1] or not generation, what


def _multipart(parts: list) -> tuple:
    boundary = "oryx-test-boundary"
    body = b""
    for i, (content, ctype) in enumerate(parts):
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="f{i}"; filename="f{i}"\r\n'
                 f"Content-Type: {ctype}\r\n\r\n").encode() + content + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def _als_requests(batch, known) -> list:
    """(method, path, request kwargs, model-backed) over every ALS route."""
    u0, u1, u2 = batch.users.index_to_id[:3]
    i0, i1, i2 = batch.items.index_to_id[:3]
    k0 = known[u0][0]
    csv = {"headers": {"Accept": "text/csv"}}
    get = [
        "/", f"/recommend/{u0}", f"/recommend/{u1}?howMany=3",
        f"/recommend/{u0}?howMany=4&offset=2",
        f"/recommend/{u2}?considerKnownItems=true&howMany=15",
        f"/recommend/{u0}?howMany=0", f"/recommend/{u0}?offset=-1",
        "/recommend/no-such-user",
        f"/recommendToMany/{u0}/{u1}", f"/recommendToMany/{u0}/{u2}?considerKnownItems=true",
        "/recommendToMany/no-such-user",
        f"/recommendToAnonymous/{i0}=2/{i1}", f"/recommendToAnonymous/{i0}=abc",
        f"/recommendWithContext/{u0}/{i0}", f"/recommendWithContext/{u1}/{i1}=3/{i2}?howMany=5",
        f"/similarity/{i0}/{i1}", f"/similarity/{i2}?howMany=3&offset=1",
        "/similarity/no-such-item",
        f"/similarityToItem/{i0}/{i1}/{i2}", f"/similarityToItem/no-such-item/{i1}",
        f"/knownItems/{u0}", "/knownItems/no-such-user",
        f"/estimate/{u0}/{i0}/{i1}/{i2}", f"/estimate/no-such-user/{i0}",
        f"/estimateForAnonymous/{i0}/{i1}=1.5/{i2}",
        f"/because/{u0}/{k0}", f"/because/{u1}/{i2}?howMany=2",
        f"/because/{u0}/no-such-item",
        f"/mostSurprising/{u0}", f"/mostSurprising/{u1}?howMany=2&offset=1",
        "/popularRepresentativeItems", "/mostActiveUsers?howMany=5",
        "/mostPopularItems", "/mostPopularItems?howMany=3&offset=2",
        "/user/allIDs", "/item/allIDs", "/nope",
    ]
    reqs = [("GET", p, kw, True) for p in get for kw in ({}, csv)]
    body, headers = _multipart([(b"m1,n1,1\nm2,n2,2\n", "text/csv"),
                                (gzip.compress(b"m3,n3,3\n"), "application/gzip")])
    reqs += [
        ("POST", "/pref/uX/iY", {"content": "3.0"}, True),
        ("POST", "/pref/uX/iZ", {}, True),
        ("DELETE", "/pref/uX/iY", {}, True),
        ("POST", "/pref/uX/iY", {"content": "junk"}, True),
        ("POST", "/ingest", {"content": "a,b,1\nc,d,2\n"}, True),
        ("POST", "/ingest", {"content": gzip.compress(b"e,f,3\n"),
                             "headers": {"Content-Encoding": "gzip"}}, True),
        ("POST", "/ingest", {"content": gzip.compress(b"g,h\n")}, True),
        ("POST", "/ingest", {"content": body, "headers": headers}, True),
        ("POST", "/ingest", {"content": "bad\n"}, True),
    ]
    return reqs


def _masked_input(messages: list) -> list:
    """Input-topic writes with each ``/pref`` line's timestamp masked; the
    key is a hash of the line, so it is masked with it."""
    out = []
    for key, message in messages:
        fields = message.split(",")
        if fields[0] == "uX":
            out.append(("<key>", ",".join(fields[:3] + ["<ms>"])))
        else:
            out.append((key, message))
    return out


def test_serving_layer_answers_as_the_reference_over_http(tiny):
    stream, batch, known = tiny
    with _Pair() as pair:
        pair.publish(stream)
        for method, path, kw, model_backed in _als_requests(batch, known):
            ref, port = pair.both(method, path, **kw)
            _same_response(ref, port, f"{method} {path} {kw.get('headers')}",
                           model_backed and ref.status_code == 200)
        ref_in, port_in = pair.inputs()
        assert len(port_in) == 10
        assert _masked_input(ref_in) == _masked_input(port_in)
        # a body past 512 bytes (the console page) goes out compressed
        ref, port = pair.both("GET", "/", headers={"Accept-Encoding": "gzip"})
        assert ref.text == port.text
        assert ref.headers.get("content-encoding") == "gzip"
        assert port.headers.get("content-encoding") == "gzip"


def test_readyz_503_before_the_model_and_200_after_in_both_packages(tiny):
    stream = tiny[0]
    with _Pair() as pair:
        before = pair.both("GET", "/readyz")
        assert [r.status_code for r in before] == [503, 503]
        assert set(before[0].json()) == set(before[1].json())
        assert before[1].json()["model"] == "not loaded"
        pair.publish(stream)
        after = pair.both("GET", "/readyz")
        assert [r.status_code for r in after] == [200, 200]
        assert set(after[0].json()) == set(after[1].json())
        assert after[1].json()["model"] == "loaded"
        assert after[1].json()["status"] == "ready"


def test_kmeans_routes_answer_as_the_reference():
    rng = np.random.default_rng(5)
    data = [f"{x:.3f},{y:.3f}" for x, y in rng.normal(5.0, 6.0, size=(40, 2))]
    with _Pair(km=True) as pair:
        pair.publish(_km_model_message(updates=True))
        for datum in data[:20]:
            for route in ("assign", "distanceToNearest"):
                ref, port = pair.both("GET", f"/{route}/{datum}")
                _same_response(ref, port, f"/{route}/{datum}", True)
        ref, port = pair.both("POST", "/assign", content="\n".join(data[20:]) + "\n")
        _same_response(ref, port, "POST /assign", True)
        ref, port = pair.both("GET", "/assign/bad,datum")
        _same_response(ref, port, "/assign/bad,datum", True)
        assert pair.both("POST", "/add", content="\n".join(data[:5]))[1].status_code == 204
        ref_in, port_in = pair.inputs()
        assert ref_in == port_in and len(port_in) == 5


# -- the port's own rules --------------------------------------------------------


def test_probes_metrics_lineage_and_no_profiler(serving):
    client, layer, batch, _ = serving
    r = client.get("/readyz")
    assert r.status_code == 200 and r.json()["model"] == "loaded"
    assert client.get("/healthz").json() == {"status": "ok"}
    client.get(f"/recommend/{batch.users.index_to_id[0]}")
    text = client.get("/metrics").text
    assert 'oryx_serving_requests_total{route="/recommend/{userID}",method="GET",status="200"}' in text
    # the on-demand profiler: POST only, bounded by max-capture-sec
    assert client.get("/debug/profile").status_code == 405
    r = client.post("/debug/profile", params={"seconds": "0.1"})
    assert r.status_code == 200 and os.path.isdir(r.json()["trace_dir"])
    assert client.post("/debug/profile",
                       params={"seconds": "1e6"}).status_code == 400
    lineage = client.get("/lineage").json()
    assert lineage["live"]["generation"] == "anon-1"
    assert "slo" in client.get("/debug/bundle").json()
    trace = client.get("/trace").json()
    assert "recent" in trace and "slowest_by_route" in trace


def test_closed_layer_leaves_no_thread_and_frees_its_port(tiny):
    stream = tiny[0]
    tp.reset_memory_brokers()
    port = ioutils.choose_free_port()
    config = _config(port)
    tp.maybe_create_topics(config, "input-topic", "update-topic")
    _publish(tp, stream)
    before = set(threading.enumerate())
    layer = ServingLayer(config, device="cpu")
    layer.start()
    try:
        with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=10) as c:
            _wait_ready(c)
            assert c.get("/recommend/u1").status_code == 200
    finally:
        layer.close()
        tp.reset_memory_brokers()
    # the tsdb sampler is the process's, started by the first configure
    left = [t for t in set(threading.enumerate()) - before
            if t.is_alive() and t.name != "OryxTsdbSampler"]
    assert not left, left
    import socket

    with socket.socket() as s:
        s.bind(("0.0.0.0", port))


# -- chip_smoke.py's serving_http phase, at a small size on the CPU -------------


def test_smoke_serving_http_phase_on_a_small_loop(tmp_path, monkeypatch):
    """``chip_smoke.serving_http_phase`` on a ``LambdaLoop`` at 300 users ×
    120 items on the CPU: the replay, ``/recommend`` and every other read
    route against the loop's in-process model, ``/ingest`` through the speed
    layer into both managers, the load levels from a client process (the
    coalescer batching at 64 connections), the operator's tools (the
    metrics view, a ``--trace-id`` tree, a second of the traffic
    generator's ALS mix), the probes and the close;
    ``serving_quant_http`` (int8 with the IVF index, LSH and the smoke's
    rescorer) on the same loop; and ``kmeans_http`` on a small k-means
    model."""
    import chip_smoke as cs
    from oryx_tpu_torch.api.keymessage import KeyMessage
    from oryx_tpu_torch.models.kmeans import pmml_codec as km_codec
    from oryx_tpu_torch.models.kmeans.model import ClusterInfo
    from oryx_tpu_torch.models.kmeans.serving import KMeansServingModelManager
    from oryx_tpu_torch.models.kmeans.speed import KMeansSpeedModelManager
    from oryx_tpu_torch.models.schema import InputSchema
    from oryx_tpu_torch.pmml import pmmlutils

    monkeypatch.setattr(cs, "HTTP_USERS", 30)
    monkeypatch.setattr(cs, "HTTP_INGEST_LINES", 200)
    monkeypatch.setattr(cs, "HTTP_TOUCHED", 10)
    monkeypatch.setattr(cs, "HTTP_LOAD", ((1, 50), (16, 200), (64, 400)))
    monkeypatch.setattr(cs, "HTTP_KMEANS_QUERIES", 50)
    monkeypatch.setattr(cs, "HTTP_KMEANS_ADDS", 10)
    monkeypatch.setattr(cs, "HTTP_QUANT_SIMILARITY", 10)
    monkeypatch.setattr(cs, "TOOLS_TRAFFIC_S", 1.0)
    monkeypatch.setattr(cs, "LOOP_USERS", 300)
    monkeypatch.setattr(cs, "N_ITEMS", 120)
    rng = np.random.default_rng(11)
    u_f, i_f = rng.standard_normal((300, 2)), rng.standard_normal((120, 2))
    p = np.exp(u_f @ i_f.T)
    p /= p.sum(axis=1, keepdims=True)
    lines = [f"u{u},i{rng.choice(120, p=p[u])},1,{t}"
             for t, u in enumerate(rng.integers(0, 300, 3_000).tolist())]
    loop = cs.LambdaLoop(str(tmp_path), {
        "oryx.id": "http",
        "oryx.batch.streaming.config.platform": "cpu",
        "oryx.speed.streaming.config.platform": "cpu",
        "oryx.als.hyperparams.features": 4,
        "oryx.als.iterations": 2,
    }, broker="memory:", serving_device="cpu")
    try:
        loop.run_batch(lines, 0.2, 0.5, 120)
        loop.settle(30, "before the HTTP phase")
        out = cs.serving_http_phase(loop, rng, device="cpu")
        quant = cs.serving_quant_http(loop, rng, device="cpu")
    finally:
        loop.close()
    loop.await_layers()
    assert out["update_messages"] > 300 and out["y_device"] == "cpu"
    assert out["recommend_checked"]["requests"] == 60
    assert len(out["routes_checked"]) == 9
    assert out["ingest"]["ups"] > 0 and out["ingest_to_served_s"] > 0
    assert [lv["concurrency"] for lv in out["load"]] == [1, 16, 64]
    assert all(lv["errors"] == 0 for lv in out["load"])
    assert out["load"][-1]["mean_batch"] > 1
    assert out["threads_left"] == [] and not any(out["launches"].values())
    tools = out["tools"]
    assert {"oryx_device_mfu", "oryx_device_hbm_bandwidth_fraction"} <= set(
        tools["metrics"]["gauges"])
    assert tools["trace_id"]["spans"] >= 3
    assert any("coalescer.device_call" in ln for ln in tools["trace_id"]["tree"])
    t = tools["traffic"]
    assert t["requests"] > 0 and t["server_errors"] == 0 and t["exceptions"] == 0
    assert all(e["sent"] > 0 for e in t["endpoints"].values())
    assert t["endpoints"]["pref"]["answered"] > 0 and t["pref_ups"] > 0
    assert quant["snapshot"]["type"] == "IVFSnapshot" and quant["snapshot"]["lsh_buckets"]
    assert quant["recommend_checked"]["users"] == 30
    assert quant["similarity_checked"] == 10 and set(quant["statuses"]) == {200}
    assert quant["threads_left"] == [] and not any(quant["launches"].values())

    conf = cfg.overlay_on({"oryx.input-schema.num-features": 4,
                           "oryx.input-schema.categorical-features": [],
                           "oryx.kmeans.hyperparams.k": 5}, cfg.get_default())
    centers = rng.standard_normal((5, 4)) * 5
    text = pmmlutils.to_string(km_codec.clustering_model_to_pmml(
        [ClusterInfo(j, centers[j], 10) for j in range(5)], InputSchema(conf)))
    points = centers[rng.integers(0, 5, 300)] + rng.standard_normal((300, 4))
    speed = KMeansSpeedModelManager(conf)
    speed.consume([KeyMessage("MODEL", text)])
    ups = speed.build_updates([KeyMessage(None, ",".join(map(str, q)))
                               for q in points[:100]])
    serving = KMeansServingModelManager(conf)
    serving.consume([KeyMessage("MODEL", text)] + [KeyMessage("UP", u) for u in ups])
    km = cs.kmeans_http(conf, text, ups, points, serving, rng, device="cpu")
    assert km["update_messages"] == 1 + len(ups) and km["added"] == 10
    assert km["queries"]["requests"] == 100 and km["threads_left"] == []
