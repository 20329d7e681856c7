"""Rules of the PyTorch port that hold for every module.

* ``oryx_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor the
  reference package ``oryx_tpu`` (not even its numpy-only modules): the port
  runs on a machine with no JAX and copies what it needs. Nor ``httpx``: the
  serving app is on aiohttp, which the card's machine has, and its clients
  there speak stdlib ``http.client``.
* ``device=None`` means the CUDA card: without one, an entry point raises
  rather than silently running on the CPU.
"""

from __future__ import annotations

import ast
import os
import tempfile

import numpy as np
import pytest
import torch

import oryx_tpu_torch
from oryx_tpu_torch import state
from oryx_tpu_torch.api.batch import BatchLayerUpdate
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import config
from oryx_tpu_torch.common import metrics
from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.lambda_rt.batch import BatchLayer
from oryx_tpu_torch.lambda_rt.speed import SpeedLayer
from oryx_tpu_torch.models.als import train
from oryx_tpu_torch.models.als.data import RatingBatch
from oryx_tpu_torch.models.als.ivf import IVFSnapshot
from oryx_tpu_torch.models.als.serving import ALSServingModel, ALSServingModelManager
from oryx_tpu_torch.models.als.update import ALSUpdate
from oryx_tpu_torch.models.als.vectors import FeatureVectorStore
from oryx_tpu_torch.models.kmeans import train as kmtrain
from oryx_tpu_torch.models.kmeans.update import KMeansUpdate
from oryx_tpu_torch.models.rdf import train as rdftrain
from oryx_tpu_torch.models.rdf.update import RDFUpdate
from oryx_tpu_torch.ops import vectormath

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

PKG = os.path.dirname(os.path.abspath(oryx_tpu_torch.__file__))
REPO = os.path.dirname(PKG)
_FORBIDDEN = ("jax", "jaxlib", "oryx_tpu", "httpx")


def _port_sources():
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tune_gather_gramian.py")
    yield os.path.join(REPO, "fp32_ceiling.py")
    yield os.path.join(REPO, "profiler_gap.py")
    yield os.path.join(REPO, "netbroker_rpc.py")
    yield os.path.join(REPO, "rdf_seed_spread.py")
    # the sanitized child chip_smoke.py starts on the card
    yield os.path.join(REPO, "tests", "torch_sanitize_child.py")


def _imported_modules(path, source=None):
    if source is None:
        source = open(path, encoding="utf-8").read()
    tree = ast.parse(source, filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_and_no_reference_package():
    sources = list(_port_sources())
    assert len(sources) > 10 and os.path.exists(sources[-1])
    scanned = {os.path.relpath(p, PKG) for p in sources}
    assert {"common/lockutils.py", "ops/solver.py", "models/als/foldin.py",
            "models/als/speed.py", "models/als/vectors.py"} <= scanned
    assert {"common/metrics.py", "common/spans.py", "common/blackbox.py",
            "common/faults.py", "common/resilience.py", "common/classutils.py",
            "common/tracing.py", "transport/topic.py", "parallel/mesh.py",
            "lambda_rt/layer.py", "lambda_rt/batch.py",
            "lambda_rt/speed.py"} <= scanned
    assert {"serving/app.py", "serving/batcher.py", "serving/resource.py",
            "serving/console.py", "serving/resources/common.py",
            "serving/resources/als.py", "serving/resources/kmeans.py",
            "common/slo.py", "common/tsdb.py", "common/compilecache.py",
            "common/lineage.py", "api/serving.py"} <= scanned
    assert {"cli/__init__.py", "cli/__main__.py", "cli/main.py",
            "transport/netbroker.py", "parallel/distributed.py"} <= scanned
    assert {"models/als/lsh.py", "models/als/rescorer.py",
            "models/als/ivf.py", "models/als/serving.py"} <= scanned
    assert {"models/classreg.py", "models/rdf/tree.py", "models/rdf/train.py",
            "models/rdf/pmml_codec.py", "models/rdf/update.py",
            "models/rdf/speed.py", "models/rdf/serving.py",
            "serving/resources/classreg.py", "common/federation.py",
            "tools/trace_summary.py", "common/checkpoint.py",
            "common/profiling.py"} <= scanned
    assert {"tools/traffic.py", "example/wordcount.py",
            "example/resources.py"} <= scanned
    assert {"tools/sanitize/__init__.py", "tools/sanitize/locks.py",
            "tools/sanitize/loop.py",
            os.path.join("..", "tests", "torch_sanitize_child.py")} <= scanned
    bad = []
    for path in sources:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in _FORBIDDEN:
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    # the two-rank program of the torch.distributed bootstrap's test
    from test_torch_distributed import _RANK_PROG

    rank_modules = list(_imported_modules("<rank program>", _RANK_PROG))
    assert "oryx_tpu_torch.parallel" in rank_modules
    bad += [m for m in rank_modules if m.split(".")[0] in _FORBIDDEN]
    assert not bad, bad


def test_the_scan_sees_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom oryx_tpu.common import rand\n"
                 "import oryx_tpu_torch\nimport jax.numpy as jnp\n"
                 "import aiohttp\nimport httpx\n")
    mods = list(_imported_modules(str(p)))
    assert [m for m in mods if m.split(".")[0] in _FORBIDDEN] == [
        "oryx_tpu.common", "jax.numpy", "httpx"]


def _entry_points():
    batch = RatingBatch(np.array([0, 1], np.int32), np.array([1, 0], np.int32),
                        np.ones(2, np.float32), [0, 1], [0, 1])
    rows = np.ones((2, 3), np.float32)
    points = np.arange(12, dtype=np.float32).reshape(4, 3)
    kmeans_conf = config.overlay_on(
        {"oryx.input-schema.num-features": 3,
         "oryx.input-schema.categorical-features": [],
         "oryx.kmeans.iterations": 1, "oryx.kmeans.runs": 1},
        config.get_default())
    lines = [KeyMessage(None, ",".join(map(str, p))) for p in points.tolist()]
    als_conf = config.overlay_on(
        {"oryx.als.iterations": 1, "oryx.als.hyperparams.features": 2,
         "oryx.ml.eval.test-fraction": 0.0}, config.get_default())
    ratings = [KeyMessage(None, f"u{i % 3},i{i % 4},1,{i}") for i in range(12)]
    store = FeatureVectorStore()
    store.set_vector("a", rows[0])

    rdf_conf = config.overlay_on(
        {"oryx.input-schema.feature-names": ["a", "b", "label"],
         "oryx.input-schema.categorical-features": ["label"],
         "oryx.input-schema.target-feature": "label",
         "oryx.rdf.num-trees": 2, "oryx.ml.eval.test-fraction": 0.25},
        config.get_default())
    rdf_lines = [KeyMessage(None, f"{a},{b},{'hi' if i % 2 else 'lo'}")
                 for i, (a, b) in enumerate(points[:, :2].tolist() * 2)]

    def run_update(update):
        data = {ALSUpdate: ratings, RDFUpdate: rdf_lines}.get(type(update), lines)
        with tempfile.TemporaryDirectory() as d:
            update.run_update(None, 1, data, [], d, None)

    def build_model(update):
        with tempfile.TemporaryDirectory() as d:
            if isinstance(update, RDFUpdate):
                update.build_model(None, rdf_lines, [4, 2, "gini"], d)
            else:
                update.build_model(None, ratings, [2, 0.1, 1.0], d)

    return {
        "resolve": lambda **kw: resolve(**kw),
        "als_train": lambda **kw: train.als_train(batch, 3, 0.1, 1.0, True, 1,
                                                  **kw),
        "prepare_blocked": lambda **kw: train.prepare_blocked(batch, 3, **kw),
        "BlockedLayoutCache.side": lambda **kw: train.BlockedLayoutCache().side(
            "user", batch.rows, batch.cols, batch.vals, 2, 32, None, None,
            **kw),
        "init_item_factors": lambda **kw: train.init_item_factors(4, 2, 3,
                                                                  **kw),
        "ALSServingModel": lambda **kw: ALSServingModel(3, True, **kw),
        "state.serving_model": lambda **kw: state.serving_model(
            rows, rows, ["a", "b"], ["c", "d"], **kw),
        "state.init_y": lambda **kw: state.init_y(rows, **kw),
        "transpose_times_self": lambda **kw: vectormath.transpose_times_self(
            rows, **kw),
        "kmeans_train": lambda **kw: kmtrain.kmeans_train(points, 2, 1, **kw),
        "fit_index_centroids": lambda **kw: kmtrain.fit_index_centroids(
            points, 2, 1, **kw),
        "KMeansUpdate.build_model": lambda **kw: KMeansUpdate(
            kmeans_conf, **kw).build_model(None, lines, [2], None),
        "state.kmeans_centers": lambda **kw: state.kmeans_centers(rows, **kw),
        "KMeansUpdate.run_update": lambda **kw: run_update(
            KMeansUpdate(kmeans_conf, **kw)),
        "ALSUpdate.build_model": lambda **kw: build_model(ALSUpdate(als_conf, **kw)),
        "ALSUpdate.run_update": lambda **kw: run_update(ALSUpdate(als_conf, **kw)),
        "ALSServingModelManager": lambda **kw: ALSServingModelManager(
            als_conf, **kw),
        # ALSServingModel.y_snapshot's device copy
        "FeatureVectorStore.materialize": lambda **kw: store.materialize(**kw),
        "ALSServingModel(int8)": lambda **kw: ALSServingModel(
            3, True, device_dtype="int8", **kw),
        "ALSServingModel(int8, index)": lambda **kw: ALSServingModel(
            3, True, device_dtype="int8", index_enabled=True, **kw),
        "IVFSnapshot.build": lambda **kw: IVFSnapshot.build(
            ["a", "b"], rows, 0, None, (rows, np.arange(2)), **kw),
        "forest_train": lambda **kw: rdftrain.forest_train(
            points, np.arange(4) % 2, [False] * 3, [0] * 3,
            task=rdftrain.CLASSIFICATION, n_classes=2, num_trees=2,
            max_depth=2, max_split_candidates=4,
            rng=np.random.default_rng(0), **kw),
        "RDFUpdate.build_model": lambda **kw: build_model(RDFUpdate(rdf_conf, **kw)),
        "RDFUpdate.run_update": lambda **kw: run_update(RDFUpdate(rdf_conf, **kw)),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_need_the_card_unless_asked_for_the_cpu(name):
    call = _entry_points()[name]
    call(device="cpu")  # the explicit CPU request always works
    if torch.cuda.is_available():
        assert resolve().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cost_accounting_on_the_cpu_never_initialises_cuda():
    """``als_train`` records one call per half into the device cost
    accounting; on the CPU that neither initialises CUDA nor wires the
    device gauges (the profiling module reads ``torch.cuda`` only once the
    process has a CUDA context)."""
    from oryx_tpu_torch.common import profiling

    batch = RatingBatch(np.array([0, 1, 2], np.int32), np.array([1, 0, 1], np.int32),
                        np.ones(3, np.float32), [0, 1, 2], [0, 1])
    snap0 = metrics.default_registry().snapshot()["oryx_device_calls_total"]
    train.als_train(batch, 3, 0.1, 1.0, True, 2, device="cpu")
    snap1 = metrics.default_registry().snapshot()["oryx_device_calls_total"]
    for half in ("user_half", "item_half"):
        label = f'program="als.train.{half}"'
        assert snap1[label] - snap0.get(label, 0.0) == 2
    if not torch.cuda.is_available():
        assert not torch.cuda.is_initialized()
        assert not profiling._torch_wired
        assert profiling.memory_snapshot()["devices"] == {}


class _NeverRun(BatchLayerUpdate):
    """An update whose generation must never run (the test below)."""

    def __init__(self, config, device=None):
        self.device = resolve(device)

    def run_update(self, *args):
        raise AssertionError("a generation ran")


@pytest.mark.parametrize("tier", ["batch", "speed"])
def test_layers_need_the_card_unless_configured_for_the_cpu(tier, tmp_path):
    """A layer with ``platform = null`` (the card) raises from ``start()``
    on a host without one: before any thread is spawned and before any
    generation, so the missing card is never a quarantined generation."""
    from oryx_tpu_torch.transport import topic as tp

    tp.reset_memory_brokers()

    def layer(platform):
        conf = config.overlay_on({
            "oryx.id": f"rules-{tier}",
            "oryx.batch.update-class": f"{__name__}._NeverRun",
            "oryx.speed.model-manager-class":
                "oryx_tpu_torch.models.als.speed.ALSSpeedModelManager",
            "oryx.batch.storage.data-dir": str(tmp_path / "data"),
            "oryx.batch.storage.model-dir": str(tmp_path / "model"),
            f"oryx.{tier}.streaming.config.platform": platform,
        }, config.get_default())
        return (BatchLayer if tier == "batch" else SpeedLayer)(conf)

    quarantined = metrics.default_registry().snapshot().get(
        "oryx_quarantined_generations_total", {}).get(f'tier="{tier}"', 0.0)
    try:
        cpu = layer("cpu")
        cpu.start(interval_sec=0.05)
        assert cpu._threads and cpu.get_context().device.type == "cpu"
        cpu.close()
        card = layer(None)
        if torch.cuda.is_available():
            card.start(interval_sec=3600)
            assert card.get_context().device.type == "cuda"
            card.close()
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                card.start(interval_sec=0.05)
            assert card._threads == [] and not card.stopped
            assert metrics.default_registry().snapshot().get(
                "oryx_quarantined_generations_total", {}).get(
                f'tier="{tier}"', 0.0) == quarantined
    finally:
        tp.reset_memory_brokers()


def _serving_config(port, extra=None):
    return config.overlay_on({
        "oryx.serving.api.port": port,
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.models.als.serving.ALSServingModelManager",
        "oryx.serving.application-resources": "oryx_tpu_torch.serving.resources.als",
        **(extra or {}),
    }, config.get_default())


def test_serving_layer_needs_the_card_unless_asked_for_the_cpu():
    """``ServingLayer(config)`` means the card: on a host without one
    ``start()`` raises before it creates a topic, a thread, a producer or a
    socket. ``device="cpu"`` serves from the CPU."""
    import socket
    import threading
    import urllib.request

    from oryx_tpu_torch.common import ioutils
    from oryx_tpu_torch.serving.app import ServingLayer
    from oryx_tpu_torch.transport import topic as tp

    tp.reset_memory_brokers()
    try:
        port = ioutils.choose_free_port()
        if not torch.cuda.is_available():
            before = set(threading.enumerate())
            layer = ServingLayer(_serving_config(port))
            with pytest.raises(RuntimeError, match="no CUDA device"):
                layer.start()
            assert not [t for t in set(threading.enumerate()) - before
                        if t.is_alive()]
            assert layer.manager is None
            assert not tp.get_broker("memory:").topic_exists("OryxUpdate")
            with socket.socket() as s:
                s.bind(("0.0.0.0", port))  # the port was never bound
        layer = ServingLayer(_serving_config(port), device="cpu")
        layer.start()
        try:
            assert layer.device == torch.device("cpu")
            assert layer.manager.device == torch.device("cpu")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/ready", timeout=10)
            assert e.value.code == 503  # serving, with no model yet
        finally:
            layer.close()
    finally:
        tp.reset_memory_brokers()


def test_serving_layer_refuses_a_rescorer_provider_at_construction():
    """A configured provider is loaded when the layer is built: one that
    cannot be loaded, or is not the port's ``RescorerProvider`` (the
    reference package's is not), raises then, not at the first request;
    the port's own is taken."""
    from oryx_tpu_torch.serving.app import ServingLayer

    for name, error in (("x.Provider", ValueError),
                        ("oryx_tpu_torch.common.config.Config", TypeError)):
        conf = _serving_config(0, {"oryx.als.rescorer-provider-class": name})
        with pytest.raises(error):
            ServingLayer(conf, device="cpu")
    conf = _serving_config(0, {"oryx.als.rescorer-provider-class":
                               "test_torch_rescorer.PlusOneProvider"})
    assert ServingLayer(conf, device="cpu").manager is None  # not started


@pytest.mark.parametrize("key,value", [
    ("oryx.serving.compute.sharded", True),
])
def test_serving_manager_still_refuses_what_is_not_ported(key, value):
    """Every serving setting of the reference is taken: sharded serving
    (on one device the manager serves unsharded, as the reference does),
    the representations, the index and the staged swap."""
    sharded = ALSServingModelManager(_serving_config(0, {key: value}), device="cpu")
    assert sharded.mesh is None
    taken = ALSServingModelManager(_serving_config(0, {
        "oryx.serving.device-dtype": "int8", "oryx.als.sample-rate": 0.3,
        "oryx.serving.index.enabled": True, "oryx.serving.index.cells": 4,
        "oryx.serving.rescore-factor": 2.0}), device="cpu")
    assert (taken.device_dtype, taken.index_enabled, taken.index_cells,
            taken.rescore_factor) == ("int8", True, 4, 2.0)
    staged = ALSServingModelManager(_serving_config(0, {
        "oryx.serving.compute.precompile-batches": True,
        "oryx.compile.swap-deadline-sec": 5.0}), device="cpu")
    assert staged._prewarm_swap and staged._swap_deadline == 5.0
