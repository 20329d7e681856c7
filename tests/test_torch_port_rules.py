"""Rules of the PyTorch port that hold for every module.

* ``oryx_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor the
  reference package ``oryx_tpu`` (not even its numpy-only modules): the port
  runs on a machine with no JAX and copies what it needs.
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
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import config
from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.models.als import train
from oryx_tpu_torch.models.als.data import RatingBatch
from oryx_tpu_torch.models.als.serving import ALSServingModel, ALSServingModelManager
from oryx_tpu_torch.models.als.update import ALSUpdate
from oryx_tpu_torch.models.kmeans import train as kmtrain
from oryx_tpu_torch.models.kmeans.update import KMeansUpdate
from oryx_tpu_torch.ops import vectormath

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

PKG = os.path.dirname(os.path.abspath(oryx_tpu_torch.__file__))
REPO = os.path.dirname(PKG)
_FORBIDDEN = ("jax", "jaxlib", "oryx_tpu")


def _port_sources():
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tune_gather_gramian.py")
    yield os.path.join(REPO, "fp32_ceiling.py")
    yield os.path.join(REPO, "profiler_gap.py")


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
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
    bad = []
    for path in sources:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in _FORBIDDEN:
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert not bad, bad


def test_the_scan_sees_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom oryx_tpu.common import rand\n"
                 "import oryx_tpu_torch\nimport jax.numpy as jnp\n")
    mods = list(_imported_modules(str(p)))
    assert [m for m in mods if m.split(".")[0] in _FORBIDDEN] == [
        "oryx_tpu.common", "jax.numpy"]


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

    def run_update(update):
        with tempfile.TemporaryDirectory() as d:
            update.run_update(None, 1, ratings if isinstance(update, ALSUpdate)
                              else lines, [], d, None)

    def build_model(update):
        with tempfile.TemporaryDirectory() as d:
            update.build_model(None, ratings, [2, 0.1, 1.0], d)

    return {
        "resolve": lambda **kw: resolve(**kw),
        "als_train": lambda **kw: train.als_train(batch, 3, 0.1, 1.0, True, 1,
                                                  **kw),
        "prepare_blocked": lambda **kw: train.prepare_blocked(batch, 3, **kw),
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
