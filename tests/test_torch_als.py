"""The reference's ALS suite, ``tests/test_als.py``, on the port.

33 of its 34 test ids run with the reference file's own source, loaded
through :mod:`tests.torch_main_suites`: the data prep (aggregation,
decay, log strength, the vectorized ingest's nine
``TestVectorizedIngest`` cases), the fold-in arithmetic, the trainer's
implicit AUC and explicit RMSE, the PMML codec, LSH, the serving model's
top-N, the speed and serving managers, the parallel pack and the
time-ordered split are the port's. The port runs on the CPU
(``DEVICE = "cpu"`` and :func:`tests.torch_mirror.cpu_default`); the same
patched text runs on the card in ``tests/test_torch_cuda_suites.py``.

Left out: ``test_batched_foldin_speedup_10k``, a wall-clock gate on host
numpy code. The port's ``models/als/foldin.py`` and ``ops/solver.py``
are the reference's modules but for docstrings and imports
(:func:`test_foldin_and_solver_are_the_references_code`), so the
reference's own gate times this code.
"""

from __future__ import annotations

import ast
import os

import pytest

from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.models.als import data as d
from oryx_tpu_torch.models.als import evaluate as ev
from oryx_tpu_torch.models.als import foldin, pmml_codec
from oryx_tpu_torch.models.als import train as tr
from oryx_tpu_torch.models.als.lsh import (LocalitySensitiveHash,
                                           choose_hash_config)
from oryx_tpu_torch.models.als.serving import (ALSServingModel,
                                               ALSServingModelManager)
from oryx_tpu_torch.models.als.speed import ALSSpeedModelManager
from oryx_tpu_torch.ops import solver as sv
import torch_main_suites as suites
import torch_mirror

REF = suites.ALS
_MIRROR = suites.load(REF, "cpu")
globals().update(suites.collectable(_MIRROR, REF))

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with torch_mirror.cpu_default():
        yield


def test_every_reference_case_is_mirrored():
    names = torch_mirror.reference_tests(REF)
    assert len(names) == 24
    left_out = suites.LEFT_OUT[REF]
    assert set(left_out) <= set(names)
    for name in names:
        if name in left_out:
            assert name not in globals()
            continue
        assert globals()[name] is getattr(_MIRROR, name)
        assert globals()[name].__globals__ is vars(_MIRROR)
    classes = torch_mirror.reference_classes(REF)
    assert {c: len(m) for c, m in classes.items()} == {"TestVectorizedIngest": 9}
    for cls, methods in classes.items():
        assert globals()[cls] is getattr(_MIRROR, cls)
        for method in methods:
            assert getattr(globals()[cls], method).__globals__ is vars(_MIRROR)


def test_collectable_yields_the_classes_a_mirror_defines():
    """A mirrored module's ``Test*`` class is collected with its functions;
    a ``Test*`` class it only imports (a ``TestClient``) is not."""
    collected = torch_mirror.collectable(_MIRROR)
    assert collected["TestVectorizedIngest"] is _MIRROR.TestVectorizedIngest
    assert "test_batched_foldin_speedup_10k" in collected
    assert "test_batched_foldin_speedup_10k" not in suites.collectable(_MIRROR, REF)

    class TestClient:
        pass

    module = suites.load(REF, "cpu")
    module.TestClient = TestClient
    assert "TestClient" not in torch_mirror.collectable(module)
    assert "TestVectorizedIngest" in torch_mirror.collectable(module)


@pytest.mark.parametrize("name, port", [
    ("KeyMessage", KeyMessage), ("cfg", cfg), ("d", d), ("ev", ev),
    ("foldin", foldin), ("pmml_codec", pmml_codec), ("tr", tr),
    ("LocalitySensitiveHash", LocalitySensitiveHash),
    ("choose_hash_config", choose_hash_config),
    ("ALSServingModel", ALSServingModel),
    ("ALSServingModelManager", ALSServingModelManager),
    ("ALSSpeedModelManager", ALSSpeedModelManager), ("sv", sv),
])
def test_mirrored_globals_are_the_ports(name, port):
    assert getattr(_MIRROR, name) is port


def test_no_reference_name_reaches_the_mirror():
    assert torch_mirror.port_only(_MIRROR) == []
    src = torch_mirror.mapped_source(REF, suites.patches(REF, "cpu"))
    assert "oryx_tpu." not in src and '"oryx_tpu"' not in src
    assert "from oryx_tpu_torch.models.als.update import ALSUpdate" in src
    assert "from oryx_tpu_torch.models.als.speed import _format_rows" in src
    assert "from oryx_tpu_torch.pmml import pmmlutils" in src
    assert "from oryx_tpu_torch.models.als.lsh import _candidate_fraction" in src


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_every_patch_applies_once(device):
    src = torch_mirror.mapped_source(REF)
    patched = torch_mirror.mapped_source(REF, suites.patches(REF, device))
    for old, new in suites.patches(REF, device):
        assert src.count(old) == 1, old
        assert "DEVICE" in new or ".cpu()" in new or "torch_mirror" in new
    assert patched.count("device=DEVICE") == 12
    assert patched.count(".cpu()") == 11
    assert ("from conftest import LenOnlyIDs" in patched) == (device == "cpu")
    with pytest.raises(ValueError, match="not once"):
        torch_mirror.mapped_source(REF, [("ALSServingModelManager(config)", "")])


def test_the_mirror_runs_on_the_cpu():
    assert _MIRROR.DEVICE == "cpu"
    model = _MIRROR._serving_model(n_items=5, k=3)
    assert model.device.type == "cpu"
    assert model.y.materialize(device=_MIRROR.DEVICE)[1].device.type == "cpu"


def test_len_only_ids_copy_is_the_conftests():
    """The card's run imports ``LenOnlyIDs`` from :mod:`tests.torch_mirror`
    (the suite conftest imports JAX); the copy is the conftest's class."""

    def class_def(path):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        (node,) = [n for n in tree.body
                   if isinstance(n, ast.ClassDef) and n.name == "LenOnlyIDs"]
        return ast.dump(node)

    tests = os.path.join(_ROOT, "tests")
    assert class_def(os.path.join(tests, "torch_mirror.py")) == class_def(
        os.path.join(tests, "conftest.py"))


def _code_only(path: str) -> str:
    """The module's syntax tree without its docstrings and imports."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        kept = [n for n in body if not isinstance(n, (ast.Import, ast.ImportFrom))]
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
                and kept and isinstance(kept[0], ast.Expr)
                and isinstance(kept[0].value, ast.Constant)
                and isinstance(kept[0].value.value, str)):
            kept = kept[1:]
        node.body = kept or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["models/als/foldin.py", "ops/solver.py"])
def test_foldin_and_solver_are_the_references_code(module):
    """The ground for leaving ``test_batched_foldin_speedup_10k`` out: the
    port's module is the reference's but for docstrings and imports, so
    the reference's gate times the same code."""
    port = _code_only(os.path.join(_ROOT, "oryx_tpu_torch", module))
    ref = _code_only(os.path.join(_ROOT, "oryx_tpu", module))
    assert port == ref
    assert "compute_updated_batch" in port or "get_solver" in port
