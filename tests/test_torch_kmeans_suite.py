"""The reference's k-means suite, ``tests/test_kmeans.py``, on the port.

All 16 cases run with the reference file's own source, loaded through
:mod:`tests.torch_main_suites`: the input schema and categorical
encodings, the trainer (blob recovery, random init, k clamped to N), the
evaluation metrics, the PMML round trip, ``ClusterInfo`` and
``closest_cluster``, ``KMeansUpdate`` end to end and its hyperparameter
search, the speed and serving managers and the serving HTTP app are the
port's. The port runs on the CPU (``DEVICE = "cpu"`` and
:func:`tests.torch_mirror.cpu_default`); the same patched text runs on the
card in ``tests/test_torch_cuda_suites.py``.

``tests/test_torch_kmeans.py`` keeps the port's own parity tests, and
``tests/test_torch_serving.py::test_kmeans_endpoints`` its own version of
the endpoints case. ``test_kmeans_hyperparam_tuning`` switches the port's
``common/rand`` to the test seed; the module fixture restores it after
the file (:func:`tests.torch_mirror.rand_restored`).
"""

from __future__ import annotations

import pytest

from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.models import pmml_common
from oryx_tpu_torch.models.kmeans import evaluate as kmeval
from oryx_tpu_torch.models.kmeans import pmml_codec
from oryx_tpu_torch.models.kmeans import train as kmtrain
from oryx_tpu_torch.models.kmeans.model import ClusterInfo, closest_cluster
from oryx_tpu_torch.models.kmeans.serving import KMeansServingModelManager
from oryx_tpu_torch.models.kmeans.speed import KMeansSpeedModelManager
from oryx_tpu_torch.models.kmeans.update import KMeansUpdate
from oryx_tpu_torch.models.schema import CategoricalValueEncodings, InputSchema
from oryx_tpu_torch.pmml import pmmlutils
import torch_main_suites as suites
import torch_mirror

REF = suites.KMEANS
_MIRROR = suites.load(REF, "cpu")
globals().update(suites.collectable(_MIRROR, REF))


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with torch_mirror.cpu_default(), torch_mirror.rand_restored():
        yield


def test_every_reference_case_is_mirrored():
    names = torch_mirror.reference_tests(REF)
    assert len(names) == 16
    assert suites.LEFT_OUT[REF] == {}
    assert torch_mirror.reference_classes(REF) == {}
    for name in names:
        assert globals()[name] is getattr(_MIRROR, name)
        assert globals()[name].__globals__ is vars(_MIRROR)


@pytest.mark.parametrize("name, port", [
    ("KeyMessage", KeyMessage), ("cfg", cfg), ("pmml_common", pmml_common),
    ("kmeval", kmeval), ("pmml_codec", pmml_codec), ("kmtrain", kmtrain),
    ("ClusterInfo", ClusterInfo), ("closest_cluster", closest_cluster),
    ("KMeansServingModelManager", KMeansServingModelManager),
    ("KMeansSpeedModelManager", KMeansSpeedModelManager),
    ("KMeansUpdate", KMeansUpdate),
    ("CategoricalValueEncodings", CategoricalValueEncodings),
    ("InputSchema", InputSchema), ("pmmlutils", pmmlutils),
])
def test_mirrored_globals_are_the_ports(name, port):
    assert getattr(_MIRROR, name) is port


def test_no_reference_name_reaches_the_mirror():
    assert torch_mirror.port_only(_MIRROR) == []
    src = torch_mirror.mapped_source(REF, suites.patches(REF, "cpu"))
    assert "oryx_tpu." not in src and '"oryx_tpu"' not in src
    assert '"oryx_tpu_torch.models.kmeans.serving.KMeansServingModelManager"' in src
    assert '"oryx_tpu_torch.serving.resources.kmeans"' in src
    assert "from oryx_tpu_torch.serving.app import ServingLayer" in src
    assert "from oryx_tpu_torch.ml.mlupdate import read_pmml_from_update_key_message" in src
    assert "from oryx_tpu_torch.common import rand" in src


def test_every_patch_applies_once():
    src = torch_mirror.mapped_source(REF)
    assert suites.patches(REF, "cuda") == suites.patches(REF, "cpu")
    for old, new in suites.patches(REF, "cpu"):
        assert src.count(old) == 1, old
        assert new.count("device=DEVICE") == 1
    patched = torch_mirror.mapped_source(REF, suites.patches(REF, "cpu"))
    assert patched.count("device=DEVICE") == 5
    calls = [ln for ln in patched.splitlines()
             if "kmtrain.kmeans_train(" in ln or "KMeansUpdate(" in ln]
    assert len(calls) == 5 and all("device=DEVICE" in ln for ln in calls)


def test_the_mirror_runs_on_the_cpu():
    assert _MIRROR.DEVICE == "cpu"
    config = _MIRROR._config()
    assert config.get("oryx.default-compute-config.platform") == "cpu"
