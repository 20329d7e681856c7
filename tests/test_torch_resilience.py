"""The reference's resilience suite, ``tests/test_resilience.py``, on the port.

Every one of its 26 cases runs here with the reference file's own source,
loaded through :mod:`tests.torch_mirror`: ``oryx_tpu.`` becomes
``oryx_tpu_torch.`` everywhere in the text, the imports inside test bodies
(``ioutils`` that a monkeypatch patches, the flight recorder ``blackbox``
that the shed case reads) and the resource paths in config strings
included. The retry policy, the circuit breaker, deadlines across the
coalescer's executor hop, fault injection, generation quarantine against
fatal-on-error, crash-safe offset commits and the 503 / 504 HTTP surfaces
are thus the port's. The guard cases below check that no reference name
reaches a mirrored body. The layers run on the CPU
(:func:`tests.torch_mirror.cpu_default`).
"""

from __future__ import annotations

import pytest

from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import faults
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import resilience
from oryx_tpu_torch.lambda_rt.layer import AbstractLayer
from oryx_tpu_torch.serving.app import make_app
from oryx_tpu_torch.serving.batcher import TopNCoalescer
from oryx_tpu_torch.transport import topic as tp
from tests import torch_mirror

REF = "test_resilience.py"
_MIRROR = torch_mirror.load(REF)
globals().update(torch_mirror.collectable(_MIRROR))


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with torch_mirror.cpu_default():
        yield


def test_every_reference_case_is_mirrored():
    names = torch_mirror.reference_tests(REF)
    assert len(names) == 26
    for name in names:
        assert globals()[name] is getattr(_MIRROR, name)
        assert globals()[name].__globals__ is vars(_MIRROR)


@pytest.mark.parametrize("name, port", [
    ("cfg", cfg), ("faults", faults), ("ioutils", ioutils),
    ("metrics_mod", metrics_mod), ("resilience", resilience),
    ("AbstractLayer", AbstractLayer), ("make_app", make_app),
    ("TopNCoalescer", TopNCoalescer), ("tp", tp),
])
def test_mirrored_globals_are_the_ports(name, port):
    assert getattr(_MIRROR, name) is port


def test_no_reference_name_reaches_the_mirror():
    assert torch_mirror.port_only(_MIRROR) == []
    src = torch_mirror.mapped_source(REF)
    assert "oryx_tpu." not in src
    assert '"oryx_tpu_torch.serving.resources.als"' in src
    assert "import oryx_tpu_torch.common.ioutils as iou" in src
    assert "from oryx_tpu_torch.common import blackbox" in src


def test_the_mirror_runs_on_the_cpu():
    assert cfg.get_default().get_string(
        "oryx.default-compute-config.platform") == "cpu"
    config = _MIRROR._pump_config()
    assert config.get_string("oryx.speed.streaming.config.platform") == "cpu"
