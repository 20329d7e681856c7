"""The reference's metrics suite, ``tests/test_metrics.py``, on the port.

Its 18 cases run with the reference file's own source, loaded through
:mod:`tests.torch_mirror`: the registry (concurrent increments, bucket
edges, the label-cardinality cap, the exposition's golden text), the
``StepTracer`` bridge, the topic counters, the coalescer's batch-size
histogram, the serving middleware's per-route counters, the ``/metrics``
auth rules, and the end-to-end run over a real serving layer with one
``MODEL`` handoff are the port's. Like the reference, the cases read
deltas of the process-wide registry, so what other files left there does
not change them. The layers run on the CPU
(:func:`tests.torch_mirror.cpu_default`).

One body takes a patch (:data:`PATCHES`): the ``serving_metrics`` fixture
trains its tiny model with ``als_train``, whose ``device=None`` means the
card on the port (no silent CPU path), so the call names ``"cpu"``.
"""

from __future__ import annotations

import pytest

from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common.metrics import MetricsRegistry
from oryx_tpu_torch.common.tracing import StepTracer
from oryx_tpu_torch.serving.app import ServingLayer, make_app
from oryx_tpu_torch.transport import topic as tp
from tests import torch_mirror

REF = "test_metrics.py"
PATCHES = [("iterations=3, chunk=256)", 'iterations=3, chunk=256, device="cpu")')]
_MIRROR = torch_mirror.load(REF, PATCHES)
globals().update(torch_mirror.collectable(_MIRROR))


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with torch_mirror.cpu_default():
        yield


def test_every_reference_case_is_mirrored():
    names = torch_mirror.reference_tests(REF)
    assert len(names) == 18
    for name in names:
        assert globals()[name] is getattr(_MIRROR, name)
        assert globals()[name].__globals__ is vars(_MIRROR)
    assert serving_metrics is _MIRROR.serving_metrics  # noqa: F821 (mirrored fixture)


@pytest.mark.parametrize("name, port", [
    ("cfg", cfg), ("ioutils", ioutils), ("metrics_mod", metrics_mod),
    ("MetricsRegistry", MetricsRegistry), ("StepTracer", StepTracer),
    ("ServingLayer", ServingLayer), ("make_app", make_app), ("tp", tp),
])
def test_mirrored_globals_are_the_ports(name, port):
    assert getattr(_MIRROR, name) is port


def test_no_reference_name_reaches_the_mirror():
    assert torch_mirror.port_only(_MIRROR) == []
    src = torch_mirror.mapped_source(REF, PATCHES)
    assert "oryx_tpu." not in src and '"oryx_tpu"' not in src
    assert src.count(
        '"oryx_tpu_torch.models.als.serving.ALSServingModelManager"') == 2
    assert "from oryx_tpu_torch.models.als import train as tr" in src
    assert "from oryx_tpu_torch.serving.batcher import TopNCoalescer" in src
    assert "from oryx_tpu_torch.tools import trace_summary" in src


def test_the_patch_applies_once_and_fails_loudly_when_it_does_not():
    src = torch_mirror.mapped_source(REF)
    ((old, new),) = PATCHES
    assert src.count(old) == 1
    assert torch_mirror.mapped_source(REF, PATCHES).count(new) == 1
    with pytest.raises(ValueError, match="not once"):
        torch_mirror.mapped_source(REF, [("chunk=256", "chunk=128")] * 2)


def test_the_live_layer_is_the_ports_on_the_cpu(serving_metrics):
    client, layer, batch, prod, pmml_str = serving_metrics
    assert type(layer).__module__ == "oryx_tpu_torch.serving.app"
    assert type(layer.manager).__module__ == "oryx_tpu_torch.models.als.serving"
    assert layer.device.type == "cpu"
    assert layer.manager.get_model().device.type == "cpu"
    assert type(prod).__module__ == "oryx_tpu_torch.transport.topic"
