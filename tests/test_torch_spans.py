"""The reference's tracing suite, ``tests/test_spans.py``, on the port.

Its 21 cases (22 ids: the topic-header round trip runs on ``memory:`` and
``file:``) run with the reference file's own source, loaded through
:mod:`tests.torch_mirror`: trace-context propagation across asyncio tasks,
executor hops, the coalescer's fan-in links and the topic headers into the
speed tier, the span ring, OpenMetrics exemplars, the ``/trace``,
``/healthz`` and ``/readyz`` endpoints, ``trace_summary --trace-id``, and
the end-to-end acceptance run (a ``/recommend`` trace covering 95% of its
server time; an ingress trace continued in a real speed layer) are all the
port's. The reference's autouse ``_fresh_recorder`` comes across with the
rest and resets the port's recorder. The layers run on the CPU
(:func:`tests.torch_mirror.cpu_default`).
"""

from __future__ import annotations

import gc

import pytest

from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import spans
from oryx_tpu_torch.lambda_rt.speed import SpeedLayer
from oryx_tpu_torch.serving.app import ServingLayer, make_app
from oryx_tpu_torch.transport import topic as tp
from tests import torch_mirror

REF = "test_spans.py"
_MIRROR = torch_mirror.load(REF)
globals().update(torch_mirror.collectable(_MIRROR))


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with torch_mirror.cpu_default():
        yield


def test_every_reference_case_is_mirrored():
    names = torch_mirror.reference_tests(REF)
    assert len(names) == 21
    for name in names:
        assert globals()[name] is getattr(_MIRROR, name)
        assert globals()[name].__globals__ is vars(_MIRROR)
    assert traced_serving is _MIRROR.traced_serving  # noqa: F821 (mirrored fixture)
    assert _fresh_recorder is _MIRROR._fresh_recorder  # noqa: F821


@pytest.mark.parametrize("name, port", [
    ("cfg", cfg), ("ioutils", ioutils), ("metrics_mod", metrics_mod),
    ("spans", spans), ("ServingLayer", ServingLayer), ("make_app", make_app),
    ("tp", tp),
])
def test_mirrored_globals_are_the_ports(name, port):
    assert getattr(_MIRROR, name) is port


def test_no_reference_name_reaches_the_mirror():
    assert torch_mirror.port_only(_MIRROR) == []
    src = torch_mirror.mapped_source(REF)
    assert "oryx_tpu." not in src and '"oryx_tpu"' not in src
    assert src.count('"oryx_tpu_torch.serving.resources.als"') == 2
    assert ('"oryx_tpu_torch.models.als.serving.ALSServingModelManager"'
            in src)
    assert src.count("from oryx_tpu_torch.lambda_rt.speed import "
                     "SpeedLayer") == 2
    assert src.count('"tests.test_torch_lambda.MockSpeedManager"') == 2
    assert "from tests.torch_serving_helpers import " in src


def _live(cls, oryx_id):
    return [o for o in gc.get_objects()
            if type(o) is cls and o.config.get_string("oryx.id") == oryx_id]


def test_the_traced_layers_are_the_ports_on_the_cpu(traced_serving):
    client, _ = traced_serving
    (serving,) = [s for s in _live(ServingLayer, "spans-e2e")
                  if str(client.base_url).endswith(
                      f":{s.config.get_int('oryx.serving.api.port')}")]
    assert type(serving).__module__ == "oryx_tpu_torch.serving.app"
    assert type(serving.manager).__module__ == "oryx_tpu_torch.models.als.serving"
    assert serving.device.type == "cpu"
    assert serving.manager.get_model().device.type == "cpu"
    (speed,) = [s for s in _live(SpeedLayer, "spans-e2e")
                if s.update_topic == "OryxUpdateSpeed"]
    assert type(speed).__module__ == "oryx_tpu_torch.lambda_rt.speed"
    assert type(speed.model_manager).__module__ == "tests.test_torch_lambda"
