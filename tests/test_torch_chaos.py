"""The reference's chaos suite, ``tests/test_chaos.py``, on the port.

All eight cases run with the reference file's own source, loaded through
:mod:`tests.torch_mirror`: the ``chaos_pair`` fixture's serving and speed
layers, the manager and resource class paths in its config strings, the
``netbroker`` server of the ``tcp`` pass, the tiny model
(:mod:`tests.torch_serving_helpers`) and the speed tier's
``MockSpeedManager`` (:mod:`tests.test_torch_lambda`) are the port's. Six
cases run under both of the fixture's parameters, ``memory`` and ``tcp``,
and two build their own ``tcp:`` pair: 14 test ids in all. Among those two
are the reference's seed failures, the consumer that must survive its
rebuild with the broker down and the close during the rebuild storm: the
port's ``NetBrokerServer.close()`` cancels its handlers before it waits for
the server to close, where the reference's waits first.

The cases depend on their order (``-p no:randomly``), as the reference's
do; they live in one file so that ``--dist loadfile`` keeps them on one
worker. The guard cases check that the live pair is the port's and runs on
the CPU (:func:`tests.torch_mirror.cpu_default`).
"""

from __future__ import annotations

import pytest

from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import faults
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.serving.app import ServingLayer
from oryx_tpu_torch.transport import topic as tp
from tests import torch_mirror

REF = "test_chaos.py"
_MIRROR = torch_mirror.load(REF)
globals().update(torch_mirror.collectable(_MIRROR))


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with torch_mirror.cpu_default():
        yield


def test_every_reference_case_is_mirrored():
    names = torch_mirror.reference_tests(REF)
    assert len(names) == 8
    for name in names:
        assert globals()[name] is getattr(_MIRROR, name)
        assert globals()[name].__globals__ is vars(_MIRROR)
    assert chaos_pair is _MIRROR.chaos_pair  # noqa: F821 (mirrored fixture)


@pytest.mark.parametrize("name, port", [
    ("cfg", cfg), ("faults", faults), ("ioutils", ioutils),
    ("metrics_mod", metrics_mod), ("ServingLayer", ServingLayer), ("tp", tp),
])
def test_mirrored_globals_are_the_ports(name, port):
    assert getattr(_MIRROR, name) is port


def test_no_reference_name_reaches_the_mirror():
    assert torch_mirror.port_only(_MIRROR) == []
    src = torch_mirror.mapped_source(REF)
    assert "oryx_tpu." not in src
    assert src.count(
        '"oryx_tpu_torch.models.als.serving.ALSServingModelManager"') == 3
    assert src.count('"oryx_tpu_torch.serving.resources.als"') == 3
    assert src.count("from oryx_tpu_torch.transport import netbroker") == 3
    assert src.count("from tests.torch_serving_helpers import "
                     "_publish_to_topic, _train_tiny") == 3
    assert '"tests.test_torch_lambda.MockSpeedManager"' in src


def test_the_live_pair_is_the_ports_on_the_cpu(chaos_pair):
    client, serving, speed, user, broker_url = chaos_pair
    assert type(serving).__module__ == "oryx_tpu_torch.serving.app"
    assert type(serving.manager).__module__.startswith("oryx_tpu_torch.")
    resources = serving.config.get("oryx.serving.application-resources")
    assert resources == "oryx_tpu_torch.serving.resources.als"
    assert type(speed).__module__ == "oryx_tpu_torch.lambda_rt.speed"
    assert type(speed.model_manager).__module__ == "tests.test_torch_lambda"
    assert serving.device.type == "cpu"
    assert serving.manager.get_model().device.type == "cpu"
    assert client.get(f"/recommend/{user}").status_code == 200
