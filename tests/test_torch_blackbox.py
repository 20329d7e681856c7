"""The reference's flight-recorder suite, ``tests/test_blackbox.py``, on the
port.

Its 11 cases run with the reference file's own source, loaded through
:mod:`tests.torch_mirror`: the event ring's bound and drop count, the
throttle, bundle assembly with the redacted config, atomic dumps and their
GC, deferred edge dumps that keep the trigger-time series, the rate floor,
and a real ``python -m oryx_tpu_torch.cli serving`` process that leaves a
bundle on SIGTERM are the port's. The reference's autouse
``_clean_recorder`` comes across with the rest and resets the port's
recorder. The bundle lists the package's version under
``"oryx_tpu_torch"`` (the mapping's quoted package name), and the SIGTERM
child loads the port's fleet app, ``tests.test_torch_fleet_app``.

One body takes a patch (:data:`PATCHES`): the reference puts the SIGTERM
child on the CPU with ``JAX_PLATFORMS=cpu``, which the port does not read;
the port's CLI takes its device from
``oryx.default-compute-config.platform``, so the child's config sets it.
"""

from __future__ import annotations

import pytest

from oryx_tpu_torch.common import blackbox
from oryx_tpu_torch.common import classutils
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import metrics as metrics_mod
from tests import torch_mirror

REF = "test_blackbox.py"
PATCHES = [('  id = "sigterm-dump"\n',
            '  id = "sigterm-dump"\n  default-compute-config.platform = "cpu"\n')]
_MIRROR = torch_mirror.load(REF, PATCHES)
globals().update(torch_mirror.collectable(_MIRROR))


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with torch_mirror.cpu_default():
        yield


def test_every_reference_case_is_mirrored():
    names = torch_mirror.reference_tests(REF)
    assert len(names) == 11
    for name in names:
        assert globals()[name] is getattr(_MIRROR, name)
        assert globals()[name].__globals__ is vars(_MIRROR)
    assert _clean_recorder is _MIRROR._clean_recorder  # noqa: F821 (mirrored fixture)


@pytest.mark.parametrize("name, port", [
    ("blackbox", blackbox), ("cfg", cfg), ("metrics_mod", metrics_mod),
])
def test_mirrored_globals_are_the_ports(name, port):
    assert getattr(_MIRROR, name) is port


def test_no_reference_name_reaches_the_mirror():
    assert torch_mirror.port_only(_MIRROR) == []
    src = torch_mirror.mapped_source(REF, PATCHES)
    assert "oryx_tpu." not in src and '"oryx_tpu"' not in src
    assert 'b["versions"]["oryx_tpu_torch"]' in src
    assert "from oryx_tpu_torch.common import tsdb" in src


def test_the_sigterm_child_runs_the_ports_cli_and_fleet_app_on_the_cpu():
    src = torch_mirror.mapped_source(REF, PATCHES)
    assert src.count("tests.fleet_app") == 0
    assert ('model-manager-class = '
            '"tests.test_torch_fleet_app.FleetServingModelManager"') in src
    assert 'application-resources = "tests.test_torch_fleet_app"' in src
    assert '[sys.executable, "-m", "oryx_tpu_torch.cli", "serving"' in src
    assert src.count('default-compute-config.platform = "cpu"') == 1
    manager = classutils.load_class(
        "tests.test_torch_fleet_app.FleetServingModelManager")
    assert manager.__module__ == "tests.test_torch_fleet_app"
    base = manager.__mro__[1]
    assert base.__module__ == "oryx_tpu_torch.api.serving"
