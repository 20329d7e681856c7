"""The main path's own reference suites on the card.

``tests/test_als.py`` (33 of its 34 ids), ``tests/test_kmeans.py`` (16)
and ``tests/test_als_quality.py`` (3) run their own source against the
port with ``DEVICE = "cuda"``: the same patched text as their CPU mirrors
(``tests/test_torch_als.py``, ``tests/test_torch_kmeans_suite.py``,
``tests/test_torch_als_quality.py``; patches in
:mod:`tests.torch_main_suites`). Every train, serving model and updater
is built on the card, so the ALS trains go through the hand-written
gather-Gramian and SPD kernels, the bfloat16 quality case through the
bfloat16 gather-Gramian, and the k-means trains through the Lloyd sweep;
the last case checks that each of them launched.

Every case needs a CUDA card and skips without one. The file imports
neither JAX nor the reference package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q -p no:randomly tests/test_torch_cuda_suites.py

(``--noconftest``: the suite's conftest imports JAX, so on the card the
ALS suite takes ``LenOnlyIDs`` from :mod:`tests.torch_mirror`.)
"""

from __future__ import annotations

import pytest
import torch

from oryx_tpu_torch.ops import kernels as K
import torch_main_suites as suites
import torch_mirror

DEVICE = "cuda"
SUITES = (suites.ALS, suites.KMEANS, suites.QUALITY)

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA card: the suites run the port there"),
]

_MIRRORS = {ref: suites.load(ref, DEVICE) for ref in SUITES}
for _ref in SUITES:
    globals().update(suites.collectable(_MIRRORS[_ref], _ref))

_AT_START: dict = {}
_RAN: set = set()


@pytest.fixture(scope="module", autouse=True)
def _suites():
    """The launch counts before the first case; the port's ``common/rand``
    as it was after the last (the quality and tuning bodies seed it)."""
    _AT_START.update(launches=dict(K.LAUNCHES), shapes=dict(K.SHAPE_LAUNCHES))
    with torch_mirror.rand_restored():
        yield


@pytest.fixture(autouse=True)
def _ran(request):
    yield
    _RAN.add(request.node.nodeid)


def test_every_mirrored_case_is_here_on_the_card():
    for ref, module in _MIRRORS.items():
        assert module.DEVICE == DEVICE
        assert torch_mirror.port_only(module) == []
        names = torch_mirror.reference_tests(ref) + list(
            torch_mirror.reference_classes(ref))
        for name in names:
            if name in suites.LEFT_OUT[ref]:
                assert name not in globals()
            else:
                assert globals()[name] is getattr(module, name)


def test_the_kernels_ran_under_the_suites():
    """Last in the file, after the 53 other cases: every kernel of the
    trains launched on the card while they ran, the bfloat16
    gather-Gramian among them."""
    assert len(_RAN) == 53, sorted(_RAN)
    before = _AT_START["launches"]
    ran = {name: n - before.get(name, 0) for name, n in K.LAUNCHES.items()}
    assert all(n > 0 for n in ran.values()), ran
    bf16 = sum(n - _AT_START["shapes"].get(key, 0)
               for key, n in K.SHAPE_LAUNCHES.items()
               if key[0] == "gather_gramian_accumulate"
               and key[1][-1] == str(torch.bfloat16))
    assert bf16 > 0, K.SHAPE_LAUNCHES
