"""The reference's ALS quality suite, ``tests/test_als_quality.py``, on
the port.

Its 3 test ids run with the reference file's own source, loaded through
:mod:`tests.torch_main_suites`: ``ALSUpdate``'s split, build and
evaluate at the synthetic MovieLens-100K shape (900 users, 1,600 items,
100,000 lines), held to the hold-out AUC bar of 0.75 with float32 and
with bfloat16 Gramian inputs, and the explicit RMSE gate of 0.35. The
port runs on the CPU (``DEVICE = "cpu"`` and
:func:`tests.torch_mirror.cpu_default`), through its kernels' plain
versions; the same patched text runs through the kernels on the card in
``tests/test_torch_cuda_suites.py``.

The bodies call ``rand.use_test_seed()``, which switches the port's
``common/rand`` for the whole process; the module fixture restores it
after the file (:func:`tests.torch_mirror.rand_restored`), so no later
file in the same worker inherits the seed.
"""

from __future__ import annotations

import ast
import os

import pytest

from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import rand
from oryx_tpu_torch.models.als.update import ALSUpdate
import chip_smoke
import torch_main_suites as suites
import torch_mirror

REF = suites.QUALITY
_MIRROR = suites.load(REF, "cpu")
globals().update(suites.collectable(_MIRROR, REF))

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with torch_mirror.cpu_default(), torch_mirror.rand_restored():
        yield


def test_every_reference_case_is_mirrored():
    names = torch_mirror.reference_tests(REF)
    assert names == ["test_als_auc_at_movielens_scale", "test_als_explicit_rmse_gate"]
    assert suites.LEFT_OUT[REF] == {}
    assert torch_mirror.reference_classes(REF) == {}
    for name in names:
        assert globals()[name] is getattr(_MIRROR, name)
        assert globals()[name].__globals__ is vars(_MIRROR)


@pytest.mark.parametrize("name, port", [
    ("KeyMessage", KeyMessage), ("cfg", cfg), ("rand", rand),
    ("ALSUpdate", ALSUpdate),
])
def test_mirrored_globals_are_the_ports(name, port):
    assert getattr(_MIRROR, name) is port


def test_no_reference_name_reaches_the_mirror():
    assert torch_mirror.port_only(_MIRROR) == []
    src = torch_mirror.mapped_source(REF, suites.patches(REF, "cpu"))
    assert "oryx_tpu." not in src and '"oryx_tpu"' not in src


def test_every_patch_applies_once():
    src = torch_mirror.mapped_source(REF)
    assert suites.patches(REF, "cuda") == suites.patches(REF, "cpu")
    for old, new in suites.patches(REF, "cpu"):
        assert src.count(old) == 1, old
        assert new.count("device=DEVICE") == 1
    patched = torch_mirror.mapped_source(REF, suites.patches(REF, "cpu"))
    assert patched.count("ALSUpdate(config, device=DEVICE)") == 2
    assert "ALSUpdate(config)" not in patched


def test_the_rand_state_is_restored_after_a_body_seeds_it():
    before = (rand._use_test_seed, rand._seed, rand._torch_seed_counter)
    g = rand.get_random()
    state = g.bit_generator.state
    with torch_mirror.rand_restored():
        rand.use_test_seed()
        g.random(3)
        rand.torch_generator()
    assert (rand._use_test_seed, rand._seed, rand._torch_seed_counter) == before
    assert g.bit_generator.state == state


def test_the_movielens_data_is_the_references_shape():
    lines = _MIRROR._synthetic_movielens(n_users=30, n_items=40, n_ratings=200)
    assert len(lines) == 200 and len(set(lines)) == 200
    assert [int(ln.rsplit(",", 1)[1]) for ln in lines] == list(range(200))


def _function(path: str, name: str) -> ast.FunctionDef:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    (node,) = [n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == name]
    return node


def test_the_smokes_movielens_data_is_the_references():
    """``chip_smoke.als_quality``'s copy of the file's data generator."""
    smoke = _function(os.path.join(_ROOT, "chip_smoke.py"), "_synthetic_movielens")
    ref = _function(os.path.join(_ROOT, "tests", REF), "_synthetic_movielens")
    assert ast.dump(smoke) == ast.dump(ref)
    small = dict(n_users=40, n_items=50, n_ratings=300, seed=5)
    assert chip_smoke._synthetic_movielens(**small) == _MIRROR._synthetic_movielens(**small)


def test_the_smokes_explicit_ratings_are_the_references():
    """``chip_smoke.explicit_ratings`` is the explicit case's data: its
    statements are the body's from the generator to the timestamps."""
    smoke = _function(os.path.join(_ROOT, "chip_smoke.py"), "explicit_ratings")
    body = _function(os.path.join(_ROOT, "tests", REF),
                     "test_als_explicit_rmse_gate").body
    start = next(i for i, n in enumerate(body)
                 if "default_rng" in ast.unparse(n))
    end = next(i for i, n in enumerate(body) if ast.unparse(n).startswith("config ="))
    assert isinstance(smoke.body[0].value, ast.Constant)  # the docstring
    assert isinstance(smoke.body[-1], ast.Return)
    assert ast.dump(ast.Module(smoke.body[1:-1], [])) == ast.dump(
        ast.Module(body[start:end], []))
    lines = chip_smoke.explicit_ratings()
    assert len(lines) == 500 * 60 and lines[0].count(",") == 3
