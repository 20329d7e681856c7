"""Run a reference test file's own source against the port.

:func:`load` reads ``tests/<name>`` (a test file of the JAX package),
applies :data:`MAPPING` to its text, compiles the result under the
reference file's path (the mapping keeps every line where it was, so a
traceback points at the reference's line) and executes it as a module of
its own. Every test body, fixture and helper then runs unchanged, and
everything it reaches by name reaches the port: its top-level imports,
the imports inside function bodies, and the class paths inside config
strings that the layers load by reflection.

The rebinding by :func:`tests.test_torch_batcher._mirror` swaps only
module globals, so it cannot reach the last two; this loader can.

:data:`MAPPING` holds general renames only: dotted names under
``oryx_tpu.``, the quoted package name ``"oryx_tpu"`` (the key under which
a flight-recorder bundle lists the package's version), and the reference's
helper modules beside their port copies (``tests.fleet_app``, the fleet
app that a CLI child loads by its dotted name, becomes
``tests.test_torch_fleet_app``).

A body that cannot run verbatim on the port takes a per-file patch:
``load(name, patches=[(old, new), ...])`` replaces ``old`` by ``new`` in
the mapped text. Each ``old`` must occur exactly once, or :func:`load`
raises, so a patch that no longer applies fails loudly instead of
letting the body run unpatched. A patch may add lines; tracebacks past it
are off by that many.

:class:`LenOnlyIDs` is a JAX-free copy of the suite conftest's helper of
that name, for a mirror that runs where the conftest cannot be imported;
``tests/test_torch_als.py`` pins the copy equal to it.
"""

from __future__ import annotations

import ast
import contextlib
import inspect
import os
import re
import types

import pytest
from _pytest.fixtures import FixtureFunctionDefinition

from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import rand

# (pattern, replacement), applied in order to the reference file's text
MAPPING = (
    (r"\boryx_tpu\.", "oryx_tpu_torch."),
    (r"\btests\.test_serving\b", "tests.torch_serving_helpers"),
    (r"\btests\.test_lambda\b", "tests.test_torch_lambda"),
    (r'"oryx_tpu"', '"oryx_tpu_torch"'),
    (r"\btests\.fleet_app\b", "tests.test_torch_fleet_app"),
)

_TESTS = os.path.dirname(os.path.abspath(__file__))


def mapped_source(ref_test: str, patches=()) -> str:
    """The text of ``tests/<ref_test>`` with :data:`MAPPING` applied, then
    each ``(old, new)`` of ``patches``; raises ``ValueError`` unless every
    ``old`` occurs exactly once in the text it is applied to."""
    with open(os.path.join(_TESTS, ref_test), encoding="utf-8") as f:
        src = f.read()
    for pattern, replacement in MAPPING:
        src = re.sub(pattern, replacement, src)
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"{ref_test}: patch {old!r} matches "
                             f"{src.count(old)} times, not once")
        src = src.replace(old, new)
    return src


def load(ref_test: str, patches=()) -> types.ModuleType:
    """``tests/<ref_test>`` executed, after :data:`MAPPING` and
    ``patches`` (see :func:`mapped_source`), as the module
    ``_mirrored_<stem>``."""
    module = types.ModuleType("_mirrored_" + ref_test[:-3])
    module.__file__ = os.path.join(_TESTS, ref_test)
    code = compile(mapped_source(ref_test, patches), module.__file__, "exec")
    exec(code, module.__dict__)
    return module


def reference_tests(ref_test: str) -> list:
    """The names of ``tests/<ref_test>``'s top-level ``test_*`` functions,
    read from its syntax tree (nothing of it is executed)."""
    with open(os.path.join(_TESTS, ref_test), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    return [node.name for node in tree.body
            if isinstance(node, ast.FunctionDef) and node.name.startswith("test_")]


def reference_classes(ref_test: str) -> dict:
    """``tests/<ref_test>``'s top-level ``Test*`` classes, each with the
    names of its ``test_*`` methods, read from its syntax tree."""
    with open(os.path.join(_TESTS, ref_test), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    return {node.name: [m.name for m in node.body
                        if isinstance(m, ast.FunctionDef)
                        and m.name.startswith("test_")]
            for node in tree.body
            if isinstance(node, ast.ClassDef) and node.name.startswith("Test")}


def collectable(module: types.ModuleType) -> dict:
    """What pytest collects from ``module``: its ``test_*`` functions, the
    ``Test*`` classes it defines (not one it imports, such as a
    ``TestClient``) and its fixtures, by name, for a port test file's
    ``globals().update``."""
    return {
        name: value for name, value in vars(module).items()
        if (name.startswith("test_") and isinstance(value, types.FunctionType))
        or (name.startswith("Test") and inspect.isclass(value)
            and value.__module__ == module.__name__)
        or isinstance(value, FixtureFunctionDefinition)
    }


def port_only(module: types.ModuleType) -> list:
    """The names in ``module``'s namespace bound to a module, class or
    function of the reference package (``oryx_tpu``): empty for a mirror
    that runs the port alone."""
    leaks = []
    for name, value in vars(module).items():
        owner = (value.__name__ if isinstance(value, types.ModuleType)
                 else getattr(value, "__module__", None))
        if isinstance(owner, str) and (owner == "oryx_tpu"
                                       or owner.startswith("oryx_tpu.")):
            leaks.append(name)
    return leaks


@contextlib.contextmanager
def cpu_default():
    """The port's default configuration with
    ``oryx.default-compute-config.platform = "cpu"`` for the duration: every
    layer a mirrored body builds from ``cfg.get_default()`` then asks for
    the CPU, as a deployment's config file that sets the key does."""
    default = cfg.get_default()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cfg, "_default_config", cfg.overlay_on(
            {"oryx.default-compute-config.platform": "cpu"}, default))
        yield


@contextlib.contextmanager
def rand_restored():
    """The port's ``common/rand`` state as it was, after the block: a
    mirrored body's ``rand.use_test_seed()`` switches every generator of
    the process to the test seed, which no later file in the same worker
    should inherit. Restores the switch, the seed, the torch seed counter
    and the state of each tracked numpy generator."""
    with rand._lock:
        saved = (rand._use_test_seed, rand._seed, rand._torch_seed_counter)
        states = [(g, g.bit_generator.state) for g in list(rand._instances)]
    try:
        yield
    finally:
        with rand._lock:
            (rand._use_test_seed, rand._seed,
             rand._torch_seed_counter) = saved
            for g, state in states:
                g.bit_generator.state = state


class LenOnlyIDs:
    """len()-only IDIndexMapping stand-in for trainer tests whose rows are
    already dense indices (materializing id strings would only test the
    host dict, not the trainer)."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n
