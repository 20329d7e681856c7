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
"""

from __future__ import annotations

import ast
import contextlib
import os
import re
import types

import pytest
from _pytest.fixtures import FixtureFunctionDefinition

from oryx_tpu_torch.common import config as cfg

# (pattern, replacement), applied in order to the reference file's text
MAPPING = (
    (r"\boryx_tpu\.", "oryx_tpu_torch."),
    (r"\btests\.test_serving\b", "tests.torch_serving_helpers"),
    (r"\btests\.test_lambda\b", "tests.test_torch_lambda"),
)

_TESTS = os.path.dirname(os.path.abspath(__file__))


def mapped_source(ref_test: str) -> str:
    """The text of ``tests/<ref_test>`` with :data:`MAPPING` applied."""
    with open(os.path.join(_TESTS, ref_test), encoding="utf-8") as f:
        src = f.read()
    for pattern, replacement in MAPPING:
        src = re.sub(pattern, replacement, src)
    return src


def load(ref_test: str) -> types.ModuleType:
    """``tests/<ref_test>`` executed, after :data:`MAPPING`, as the module
    ``_mirrored_<stem>``."""
    module = types.ModuleType("_mirrored_" + ref_test[:-3])
    module.__file__ = os.path.join(_TESTS, ref_test)
    code = compile(mapped_source(ref_test), module.__file__, "exec")
    exec(code, module.__dict__)
    return module


def reference_tests(ref_test: str) -> list:
    """The names of ``tests/<ref_test>``'s top-level ``test_*`` functions,
    read from its syntax tree (nothing of it is executed)."""
    with open(os.path.join(_TESTS, ref_test), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    return [node.name for node in tree.body
            if isinstance(node, ast.FunctionDef) and node.name.startswith("test_")]


def collectable(module: types.ModuleType) -> dict:
    """What pytest collects from ``module``: its ``test_*`` functions and
    its fixtures, by name, for a port test file's ``globals().update``."""
    return {
        name: value for name, value in vars(module).items()
        if (name.startswith("test_") and isinstance(value, types.FunctionType))
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
