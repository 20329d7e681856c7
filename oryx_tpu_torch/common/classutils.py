"""Dynamic class loading for config-driven extension points.

A copy of the JAX package's ``oryx_tpu/common/classutils.py`` (host code, no
JAX), held equal to it by ``tests/test_torch_lambda.py``, plus
:func:`load_instance_on`, which builds a class whose constructor takes a
``device`` keyword on the layer's device.

Equivalent of the reference's ClassUtils (framework/oryx-common/.../lang/
ClassUtils.java:36-101): user classes named in config (``oryx.batch.update-class``,
``oryx.speed.model-manager-class``, ``oryx.serving.model-manager-class``,
``oryx.als.rescorer-provider-class``) are loaded reflectively, trying a
``(config)`` constructor first and falling back to no-arg.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Type


def load_class(name: str) -> Type:
    """Load a class by fully-qualified dotted name ``pkg.module.Class``."""
    if not name:
        raise ValueError("empty class name")
    module_name, _, cls_name = name.rpartition(".")
    if not module_name:
        raise ValueError(f"class name must be fully qualified: {name}")
    try:
        module = importlib.import_module(module_name)
    except ImportError as e:
        raise ValueError(f"cannot import module for class {name}") from e
    try:
        return getattr(module, cls_name)
    except AttributeError as e:
        raise ValueError(f"no class {cls_name} in module {module_name}") from e


def class_exists(name: str) -> bool:
    try:
        load_class(name)
        return True
    except ValueError:
        return False


def load_instance_of(name: str, expected_type: Type | None = None, *args: Any) -> Any:
    """Instantiate ``name``, preferring a ctor that accepts *args and falling
    back to no-arg (ClassUtils.loadInstanceOf). Constructor selection is by
    signature — errors raised *inside* a matching __init__ propagate, like the
    reference's reflective constructor lookup."""
    cls = load_class(name)
    if expected_type is not None and not issubclass(cls, expected_type):
        raise TypeError(f"{name} is not a {expected_type.__name__}")
    if args:
        try:
            inspect.signature(cls).bind(*args)
        except TypeError:
            pass  # no matching ctor; fall back to no-arg
        except ValueError:
            return cls(*args)  # signature unavailable (builtins); just try
        else:
            return cls(*args)
    return cls()


def load_instance_on(name: str, expected_type: "Type | None", config, device) -> Any:
    """``name`` built from ``(config)`` as :func:`load_instance_of` builds
    it; a class whose constructor takes a ``device`` keyword is built as
    ``cls(config, device=device)`` (the port's updates and managers hold
    their tensors on it)."""
    cls = load_class(name)
    try:
        takes_device = "device" in inspect.signature(cls).parameters
    except (TypeError, ValueError):
        takes_device = False
    if not takes_device:
        return load_instance_of(name, expected_type, config)
    if expected_type is not None and not issubclass(cls, expected_type):
        raise TypeError(f"{name} is not a {expected_type.__name__}")
    return cls(config, device=device)
