"""Central RNG management with a test-determinism switch.

A copy of the reference's ``common/rand`` host part (RandomManager.java:51-97
in the original Oryx): numpy generators handed out here are tracked weakly
and reseeded in place when :func:`use_test_seed` is called, and they use the
same PCG64 test seed as the reference, so a host-side sampling routine draws
the same numbers in both packages. Device randomness goes through explicit
``torch.Generator`` objects (:func:`torch_generator`): their streams differ
from ``jax.random``'s, so tests that compare values inject the random state.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

_TEST_SEED = 1234567890123456789 & 0xFFFFFFFF

_lock = threading.Lock()
_use_test_seed = False
_instances: "weakref.WeakSet[np.random.Generator]" = weakref.WeakSet()
_torch_seed_counter = 0


class _Generator(np.random.Generator):
    """np.random.Generator is not weakref-able; this subclass is."""


def use_test_seed() -> None:
    """Switch all RNGs (existing and future) to a fixed seed — tests only."""
    global _use_test_seed, _torch_seed_counter
    with _lock:
        _use_test_seed = True
        _torch_seed_counter = 0
        for gen in _instances:
            gen.bit_generator.state = np.random.PCG64(_TEST_SEED).state


def get_random(seed: int | None = None) -> np.random.Generator:
    """A new host RNG; seeded deterministically iff use_test_seed() was called
    (or an explicit seed is given)."""
    with _lock:
        if seed is not None:
            return np.random.default_rng(seed)
        g = _Generator(np.random.PCG64(_TEST_SEED if _use_test_seed else None))
        _instances.add(g)
        return g


def torch_generator(seed: int | None = None) -> torch.Generator:
    """A CPU ``torch.Generator`` under the same determinism switch. It lives
    on the CPU so that a seed gives the same numbers whatever device the
    result is moved to."""
    global _torch_seed_counter
    with _lock:
        if seed is None:
            if _use_test_seed:
                _torch_seed_counter += 1
                seed = _TEST_SEED + _torch_seed_counter
            else:
                seed = int(np.random.SeedSequence().entropy & 0x7FFFFFFF)
    return torch.Generator().manual_seed(seed)
