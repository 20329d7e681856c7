"""Hyperparameter DSL + grid/random search.

A copy of the JAX package's
``oryx_tpu/ml/param.py``
(host code, no JAX), held equal to it by ``tests/test_torch_kmeans.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's ml.param package (framework/oryx-ml/.../param/):
HyperParamValues impls ContinuousRange, DiscreteRange, ContinuousAround,
DiscreteAround, Unordered; config sniffing HyperParams.fromConfig:67-103
(scalar → fixed, 2-element list → range typed by int/float, longer list →
unordered); GridSearch.chooseHyperParameterCombos:42 (cartesian product with
per-param value count sized to reach the candidate budget, random subset +
shuffle) and RandomSearch:35 (independent random draws).
"""

from __future__ import annotations

import abc
import itertools
from typing import Any, Sequence

from oryx_tpu_torch.common import rand

MAX_COMBOS = 65536


class HyperParamValues(abc.ABC):
    @abc.abstractmethod
    def get_trial_values(self, num: int) -> list:
        ...

    @abc.abstractmethod
    def get_random_value(self, rng) -> Any:
        ...

    @abc.abstractmethod
    def get_num_distinct_values(self) -> int:
        ...


class ContinuousRange(HyperParamValues):
    """Uniform real range [min, max] (param/ContinuousRange.java)."""

    def __init__(self, lo: float, hi: float):
        assert lo <= hi
        self.lo, self.hi = float(lo), float(hi)

    def get_trial_values(self, num: int) -> list:
        if self.hi == self.lo:
            return [self.lo]
        if num == 1:
            return [(self.hi + self.lo) / 2.0]
        if num == 2:
            return [self.lo, self.hi]
        step = (self.hi - self.lo) / (num - 1)
        return [self.lo + i * step for i in range(num)]

    def get_random_value(self, rng) -> float:
        if self.hi == self.lo:
            return self.lo
        return float(rng.uniform(self.lo, self.hi))

    def get_num_distinct_values(self) -> int:
        return 2**63 - 1

    def __repr__(self):  # pragma: no cover
        return f"ContinuousRange[{self.lo},{self.hi}]"


class DiscreteRange(HyperParamValues):
    """Integer range [min, max] inclusive (param/DiscreteRange.java)."""

    def __init__(self, lo: int, hi: int):
        assert lo <= hi
        self.lo, self.hi = int(lo), int(hi)

    def get_trial_values(self, num: int) -> list:
        count = self.hi - self.lo + 1
        if count <= num:
            return list(range(self.lo, self.hi + 1))
        if num == 1:
            return [round((self.lo + self.hi) / 2)]
        step = (self.hi - self.lo) / (num - 1)
        vals = sorted({round(self.lo + i * step) for i in range(num)})
        return vals

    def get_random_value(self, rng) -> int:
        return int(rng.integers(self.lo, self.hi + 1))

    def get_num_distinct_values(self) -> int:
        return self.hi - self.lo + 1

    def __repr__(self):  # pragma: no cover
        return f"DiscreteRange[{self.lo},{self.hi}]"


class ContinuousAround(HyperParamValues):
    """Values spread around a center with a given step (param/ContinuousAround.java)."""

    def __init__(self, around: float, step: float):
        self.around, self.step = float(around), float(step)

    def get_trial_values(self, num: int) -> list:
        start = self.around - self.step * (num - 1) / 2.0
        return [start + i * self.step for i in range(num)]

    def get_random_value(self, rng) -> float:
        return float(rng.uniform(self.around - self.step, self.around + self.step))

    def get_num_distinct_values(self) -> int:
        return 2**63 - 1


class DiscreteAround(HyperParamValues):
    """Integer values around a center (param/DiscreteAround.java)."""

    def __init__(self, around: int, step: int):
        self.around, self.step = int(around), int(step)

    def get_trial_values(self, num: int) -> list:
        start = self.around - (self.step * (num - 1)) // 2
        return [start + i * self.step for i in range(num)]

    def get_random_value(self, rng) -> int:
        return int(rng.integers(self.around - self.step, self.around + self.step + 1))

    def get_num_distinct_values(self) -> int:
        return 2**63 - 1


class Unordered(HyperParamValues):
    """Categorical values (param/Unordered.java)."""

    def __init__(self, values: Sequence):
        assert len(values) > 0
        self.values = list(values)

    def get_trial_values(self, num: int) -> list:
        return self.values[: max(1, num)]

    def get_random_value(self, rng) -> Any:
        return self.values[int(rng.integers(0, len(self.values)))]

    def get_num_distinct_values(self) -> int:
        return len(self.values)


def fixed(value) -> HyperParamValues:
    """A single fixed value as a degenerate range."""
    if isinstance(value, bool) or isinstance(value, str):
        return Unordered([value])
    if isinstance(value, int):
        return DiscreteRange(value, value)
    return ContinuousRange(float(value), float(value))


def from_config(config, key: str) -> HyperParamValues:
    """Sniff a hyperparam spec from config (HyperParams.fromConfig:67-103):
    scalar → fixed; [lo, hi] → typed range; longer list → unordered."""
    v = config.get(key)
    if isinstance(v, list):
        if len(v) == 2 and all(isinstance(x, (int, float)) and not isinstance(x, bool) for x in v):
            if all(isinstance(x, int) for x in v):
                return DiscreteRange(v[0], v[1])
            return ContinuousRange(float(v[0]), float(v[1]))
        return Unordered(v)
    return fixed(v)


# ---------------------------------------------------------------------------
# Search strategies
# ---------------------------------------------------------------------------


def choose_hyper_parameter_combos(
    ranges: Sequence[HyperParamValues], how_many: int, search: str = "random"
) -> list[list]:
    """Dispatch by oryx.ml.eval.hyperparam-search (HyperParams:105-116)."""
    if search == "grid":
        return _grid(ranges, how_many)
    if search == "random":
        return _random(ranges, how_many)
    raise ValueError(f"unknown hyperparam search: {search}")


def _values_per_hyper_param(ranges: Sequence[HyperParamValues], candidates: int) -> int:
    """Smallest per-param count whose combination total reaches the budget
    (GridSearch.chooseValuesPerHyperParam)."""
    if not ranges:
        return 0
    per, last_total, total = 0, -1, 0
    while total < candidates and total > last_total or per == 0:
        per += 1
        last_total = total
        total = 1
        for r in ranges:
            total *= min(per, r.get_num_distinct_values())
        if total >= candidates or total <= last_total:
            break
    return per


def _grid(ranges: Sequence[HyperParamValues], how_many: int) -> list[list]:
    assert 0 < how_many <= MAX_COMBOS
    if not ranges:
        return [[]]
    per = _values_per_hyper_param(ranges, how_many)
    value_lists = [r.get_trial_values(per) for r in ranges]
    combos = [list(c) for c in itertools.product(*value_lists)]
    rng = rand.get_random()
    if how_many >= len(combos):
        rng.shuffle(combos)
        return combos
    idx = rng.permutation(len(combos))[:how_many]
    picked = [combos[i] for i in idx]
    rng.shuffle(picked)
    return picked


def _random(ranges: Sequence[HyperParamValues], how_many: int) -> list[list]:
    assert how_many > 0
    if not ranges:
        return [[]]
    rng = rand.get_random()
    return [[r.get_random_value(rng) for r in ranges] for _ in range(how_many)]
