"""The port's rescorer SPI (``models/als/rescorer.py``, a copy of the
reference's on the port's ``common/classutils``): the four cases of
``tests/test_rescorer.py`` on the port, parity of the composed hooks with
the reference's, and the serving layer that now takes a configured
provider."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from oryx_tpu.models.als import rescorer as ref_rescorer
from oryx_tpu.models.als.serving import ALSServingModel as RefModel
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.models.als.rescorer import (
    MultiRescorer,
    MultiRescorerProvider,
    Rescorer,
    RescorerProvider,
    load_rescorer_providers,
)
from oryx_tpu_torch.models.als.serving import ALSServingModel, ALSServingModelManager

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)


class _PlusOne(Rescorer):
    def rescore(self, id_, score):
        return score + 1.0


class _FilterEven(Rescorer):
    def rescore(self, id_, score):
        return float("nan") if int(id_[1:]) % 2 == 0 else score


class BanEvenProvider(RescorerProvider):
    """Filters even-numbered item ids; loadable by dotted name from config."""

    def __init__(self, config=None):
        pass

    def get_recommend_rescorer(self, user_ids, args):
        if args and args[0] == "off":
            return None
        return _FilterEven()


class PlusOneProvider(RescorerProvider):
    def __init__(self, config=None):
        pass

    def get_recommend_rescorer(self, user_ids, args):
        return _PlusOne()


class _RefFilterEven(ref_rescorer.Rescorer):
    def rescore(self, id_, score):
        return float("nan") if int(id_[1:]) % 2 == 0 else score


class _RefPlusOne(ref_rescorer.Rescorer):
    def rescore(self, id_, score):
        return score + 1.0


def test_multi_rescorer_composes_and_filters():
    multi = MultiRescorer([_PlusOne(), _PlusOne()])
    assert multi.rescore("i1", 1.0) == 3.0
    assert not multi.is_filtered("i1")
    multi2 = MultiRescorer([_PlusOne(), _FilterEven()])
    assert multi2.is_filtered("i2")
    assert not multi2.is_filtered("i3")
    assert math.isnan(multi2.rescore("i4", 9.0))


def test_multi_rescorer_of_collapses():
    assert MultiRescorer.of([None, None]) is None
    single = _PlusOne()
    assert MultiRescorer.of([None, single]) is single
    assert isinstance(MultiRescorer.of([_PlusOne(), _PlusOne()]), MultiRescorer)


def test_load_single_and_multiple_providers():
    config = cfg.overlay_on(
        {"oryx.als.rescorer-provider-class": "test_torch_rescorer.BanEvenProvider"},
        cfg.get_default(),
    )
    provider = load_rescorer_providers(config)
    assert isinstance(provider, BanEvenProvider)
    config2 = cfg.overlay_on(
        {"oryx.als.rescorer-provider-class":
            "test_torch_rescorer.BanEvenProvider,test_torch_rescorer.PlusOneProvider"},
        cfg.get_default(),
    )
    multi = load_rescorer_providers(config2)
    assert isinstance(multi, MultiRescorerProvider)
    rescorer = multi.get_recommend_rescorer(["u0"], [])
    assert rescorer.is_filtered("i2")
    assert rescorer.rescore("i3", 1.0) == 2.0
    assert multi.get_most_popular_items_rescorer([]) is None
    assert load_rescorer_providers(cfg.get_default()) is None
    # a provider of the reference package is not the port's
    bad = cfg.overlay_on(
        {"oryx.als.rescorer-provider-class": "test_rescorer.BanEvenProvider"},
        cfg.get_default())
    with pytest.raises(TypeError, match="RescorerProvider"):
        load_rescorer_providers(bad)


def test_rescorer_applies_to_top_n():
    """Model level: the rescore hook reorders and filters top-N results the
    way the /recommend endpoint wires it."""
    rng = np.random.default_rng(0)
    model = ALSServingModel(8, implicit=True, device="cpu")
    model.bulk_load_items(
        [f"i{i}" for i in range(50)], rng.standard_normal((50, 8)).astype(np.float32)
    )
    q = rng.standard_normal(8).astype(np.float32)
    rescorer = _FilterEven()
    plain = model.top_n(q, 10)
    filtered = model.top_n(
        q, 10,
        allowed=lambda i: not rescorer.is_filtered(i),
        rescore=rescorer.rescore,
    )
    assert len(filtered) == 10
    assert all(int(i[1:]) % 2 == 1 for i, _ in filtered)
    plain_odd = [i for i, _ in plain if int(i[1:]) % 2 == 1]
    assert [i for i, _ in filtered[: len(plain_odd)]] != [] and set(plain_odd) <= {
        i for i, _ in filtered
    } | {i for i, _ in plain}


@pytest.mark.parametrize("dtype,sample_rate", [("float32", 1.0), ("int8", 1.0),
                                               ("int8", 0.3)])
def test_composed_rescorer_hooks_answer_as_the_reference(dtype, sample_rate):
    """The same composed rescorer in both packages, wired as the resources
    wire it: the same ids in the same order, scores within 1e-5."""
    from oryx_tpu.common import rand as ref_rand
    from oryx_tpu_torch.common import rand

    rng = np.random.default_rng(4)
    y = rng.standard_normal((800, 12)).astype(np.float32)
    ids = [f"i{i}" for i in range(800)]
    ref_rand.use_test_seed()
    ref = RefModel(12, True, sample_rate, device_dtype=dtype)
    rand.use_test_seed()
    got = ALSServingModel(12, True, sample_rate, device_dtype=dtype, device="cpu")
    ref.bulk_load_items(ids, y)
    got.bulk_load_items(ids, y)
    ref_r = ref_rescorer.MultiRescorer.of([_RefPlusOne(), _RefFilterEven()])
    got_r = MultiRescorer.of([_PlusOne(), _FilterEven()])
    for q in rng.standard_normal((5, 12)).astype(np.float32):
        a = got.top_n(q, 10, allowed=lambda i: not got_r.is_filtered(i),
                      rescore=got_r.rescore)
        b = ref.top_n(q, 10, allowed=lambda i: not ref_r.is_filtered(i),
                      rescore=ref_r.rescore)
        assert [i for i, _ in a] == [i for i, _ in b]
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b],
                                   rtol=1e-5)


def test_serving_manager_loads_the_configured_provider():
    conf = cfg.overlay_on(
        {"oryx.als.rescorer-provider-class": "test_torch_rescorer.PlusOneProvider"},
        cfg.get_default())
    manager = ALSServingModelManager(conf, device="cpu")
    assert isinstance(manager.rescorer_provider, PlusOneProvider)
    assert ALSServingModelManager(cfg.get_default(),
                                  device="cpu").rescorer_provider is None
