"""Rescoring SPI: per-request hooks to filter/adjust recommendation results.

A copy of the JAX package's ``oryx_tpu/models/als/rescorer.py`` (host code,
no JAX) on the port's ``common/classutils``, held to it by
``tests/test_torch_rescorer.py``. A provider named by
``oryx.als.rescorer-provider-class`` for the port subclasses THIS module's
:class:`RescorerProvider`. Below, "the reference" is the original Oryx that
module was modelled on.

Equivalent of the reference's oryx-app-api (app/oryx-app-api/.../als/
RescorerProvider.java, Rescorer.java, MultiRescorer.java:90,
MultiRescorerProvider.java:142, AbstractRescorerProvider.java): user-supplied
classes named by ``oryx.als.rescorer-provider-class`` adjust scores or filter
IDs for /recommend, /recommendToAnonymous, /mostPopularItems and
/mostActiveUsers.
"""

from __future__ import annotations

import abc
from typing import Sequence

from oryx_tpu_torch.common import classutils


class Rescorer(abc.ABC):
    @abc.abstractmethod
    def rescore(self, id_: str, score: float) -> float:
        """New score, NaN to filter (Rescorer.java)."""

    def is_filtered(self, id_: str) -> bool:
        import math

        return math.isnan(self.rescore(id_, 0.0))


class RescorerProvider(abc.ABC):
    def get_recommend_rescorer(self, user_ids: Sequence[str], args: Sequence[str]):
        return None

    def get_recommend_to_anonymous_rescorer(self, item_ids: Sequence[str], args: Sequence[str]):
        return None

    def get_most_popular_items_rescorer(self, args: Sequence[str]):
        return None

    def get_most_active_users_rescorer(self, args: Sequence[str]):
        return None


AbstractRescorerProvider = RescorerProvider


class MultiRescorer(Rescorer):
    """Composes several rescorers (MultiRescorer.java:90)."""

    def __init__(self, rescorers: Sequence[Rescorer]):
        self.rescorers = [r for r in rescorers if r is not None]

    def rescore(self, id_: str, score: float) -> float:
        import math

        for r in self.rescorers:
            score = r.rescore(id_, score)
            if math.isnan(score):
                return score
        return score

    def is_filtered(self, id_: str) -> bool:
        return any(r.is_filtered(id_) for r in self.rescorers)

    @staticmethod
    def of(rescorers: Sequence["Rescorer | None"]) -> "Rescorer | None":
        present = [r for r in rescorers if r is not None]
        if not present:
            return None
        if len(present) == 1:
            return present[0]
        return MultiRescorer(present)


class MultiRescorerProvider(RescorerProvider):
    """Composes several providers (MultiRescorerProvider.java:142)."""

    def __init__(self, providers: Sequence[RescorerProvider]):
        self.providers = list(providers)

    def get_recommend_rescorer(self, user_ids, args):
        return MultiRescorer.of([p.get_recommend_rescorer(user_ids, args) for p in self.providers])

    def get_recommend_to_anonymous_rescorer(self, item_ids, args):
        return MultiRescorer.of(
            [p.get_recommend_to_anonymous_rescorer(item_ids, args) for p in self.providers]
        )

    def get_most_popular_items_rescorer(self, args):
        return MultiRescorer.of([p.get_most_popular_items_rescorer(args) for p in self.providers])

    def get_most_active_users_rescorer(self, args):
        return MultiRescorer.of([p.get_most_active_users_rescorer(args) for p in self.providers])


def load_rescorer_providers(config) -> "RescorerProvider | None":
    """Load the configured provider class(es)
    (ALSServingModelManager.loadRescorerProviders:146-163)."""
    names = config.get("oryx.als.rescorer-provider-class", None)
    if not names:
        return None
    if isinstance(names, str):
        names = [n.strip() for n in names.split(",") if n.strip()]
    providers = [
        classutils.load_instance_of(name, RescorerProvider, config) for name in names
    ]
    if len(providers) == 1:
        return providers[0]
    return MultiRescorerProvider(providers)
