"""Protocol model checker.

The port's copy of the JAX package's ``oryx_tpu/tools/analyze/protocol/``
(stdlib only; it imports nothing of that package): the same models,
variants and tier-1 depth, with every :class:`Site` pointing at the
port's sources (``oryx_tpu_torch/...``), its line re-anchored there.

A stdlib-only explicit-state model checker for the transport-layer
protocols behind the exactly-once story: the consumer-group
join/heartbeat/rebalance machine, the broker append path (idempotence
tokens, retries, torn-tail recovery), and the checkpoint/generation
lifecycle. Each transition carries ``file:line`` annotations of the
implementation site it abstracts; the ``protocol-model-drift``
conformance checker keeps those annotations honest against the real
code.

Public surface:

* :func:`build_model` — construct a model (optionally a named buggy
  variant that re-introduces a historically-fixed bug).
* :func:`explore` / :func:`replay` / :func:`render_schedule` — the
  engine, re-exported from :mod:`.machine`.
* :data:`MODELS` / :data:`MODEL_VARIANTS` — the registry.
* :data:`TIER1_DEPTH` / :data:`TIER1_CRASH_BUDGET` — the depth every
  tier-1 run must explore clean at HEAD (3 consumers x 2
  partitions x 2 crash/restarts = 12).
"""

from __future__ import annotations

from oryx_tpu_torch.tools.analyze.protocol import broker_model, ckpt_model, group_model
from oryx_tpu_torch.tools.analyze.protocol.machine import (
    Action,
    ExploreResult,
    Model,
    ReplayResult,
    S,
    Site,
    Violation,
    explore,
    render_schedule,
    replay,
    shortest_counterexample,
)

#: Minimum interleaving depth every HEAD model must explore violation-free
#: in a tier-1 run: 3 consumers x 2 partitions x 2 crash/restarts.
TIER1_DEPTH = 12
TIER1_CRASH_BUDGET = 2

_BUILDERS = {
    "consumer-group": group_model.build,
    "broker-append": broker_model.build,
    "ckpt-generation": ckpt_model.build,
}

MODELS = tuple(_BUILDERS)

MODEL_VARIANTS = {
    "consumer-group": group_model.VARIANTS,
    "broker-append": broker_model.VARIANTS,
    "ckpt-generation": ckpt_model.VARIANTS,
}

#: The three historical bugs the explorer must rediscover, as (model, variant, invariant-expected-to-fire).
HISTORICAL_BUGS = (
    ("consumer-group", "skip-hysteresis", "no-duplicate-delivery"),
    ("consumer-group", "closing-claims", "closing-consumer-claim"),
    ("broker-append", "no-token-dedup", "no-duplicate-append"),
)


def build_model(name: str, variant: str = "") -> Model:
    """Build a registered protocol model, optionally a buggy variant."""
    try:
        builder = _BUILDERS[name]
    except KeyError:
        raise ValueError(
            f"unknown protocol model {name!r}; known: {', '.join(MODELS)}"
        ) from None
    return builder(variant)


def all_models(include_variants: bool = False):
    """Yield every HEAD model, plus buggy variants when asked."""
    for name in MODELS:
        yield build_model(name)
        if include_variants:
            for variant in MODEL_VARIANTS[name]:
                yield build_model(name, variant)


__all__ = [
    "Action",
    "ExploreResult",
    "HISTORICAL_BUGS",
    "MODELS",
    "MODEL_VARIANTS",
    "Model",
    "ReplayResult",
    "S",
    "Site",
    "TIER1_CRASH_BUDGET",
    "TIER1_DEPTH",
    "Violation",
    "all_models",
    "build_model",
    "explore",
    "render_schedule",
    "replay",
    "shortest_counterexample",
]
