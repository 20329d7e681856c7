"""Key/message pair flowing through topics.

A copy of the JAX package's
``oryx_tpu/api/keymessage.py``
(host code, no JAX), held equal to it by ``tests/test_torch_kmeans.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's KeyMessage/KeyMessageImpl
(framework/oryx-api/.../KeyMessage.java:34-40, KeyMessageImpl.java), plus
transport-level ``headers`` (Kafka record headers equivalent) carrying
cross-tier metadata — today the W3C ``traceparent`` injected by
TopicProducerImpl so a trace minted at HTTP ingress survives the topic hop
into the speed/batch tiers (common/spans.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Generic, TypeVar

K = TypeVar("K")
M = TypeVar("M")


@dataclass(frozen=True)
class KeyMessage(Generic[K, M]):
    key: K
    message: M
    #: Transport metadata (e.g. {"traceparent": ...}); excluded from
    #: equality so payload comparison semantics predate headers.
    headers: "dict | None" = field(default=None, compare=False)

    def get_key(self) -> K:
        return self.key

    def get_message(self) -> M:
        return self.message
