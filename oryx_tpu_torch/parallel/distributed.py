"""Multi-host bootstrap, as the CLI calls it before it builds a layer.

The port of the JAX package's ``oryx_tpu/parallel/distributed.py``, whose
``initialize_from_config`` joins the JAX distributed runtime described by
``oryx.distributed.*``::

    oryx.distributed {
      coordinator = "host0:8476"   # null = single-host (default)
      num-processes = 4
      process-id = 0
    }

Only the single-host half is ported: without a ``coordinator`` it returns
``False`` and starts nothing, exactly as the reference does. A configured
coordinator raises :class:`NotImplementedError`: the multi-card runtime
(``torch.distributed`` over NCCL) is ROADMAP Queue 1, item 5, and nothing
is started on the one card in its place.
"""

from __future__ import annotations


def initialize_from_config(config) -> bool:
    """Join the multi-host job described by ``oryx.distributed.*``.

    Returns False for single-host configs; raises for a configured
    coordinator (not ported yet)."""
    coordinator = config.get_string("oryx.distributed.coordinator", None)
    if not coordinator:
        return False
    raise NotImplementedError(
        f"oryx.distributed.coordinator = {coordinator!r}: the multi-host "
        "runtime (torch.distributed over NCCL) is not ported yet "
        "(ROADMAP Queue 1, item 5)")


def is_initialized() -> bool:
    """Always False: no multi-host runtime is ported."""
    return False
