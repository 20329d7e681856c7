"""Compute context: the device a layer's generations run on.

The port of the JAX package's ``oryx_tpu/parallel/mesh.py`` for one device.
A layer hands its ``ComputeContext`` to the batch update and reads its
device when it builds the update class or a model manager. It reads
``oryx.<tier>.streaming.config`` as the reference does:

  * ``platform``: ``null`` (the default) or ``"gpu"`` / ``"cuda"`` mean the
    CUDA card, through :func:`~oryx_tpu_torch.common.device.resolve`, which
    raises without one; ``"cpu"`` means the CPU. A tier whose own
    ``platform`` is null takes ``oryx.default-compute-config.platform``:
    the defaults' ``config = ${oryx.default-compute-config}`` is resolved
    when the defaults are parsed, so a file that sets only the shared key
    would otherwise not reach the tiers. That one key asks a whole
    deployment (batch, speed and, through the CLI, serving) for the CPU;
  * ``mesh-shape``: a shape whose product is over 1 is refused (the
    multi-device mesh is not ported yet).

The context also carries what the batch layer records for the lineage
stamp of a publish (``input_offsets``, ``input_watermark_ms``,
``input_max_event_ms``, ``lineage_fingerprint``, ``lineage_origin``; see
:func:`oryx_tpu_torch.common.lineage.make_stamp`).
"""

from __future__ import annotations

import math

import torch

from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common.device import resolve

_PLATFORMS = {None: None, "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}
DEFAULT_COMPUTE_KEY = "oryx.default-compute-config"


def platform_device(platform, key: str) -> "str | None":
    """The ``device`` argument a ``platform`` value names: None (the card)
    for null, ``"cuda"`` for gpu / cuda, ``"cpu"`` for cpu; anything else
    raises, naming ``key``."""
    if platform not in _PLATFORMS:
        raise ValueError(
            f"{key}.platform must be null, gpu, cuda or cpu, got {platform!r}")
    return _PLATFORMS[platform]


def default_platform(config):
    """``oryx.default-compute-config.platform`` (None where unset)."""
    if not config.has(DEFAULT_COMPUTE_KEY):
        return None
    return config.get_config(DEFAULT_COMPUTE_KEY).get_string("platform", None)


class ComputeContext:
    """One-device context passed to batch updates and model managers."""

    def __init__(self, config, tier: str = "batch"):
        self.config = config
        self.tier = tier
        compute_key = f"oryx.{tier}.streaming.config"
        ccfg = config.get_config(compute_key) if config.has(compute_key) else None
        platform = ccfg.get_string("platform", None) if ccfg else None
        platform_key = compute_key
        if platform is None:
            platform, platform_key = default_platform(config), DEFAULT_COMPUTE_KEY
        device = platform_device(platform, platform_key)
        shape = ccfg.get_list("mesh-shape", None) if ccfg else None
        if shape is not None and math.prod(int(d) for d in shape) > 1:
            raise NotImplementedError(
                f"{compute_key}.mesh-shape {shape}: a multi-device mesh is "
                "not ported yet")
        self.device: torch.device = resolve(device)
        kind = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        metrics_mod.set_build_info(self.device.type, kind)
        self.input_offsets: "dict[int, int] | None" = None
        self.input_watermark_ms: "int | None" = None
        self.input_max_event_ms: "int | None" = None
        self.lineage_fingerprint: "str | None" = None
        self.lineage_origin: "str | None" = None

    @property
    def num_devices(self) -> int:
        return 1
