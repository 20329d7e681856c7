"""Device mesh and compute context: where a layer's generations run.

The port of the JAX package's ``oryx_tpu/parallel/mesh.py``. A layer hands
its :class:`ComputeContext` to the batch update and reads its device when
it builds the update class or a model manager. It reads
``oryx.<tier>.streaming.config`` as the reference does:

  * ``platform``: ``null`` (the default) or ``"gpu"`` / ``"cuda"`` mean the
    CUDA cards, through :func:`~oryx_tpu_torch.common.device.resolve`,
    which raises without one; ``"cpu"`` means the CPU. A tier whose own
    ``platform`` is null takes ``oryx.default-compute-config.platform``:
    the defaults' ``config = ${oryx.default-compute-config}`` is resolved
    when the defaults are parsed, so a file that sets only the shared key
    would otherwise not reach the tiers. That one key asks a whole
    deployment (batch, speed and, through the CLI, serving) for the CPU;
  * ``mesh-shape`` / ``mesh-axes``: the mesh over the platform's local
    devices (:func:`local_devices`). ``null`` puts every local device on
    the first axis; a shape that needs more devices than the host has
    raises the reference's ``ValueError``.

A :class:`Mesh` is a numpy array of ``torch.device`` entries with axis
names. Its entries may repeat a device (:func:`make_mesh` with
``devices=``): each shard is still its own tensor and its own kernel
launches, and the reductions and merges run as they would across cards;
only where the tensors live changes. That is how the CPU tests and one
card hold a several-shard run. The mesh is local to this process:
:mod:`oryx_tpu_torch.parallel.distributed` joins a job of several
processes, but no mesh spans them.

The counterpart of the reference's ``NamedSharding`` over one axis is
:class:`ShardedRows`: one tensor per shard along a mesh axis, rows padded
with zeros to a multiple of the shard count; :func:`replicated` is the
counterpart of ``PartitionSpec()``, a copy of a value on each shard's
device.

The context also carries what the batch layer records for the lineage
stamp of a publish (``input_offsets``, ``input_watermark_ms``,
``input_max_event_ms``, ``lineage_fingerprint``, ``lineage_origin``; see
:func:`oryx_tpu_torch.common.lineage.make_stamp`).
"""

from __future__ import annotations

import math

import numpy as np
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


def local_devices(platform: "str | None" = None) -> "list[torch.device]":
    """This process's devices of ``platform`` (the counterpart of
    ``jax.devices(platform)``): one entry per CUDA card for null / gpu /
    cuda (raises without a card), one ``cpu`` entry for cpu."""
    dev = resolve(platform_device(platform, "platform"))
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """Devices on named axes: ``devices`` is a numpy object array of
    ``torch.device`` (entries may repeat), ``shape`` maps each axis name to
    its size, in order."""

    def __init__(self, devices: np.ndarray, axis_names):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dimensions needs as many "
                             f"axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> "list[torch.device]":
        """The devices along ``axis`` (index 0 on every other axis): shard
        ``i`` of a value sharded over ``axis`` lives on entry ``i``."""
        at = self.axis_names.index(axis)
        index = tuple(slice(None) if a == at else 0
                      for a in range(len(self.axis_names)))
        return list(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _device_array(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr.reshape(tuple(int(s) for s in shape))


def make_mesh(n_devices: "int | None" = None, axes=("data",), shape=None,
              devices=None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    local CUDA card), on ``axes``; ``shape`` defaults to all of them on the
    first axis. An explicit ``devices`` list may repeat a device."""
    devs = list(devices) if devices is not None else local_devices()
    if n_devices is None:
        n_devices = len(devs)
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axes) - 1)
    n_used = math.prod(int(s) for s in shape)
    if n_used > len(devs):
        raise ValueError(f"mesh shape {list(shape)} needs {n_used} devices, "
                         f"have {len(devs)}")
    for d in devs[:n_used]:
        resolve(d)
    return Mesh(_device_array(devs[:n_used], shape), axes)


class ShardedRows:
    """A value whose rows are split over a mesh axis: ``shards[i]`` (an
    equal run of rows) lives on the axis's ``i``-th device. ``shape`` is
    the global shape, rows padded to a multiple of the shard count."""

    def __init__(self, shards: "list[torch.Tensor]", axis: str):
        rows = {s.shape[0] for s in shards}
        if len(rows) != 1:
            raise ValueError(f"shards of unequal rows {sorted(rows)}")
        self.shards = list(shards)
        self.axis = axis
        first = self.shards[0]
        self.shape = (first.shape[0] * len(self.shards), *first.shape[1:])

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def rows_per_shard(self) -> int:
        return self.shards[0].shape[0]

    @property
    def devices(self) -> "list[torch.device]":
        return [s.device for s in self.shards]

    def full(self) -> torch.Tensor:
        """The whole value gathered onto shard 0's device."""
        dev = self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards])


def shard_rows(value: torch.Tensor, mesh: Mesh, axis: str) -> ShardedRows:
    """``value``'s rows split evenly over ``mesh``'s ``axis``, padded with
    zero rows to a multiple of the shard count."""
    devs = mesh.axis_devices(axis)
    pad = (-value.shape[0]) % len(devs)
    if pad:
        value = torch.cat([value, value.new_zeros((pad, *value.shape[1:]))])
    per = value.shape[0] // len(devs)
    return ShardedRows([value[i * per:(i + 1) * per].to(d)
                        for i, d in enumerate(devs)], axis)


def replicated(value: torch.Tensor,
               devices: "list[torch.device]") -> "list[torch.Tensor]":
    """A copy of ``value`` on each of ``devices`` (one tensor per distinct
    device, shared by the entries that repeat it)."""
    copies: dict = {}
    return [copies.setdefault(d, value.to(d)) for d in devices]


class ComputeContext:
    """The mesh a tier computes on, passed to batch updates and model
    managers. ``device`` is the mesh's first device."""

    def __init__(self, config, tier: str = "batch"):
        self.config = config
        self.tier = tier
        compute_key = f"oryx.{tier}.streaming.config"
        ccfg = config.get_config(compute_key) if config.has(compute_key) else None
        platform = ccfg.get_string("platform", None) if ccfg else None
        platform_key = compute_key
        if platform is None:
            platform, platform_key = default_platform(config), DEFAULT_COMPUTE_KEY
        platform_device(platform, platform_key)
        devices = local_devices(platform)
        shape = ccfg.get_list("mesh-shape", None) if ccfg else None
        axes = (tuple(ccfg.get_list("mesh-axes", ["data", "model"])) if ccfg
                else ("data", "model"))
        if shape is None:
            shape = [len(devices)] + [1] * (len(axes) - 1)
        n_used = math.prod(int(d) for d in shape)
        if n_used > len(devices):
            raise ValueError(
                f"mesh shape {list(shape)} needs {n_used} devices, have "
                f"{len(devices)}")
        self.mesh = Mesh(_device_array(devices[:n_used], shape), axes)
        self.device: torch.device = self.mesh.devices.flat[0]
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
        return self.mesh.size

    def shard_rows(self, value: torch.Tensor, axis: str) -> ShardedRows:
        """``value`` row-sharded over this mesh's ``axis``."""
        return shard_rows(value, self.mesh, axis)

    def replicated(self, value: torch.Tensor) -> "list[torch.Tensor]":
        """``value`` on every device of this mesh, in the mesh's order."""
        return replicated(value, list(self.mesh.devices.flat))
