"""Multi-host bootstrap, as the CLI calls it before it builds a layer.

The port of the JAX package's ``oryx_tpu/parallel/distributed.py``, whose
``initialize_from_config`` joins the JAX distributed runtime described by
``oryx.distributed.*``; here it joins a ``torch.distributed`` process
group::

    oryx.distributed {
      coordinator = "host0:8476"   # null = single-host (default)
      num-processes = 4            # the job's processes (the world size)
      process-id = 0               # this process's rank
    }

Without a ``coordinator`` it returns ``False`` and starts nothing, as the
reference does. With one, every process calls
``torch.distributed.init_process_group`` at ``tcp://<coordinator>`` with
its world size and rank: over ``gloo`` when the deployment's platform
(``oryx.default-compute-config.platform``, the key that asks every tier
for the CPU) is the CPU, over ``nccl`` on the cards. It is idempotent.

The group is the job's collective channel; the device mesh stays local to
each process (:func:`oryx_tpu_torch.parallel.mesh.local_devices`), so a
``mesh-shape`` larger than one host still raises.
"""

from __future__ import annotations

import logging

import torch

from oryx_tpu_torch.parallel.mesh import (
    DEFAULT_COMPUTE_KEY,
    default_platform,
    platform_device,
)

log = logging.getLogger(__name__)


def backend_for(config) -> str:
    """``gloo`` when the deployment's platform is the CPU, ``nccl``
    otherwise."""
    platform = platform_device(default_platform(config), DEFAULT_COMPUTE_KEY)
    return "gloo" if platform == "cpu" else "nccl"


def initialize_from_config(config) -> bool:
    """Join the multi-host job described by ``oryx.distributed.*``.

    Returns True when the process group was (or already is) initialized,
    False for single-host configs."""
    if is_initialized():
        return True
    coordinator = config.get_string("oryx.distributed.coordinator", None)
    if not coordinator:
        return False
    num_processes = config.get_int("oryx.distributed.num-processes", None)
    process_id = config.get_int("oryx.distributed.process-id", None)
    if num_processes is None or process_id is None:
        raise ValueError(
            "oryx.distributed.coordinator needs num-processes and process-id")
    backend = backend_for(config)
    log.info("joining distributed job: coordinator=%s processes=%s rank=%s "
             "backend=%s", coordinator, num_processes, process_id, backend)
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id)
    log.info("distributed runtime up: process %d/%d",
             torch.distributed.get_rank(), torch.distributed.get_world_size())
    return True


def is_initialized() -> bool:
    """Whether this process is in a ``torch.distributed`` process group."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if is_initialized():
        torch.distributed.destroy_process_group()
