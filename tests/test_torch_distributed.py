"""The port's multi-host bootstrap against the reference's.

The three cases of ``tests/test_distributed.py``: without a coordinator
both packages start nothing; both read the same ``oryx.distributed.*``
defaults; and a real two-rank localhost job, each rank joining through
``initialize_from_config`` (``torch.distributed`` over ``gloo``, the CPU
platform's backend) and taking part in one all-gather. The rank program
imports neither ``jax`` nor ``oryx_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

from oryx_tpu.common import config as ref_cfg
from oryx_tpu.parallel import distributed as ref_distributed
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.parallel import distributed


def test_no_coordinator_is_single_host_noop():
    for module, config in ((distributed, cfg), (ref_distributed, ref_cfg)):
        assert module.initialize_from_config(config.get_default()) is False
        assert module.is_initialized() is False


def test_config_keys_exist():
    for config in (cfg.get_default(), ref_cfg.get_default()):
        assert config.get_string("oryx.distributed.coordinator", None) is None
        assert config.get_int("oryx.distributed.num-processes", None) is None
        assert config.get_int("oryx.distributed.process-id", None) is None
    assert distributed.backend_for(cfg.overlay_on(
        {"oryx.default-compute-config.platform": "cpu"}, cfg.get_default())) == "gloo"
    assert distributed.backend_for(cfg.get_default()) == "nccl"


_RANK_PROG = textwrap.dedent(
    """
    import json, sys

    import torch

    from oryx_tpu_torch.common import config as cfg
    from oryx_tpu_torch.parallel import distributed

    coordinator, rank = sys.argv[1], int(sys.argv[2])
    config = cfg.overlay_on(
        {
            "oryx.distributed.coordinator": coordinator,
            "oryx.distributed.num-processes": 2,
            "oryx.distributed.process-id": rank,
            "oryx.default-compute-config.platform": "cpu",
        },
        cfg.get_default(),
    )
    assert distributed.initialize_from_config(config) is True
    assert distributed.is_initialized() is True
    assert distributed.initialize_from_config(config) is True  # idempotent
    # one collective across the two processes proves the group is live
    parts = [torch.zeros(1) for _ in range(2)]
    torch.distributed.all_gather(parts, torch.tensor([rank + 1.0]))
    out = {
        "rank": torch.distributed.get_rank(),
        "count": torch.distributed.get_world_size(),
        "backend": torch.distributed.get_backend(),
        "allgather_sum": float(torch.cat(parts).sum()),
        "modules": sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "oryx_tpu")),
    }
    distributed.shutdown()
    out["after_shutdown"] = distributed.is_initialized()
    print(json.dumps(out))
    """
)


def test_two_process_localhost_job():
    """Two ranks join a localhost coordinator; both must see a world of 2
    and agree on a cross-process all-gather."""
    coordinator = f"127.0.0.1:{ioutils.choose_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RANK_PROG, coordinator, str(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for rank in range(2)
    ]
    parsed = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-2000:]
        parsed.append(json.loads(out.decode().strip().splitlines()[-1]))
    assert {o["rank"] for o in parsed} == {0, 1}
    for o in parsed:
        assert o["count"] == 2 and o["backend"] == "gloo"
        assert o["allgather_sum"] == 3.0  # (0+1) + (1+1)
        assert o["modules"] == [] and o["after_shutdown"] is False
