"""Does ``torch.profiler`` still see the card after an idle gap?

    python3 profiler_gap.py

Needs one CUDA card. Profiles one 2,048 × 2,048 float32 matrix product under
``torch.profiler`` (CUPTI), then again after sleeping 5, 10, 20, 40 and
80 s, and prints one JSON line per session: the gap before it and the
number of device events it recorded; then the card's name and power limit
as ``nvidia-smi`` prints them. On the H100 machines ``chip_smoke.py`` runs
on, a session after some gap has recorded no device events, and no later
session in the process recorded any; the gap at which that starts differs
from run to run (one run still recorded after 10 and 20 s and not after
40 s; another recorded after 5 s and not after 10 s). So the smoke runs its
profiled phases back to back and its ALS generation phase last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def device_events(fn) -> int:
    """Device events ``torch.profiler`` records over one call of ``fn``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_gap: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    a = torch.randn(2048, 2048, device="cuda")
    (a @ a).sum().item()
    for gap in (0, 5, 10, 20, 40, 80):
        time.sleep(gap)
        print(json.dumps({"gap_s": gap, "device_events": device_events(lambda: a @ a)}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
