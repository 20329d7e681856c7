"""Tuning sweep for the gather-Gramian kernel on one CUDA card.

    python3 tune_gather_gramian.py

Builds the same data and packed blocks as ``chip_smoke.py`` (its seed and
sizes, k = 50, float32) and times the kernel by bare launches of its C
entry on block 0 of each side:

* at unit sizes of 128 to 2,048 entries (``unit_entries``; the schedule
  may raise a size for the workspace bound, and reports the size it used);
* with the default schedule's units launched in slot order instead of
  longest first; the result must be the same bits.

Prints the card's name and power limit, then one JSON object per block.
Exits 1 without a CUDA card. Nothing in the port reads its output: it
records why ``GG_UNIT_ENTRIES`` is 512 and why units launch longest first.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch

import chip_smoke as cs
from oryx_tpu_torch.common.device import resolve
from oryx_tpu_torch.models.als import data as als_data
from oryx_tpu_torch.models.als import train as tr
from oryx_tpu_torch.ops import kernels as K

UNIT_SIZES = (128, 256, 512, 1024, 2048)


def sweep(side, y, label: str) -> dict:
    srow, scols, svals, slens = (side.srows[0], side.scols[0], side.svals[0],
                                 side.slens[0])
    t = side.slot_width
    w, coef = tr._entry_weights(svals, slens, cs.ALPHA, True, t)
    args = (y, srow, scols, w, coef, slens)
    out = {"block": label, "rows": side.block, "T": t, "unit_ms": {}}
    for u in UNIT_SIZES:
        sched = K.gather_gramian_schedule(srow, slens, block=side.block,
                                          slot_width=t, unit_entries=u)
        out["unit_ms"][str(u)] = {
            "unit_entries": sched.unit_entries, "units": sched.units,
            "split_rows": sched.split_rows,
            "ms": cs.time_ms(cs.gg_bare_launch(args, side.block, sched),
                             inner=cs.INNER)}
    sched = side.gg_schedules[0]
    units = sched.work[:sched.units]
    in_slot_order = dataclasses.replace(sched, work=torch.cat(
        [units[torch.argsort(units[:, 1])], sched.work[sched.units:]]))
    default = cs.gg_bare_launch(args, side.block, sched)
    slot_order = cs.gg_bare_launch(args, side.block, in_slot_order)
    a, b = (x.clone() for x in default())
    sa, sb = slot_order()
    torch.cuda.synchronize()
    cs.check(torch.equal(a, sa) and torch.equal(b, sb),
             f"{label}: the launch order changed the result")
    out["longest_first_ms"] = cs.time_ms(default, inner=cs.INNER)
    out["slot_order_ms"] = cs.time_ms(slot_order, inner=cs.INNER)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_gather_gramian: no CUDA device", file=sys.stderr)
        return 1
    dev = resolve(None)
    print(cs.gpu_query(), flush=True)
    rng = np.random.default_rng(cs.SEED)
    lines = cs.synthetic_lines(rng)
    test_mask = rng.random(len(lines)) < cs.TEST_FRACTION
    batch = als_data.prepare(
        [ln for ln, m in zip(lines, test_mask) if not m], implicit=True)
    user_side, item_side = tr.prepare_blocked(batch, cs.FEATURES, device=dev)
    g = torch.Generator().manual_seed(cs.SEED)
    y_items = tr.init_item_factors(item_side.padded_rows, len(batch.items),
                                   cs.FEATURES, g, dev)
    y_users = tr.init_item_factors(user_side.padded_rows, len(batch.users),
                                   cs.FEATURES, g, dev)
    for side, y, label in ((user_side, y_items, "user"),
                           (item_side, y_users, "item")):
        print(json.dumps(sweep(side, y, label)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
