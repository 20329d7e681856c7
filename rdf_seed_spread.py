"""The hold-out accuracy of ``chip_smoke.py``'s RDF generation over seeds.

``chip_smoke.rdf_generation`` runs ``RDFUpdate.run_update`` on the first
``RDF_LINES`` synthetic covtype rows (20 trees, depth 8, 10% held out) and
gates on a hold-out accuracy of at least 0.90; its draws come from the
smoke's fixed ``SEED`` through ``rand.seeded``. This script runs the same
generation for ``--seeds`` consecutive seeds starting at ``SEED`` (the
smoke's own is the first) and prints one JSON line per seed, then a
summary line: min, max, mean, standard deviation, and how many fell under
the gate. The forest grows node for node the same on the CPU as on the
card, so ``--device cpu`` gives the card's numbers.

    python3 rdf_seed_spread.py [--seeds 20] [--device cpu] [--threads 4]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import rand
from oryx_tpu_torch.models.rdf.update import RDFUpdate

GATE = 0.90


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="'cpu', or omit for the CUDA card")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch intra-op threads (0: torch's default)")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    data = cs.covtype_data(np.random.default_rng(cs.SEED + 19), cs.RDF_ROWS)
    lines = cs.covtype_lines(data["X"][:cs.RDF_LINES], data["cover"][:cs.RDF_LINES])
    del data
    messages = [KeyMessage(None, ln) for ln in lines]
    conf = cs.rdf_conf()
    accuracies = []
    for seed in range(cs.SEED, cs.SEED + args.seeds):
        update = RDFUpdate(conf, device=args.device)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="oryx-rdf-spread-") as d, \
                rand.seeded(seed):
            update.run_update(None, cs.GENERATION_TIMESTAMP_MS, messages, [],
                              d, cs.RecordingProducer())
        (cand,) = update.report["candidates"].values()
        accuracies.append(float(cand["eval"]))
        print(json.dumps({"seed": seed, "accuracy": accuracies[-1],
                          "seconds": time.perf_counter() - t0}), flush=True)
    acc = np.asarray(accuracies)
    print(json.dumps({
        "seeds": len(acc), "first_seed": cs.SEED, "device": args.device or "cuda",
        "smoke_seed_accuracy": accuracies[0], "min": float(acc.min()),
        "max": float(acc.max()), "mean": float(acc.mean()),
        "std": float(acc.std(ddof=1)) if len(acc) > 1 else 0.0,
        "below_gate": int((acc < GATE).sum()), "gate": GATE}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
