"""The port's sanitizer in a process of its own: run with
``ORYX_SANITIZE=locks,loop``, this file imports ``oryx_tpu_torch`` (which
installs the port's sanitizer) and nothing of the JAX package, so the
port's wrappers are the ones in place.

    ORYX_SANITIZE=locks,loop python tests/torch_sanitize_child.py guard
    ORYX_SANITIZE=locks,loop python tests/torch_sanitize_child.py mirror CASE
    ORYX_SANITIZE=locks,loop python tests/torch_sanitize_child.py overhead --device cpu
    ORYX_SANITIZE=locks,loop python tests/torch_sanitize_child.py probe --device cuda

Each command prints one JSON line; a failed check exits non-zero with its
traceback. ``tests/test_torch_sanitize.py`` runs the first three on the
CPU, ``chip_smoke.py``'s ``sanitize`` phase runs ``probe`` on the card.

The file lives under ``tests/`` on purpose: the sanitizer wraps only locks
allocated from a repo frame (its site filter matches ``oryx_tpu`` and
``tests`` paths), and the locks that :func:`probe` inverts and the probe
lock of :func:`overhead` must be wrapped.
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import oryx_tpu_torch  # noqa: E402,F401 — installs the sanitizer first

import _thread  # noqa: E402
import argparse  # noqa: E402
import ast  # noqa: E402
import asyncio  # noqa: E402
import asyncio.events  # noqa: E402
import json  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

from oryx_tpu_torch.common import config as cfg  # noqa: E402
from oryx_tpu_torch.tools import sanitize  # noqa: E402
from oryx_tpu_torch.tools.sanitize import locks as san_locks  # noqa: E402
from oryx_tpu_torch.tools.sanitize import loop as san_loop  # noqa: E402

#: The reference suite whose installing cases :func:`mirror` runs.
REFERENCE_TESTS = REPO / "tests" / "test_sanitize.py"


def guard() -> dict:
    """What this process has installed: the port's modes and whose
    ``threading.Lock`` / ``RLock`` / ``Handle._run`` are in place."""
    return {
        "modes": sorted(sanitize.modes()),
        "lock": ("port" if threading.Lock is san_locks._lock_factory
                 else "stdlib" if threading.Lock is _thread.allocate_lock
                 else "other"),
        "rlock": ("port" if threading.RLock is san_locks._rlock_factory
                  else "stdlib" if threading.RLock.__module__ == "threading"
                  else "other"),
        "handle_run": asyncio.events.Handle._run.__module__,
        # allocated here, a tests/ frame: wrapped when locks is on
        "lock_type": type(threading.Lock()).__name__,
    }


class _Skipped(Exception):
    pass


class _PytestStandIn:
    """What the reference's case bodies call of ``pytest``, without pytest."""

    @staticmethod
    def skip(reason: str = ""):
        raise _Skipped(reason)


def mirror(case: str) -> dict:
    """Run the reference test ``case`` of ``tests/test_sanitize.py`` (and
    the helper it calls) on the port's sanitizer: the function's source,
    compiled under the reference file's own name and lines (so its locks'
    sites read ``tests/test_sanitize.py:N``, as its assertions expect),
    with the port's modules in its globals. A ``no_sanitize`` mark runs
    the body inside ``sanitize.suspended()``, as the suite's conftest
    does."""
    tree = ast.parse(REFERENCE_TESTS.read_text(), str(REFERENCE_TESTS))
    body, marks = [], []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in (case, "_run_in_thread"):
            if node.name == case:
                marks = [ast.unparse(d) for d in node.decorator_list]
            node.decorator_list = []
            body.append(node)
    if not any(node.name == case for node in body):
        raise SystemExit(f"{case}: no such case in {REFERENCE_TESTS}")
    ns = {"__name__": "_reference_test_sanitize", "asyncio": asyncio,
          "threading": threading, "time": time, "pytest": _PytestStandIn,
          "cfg": cfg, "sanitize": sanitize, "san_locks": san_locks,
          "san_loop": san_loop}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(REFERENCE_TESTS),
                 "exec"), ns)
    fn = ns[case]
    outcome = "passed"
    try:
        if "pytest.mark.no_sanitize" in marks:
            with sanitize.suspended():
                fn()
        else:
            fn()
    except _Skipped as e:
        outcome = f"skipped: {e}"
    rep = sanitize.report()
    return {"case": case, "marks": marks, "outcome": outcome,
            "modes": sorted(sanitize.modes()),
            # what reached this process's own report: the deliberate
            # cycles and stalls stay inside sanitize.isolated()
            "session_cycles": len(rep["lock_cycles"]),
            "session_stalls": len(rep["loop_stalls"])}


def _run_in_thread(fn) -> None:
    t = threading.Thread(target=fn)
    t.start()
    t.join(10)
    assert not t.is_alive()


def inversion_and_stall(stall_s: float = 0.4) -> dict:
    """Inside ``sanitize.isolated()``: the two-thread lock inversion of
    ``tests/test_sanitize.py``'s installed-wrappers case (each order run
    alone, so nothing hangs) and one asyncio callback that blocks its loop
    for ``stall_s`` seconds. Returns what the report holds."""
    with sanitize.isolated() as (graph, watch):
        lock_a = threading.Lock()   # wrapped: allocated from a tests/ frame
        lock_b = threading.Lock()

        def forward():
            with lock_a:
                with lock_b:
                    pass

        def backward():
            with lock_b:
                with lock_a:
                    pass

        _run_in_thread(forward)
        _run_in_thread(backward)

        async def main():
            def blocks_the_loop():
                time.sleep(stall_s)

            asyncio.get_running_loop().call_soon(blocks_the_loop)
            await asyncio.sleep(stall_s + 0.2)

        asyncio.run(main())
        rep = sanitize.report()
        text = sanitize.render_report(rep)
        stall_ms = watch.stall_ms
    return {
        "lock_type": type(lock_a).__name__,
        "cycles": [{"ring": c["ring"], "edges": len(c["edges"]),
                    "stacks": sum(1 for e in c["edges"] if e["stack"])}
                   for c in rep["lock_cycles"]],
        "stalls": rep["loop_stalls"],
        "stall_threshold_ms": stall_ms,
        "rendered": {"cycles": text.count("LOCK-ORDER CYCLE"),
                     "stalls": text.count("LOOP STALL"),
                     "blocked_at": text.count("blocked at:")},
    }


def overhead(device: str) -> dict:
    """The sanitizer's cost on the smoke-benchmark serving shape, measured
    as ``tests/test_load_benchmark.py``'s gate measures it: bookkeeping
    events per batched ``top_n_batch`` call (5,000 x 16 items, batch 128,
    top 5) x the isolated per-event cost (min of 3 probe windows of 5,000
    acquire/release pairs) / the mean call over 20 calls."""
    import numpy as np
    import torch

    from oryx_tpu_torch.models.als.serving import ALSServingModel

    if device == "cpu":
        torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    items, features, how_many, batch = 5_000, 16, 5, 128
    model = ALSServingModel(features, implicit=True, device=device)
    model.bulk_load_items(
        [f"i{i}" for i in range(items)],
        rng.standard_normal((items, features)).astype(np.float32),
    )
    queries = rng.standard_normal((512, features)).astype(np.float32)
    _ = model.top_n_batch(queries[:batch], how_many)  # warm-up

    graph = san_locks.graph()
    watch = sanitize.stall_watch()
    ev0 = graph.events + watch.events
    n_calls = 20
    t0 = time.perf_counter()
    for i in range(n_calls):
        model.top_n_batch(queries[(i * batch) % 384:][:batch], how_many)
    elapsed = time.perf_counter() - t0
    events_per_call = (graph.events + watch.events - ev0) / n_calls
    mean_call = elapsed / n_calls

    # a tracked acquire/release pair is two bookkeeping events on the
    # steady-state path (edges already seen)
    probe_lock = threading.Lock()  # allocated HERE -> repo site -> tracked
    n_pairs = 5_000
    pair_cost = float("inf")
    for _ in range(3):
        t1 = time.perf_counter()
        for _ in range(n_pairs):
            with probe_lock:
                pass
        pair_cost = min(pair_cost, (time.perf_counter() - t1) / n_pairs)
    per_event_cost = pair_cost / 2.0
    return {
        "device": str(model.device), "items": items, "features": features,
        "batch": batch, "how_many": how_many, "calls": n_calls,
        "probe_lock_type": type(probe_lock).__name__,
        "events_per_call": events_per_call,
        "per_event_us": per_event_cost * 1e6,
        "mean_call_ms": mean_call * 1e3,
        "overhead": events_per_call * per_event_cost / mean_call,
    }


def probe(device: str) -> dict:
    """``guard`` + ``inversion_and_stall`` + ``overhead``: what the smoke's
    ``sanitize`` phase reads from its child."""
    return {"install": guard(), "isolated": inversion_and_stall(),
            "overhead": overhead(device)}


def main(argv: "list[str]") -> int:
    parser = argparse.ArgumentParser(prog="torch_sanitize_child")
    parser.add_argument("command", choices=("guard", "mirror", "overhead", "probe"))
    parser.add_argument("case", nargs="?")
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args(argv)
    if args.command == "guard":
        out = guard()
    elif args.command == "mirror":
        out = mirror(args.case)
    elif args.command == "overhead":
        out = overhead(args.device)
    else:
        out = probe(args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
