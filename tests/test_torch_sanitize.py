"""The port's runtime concurrency sanitizer (``oryx_tpu_torch/tools/sanitize``),
held to the reference's tests and to the reference itself.

* The 12 cases of ``tests/test_sanitize.py`` that drive ``LockGraph`` /
  ``StallWatch`` directly (or read the config) run here with the reference
  test file's own bodies rebound to the port's modules (``_mirror``).
* The 8 that install the sanitizer or rely on the ``no_sanitize`` marker run
  in a child interpreter that imports only ``oryx_tpu_torch``
  (``tests/torch_sanitize_child.py mirror CASE``): in this process the
  suite's conftest has installed the reference's sanitizer first, and an
  install over it is exactly what the port's guard refuses.
* Parity pins: the same seeded acquire/release sequences through both
  packages' ``LockGraph`` give the same edges and cycles; ``bfs_path`` on
  seeded graphs, ``parse_modes`` and ``render_report`` give the same
  answers, the report byte for byte.
* The guard: importing the port here leaves the reference's wrappers in
  place and the port's modes unset; a child under ``ORYX_SANITIZE`` has the
  port's wrappers, a child under ``ORYX_SANITIZE=off`` none, and a child
  whose ``threading.Lock`` another sanitizer replaced keeps only ``loop``.
* The overhead gate of ``tests/test_load_benchmark.py`` on the port's
  ``ALSServingModel`` on the CPU (in a sanitized child), the smoke's
  ``sanitize`` phase rehearsed on the CPU, and its report parser.
"""

from __future__ import annotations

import ast
import asyncio
import asyncio.events
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from oryx_tpu.tools import sanitize as ref_sanitize
from oryx_tpu.tools.sanitize import locks as ref_locks
from oryx_tpu.tools.sanitize import loop as ref_loop
import oryx_tpu_torch
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import metrics
from oryx_tpu_torch.tools import sanitize
from oryx_tpu_torch.tools.sanitize import locks as san_locks
from oryx_tpu_torch.tools.sanitize import loop as san_loop
from test_torch_observability import _mirror

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
CHILD = TESTS / "torch_sanitize_child.py"

_SAN = _mirror("test_sanitize.py", {"sanitize": sanitize, "san_locks": san_locks,
                                    "san_loop": san_loop, "cfg": cfg})

_IN_PROCESS_CASES = [
    "test_cycle_detector_flags_inverted_order",
    "test_cycle_detector_quiet_on_consistent_order_and_same_site",
    "test_cycle_detector_finds_three_lock_ring",
    "test_long_hold_outlier_reported_with_duration",
    "test_stall_watch_records_completed_stall",
    "test_stall_watchdog_captures_live_stack_of_blocked_thread",
    "test_stall_watch_honors_suspension_on_both_record_paths",
    "test_stall_watch_subtracts_gc_pause_time",
    "test_parse_modes",
    "test_configure_applies_sanitize_thresholds",
    "test_reference_conf_declares_sanitize_defaults",
    "test_report_is_clean_shape_when_nothing_found",
]
_CHILD_CASES = [
    "test_thread_startup_event_locks_stay_real",
    "test_installed_wrappers_catch_deadlock_shaped_threads",
    "test_condition_on_sanitized_rlock_keeps_working",
    "test_suspended_records_no_bookkeeping",
    "test_release_inside_suspended_window_leaves_no_ghost_hold",
    "test_loop_watchdog_end_to_end_on_blocked_asyncio_loop",
    "test_loop_watchdog_quiet_on_well_behaved_loop",
    "test_no_sanitize_marker_suspends_bookkeeping",
]
for _name in _IN_PROCESS_CASES:
    globals()[f"{_name}_port"] = _SAN[_name]


def _child(*args: str, env: "dict | None" = None, code: "str | None" = None,
           timeout: float = 120) -> tuple:
    """Run ``tests/torch_sanitize_child.py`` (or ``code`` with ``-c``) with
    every ``ORYX_SANITIZE*`` variable replaced by ``env`` (default: both
    modes, default thresholds); returns (its JSON line, its stderr)."""
    full = {k: v for k, v in os.environ.items() if not k.startswith("ORYX_SANITIZE")}
    full.update({"ORYX_SANITIZE": "locks,loop"} if env is None else env)
    argv = ["-c", code, *args] if code is not None else [str(CHILD), *args]
    done = subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                          timeout=timeout, cwd=REPO, env=full)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1]), done.stderr


def test_every_reference_case_is_mirrored():
    tree = ast.parse((TESTS / "test_sanitize.py").read_text())
    cases = {n.name for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert len(cases) == 20
    assert set(_IN_PROCESS_CASES) | set(_CHILD_CASES) == cases
    assert not set(_IN_PROCESS_CASES) & set(_CHILD_CASES)


@pytest.mark.parametrize("case", _CHILD_CASES)
def test_installing_reference_case_in_a_port_sanitized_child(case):
    out, stderr = _child("mirror", case)
    assert out["outcome"] == "passed", out
    assert out["modes"] == ["locks", "loop"]
    # the deliberate cycles and stalls stayed inside sanitize.isolated():
    # neither the child's report nor its exit dump holds any
    assert out["session_cycles"] == 0 and out["session_stalls"] == 0, out
    assert "LOCK-ORDER CYCLE" not in stderr and "LOOP STALL" not in stderr, stderr


# -- parity with the reference ------------------------------------------------


def _seeded_threads(seed: int, n_threads: int = 6, steps: int = 40,
                    n_sites: int = 6) -> list:
    """Per thread, a seeded sequence of acquires (site, object) and
    releases, not always of the innermost hold, re-entry allowed; every
    thread ends holding nothing."""
    rng = np.random.default_rng(seed)
    sites = [f"s{j}.py:{10 + j}" for j in range(n_sites)]
    threads = []
    for _ in range(n_threads):
        events, held = [], []
        for _ in range(steps):
            if held and (len(held) >= 3 or rng.random() < 0.45):
                events.append(("rel", *held.pop(int(rng.integers(len(held))))))
            else:
                site = sites[int(rng.integers(n_sites))]
                obj = f"{site}#{int(rng.integers(2))}"
                events.append(("acq", site, obj))
                held.append((site, obj))
        while held:
            events.append(("rel", *held.pop()))
        threads.append(events)
    return threads


def _drive(graph, threads) -> None:
    for events in threads:
        def run(events=events):
            for kind, site, obj in events:
                if kind == "acq":
                    graph.on_acquired(site, obj)
                else:
                    graph.on_released(site, obj)

        t = threading.Thread(target=run)
        t.start()
        t.join(10)
        assert not t.is_alive()


def _without_stacks(cycles: list) -> list:
    return [{"ring": c["ring"],
             "edges": [{k: v for k, v in e.items() if k != "stack"} for e in c["edges"]]}
            for c in cycles]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lock_graph_parity_on_a_seeded_event_sequence(seed):
    threads = _seeded_threads(seed)
    ref_graph, port_graph = ref_sanitize.LockGraph(), sanitize.LockGraph()
    _drive(ref_graph, threads)
    _drive(port_graph, threads)
    ref_edges = {k: v["count"] for k, v in ref_graph.edges().items()}
    assert ref_edges and {k: v["count"] for k, v in port_graph.edges().items()} == ref_edges
    ref_cycles, port_cycles = ref_graph.cycles(), port_graph.cycles()
    assert ref_cycles, "the seeded sequence should hold an ordering cycle"
    assert _without_stacks(port_cycles) == _without_stacks(ref_cycles)
    assert all(e["stack"] for c in port_cycles for e in c["edges"])
    assert port_graph.events == ref_graph.events == sum(len(t) for t in threads)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bfs_path_parity_on_seeded_graphs(seed):
    rng = np.random.default_rng(seed)
    nodes = [f"n{j}" for j in range(12)]
    adj: dict = {}
    for a in nodes:
        for b in nodes:
            if a != b and rng.random() < 0.15:
                adj.setdefault(a, set()).add(b)
    found = 0
    for src in nodes:
        for dst in nodes:
            want = ref_locks.bfs_path(adj, src, dst)
            assert san_locks.bfs_path(adj, src, dst) == want
            found += want is not None
    assert found > 0


def test_parse_modes_parity_on_the_reference_inputs():
    inputs = ["locks,loop", "locks", " loop ", "off", "0", None, "bogus", "",
              "none", "false", "OFF", "Locks, LOOP", "locks,,loop,extra"]
    for value in inputs:
        assert sanitize.parse_modes(value) == ref_sanitize.parse_modes(value), value


def test_render_report_parity_byte_for_byte():
    graph = sanitize.LockGraph()
    _drive(graph, _seeded_threads(0))
    ref_watch, port_watch = ref_sanitize.StallWatch(stall_ms=10.0), sanitize.StallWatch(stall_ms=10.0)
    for w in (ref_watch, port_watch):
        w._record(7, 1.5, "<callback a>", 42.125, '  File "x.py", line 3, in f\n    g()\n')
        w._record(8, 2.5, "<callback b>", 12.0, "", gc_ms=1.0)
    assert port_watch.stalls() == ref_watch.stalls()
    rep = {
        "modes": ["locks", "loop"],
        "lock_cycles": graph.cycles(),
        "long_holds": [{"site": "a.py:1", "held_ms": 300.25, "thread": "T-1",
                        "stack": "s"}],
        "loop_stalls": port_watch.stalls(),
    }
    assert rep["lock_cycles"]
    assert sanitize.render_report(rep) == ref_sanitize.render_report(rep)
    clean = {"modes": [], "lock_cycles": [], "long_holds": [], "loop_stalls": []}
    assert sanitize.render_report(clean) == ref_sanitize.render_report(clean)


# -- the guard ------------------------------------------------------------------


def test_importing_the_port_leaves_the_reference_sanitizer_in_place():
    """In the pytest process the conftest installed the reference's
    sanitizer (unless the suite runs with ``ORYX_SANITIZE=off``): importing
    the port, and asking it to install again, changes none of the patched
    primitives and leaves the port's modes unset, while the reference's
    wrappers keep wrapping the port's locks."""
    import importlib

    importlib.import_module("oryx_tpu_torch.tools.sanitize")
    importlib.import_module("oryx_tpu_torch")
    primitives = (threading.Lock, threading.RLock, asyncio.events.Handle._run)
    if ref_locks.installed():
        assert threading.Lock is ref_locks._lock_factory
        assert threading.RLock is ref_locks._rlock_factory
        # a port lock allocated here is the reference's wrapper, at the
        # port's site: the conftest's session gate covers it
        family = metrics.MetricsRegistry().counter("guard_total", "guard", ())
        assert type(family._lock) is ref_locks.SanLock
        assert family._lock._site == "common/metrics.py:282"
        assert san_locks.replaced_elsewhere()
        assert sanitize.install({"locks"}) == frozenset()
    else:
        assert threading.Lock is san_locks._REAL_LOCK
    if ref_loop.installed():
        assert asyncio.events.Handle._run.__module__ == "oryx_tpu.tools.sanitize.loop"
        assert san_loop.replaced_elsewhere()
        assert sanitize.install({"loop"}) == frozenset()
    else:
        assert asyncio.events.Handle._run.__module__ == "asyncio.events"
    if ref_locks.installed() and ref_loop.installed():
        assert sanitize.install_from_env() == frozenset()
    assert (threading.Lock, threading.RLock, asyncio.events.Handle._run) == primitives
    assert not sanitize.enabled() and not san_locks.installed() and not san_loop.installed()
    rep = sanitize.report()
    assert rep["lock_cycles"] == rep["long_holds"] == rep["loop_stalls"] == []
    assert oryx_tpu_torch.__version__ == "0.1.0"


def test_configure_sets_thresholds_while_not_installed(monkeypatch):
    monkeypatch.delenv("ORYX_SANITIZE_LOOP_STALL_MS", raising=False)
    monkeypatch.delenv("ORYX_SANITIZE_LONG_HOLD_MS", raising=False)
    assert not sanitize.enabled()
    overlay = cfg.Config.parse_string(
        "oryx = { sanitize = { loop-stall-ms = 333, long-hold-ms = 444 } }")
    old_stall, old_hold = san_loop._stall_ms, san_locks.graph().long_hold_ms
    ref_stall, ref_hold = ref_loop._stall_ms, ref_locks.graph().long_hold_ms
    try:
        sanitize.configure(overlay.overlay_on(cfg.get_default()))
        assert san_loop._stall_ms == 333.0 and san_locks.graph().long_hold_ms == 444.0
        # the reference's thresholds (the session gate's) are its own
        assert (ref_loop._stall_ms, ref_locks.graph().long_hold_ms) == (ref_stall, ref_hold)
    finally:
        san_loop.set_stall_ms(old_stall)
        san_locks.graph().long_hold_ms = old_hold


# another sanitizer's threading.Lock, in place before the port is imported
_FOREIGN_LOCK = (
    "import _thread, runpy, sys, threading\n"
    "def foreign_lock():\n"
    "    return _thread.allocate_lock()\n"
    "threading.Lock = foreign_lock\n"
    "sys.argv = [sys.argv[1], 'guard']\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
)


@pytest.mark.parametrize("variant,env,code,want", [
    ("on", None, None,
     {"modes": ["locks", "loop"], "lock": "port", "rlock": "port",
      "handle_run": "oryx_tpu_torch.tools.sanitize.loop", "lock_type": "SanLock"}),
    ("off", {"ORYX_SANITIZE": "off"}, None,
     {"modes": [], "lock": "stdlib", "rlock": "stdlib", "handle_run": "asyncio.events",
      "lock_type": "lock"}),
    ("foreign_lock", None, _FOREIGN_LOCK,
     {"modes": ["loop"], "lock": "other", "rlock": "stdlib",
      "handle_run": "oryx_tpu_torch.tools.sanitize.loop", "lock_type": "lock"}),
])
def test_a_port_child_installs_the_port_sanitizer(variant, env, code, want):
    if code is None:
        out, _ = _child("guard", env=env)
    else:
        out, _ = _child(str(CHILD), env=env, code=code)
    assert out == want, variant


# -- overhead -------------------------------------------------------------------


def test_port_sanitizer_overhead_within_five_percent_of_smoke_call():
    """``tests/test_load_benchmark.py``'s gate on the port: bookkeeping
    events per batched ``top_n_batch`` call on the port's
    ``ALSServingModel`` (5,000 x 16, batch 128, on the CPU) x the isolated
    per-event cost (min of 3 probe windows) <= 5% of the mean call, in a
    child sanitized by the port."""
    out, _ = _child("overhead", "--device", "cpu", timeout=300)
    assert out["probe_lock_type"] == "SanLock"
    assert out["events_per_call"] > 0
    assert out["overhead"] <= 0.05, (
        f"sanitizer costs {out['overhead']:.2%} of a smoke call "
        f"({out['events_per_call']:.0f} events x {out['per_event_us']:.2f}µs "
        f"vs {out['mean_call_ms']:.2f}ms/call)")


# -- the smoke's sanitize phase and report parser ---------------------------------


def test_smoke_sanitize_phase_on_the_cpu():
    """``chip_smoke.sanitize_phase`` with its child's model on the CPU:
    the install, exactly one cycle and one stall with its live stack, and
    the overhead's figures."""
    import chip_smoke

    out = chip_smoke.sanitize_phase(device="cpu")
    assert out["overhead"]["device"] == "cpu"
    assert out["overhead"]["mean_call_ms"] > 0
    assert out["isolated"]["cycles"][0]["ring"][0].startswith("tests/torch_sanitize_child.py:")
    assert out["this_process_modes"] == []


def test_smoke_parses_a_rendered_report():
    import chip_smoke

    graph = sanitize.LockGraph()
    _drive(graph, _seeded_threads(1))
    watch = sanitize.StallWatch(stall_ms=10.0)
    watch._record(1, 1.0, "<bound method X.y of <X on loop>>", 300.5,
                  '  File "/r/a.py", line 3, in f\n    g()\n'
                  '  File "/r/b.py", line 9, in g\n    time.sleep(1)\n')
    watch._record(2, 2.0, "<callback b>", 260.0, "")
    rep = {"modes": ["locks", "loop"], "lock_cycles": graph.cycles(),
           "long_holds": [{"site": "a.py:1", "held_ms": 2.5, "thread": "T", "stack": ""},
                          {"site": "b.py:2", "held_ms": 7.5, "thread": "T", "stack": ""},
                          {"site": "a.py:1", "held_ms": 1.0, "thread": "U", "stack": ""}],
           "loop_stalls": watch.stalls()}
    text = "log line before\n" + sanitize.render_report(rep) + "\n"
    got = chip_smoke.sanitizer_report(text)
    assert got["report"] and got["modes"] == "locks,loop"
    assert [c["ring"] for c in got["cycles"]] == [
        " -> ".join(c["ring"]) for c in rep["lock_cycles"]]
    assert got["stalls"]["count"] == 2 and got["stalls"]["longest_ms"] == 300.5
    first = got["stalls"]["each"][0]
    assert first["callback"] == "<bound method X.y of <X on loop>>"
    assert first["blocked_at"] == 'File "/r/b.py", line 9, in g: time.sleep(1)'
    assert got["stalls"]["each"][1]["blocked_at"] == ""
    assert got["long_holds"] == {"count": 3, "longest_ms": 7.5, "longest_site": "b.py:2",
                                 "by_site": {"a.py:1": 2, "b.py:2": 1}}
    with pytest.raises(chip_smoke.SmokeFailure, match="lock-order cycles"):
        chip_smoke.sanitizer_summary({"p": got}, "parse")
    quiet = chip_smoke.sanitizer_report("nothing here\n")
    summary = chip_smoke.sanitizer_summary({"p": quiet}, "parse")
    assert summary["no_report"] == ["p"] and summary["no_long_holds"] == ["p"]
