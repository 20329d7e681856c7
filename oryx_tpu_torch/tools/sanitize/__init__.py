"""Runtime concurrency sanitizer: lock-order + event-loop-stall detection.

The port of the JAX package's ``oryx_tpu/tools/sanitize/`` (stdlib only; it
imports nothing of that package), held to it by
``tests/test_torch_sanitize.py``. ``oryx_tpu_torch/__init__`` installs it
under ``ORYX_SANITIZE`` as the reference's package does, and every layer
entry point (``lambda_rt/layer.py``, ``serving/app.py``) calls
:func:`configure`. One change from the reference:

  * :func:`install` leaves a primitive alone when another sanitizer has
    already replaced it: ``threading.Lock``/``RLock`` that are not the
    standard library's (no ``locks`` mode), an ``asyncio.events.Handle._run``
    that is not asyncio's own (no ``loop`` mode). Such a mode stays unset,
    so :func:`enabled` says False for it and :func:`report` leaves it
    empty; :func:`configure` still sets the thresholds, as the reference's
    does when it is not installed. Under pytest the suite's conftest
    installs the JAX package's sanitizer first, which already wraps the
    port's locks (its site filter matches ``oryx_tpu_torch`` paths) and
    gates on them; importing this package there patches nothing, so the
    reference's wrappers, its session gate and its tests see what they
    check. A process that runs only the port (a CLI process, a child of a
    test, anything on the card) installs this one.

Below, the reference's text.

Opt-in via ``ORYX_SANITIZE=locks,loop`` (any oryx process — layers, the
CLI, tests — self-installs at ``oryx_tpu`` import when the variable is
set). Two modes, independently selectable:

  * ``locks`` — every ``threading.Lock``/``RLock`` allocated from repo code
    is wrapped to record the per-thread lock-order graph; ordering cycles
    (potential deadlocks, with the acquisition stacks of both paths) and
    long-hold outliers (> ``oryx.sanitize.long-hold-ms``) are reported at
    process exit. See :mod:`oryx_tpu_torch.tools.sanitize.locks`.
  * ``loop`` — an event-loop stall watchdog: any asyncio callback running
    longer than ``oryx.sanitize.loop-stall-ms`` gets its LIVE stack dumped
    by a sampling thread while the loop is still blocked. See
    :mod:`oryx_tpu_torch.tools.sanitize.loop`.

The pytest wiring in ``tests/conftest.py`` runs the whole tier-1 suite
sanitized (``ORYX_SANITIZE`` defaults on under pytest) and fails the
session on any cycle or stall, so every e2e/chaos/fleet test doubles as a
race harness; perf-floor tests opt out with ``@pytest.mark.no_sanitize``
(the suspension is one int read per lock op). Overhead is measured and
gated at <= 5% of a smoke-benchmark device call.

This package is stdlib-only and must stay import-light: it installs before
jax, aiohttp, or any oryx module creates its locks. Env knobs (read at
install, before any config file exists): ``ORYX_SANITIZE_LOOP_STALL_MS``,
``ORYX_SANITIZE_LONG_HOLD_MS``; the ``oryx.sanitize.*`` config keys apply
on ``configure()`` from every layer entry point. Runbook:
``docs/sanitizer.md``.
"""

from __future__ import annotations

import contextlib
import os

from oryx_tpu_torch.tools.sanitize import locks as _locks
from oryx_tpu_torch.tools.sanitize import loop as _loop

_modes: "frozenset[str]" = frozenset()
_report_at_exit_registered = False


def parse_modes(value: "str | None") -> "frozenset[str]":
    """``"locks,loop"`` -> modes; empty/"off"/"0"/"none" -> disabled."""
    if not value:
        return frozenset()
    if value.strip().lower() in ("off", "0", "none", "false"):
        return frozenset()
    return frozenset(
        m for m in (p.strip().lower() for p in value.split(","))
        if m in ("locks", "loop")
    )


def install(modes) -> "frozenset[str]":
    """Install the requested modes (idempotent; modes accumulate). Returns
    the active mode set. A mode whose primitive another sanitizer already
    replaced is left out (see the module docstring)."""
    global _modes
    modes = frozenset(modes) & {"locks", "loop"}
    took = set()
    if "locks" in modes and _locks.install():
        took.add("locks")
    if "loop" in modes and _loop.install():
        took.add("loop")
    _modes = _modes | took
    if _modes:
        _register_exit_report()
    return _modes


def install_from_env() -> "frozenset[str]":
    """Install per ``ORYX_SANITIZE`` (the opt-in used by
    ``oryx_tpu_torch/__init__``); applies the env threshold overrides first."""
    stall = os.environ.get("ORYX_SANITIZE_LOOP_STALL_MS")
    if stall:
        with contextlib.suppress(ValueError):
            _loop.set_stall_ms(float(stall))
    hold = os.environ.get("ORYX_SANITIZE_LONG_HOLD_MS")
    if hold:
        with contextlib.suppress(ValueError):
            _locks.graph().long_hold_ms = max(1.0, float(hold))
    return install(parse_modes(os.environ.get("ORYX_SANITIZE")))


def enabled(mode: "str | None" = None) -> bool:
    if mode is None:
        return bool(_modes)
    return mode in _modes


def modes() -> "frozenset[str]":
    return _modes


def configure(config) -> None:
    """Apply ``oryx.sanitize.*`` thresholds process-wide (the configure-at-
    entry idiom of metrics/resilience; called by every layer entry point).
    Cheap no-op work when the sanitizer is not installed — the keys stay
    read either way so config-key-drift holds them accountable."""
    stall_ms = config.get_float("oryx.sanitize.loop-stall-ms", 250.0)
    hold_ms = config.get_float("oryx.sanitize.long-hold-ms", 250.0)
    # env overrides (set before install, when no config file exists yet) win
    if not os.environ.get("ORYX_SANITIZE_LOOP_STALL_MS"):
        _loop.set_stall_ms(stall_ms)
    if not os.environ.get("ORYX_SANITIZE_LONG_HOLD_MS"):
        _locks.graph().long_hold_ms = max(1.0, float(hold_ms))


# -- suspension (the no_sanitize pytest marker) ------------------------------


def is_suspended() -> bool:
    return _locks._suspend_depth > 0


@contextlib.contextmanager
def suspended():
    """Disable all bookkeeping inside the block (wrappers still lock
    correctly; the loop patch passes straight through). Used by perf-floor
    tests via ``@pytest.mark.no_sanitize`` so floors stay honest."""
    _locks._suspend_depth += 1
    try:
        yield
    finally:
        _locks._suspend_depth -= 1


@contextlib.contextmanager
def isolated():
    """Swap in a FRESH lock graph + stall watch for the duration (restored
    after): the harness for tests that deliberately deadlock or stall —
    their reports must never reach the session gate, and the session's
    state must survive them. Yields (lock_graph, stall_watch)."""
    g = _locks.LockGraph(long_hold_ms=_locks.graph().long_hold_ms)
    w = _loop.StallWatch()
    old_g = _locks._swap_graph(g)
    old_w = _loop._swap_watch(w)
    try:
        yield g, w
    finally:
        _locks._swap_graph(old_g)
        _loop._swap_watch(old_w)


# -- reporting ---------------------------------------------------------------


def report() -> dict:
    """The current sanitizer report: lock-order cycles, long holds, loop
    stalls. Empty lists everywhere = a clean run (the tier-1 gate)."""
    return {
        "modes": sorted(_modes),
        "lock_cycles": _locks.graph().cycles() if "locks" in _modes else [],
        "long_holds": _locks.graph().long_holds() if "locks" in _modes else [],
        "loop_stalls": _loop.watch().stalls() if "loop" in _modes else [],
    }


def render_report(rep: "dict | None" = None) -> str:
    """Human-readable report (what the exit hook and the pytest gate
    print)."""
    rep = rep if rep is not None else report()
    lines = [f"oryx sanitizer report (modes: {','.join(rep['modes']) or '-'})"]
    for cyc in rep["lock_cycles"]:
        lines.append(f"LOCK-ORDER CYCLE: {' -> '.join(cyc['ring'])}")
        for e in cyc["edges"]:
            lines.append(f"  {e['from']} -> {e['to']} (seen {e['count']}x)")
            if e["stack"]:
                lines.append("    acquired at:")
                lines.extend(f"    {ln}" for ln in e["stack"].splitlines())
    for h in rep["long_holds"]:
        lines.append(
            f"LONG HOLD: {h['site']} held {h['held_ms']:.1f} ms "
            f"on {h['thread']}"
        )
    for s in rep["loop_stalls"]:
        lines.append(
            f"LOOP STALL: {s['stalled_ms']:.1f} ms in {s['callback']} "
            f"on {s['thread']}"
        )
        if s["stack"]:
            lines.append("  blocked at:")
            lines.extend(f"  {ln}" for ln in s["stack"].splitlines())
    if not (rep["lock_cycles"] or rep["long_holds"] or rep["loop_stalls"]):
        lines.append("clean: no cycles, no long holds, no loop stalls")
    return "\n".join(lines)


def _register_exit_report() -> None:
    """Print the report at interpreter exit when anything was found (the
    standalone-process story; pytest uses its own session gate)."""
    global _report_at_exit_registered
    if _report_at_exit_registered:
        return
    _report_at_exit_registered = True
    import atexit
    import sys

    def _dump():
        rep = report()
        if rep["lock_cycles"] or rep["long_holds"] or rep["loop_stalls"]:
            print(render_report(rep), file=sys.stderr)

    atexit.register(_dump)


# re-exported building blocks (unit tests + the pytest plugin)
LockGraph = _locks.LockGraph
StallWatch = _loop.StallWatch
lock_graph = _locks.graph
stall_watch = _loop.watch
run_watchdog = _loop.run_watchdog
