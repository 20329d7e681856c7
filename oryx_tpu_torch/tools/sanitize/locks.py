"""Lock sanitizer: runtime lock-order graph + long-hold outliers.

The port of the JAX package's ``oryx_tpu/tools/sanitize/locks.py`` (stdlib
only), held to it by ``tests/test_torch_sanitize.py``. Two changes:

  * The real primitives are taken from ``_thread`` (``allocate_lock``,
    ``RLock``), never from ``threading``, whose names another sanitizer in
    the process may already have replaced.
  * :func:`install` refuses, and returns False, when ``threading.Lock`` or
    ``threading.RLock`` is no longer the standard library's: another
    sanitizer (the JAX package's, which the test suite installs first)
    already watches this process's locks.

Below, the reference's text.

The dynamic counterpart of the static ``lock-order-cycle`` checker: where
the static pass approximates acquisition order from resolvable call paths,
this records the REAL per-thread order every time two repo locks nest, and
reports ordering cycles (potential deadlocks: two threads interleaving the
observed orders hang) and long-hold outliers at process exit — the same
static+dynamic pairing TSan-style tooling uses, applied at the Python
layer.

Design constraints, in order:

  * **Only repo locks are instrumented.** ``threading.Lock``/``RLock``
    are patched process-wide, but the patched factory walks the allocation
    stack and returns a REAL (uninstrumented) lock unless some frame lives
    in this repo — jax/XLA/logging/aiohttp internals pay literally zero
    overhead, and the order graph never fills with third-party noise.
  * **Site-aggregated identity.** Locks are named by allocation site
    (``file.py:lineno``), so two store instances' ``_lock`` are one graph
    node — that is what makes an A→B / B→A interleaving across INSTANCES
    visible. The flip side: nesting two same-site locks would self-edge,
    which is skipped (RLock re-entry and sibling-instance nesting would
    otherwise false-positive).
  * **Cheap steady state.** Per acquire: one thread-local list append +
    one set lookup; the global mutex and the stack capture are only paid
    the first time a given (held-site, acquired-site) pair is seen on a
    thread that has not seen it. Suspension (the ``no_sanitize`` pytest
    marker) is one int read.

The wrapper types keep the full lock protocol, including the private
``_is_owned``/``_release_save``/``_acquire_restore`` hooks
``threading.Condition`` needs, so a ``Condition`` built on a sanitized
RLock keeps working — and a ``cond.wait()`` correctly RELEASES the lock in
the held-stack model, then re-acquires on wake.
"""

from __future__ import annotations

import threading
import time
import traceback
import _thread

#: The real primitives, from ``_thread`` (which nothing patches).
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock

#: Frames whose filename contains one of these are "ours": a lock allocated
#: with any such frame on the stack is instrumented. ``oryx_tpu`` matches
#: this package's ``oryx_tpu_torch`` paths too.
_REPO_MARKERS = ("oryx_tpu", "tests")

#: Suspension: > 0 disables REPORTING (edges, long holds). The held-stack
#: push/pop stays on — suspension is process-global, and an unbalanced
#: acquire/release across a suspended window would leave ghost held
#: entries that manufacture phantom edges later.
_suspend_depth = 0

#: Per-thread held stack, MODULE-level on purpose: it tracks the thread's
#: true lock state, which must stay balanced across graph swaps
#: (sanitize.isolated()) and suspension windows alike — only REPORTS
#: belong to a particular LockGraph.
_HELD = threading.local()


def _held_stack() -> list:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


def _site_of_allocation() -> "str | None":
    """file.py:lineno of the nearest repo frame on the allocation stack;
    None when no repo frame exists (third-party lock: do not instrument).
    The SANITIZER's own frames never count, and lock-HELPER frames
    (lockutils' AutoLock/AutoReadWriteLock constructors, which allocate on
    behalf of their caller) are skipped when a deeper repo frame exists —
    otherwise every AutoLock in the process would share one site and their
    nestings would all read as self-edges."""
    f = None
    helper_site = None
    try:
        import sys

        f = sys._getframe(2)
    except ValueError:
        return None
    while f is not None:
        fname = f.f_code.co_filename
        if "importlib" in fname and "_bootstrap" in fname:
            # the lock belongs to a module being IMPORTED (stdlib/third-
            # party globals like concurrent.futures' shutdown lock) — the
            # repo frame beyond the import machinery merely triggered the
            # import and must not claim the lock
            return helper_site
        if (
            fname.endswith("threading.py")
            and f.f_code.co_name == "__init__"
            and isinstance(f.f_locals.get("self"), threading.Thread)
        ):
            # thread-STARTUP machinery: the `_started` Event's condition
            # lock allocated inside Thread.__init__. It is per-instance,
            # never user-shared, and held only across Thread.start() — but
            # the repo frame that created the thread (a to_thread dispatch
            # spawning a lazy executor worker) would claim it, and SITE
            # aggregation across instances then fabricates order edges
            # between unrelated thread spawns (a phantom cycle the suite
            # gate trips on). Leave it a real lock. A repo Thread
            # SUBCLASS's own locks allocate in the subclass's __init__
            # frame, not threading.py's, and stay instrumented.
            return None
        if "/tools/sanitize/" not in fname and any(
            m in fname for m in _REPO_MARKERS
        ):
            site = f"{'/'.join(fname.rsplit('/', 2)[-2:])}:{f.f_lineno}"
            if fname.endswith("common/lockutils.py"):
                if helper_site is None:
                    helper_site = site
            else:
                return site
        f = f.f_back
    return helper_site


class LockGraph:
    """Observed lock-order edges + held stacks + long-hold outliers.

    The unit tests drive this directly (no patching): ``on_acquired`` /
    ``on_released`` with explicit sites, then ``cycles()``.
    """

    def __init__(self, long_hold_ms: float = 250.0, max_reports: int = 64):
        self._mu = _REAL_LOCK()
        self.long_hold_ms = float(long_hold_ms)
        self.max_reports = int(max_reports)
        # (held site, acquired site) -> {"count": n, "stack": str}
        self._edges: dict = {}
        self._long_holds: list = []
        self._tls = threading.local()
        # bookkeeping events since construction (the overhead gate reads it)
        self.events = 0

    # -- event intake --------------------------------------------------------
    def _seen_edges(self) -> set:
        seen = getattr(self._tls, "seen_edges", None)
        if seen is None:
            seen = self._tls.seen_edges = set()
        return seen

    def on_acquired(self, site: str, obj=None) -> None:
        # the held-stack push/pop is UNCONDITIONAL: suspension only gates
        # reporting. Skipping bookkeeping while suspended would leave ghost
        # held entries whenever a lock is acquired with recording on and
        # released inside a suspended window (suspension is process-global;
        # OTHER threads keep running during a no_sanitize test) — every
        # later acquisition on that thread would then edge from the ghost,
        # manufacturing phantom cycles. Same reason the stack lives at
        # module level: it must survive graph swaps intact.
        held = _held_stack()
        if _suspend_depth:
            held.append((site, obj, time.monotonic()))
            return
        self.events += 1
        if held:
            seen = self._seen_edges()
            acquired_at = None
            for held_site, _, _ in held:
                if held_site == site:
                    continue  # same-site nesting: re-entry/sibling instance
                edge = (held_site, site)
                if edge in seen:
                    continue
                seen.add(edge)
                if acquired_at is None:
                    acquired_at = "".join(
                        traceback.format_stack(limit=12)[:-2]
                    )
                with self._mu:
                    rec = self._edges.get(edge)
                    if rec is None:
                        self._edges[edge] = {"count": 1, "stack": acquired_at}
                    else:
                        rec["count"] += 1
        held.append((site, obj, time.monotonic()))

    def on_released(self, site: str, obj=None) -> None:
        held = _held_stack()
        if not _suspend_depth:
            self.events += 1
        for i in range(len(held) - 1, -1, -1):
            h_site, h_obj, t0 = held[i]
            if h_obj is obj and h_site == site:
                del held[i]
                held_ms = (time.monotonic() - t0) * 1000.0
                if held_ms >= self.long_hold_ms and not _suspend_depth:
                    with self._mu:
                        if len(self._long_holds) < self.max_reports:
                            self._long_holds.append({
                                "site": site,
                                "held_ms": round(held_ms, 3),
                                "thread": threading.current_thread().name,
                                "stack": "".join(
                                    traceback.format_stack(limit=8)[:-2]
                                ),
                            })
                return
        # acquired before install (or by a graph swap): nothing to pop

    # -- reports -------------------------------------------------------------
    def edges(self) -> dict:
        with self._mu:
            return dict(self._edges)

    def long_holds(self) -> list:
        with self._mu:
            return list(self._long_holds)

    def cycles(self) -> list:
        """Ordering cycles in the observed edge graph: each is a dict with
        the site ring and the recorded acquisition stacks of its edges —
        the two (or more) code paths whose interleaving deadlocks."""
        edges = self.edges()
        adj: dict = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)
        out = []
        seen_rings = set()
        for a, b in sorted(edges):
            back = bfs_path(adj, b, a)
            if back is None:
                continue
            ring = frozenset([a, b, *back])
            if ring in seen_rings:
                continue
            seen_rings.add(ring)
            chain = [a, b, *back, a]
            out.append({
                "ring": chain,
                "edges": [
                    {
                        "from": x,
                        "to": y,
                        "count": edges.get((x, y), {}).get("count", 0),
                        "stack": edges.get((x, y), {}).get("stack", ""),
                    }
                    for x, y in zip(chain, chain[1:])
                    if (x, y) in edges
                ],
            })
        return out

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._long_holds.clear()


def bfs_path(adj: dict, src: str, dst: str) -> "list | None":
    """Intermediate nodes of the shortest src->dst path ([] for a direct
    edge, None when unreachable). Shared with the static lock-order-cycle
    checker — one cycle-path algorithm, two callers."""
    from collections import deque

    q = deque([(src, [])])
    visited = {src}
    while q:
        node, trail = q.popleft()
        ntrail = trail + ([node] if node != src else [])
        for succ in adj.get(node, ()):
            if succ == dst:
                return ntrail
            if succ not in visited:
                visited.add(succ)
                q.append((succ, ntrail))
    return None


#: Process-wide graph the patched wrappers record into. Tests swap it via
#: sanitize.isolated() so deliberately deadlock-shaped fixtures never
#: pollute the session gate.
_GRAPH = LockGraph()


def graph() -> LockGraph:
    return _GRAPH


def _swap_graph(new: LockGraph) -> LockGraph:
    global _GRAPH
    old, _GRAPH = _GRAPH, new
    return old


class SanLock:
    """Instrumented ``threading.Lock`` (wrapper over the real primitive)."""

    __slots__ = ("_inner", "_site")

    def __init__(self, site: str):
        self._inner = _REAL_LOCK()
        self._site = site

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _GRAPH.on_acquired(self._site, self)
        return ok

    def release(self) -> None:
        _GRAPH.on_released(self._site, self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        self._inner._at_fork_reinit()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<SanLock {self._site} {self._inner!r}>"


class SanRLock:
    """Instrumented ``threading.RLock``, including the private Condition
    protocol (``Condition(RLock())`` keeps working sanitized, and a
    ``wait()`` correctly releases/re-acquires in the held model)."""

    __slots__ = ("_inner", "_site")

    def __init__(self, site: str):
        self._inner = _REAL_RLOCK()
        self._site = site

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _GRAPH.on_acquired(self._site, self)
        return ok

    def release(self) -> None:
        _GRAPH.on_released(self._site, self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- Condition protocol --------------------------------------------------
    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        _GRAPH.on_released(self._site, self)
        return self._inner._release_save()

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)
        _GRAPH.on_acquired(self._site, self)

    def _at_fork_reinit(self) -> None:
        self._inner._at_fork_reinit()

    def __repr__(self) -> str:
        return f"<SanRLock {self._site} {self._inner!r}>"


def _lock_factory():
    site = _site_of_allocation()
    if site is None:
        return _REAL_LOCK()
    return SanLock(site)


def _rlock_factory():
    site = _site_of_allocation()
    if site is None:
        return _REAL_RLOCK()
    return SanRLock(site)


_installed = False


def replaced_elsewhere() -> bool:
    """True when ``threading.Lock`` or ``threading.RLock`` is not the
    standard library's and not this module's: another sanitizer patched
    them first."""
    if _installed:
        return False
    return not (threading.Lock is _thread.allocate_lock
                and getattr(threading.RLock, "__module__", None) == "threading")


def install() -> bool:
    """Patch ``threading.Lock``/``RLock`` (and thereby the default lock of
    ``threading.Condition``) with the site-filtered factories. Idempotent;
    there is deliberately no uninstall — wrappers delegate to real
    primitives, so an installed process is simply a monitored process.
    Returns False, patching nothing, when another sanitizer got there
    first (:func:`replaced_elsewhere`)."""
    global _installed
    if _installed:
        return True
    if replaced_elsewhere():
        return False
    _installed = True
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    return True


def installed() -> bool:
    return _installed
