"""Explicit-state model-checking substrate for the transport protocols.

The port's copy of the JAX package's
``oryx_tpu/tools/analyze/protocol/machine.py`` (stdlib only): the same
explorer, visiting states in the same order, so state counts and
minimised schedules equal the reference's. Below, the reference's text.

Every exactly-once bug shipped so far hid in an *interleaving* — the
rebalance-hysteresis replay hole, the closing-consumer partition claim,
the idempotent-append lost-response double-write — exactly the failure
class the AST checkers cannot see: they reason about locks and dataflow
inside one process, not about protocol state spread across processes.
This module is the other half: tiny executable state machines
(:mod:`group_model`, :mod:`broker_model`, :mod:`ckpt_model`) explored
exhaustively over all interleavings up to a depth, with the safety
invariants of docs/robustness.md checked at every reached state.

Design, stdlib only:

* **States** are immutable hashable records (:class:`S`). Model code
  builds successor states functionally; the explorer dedups on state
  identity so revisited interleavings cost nothing.
* **Actions** are *whole-model* transition functions with stable names:
  ``fire(state)`` returns the successor state or ``None`` when disabled.
  Names double as schedule entries, so a counterexample is replayable
  byte-for-byte (tests/data/protocol_schedules/). Each action carries
  the ``file:line`` :class:`Site` annotations of the implementation code
  it models; the ``protocol-model-drift`` checker fails the build when
  those sites move out from under the model.
* **Exploration** is DFS with *sleep-set* partial-order reduction
  (Godefroid): after exploring action ``a`` from a state, every sibling
  branch puts ``a`` to sleep in any successor reached by an action
  independent of ``a`` — the commuted interleaving would reach a state
  the ``a``-first branch already covered. Independence is declared, not
  inferred: two actions commute iff their static variable footprints are
  disjoint (coarse, hence sound). Sleep sets combine with the visited
  table in the standard way: a state is re-expanded when reached with a
  sleep set no recorded visit subsumes.
* **Crash/restart budget**: ``kind="crash"``/``"restart"`` actions are
  rationed by the explorer (the budget is part of the search key), so
  depth buys interleavings instead of crash storms.
* **Bounded liveness**: at every search frontier the state is *drained*
  — progress actions applied in a fixed round-robin until fixpoint,
  modelling "crashes stop and the system runs fairly" — and the model's
  liveness predicate (every record eventually delivered) must hold at
  the fixpoint.
* **Counterexamples** are minimized by a plain BFS re-search (shortest
  violating schedule, deterministic under hash randomization because
  actions are tried in name order) and rendered as numbered schedules.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = [
    "S",
    "Site",
    "Action",
    "Model",
    "Violation",
    "ExploreResult",
    "ReplayResult",
    "explore",
    "shortest_counterexample",
    "replay",
    "render_schedule",
    "tuple_set",
]


# ---------------------------------------------------------------------------
# Immutable state records
# ---------------------------------------------------------------------------


class S:
    """Immutable, hashable record: ``S(a=1, b=(2, 3)).updated(a=4)``.

    Field values must themselves be hashable (ints, strings, tuples,
    frozensets, nested :class:`S`). Equality and hashing are structural,
    which is what makes the explorer's visited table collapse revisited
    interleavings.
    """

    __slots__ = ("_d", "_h")

    def __init__(self, **fields):
        self._d = fields
        self._h = None

    def updated(self, **fields) -> "S":
        d = dict(self._d)
        d.update(fields)
        return S(**d)

    def __getattr__(self, name):
        try:
            return self._d[name]
        except KeyError:
            raise AttributeError(name) from None

    def __eq__(self, other):
        return isinstance(other, S) and self._d == other._d

    def __hash__(self):
        if self._h is None:
            self._h = hash(tuple(sorted(self._d.items(), key=lambda kv: kv[0])))
        return self._h

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in sorted(self._d.items()))
        return f"S({inner})"


def tuple_set(tup: tuple, index: int, value) -> tuple:
    """Functional update of one slot of a tuple."""
    return tup[:index] + (value,) + tup[index + 1 :]


# ---------------------------------------------------------------------------
# Sites, actions, models
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Site:
    """``file:line`` annotation tying a model transition to the
    implementation code it abstracts. The ``protocol-model-drift``
    checker verifies the function still exists, that ``line`` still
    falls inside it, and that ``contains`` (when given) still appears in
    its body — so the model fails loudly when the implementation moves
    instead of silently verifying a fiction."""

    path: str  # repo-relative, '/'-separated
    qual: str  # dotted qualname within the module
    line: int  # line inside the function at the time of modelling
    contains: str = ""  # source fragment that must appear in the body

    def label(self) -> str:
        return f"{self.path}:{self.line} ({self.qual})"


@dataclass(frozen=True)
class Action:
    """One named transition of the whole model.

    ``fire(state)`` returns the successor or ``None`` when disabled.
    ``vars`` is the static full footprint (reads ∪ writes) and
    ``writes`` the written subset (defaults to ``vars``), used for the
    independence relation: two actions commute iff neither's writes
    intersect the other's footprint. Keep footprints conservative — a
    too-small one makes the reduction unsound, a too-large one only
    costs states. ``progress`` marks actions the liveness drain may
    take (adversarial faults and crashes are not progress)."""

    name: str
    fire: "callable"
    vars: frozenset
    kind: str = "step"  # "step" | "crash" | "restart" | "fault"
    progress: bool = True
    sites: tuple = ()
    writes: "frozenset | None" = None  # None -> same as vars

    def __repr__(self):
        return f"Action({self.name})"


class Model:
    """A named protocol model: initial state, static action table,
    safety invariants (state -> violation message | None) and a bounded
    liveness predicate checked at drained fixpoints."""

    def __init__(
        self,
        name: str,
        initial: S,
        actions: "tuple[Action, ...]",
        invariants: "tuple[tuple[str, callable], ...]",
        liveness: "tuple[str, callable] | None" = None,
        variant: str = "",
        canonicalize: "callable | None" = None,
    ):
        self.name = name
        self.variant = variant  # "" = HEAD semantics
        # symmetry reduction: a model may supply a canonicalize(state)
        # that maps behaviorally-identical states (e.g. uniformly
        # shifted epoch counters) to one representative. It is applied
        # after every action, so it must commute with every action —
        # actions may only COMPARE the values it rewrites, never branch
        # on their magnitude.
        self.canonicalize = canonicalize
        self.initial = canonicalize(initial) if canonicalize else initial
        self.actions = tuple(sorted(actions, key=lambda a: a.name))
        self.invariants = tuple(invariants)
        self.liveness = liveness
        names = [a.name for a in self.actions]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate action names in model {name}")
        self.by_name = {a.name: a for a in self.actions}

    def step(self, action: Action, state: S) -> "S | None":
        """Fire `action` from `state`, canonicalizing the successor."""
        nxt = action.fire(state)
        if nxt is not None and self.canonicalize is not None:
            nxt = self.canonicalize(nxt)
        return nxt

    @property
    def key(self) -> str:
        return f"{self.name}@{self.variant or 'HEAD'}"

    def sites(self) -> "list[Site]":
        out: list = []
        for a in self.actions:
            out.extend(a.sites)
        return out


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclass
class Violation:
    model: str
    variant: str
    invariant: str
    message: str
    schedule: "tuple[str, ...]"
    minimized: bool = False


@dataclass
class ExploreResult:
    model: str
    variant: str
    depth: int
    crash_budget: int
    states: int = 0
    transitions: int = 0
    elapsed: float = 0.0
    complete: bool = True  # False when the time budget cut the search
    violation: "Violation | None" = None

    @property
    def ok(self) -> bool:
        return self.violation is None


@dataclass
class ReplayResult:
    """``status``: "violation" | "blocked" | "clean". A schedule recorded
    against a buggy variant typically *blocks* at HEAD — the fixed guard
    disables the step the bug needed — which is exactly the evidence the
    regression fixture wants."""

    status: str
    step: int = 0  # 1-based index of the violating/blocked step
    action: str = ""
    violation: "Violation | None" = None


class _TimeBudgetExceeded(Exception):
    pass


# ---------------------------------------------------------------------------
# Exploration
# ---------------------------------------------------------------------------


def _check_invariants(model: Model, state: S) -> "tuple[str, str] | None":
    for name, fn in model.invariants:
        msg = fn(state)
        if msg:
            return name, msg
    return None


def _independence(model: Model) -> dict:
    """name -> set of independent action names: neither action's writes
    touch the other's footprint (two readers of a shared variable still
    commute)."""
    indep: dict = {a.name: set() for a in model.actions}
    for a in model.actions:
        wa = a.writes if a.writes is not None else a.vars
        for b in model.actions:
            if a.name == b.name:
                continue
            wb = b.writes if b.writes is not None else b.vars
            if not (wa & b.vars) and not (wb & a.vars):
                indep[a.name].add(b.name)
    return indep


def _drain(
    model: Model,
    state: S,
    cap: int = 400,
    memo: "dict | None" = None,
) -> "tuple[S, tuple[str, ...]]":
    """Deterministic fair completion: apply the first enabled *progress*
    action (name order) until fixpoint — "crashes stop, the system keeps
    running". Restart/TTL actions count as progress: recovery is part of
    the fair future, adversarial faults are not.

    ``memo`` maps state -> (fixpoint, suffix). The drain is
    deterministic, so every intermediate state shares the tail of the
    same drain — the whole path is memoized, which is what makes the
    per-frontier liveness check affordable (frontier states differ from
    each other by one step and their drains converge immediately)."""
    path: list = []
    trail: list = [state]
    for _ in range(cap):
        if memo is not None:
            hit = memo.get(state)
            if hit is not None:
                state, suffix = hit
                path.extend(suffix)
                break
        for a in model.actions:
            if not a.progress or a.kind in ("crash", "fault"):
                continue
            nxt = model.step(a, state)
            if nxt is not None and nxt != state:
                state = nxt
                path.append(a.name)
                trail.append(state)
                break
        else:
            break
    # cap hit without fixpoint: the liveness check judges the cap state
    if memo is not None:
        full = tuple(path)
        for i, st in enumerate(trail):
            if st not in memo:
                memo[st] = (state, full[i:])
    return state, tuple(path)


def explore(
    model: Model,
    *,
    depth: int,
    crash_budget: int = 2,
    time_budget: "float | None" = None,
    minimize: bool = True,
) -> ExploreResult:
    """DFS over interleavings with sleep-set reduction and a crash
    budget; safety invariants at every new state, bounded liveness at
    every frontier. Returns the first violation (minimized to a shortest
    schedule via BFS when ``minimize``) or a clean, complete result."""

    res = ExploreResult(
        model=model.name, variant=model.variant,
        depth=depth, crash_budget=crash_budget,
    )
    t0 = time.monotonic()
    deadline = t0 + time_budget if time_budget else None
    indep = _independence(model)
    visited: dict = {}  # (state, crashes_left) -> [frozenset(sleep), ...]
    drained: set = set()  # states already liveness-checked
    drain_memo: dict = {}  # state -> (fixpoint, suffix)
    found: list = []  # [Violation] when a violation is found

    def liveness_check(state: S, path: tuple) -> None:
        if model.liveness is None or state in drained:
            return
        drained.add(state)
        final, suffix = _drain(model, state, memo=drain_memo)
        name, fn = model.liveness
        msg = fn(final)
        if msg:
            found.append(Violation(
                model=model.name, variant=model.variant, invariant=name,
                message=msg, schedule=path + suffix,
            ))

    def dfs(state: S, crashes_left: int, sleep: frozenset, d: int, path: tuple):
        if found:
            return
        if deadline is not None and time.monotonic() > deadline:
            raise _TimeBudgetExceeded
        key = (state, crashes_left)
        recorded = visited.get(key)
        if recorded is not None:
            if any(r <= sleep for r in recorded):
                return
            recorded.append(sleep)
        else:
            visited[key] = [sleep]
            res.states += 1
            hit = _check_invariants(model, state)
            if hit:
                found.append(Violation(
                    model=model.name, variant=model.variant,
                    invariant=hit[0], message=hit[1], schedule=path,
                ))
                return
        succ = []
        for a in model.actions:
            if a.kind in ("crash", "restart") and crashes_left <= 0:
                continue
            nxt = model.step(a, state)
            if nxt is not None and nxt != state:
                succ.append((a, nxt))
        if d >= depth or not succ:
            liveness_check(state, path)
            return
        enabled = {a.name for a, _ in succ}
        cur_sleep = set(sleep & enabled)
        explored: set = set()
        for a, nxt in succ:
            if a.name in cur_sleep:
                continue
            res.transitions += 1
            spends = 1 if a.kind in ("crash", "restart") else 0
            child_sleep = frozenset(
                b for b in (cur_sleep | explored) if b in indep[a.name]
            )
            dfs(nxt, crashes_left - spends, child_sleep, d + 1, path + (a.name,))
            if found:
                return
            explored.add(a.name)

    try:
        dfs(model.initial, crash_budget, frozenset(), 0, ())
    except _TimeBudgetExceeded:
        res.complete = False
    res.elapsed = time.monotonic() - t0

    if found:
        v = found[0]
        if minimize and v.invariant != (model.liveness[0] if model.liveness else None):
            short = shortest_counterexample(
                model, invariant=v.invariant, depth=len(v.schedule),
                crash_budget=crash_budget,
                time_budget=(deadline - time.monotonic()) if deadline else None,
            )
            if short is not None:
                v = short
        res.violation = v
        res.complete = True
    return res


def shortest_counterexample(
    model: Model,
    *,
    invariant: str,
    depth: int,
    crash_budget: int = 2,
    time_budget: "float | None" = None,
) -> "Violation | None":
    """Shortest schedule violating ``invariant``, by plain BFS (no
    reduction — minimality matters more than speed here, and the DFS
    already bounded the length). Deterministic: actions tried in name
    order, so committed fixtures are stable across runs."""
    from collections import deque

    deadline = time.monotonic() + time_budget if time_budget else None
    inv = dict(model.invariants)[invariant]
    msg = inv(model.initial)
    if msg:
        return Violation(
            model=model.name, variant=model.variant, invariant=invariant,
            message=msg, schedule=(), minimized=True,
        )
    seen = {(model.initial, crash_budget)}
    queue = deque([(model.initial, crash_budget, ())])
    while queue:
        if deadline is not None and time.monotonic() > deadline:
            return None
        state, budget, path = queue.popleft()
        if len(path) >= depth:
            continue
        for a in model.actions:
            spends = 1 if a.kind in ("crash", "restart") else 0
            if spends and budget <= 0:
                continue
            nxt = model.step(a, state)
            if nxt is None or nxt == state:
                continue
            key = (nxt, budget - spends)
            if key in seen:
                continue
            seen.add(key)
            msg = inv(nxt)
            if msg:
                return Violation(
                    model=model.name, variant=model.variant,
                    invariant=invariant, message=msg,
                    schedule=path + (a.name,), minimized=True,
                )
            queue.append((nxt, budget - spends, path + (a.name,)))
    return None


# ---------------------------------------------------------------------------
# Replay and rendering
# ---------------------------------------------------------------------------


def replay(model: Model, schedule: "list[str] | tuple[str, ...]") -> ReplayResult:
    """Apply a recorded schedule action-by-action, checking every safety
    invariant after each step. Unknown action names are an error (the
    schedule drifted from the model); a *disabled* step merely blocks —
    at HEAD that is the fixed guard refusing the transition the bug
    needed."""
    state = model.initial
    hit = _check_invariants(model, state)
    if hit:
        return ReplayResult(
            status="violation", step=0, action="",
            violation=Violation(
                model=model.name, variant=model.variant, invariant=hit[0],
                message=hit[1], schedule=(),
            ),
        )
    for i, name in enumerate(schedule, start=1):
        try:
            action = model.by_name[name]
        except KeyError:
            raise KeyError(
                f"schedule step {i}: unknown action {name!r} in model "
                f"{model.key}"
            ) from None
        nxt = model.step(action, state)
        if nxt is None:
            return ReplayResult(status="blocked", step=i, action=name)
        state = nxt
        hit = _check_invariants(model, state)
        if hit:
            return ReplayResult(
                status="violation", step=i, action=name,
                violation=Violation(
                    model=model.name, variant=model.variant,
                    invariant=hit[0], message=hit[1],
                    schedule=tuple(schedule[:i]),
                ),
            )
    return ReplayResult(status="clean", step=len(tuple(schedule)))


def render_schedule(model: Model, violation: Violation) -> str:
    """A counterexample as a numbered schedule, each step annotated with
    the implementation site(s) its transition models."""
    lines = [
        f"counterexample · model={model.name} variant="
        f"{model.variant or 'HEAD'} invariant={violation.invariant}"
    ]
    for i, name in enumerate(violation.schedule, start=1):
        action = model.by_name.get(name)
        sites = ""
        if action is not None and action.sites:
            sites = "  [" + "; ".join(s.label() for s in action.sites) + "]"
        lines.append(f"  {i:2d}. {name}{sites}")
    lines.append(f"  => {violation.message}")
    return "\n".join(lines)
