"""Whole-program concurrency analysis: the generational upgrade of
``lock-discipline`` from per-class heuristics to project-wide flow.

The port of the JAX package's
``oryx_tpu/tools/analyze/checkers/concurrency.py`` (same three ids, the
same lock-region analysis and messages). Changes: the lock classes are
``oryx_tpu_torch.common.lockutils``'s, and ``bfs_path`` comes from the
port's sanitizer (``oryx_tpu_torch/tools/sanitize/locks.py``). Below, the
reference's text.

Three checkers share one per-function lock-region analysis plus the
project call graph (``core.CallGraph``, built once per run):

  * ``lock-order-cycle`` — an interprocedural lock-acquisition-order graph:
    every ``with self._lock`` / ``.acquire()`` region contributes
    held-lock → acquired-lock edges, held-lock sets propagate through
    resolvable calls, and a cycle in the resulting graph is a potential
    deadlock (two threads can interleave the two acquisition paths). The
    finding carries BOTH paths.
  * ``blocking-under-lock`` — any ``await``, ``asyncio.to_thread``,
    ``run_in_executor``, raw-socket I/O, ``subprocess.*`` or ``time.sleep``
    reachable while a ``threading`` lock is held, plus the probe-spin shape:
    a ``while True`` loop with no ``break``/``return``/``raise`` under a
    lock (the tombstone-probe bug — an infinite spin that wedges every
    other thread on the lock). Locks serialize; anything slow or unbounded
    inside one is a convoy (and, on the event loop, a p99 regression).
  * ``shared-state-escape`` — instance attributes written from BOTH a
    thread-context method (a ``threading.Thread`` subclass's ``run``, or a
    method handed to ``Thread(target=...)`` / ``to_thread`` /
    ``run_in_executor``, plus methods those call) and an event-loop-context
    method (``async def``, plus sync methods they call), with no common
    guarding lock across the writes — the cross-context race
    ``lock-discipline``'s single-class view cannot see.

Lock identity is structural: ``self.<attr>`` attributes assigned a
``threading``/``lockutils`` lock constructor (or named ``*lock*``, unless
assigned an ``asyncio`` primitive — holding an asyncio lock across an
``await`` is the POINT of asyncio locks) own per-class nodes; module-level
``_x_lock = threading.Lock()`` globals own per-module nodes. Self-edges
(RLock re-entry, two instances from one allocation site) are never
reported. The runtime counterpart of the order graph is the lock sanitizer
(``oryx_tpu_torch/tools/sanitize``, ``ORYX_SANITIZE=locks``), which observes the
REAL acquisition orders the static pass can only approximate.
"""

from __future__ import annotations

import ast

from oryx_tpu_torch.tools.analyze.core import scope_nodes
# the sanitizer's cycle-path BFS is the same algorithm this checker needs
# (both packages are stdlib-only; one implementation, two callers)
from oryx_tpu_torch.tools.sanitize.locks import bfs_path

ORDER_ID = "lock-order-cycle"
BLOCKING_ID = "blocking-under-lock"
ESCAPE_ID = "shared-state-escape"

_LOCK_CTORS = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
    "oryx_tpu_torch.common.lockutils.AutoLock",
    "oryx_tpu_torch.common.lockutils.AutoReadWriteLock",
}

#: asyncio primitives are NOT thread locks: holding one across an await is
#: their design, and they never block a thread — a ``*lock*``-named attr
#: assigned one of these must not create a lock node.
_ASYNC_CTORS = {
    "asyncio.Lock",
    "asyncio.Condition",
    "asyncio.Semaphore",
    "asyncio.Event",
}

#: Calls that block (or hop to) another thread of control — forbidden while
#: a threading lock is held. File I/O is deliberately absent: serializing
#: file access IS what broker locks are for.
_BLOCKING_RESOLVED = {
    "time.sleep": "`time.sleep` sleeps with the lock held",
    "asyncio.to_thread": "`asyncio.to_thread` hops to an executor with the "
                         "lock held",
    "socket.create_connection": "`socket.create_connection` does network "
                                "I/O with the lock held",
    "subprocess.run": "`subprocess.run` blocks with the lock held",
    "subprocess.call": "`subprocess.call` blocks with the lock held",
    "subprocess.check_call": "`subprocess.check_call` blocks with the lock "
                             "held",
    "subprocess.check_output": "`subprocess.check_output` blocks with the "
                               "lock held",
}

#: Attribute calls that block regardless of how the receiver is spelled.
_BLOCKING_ATTRS = {
    "run_in_executor": "`run_in_executor` schedules executor work with the "
                       "lock held (the hop's completion needs another "
                       "thread; awaiting it parks the loop with the lock)",
}

#: Socket methods that block when the receiver is named like a socket.
_SOCKET_METHODS = {"connect", "recv", "sendall"}


def _recv_parts(node: ast.AST) -> list:
    """Identifier parts of an attribute/name chain, innermost-first."""
    out = []
    while isinstance(node, ast.Attribute):
        out.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        out.append(node.id)
    return out


def _fmt_lock(node: tuple) -> str:
    """Human name of a lock node: ``Store._lock`` / ``netbroker._defaults_lock``."""
    return node[2]


class _ClassFacts:
    """Lock attributes + method ownership for one class."""

    __slots__ = ("qual", "node", "lock_attrs", "async_attrs", "methods")

    def __init__(self, qual, cnode, lock_attrs, async_attrs):
        self.qual = qual
        self.node = cnode
        self.lock_attrs = lock_attrs  # attr name -> lock node tuple
        self.async_attrs = async_attrs  # attrs holding asyncio primitives
        self.methods = {
            child.name: child
            for child in cnode.body
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
        }


def _class_lock_attrs(fctx, cqual, cnode) -> "tuple[dict, set]":
    """(attr name -> lock node, asyncio-primitive attrs) for locks this
    class owns. Constructor-based (threading/lockutils ctors) plus
    ``*lock*``-named attrs, EXCLUDING anything assigned an asyncio
    primitive (holding those across awaits is their design)."""
    out: dict = {}
    async_attrs: set = set()
    for child in cnode.body:
        if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in scope_nodes(fctx, child):
            if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
                continue
            ctor = fctx.resolve(node.value.func)
            for t in node.targets:
                if not (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    continue
                if ctor in _ASYNC_CTORS:
                    async_attrs.add(t.attr)
                elif ctor in _LOCK_CTORS or "lock" in t.attr.lower():
                    out[t.attr] = ("C", fctx.relpath, f"{cqual}.{t.attr}")
    for attr in async_attrs:
        out.pop(attr, None)
    return out, async_attrs


def _module_locks(fctx) -> dict:
    """name -> lock node for module-global ``_x = threading.Lock()``."""
    out: dict = {}
    for stmt in fctx.tree.body:
        if not (isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call)):
            continue
        ctor = fctx.resolve(stmt.value.func)
        if ctor not in _LOCK_CTORS:
            continue
        for t in stmt.targets:
            if isinstance(t, ast.Name):
                mod = fctx.relpath.rsplit("/", 1)[-1]
                out[t.id] = ("M", fctx.relpath, f"{mod}:{t.id}")
    return out


def _is_unbounded_loop(while_node: ast.While) -> bool:
    """``while True`` (or constant-truthy) with no break/return/raise —
    and no yield: a generator loop suspends at every iteration, handing
    control back to the consumer — anywhere in its body: structurally
    unable to terminate or relinquish the thread."""
    test = while_node.test
    if not (isinstance(test, ast.Constant) and bool(test.value)):
        return False
    stack = list(while_node.body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(n, (ast.Break, ast.Return, ast.Raise, ast.Yield,
                          ast.YieldFrom)):
            return False
        stack.extend(ast.iter_child_nodes(n))
    return True


class _FnLockFacts:
    """Everything the three checkers need from one function body."""

    __slots__ = ("acquisitions", "order_edges", "events", "held_at_line",
                 "blocking_fact", "attr_accesses")

    def __init__(self):
        # [(lock node, line)] — every direct acquisition (any held state)
        self.acquisitions = []
        # [(held node, held line, acquired node, line)] — nested acquisitions
        self.order_edges = []
        # [(line, cause, held node, held line)] — blocking while held
        self.events = []
        # call-site line -> tuple of held (node, line): for interprocedural
        # propagation against the shared call-graph edges
        self.held_at_line = {}
        # (line, cause) | None — first direct blocking call, held or not
        # (feeds the transitive blocks() fact)
        self.blocking_fact = None
        # [(attr, line, is_write, frozenset of held lock-node tuples)]
        self.attr_accesses = []


class _FnVisitor:
    """One pass over a function body threading the held-lock list through
    statement sequence, ``with`` nesting, and branch bodies."""

    def __init__(self, fctx, cfacts: "_ClassFacts | None", module_locks: dict):
        self.fctx = fctx
        self.cfacts = cfacts
        self.module_locks = module_locks
        self.facts = _FnLockFacts()

    # -- lock resolution ----------------------------------------------------
    def lock_of(self, expr: ast.AST) -> "tuple | None":
        """Lock node acquired by a with-item / acquire receiver: strips
        call layers (``self._lock.read()``), then matches ``self.<attr>``
        chains against the class's lock attrs and bare names against the
        module's lock globals."""
        e = expr
        while isinstance(e, ast.Call):
            e = e.func
        parts = []
        while isinstance(e, ast.Attribute):
            parts.append(e.attr)
            e = e.value
        if not isinstance(e, ast.Name):
            return None
        if e.id == "self" and self.cfacts is not None:
            for p in parts:
                node = self.cfacts.lock_attrs.get(p)
                if node is not None:
                    return node
            return None
        if e.id in self.module_locks:
            # bare name or used through a handle: _rw_lock.read()
            return self.module_locks[e.id]
        return None

    def anon_lock_of(self, expr: ast.AST) -> "tuple | None":
        """A lock-ish expression that resolves to NO class/module node (a
        lock on ANOTHER object, a lock parameter): tracked as an anonymous
        node so blocking-under-lock still sees the held region, but kept
        out of the order graph — textual identity across call sites is not
        sound enough to call two anonymous mentions the same lock."""
        e = expr
        while isinstance(e, ast.Call):
            e = e.func
        parts = _recv_parts(e)
        if not parts or not any("lock" in p.lower() for p in parts):
            return None
        if self.cfacts is not None and set(parts) & self.cfacts.async_attrs:
            return None
        display = ast.unparse(e) if parts else "lock"
        return ("A", self.fctx.relpath, display)

    # -- events -------------------------------------------------------------
    def _on_acquire(self, node, line, held):
        self.facts.acquisitions.append((node, line))
        for h, hline in held:
            if h != node and h[0] != "A":
                self.facts.order_edges.append((h, hline, node, line))

    def _on_event(self, line, cause, held):
        h, hline = held[-1]
        self.facts.events.append((line, cause, h, hline))

    # -- walk ---------------------------------------------------------------
    def visit_function(self, fn) -> _FnLockFacts:
        self._visit_body(fn.body, [])
        return self.facts

    def _visit_body(self, stmts, held):
        held = list(held)  # branch-local acquires stay branch-local
        for stmt in stmts:
            self._visit_stmt(stmt, held)

    def _visit_stmt(self, stmt, held):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested scopes are separate functions
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in stmt.items:
                self._scan_expr(item.context_expr, held)
                # asyncio primitives never make lock nodes, so an
                # ``async with`` that reaches here is a thread lock used
                # from a coroutine — track it like any other region
                node = self.lock_of(item.context_expr)
                if node is not None:
                    self._on_acquire(node, stmt.lineno, held + acquired)
                    acquired.append((node, stmt.lineno))
                else:
                    anon = self.anon_lock_of(item.context_expr)
                    if anon is not None:
                        acquired.append((anon, stmt.lineno))
            self._visit_body(stmt.body, held + acquired)
            return
        if isinstance(stmt, ast.While):
            self._scan_expr(stmt.test, held)
            if _is_unbounded_loop(stmt):
                cause = ("`while True` loop with no break/return/raise can "
                         "spin forever")
                # a blocking FACT either way: a caller holding a lock around
                # a call into this spin is the tombstone-probe shape
                if self.facts.blocking_fact is None:
                    self.facts.blocking_fact = (stmt.lineno, cause)
                if held:
                    self._on_event(stmt.lineno, cause, held)
            self._visit_body(stmt.body, held)
            self._visit_body(stmt.orelse, held)
            return
        if isinstance(stmt, ast.If):
            self._scan_expr(stmt.test, held)
            self._visit_body(stmt.body, held)
            self._visit_body(stmt.orelse, held)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(stmt.iter, held)
            self._scan_expr(stmt.target, held)
            self._visit_body(stmt.body, held)
            self._visit_body(stmt.orelse, held)
            return
        if isinstance(stmt, ast.Try) or stmt.__class__.__name__ == "TryStar":
            self._visit_body(stmt.body, held)
            for handler in stmt.handlers:
                self._visit_body(handler.body, held)
            self._visit_body(stmt.orelse, held)
            # the finally body runs UNCONDITIONALLY in the same scope, so
            # its acquire/release effects flow into the statements after
            # the try — `lock.acquire(); try: ... finally: lock.release()`
            # must leave the lock un-held for the rest of the function
            # (branch bodies above keep their copies: their effects are
            # conditional)
            for s in stmt.finalbody:
                self._visit_stmt(s, held)
            return
        # simple statement: a bare acquire()/release() mutates the held list
        # for the REST of this body (the non-with acquisition style)
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            if isinstance(call.func, ast.Attribute):
                node = self.lock_of(call.func.value)
                if node is None and call.func.attr in ("acquire", "release"):
                    node = self.anon_lock_of(call.func.value)
                if node is not None and call.func.attr == "acquire":
                    for a in [*call.args, *[k.value for k in call.keywords]]:
                        self._scan_expr(a, held)
                    if node[0] != "A":
                        self._on_acquire(node, stmt.lineno, held)
                    held.append((node, stmt.lineno))
                    return
                if node is not None and call.func.attr == "release":
                    for i in range(len(held) - 1, -1, -1):
                        if held[i][0] == node:
                            del held[i]
                            break
                    return
        self._scan_expr(stmt, held)

    def _scan_expr(self, root, held):
        """Events inside one statement/expression: awaits, blocking calls,
        expression-position acquires, attribute accesses, call-site held
        sets. Does not descend into nested function/lambda bodies."""
        # guard identity for shared-state-escape: full lock-node tuples, so
        # class locks AND module-global locks both count as a common guard
        # (anonymous nodes excluded — textual identity is not sound)
        held_names = frozenset(h for h, _ in held if h[0] in ("C", "M"))
        stack = [root]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(n, ast.Await) and held:
                self._on_event(
                    n.lineno,
                    "`await` parks the coroutine with the lock held (every "
                    "other waiter convoys behind it)",
                    held,
                )
            elif isinstance(n, ast.Call):
                self._scan_call(n, held)
            elif (
                isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name)
                and n.value.id == "self"
                and self.cfacts is not None
                and n.attr not in self.cfacts.lock_attrs
                and n.attr not in self.cfacts.methods
            ):
                self.facts.attr_accesses.append((
                    n.attr, n.lineno,
                    isinstance(n.ctx, (ast.Store, ast.Del)), held_names,
                ))
            stack.extend(ast.iter_child_nodes(n))

    def _scan_call(self, n: ast.Call, held):
        if held:
            self.facts.held_at_line.setdefault(
                n.lineno, tuple(held)
            )
        cause = self._blocking_cause(n)
        if cause is not None:
            if self.facts.blocking_fact is None:
                self.facts.blocking_fact = (n.lineno, cause)
            if held:
                self._on_event(n.lineno, cause, held)
        if isinstance(n.func, ast.Attribute):
            if n.func.attr == "acquire":
                node = self.lock_of(n.func.value)
                if node is not None:
                    self._on_acquire(node, n.lineno, held)
            elif n.func.attr == "wait" and len(held) > 1:
                # cond.wait() releases ITS lock but keeps every outer one —
                # a wait under a second lock convoys that lock's waiters
                node = self.lock_of(n.func.value)
                if node is not None and any(h != node for h, _ in held):
                    outer = next((hl for hl in held if hl[0] != node), None)
                    if outer is not None and held[-1][0] == node:
                        self.facts.events.append((
                            n.lineno,
                            f"`{ast.unparse(n.func)}()` waits while "
                            f"`{_fmt_lock(outer[0])}` stays held",
                            outer[0], outer[1],
                        ))

    def _blocking_cause(self, n: ast.Call) -> "str | None":
        resolved = self.fctx.resolve(n.func)
        if resolved in _BLOCKING_RESOLVED:
            return _BLOCKING_RESOLVED[resolved]
        if isinstance(n.func, ast.Attribute):
            attr = n.func.attr
            if attr in _BLOCKING_ATTRS:
                return _BLOCKING_ATTRS[attr]
            if attr in _SOCKET_METHODS:
                recv = [s.lower() for s in _recv_parts(n.func.value)]
                if any("sock" in s for s in recv):
                    return (
                        f"`{ast.unparse(n.func)}()` does synchronous socket "
                        "I/O with the lock held"
                    )
        return None


class _ProjectConcurrency:
    """The shared whole-program pass: per-function lock facts + the
    interprocedural held-set/acquisition-set propagation, computed once and
    read by all three checkers (memoized on the ProjectContext)."""

    def __init__(self, project):
        self.project = project
        self.graph = project.call_graph()
        self.fn_facts: dict = {}       # key -> _FnLockFacts
        self.fn_cfacts: dict = {}      # key -> _ClassFacts | None
        self.class_facts: dict = {}    # (relpath, cqual) -> _ClassFacts
        # calls to these keys BUILD something instead of running the body
        # (async defs -> coroutine, generators -> generator object): their
        # acquisitions and blocking facts never execute at the call site
        self.deferred_keys: set = set(self.graph.async_keys)
        self._analyze_all()
        # acq*: key -> {lock node: (line, path string)}
        self.acq = self._propagate_acquisitions()
        # blocks*: key -> (line, cause), through sync calls only
        self.blocks = self._propagate_blocking()

    # -- per-function facts -------------------------------------------------
    def _analyze_all(self) -> None:
        for fctx in self.project.files:
            mlocks = _module_locks(fctx)
            for cqual, cnode in fctx.classes:
                lock_attrs, async_attrs = _class_lock_attrs(fctx, cqual, cnode)
                self.class_facts[(fctx.relpath, cqual)] = _ClassFacts(
                    cqual, cnode, lock_attrs, async_attrs
                )
            cls_of_method: dict = {}
            for (relpath, cqual), cf in self.class_facts.items():
                if relpath != fctx.relpath:
                    continue
                for m in cf.methods.values():
                    cls_of_method[m] = cf
            for qual, fn in fctx.functions:
                key = (fctx.relpath, qual)
                cfacts = cls_of_method.get(fn)
                visitor = _FnVisitor(fctx, cfacts, mlocks)
                self.fn_facts[key] = visitor.visit_function(fn)
                self.fn_cfacts[key] = cfacts
                if any(
                    isinstance(n, (ast.Yield, ast.YieldFrom))
                    for n in scope_nodes(fctx, fn)
                ):
                    self.deferred_keys.add(key)

    # -- interprocedural propagation ----------------------------------------
    def _propagate_acquisitions(self) -> dict:
        acq: dict = {}
        for key, facts in self.fn_facts.items():
            if facts.acquisitions:
                acq[key] = {}
                for node, line in facts.acquisitions:
                    if node not in acq[key]:
                        acq[key][node] = (
                            line,
                            f"`{key[1]}` acquires `{_fmt_lock(node)}` "
                            f"({key[0]}:{line})",
                        )
        changed = True
        while changed:
            changed = False
            for key, outs in self.graph.edges.items():
                for line, callee, label in outs:
                    # calling an async def or a generator only BUILDS a
                    # coroutine/generator — its acquisitions do not happen
                    # at the call site (the same rule _propagate_blocking
                    # applies); a lock held across the await that
                    # eventually runs a coroutine is already a
                    # blocking-under-lock finding
                    if callee in self.deferred_keys:
                        continue
                    sub = acq.get(callee)
                    if not sub:
                        continue
                    mine = acq.setdefault(key, {})
                    for node, (_, path) in sub.items():
                        if node not in mine:
                            mine[node] = (line, f"{label} ({key[0]}:{line}) -> {path}")
                            changed = True
        return acq

    def _propagate_blocking(self) -> dict:
        direct = {
            key: facts.blocking_fact
            for key, facts in self.fn_facts.items()
            if facts.blocking_fact is not None
        }
        # the shared closure over edges with deferred callees dropped: a
        # call to an async def / generator only builds the object — the
        # await (or iteration) that runs it is charged separately
        edges = {
            key: [e for e in outs if e[1] not in self.deferred_keys]
            for key, outs in self.graph.edges.items()
        }
        return self.graph.propagate(direct, edges=edges)


def _project_concurrency(project) -> _ProjectConcurrency:
    cached = getattr(project, "_concurrency_pass", None)
    if cached is None:
        cached = _ProjectConcurrency(project)
        project._concurrency_pass = cached
    return cached


# ---------------------------------------------------------------------------
# lock-order-cycle
# ---------------------------------------------------------------------------


class LockOrderCycleChecker:
    id = ORDER_ID

    def check(self, project) -> list:
        cp = _project_concurrency(project)
        # edge (a, b) -> (finding location, human path)
        edges: dict = {}

        def add_edge(a, b, where, path):
            if a != b and (a, b) not in edges:
                edges[(a, b)] = (where, path)

        for key, facts in cp.fn_facts.items():
            relpath, qual = key
            for h, hline, node, line in facts.order_edges:
                add_edge(
                    h, node, (relpath, line),
                    f"`{qual}` holds `{_fmt_lock(h)}` (line {hline}) and "
                    f"acquires `{_fmt_lock(node)}` ({relpath}:{line})",
                )
            # calls made with a lock held pull the callee's transitive
            # acquisition set into the order graph (async/generator callees
            # excluded: the call site only builds the object)
            for line, callee, label in cp.graph.edges.get(key, ()):
                held = facts.held_at_line.get(line)
                sub = cp.acq.get(callee)
                if not held or not sub or callee in cp.deferred_keys:
                    continue
                for node, (_, path) in sub.items():
                    for h, hline in held:
                        add_edge(
                            h, node, (relpath, line),
                            f"`{qual}` holds `{_fmt_lock(h)}` (line {hline}) "
                            f"and calls {label} ({relpath}:{line}) -> {path}",
                        )

        return self._report_cycles(project, edges)

    @staticmethod
    def _report_cycles(project, edges: dict) -> list:
        adj: dict = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        # shortest cycle through each edge; one finding per node set
        out = []
        seen_cycles = set()
        for (a, b), (where, path_ab) in sorted(
            edges.items(), key=lambda kv: (kv[1][0], str(kv[0]))
        ):
            back = bfs_path(adj, b, a)
            if back is None:
                continue
            cycle_nodes = frozenset([a, b, *back])
            if cycle_nodes in seen_cycles:
                continue
            seen_cycles.add(cycle_nodes)
            # render the return path b -> ... -> a edge by edge
            hops = [path_ab]
            chain = [b, *back, a]
            for x, y in zip(chain, chain[1:]):
                hop = edges.get((x, y))
                if hop is not None:
                    hops.append(hop[1])
            relpath, line = where
            fctx = project.by_relpath.get(relpath)
            names = " -> ".join(
                f"`{_fmt_lock(n)}`" for n in [a, b, *back, a]
            )
            message = (
                f"lock acquisition order cycle {names}: two threads "
                "interleaving these paths deadlock. Path A: "
                + "; Path B: ".join(hops)
            )
            symbol = "cycle:" + "<->".join(sorted(_fmt_lock(n) for n in cycle_nodes))
            if fctx is not None:
                out.append(fctx.finding(ORDER_ID, line, message, symbol=symbol))
        return out




# ---------------------------------------------------------------------------
# blocking-under-lock
# ---------------------------------------------------------------------------


class BlockingUnderLockChecker:
    id = BLOCKING_ID

    def check(self, project) -> list:
        cp = _project_concurrency(project)
        out = []
        for key, facts in cp.fn_facts.items():
            relpath, qual = key
            fctx = project.by_relpath.get(relpath)
            if fctx is None:
                continue
            reported_lines = set()
            for line, cause, h, hline in facts.events:
                if line in reported_lines:
                    continue
                reported_lines.add(line)
                out.append(fctx.finding(
                    BLOCKING_ID, line,
                    f"`{qual}` blocks while holding `{_fmt_lock(h)}` "
                    f"(acquired line {hline}): {cause} — shrink the lock "
                    "region or move the slow work outside it",
                    symbol=f"{qual}:{_fmt_lock(h)}",
                ))
            # transitive: a call made under a lock to a function that
            # (transitively) blocks
            for line, callee, label in cp.graph.edges.get(key, ()):
                held = facts.held_at_line.get(line)
                if not held or line in reported_lines:
                    continue
                sub = cp.blocks.get(callee)
                if sub is None or callee in cp.deferred_keys:
                    continue
                _, cause = sub
                h, hline = held[-1]
                reported_lines.add(line)
                out.append(fctx.finding(
                    BLOCKING_ID, line,
                    f"`{qual}` calls {label} while holding "
                    f"`{_fmt_lock(h)}` (acquired line {hline}), and it "
                    f"blocks: {cause} — shrink the lock region or move the "
                    "call outside it",
                    symbol=f"{qual}->{callee[1]}:{_fmt_lock(h)}",
                ))
        return out


# ---------------------------------------------------------------------------
# shared-state-escape
# ---------------------------------------------------------------------------

_ESCAPE_EXEMPT = {"__init__", "__post_init__", "__repr__", "__str__", "close"}


class SharedStateEscapeChecker:
    id = ESCAPE_ID

    def check(self, project) -> list:
        cp = _project_concurrency(project)
        out = []
        for (relpath, cqual), cf in sorted(cp.class_facts.items()):
            fctx = project.by_relpath.get(relpath)
            if fctx is None:
                continue
            thread_methods = self._thread_context_methods(fctx, cf)
            loop_methods = self._loop_context_methods(cf)
            # a method in BOTH contexts races with itself; classify it as
            # thread-context (the stricter report)
            loop_methods -= thread_methods
            if not thread_methods or not loop_methods:
                continue
            out.extend(self._check_class(
                fctx, relpath, cqual, cf, cp, thread_methods, loop_methods
            ))
        return out

    # -- context inference ---------------------------------------------------
    def _thread_context_methods(self, fctx, cf: _ClassFacts) -> set:
        """Methods with EVIDENCE of running on a thread: ``run`` of a
        ``threading.Thread`` subclass, methods handed to
        ``Thread(target=...)``/``to_thread``/``run_in_executor``, closed
        over ``self.method`` call edges."""
        roots: set = set()
        for base in cf.node.bases:
            if fctx.resolve(base) == "threading.Thread" and "run" in cf.methods:
                roots.add("run")
        for method in cf.methods.values():
            for node in scope_nodes(fctx, method):
                if not isinstance(node, ast.Call):
                    continue
                target_exprs = []
                resolved = fctx.resolve(node.func)
                if resolved == "threading.Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            target_exprs.append(kw.value)
                elif resolved == "asyncio.to_thread" and node.args:
                    target_exprs.append(node.args[0])
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "run_in_executor"
                    and len(node.args) >= 2
                ):
                    target_exprs.append(node.args[1])
                for te in target_exprs:
                    if (
                        isinstance(te, ast.Attribute)
                        and isinstance(te.value, ast.Name)
                        and te.value.id == "self"
                        and te.attr in cf.methods
                    ):
                        roots.add(te.attr)
        return self._close_over_self_calls(fctx, cf, roots)

    def _loop_context_methods(self, cf: _ClassFacts) -> set:
        roots = {
            name for name, m in cf.methods.items()
            if isinstance(m, ast.AsyncFunctionDef)
        }
        return self._close_over_self_calls(None, cf, roots)

    @staticmethod
    def _close_over_self_calls(fctx, cf: _ClassFacts, roots: set) -> set:
        result = set(roots)
        frontier = list(roots)
        while frontier:
            name = frontier.pop()
            method = cf.methods.get(name)
            if method is None:
                continue
            for node in ast.walk(method):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"
                    and node.func.attr in cf.methods
                    and node.func.attr not in result
                ):
                    result.add(node.func.attr)
                    frontier.append(node.func.attr)
        return result

    # -- the race check ------------------------------------------------------
    def _check_class(self, fctx, relpath, cqual, cf, cp,
                     thread_methods: set, loop_methods: set) -> list:
        # attr -> context -> [(method, line, held names frozenset)]
        writes: dict = {}
        for name, method in cf.methods.items():
            if name in _ESCAPE_EXEMPT:
                continue
            ctx = (
                "thread" if name in thread_methods
                else "loop" if name in loop_methods
                else None
            )
            if ctx is None:
                continue
            qual = fctx.qualname_of.get(method)
            facts = cp.fn_facts.get((relpath, qual))
            if facts is None:
                continue
            for attr, line, is_write, held in facts.attr_accesses:
                if not is_write:
                    continue
                writes.setdefault(attr, {}).setdefault(ctx, []).append(
                    (name, line, held)
                )
        out = []
        for attr in sorted(writes):
            per_ctx = writes[attr]
            if "thread" not in per_ctx or "loop" not in per_ctx:
                continue
            # a common lock across EVERY cross-context write makes it safe
            common = None
            for accesses in per_ctx.values():
                for _, _, held in accesses:
                    common = set(held) if common is None else common & held
            if common:
                continue
            t_m, t_line, _ = per_ctx["thread"][0]
            l_m, l_line, _ = per_ctx["loop"][0]
            out.append(fctx.finding(
                ESCAPE_ID, t_line,
                f"`self.{attr}` is written from thread context "
                f"`{cqual}.{t_m}` (line {t_line}) AND from event-loop "
                f"context `{cqual}.{l_m}` (line {l_line}) with no common "
                "guarding lock — cross-context writes race; guard both "
                "sides with one lock or confine the attribute to one "
                "context",
                symbol=f"{cqual}.{attr}",
            ))
        return out
