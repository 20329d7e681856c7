"""lock-discipline: attributes written under a lock but accessed without it.

The port of the JAX package's ``oryx_tpu/tools/analyze/checkers/locks.py``;
the one change is that the lock classes are
``oryx_tpu_torch.common.lockutils``'s. Below, the reference's text.

The framework's shared state (feature-vector stores, brokers, model
managers) is guarded by convention: ``with self._lock…`` around every access.
Convention decays — the race detector here is structural: within a class that
owns a lock (``threading.Lock``/``RLock``/``Condition``, ``AutoLock``,
``AutoReadWriteLock``, or any ``*lock*``-named attribute), an attribute that
is WRITTEN under a lock context in one method and READ OR WRITTEN outside any
lock context in another method is a finding. ``__init__`` (single-threaded
construction) and the guarded accesses themselves are exempt, so a class
whose every post-init access is guarded stays silent.
"""

from __future__ import annotations

import ast

from oryx_tpu_torch.tools.analyze.core import walk_scope

ID = "lock-discipline"

_LOCK_CTORS = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "threading.Semaphore",
    "oryx_tpu_torch.common.lockutils.AutoLock",
    "oryx_tpu_torch.common.lockutils.AutoReadWriteLock",
}

_EXEMPT_METHODS = {"__init__", "__repr__", "__str__", "__post_init__"}


class LockDisciplineChecker:
    id = ID

    def check(self, project) -> list:
        out = []
        for fctx in project.files:
            for cqual, cnode in fctx.classes:
                out.extend(self._check_class(fctx, cqual, cnode))
        return out

    # -- class facts ---------------------------------------------------------
    @staticmethod
    def _methods(cnode):
        for child in cnode.body:
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child

    def _lock_attrs(self, fctx, cnode) -> set:
        locks = set()
        for method in self._methods(cnode):
            for node in walk_scope(method):
                if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
                    continue
                ctor = fctx.resolve(node.value.func)
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        if ctor in _LOCK_CTORS or "lock" in t.attr.lower():
                            locks.add(t.attr)
        return locks

    @staticmethod
    def _with_guards(node: ast.With, locks: set) -> bool:
        """True when any with-item acquires one of the class's locks
        (``self._lock``, ``self._lock.read()``, ``self.rw.write()``…)."""
        for item in node.items:
            expr = item.context_expr
            while isinstance(expr, ast.Call):
                expr = expr.func
            parts = []
            while isinstance(expr, ast.Attribute):
                parts.append(expr.attr)
                expr = expr.value
            if isinstance(expr, ast.Name) and expr.id == "self" and (
                set(parts) & locks
            ):
                return True
        return False

    def _check_class(self, fctx, cqual, cnode) -> list:
        locks = self._lock_attrs(fctx, cnode)
        if not locks:
            return []
        method_names = {m.name for m in self._methods(cnode)}
        # attr -> {"guarded_writes": {(method, line)}, "unguarded": {(method, line, is_write)}}
        acc: dict[str, dict] = {}

        def visit(node, method, guarded):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                child_guarded = guarded or (
                    isinstance(child, ast.With) and self._with_guards(child, locks)
                )
                attr_node, is_write = None, False
                if (
                    isinstance(child, ast.Attribute)
                    and isinstance(child.value, ast.Name)
                    and child.value.id == "self"
                ):
                    attr_node = child
                    is_write = isinstance(child.ctx, (ast.Store, ast.Del))
                elif (
                    # container mutation: self.x[i] = v / self.x[i] += v
                    isinstance(child, ast.Subscript)
                    and isinstance(child.ctx, (ast.Store, ast.Del))
                    and isinstance(child.value, ast.Attribute)
                    and isinstance(child.value.value, ast.Name)
                    and child.value.value.id == "self"
                ):
                    attr_node = child.value
                    is_write = True
                if (
                    attr_node is not None
                    and attr_node.attr not in locks
                    and attr_node.attr not in method_names
                ):
                    rec = acc.setdefault(
                        attr_node.attr, {"guarded_writes": set(), "unguarded": set()}
                    )
                    if guarded:
                        if is_write:
                            rec["guarded_writes"].add((method, attr_node.lineno))
                    else:
                        rec["unguarded"].add((method, attr_node.lineno, is_write))
                visit(child, method, child_guarded)

        for method in self._methods(cnode):
            if method.name in _EXEMPT_METHODS:
                continue
            visit(method, method.name, False)

        out = []
        for attr in sorted(acc):
            rec = acc[attr]
            if not rec["guarded_writes"]:
                continue
            write_methods = {m for m, _ in rec["guarded_writes"]}
            reported = set()
            for method, line, is_write in sorted(rec["unguarded"], key=lambda t: t[1]):
                if method in reported:
                    continue
                if method in write_methods and not is_write:
                    # a read in the same method that also writes under the
                    # lock is usually the pre-check of a double-checked
                    # pattern; still racy, still reported
                    pass
                reported.add(method)
                w_method, w_line = sorted(rec["guarded_writes"], key=lambda t: t[1])[0]
                kind = "written" if is_write else "read"
                out.append(fctx.finding(
                    ID, line,
                    f"`self.{attr}` is written under a lock in "
                    f"`{cqual}.{w_method}` (line {w_line}) but {kind} without "
                    f"one in `{cqual}.{method}` — racy against concurrent "
                    "writers",
                    symbol=f"{cqual}.{attr}:{method}",
                ))
        return out
