"""blocking-async: event-loop stalls reachable from ``async def`` handlers.

The port of the JAX package's ``oryx_tpu/tools/analyze/checkers/blocking.py``
(same id, causes and messages), held to its tests by
``tests/test_torch_static_analysis.py``. Changes: the synchronous device
waits are torch's — ``torch.cuda.synchronize()``, ``<event>.synchronize()``
and ``<stream>.synchronize()`` take the place of ``jax.device_get`` and
``.block_until_ready()`` — and the lock classes are
``oryx_tpu_torch.common.lockutils``'s.

Below, the reference's text.

The serving tier is one asyncio loop; any synchronous sleep, file write,
device fetch, or lock acquisition inside a handler stalls EVERY in-flight
request — the p99-inflating bug class. Flagged when reachable from an
``async def``:

  * ``time.sleep``, ``subprocess.*``, builtin ``open()``, blocking ``os.*``
    file calls
  * ``torch.cuda.synchronize()`` / ``.synchronize()`` on an event or a
    stream (synchronous device waits)
  * lock acquisition: ``with <anything named *lock*>``, ``.acquire()``,
    ``AutoLock``/``AutoReadWriteLock`` handles
  * ``<*producer*>.send(...)`` — the topic producer's send does file I/O
    under the broker lock on ``file:`` brokers
  * raw socket I/O: ``socket.create_connection`` and
    ``<*sock*>.{connect,recv,sendall}`` — the tcp broker hazard class: the
    netbroker server/``cli broker`` event loop must reach sockets only
    through asyncio streams (or the sync client, which runs on threads)

Reachability is a project-wide call graph over resolvable calls (module
functions, ``from``-imports, ``module.fn``, ``self.method``), so a handler
calling a sync helper that blocks is flagged at the handler's call site.
Callables handed to ``run_in_executor`` (the sanctioned escape hatch) are
references, not calls, and naturally stay clean; nested defs/lambdas are
likewise only charged where they are actually invoked.
"""

from __future__ import annotations

import ast

from oryx_tpu_torch.tools.analyze.core import scope_nodes

ID = "blocking-async"

_BLOCKING_RESOLVED = {
    "time.sleep": "time.sleep() sleeps the whole event loop (use asyncio.sleep)",
    "subprocess.run": "subprocess.run blocks the event loop",
    "subprocess.call": "subprocess.call blocks the event loop",
    "subprocess.check_call": "subprocess.check_call blocks the event loop",
    "subprocess.check_output": "subprocess.check_output blocks the event loop",
    "torch.cuda.synchronize": "torch.cuda.synchronize() waits on the device",
    "socket.create_connection": "socket.create_connection blocks the event "
                                "loop (use asyncio.open_connection)",
}

#: Methods that block on a raw socket when the receiver is named like one.
_BLOCKING_SOCKET_METHODS = {"connect", "recv", "sendall"}

_BLOCKING_OS = {
    "open", "remove", "rename", "replace", "fsync", "makedirs", "listdir",
    "unlink", "scandir", "stat",
}

_LOCK_CTORS = {
    "oryx_tpu_torch.common.lockutils.AutoLock",
    "oryx_tpu_torch.common.lockutils.AutoReadWriteLock",
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
}


def _identifiers(node: ast.AST) -> list:
    """All identifier parts of a name/attribute/call chain, outermost last."""
    out = []
    while True:
        if isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Attribute):
            out.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Name):
            out.append(node.id)
            return out
        else:
            return out


class BlockingAsyncChecker:
    id = ID

    def check(self, project) -> list:
        # -- pass 1: per-function direct blocking facts over the SHARED
        # project call graph (built once per run, core.CallGraph) ----------
        graph = project.call_graph()
        edges = graph.edges
        async_keys = graph.async_keys

        facts = {}  # (relpath, qualname) -> (line, cause) | None
        for key, (fctx, fn) in graph.functions.items():
            facts[key] = self._direct_fact(fctx, fn)

        # -- pass 2: propagate blocking through the call graph --------------
        blocking = graph.propagate(
            {k: v for k, v in facts.items() if v is not None}
        )

        # -- report: async functions only -----------------------------------
        out = []
        for fctx in project.files:
            for qual, fn in fctx.functions:
                key = (fctx.relpath, qual)
                if key not in async_keys:
                    continue
                direct = facts.get(key)
                if direct is not None:
                    line, cause = direct
                    out.append(fctx.finding(
                        ID, line,
                        f"async `{qual}` blocks the event loop: {cause} "
                        "(await an async equivalent or run_in_executor)",
                        symbol=qual,
                    ))
                    continue
                for line, callee, label in edges[key]:
                    if callee in blocking and callee not in async_keys:
                        _, cause = blocking[callee]
                        out.append(fctx.finding(
                            ID, line,
                            f"async `{qual}` calls {label} which blocks the "
                            f"event loop ({cause}) — run it in an executor",
                            symbol=f"{qual}->{callee[1]}",
                        ))
                        break  # one finding per handler keeps the report readable
        return out

    # -- fact/edge extraction ------------------------------------------------
    def _direct_fact(self, fctx, fn):
        for node in scope_nodes(fctx, fn):
            if isinstance(node, ast.With):
                for item in node.items:
                    ids = [s.lower() for s in _identifiers(item.context_expr)]
                    ctor = (
                        fctx.resolve(item.context_expr.func)
                        if isinstance(item.context_expr, ast.Call)
                        else None
                    )
                    if ctor in _LOCK_CTORS or any("lock" in s for s in ids):
                        src = ast.unparse(item.context_expr)
                        return (node.lineno, f"`with {src}` acquires a thread lock")
            if not isinstance(node, ast.Call):
                continue
            resolved = fctx.resolve(node.func)
            if resolved in _BLOCKING_RESOLVED:
                return (node.lineno, _BLOCKING_RESOLVED[resolved])
            if resolved and resolved.startswith("os.") and resolved[3:] in _BLOCKING_OS:
                return (node.lineno, f"{resolved} does synchronous file I/O")
            if (
                isinstance(node.func, ast.Name)
                and node.func.id == "open"
                and "open" not in fctx.import_map
            ):
                return (node.lineno, "builtin open() does synchronous file I/O")
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                recv = _identifiers(node.func.value)
                recv_l = [s.lower() for s in recv]
                if attr == "acquire" and any("lock" in s for s in recv_l):
                    return (node.lineno, f"`{ast.unparse(node.func)}()` acquires a thread lock")
                if attr == "synchronize" and not node.args:
                    return (node.lineno,
                            f"`{ast.unparse(node.func)}()` waits on the device")
                if attr in _BLOCKING_SOCKET_METHODS and any(
                    "sock" in s for s in recv_l
                ):
                    return (
                        node.lineno,
                        f"`{ast.unparse(node.func)}()` does synchronous "
                        "socket I/O (use asyncio streams on the event loop)",
                    )
                if attr == "send" and any("producer" in s for s in recv_l):
                    return (
                        node.lineno,
                        f"`{ast.unparse(node.func)}()` — topic producer send does "
                        "file I/O under the broker lock on file: brokers",
                    )
        return None
