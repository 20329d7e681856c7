"""Device-placement facts for the port's torch code.

The port of the device/host placement part of the JAX package's
``oryx_tpu/tools/analyze/dataflow.py`` (``is_device_producer``,
``device_returning``, ``transfer_of_call``, ``DeviceFlow``,
``async_reachable``), rewritten for torch and held to the reference's
host-device-transfer cases in their torch form by
``tests/test_torch_static_analysis.py``. Not ported: the shape and dtype
lattices, ``Poly``, the PartitionSpec parsing and ``cost_report``; they
belong to dtype-widening, replicated-collective and ``analyze --cost``,
which wait for their own slice (ROADMAP).

Device values are made by:

  * a ``torch.*`` call given ``device=`` (a factory, ``torch.as_tensor``,
    ``torch.tensor``) that does not name the CPU;
  * ``.to(<device>)`` and ``.cuda()``;
  * a ``torch.*`` call or a tensor method applied to a device value
    (``torch.topk(scores, k)``, ``scores.sum()``);
  * a project function that returns one of these.

Transfers (:func:`transfer_of_call`) are the calls that make the host wait
for the device, in three groups:

  * fetches, which the host-device-transfer checker reports when their
    operand is a device value: ``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``.to("cpu")``, ``float()`` / ``int()`` / ``bool()`` of a
    tensor, any top-level numpy entry point applied to one, and the ops
    whose result size depends on the data (``torch.nonzero``,
    ``torch.unique``, ``torch.masked_select``, ``torch.bincount``,
    ``torch.repeat_interleave``), which copy a count or a maximum back;
  * explicit waits, never reported (they are the sanctioned idiom, as
    ``jax.device_get`` is the reference's): ``torch.cuda.synchronize()``,
    ``<stream or event>.synchronize()`` and the port's one batched fetch,
    :func:`oryx_tpu_torch.common.device.to_host`;
  * uploads, never reported (the reference's checker does not report
    ``jax.device_put`` either), but classified, because a copy from
    pageable host memory makes the host wait too: a ``torch.*`` call that
    takes host data and ``device=``, and ``.to(<device>)`` / ``.cuda()``.

``.float()``, ``.half()``, ``.to(<dtype>)`` and the like are casts, not
transfers; ``.to(..., non_blocking=True)`` does not wait.

Everything here is stdlib-only and rides the memoized per-file scope caches
(:func:`core.scope_nodes`) and the shared project call graph.
"""

from __future__ import annotations

import ast

from oryx_tpu_torch.tools.analyze.core import (
    method_classes,
    module_map,
    scope_nodes,
)

# -- device / host placement -----------------------------------------------

#: Scalar-extraction transfers: each call is ONE blocking device→host sync.
SCALAR_TRANSFERS = {"float", "int", "bool"}
SCALAR_TRANSFER_METHODS = {"item", "tolist"}
#: Whole-tensor fetches to host memory.
HOST_COPY_METHODS = {"cpu", "numpy"}
#: Ops whose output size depends on the data: the host reads the count
#: back before it can allocate the result.
SYNC_OPS = {"nonzero", "unique", "unique_consecutive", "masked_select",
            "bincount", "repeat_interleave"}

#: The port's batched fetch (several tensors, one synchronisation): the
#: exempt idiom this checker pushes silent syncs toward.
TO_HOST = "oryx_tpu_torch.common.device.to_host"

#: Kinds :func:`transfer_of_call` classifies that the checker never
#: reports (explicit waits and uploads).
EXPLICIT_PREFIX = "wait:"
UPLOAD_PREFIX = "upload:"

_DTYPE_NAMES = {
    "float", "float16", "float32", "float64", "half", "double", "bfloat16",
    "int", "int8", "int16", "int32", "int64", "long", "short", "uint8",
    "bool", "complex64", "complex128",
}


def _keyword(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _names_cpu(fctx, node) -> bool:
    """True for a literal CPU device: ``"cpu"``, ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and fctx.resolve(node.func) == "torch.device":
        return bool(node.args) and _names_cpu(fctx, node.args[0])
    return False


def _to_target(fctx, call: ast.Call) -> "str | None":
    """What a ``.to(...)`` call moves to: ``"cpu"``, ``"device"``,
    ``"dtype"``, or None when the target cannot be told from the source
    (``.to(other_tensor)``)."""
    dev = _keyword(call, "device")
    if dev is not None:
        return "cpu" if _names_cpu(fctx, dev) else "device"
    if not call.args:
        return "dtype" if _keyword(call, "dtype") is not None else None
    arg = call.args[0]
    if _names_cpu(fctx, arg):
        return "cpu"
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return "device"
    if isinstance(arg, ast.Call) and fctx.resolve(arg.func) == "torch.device":
        return "device"
    resolved = fctx.resolve(arg) or ""
    if resolved.startswith("torch.") and resolved[6:] in _DTYPE_NAMES:
        return "dtype"
    parts = []
    node = arg
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    last = parts[0].lower() if parts else ""
    if "dtype" in last:
        return "dtype"
    if "device" in last or last in ("dev", "cuda"):
        return "device"
    return None


def _non_blocking(call: ast.Call) -> bool:
    v = _keyword(call, "non_blocking")
    return isinstance(v, ast.Constant) and v.value is True


def is_device_producer(fctx, call: ast.Call) -> bool:
    """A call whose result lives on the device whatever its operands:
    ``torch.*(..., device=<not cpu>)``, ``.to(<device>)``, ``.cuda()``."""
    func = call.func
    if isinstance(func, ast.Attribute):
        if func.attr == "cuda":
            return True
        if func.attr == "to" and _to_target(fctx, call) == "device":
            return True
    resolved = fctx.resolve(func)
    if resolved and resolved.startswith("torch."):
        dev = _keyword(call, "device")
        return dev is not None and not _names_cpu(fctx, dev)
    return False


def _is_torch_call(fctx, call: ast.Call) -> bool:
    resolved = fctx.resolve(call.func)
    return bool(resolved) and resolved.startswith("torch.")


def device_returning(project) -> set:
    """Keys ``(relpath, qualname)`` of project functions whose calls yield
    device tensors whatever their arguments: functions whose return
    expression is device-typed under :class:`DeviceFlow` (``return
    torch.zeros(n, device=dev)``, a local name assigned from a device
    value, a call of another such function), closed to a fixpoint over the
    project. Memoized on the project."""
    return _return_facts(project)[0]


def device_if_args(project) -> set:
    """Keys of project functions whose result is a device tensor when a
    device tensor is passed in (``def _lloyd_from(points, ...)`` computes
    on ``points`` and returns the result): their calls are device-typed
    when some argument is. The per-function summary that carries device
    values through the port's parameter-passing helpers, which the
    reference's jnp-producer model gets from ``jnp.*`` alone."""
    return _return_facts(project)[1]


def _return_facts(project) -> tuple:
    """(device_returning, device_if_args, class attrs): the three facts
    closed together to a fixpoint, each growing only. They are published
    on the project before the first pass, so every :class:`DeviceFlow`
    built during the closure reads the facts found so far."""
    cached = getattr(project, "_return_facts", None)
    if cached is not None:
        return cached
    returns = []
    methods_of = []
    for fctx in project.files:
        for qual, fn in fctx.functions:
            rets = [n for n in scope_nodes(fctx, fn)
                    if isinstance(n, ast.Return) and n.value is not None]
            if rets:
                returns.append(((fctx.relpath, qual), fctx, fn, rets))
        for _, cnode in fctx.classes:
            methods_of.append((fctx, cnode))
    uncond: set = set()
    cond: set = set()
    attrs: dict = {}
    project._return_facts = (uncond, cond, attrs)
    changed = True
    while changed:
        changed = False
        for key, fctx, fn, rets in returns:
            if key in uncond:
                continue
            flow = DeviceFlow(fctx, fn, project)
            if any(flow.expr_is_device(r.value, r.lineno) for r in rets):
                uncond.add(key)
                changed = True
                continue
            if key in cond:
                continue
            flow = DeviceFlow(fctx, fn, project, assume_params=True)
            if any(flow.expr_is_device(r.value, r.lineno) for r in rets):
                cond.add(key)
                changed = True
        for fctx, cnode in methods_of:
            found = _device_attrs(project, fctx, cnode)
            known = attrs.setdefault(cnode, set())
            if found - known:
                known |= found
                changed = True
    return project._return_facts


def _device_attrs(project, fctx, cnode) -> set:
    """``self.<attr>`` names of one class that some method assigns a device
    value, under the facts found so far."""
    out = set()
    for child in cnode.body:
        if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        flow = None
        for node in _flow_stmts(fctx, child):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)) or node.value is None:
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names = [t.attr for t in targets
                     if isinstance(t, ast.Attribute)
                     and isinstance(t.value, ast.Name) and t.value.id == "self"]
            if not names:
                continue
            if flow is None:
                flow = DeviceFlow(fctx, child, project)
            if flow._value_is_device(node.value, node.lineno):
                out.update(names)
    return out


def _flow_stmts(fctx, fn_node) -> list:
    """The assignments and loops of one function body in source order
    (memoized on the file context)."""
    cache = getattr(fctx, "_flow_stmts", None)
    if cache is None:
        cache = fctx._flow_stmts = {}
    got = cache.get(fn_node)
    if got is None:
        got = cache[fn_node] = sorted(
            (n for n in scope_nodes(fctx, fn_node)
             if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                               ast.For, ast.AsyncFor))),
            key=lambda n: n.lineno,
        )
    return got


def transfer_of_call(fctx, call: ast.Call) -> "str | None":
    """The kind of host-device transfer a call performs, or None. Kinds
    starting ``wait:`` (explicit waits, :data:`TO_HOST`) and ``upload:``
    (host data copied to the device) are classified but never reported;
    the others fetch their operand to the host."""
    func = call.func
    if isinstance(func, ast.Name) and func.id in SCALAR_TRANSFERS:
        if func.id not in fctx.import_map:
            return f"{func.id}()"
        return None
    resolved = fctx.resolve(func)
    mod, _, name = (resolved or "").rpartition(".")
    # any top-level numpy entry point fetches a device operand: the
    # conversions (np.asarray, np.array, np.stack, ...) and implicit op
    # mixing (np.dot, np.where, ...) alike
    if mod == "numpy" and name:
        return f"np.{name}()"
    if resolved == TO_HOST:
        return EXPLICIT_PREFIX + "to_host()"
    if resolved == "torch.cuda.synchronize":
        return EXPLICIT_PREFIX + "torch.cuda.synchronize()"
    if isinstance(func, ast.Attribute):
        attr = func.attr
        if attr in SCALAR_TRANSFER_METHODS and not call.args:
            return f".{attr}()"
        if attr in HOST_COPY_METHODS and not call.args:
            return f".{attr}()"
        if attr == "synchronize" and not call.args:
            return EXPLICIT_PREFIX + ".synchronize()"
        if attr in SYNC_OPS and mod != "torch":
            return f".{attr}()"
        if attr == "to" and not _non_blocking(call):
            target = _to_target(fctx, call)
            if target == "cpu":
                return ".to(cpu)"
            if target == "device":
                return UPLOAD_PREFIX + ".to(device)"
        if attr == "cuda" and not _non_blocking(call):
            return UPLOAD_PREFIX + ".cuda()"
    if mod == "torch" and name in SYNC_OPS:
        return f"torch.{name}()"
    if (mod == "torch" and call.args
            and _keyword(call, "device") is not None
            and not _names_cpu(fctx, _keyword(call, "device"))
            and name in ("tensor", "as_tensor", "asarray")):
        return UPLOAD_PREFIX + f"torch.{name}(device=)"
    return None


def is_reported_kind(kind: "str | None") -> bool:
    """A fetch the host-device-transfer checker reports (not an explicit
    wait, not an upload)."""
    return bool(kind) and not kind.startswith((EXPLICIT_PREFIX, UPLOAD_PREFIX))


def transfers_at(fctx, line: int) -> list:
    """``(call, kind)`` of the transfer calls at a source line, for matching
    a sync the device reported (a stack frame's line) to the recogniser:
    the calls that start on the line, else the calls whose span covers it."""
    calls = [n for n in ast.walk(fctx.tree) if isinstance(n, ast.Call)]
    starting = [c for c in calls if c.lineno == line]
    if not starting:
        starting = [c for c in calls
                    if c.lineno <= line <= (c.end_lineno or c.lineno)]
    out = []
    for c in starting:
        kind = transfer_of_call(fctx, c)
        if kind is not None:
            out.append((c, kind))
    return out


class LineStateEnv:
    """name -> ``[(line, state)]`` events in ascending line order, answering
    "what was this name's state just BEFORE line L"."""

    def __init__(self):
        self._events: dict = {}

    def record(self, name: str, line: int, state) -> None:
        self._events.setdefault(name, []).append((line, state))

    def state_before(self, name: str, line: int, default=None):
        """State of ``name`` just before ``line`` (a same-line assignment
        has not landed yet)."""
        state = default
        for ln, s in self._events.get(name, ()):
            if ln >= line:
                break
            state = s
        return state


class DeviceFlow:
    """Linear (source-ordered, flow-sensitive) device-placement pass over
    one function body: which local names hold device tensors BEFORE each
    line. A name reassigned from a host transfer (``vals =
    vals.cpu().numpy()``) leaves the device state from that line on, while
    the transfer call itself still sees the pre-assignment device value."""

    def __init__(self, fctx, fn_node, project, assume_params: bool = False):
        self.fctx = fctx
        self._dev_ret, self._dev_if, self._attrs = _return_facts(project)
        self._mod_of = module_map(project)
        self._cls = method_classes(fctx).get(fn_node)
        self._env = LineStateEnv()
        if assume_params:
            a = fn_node.args
            for arg in a.posonlyargs + a.args + a.kwonlyargs:
                if arg.arg not in ("self", "cls"):
                    self._env.record(arg.arg, fn_node.lineno, True)
        stmts = _flow_stmts(fctx, fn_node)
        for stmt in stmts:
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                # the loop target binds one ELEMENT of the iterable per
                # step: iterating a device tensor yields device scalars
                # (`for s in scores:` — the per-element sync shape), and a
                # host iterable rebinds/shadows any earlier device name
                dev = self.expr_is_device(stmt.iter, stmt.lineno)
                for n in ast.walk(stmt.target):
                    if isinstance(n, ast.Name):
                        self._env.record(n.id, stmt.lineno, dev)
                continue
            value = stmt.value
            if value is None:
                continue
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            dev = self._value_is_device(value, stmt.lineno)
            if isinstance(stmt, ast.AugAssign):
                # `acc += 1` combines the RHS with acc's PRIOR state: a
                # host-scalar increment must not downgrade a device name
                # and hide every later sync on it
                dev = dev or self.expr_is_device(stmt.target, stmt.lineno)
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        self._env.record(n.id, stmt.lineno, dev)

    def name_is_device(self, name: str, line: int) -> bool:
        return bool(self._env.state_before(name, line, False))

    def _value_is_device(self, node, line: int) -> bool:
        if isinstance(node, ast.Call):
            kind = transfer_of_call(self.fctx, node)
            if kind and not kind.startswith(UPLOAD_PREFIX):
                return False  # a fetch or a wait yields HOST data
        return self.expr_is_device(node, line)

    def call_returns_device(self, call: ast.Call, line: "int | None" = None) -> bool:
        """Device-ness of a call result: device producers, a resolvable
        project function in the ``device_returning`` set, or one in the
        ``device_if_args`` set given a device argument."""
        if is_device_producer(self.fctx, call):
            return True
        key = self._callee_key(call)
        if key is None:
            return False
        if key in self._dev_ret:
            return True
        if key in self._dev_if and line is not None:
            args = [*call.args, *(k.value for k in call.keywords)]
            return any(self.expr_is_device(a, line) for a in args)
        return False

    def _callee_key(self, call: ast.Call) -> "tuple | None":
        resolved = self.fctx.resolve(call.func)
        if resolved and "." in resolved:
            mod, _, name = resolved.rpartition(".")
            target = self._mod_of.get(mod)
            if target is not None and name in target.functions_by_name:
                t = target.functions_by_name[name][0]
                return (target.relpath, target.qualname_of[t])
        func = call.func
        if isinstance(func, ast.Name):
            local = self.fctx.functions_by_name.get(func.id)
            if local:
                qual = min((self.fctx.qualname_of[n] for n in local),
                           key=lambda q: q.count("."))
                return (self.fctx.relpath, qual)
        if (self._cls is not None and isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name) and func.value.id == "self"):
            # self.method(): the method of the enclosing class
            for child in self._cls.body:
                if (isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and child.name == func.attr):
                    return (self.fctx.relpath, self.fctx.qualname_of[child])
        return None

    def attr_is_device(self, attr: str) -> bool:
        """``self.<attr>`` holds a device value somewhere in the class."""
        return self._cls is not None and attr in self._attrs.get(self._cls, ())

    def expr_is_device(self, node, line: int) -> bool:
        """Device-ness of an expression evaluated at ``line``."""
        if isinstance(node, ast.Name):
            return self.name_is_device(node.id, line)
        if isinstance(node, ast.Call):
            if self.call_returns_device(node, line):
                return True
            kind = transfer_of_call(self.fctx, node)
            if kind and not kind.startswith(UPLOAD_PREFIX):
                return False  # .item()/.cpu()/.tolist() results are host
            if _is_torch_call(self.fctx, node):
                return any(self.expr_is_device(a, line) for a in node.args)
            if isinstance(node.func, ast.Attribute):
                return self.expr_is_device(node.func.value, line)
            return False
        if isinstance(node, ast.BinOp):
            return (self.expr_is_device(node.left, line)
                    or self.expr_is_device(node.right, line))
        if isinstance(node, ast.Subscript):
            return self.expr_is_device(node.value, line)
        if isinstance(node, ast.Attribute):
            if node.attr in ("shape", "dtype", "ndim", "device",
                             "is_cuda", "layout"):
                return False  # metadata reads never transfer
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return self.attr_is_device(node.attr)
            return self.expr_is_device(node.value, line)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.expr_is_device(e, line) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return (self.expr_is_device(node.body, line)
                    or self.expr_is_device(node.orelse, line))
        return False


def async_reachable(project) -> set:
    """Keys of every function reachable FROM an ``async def`` over the call
    graph — the functions whose synchronous work runs on the event loop.
    Callables handed to ``to_thread``/``run_in_executor`` are references,
    not calls, so the sanctioned executor hop naturally stays outside this
    set. Memoized on the project."""
    cached = getattr(project, "_async_reachable", None)
    if cached is not None:
        return cached
    graph = project.call_graph()
    seen = set(graph.async_keys)
    stack = list(seen)
    while stack:
        key = stack.pop()
        for _, callee, _ in graph.edges.get(key, ()):
            if callee not in seen:
                seen.add(callee)
                stack.append(callee)
    project._async_reachable = seen
    return seen
