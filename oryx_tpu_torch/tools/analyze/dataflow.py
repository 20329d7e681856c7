"""Sharding-, dtype- and placement-aware dataflow facts for the port's
torch code.

The port of the JAX package's ``oryx_tpu/tools/analyze/dataflow.py``,
rewritten for torch and held to the reference's dataflow cases in their
torch form by ``tests/test_torch_static_analysis.py`` and
``tests/test_torch_dataflow_analysis.py``. It is the substrate of the
host-device-transfer, dtype-widening and replicated-collective checkers
and of the ``analyze --cost`` report:

  * **device placement** — which values live on the card (below);
  * **dtype lattice** — ``int8 ≤ bfloat16 (float16) ≤ float32 ≤ float64``
    with byte widths, read from ``dtype=torch.*``, ``.to(torch.*)`` and the
    cast methods (``.bfloat16()``, ``.half()``, ``.float()``, ...);
  * **abstract shapes** — tuples of dims, each a concrete int or a *shape
    symbol* (``"k"``, or a parameter-derived ``"y.d0"``), read from
    ``torch.zeros/ones/full/empty``, ``reshape``/``view``, ``.T`` and
    ``.shape`` unpacking;
  * **per-shard regions** — the port's counterpart of a ``shard_map``
    input spec'd ``P()``: a loop over a mesh's shards whose iterable zips
    the copies ``parallel.mesh.replicated(value, devices)`` (or
    ``ComputeContext.replicated``) makes, each copy fed to a per-shard call;
  * **cost polynomials** — FLOPs / HBM bytes / collective bytes as
    symbolic polynomials over shape symbols (:class:`Poly`), evaluable once
    bound (``analyze --cost --bind y.d0=1000000``).

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
    module_name,
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

    def final_states(self) -> dict:
        return {n: evs[-1][1] for n, evs in self._events.items() if evs}


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

    @property
    def device(self) -> set:
        """Final-state device names (closure-capture checks)."""
        return {n for n, dev in self._env.final_states().items() if dev}

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


# -- dtype lattice ----------------------------------------------------------

#: Promotion order of the port's device dtypes. Integer index tensors
#: (int32/int64) deliberately sit outside the lattice: they never carry
#: factor numerics, and flagging index widening would be pure noise.
#: float16 (``.half()``) ranks with bfloat16: a two-byte storage dtype.
DTYPE_RANK = {"int8": 0, "bfloat16": 1, "float16": 1, "float32": 2,
              "float64": 3}
DTYPE_BYTES = {"int8": 1, "bfloat16": 2, "float16": 2, "float32": 4,
               "float64": 8}
#: The deliberately-narrow storage dtypes whose silent widening defeats
#: their purpose (they exist to halve/quarter HBM traffic).
LOW_DTYPES = frozenset({"int8", "bfloat16", "float16"})

_DTYPE_ORIGINS = {
    "torch.int8": "int8", "numpy.int8": "int8",
    "torch.bfloat16": "bfloat16",
    "torch.float16": "float16", "torch.half": "float16",
    "numpy.float16": "float16",
    "torch.float32": "float32", "torch.float": "float32",
    "numpy.float32": "float32",
    "torch.float64": "float64", "torch.double": "float64",
    "numpy.float64": "float64",
}

#: Tensor methods that cast to one lattice dtype.
CAST_METHODS = {"bfloat16": "bfloat16", "half": "float16", "float": "float32",
                "double": "float64", "char": "int8"}


def dtype_of_node(fctx, node) -> "str | None":
    """Lattice dtype named by an AST expression (``torch.bfloat16``,
    ``"int8"``), or None when it is not a recognized literal dtype."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value in DTYPE_RANK else None
    resolved = fctx.resolve(node)
    return _DTYPE_ORIGINS.get(resolved or "")


def cast_dtype(fctx, call: ast.Call) -> "str | None":
    """The lattice dtype a cast call converts to: ``.to(torch.bfloat16)``,
    ``.to(dtype=...)``, ``.to(dev, torch.int8)``, ``.type(torch.float32)``,
    ``.bfloat16()`` / ``.half()`` / ``.float()`` / ``.double()`` /
    ``.char()``; None for anything else (a device move included)."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in CAST_METHODS and not call.args:
        return CAST_METHODS[func.attr]
    if func.attr in ("to", "type"):
        dt = _keyword(call, "dtype")
        if dt is not None:
            return dtype_of_node(fctx, dt)
        for arg in call.args:
            got = dtype_of_node(fctx, arg)
            if got is not None:
                return got
    return None


# -- cost polynomials -------------------------------------------------------


class Poly:
    """A polynomial over shape symbols: ``{(sym, ...): coeff}`` with ints
    folded into coefficients. Just enough algebra for static cost models —
    add, multiply, render (``2·N·k²``), and evaluate under bindings."""

    __slots__ = ("terms",)

    def __init__(self, terms: "dict | None" = None):
        self.terms = {k: v for k, v in (terms or {}).items() if v}

    @classmethod
    def const(cls, value: float) -> "Poly":
        return cls({(): float(value)} if value else {})

    @classmethod
    def sym(cls, name: str) -> "Poly":
        return cls({(name,): 1.0})

    @classmethod
    def of_dim(cls, dim) -> "Poly":
        return cls.const(dim) if isinstance(dim, (int, float)) else cls.sym(str(dim))

    @classmethod
    def of_shape(cls, shape) -> "Poly":
        out = cls.const(1.0)
        for d in shape:
            out = out * cls.of_dim(d)
        return out

    def __add__(self, other: "Poly") -> "Poly":
        terms = dict(self.terms)
        for k, v in other.terms.items():
            terms[k] = terms.get(k, 0.0) + v
        return Poly(terms)

    def __mul__(self, other) -> "Poly":
        if isinstance(other, (int, float)):
            return Poly({k: v * other for k, v in self.terms.items()})
        terms: dict = {}
        for ka, va in self.terms.items():
            for kb, vb in other.terms.items():
                key = tuple(sorted(ka + kb))
                terms[key] = terms.get(key, 0.0) + va * vb
        return Poly(terms)

    def __bool__(self) -> bool:
        return bool(self.terms)

    def symbols(self) -> set:
        return {s for key in self.terms for s in key}

    def evaluate(self, bindings: dict) -> "float | None":
        """Numeric value under ``bindings``; None if any symbol is unbound."""
        total = 0.0
        for key, coeff in self.terms.items():
            val = coeff
            for s in key:
                if s not in bindings:
                    return None
                val *= float(bindings[s])
            total += val
        return total

    def render(self) -> str:
        if not self.terms:
            return "0"
        parts = []
        for key, coeff in sorted(self.terms.items(), key=lambda kv: (-len(kv[0]), kv[0])):
            syms: list = []
            seen: dict = {}
            for s in key:
                seen[s] = seen.get(s, 0) + 1
            for s, p in sorted(seen.items()):
                # expression symbols ("k + 1") read as separate terms when
                # joined bare into a product — parenthesize them
                disp = f"({s})" if any(c in s for c in " +-*/") else s
                syms.append(disp if p == 1 else f"{disp}^{p}")
            body = "·".join(syms)
            if coeff == 1.0 and body:
                parts.append(body)
            elif body:
                c = int(coeff) if float(coeff).is_integer() else coeff
                parts.append(f"{c}·{body}")
            else:
                c = int(coeff) if float(coeff).is_integer() else coeff
                parts.append(str(c))
        return " + ".join(parts)


def poly_max(a: Poly, b: Poly) -> Poly:
    """The term-wise maximum of two cost polynomials: at least either one
    wherever the symbols and coefficients are non-negative, as shape
    symbols and costs are. The price of two alternative code paths."""
    keys = set(a.terms) | set(b.terms)
    return Poly({k: max(a.terms.get(k, 0.0), b.terms.get(k, 0.0)) for k in keys})


# -- abstract shapes --------------------------------------------------------

_MAX_DIM_EXPR = 24


def dim_of_node(node, dims: "dict | None" = None) -> "int | str | None":
    """A dim from an AST expression: int constant, name, or a short source
    expression kept verbatim as a shape symbol (``"block + 1"``). ``dims``
    maps local names bound from a ``.shape`` to their dims (``n, k =
    y.shape`` binds ``n`` to ``"y.d0"``)."""
    if isinstance(node, ast.Constant):
        if isinstance(node.value, int):
            return node.value if node.value >= 0 else "?"
        return None
    if isinstance(node, ast.Name):
        return (dims or {}).get(node.id, node.id)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return "?"  # -1 in a reshape: inferred dim
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover — malformed tree
        return None
    return text if len(text) <= _MAX_DIM_EXPR else "?"


_SHAPE_CTORS = {"zeros", "ones", "full", "empty", "rand", "randn"}
#: Methods whose result is their operand's table, moved, cast or copied
#: (``ShardedRows.full`` gathers the shards back into one tensor): the
#: same shape, and an alias for the model-scaled evidence.
_SAME_TABLE = {"to", "type", "contiguous", "clone", "detach", "float",
               "half", "bfloat16", "double", "char", "astype", "copy",
               "cpu", "cuda", "pin_memory", "full"}


def _ctor_shape(call: ast.Call, name: str, dims: dict) -> "tuple | None":
    if not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, (ast.Tuple, ast.List)):
        elts = arg.elts
    elif name == "full":
        elts = [arg]  # torch.full(size, fill): one size argument
    else:
        elts = call.args  # torch.zeros(n, k): sizes as varargs
    out = tuple(dim_of_node(e, dims) for e in elts)
    return None if any(d is None for d in out) else out


def _params(fn_node) -> list:
    a = fn_node.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


def shape_env(fctx, fn_node) -> dict:
    """name -> abstract shape for one function scope: a single ordered pass
    over constructor calls, ``reshape``/``view``, ``.T``, casts, plain
    aliasing and ``.shape`` unpacking. Meant for the cost model, not
    soundness — unknown stays unknown. ``"__shape_of__"`` holds the
    expression evaluator and ``"__alias__"`` the names that are a cast or
    an alias of another (``qb = qs.to(torch.bfloat16)``), which the cost
    model reads back to the parameter they came from."""
    env: dict = {}
    dims: dict = {}
    alias: dict = {}
    params = set(_params(fn_node))

    def shape_of(node) -> "tuple | None":
        if isinstance(node, ast.Name):
            return env.get(node.id)
        if isinstance(node, ast.Attribute) and node.attr in ("T", "mT"):
            inner = shape_of(node.value)
            return tuple(reversed(inner)) if inner else None
        if not isinstance(node, ast.Call):
            return None
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in ("reshape", "view"):
            if len(node.args) == 1 and isinstance(node.args[0], (ast.Tuple, ast.List)):
                out = tuple(dim_of_node(e, dims) for e in node.args[0].elts)
            else:
                out = tuple(dim_of_node(a, dims) for a in node.args)
            return None if not out or any(d is None for d in out) else out
        if isinstance(func, ast.Attribute) and func.attr == "t" and not node.args:
            inner = shape_of(func.value)
            return tuple(reversed(inner)) if inner else None
        if isinstance(func, ast.Attribute) and func.attr in _SAME_TABLE:
            return shape_of(func.value)
        resolved = fctx.resolve(func)
        if resolved:
            mod, _, name = resolved.rpartition(".")
            if mod in ("torch", "numpy") and name in _SHAPE_CTORS:
                return _ctor_shape(node, name, dims)
            if mod in ("torch", "numpy") and name == "arange" and len(node.args) == 1:
                d = dim_of_node(node.args[0], dims)
                return None if d is None else (d,)
        return None

    def dims_of(node, rank: int) -> "tuple | None":
        s = shape_of(node)
        if s is None and isinstance(node, ast.Name):
            root = alias.get(node.id, node.id)
            if root in params:
                s = param_shape(root, rank)
        return s if s is not None and len(s) == rank else None

    for node in scope_nodes(fctx, fn_node):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target, value = node.targets[0], node.value
        if isinstance(target, ast.Tuple) and isinstance(value, ast.Attribute) \
                and value.attr == "shape":
            s = dims_of(value.value, len(target.elts))
            if s is not None:
                for e, d in zip(target.elts, s):
                    if isinstance(e, ast.Name):
                        dims[e.id] = d
            continue
        if not isinstance(target, ast.Name):
            continue
        if isinstance(value, ast.Subscript) and isinstance(value.value, ast.Attribute) \
                and value.value.attr == "shape" \
                and isinstance(value.slice, ast.Constant) \
                and isinstance(value.slice.value, int) and value.slice.value >= 0:
            s = dims_of(value.value.value, 2)
            if s is not None and value.slice.value < len(s):
                dims[target.id] = s[value.slice.value]
            continue
        s = shape_of(value)
        if s is not None:
            env[target.id] = s
            continue
        roots = _alias_roots(value)
        if len(roots) == 1:
            (root,) = roots
            root = alias.get(root, root)
            if root in params and root not in ("self", "cls"):
                alias[target.id] = root
    env["__shape_of__"] = shape_of
    env["__alias__"] = alias
    return env


def param_shape(param: str, rank: int = 2) -> tuple:
    """The signature-derived symbolic shape of a parameter: ``y`` ->
    ``("y.d0", "y.d1")``. These are the symbols ``--bind`` binds."""
    return tuple(f"{param}.d{i}" for i in range(rank))


# -- per-shard regions ------------------------------------------------------

#: The port's replication call: a copy of one value on each device.
REPLICATED = "oryx_tpu_torch.parallel.mesh.replicated"


def _is_replicated_call(fctx, node) -> bool:
    """``replicated(value, devices)`` (the mesh module's function, however
    imported) or ``<context>.replicated(value)``
    (``ComputeContext.replicated``)."""
    if not (isinstance(node, ast.Call) and node.args):
        return False
    if fctx.resolve(node.func) == REPLICATED:
        return True
    func = node.func
    return (isinstance(func, ast.Attribute) and func.attr == "replicated"
            and len(node.args) == 1)


def _find_replicated(fctx, node):
    """The replicated call an iterable argument is, or holds one level
    down (``replicated(x, devs) if x is not None else [None] * n``)."""
    if _is_replicated_call(fctx, node):
        return node
    if isinstance(node, ast.IfExp):
        return _find_replicated(fctx, node.body) or _find_replicated(fctx, node.orelse)
    return None


def _is_shards(node) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "shards"


class ShardRegion:
    """One per-shard loop: the loop (or comprehension) over a mesh's
    shards, its enclosing function, the replicated copies it hands each
    shard and the per-shard calls they reach.

    ``replicated`` holds ``(call, value, copy)``: the ``replicated(...)``
    call, the value it copies and the loop-target name bound to one copy
    per shard. ``callees`` holds ``(fctx, fn_node, qualname, param,
    copy)``: a per-shard call's project function and the parameter a copy
    is passed to. ``nested`` holds the per-shard functions defined in the
    enclosing scope (closure-capture checks)."""

    __slots__ = ("fctx", "loop", "body", "enclosing", "enclosing_qual",
                 "replicated", "callees", "nested")

    def __init__(self, fctx, loop, body, enclosing, enclosing_qual):
        self.fctx = fctx
        self.loop = loop
        self.body = body
        self.enclosing = enclosing
        self.enclosing_qual = enclosing_qual
        self.replicated: list = []
        self.callees: list = []
        self.nested: list = []


def _loop_parts(node):
    """(target, iterable, body nodes) of a for-loop or a one-generator
    comprehension, else None."""
    if isinstance(node, (ast.For, ast.AsyncFor)):
        return node.target, node.iter, node.body
    if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)) \
            and len(node.generators) == 1:
        g = node.generators[0]
        return g.target, g.iter, [node.elt]
    if isinstance(node, ast.DictComp) and len(node.generators) == 1:
        g = node.generators[0]
        return g.target, g.iter, [node.key, node.value]
    return None


def _zip_items(target, it):
    """(target element, zipped argument) pairs of a ``for ... in zip(...)``
    (or ``enumerate(zip(...))``), or of a plain loop over one iterable."""
    if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
            and it.func.id == "enumerate" and it.args:
        if isinstance(target, ast.Tuple) and len(target.elts) == 2:
            return _zip_items(target.elts[1], it.args[0])
        return []
    if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
            and it.func.id == "zip":
        if isinstance(target, ast.Tuple) and len(target.elts) == len(it.args):
            return list(zip(target.elts, it.args))
        return []
    return [(target, it)]


def _local_value(fctx, fn_node, name: str):
    """The value of the one plain assignment to ``name`` in a scope."""
    found = None
    for node in scope_nodes(fctx, fn_node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name:
            if found is not None:
                return None
            found = node.value
    return found


def _callee(project, fctx, call: ast.Call):
    """(fctx, fn_node) of a call's project function: a local function, a
    from-import, ``module.fn``, or ``self.method`` of the enclosing
    class; None when it does not resolve."""
    func = call.func
    if isinstance(func, ast.Name):
        local = fctx.functions_by_name.get(func.id)
        if local:
            return fctx, min(local, key=lambda n: fctx.qualname_of[n].count("."))
    resolved = fctx.resolve(func)
    if resolved and "." in resolved:
        mod, _, name = resolved.rpartition(".")
        target = module_map(project).get(mod)
        if target is not None and name in target.functions_by_name:
            return target, target.functions_by_name[name][0]
    return None


def shard_regions(project) -> list:
    """Every statically parsable per-shard loop in the project, memoized:
    a loop whose iterable zips ``replicated(...)`` copies (directly, or a
    local name assigned one) or a value's ``.shards``. Anything else is
    skipped, never guessed."""
    cached = getattr(project, "_shard_regions", None)
    if cached is not None:
        return cached
    out: list = []
    for fctx in project.files:
        # textual pre-gate: only the files that mention the mesh's idioms
        if "replicated" not in fctx.source and ".shards" not in fctx.source:
            continue
        for qual, fn in fctx.functions:
            nested = {n.name: n for n in ast.iter_child_nodes(fn)
                      if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            for node in scope_nodes(fctx, fn):
                parts = _loop_parts(node)
                if parts is None:
                    continue
                target, it, body = parts
                items = _zip_items(target, it)
                region = ShardRegion(fctx, node, body, fn, qual)
                per_shard = False
                for elt, arg in items:
                    value = arg
                    if isinstance(arg, ast.Name):
                        value = _local_value(fctx, fn, arg.id) or arg
                    rep = _find_replicated(fctx, value)
                    if rep is not None and isinstance(elt, ast.Name):
                        region.replicated.append((rep, rep.args[0], elt.id))
                        per_shard = True
                    elif _is_shards(value):
                        per_shard = True
                if not per_shard:
                    continue
                copies = {c for _, _, c in region.replicated}
                for b in body:
                    for call in ast.walk(b):
                        if not isinstance(call, ast.Call):
                            continue
                        if isinstance(call.func, ast.Name) and call.func.id in nested:
                            region.nested.append(nested[call.func.id])
                        if not copies:
                            continue
                        target_fn = _callee(project, fctx, call)
                        if target_fn is None:
                            continue
                        cfctx, cnode = target_fn
                        cparams = [a.arg for a in cnode.args.posonlyargs + cnode.args.args]
                        for i, a in enumerate(call.args):
                            if isinstance(a, ast.Name) and a.id in copies and i < len(cparams):
                                region.callees.append((cfctx, cnode, cfctx.qualname_of[cnode],
                                                       cparams[i], a.id))
                        for kw in call.keywords:
                            if isinstance(kw.value, ast.Name) and kw.value.id in copies \
                                    and kw.arg is not None:
                                region.callees.append((cfctx, cnode, cfctx.qualname_of[cnode],
                                                       kw.arg, kw.value.id))
                out.append(region)
    project._shard_regions = out
    return out


# -- model-scaled evidence --------------------------------------------------

def _alias_roots(node) -> set:
    """Names an expression is a pure alias/cast of: ``y``, ``y.to(cd)``,
    ``y.full() if p else y``. A call with other argument roots is NOT an
    alias — derived-ness must not flow through arbitrary call results."""
    if isinstance(node, ast.Name):
        return {node.id}
    if isinstance(node, ast.Attribute):
        return _alias_roots(node.value)
    if isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _SAME_TABLE:
            return _alias_roots(func.value)
        return set()
    if isinstance(node, ast.IfExp):
        return _alias_roots(node.body) | _alias_roots(node.orelse)
    return set()


def _param_aliases(fctx, fn_node, param: str) -> set:
    names = {param}
    for _ in range(2):
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                roots = _alias_roots(node.value)
                if roots and roots <= names:
                    names.add(node.targets[0].id)
    return names


def _static_index(node) -> bool:
    """Indices that slice structure rather than gather by data: constants,
    slices, None-extensions."""
    if isinstance(node, (ast.Constant, ast.Slice)):
        return True
    if isinstance(node, ast.UnaryOp):
        return _static_index(node.operand)
    if isinstance(node, ast.Tuple):
        return all(_static_index(e) for e in node.elts)
    return False


def _row_index(node):
    """The leading (row) index of a subscript: a factor table is gathered
    by ROWS (``y[cols]``, ``y[cols, :]``); a column pick by data
    (``lut[:, buckets]``) reads a batch-shaped operand's columns."""
    if isinstance(node, ast.Tuple) and node.elts:
        return node.elts[0]
    return node


_GATHER_FNS = {"torch.index_select", "torch.take"}
_GRAMIAN_FNS = {"torch.mm", "torch.matmul"}


def _direct_gather_evidence(fctx, fn_node, param: str) -> bool:
    """Does ``param`` look like a factor TABLE inside ``fn_node`` (a
    function, or a per-shard loop)? Evidence: a data-indexed row gather
    (``y[cols]``, ``torch.index_select(y, 0, idx)``,
    ``y.index_select(0, idx)``, ``torch.take(y, idx)``) or the
    self-Gramian (``y.T @ y``, ``torch.mm(y.T, y)``). Batch-shaped
    operands (queries, masks) are multiplied or masked but never gathered
    by data rows — that asymmetry is what separates the replicated-factor
    hazard from deliberate small broadcasts. Walks nested defs."""
    aliases = _param_aliases(fctx, fn_node, param)

    def is_table(node) -> bool:
        roots = _alias_roots(node)
        return bool(roots) and roots <= aliases

    for node in ast.walk(fn_node):
        if isinstance(node, ast.Subscript):
            if is_table(node.value) and not _static_index(_row_index(node.slice)):
                return True
        elif isinstance(node, ast.Call):
            resolved = fctx.resolve(node.func)
            func = node.func
            if resolved in _GATHER_FNS and node.args and is_table(node.args[0]):
                return True
            if isinstance(func, ast.Attribute) and func.attr == "index_select" \
                    and resolved not in _GATHER_FNS and is_table(func.value):
                return True
            if resolved in _GRAMIAN_FNS and len(node.args) >= 2 \
                    and is_table(node.args[0]) and is_table(node.args[1]):
                return True
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            if is_table(node.left) and is_table(node.right):
                return True  # y.T @ y: the Gramian of a factor table
    return False


def model_scaled_params(project, fctx, fn_node) -> set:
    """Parameters of ``fn_node`` whose abstract size scales with a model
    dimension: direct gather/Gramian evidence, or the same evidence one
    positional-argument hop away in a project callee."""
    params = [a.arg for a in fn_node.args.posonlyargs + fn_node.args.args]
    out = {p for p in params if _direct_gather_evidence(fctx, fn_node, p)}
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        callee = _callee(project, fctx, node)
        if callee is None:
            continue
        cfctx, cnode = callee
        cparams = [a.arg for a in cnode.args.posonlyargs + cnode.args.args]
        for i, arg in enumerate(node.args):
            if i >= len(cparams):
                break
            roots = _alias_roots(arg)
            if not roots:
                continue
            for p in params:
                if p in out:
                    continue
                if roots <= _param_aliases(fctx, fn_node, p) and \
                        _direct_gather_evidence(cfctx, cnode, cparams[i]):
                    out.add(p)
    return out


def replicated_tables(project, region: ShardRegion) -> list:
    """``(call, value, copy, reached)`` for each replicated copy of a
    region that is model-scaled where it goes: gathered or Gramian'd in
    the loop body itself, or in a per-shard callee (or one hop beyond).
    ``reached`` names where: ``"the loop body"`` or ``"<callee>(<param>)"``."""
    out = []
    for call, value, copy in region.replicated:
        reached = None
        if any(_direct_gather_evidence(region.fctx, b, copy)
               for b in region.body):
            reached = "the loop body"
        else:
            for cfctx, cnode, cqual, param, c in region.callees:
                if c == copy and param in model_scaled_params(project, cfctx, cnode):
                    reached = f"{cqual}({param})"
                    break
        if reached is not None:
            out.append((call, value, copy, reached))
    return out


def priced_name(region: ShardRegion, value) -> str:
    """The name a replicated value is priced by: the enclosing function's
    parameter it is an alias of (``full = y.full() if ... else y`` is
    priced as ``y``), else its own root name."""
    roots = _alias_roots(value)
    fn = region.enclosing
    for p in _params(fn):
        if roots and roots <= _param_aliases(region.fctx, fn, p):
            return p
    return sorted(roots)[0] if roots else ast.unparse(value)


def replicated_capture_names(project, region: ShardRegion) -> list:
    """``(nested function node, name)`` for the free names of a per-shard
    function defined in the enclosing scope that are bound to device
    tensors there: a closure-captured factor table is read whole by every
    shard, with no ``replicated(...)`` line to review."""
    if not region.nested:
        return []
    flow = DeviceFlow(region.fctx, region.enclosing, project)
    device = flow.device
    out = []
    for fn in dict.fromkeys(region.nested):
        bound = set(_params(fn))
        local_assigns = {
            n.id
            for s in ast.walk(fn)
            if isinstance(s, ast.Assign)
            for t in s.targets
            for n in ast.walk(t)
            if isinstance(n, ast.Name)
        }
        seen: set = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                name = node.id
                if name in bound or name in local_assigns or name in seen:
                    continue
                if name in device:
                    seen.add(name)
                    out.append((fn, name))
    return out


def replicated_bytes(param: str, dtype: str = "float32") -> Poly:
    """Per-call copy bytes of one replicated table: Π(signature dims) ×
    itemsize — ``y`` -> ``y.d0·y.d1·4``."""
    return Poly.of_shape(param_shape(param)) * float(DTYPE_BYTES[dtype])


# -- per-program cost model -------------------------------------------------

#: torch contractions: (a, b) operands, or an einsum spec first.
_CONTRACTIONS = {"torch.mm", "torch.matmul", "torch.bmm", "torch.tensordot"}
_EINSUMS = {"torch.einsum", "numpy.einsum"}


def _einsum_cost(fctx, call: ast.Call, senv: dict) -> "tuple[Poly, Poly] | None":
    """(flops, bytes) of one einsum: FLOPs = 2·Π(distinct index extents),
    bytes = operand + output sizes at 4 B. Extents come from operand shapes
    when the shape env knows them, else stay symbolic by index letter."""
    if not (call.args and isinstance(call.args[0], ast.Constant)
            and isinstance(call.args[0].value, str)):
        return None
    spec = call.args[0].value.replace(" ", "")
    if "->" not in spec:
        return None
    lhs, rhs = spec.split("->", 1)
    in_specs = lhs.split(",")
    operands = call.args[1:1 + len(in_specs)]
    shape_of = senv.get("__shape_of__")
    letter_dim: dict = {}
    for op_spec, op_node in zip(in_specs, operands):
        shape = shape_of(op_node) if shape_of else None
        for i, letter in enumerate(op_spec):
            if letter in letter_dim:
                continue
            if shape is not None and i < len(shape):
                letter_dim[letter] = shape[i]
            else:
                letter_dim[letter] = letter
    flops = Poly.const(2.0)
    for letter in sorted(set(lhs.replace(",", "")) | set(rhs)):
        flops = flops * Poly.of_dim(letter_dim.get(letter, letter))
    bytes_ = Poly.const(0.0)
    for op_spec in in_specs + [rhs]:
        term = Poly.const(4.0)
        for letter in op_spec:
            term = term * Poly.of_dim(letter_dim.get(letter, letter))
        bytes_ = bytes_ + term
    return flops, bytes_


def _operand_shape(fctx, node, senv, transpose_ok=True) -> tuple:
    shape_of = senv.get("__shape_of__")
    s = shape_of(node) if shape_of else None
    if s is not None:
        return s
    # casts keep the operand's shape: qb.float() is qb
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _SAME_TABLE:
        return _operand_shape(fctx, node.func.value, senv, transpose_ok)
    # signature-derived fallback: a bare name gets p.d0 × p.d1 of the
    # parameter it is a cast or alias of
    if isinstance(node, ast.Name):
        return param_shape(senv.get("__alias__", {}).get(node.id, node.id))
    if isinstance(node, ast.Attribute) and node.attr in ("T", "mT") and transpose_ok:
        return tuple(reversed(_operand_shape(fctx, node.value, senv, False)))
    return ("?", "?")


def _matmul_cost(fctx, left, right, senv) -> "tuple[Poly, Poly]":
    a = _operand_shape(fctx, left, senv)
    b = _operand_shape(fctx, right, senv)
    dims = list(a[:-1]) + [b[-1] if len(b) else "?"]
    if len(a) >= 2:
        dims.append(a[-1])  # the contracted extent
    flops = Poly.const(2.0) * Poly.of_shape(dims)
    bytes_ = (Poly.of_shape(a) + Poly.of_shape(b)) * 4.0
    return flops, bytes_


_NUMPY_METHODS = {"astype", "numpy"}


def _numpy_names(fctx, fn_node) -> set:
    """Local names assigned host numpy arrays in a scope (from a
    ``numpy.*`` call, ``.numpy()`` or ``.astype(...)``): a ``@`` over
    one is host arithmetic, not a device program."""
    out: set = set()
    for node in scope_nodes(fctx, fn_node):
        if isinstance(node, ast.Assign) and _is_numpy(fctx, node.value, out):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
    return out


def _is_numpy(fctx, node, names: set) -> bool:
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Attribute):
        return node.attr != "shape" and _is_numpy(fctx, node.value, names)
    if isinstance(node, ast.Subscript):
        return _is_numpy(fctx, node.value, names)
    if isinstance(node, ast.BinOp):
        return _is_numpy(fctx, node.left, names) or _is_numpy(fctx, node.right, names)
    if isinstance(node, ast.Call):
        resolved = fctx.resolve(node.func) or ""
        if resolved.startswith("numpy."):
            return True
        func = node.func
        if isinstance(func, ast.Attribute):
            return func.attr in _NUMPY_METHODS or _is_numpy(fctx, func.value, names)
    return False


class _CostWalk:
    """FLOPs and HBM bytes of one function body: contractions and
    data-indexed gathers (elementwise traffic is second-order and
    skipped). Loop bodies count once; alternative paths (``if``/``else``,
    an ``if`` that returns against the rest of its block, ``a if p else
    b``) price at the term-wise maximum of the two (:func:`poly_max`)."""

    def __init__(self, fctx, fn_node):
        self.fctx = fctx
        self.senv = shape_env(fctx, fn_node)
        self.numpy = _numpy_names(fctx, fn_node)
        self.contractions = 0

    def block(self, stmts) -> tuple:
        flops, hbm = Poly(), Poly()
        for i, stmt in enumerate(stmts):
            if isinstance(stmt, ast.If) and not stmt.orelse and stmt.body \
                    and isinstance(stmt.body[-1], (ast.Return, ast.Raise)):
                tf, th = self.node(stmt.test)
                bf, bh = self.block(stmt.body)
                rf, rh = self.block(stmts[i + 1:])
                return (flops + tf + poly_max(bf, rf),
                        hbm + th + poly_max(bh, rh))
            f, h = self.node(stmt)
            flops, hbm = flops + f, hbm + h
        return flops, hbm

    def node(self, node) -> tuple:
        if isinstance(node, ast.If):
            tf, th = self.node(node.test)
            bf, bh = self.block(node.body)
            of, oh = self.block(node.orelse)
            return tf + poly_max(bf, of), th + poly_max(bh, oh)
        if isinstance(node, ast.IfExp):
            tf, th = self.node(node.test)
            bf, bh = self.node(node.body)
            of, oh = self.node(node.orelse)
            return tf + poly_max(bf, of), th + poly_max(bh, oh)
        flops, hbm = self.own(node)
        for _, value in ast.iter_fields(node):
            if isinstance(value, list):
                if value and isinstance(value[0], ast.stmt):
                    f, h = self.block(value)
                    flops, hbm = flops + f, hbm + h
                    continue
                for v in value:
                    if isinstance(v, ast.AST):
                        f, h = self.node(v)
                        flops, hbm = flops + f, hbm + h
            elif isinstance(value, ast.AST):
                f, h = self.node(value)
                flops, hbm = flops + f, hbm + h
        return flops, hbm

    def own(self, node) -> tuple:
        """The cost of the node itself, without its children."""
        fctx, senv = self.fctx, self.senv
        if isinstance(node, ast.Call):
            resolved = fctx.resolve(node.func)
            if resolved in _EINSUMS:
                cost = _einsum_cost(fctx, node, senv)
                if cost:
                    self.contractions += resolved.startswith("torch.")
                    return cost
            elif resolved in _CONTRACTIONS and len(node.args) >= 2:
                self.contractions += 1
                return _matmul_cost(fctx, node.args[0], node.args[1], senv)
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            if not (_is_numpy(fctx, node.left, self.numpy)
                    or _is_numpy(fctx, node.right, self.numpy)):
                self.contractions += 1
                return _matmul_cost(fctx, node.left, node.right, senv)
        elif isinstance(node, ast.Subscript) and not _static_index(node.slice):
            shape_of = senv.get("__shape_of__")
            s = shape_of(node.value) if shape_of else None
            if s is not None:
                return Poly(), Poly.of_shape(s) * 4.0  # data-indexed gather
        return Poly(), Poly()


def program_cost(project, fctx, fn_node) -> dict:
    """Static cost of one program (:func:`cost_report`): FLOPs/HBM-bytes
    polynomials from its contractions and gathers, plus collective bytes
    from the per-shard regions it holds — each model-scaled replicated
    table priced once per program, not per loop. The table is a
    per-call roofline to diff in review, not a cycle counter. ``is_program``
    says whether the function holds a torch contraction or a region."""
    walk = _CostWalk(fctx, fn_node)
    flops, hbm = walk.block(fn_node.body)
    collective = Poly()
    priced: set = set()
    regions = [r for r in shard_regions(project)
               if r.fctx is fctx and r.enclosing is fn_node]
    for region in regions:
        for _, value, _, _ in replicated_tables(project, region):
            name = priced_name(region, value)
            if name not in priced:
                priced.add(name)
                collective = collective + replicated_bytes(name)
    return {"flops": flops, "hbm_bytes": hbm, "collective_bytes": collective,
            "is_program": bool(walk.contractions or regions)}


def cost_report(project) -> list:
    """One row per program with a nonzero cost, sorted by path/line — the
    ``analyze --cost`` payload. A program is a function that holds a torch
    contraction (``torch.mm/matmul/bmm/tensordot/einsum``, or ``@`` on
    operands that are not host numpy) or a per-shard region. Rows carry
    Poly objects; the CLI renders/evaluates them."""
    rows = []
    for fctx in project.files:
        if "@" not in fctx.source and "torch" not in fctx.source \
                and "replicated" not in fctx.source:
            continue
        for qual, fn in fctx.functions:
            cost = program_cost(project, fctx, fn)
            if not cost.pop("is_program"):
                continue
            if not (cost["flops"] or cost["hbm_bytes"]
                    or cost["collective_bytes"]):
                continue
            rows.append({
                "program": f"{module_name(fctx.relpath)}.{qual}",
                "path": fctx.relpath,
                "line": fn.lineno,
                **cost,
            })
    rows.sort(key=lambda r: (r["path"], r["line"]))
    return rows
