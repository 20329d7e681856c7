"""dtype-widening: narrow device dtypes silently promoted to float32.

The port of the JAX package's ``oryx_tpu/tools/analyze/checkers/dtypewidth.py``
under the reference's id and version, rewritten for torch, which has no
jit scope: the scopes checked are the functions whose operands
``dataflow.DeviceFlow`` shows on the device (a device value made or
returned there, or a helper whose result is a device tensor when its
arguments are, ``dataflow.device_if_args``, with its parameters taken as
device tensors).

The framework keeps deliberately-narrow device copies — bfloat16 scoring
matrices (half the HBM per scan) and int8 quantized factor slabs (a
quarter) — precisely to stay under the bandwidth roofline. A bf16/int8
tensor that silently mixes with float32 in an elementwise op pays f32
traffic anyway while keeping the narrow dtype's rounding error: the worst
of both. torch promotes such an op (``bf16 * f32`` is f32) without a word.

Flagged: a binary arithmetic op (``+ - * / **``) mixing a LOW-dtype tensor
(``int8``/``bfloat16``/``float16``, by cast or constructor evidence) with a
float32 one, on the device. The evidence is read in the function itself:
a cast, a constructor's ``dtype=``, or a numpy array of a known dtype
(``dtype=np.int8``, ``.astype(np.int8)``) uploaded with
``torch.as_tensor`` / ``torch.from_numpy``. A dtype that reaches the
function only through an attribute or a parameter (the serving
snapshot's ``qmat`` int8 slab and bfloat16 ``score_mat``, read as
``snap.qmat``) is beyond its reach: a silent widening of those is not
seen. Not flagged, because torch refuses it at run
time: a contraction over mixed dtypes (``torch.mm``, ``@``). Sanctioned
and silent, the reference's forms translated:

  * ``torch.mm/matmul/bmm(..., out_dtype=torch.float32)`` — f32
    ACCUMULATION over narrow inputs is the card's matmul recipe (the
    reference's ``preferred_element_type``), not a widening;
  * an explicit ``.float()`` / ``.to(torch.float32)`` — visible intent;
  * scopes whose qualname contains ``rescore`` or ``solve`` — the exact-f32
    rescore of quantized candidates and the f32 solves widen by design.
"""

from __future__ import annotations

import ast

from oryx_tpu_torch.tools.analyze.core import scope_nodes
from oryx_tpu_torch.tools.analyze.dataflow import (
    DTYPE_RANK,
    LOW_DTYPES,
    DeviceFlow,
    LineStateEnv,
    cast_dtype,
    device_if_args,
    dtype_of_node,
)

ID = "dtype-widening"

_SANCTIONED_NAME_PARTS = ("rescore", "solve")
_ARITH_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow)
#: torch constructors whose default dtype is float32.
_F32_DEFAULT_CTORS = {"zeros", "ones", "empty", "rand", "randn", "linspace"}
#: torch constructors that take their argument's dtype.
_LIKE_CTORS = {"zeros_like", "ones_like", "empty_like", "full_like",
               "rand_like", "randn_like"}
#: host-to-tensor uploads that keep their argument's dtype.
_UPLOADS = {"torch.as_tensor", "torch.from_numpy", "torch.tensor",
            "torch.asarray"}
#: contractions whose ``out_dtype=`` names their result's dtype.
_OUT_DTYPE_CONTRACTIONS = {"torch.mm", "torch.matmul", "torch.bmm"}
#: tensor methods whose result keeps the operand's dtype.
_DTYPE_KEEPING = {"clone", "contiguous", "detach", "cpu", "cuda", "sum",
                  "mean", "abs", "neg", "sqrt", "exp", "reshape", "view",
                  "t", "transpose", "permute", "squeeze", "unsqueeze",
                  "expand", "flatten", "index_select", "gather", "mul",
                  "mul_", "add", "add_", "sub", "div", "clamp", "clamp_min"}


class _DtypeEnv:
    """Flow-sensitive (per-line) name -> lattice dtype inference for one
    scope, the same discipline as ``dataflow.DeviceFlow``: a name resolves
    to its dtype just BEFORE the queried line, so the idiomatic
    compute-wide-then-store-narrow pattern (``acc = acc + w`` ... ``acc =
    acc.bfloat16()`` at the end) never retro-flags the earlier pure-f32
    arithmetic."""

    def __init__(self, fctx, fn_node):
        self.fctx = fctx
        self._env = LineStateEnv()
        stmts = sorted(
            (n for n in scope_nodes(fctx, fn_node)
             if isinstance(n, (ast.Assign, ast.AnnAssign))),
            key=lambda n: n.lineno,
        )
        for stmt in stmts:
            if stmt.value is None:
                continue
            dt = self.dtype_of(stmt.value, stmt.lineno)
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    self._env.record(t.id, stmt.lineno, dt)

    def dtype_of(self, node, line: int) -> "str | None":
        if isinstance(node, ast.Name):
            return self._env.state_before(node.id, line)
        if isinstance(node, ast.Attribute):
            if node.attr in ("T", "mT", "data"):
                return self.dtype_of(node.value, line)
            return None
        if isinstance(node, ast.Subscript):
            return self.dtype_of(node.value, line)
        if isinstance(node, ast.Call):
            return self._call_dtype(node, line)
        if isinstance(node, ast.BinOp):
            lo = self.dtype_of(node.left, line)
            hi = self.dtype_of(node.right, line)
            if lo is None or hi is None:
                return lo or hi
            return lo if DTYPE_RANK[lo] >= DTYPE_RANK[hi] else hi
        return None

    def _call_dtype(self, node: ast.Call, line: int) -> "str | None":
        fctx, func = self.fctx, node.func
        cast = cast_dtype(fctx, node)
        if cast is not None:
            return cast
        for kw in node.keywords:
            if kw.arg in ("dtype", "out_dtype"):
                return dtype_of_node(fctx, kw.value)
        if (isinstance(func, ast.Attribute) and func.attr == "astype"
                and node.args):
            return dtype_of_node(fctx, node.args[0])
        resolved = fctx.resolve(func)
        if resolved in _UPLOADS and node.args:
            return self.dtype_of(node.args[0], line)
        if resolved:
            mod, _, name = resolved.rpartition(".")
            if mod == "torch" and name in _F32_DEFAULT_CTORS:
                return "float32"
            if mod == "torch" and name in _LIKE_CTORS and node.args:
                return self.dtype_of(node.args[0], line)
        if isinstance(func, ast.Attribute) and (
                func.attr in _DTYPE_KEEPING
                or (func.attr in ("to", "type") and cast is None)):
            return self.dtype_of(func.value, line)
        return None


def _mixes_low_and_f32(env: _DtypeEnv, operands, line: int) -> "tuple | None":
    """(low_expr, low_dtype) when the operand dtypes (as of ``line``) mix a
    LOW dtype with float32/float64 — the silent-widening signature."""
    dts = [(op, env.dtype_of(op, line)) for op in operands]
    low = next(((op, dt) for op, dt in dts if dt in LOW_DTYPES), None)
    wide = any(dt in ("float32", "float64") for _, dt in dts)
    return low if (low and wide) else None


class DtypeWideningChecker:
    id = ID
    version = 1

    def check(self, project) -> list:
        out = []
        cond = device_if_args(project)
        for fctx in project.files:
            if "torch" not in fctx.source:
                continue
            for qual, fn in fctx.functions:
                low_name = qual.lower()
                if any(p in low_name for p in _SANCTIONED_NAME_PARTS):
                    continue
                ops = [n for n in scope_nodes(fctx, fn)
                       if isinstance(n, ast.BinOp) and isinstance(n.op, _ARITH_OPS)]
                if not ops:
                    continue
                env = None
                flows = None
                for node in ops:
                    if env is None:
                        env = _DtypeEnv(fctx, fn)
                    hit = _mixes_low_and_f32(env, [node.left, node.right],
                                             node.lineno)
                    if hit is None:
                        continue
                    if flows is None:
                        flows = [DeviceFlow(fctx, fn, project)]
                        if (fctx.relpath, qual) in cond:
                            flows.append(DeviceFlow(fctx, fn, project,
                                                    assume_params=True))
                    if not any(f.expr_is_device(node, node.lineno) for f in flows):
                        continue
                    expr, dt = hit
                    out.append(fctx.finding(
                        ID, node,
                        f"arithmetic mixing {dt} `{ast.unparse(expr)[:40]}` "
                        f"and float32 on the device in `{qual}` silently "
                        "widens to f32 — the narrow copy pays full HBM "
                        "traffic anyway; widen explicitly (.float()) at a "
                        "sanctioned rescore/solve site, or keep the op "
                        "narrow with out_dtype=torch.float32 accumulation",
                        symbol=f"{qual}:{dt}",
                    ))
        return out
