"""host-device-transfer: silent device→host syncs on hot paths.

The port of the JAX package's
``oryx_tpu/tools/analyze/checkers/hosttransfer.py`` (same id, version,
contexts and messages) over torch code, held to the reference's cases in
their torch form by ``tests/test_torch_static_analysis.py``. Changes: the
device model and the transfer recogniser are the port's
(:mod:`oryx_tpu_torch.tools.analyze.dataflow`); the exempt idiom is
:func:`oryx_tpu_torch.common.device.to_host` (several tensors to the host
with one synchronisation) and explicit ``synchronize()`` calls, where the
reference's is ``jax.device_get``; uploads are classified but not
reported, as the reference does not report ``jax.device_put``; there are
no jit scopes to skip. ``chip_smoke.py``'s ``analyze`` phase holds the
recogniser against the syncs the card reports
(``torch.cuda.set_sync_debug_mode``).

Below, the reference's text.

Every ``np.asarray(device_val)``, ``float()``, ``.item()``, ``.tolist()``,
``.cpu()`` or implicit numpy-op on a device tensor is a blocking round trip
through the copy engine. Three contexts make it a bug rather than a design
choice:

  * **(A) event-loop reachability** — a sync in any function an ``async
    def`` actually calls (project call graph) stalls every in-flight
    request: the static cousin of the loop-stall watchdog's catch.
    Callables hopped through ``to_thread``/``run_in_executor`` are
    references, not calls, so the sanctioned executor escape stays clean.
  * **(B) inner training loops** — a transfer inside a ``for``/``while``
    body in a trainer module (``models/**/train.py``, ``lambda_rt/``)
    serializes the device against the host once per iteration.
  * **(C) per-element scalar syncs** — ``float(...)``/``.item()`` applied
    per element in a loop/comprehension over device-returning calls inside
    ``models/``/``serving/``: the death-by-a-thousand-syncs shape (one
    dispatch + one transfer per item instead of one batched call). Lambda
    bodies count here — the shape is the hazard wherever it finally runs.

``to_host`` is deliberately exempt: it is the explicit, batched transfer
idiom fixes should reach for (and ``blocking-async`` already owns the
event-loop reachability of explicit waits).
"""

from __future__ import annotations

import ast

from oryx_tpu_torch.tools.analyze.dataflow import (
    DeviceFlow,
    async_reachable,
    is_reported_kind,
    transfer_of_call,
)

ID = "host-device-transfer"

_TRAIN_TIER_MARKERS = ("/train.py", "lambda_rt/")
_HOT_TIER_PREFIXES = ("oryx_tpu_torch/models/", "oryx_tpu_torch/serving/")


def _is_train_tier(relpath: str) -> bool:
    return any(m in relpath for m in _TRAIN_TIER_MARKERS)


def _is_hot_tier(relpath: str) -> bool:
    return relpath.startswith(_HOT_TIER_PREFIXES)


def _may_touch_device(fctx) -> bool:
    """Cheap file gate: a file can only hold device values if it imports
    torch itself or a project module (which may re-export device-returning
    helpers, the ``vm.cosine_similarity`` shape)."""
    return any(origin.split(".")[0] in ("torch", "oryx_tpu_torch")
               for origin in fctx.import_map.values())


def _transfer_operands(call: ast.Call, kind: str) -> list:
    """The expressions a transfer call would fetch: the receiver of a
    method (``t.cpu()``), the single operand of a scalar cast, every
    positional arg of a numpy or torch function."""
    if kind.startswith("."):
        return [call.func.value] if isinstance(call.func, ast.Attribute) else []
    if kind in ("float()", "int()", "bool()"):
        return list(call.args) if len(call.args) == 1 else []
    return list(call.args)


def _is_scalar_kind(kind: str) -> bool:
    return kind in ("float()", "int()", "bool()", ".item()", ".tolist()")


class _SiteWalker:
    """Collect transfer-shaped calls with their loop/lambda context and the
    comprehension-target bindings in scope at each site. Loop context
    covers ``for``/``while`` bodies, ``while`` tests, and comprehension
    element/condition expressions — but NOT a ``for`` statement's iterable,
    which evaluates once, and NOT loop ``else:`` arms, which run at most
    once. Comprehension targets are their own scope: ``v`` in ``[float(v)
    for v in hostvals]`` binds one element of ``hostvals``, shadowing any
    earlier (possibly device) ``v`` — the bindings map lets the checker
    resolve such names to their iterable instead of the outer flow state."""

    def __init__(self):
        self.sites: list = []  # (call, in_loop, in_lambda, bindings)

    def visit(self, node, in_loop: bool, in_lambda: bool,
              bindings: "dict | None" = None) -> None:
        bindings = bindings or {}
        if isinstance(node, ast.Call):
            self.sites.append((node, in_loop, in_lambda, bindings))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if isinstance(node, ast.Lambda):
            self.visit(node.body, in_loop, True, bindings)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self.visit(node.iter, in_loop, in_lambda, bindings)
            for stmt in node.body:
                self.visit(stmt, True, in_lambda, bindings)
            for stmt in node.orelse:  # else: runs at most ONCE per loop
                self.visit(stmt, in_loop, in_lambda, bindings)
            return
        if isinstance(node, ast.While):
            self.visit(node.test, True, in_lambda, bindings)
            for stmt in node.body:
                self.visit(stmt, True, in_lambda, bindings)
            for stmt in node.orelse:
                self.visit(stmt, in_loop, in_lambda, bindings)
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            inner = dict(bindings)
            for gen in node.generators:
                self.visit(gen.iter, in_loop, in_lambda, bindings)
                for n in ast.walk(gen.target):
                    if isinstance(n, ast.Name):
                        inner[n.id] = gen.iter
                for cond in gen.ifs:
                    self.visit(cond, True, in_lambda, inner)
            if isinstance(node, ast.DictComp):
                self.visit(node.key, True, in_lambda, inner)
                self.visit(node.value, True, in_lambda, inner)
            else:
                self.visit(node.elt, True, in_lambda, inner)
            return
        for child in ast.iter_child_nodes(node):
            self.visit(child, in_loop, in_lambda, bindings)


class HostDeviceTransferChecker:
    id = ID
    version = 1

    def check(self, project) -> list:
        reach = async_reachable(project)  # memoizes the shared call graph
        out = []
        for fctx in project.files:
            if not _may_touch_device(fctx):
                continue  # no torch/project imports: no device values to fetch
            train_tier = _is_train_tier(fctx.relpath)
            hot_tier = _is_hot_tier(fctx.relpath)
            for qual, fn in fctx.functions:
                key = (fctx.relpath, qual)
                on_loop = key in reach
                if not (on_loop or train_tier or hot_tier):
                    continue
                flow = None
                walker = _SiteWalker()
                for stmt in fn.body:
                    walker.visit(stmt, False, False)
                for call, in_loop, in_lambda, bindings in walker.sites:
                    kind = transfer_of_call(fctx, call)
                    if not is_reported_kind(kind):
                        continue
                    if flow is None:
                        flow = DeviceFlow(fctx, fn, project)

                    def _op_is_device(o) -> bool:
                        # a comprehension-bound name is one ELEMENT of its
                        # iterable: device iff the iterable is
                        if isinstance(o, ast.Name) and o.id in bindings:
                            return flow.expr_is_device(
                                bindings[o.id], call.lineno
                            )
                        return flow.expr_is_device(o, call.lineno)

                    operand = next(
                        (o for o in _transfer_operands(call, kind)
                         if _op_is_device(o)),
                        None,
                    )
                    if operand is None:
                        continue
                    context = None
                    if on_loop and not in_lambda:
                        context = ("reachable from an async handler — it "
                                   "blocks the event loop for every "
                                   "in-flight request (batch with "
                                   "device.to_host in an executor hop)")
                    elif in_loop and not in_lambda and train_tier:
                        context = ("inside an inner training-tier loop — "
                                   "one blocking device round-trip per "
                                   "iteration (hoist it, or batch the "
                                   "fetch with one device.to_host)")
                    elif in_loop and hot_tier and _is_scalar_kind(kind):
                        context = ("a per-element device sync in a "
                                   "models/serving loop — one dispatch + "
                                   "one transfer PER ITEM; batch the "
                                   "computation into a single device call")
                    if context is None:
                        continue
                    out.append(fctx.finding(
                        ID, call,
                        f"`{kind.rstrip('()')}({ast.unparse(operand)[:40]})` "
                        f"fetches a device value host-side in `{qual}`, "
                        f"{context}",
                        symbol=f"{qual}:{kind}:{ast.unparse(operand)[:30]}",
                    ))
        return out
