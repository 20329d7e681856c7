"""per-row-ndarray-store: dict-of-small-ndarray accumulation in hot paths.

The port of the JAX package's
``oryx_tpu/tools/analyze/checkers/perrowstore.py`` over the port's hot paths
(``oryx_tpu_torch/{models,serving}/``). It also counts a dict of tensors: a
``torch`` constructor or conversion (``torch.tensor``, ``torch.as_tensor``,
``torch.from_numpy``, ``torch.zeros``, ``torch.stack``, ...), and
``.clone()`` / ``.detach()`` / ``.contiguous()`` / ``.to(...)`` /
``.float()`` / ``.cpu()`` / ``.cuda()`` of an array-like receiver, are
per-row allocations too (a tensor carries a larger header than an ndarray).
Below, the reference's text.

The factor-arena migration exists because the serving/speed host
stores were ``dict[str, np.ndarray]`` maps: one Python ndarray object
(~200 B of header) plus a dict slot and key string per row. At reference
scale (millions of rows) that multiplies host RSS 2-3× over the raw factor
bytes (measured: 2.24× dict vs 1.27× arena at 1M × 50f) and turns every
device materialization into a million-element ``np.stack``. The sanctioned
pattern is an arena: ids → row indices into one contiguous slab
(models/als/vectors.py).

This checker flags the accumulation shape so it cannot quietly grow back:
inside ``oryx_tpu_torch/models/`` and ``oryx_tpu_torch/serving/``, a subscript store of
an ndarray-valued expression into an instance attribute that the class
initializes as a dict::

    self._vectors[id_] = np.asarray(vec, dtype=np.float32)   # flagged

Stores of scalars/indices into dicts (``self._rows[id_] = 7``) and writes
into array rows (``self._slab[row] = vec``) are the arena idiom and stay
silent. One-hop local inference follows names assigned from an
ndarray-producing expression earlier in the same function.
"""

from __future__ import annotations

import ast

from oryx_tpu_torch.tools.analyze.core import walk_scope

ID = "per-row-ndarray-store"

#: Module-path prefixes whose per-id stores sit on model/serving hot paths.
_HOT_PREFIXES = ("oryx_tpu_torch/models/", "oryx_tpu_torch/serving/")

#: Calls whose result is a (fresh) ndarray — the per-row allocation the
#: arena exists to eliminate.
_NDARRAY_CALLS = {
    "numpy.asarray", "numpy.array", "numpy.ascontiguousarray",
    "numpy.copy", "numpy.zeros", "numpy.ones", "numpy.full", "numpy.empty",
    "numpy.stack", "numpy.concatenate", "numpy.frombuffer", "numpy.fromiter",
    "torch.tensor", "torch.as_tensor", "torch.from_numpy", "torch.zeros",
    "torch.ones", "torch.full", "torch.empty", "torch.stack", "torch.cat",
    "torch.zeros_like", "torch.empty_like",
}

#: Method calls that (near-)always yield a fresh ndarray. ``.copy()`` is
#: deliberately NOT here unconditionally — sets/dicts/lists copy too, and
#: a ``known.copy()`` into a bookkeeping dict must stay silent; it only
#: counts when its receiver is itself array-like (see _is_ndarray_expr).
_NDARRAY_METHODS = {"astype"}

#: Tensor methods that yield a fresh tensor when their receiver is itself
#: array-like (``vec.clone()``), the tensor counterparts of ``.copy()``.
_ARRAY_RECEIVER_METHODS = {
    "copy", "clone", "detach", "contiguous", "to", "float", "cpu", "cuda",
}


def _is_dict_init(value: ast.AST) -> bool:
    return isinstance(value, ast.Dict) or (
        isinstance(value, ast.Call)
        and isinstance(value.func, ast.Name)
        and value.func.id == "dict"
    )


def _dict_annotation(node: ast.AST) -> bool:
    """True for ``dict[...]``/``Dict[...]`` annotations."""
    if isinstance(node, ast.Subscript):
        node = node.value
    name = getattr(node, "id", None) or getattr(node, "attr", None)
    return name in ("dict", "Dict")


class PerRowNdarrayStoreChecker:
    id = ID

    def check(self, project) -> list:
        out = []
        for fctx in project.files:
            if not fctx.relpath.startswith(_HOT_PREFIXES):
                continue
            out.extend(self._check_file(fctx))
        return out

    # -- helpers ------------------------------------------------------------
    def _dict_attrs(self, cnode: ast.ClassDef) -> set:
        """Attribute names this class initializes (or annotates) as dicts."""
        attrs: set = set()
        for node in ast.walk(cnode):
            if isinstance(node, ast.Assign) and _is_dict_init(node.value):
                for target in node.targets:
                    if (isinstance(target, ast.Attribute)
                            and isinstance(target.value, ast.Name)
                            and target.value.id == "self"):
                        attrs.add(target.attr)
            elif isinstance(node, ast.AnnAssign):
                target = node.target
                if (isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"
                        and _dict_annotation(node.annotation)):
                    attrs.add(target.attr)
        return attrs

    def _is_ndarray_expr(self, fctx, node: ast.AST, local_arrays: set) -> bool:
        if isinstance(node, ast.Name):
            return node.id in local_arrays
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute):
                if func.attr in _NDARRAY_METHODS:
                    return True
                if func.attr in _ARRAY_RECEIVER_METHODS:
                    # only when the receiver is itself array-like: a bare
                    # `known.copy()` (set/dict) must not fire
                    return self._is_ndarray_expr(fctx, func.value, local_arrays)
            resolved = fctx.resolve(func)
            return resolved in _NDARRAY_CALLS
        return False

    def _check_file(self, fctx) -> list:
        out = []
        for cqual, cnode in fctx.classes:
            dict_attrs = self._dict_attrs(cnode)
            if not dict_attrs:
                continue
            for child in cnode.body:
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.extend(self._check_method(
                        fctx, cqual, child, dict_attrs
                    ))
        return out

    def _check_method(self, fctx, cqual: str, fn, dict_attrs: set) -> list:
        out = []
        # one-hop local inference: names bound from ndarray-producing
        # expressions anywhere in this function body
        local_arrays: set = set()
        for node in walk_scope(fn):
            if isinstance(node, ast.Assign) and self._is_ndarray_expr(
                    fctx, node.value, set()):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        local_arrays.add(target.id)
        for node in walk_scope(fn):
            if not isinstance(node, ast.Assign):
                continue
            for target in node.targets:
                if not (isinstance(target, ast.Subscript)
                        and isinstance(target.value, ast.Attribute)
                        and isinstance(target.value.value, ast.Name)
                        and target.value.value.id == "self"
                        and target.value.attr in dict_attrs):
                    continue
                if self._is_ndarray_expr(fctx, node.value, local_arrays):
                    attr = target.value.attr
                    out.append(fctx.finding(
                        ID, node,
                        f"per-row ndarray accumulation: `self.{attr}[...]` "
                        f"stores an ndarray per key in `{cqual}.{fn.name}` — "
                        "at model scale the per-key Python/numpy object "
                        "overhead multiplies host RSS 2-3x over raw factor "
                        "bytes; intern rows into a contiguous arena slab "
                        "(models/als/vectors.py FeatureVectorStore)",
                        symbol=f"{cqual}.{fn.name}:{attr}",
                    ))
        return out
