"""protocol-model-drift: the protocol models must stay glued to the code.

The port of the JAX package's ``oryx_tpu/tools/analyze/checkers/protocolmodel.py``
under the reference's id and version: the catalog is the port's own
protocol package (``oryx_tpu_torch/tools/analyze/protocol/``) and the
coverage scan reads ``oryx_tpu_torch/transport/``. Below, the reference's
text.

The model checker under ``tools/analyze/protocol/`` verifies the
exactly-once state machines *as modelled*. That is only worth anything
while the model and the implementation agree, so this checker fails the
build in both drift directions:

* **stale annotation** — every transition's :class:`Site` annotation
  (``path``, dotted ``qual``, ``line``, optional ``contains`` fragment)
  must still resolve: the function exists, the line falls inside it,
  and the fragment still appears in its body. When a refactor moves
  ``_assigned`` or the token dedup, the model's claim to verify that
  code dies loudly instead of silently verifying a fiction.
* **unmodelled guard-relevant site** — transport functions that
  participate in the exactly-once story (offset commit via
  ``set_offset``/``_op_set_offset``, assignment computation via
  ``partitions_for_member``, idempotence-token mint/dedup via
  ``uuid4``/``_applied_tokens``, torn-tail recovery via
  ``ftruncate``/``_recover_tail``/``_ensure_recovered``) must each be
  covered by at least one model transition. New protocol surface cannot
  land without a decision about how the model represents it (or an
  explicit baseline suppression recording why it needs none).

Both directions skip files outside the current analysis scope, so
fixture projects that do not ship the transport layer stay clean.
"""

from __future__ import annotations

import ast

ID = "protocol-model-drift"

_TRANSPORT_PREFIX = "oryx_tpu_torch/transport/"

#: function names that ARE guard-relevant by name alone
_NAMED = {"set_offset", "_op_set_offset", "_recover_tail", "_ensure_recovered"}

#: resolved call targets that make the calling function guard-relevant
_CALL_MARKERS = {"uuid.uuid4", "os.ftruncate"}

#: attribute whose mere mention marks the idempotence dedup path
_ATTR_MARKER = "_applied_tokens"

#: bare callee names that mark assignment computation
_ASSIGN_MARKER = "partitions_for_member"


def _site_catalog():
    """[(model_module_relpath, site_key, Site)] for every model site.

    Imported lazily so an analyze run over a project that does not ship
    the protocol package still works (and so fixture tests can override
    the catalog wholesale via ``_catalog_override``)."""
    from oryx_tpu_torch.tools.analyze.protocol import (
        broker_model,
        ckpt_model,
        group_model,
    )

    base = "oryx_tpu_torch/tools/analyze/protocol/"
    out = []
    for mod, rel in (
        (group_model, base + "group_model.py"),
        (broker_model, base + "broker_model.py"),
        (ckpt_model, base + "ckpt_model.py"),
    ):
        for key, site in sorted(mod.SITES.items()):
            out.append((rel, key, site))
    return out


def _anchor_line(fctx, key: str) -> int:
    """Line of the ``"<key>": Site(`` entry in the model module."""
    needle = f'"{key}": Site('
    for i, text in enumerate(fctx.lines, start=1):
        if needle in text:
            return i
    return 1


class ProtocolModelDriftChecker:
    id = ID
    version = 1

    #: tests inject a replacement catalog: [(module_relpath, key, Site)]
    _catalog_override = None

    def check(self, project) -> list:
        out: list = []
        catalog = (
            self._catalog_override
            if self._catalog_override is not None
            else _site_catalog()
        )

        covered: set = set()  # (relpath, qualname) with a model transition
        for anchor_rel, key, site in catalog:
            covered.add((site.path, site.qual))
            target = project.by_relpath.get(site.path)
            if target is None:
                continue  # outside this run's scope (fixture projects)
            anchor = project.by_relpath.get(anchor_rel) or target
            line = (
                _anchor_line(anchor, key)
                if anchor is not target
                else site.line
            )
            fn = dict(target.functions).get(site.qual)
            if fn is None:
                out.append(anchor.finding(
                    ID, line,
                    f"model site {key!r} annotates {site.path}:{site.line} "
                    f"({site.qual}) but no such function exists — the "
                    "implementation moved out from under the model",
                    symbol=f"{key}:{site.qual}",
                ))
                continue
            end = getattr(fn, "end_lineno", fn.lineno)
            if not (fn.lineno <= site.line <= end):
                out.append(anchor.finding(
                    ID, line,
                    f"model site {key!r} points at {site.path}:{site.line} "
                    f"but {site.qual} now spans lines {fn.lineno}-{end} — "
                    "re-anchor the annotation",
                    symbol=f"{key}:{site.qual}",
                ))
                continue
            if site.contains:
                body = "\n".join(target.lines[fn.lineno - 1:end])
                if site.contains not in body:
                    out.append(anchor.finding(
                        ID, line,
                        f"model site {key!r} expects {site.contains!r} "
                        f"inside {site.qual} ({site.path}) but the fragment "
                        "is gone — the modelled behaviour may have changed",
                        symbol=f"{key}:{site.qual}",
                    ))

        out.extend(self._coverage(project, covered))
        return out

    # -- direction 2: guard-relevant sites must be modelled -----------------

    def _coverage(self, project, covered: set) -> list:
        out: list = []
        for fctx in project.files:
            if not fctx.relpath.startswith(_TRANSPORT_PREFIX):
                continue
            for qual, fn in fctx.functions:
                name = fn.name
                if name.startswith("__") and name.endswith("__"):
                    continue
                why = self._guard_relevance(fctx, fn, name)
                if why and (fctx.relpath, qual) not in covered:
                    out.append(fctx.finding(
                        ID, fn.lineno,
                        f"{qual} is guard-relevant to the exactly-once "
                        f"protocols ({why}) but no protocol model "
                        "transition covers it — model it or record a "
                        "baseline justification",
                        symbol=qual,
                    ))
        return out

    def _guard_relevance(self, fctx, fn, name: str) -> "str | None":
        if name in _NAMED:
            return f"named {name}"
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                callee = fctx.resolve(node.func)
                if callee in _CALL_MARKERS:
                    return f"calls {callee}"
                tail = callee.rsplit(".", 1)[-1] if callee else ""
                if tail == _ASSIGN_MARKER:
                    return f"calls {_ASSIGN_MARKER}"
            elif isinstance(node, ast.Attribute) and node.attr == _ATTR_MARKER:
                return f"touches {_ATTR_MARKER}"
        return None
