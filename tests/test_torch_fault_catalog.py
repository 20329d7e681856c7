"""The fault-site gate of ``tests/test_fault_catalog.py`` over the port.

The reference's four cases, with the scan pointed at ``oryx_tpu_torch/``
and the tier literals read from ``oryx_tpu_torch/lambda_rt/``: every
``faults.maybe_fail(<site>)`` injection point in the port is in
``docs/robustness.md``'s site list and every documented site is injected
in the port. A name passed as the site (``faults.maybe_fail(site)`` in the
nested ``attempt`` of ``_run_generation``) resolves through the enclosing
functions, innermost first, so ``batch.generation`` and
``speed.generation`` are found. One more case: the port's sites are
exactly the reference's.
"""

from __future__ import annotations

import ast
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOC = os.path.join(REPO, "docs", "robustness.md")

_DOC_SITE_RE = re.compile(
    r"(?<!oryx\.)\b(?:broker|ckpt|serving|batch|speed)\.[a-z_]+"
)


def _iter_trees(package: str):
    for root, dirs, files in os.walk(os.path.join(REPO, package)):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(root, fname)
            with open(path, encoding="utf-8") as fh:
                yield os.path.relpath(path, REPO).replace(os.sep, "/"), \
                    ast.parse(fh.read())


def _is_maybe_fail(node) -> bool:
    return (
        isinstance(node, ast.Attribute) and node.attr == "maybe_fail"
    ) or (isinstance(node, ast.Name) and node.id == "maybe_fail")


def _generation_fstring(node) -> bool:
    """``f"{<expr>}.generation"`` — one hole, then the literal suffix."""
    return (
        isinstance(node, ast.JoinedStr)
        and len(node.values) == 2
        and isinstance(node.values[0], ast.FormattedValue)
        and isinstance(node.values[1], ast.Constant)
        and node.values[1].value == ".generation"
    )


def _tier_literals(package: str) -> set:
    """Tier names layer subclasses pass to ``super().__init__``."""
    out = set()
    for rel, tree in _iter_trees(package):
        if not rel.startswith(f"{package}/lambda_rt/"):
            continue
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "__init__"
                and isinstance(node.func.value, ast.Call)
                and isinstance(node.func.value.func, ast.Name)
                and node.func.value.func.id == "super"
                and len(node.args) >= 2
                and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, str)
            ):
                out.add(node.args[1].value)
    return out


def _site_args(tree):
    """Yield the AST node holding the site for each maybe_fail use."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _is_maybe_fail(node.func) and node.args:
            yield node, node.args[0]
        else:
            # callable passed by reference: the site is the next arg
            for i, arg in enumerate(node.args):
                if _is_maybe_fail(arg) and i + 1 < len(node.args):
                    yield node, node.args[i + 1]


def _resolve_name_to_fstring(tree, call, name):
    """``maybe_fail(site)``: the ``site = f"…"`` of the enclosing functions,
    innermost outward (``_run_generation`` assigns it, its nested
    ``attempt`` fires it)."""
    enclosing = [
        fn for fn in ast.walk(tree)
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
        and fn.lineno <= call.lineno <= getattr(fn, "end_lineno", fn.lineno)
    ]
    for fn in sorted(enclosing, key=lambda f: f.lineno, reverse=True):
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets)
                and _generation_fstring(node.value)
            ):
                return node.value
    return None


def _code_sites(package: str = "oryx_tpu_torch") -> dict:
    """{site name: relpath of one injection point}."""
    tiers = _tier_literals(package)
    out: dict = {}
    unresolved = []
    for rel, tree in _iter_trees(package):
        for call, arg in _site_args(tree):
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.setdefault(arg.value, rel)
            elif _generation_fstring(arg) or (
                isinstance(arg, ast.Name)
                and _resolve_name_to_fstring(tree, call, arg.id) is not None
            ):
                for tier in tiers:
                    out.setdefault(f"{tier}.generation", rel)
            else:
                unresolved.append(f"{rel}:{call.lineno}")
    assert not unresolved, (
        "maybe_fail called with a site this gate cannot resolve "
        f"statically: {unresolved}")
    return out


def _doc_sites() -> set:
    with open(DOC, encoding="utf-8") as fh:
        return set(_DOC_SITE_RE.findall(fh.read()))


def test_tier_literals_found():
    assert _tier_literals("oryx_tpu_torch") == {"batch", "speed"}


def test_every_code_site_is_documented():
    code, doc = _code_sites(), _doc_sites()
    missing = {s: rel for s, rel in code.items() if s not in doc}
    assert not missing, f"fault sites in the port absent from {DOC}: {missing}"


def test_every_documented_site_exists_in_code():
    stale = sorted(_doc_sites() - set(_code_sites()))
    assert not stale, f"documented fault sites the port never injects: {stale}"


def test_site_surface_is_nontrivial():
    code = _code_sites()
    assert len(code) >= 8, f"only found {sorted(code)}"
    assert "broker.append" in code and "serving.request" in code
    assert "batch.generation" in code and "speed.generation" in code


def test_port_sites_are_the_reference_sites():
    assert set(_code_sites()) == set(_code_sites("oryx_tpu"))
