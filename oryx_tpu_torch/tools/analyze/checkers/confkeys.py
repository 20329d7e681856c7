"""config-key-drift: the oryx.* key surface must match reference_conf.

The port of the JAX package's ``oryx_tpu/tools/analyze/checkers/confkeys.py``
over the port's own key tree: the configuration parser and the reference
text are ``oryx_tpu_torch.common``'s, and unread keys are reported at
``oryx_tpu_torch/common/reference_conf.py``. Below, the reference's text.

Two directions (both are real bugs in a convention-typed config tree):

  * **unknown key** — code reads an ``oryx.*`` key that does not exist in
    ``common/reference_conf.py``. With a default argument the typo silently
    disables the knob forever; without one it is a runtime ConfigError on a
    path nobody tested.
  * **unread key** — a key declared in reference_conf that no code reads:
    a dead knob an operator can set with no effect (or the fossil of a
    rename that left the old spelling behind).

Read detection is AST-based: literal first arguments of
``get/get_string/get_int/get_float/get_bool/get_list/get_config/has`` calls,
f-string keys (``f"oryx.{tier}.streaming..."`` becomes a one-segment
wildcard), relative reads through a tracked ``get_config("oryx.x")``
variable, loose ``oryx.*`` string literals anywhere in code (constants such
as routing keys), and ``${oryx.*}`` substitutions inside the reference text
itself.
"""

from __future__ import annotations

import ast
import re

from oryx_tpu_torch.tools.analyze.core import Finding

ID = "config-key-drift"

_GETTERS = {
    "get", "get_string", "get_int", "get_float", "get_bool", "get_list",
    "get_config", "has",
}

_SUBST_RE = re.compile(r"\$\{\??\s*(oryx\.[^}]+?)\s*\}")

# best-effort line numbers for keys inside the reference HOCON text
_KEY_LINE_RE = re.compile(r"^(\s*)([A-Za-z0-9_\-]+)\s*(=|\{|:)")
_INLINE_OBJ_RE = re.compile(r"([A-Za-z0-9_\-]+)\s*=")


def _fstring_pattern(node: ast.JoinedStr) -> "str | None":
    """f"oryx.{tk}.broker" -> regex ``oryx\\.[^.]+\\.broker`` (each hole spans
    one dotted segment); None when the literal head is not oryx."""
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(re.escape(v.value))
        elif isinstance(v, ast.FormattedValue):
            parts.append(r"[^.]+")
        else:
            return None
    pattern = "".join(parts)
    return pattern if pattern.startswith("oryx\\.") else None


def _flatten_conf(text: str) -> dict:
    """key -> best-effort line number in the reference text."""
    from oryx_tpu_torch.common.config import Config

    flat = dict(Config.parse_string(text).flatten())
    lines_of: dict[str, int] = {}
    stack: list[str] = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        stripped = raw.split("#", 1)[0].strip()
        if not stripped:
            continue
        m = _KEY_LINE_RE.match(raw)
        if m:
            key = m.group(2)
            path = ".".join([*stack, key])
            if "{" in stripped and "}" not in stripped:
                stack.append(key)
            elif "{" in stripped and "}" in stripped:
                # inline object: `lock = { master = "memory:" }`
                inner = stripped[stripped.index("{") + 1:]
                for im in _INLINE_OBJ_RE.finditer(inner):
                    lines_of.setdefault(f"{path}.{im.group(1)}", lineno)
            else:
                lines_of.setdefault(path, lineno)
        # net close braces pop enclosing objects (same-line open+close nets 0)
        for _ in range(max(0, stripped.count("}") - stripped.count("{"))):
            if stack:
                stack.pop()
    return {k: lines_of.get(k, 1) for k in flat}


class ConfigKeyDriftChecker:
    id = ID

    def check(self, project) -> list:
        conf_text = project.reference_conf_text()
        key_lines = _flatten_conf(conf_text)
        flat_keys = set(key_lines)

        strict: list = []  # (key_or_None, pattern_or_None, fctx, line)
        loose_literals: set = set()
        loose_patterns: set = set()
        for m in _SUBST_RE.finditer(conf_text):
            loose_literals.add(m.group(1))

        for fctx in project.files:
            self._collect_file(fctx, strict, loose_literals, loose_patterns)

        out = []
        # -- unknown keys ----------------------------------------------------
        for key, pattern, fctx, line in strict:
            if key is not None:
                ok = key in flat_keys or any(
                    k.startswith(key + ".") for k in flat_keys
                )
                if not ok:
                    out.append(fctx.finding(
                        ID, line,
                        f"config key {key!r} is read here but does not exist "
                        "in common/reference_conf.py — typo'd or dropped knob",
                        symbol=key,
                    ))
            elif pattern is not None:
                ok = any(
                    re.fullmatch(pattern, k) or re.match(pattern + r"\.", k)
                    for k in flat_keys
                )
                if not ok:
                    out.append(fctx.finding(
                        ID, line,
                        f"config key pattern `{pattern}` matches no key in "
                        "common/reference_conf.py",
                        symbol=pattern,
                    ))

        # -- unread keys -----------------------------------------------------
        read_exact = {k for k, _, _, _ in strict if k is not None} | loose_literals
        read_patterns = [p for _, p, _, _ in strict if p is not None]
        read_patterns.extend(loose_patterns)
        conf_relpath = self._conf_relpath(project)
        # map conf-text line numbers onto the .py file holding the string
        conf_fctx = project.by_relpath.get(conf_relpath)
        line_offset = 0
        if conf_fctx is not None:
            for i, raw in enumerate(conf_fctx.lines, start=1):
                if "REFERENCE_CONF" in raw and '"""' in raw:
                    line_offset = i - 1
                    break
        for key in sorted(flat_keys):
            if key in read_exact:
                continue
            if any(key.startswith(p + ".") for p in read_exact):
                continue
            if any(
                re.fullmatch(p, key) or re.match(p + r"\.", key)
                for p in read_patterns
            ):
                continue
            out.append(Finding(
                ID, conf_relpath, key_lines[key] + line_offset,
                f"config key {key!r} is declared in reference_conf but never "
                "read anywhere — dead knob (wire it or remove it)",
                symbol=key,
            ))
        return out

    @staticmethod
    def _conf_relpath(project) -> str:
        for rel in project.by_relpath:
            if rel.endswith("common/reference_conf.py"):
                return rel
        return "oryx_tpu_torch/common/reference_conf.py"

    def _collect_file(self, fctx, strict, loose_literals, loose_patterns) -> None:
        # One walk gathers everything; getter calls are replayed after so
        # prefix tracking still sees assignments that follow a use site.
        # (ast.walk is breadth-first, so a scope node is always seen
        # before its docstring Constant.)
        docstrings = set()
        prefixes: dict[str, str] = {}
        getter_calls: list = []
        for node in ast.walk(fctx.tree):
            if isinstance(node, ast.Constant):
                if (
                    isinstance(node.value, str)
                    and node.value.startswith("oryx.")
                    and node not in docstrings
                ):
                    val = node.value.rstrip(".")
                    if "." in val:  # bare "oryx" would prefix-mask every key
                        loose_literals.add(val)
            elif isinstance(node, ast.Call):
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _GETTERS
                    and node.args
                ):
                    getter_calls.append(node)
            elif isinstance(node, ast.JoinedStr):
                p = _fstring_pattern(node)
                if p:
                    loose_patterns.add(p)
            elif isinstance(node, ast.Assign):
                call = node.value
                if (
                    isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr == "get_config"
                    and call.args
                    and isinstance(call.args[0], ast.Constant)
                    and isinstance(call.args[0].value, str)
                    and call.args[0].value.startswith("oryx.")
                ):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            prefixes[t.id] = call.args[0].value
            elif isinstance(
                node,
                (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef),
            ):
                body = getattr(node, "body", [])
                if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant
                ):
                    docstrings.add(body[0].value)

        for node in getter_calls:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                key = arg.value
                if key.startswith("oryx."):
                    strict.append((key, None, fctx, node.lineno))
                elif (
                    isinstance(node.func.value, ast.Name)
                    and node.func.value.id in prefixes
                ):
                    strict.append((
                        f"{prefixes[node.func.value.id]}.{key}", None, fctx,
                        node.lineno,
                    ))
            elif isinstance(arg, ast.JoinedStr):
                p = _fstring_pattern(arg)
                if p:
                    strict.append((None, p, fctx, node.lineno))
