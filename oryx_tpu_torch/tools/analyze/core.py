"""Analysis core: findings, suppressions, baselines, per-file AST context.

The port of the JAX package's ``oryx_tpu/tools/analyze/core.py`` (stdlib
only; it imports nothing of that package), held to it by
``tests/test_torch_static_analysis.py``. Changes:

  * No jit scopes: the port traces nothing, so the jitted-scope map, its
    static-argument sets and the traced-value inference (read only by the
    jit-recompile, tracer-leak, float64-promotion and Pallas checkers,
    which are not ported) are gone.
  * The reference configuration and the checker registry are the port's
    (``oryx_tpu_torch.common.reference_conf``,
    ``oryx_tpu_torch.tools.analyze.checkers``); the default baseline is
    ``conf/analyze-baseline-torch.json`` (``cli.py``).

Below, the reference's text.

Design: one :class:`FileContext` per source file carries everything a checker
needs (AST, resolved import aliases, async scopes, inline suppressions); a :class:`ProjectContext` carries
the cross-file facts (all file contexts, the canonical config-key tree).
Checkers are small classes over those contexts; everything is stdlib-only so
the analyzer can run in CI without torch ever importing.

Suppression surfaces (both REQUIRE a justification string, enforced by the
``suppression-hygiene`` meta-check):

  * inline:   ``# analyze: ignore[<checker-id>] -- why this is fine``
    (on the finding's line, or alone on the line above)
  * baseline: entries in ``conf/analyze-baseline-torch.json`` matched by
    (checker, path, symbol) — line-independent so unrelated edits don't
    churn the file.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Iterable

_SUPPRESS_RE = re.compile(
    r"#\s*analyze:\s*ignore\[([a-zA-Z0-9_\-, *]+)\]\s*(?:--\s*(.*\S))?\s*$"
)


def walk_scope(fn_node: ast.AST):
    """ast.walk that does NOT descend into nested function bodies — those are
    separate scopes."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def module_name(relpath: str) -> str:
    """Repo-relative path -> dotted module name (packages drop __init__)."""
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def module_map(project) -> dict:
    """Dotted module name -> FileContext for every file in the project
    (memoized on the project: every reachability checker needs it)."""
    cached = getattr(project, "_module_map", None)
    if cached is None:
        cached = {module_name(fctx.relpath): fctx for fctx in project.files}
        project._module_map = cached
    return cached


def method_classes(fctx) -> dict:
    """Immediate method node -> owning class node (for self.method edges).
    Memoized on the file context — shared by every call-graph consumer."""
    cached = getattr(fctx, "_method_classes", None)
    if cached is None:
        cached = {}
        for _, cnode in fctx.classes:
            for child in cnode.body:
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    cached[child] = cnode
        fctx._method_classes = cached
    return cached


def scope_nodes(fctx, fn_node) -> list:
    """The ``walk_scope`` node list of one function, parsed ONCE per run and
    cached on the file context. Every checker that inspects function bodies
    (blocking-async, compile-on-hot-path, the concurrency family, the call
    graph itself) shares this list instead of re-walking the tree."""
    cache = getattr(fctx, "_scope_nodes", None)
    if cache is None:
        cache = fctx._scope_nodes = {}
    nodes = cache.get(fn_node)
    if nodes is None:
        nodes = cache[fn_node] = list(walk_scope(fn_node))
    return nodes


def call_edges(fctx, fn, fn_class: dict, module_of: dict) -> list:
    """Resolvable call edges out of one function: local functions,
    from-imports of project functions, ``module.fn``, and ``self.method``.
    Returns (call_line, (relpath, qualname), display_label) triples — the
    shared reachability substrate of the blocking-async and
    compile-on-hot-path checkers. Callables merely REFERENCED (e.g. handed
    to run_in_executor) are not calls and produce no edge."""
    out = []
    for node in scope_nodes(fctx, fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Name):
            # local function, or from-import of a project function
            local = fctx.functions_by_name.get(func.id)
            if local:
                target = min(local, key=lambda n: fctx.qualname_of[n].count("."))
                out.append((node.lineno, (fctx.relpath, fctx.qualname_of[target]),
                            f"`{func.id}()`"))
                continue
            origin = fctx.import_map.get(func.id)
            if origin and "." in origin:
                mod, _, name = origin.rpartition(".")
                target_fctx = module_of.get(mod)
                if target_fctx is not None and name in target_fctx.functions_by_name:
                    t = target_fctx.functions_by_name[name][0]
                    out.append((node.lineno,
                                (target_fctx.relpath, target_fctx.qualname_of[t]),
                                f"`{func.id}()`"))
        elif isinstance(func, ast.Attribute):
            if isinstance(func.value, ast.Name) and func.value.id == "self":
                cnode = fn_class.get(fn)
                if cnode is not None:
                    for child in cnode.body:
                        if (
                            isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                            and child.name == func.attr
                        ):
                            out.append((node.lineno,
                                        (fctx.relpath, fctx.qualname_of[child]),
                                        f"`self.{func.attr}()`"))
                            break
                continue
            resolved = fctx.resolve(func)
            if resolved and "." in resolved:
                mod, _, name = resolved.rpartition(".")
                target_fctx = module_of.get(mod)
                if target_fctx is not None and name in target_fctx.functions_by_name:
                    t = target_fctx.functions_by_name[name][0]
                    out.append((node.lineno,
                                (target_fctx.relpath, target_fctx.qualname_of[t]),
                                f"`{ast.unparse(func)}()`"))
    return out


class CallGraph:
    """Project-wide call-graph facts, computed ONCE per analysis run and
    shared by every reachability checker (blocking-async,
    compile-on-hot-path, the whole concurrency family). Before this cache
    each of those checkers re-derived the same edges from a fresh AST walk
    per checker; now the tree is walked once and the derived facts ride
    along on the :class:`ProjectContext`.

    ``edges``: (relpath, qualname) -> [(call_line, callee_key, label)]
    ``async_keys``: keys of every ``async def`` in the project
    ``functions``: key -> (fctx, fn_node) for direct body inspection
    """

    __slots__ = ("module_of", "edges", "async_keys", "functions")

    def __init__(self, project: "ProjectContext"):
        self.module_of = module_map(project)
        self.edges: dict = {}
        self.async_keys: set = set()
        self.functions: dict = {}
        for fctx in project.files:
            fn_class = method_classes(fctx)
            for qual, fn in fctx.functions:
                key = (fctx.relpath, qual)
                if isinstance(fn, ast.AsyncFunctionDef):
                    self.async_keys.add(key)
                self.functions[key] = (fctx, fn)
                self.edges[key] = call_edges(fctx, fn, fn_class, self.module_of)
        self._add_attr_typed_edges(project)

    def _add_attr_typed_edges(self, project: "ProjectContext") -> None:
        """``self.X.method()`` edges where ``self.X`` has exactly one
        class-typed assignment (``self.X = SomeProjectClass(...)``) anywhere
        in the owning class. This is how a store's public method reaches its
        helper object's internals (a probe loop in a helper index class,
        reached via ``self._ids.lookup()`` under the store lock) — without these edges every composed-helper call is a
        blind spot for all reachability checkers."""
        # class name -> (fctx, cqual, cnode), per file (last definition wins)
        local_classes: dict = {}
        for fctx in project.files:
            local_classes[fctx.relpath] = {
                cqual.rsplit(".", 1)[-1]: (fctx, cqual, cnode)
                for cqual, cnode in fctx.classes
            }

        def resolve_class(fctx, ctor_node):
            resolved = fctx.resolve(ctor_node)
            if not resolved:
                return None
            if "." not in resolved:
                return local_classes.get(fctx.relpath, {}).get(resolved)
            mod, _, name = resolved.rpartition(".")
            target_fctx = self.module_of.get(mod)
            if target_fctx is None:
                return None
            return local_classes.get(target_fctx.relpath, {}).get(name)

        for fctx in project.files:
            fn_class = method_classes(fctx)
            # per class: attr -> target class, None when ambiguous
            attr_types: dict = {}
            for fn, cnode in fn_class.items():
                types = attr_types.setdefault(id(cnode), {})
                for node in scope_nodes(fctx, fn):
                    if not (isinstance(node, ast.Assign)
                            and isinstance(node.value, ast.Call)):
                        continue
                    target = resolve_class(fctx, node.value.func)
                    if target is None:
                        continue
                    for t in node.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            prev = types.get(t.attr)
                            if prev is not None and prev != target:
                                types[t.attr] = None  # ambiguous: no edges
                            elif prev is None and t.attr not in types:
                                types[t.attr] = target
            for fn, cnode in fn_class.items():
                types = attr_types.get(id(cnode), {})
                if not types:
                    continue
                key = (fctx.relpath, fctx.qualname_of[fn])
                for node in scope_nodes(fctx, fn):
                    if not (
                        isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Attribute)
                        and isinstance(node.func.value.value, ast.Name)
                        and node.func.value.value.id == "self"
                    ):
                        continue
                    target = types.get(node.func.value.attr)
                    if target is None:
                        continue
                    tfctx, tcqual, tcnode = target
                    for child in tcnode.body:
                        if (
                            isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                            and child.name == node.func.attr
                        ):
                            self.edges[key].append((
                                node.lineno,
                                (tfctx.relpath, f"{tcqual}.{child.name}"),
                                f"`self.{node.func.value.attr}."
                                f"{node.func.attr}()`",
                            ))
                            break

    def propagate(self, facts: dict, edges: "dict | None" = None) -> dict:
        """Fixpoint closure of per-function facts over the call graph: a
        function whose callee carries a fact inherits (line, "label ->
        cause") at the first such call site. ``facts`` maps key ->
        (line, cause) for functions with a DIRECT fact; returns the
        transitive map (callees' facts flowing up through callers).
        ``edges`` substitutes a filtered edge map (hotcompile drops edges
        into the warmup subsystem; the concurrency pass drops edges to
        async/generator callees) — one closure algorithm, every caller."""
        edge_map = self.edges if edges is None else edges
        out = dict(facts)
        changed = True
        while changed:
            changed = False
            for key, outs in edge_map.items():
                if key in out:
                    continue
                for line, callee, label in outs:
                    if callee in out:
                        _, cause = out[callee]
                        out[key] = (line, f"{label} -> {cause}")
                        changed = True
                        break
        return out


@dataclasses.dataclass
class Finding:
    checker: str
    path: str  # repo-relative, '/'-separated
    line: int
    message: str
    # stable anchor for baseline matching (function/class/config key); falls
    # back to the message so every finding is baseline-able
    symbol: str = ""
    suppressed_by: "str | None" = None  # None | "inline" | "baseline"
    justification: str = ""

    @property
    def baseline_key(self) -> tuple:
        return (self.checker, self.path, self.symbol or self.message)

    def to_dict(self) -> dict:
        return {
            "checker": self.checker,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "suppressed_by": self.suppressed_by,
            "justification": self.justification,
        }

    def render(self) -> str:
        sup = f"  [suppressed: {self.suppressed_by}]" if self.suppressed_by else ""
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}{sup}"


class _Suppression:
    __slots__ = ("checkers", "justification", "used")

    def __init__(self, checkers: set, justification: str):
        self.checkers = checkers
        self.justification = justification
        self.used = False

    def matches(self, checker: str) -> bool:
        return "*" in self.checkers or checker in self.checkers


def _parse_suppressions(lines: list) -> dict:
    """line number -> _Suppression. A comment-only suppression line applies
    to the next line; a trailing comment applies to its own line."""
    out: dict[int, _Suppression] = {}
    for i, raw in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(raw)
        if not m:
            continue
        ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
        sup = _Suppression(ids, (m.group(2) or "").strip())
        target = i + 1 if raw.lstrip().startswith("#") else i
        out[target] = sup
    return out


# ---------------------------------------------------------------------------
# Name resolution
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> "str | None":
    """``torch.nn.functional.softmax`` -> that string; None if the
    expression is not a plain name/attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class FileContext:
    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        self.suppressions = _parse_suppressions(self.lines)
        # local alias -> dotted origin ("np" -> "numpy", "F" -> "torch.nn.functional")
        self.import_map: dict[str, str] = {}
        # bare function name -> FunctionDef nodes in this module (all scopes)
        self.functions_by_name: dict[str, list] = {}
        self.functions: list = []  # (qualname, node)
        self.async_functions: list = []  # (qualname, node)
        self.classes: list = []  # (qualname, node)
        self._collect()

    # -- imports / names ----------------------------------------------------
    def _collect(self) -> None:
        # One scoped traversal gathers imports and qualnames — a second
        # full ast.walk per concern is the analyzer's hottest cost.
        import_map = self.import_map

        def walk(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    self.functions.append((qual, child))
                    self.functions_by_name.setdefault(child.name, []).append(child)
                    if isinstance(child, ast.AsyncFunctionDef):
                        self.async_functions.append((qual, child))
                    walk(child, qual + ".")
                elif isinstance(child, ast.ClassDef):
                    self.classes.append((f"{prefix}{child.name}", child))
                    walk(child, f"{prefix}{child.name}.")
                else:
                    if isinstance(child, ast.Import):
                        for alias in child.names:
                            import_map[alias.asname or alias.name.split(".")[0]] = (
                                alias.name if alias.asname else alias.name.split(".")[0]
                            )
                    elif (
                        isinstance(child, ast.ImportFrom)
                        and child.module
                        and child.level == 0
                    ):
                        for alias in child.names:
                            import_map[alias.asname or alias.name] = (
                                f"{child.module}.{alias.name}"
                            )
                    walk(child, prefix)

        walk(self.tree, "")
        self.qualname_of = {node: q for q, node in self.functions}

    def resolve(self, node: ast.AST) -> "str | None":
        """Resolve a call target to its fully-qualified origin where the
        import map allows (``np.asarray`` -> ``numpy.asarray``)."""
        name = dotted_name(node)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        origin = self.import_map.get(head, head)
        return f"{origin}.{rest}" if rest else origin

    # -- findings -----------------------------------------------------------
    def finding(self, checker: str, node_or_line, message: str, symbol: str = "") -> Finding:
        line = (
            node_or_line
            if isinstance(node_or_line, int)
            else getattr(node_or_line, "lineno", 1)
        )
        return Finding(checker, self.relpath, line, message, symbol)


class ProjectContext:
    def __init__(self, files: list, reference_conf_text: "str | None" = None):
        self.files: list[FileContext] = files
        self.by_relpath = {f.relpath: f for f in files}
        self._reference_conf_text = reference_conf_text
        self._call_graph: "CallGraph | None" = None

    def call_graph(self) -> CallGraph:
        """The shared project call graph, built on first use and reused by
        every checker in the run."""
        if self._call_graph is None:
            self._call_graph = CallGraph(self)
        return self._call_graph

    def reference_conf_text(self) -> str:
        if self._reference_conf_text is not None:
            return self._reference_conf_text
        from oryx_tpu_torch.common import reference_conf

        return reference_conf.REFERENCE_CONF


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def load_baseline(path: str) -> dict:
    """(checker, path, symbol) -> {justification, version}. Empty when
    absent. ``version`` defaults to 1 (pre-versioning entries)."""
    if not path or not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    out = {}
    for e in data.get("entries", []):
        out[(e["checker"], e["path"], e["symbol"])] = {
            "justification": e.get("justification", ""),
            "version": int(e.get("version", 1)),
        }
    return out


def checker_versions() -> dict:
    from oryx_tpu_torch.tools.analyze.checkers import CHECKER_VERSIONS

    return CHECKER_VERSIONS


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    """Skeleton baseline from current unsuppressed findings; justifications
    start as TODO and the suppression-hygiene check fails until they are
    written by a human. Each entry records the CURRENT checker version so
    a later precision upgrade invalidates the justification loudly instead
    of silently re-accepting it against semantics nobody reviewed."""
    versions = checker_versions()
    entries = [
        {
            "checker": f.checker,
            "path": f.path,
            "symbol": f.symbol or f.message,
            "justification": "TODO: justify this accepted finding",
            "version": versions.get(f.checker, 1),
        }
        for f in findings
        # hygiene meta-findings are generated after baseline matching and
        # can never be suppressed by an entry — writing them would leave a
        # dead "accepted" record while the CLI stays red
        if f.suppressed_by is None and f.checker != "suppression-hygiene"
    ]
    entries.sort(key=lambda e: (e["checker"], e["path"], e["symbol"]))
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"entries": entries}, f, indent=2)
        f.write("\n")


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AnalysisResult:
    findings: list
    parse_errors: list

    @property
    def unsuppressed(self) -> list:
        return [f for f in self.findings if f.suppressed_by is None]

    @property
    def suppressed(self) -> list:
        return [f for f in self.findings if f.suppressed_by is not None]

    def to_dict(self) -> dict:
        counts: dict[str, int] = {}
        for f in self.unsuppressed:
            counts[f.checker] = counts.get(f.checker, 0) + 1
        return {
            "findings": [f.to_dict() for f in self.findings],
            "counts": counts,
            "total": len(self.findings),
            "unsuppressed": len(self.unsuppressed),
            "suppressed": len(self.suppressed),
            "parse_errors": self.parse_errors,
        }


def _iter_py_files(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


def build_project(
    paths: Iterable[str],
    root: "str | None" = None,
    reference_conf_text: "str | None" = None,
) -> "tuple[ProjectContext, list]":
    files, errors = [], []
    for path in _iter_py_files(paths):
        rel = os.path.relpath(path, root) if root else path
        rel = rel.replace(os.sep, "/")
        try:
            with open(path, "r", encoding="utf-8") as f:
                src = f.read()
            files.append(FileContext(path, rel, src))
        except (SyntaxError, UnicodeDecodeError) as e:
            errors.append(f"{rel}: {e}")
    return ProjectContext(files, reference_conf_text), errors


def _apply_suppressions(
    project: ProjectContext,
    findings: list,
    baseline: dict,
    versions: "dict | None" = None,
) -> list:
    versions = versions if versions is not None else checker_versions()
    hygiene: list[Finding] = []
    for f in findings:
        fctx = project.by_relpath.get(f.path)
        sup = None
        if fctx is not None:
            cand = fctx.suppressions.get(f.line)
            if cand is not None and cand.matches(f.checker):
                sup = cand
        if sup is not None:
            sup.used = True
            f.suppressed_by = "inline"
            f.justification = sup.justification
            if not sup.justification:
                hygiene.append(
                    Finding(
                        "suppression-hygiene",
                        f.path,
                        f.line,
                        f"inline suppression of [{f.checker}] carries no "
                        "justification (write `# analyze: ignore[...] -- why`)",
                        symbol=f"{f.checker}:{f.symbol or f.message}",
                    )
                )
            continue
        entry = baseline.get(f.baseline_key)
        if entry is not None:
            current = versions.get(f.checker, 1)
            if entry["version"] != current:
                # a checker precision upgrade means the accepted finding may
                # not be the same finding any more: the justification goes
                # STALE loudly — the original finding stays unsuppressed and
                # the entry must be re-adjudicated (re-justify + bump, or
                # delete if the upgrade fixed the false positive)
                hygiene.append(
                    Finding(
                        "suppression-hygiene",
                        f.path,
                        f.line,
                        f"baseline entry for [{f.checker}] "
                        f"{f.symbol or f.message!r} was justified against "
                        f"checker v{entry['version']} but the checker is "
                        f"now v{current} — re-adjudicate the finding and "
                        "update the entry's version",
                        symbol=f"{f.checker}:{f.symbol or f.message}:version",
                    )
                )
                continue
            just = entry["justification"]
            f.suppressed_by = "baseline"
            f.justification = just
            if not just or just.startswith("TODO"):
                hygiene.append(
                    Finding(
                        "suppression-hygiene",
                        f.path,
                        f.line,
                        f"baseline entry for [{f.checker}] {f.symbol or f.message!r} "
                        "has no justification",
                        symbol=f"{f.checker}:{f.symbol or f.message}",
                    )
                )
    return hygiene


def _unused_suppressions(project: ProjectContext) -> list:
    """A `# analyze: ignore[...]` whose finding no longer fires is stale —
    left in place it would silently mask the next regression on that line."""
    out = []
    for fctx in project.files:
        for line, sup in sorted(fctx.suppressions.items()):
            if not sup.used:
                ids = ",".join(sorted(sup.checkers))
                out.append(Finding(
                    "suppression-hygiene", fctx.relpath, line,
                    f"stale suppression: no [{ids}] finding fires here any "
                    "more — remove the comment so it cannot mask a future "
                    "regression",
                    symbol=f"stale:{ids}:{line}",
                ))
    return out


def analyze_project(
    paths: Iterable[str],
    root: "str | None" = None,
    baseline_path: "str | None" = None,
    checkers: "Iterable[str] | None" = None,
    reference_conf_text: "str | None" = None,
    only_relpaths: "set | None" = None,
) -> AnalysisResult:
    """Analyze ``paths``. ``only_relpaths`` scopes the REPORT to those
    repo-relative files (``analyze --changed``): the whole project is still
    parsed and the call graph still spans every file — cross-file
    reachability must not shrink with the diff — only findings (and stale-
    suppression hygiene) outside the set are dropped."""
    from oryx_tpu_torch.tools.analyze.checkers import ALL_CHECKERS

    project, errors = build_project(paths, root, reference_conf_text)
    wanted = set(checkers) if checkers else None
    findings: list[Finding] = []
    for checker in ALL_CHECKERS:
        if wanted is not None and checker.id not in wanted:
            continue
        findings.extend(checker.check(project))
    if only_relpaths is not None:
        findings = [f for f in findings if f.path in only_relpaths]
    findings.sort(key=lambda f: (f.path, f.line, f.checker))
    baseline = load_baseline(baseline_path) if baseline_path else {}
    findings.extend(_apply_suppressions(project, findings, baseline))
    if wanted is None and only_relpaths is None:
        # partial runs (by checker or by diff) would false-flag stale
        findings.extend(_unused_suppressions(project))
    elif wanted is None:
        findings.extend(
            f for f in _unused_suppressions(project)
            if f.path in only_relpaths
        )
    return AnalysisResult(findings, errors)


def analyze_source(
    source: str,
    filename: str = "fixture.py",
    checkers: "Iterable[str] | None" = None,
    reference_conf_text: "str | None" = None,
    extra_sources: "dict[str, str] | None" = None,
) -> list:
    """Analyze in-memory source (fixture tests); returns raw findings with
    inline suppressions applied but no baseline."""
    from oryx_tpu_torch.tools.analyze.checkers import ALL_CHECKERS

    files = [FileContext(filename, filename, source)]
    for rel, src in (extra_sources or {}).items():
        files.append(FileContext(rel, rel, src))
    project = ProjectContext(files, reference_conf_text)
    wanted = set(checkers) if checkers else None
    findings: list[Finding] = []
    for checker in ALL_CHECKERS:
        if wanted is not None and checker.id not in wanted:
            continue
        findings.extend(checker.check(project))
    findings.sort(key=lambda f: (f.path, f.line, f.checker))
    findings.extend(_apply_suppressions(project, findings, {}))
    if wanted is None:
        findings.extend(_unused_suppressions(project))
    return findings
