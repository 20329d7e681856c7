"""CLI for the port's static analyzer: ``python -m oryx_tpu_torch.cli analyze``.

The port of the JAX package's ``oryx_tpu/tools/analyze/cli.py``: the same
findings mode (``--format json|text|sarif``, ``--changed``, ``--checker``,
``--baseline``, ``--no-baseline``, ``--update-baseline``, paths) and exit
codes. Changes: the default scan is the ``oryx_tpu_torch`` package rooted
at its parent, and the default baseline is
``conf/analyze-baseline-torch.json`` (never the reference's). ``--cost``,
``--bind`` and ``--protocol`` with its flags are not ported: each exits 2
with a message naming the ROADMAP item that ports it.

Below, the reference's text.

Exit code 0 when there are no unsuppressed findings, 1 otherwise (the tier-1
gate in tests/test_torch_static_analysis.py holds the port at zero). ``--format
json`` emits a machine-readable report so CI/benches can diff finding counts
across revisions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _default_paths() -> "tuple[list[str], str]":
    """(paths to scan, repo root for relpaths): the installed oryx_tpu_torch
    package, rooted at its parent so reports read ``oryx_tpu_torch/...``."""
    import oryx_tpu_torch

    pkg_dir = os.path.dirname(os.path.abspath(oryx_tpu_torch.__file__))
    return [pkg_dir], os.path.dirname(pkg_dir)


def _default_baseline(root: str) -> str:
    return os.path.join(root, "conf", "analyze-baseline-torch.json")


def _changed_relpaths(root: str) -> "set[str]":
    """ROOT-relative .py files with uncommitted changes (worktree + index)
    plus untracked files — the ``--changed`` pre-commit scope. git emits
    paths relative to its TOP-LEVEL regardless of cwd, so they are
    re-anchored onto ``root`` (finding paths are root-relative): in a
    monorepo checkout a silent mismatch here would make the gate report
    0 findings on real ones. Empty set when nothing changed; SystemExit 2
    outside a git checkout."""
    import subprocess

    def run(cmd):
        try:
            return subprocess.run(
                cmd, cwd=root, capture_output=True, text=True, check=True,
                timeout=30,
            ).stdout
        except (OSError, subprocess.SubprocessError) as e:
            print(f"--changed needs a git checkout at {root}: {e}",
                  file=sys.stderr)
            raise SystemExit(2)

    toplevel = run(["git", "rev-parse", "--show-toplevel"]).strip()
    prefix = os.path.relpath(os.path.abspath(root), toplevel).replace(
        os.sep, "/"
    )
    out: set = set()
    for cmd in (
        ["git", "diff", "--name-only", "HEAD"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        for line in run(cmd).splitlines():
            p = line.strip()
            if not p.endswith(".py"):
                continue
            if prefix not in (".", ""):
                if not p.startswith(prefix + "/"):
                    continue  # changed outside the analyze root
                p = p[len(prefix) + 1:]
            out.add(p)
    return out


#: Flags of the reference's CLI whose modes are not ported yet, with the
#: ROADMAP item that ports them.
_UNPORTED_FLAGS = {
    "--cost": "item 7d, third part: the dataflow family's dtype-widening, "
              "replicated-collective and --cost",
    "--bind": "item 7d, third part: --bind prices --cost's shape symbols",
    "--protocol": "item 7d, third part: the protocol models and "
                  "protocol-model-drift",
    "--model": "item 7d, third part: a --protocol flag",
    "--variant": "item 7d, third part: a --protocol flag",
    "--depth": "item 7d, third part: a --protocol flag",
    "--crash-budget": "item 7d, third part: a --protocol flag",
    "--time-budget": "item 7d, third part: a --protocol flag",
    "--schedule": "item 7d, third part: a --protocol flag",
}


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(
        prog="oryx-run analyze",
        description="AST static analysis of the port's torch/asyncio code "
        "(blocking in async, lock discipline, lock-order cycles, "
        "blocking under a lock, shared-state escapes, config-key drift, "
        "log discipline, swallowed exceptions, per-row stores, "
        "host-device transfers)",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to scan (default: the oryx_tpu_torch package)",
    )
    parser.add_argument(
        "--format", choices=["text", "json", "sarif"], default="text",
        help="sarif = SARIF 2.1.0 for CI code-scanning annotations",
    )
    parser.add_argument(
        "--baseline", default=None,
        help="baseline JSON of accepted findings "
        "(default: <repo>/conf/analyze-baseline-torch.json)",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="report every finding, ignoring the baseline",
    )
    parser.add_argument(
        "--update-baseline", action="store_true",
        help="write current unsuppressed findings to the baseline file as "
        "TODO-justified entries (the suite stays red until justified)",
    )
    parser.add_argument(
        "--checker", action="append", dest="checkers", metavar="ID",
        help="run only the given checker id(s); repeatable",
    )
    parser.add_argument(
        "--changed", action="store_true",
        help="report only findings in files changed per `git diff "
        "--name-only HEAD` (plus untracked .py files) — the fast "
        "pre-commit mode; the call graph still spans the whole project",
    )
    for flag in _UNPORTED_FLAGS:
        parser.add_argument(
            flag, dest="unported_" + flag[2:].replace("-", "_"),
            nargs="?", const=True, default=None, help=argparse.SUPPRESS,
        )
    args = parser.parse_args(argv)

    for flag in _UNPORTED_FLAGS:
        if getattr(args, "unported_" + flag[2:].replace("-", "_")) is not None:
            print(f"analyze {flag}: not ported yet (ROADMAP Queue 1, "
                  f"{_UNPORTED_FLAGS[flag]})", file=sys.stderr)
            return 2

    from oryx_tpu_torch.tools.analyze.core import analyze_project, write_baseline

    default_paths, root = _default_paths()
    paths = args.paths or default_paths
    baseline_path = args.baseline or _default_baseline(root)
    only_relpaths = None
    if args.changed:
        if args.update_baseline:
            # write_baseline overwrites the whole file: scoped to a diff it
            # would silently DROP every unchanged file's accepted entries
            print("--update-baseline needs a full run (a --changed-scoped "
                  "write would truncate other files' baseline entries)",
                  file=sys.stderr)
            return 2
        only_relpaths = _changed_relpaths(root)
        if not only_relpaths:
            if args.format == "json":
                print(json.dumps({
                    "findings": [], "counts": {}, "total": 0,
                    "unsuppressed": 0, "suppressed": 0, "parse_errors": [],
                }, indent=2))
            elif args.format == "sarif":
                from oryx_tpu_torch.tools.analyze.core import AnalysisResult
                from oryx_tpu_torch.tools.analyze.sarif import to_sarif

                print(json.dumps(to_sarif(AnalysisResult([], [])), indent=2))
            else:
                print("0 finding(s) (no changed .py files)")
            return 0
    result = analyze_project(
        paths,
        root=root,
        baseline_path=None if args.no_baseline else baseline_path,
        checkers=args.checkers,
        only_relpaths=only_relpaths,
    )

    if args.update_baseline:
        write_baseline(baseline_path, result.findings)
        print(f"baseline written: {baseline_path} "
              f"({len(result.unsuppressed)} entries need justification)")
        return 0

    if args.format == "json":
        print(json.dumps(result.to_dict(), indent=2))
    elif args.format == "sarif":
        from oryx_tpu_torch.tools.analyze.sarif import to_sarif

        print(json.dumps(to_sarif(result), indent=2))
    else:
        for f in result.findings:
            print(f.render())
        for err in result.parse_errors:
            print(f"PARSE ERROR: {err}", file=sys.stderr)
        n_inline = sum(1 for f in result.suppressed if f.suppressed_by == "inline")
        n_base = sum(1 for f in result.suppressed if f.suppressed_by == "baseline")
        print(
            f"{len(result.unsuppressed)} finding(s) "
            f"({len(result.suppressed)} suppressed: {n_inline} inline, "
            f"{n_base} baseline)"
        )
    if result.parse_errors:
        return 2
    return 0 if not result.unsuppressed else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
