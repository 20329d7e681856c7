"""CLI for the port's static analyzer: ``python -m oryx_tpu_torch.cli analyze``.

The port of the JAX package's ``oryx_tpu/tools/analyze/cli.py``: the same
findings mode (``--format json|text|sarif``, ``--changed``, ``--checker``,
``--baseline``, ``--no-baseline``, ``--update-baseline``, paths), the
``--cost`` / ``--bind`` static roofline and the ``--protocol`` model
checker (``--model``, ``--variant``, ``--depth``, ``--crash-budget``,
``--time-budget``, ``--schedule``), with the reference's flag guards and
exit codes. Changes: the default scan is the ``oryx_tpu_torch`` package
rooted at its parent, the default baseline is
``conf/analyze-baseline-torch.json`` (never the reference's), and
``--cost`` prints no Pallas kernel rows (the reference's
``kernelmodel.py`` is not ported: the port has no Pallas kernels).

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


def _parse_bindings(bind_args: "list[str]") -> dict:
    out: dict = {}
    for chunk in bind_args:
        for pair in chunk.split(","):
            pair = pair.strip()
            if not pair:
                continue
            sym, sep, value = pair.partition("=")
            if not sep:
                print(f"--bind needs SYM=VALUE, got {pair!r}", file=sys.stderr)
                raise SystemExit(2)
            try:
                out[sym.strip()] = float(value)
            except ValueError:
                print(f"--bind value for {sym!r} is not numeric: {value!r}",
                      file=sys.stderr)
                raise SystemExit(2)
    return out


def _fmt_cost(poly, bindings: dict) -> str:
    value = poly.evaluate(bindings) if bindings else None
    if value is not None:
        return f"{value:,.0f}"
    return poly.render() if poly else "-"


def _cost_main(paths, root, args) -> int:
    """``analyze --cost``: the static roofline table — per-program FLOPs /
    HBM bytes / collective bytes from the abstract shapes, to diff in
    review before anything runs on the card. A program is a function that
    holds a torch contraction or a per-shard region (``dataflow.py``). The
    reference's per-Pallas-kernel VMEM rows are not ported: the port has
    no Pallas kernels, and its CUDA kernels are measured on the card."""
    from oryx_tpu_torch.tools.analyze.core import build_project
    from oryx_tpu_torch.tools.analyze.dataflow import cost_report

    bindings = _parse_bindings(args.bind)
    project, errors = build_project(paths, root)
    rows = cost_report(project)
    if args.format == "json":
        payload = []
        for r in rows:
            entry = {
                "program": r["program"], "path": r["path"], "line": r["line"],
            }
            for field in ("flops", "hbm_bytes", "collective_bytes"):
                poly = r[field]
                entry[field] = {
                    "expr": poly.render(),
                    "value": poly.evaluate(bindings) if bindings else None,
                }
            payload.append(entry)
        print(json.dumps({"programs": payload, "bindings": bindings,
                          "parse_errors": errors}, indent=2))
    else:
        header = f"{'program':58s} {'flops':>24s} {'hbm_bytes':>24s} {'collective_bytes':>24s}"
        print(header)
        print("-" * len(header))
        for r in rows:
            print(f"{r['program'][:58]:58s} "
                  f"{_fmt_cost(r['flops'], bindings)[:24]:>24s} "
                  f"{_fmt_cost(r['hbm_bytes'], bindings)[:24]:>24s} "
                  f"{_fmt_cost(r['collective_bytes'], bindings)[:24]:>24s}")
        print(f"{len(rows)} program(s)"
              + (f", bound: {bindings}" if bindings else ""))
        for err in errors:
            print(f"PARSE ERROR: {err}", file=sys.stderr)
    return 2 if errors else 0


def _protocol_replay(args) -> int:
    """``analyze --protocol --schedule FIX.json``: replay a recorded
    counterexample schedule against the fixture's own (buggy) variant AND
    against HEAD, checking both outcomes against the fixture's
    expectations. Exit 0 only when both match — the CI shape of the
    regression fixtures under tests/data/protocol_schedules/."""
    from oryx_tpu_torch.tools.analyze import protocol as proto

    try:
        with open(args.schedule, "r", encoding="utf-8") as f:
            fix = json.load(f)
    except (OSError, ValueError) as e:
        print(f"--schedule: cannot load {args.schedule}: {e}", file=sys.stderr)
        return 2
    try:
        name = fix["model"]
        schedule = fix["schedule"]
    except KeyError as e:
        print(f"--schedule: fixture is missing key {e}", file=sys.stderr)
        return 2
    variant = fix.get("variant", "")

    runs = []  # (label, variant, expect_status, expect_invariant)
    runs.append((variant or "HEAD", variant, fix.get("expect"),
                 fix.get("invariant")))
    if variant and fix.get("expect_at_head"):
        # variant-only fixtures (schedules using actions HEAD does not
        # have, e.g. the split recover_mark/recover_cut) omit this key
        runs.append(("HEAD", "", fix["expect_at_head"], None))

    rc = 0
    payload = []
    for label, var, expect, expect_inv in runs:
        try:
            model = proto.build_model(name, var)
            result = proto.replay(model, schedule)
        except (KeyError, ValueError) as e:
            print(f"--schedule: {e}", file=sys.stderr)
            return 2
        got_inv = result.violation.invariant if result.violation else None
        ok = (expect is None or result.status == expect) and (
            expect_inv is None or got_inv == expect_inv
        )
        if not ok:
            rc = 1
        payload.append({
            "against": label, "status": result.status, "step": result.step,
            "action": result.action or None, "invariant": got_inv,
            "expected": expect, "ok": ok,
        })
        if args.format != "json":
            want = f" — expected {expect}" if expect else ""
            verdict = "ok" if ok else "MISMATCH"
            at = f" at step {result.step} ({result.action})" if result.step else ""
            print(f"  {label}: {result.status}{at}{want} [{verdict}]")
            if result.violation is not None:
                print(proto.render_schedule(model, result.violation))
    if args.format == "json":
        print(json.dumps({"replay": {
            "fixture": args.schedule, "model": name, "schedule": schedule,
            "runs": payload,
        }, "ok": rc == 0}, indent=2))
    return rc


def _protocol_main(args) -> int:
    """``analyze --protocol``: exhaustively explore the transport protocol
    state machines. Exit 0 when every model explores clean and complete,
    1 on an invariant/liveness violation (with a minimized numbered
    schedule), 2 when a time budget truncated the search."""
    from oryx_tpu_torch.tools.analyze import protocol as proto

    if args.schedule:
        return _protocol_replay(args)

    if args.variant and not args.model:
        print("--variant names a buggy variant of ONE model; pass --model",
              file=sys.stderr)
        return 2
    names = [args.model] if args.model else list(proto.MODELS)
    depth = args.depth if args.depth is not None else proto.TIER1_DEPTH
    rc = 0
    rows = []
    for name in names:
        try:
            model = proto.build_model(name, args.variant or "")
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        res = proto.explore(
            model, depth=depth, crash_budget=args.crash_budget,
            time_budget=args.time_budget,
        )
        rows.append((model, res))
        if not res.ok:
            rc = 1
        elif not res.complete:
            rc = max(rc, 2)

    if args.format == "json":
        payload = []
        for model, res in rows:
            entry = {
                "model": res.model, "variant": res.variant or None,
                "depth": res.depth, "crash_budget": res.crash_budget,
                "states": res.states, "transitions": res.transitions,
                "elapsed_s": round(res.elapsed, 3),
                "complete": res.complete, "ok": res.ok,
            }
            if res.violation is not None:
                v = res.violation
                entry["violation"] = {
                    "invariant": v.invariant, "message": v.message,
                    "schedule": list(v.schedule), "minimized": v.minimized,
                }
            payload.append(entry)
        print(json.dumps({"protocol": payload, "ok": rc == 0}, indent=2))
    else:
        for model, res in rows:
            if not res.ok:
                status = f"VIOLATION {res.violation.invariant}"
            elif not res.complete:
                status = "INCOMPLETE (time budget hit — raise --time-budget)"
            else:
                status = "OK"
            print(
                f"{res.model:16s} variant={res.variant or 'HEAD':22s} "
                f"depth={res.depth:2d} crash_budget={res.crash_budget} "
                f"states={res.states:7d} transitions={res.transitions:8d} "
                f"{res.elapsed:7.2f}s  {status}"
            )
            if res.violation is not None:
                print(proto.render_schedule(model, res.violation))
    return rc


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(
        prog="oryx-run analyze",
        description="AST static analysis of the port's torch/asyncio code "
        "(blocking in async, lock discipline, lock-order cycles, "
        "blocking under a lock, shared-state escapes, config-key drift, "
        "log discipline, swallowed exceptions, per-row stores, "
        "replicated collectives, host-device transfers, dtype widening, "
        "protocol-model drift) plus the --cost static roofline and the "
        "--protocol model checker. Not ported: the reference's jit and "
        "Pallas checkers and --cost's Pallas kernel rows "
        "(kernelmodel.py): the port has neither JAX tracing nor Pallas "
        "sources",
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
        "--cost", action="store_true",
        help="emit the per-program static cost table (FLOPs / HBM "
        "bytes / collective bytes as shape-symbol polynomials) instead "
        "of findings; a program is a function holding a torch "
        "contraction or a per-shard region. The reference's Pallas "
        "kernel VMEM rows are not ported",
    )
    parser.add_argument(
        "--bind", action="append", default=[], metavar="SYM=VALUE",
        help="bind shape symbols for --cost evaluation (repeatable, "
        "comma-separable): --bind y.d0=1000000,y.d1=50",
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
    parser.add_argument(
        "--protocol", action="store_true",
        help="run the protocol model checker (exhaustive exploration of "
        "the consumer-group / broker-append / checkpoint-generation "
        "state machines) instead of the AST checkers",
    )
    parser.add_argument(
        "--model", default=None, metavar="NAME",
        help="with --protocol: explore only this model "
        "(consumer-group | broker-append | ckpt-generation)",
    )
    parser.add_argument(
        "--variant", default=None, metavar="NAME",
        help="with --protocol --model: explore a buggy variant that "
        "re-introduces a historically-fixed protocol bug (the explorer "
        "should rediscover it and print the minimized schedule)",
    )
    parser.add_argument(
        "--depth", type=int, default=None, metavar="N",
        help="with --protocol: interleaving depth bound "
        "(default: the tier-1 depth, 12)",
    )
    parser.add_argument(
        "--crash-budget", type=int, default=2, metavar="N",
        help="with --protocol: crash/restart steps allowed per run "
        "(default 2)",
    )
    parser.add_argument(
        "--time-budget", type=float, default=None, metavar="SECONDS",
        help="with --protocol: cap exploration wall time; a truncated "
        "search exits 2 instead of claiming a clean full exploration",
    )
    parser.add_argument(
        "--schedule", default=None, metavar="FIXTURE.json",
        help="with --protocol: replay a recorded counterexample schedule "
        "fixture against its buggy variant AND against HEAD, checking "
        "both expected outcomes (exit 0 only when both match)",
    )
    args = parser.parse_args(argv)

    from oryx_tpu_torch.tools.analyze.core import analyze_project, write_baseline

    default_paths, root = _default_paths()
    paths = args.paths or default_paths
    baseline_path = args.baseline or _default_baseline(root)
    if args.protocol:
        # model exploration has no findings/baseline/cost surface — refuse
        # the other modes' flags instead of silently ignoring them
        bad = [flag for flag, on in (
            ("--cost", args.cost),
            ("--changed", args.changed),
            ("--update-baseline", args.update_baseline),
            ("--checker", bool(args.checkers)),
            ("--baseline", args.baseline is not None),
            ("--no-baseline", args.no_baseline),
            ("--bind", bool(args.bind)),
            ("--format sarif", args.format == "sarif"),
            ("PATHS", bool(args.paths)),
        ) if on]
        if bad:
            print("--protocol explores the protocol models, not files or "
                  f"findings; it does not combine with {', '.join(bad)}",
                  file=sys.stderr)
            return 2
        if args.schedule and (
            args.model or args.variant or args.depth is not None
        ):
            print("--schedule fixtures name their own model/variant and "
                  "fix the step sequence; drop --model/--variant/--depth",
                  file=sys.stderr)
            return 2
        return _protocol_main(args)
    for flag, on in (
        ("--model", args.model is not None),
        ("--variant", args.variant is not None),
        ("--depth", args.depth is not None),
        ("--time-budget", args.time_budget is not None),
        ("--schedule", args.schedule is not None),
    ):
        if on:
            print(f"{flag} only applies to --protocol", file=sys.stderr)
            return 2
    if args.cost:
        # refuse findings-mode flags instead of silently dropping them: an
        # operator typing `--cost --changed` would otherwise believe the
        # table was diff-scoped, and `--cost --update-baseline` would exit
        # 0 having written nothing
        bad = [flag for flag, on in (
            ("--changed", args.changed),
            ("--update-baseline", args.update_baseline),
            ("--checker", bool(args.checkers)),
            ("--baseline", args.baseline is not None),
            ("--no-baseline", args.no_baseline),
            ("--format sarif", args.format == "sarif"),
        ) if on]
        if bad:
            print("--cost prices programs, not findings; it does not "
                  f"combine with {', '.join(bad)}", file=sys.stderr)
            return 2
        return _cost_main(paths, root, args)
    if args.bind:
        print("--bind only applies to --cost", file=sys.stderr)
        return 2
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
