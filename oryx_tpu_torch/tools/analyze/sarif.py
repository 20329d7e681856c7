"""SARIF 2.1.0 rendering of an analysis result (stdlib-only).

A copy of the JAX package's ``oryx_tpu/tools/analyze/sarif.py``: the same
document, tool name and fingerprints. Below, the reference's text.

``analyze --format sarif`` emits one run whose results are the UNSUPPRESSED
findings — suppressed/baselined findings are carried with
``suppressions[]`` entries so code-scanning UIs show them as reviewed, not
open. With ``--changed`` the scoped findings render as inline PR
annotations through GitHub's ``upload-sarif`` action (wiring documented in
docs/static_analysis.md).
"""

from __future__ import annotations

_SARIF_VERSION = "2.1.0"
_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
           "Schemata/sarif-schema-2.1.0.json")


def to_sarif(result, tool_version: str = "1") -> dict:
    """One SARIF run from an :class:`core.AnalysisResult`. Paths are
    repo-relative with ``%SRCROOT%`` as the uriBase, which is what
    github/codeql-action/upload-sarif resolves against the checkout."""
    rule_ids = sorted({f.checker for f in result.findings})
    rules = [
        {
            "id": rid,
            "name": rid.replace("-", " ").title().replace(" ", ""),
            "defaultConfiguration": {"level": "error"},
            "helpUri": "docs/static_analysis.md",
        }
        for rid in rule_ids
    ]
    rule_index = {rid: i for i, rid in enumerate(rule_ids)}
    results = []
    for f in result.findings:
        entry = {
            "ruleId": f.checker,
            "ruleIndex": rule_index[f.checker],
            "level": "error" if f.suppressed_by is None else "note",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path,
                        "uriBaseId": "%SRCROOT%",
                    },
                    "region": {"startLine": max(1, f.line)},
                },
            }],
            "partialFingerprints": {
                # the baseline identity: stable across line churn
                "oryxAnalyzeSymbol/v1": f"{f.checker}:{f.path}:"
                                        f"{f.symbol or f.message}",
            },
        }
        if f.suppressed_by is not None:
            entry["suppressions"] = [{
                "kind": "inSource" if f.suppressed_by == "inline"
                        else "external",
                "justification": f.justification or "",
            }]
        results.append(entry)
    return {
        "$schema": _SCHEMA,
        "version": _SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "oryx-analyze",
                    "informationUri": "docs/static_analysis.md",
                    "version": str(tool_version),
                    "rules": rules,
                },
            },
            "results": results,
            "columnKind": "utf16CodeUnits",
        }],
    }
