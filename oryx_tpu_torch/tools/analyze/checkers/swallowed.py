"""swallowed-exception: broad catches in hot paths must re-raise or log
(docs/robustness.md: failures degrade loudly, never silently).

The port of the JAX package's ``oryx_tpu/tools/analyze/checkers/swallowed.py``
over the port's hot paths (``oryx_tpu_torch/{serving,transport,lambda_rt}/``).
Below, the reference's text.

A ``except Exception:`` (or bare ``except:`` / ``except BaseException:``)
whose body neither re-raises, logs, nor records the exception erases a
failure from every observability surface at once: no log line, no span
status, no metric — the bug ships as silence. In the serving/transport/
lambda_rt hot paths (where this framework's whole robustness story is
"degrade loudly, never silently"), that pattern is treated as a defect.

A handler is compliant when its body (nested scopes included) contains any
of: a ``raise``, a call to a logging method (``debug``/``info``/``warning``/
``error``/``exception``/``critical``/``log``), or a
``span.record_exception(...)`` call. NARROW catches (``except ValueError:``,
``except FileNotFoundError:``) are deliberate control flow and stay out of
scope — the checker targets the catch-everything-say-nothing shape.

Intentional broad swallows (e.g. advisory scrape-time probes where a log
per scrape would flood) carry the standard inline suppression comment
(``analyze: ignore`` with this checker's id and a justification).
"""

from __future__ import annotations

import ast

ID = "swallowed-exception"

#: Repo-relative path prefixes where silent failure is unacceptable (the
#: same hot-path scope as the log-discipline checker).
HOT_PATH_PREFIXES = (
    "oryx_tpu_torch/serving/",
    "oryx_tpu_torch/transport/",
    "oryx_tpu_torch/lambda_rt/",
)

_BROAD = {"Exception", "BaseException"}
_LOG_METHODS = {
    "debug", "info", "warning", "error", "exception", "critical", "log",
    "record_exception",
}


def _is_broad(handler: ast.ExceptHandler, fctx) -> bool:
    """Bare except, Exception/BaseException, or a tuple containing one."""
    t = handler.type
    if t is None:
        return True
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for node in types:
        if isinstance(node, ast.Name) and node.id in _BROAD:
            return True
        resolved = fctx.resolve(node)
        if resolved in ("builtins.Exception", "builtins.BaseException"):
            return True
    return False


def _is_handled(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _LOG_METHODS
        ):
            return True
    return False


class SwallowedExceptionChecker:
    id = ID

    def check(self, project) -> list:
        out = []
        for fctx in project.files:
            if not fctx.relpath.startswith(HOT_PATH_PREFIXES):
                continue
            for node in ast.walk(fctx.tree):
                if not isinstance(node, ast.Try):
                    continue
                for handler in node.handlers:
                    if not _is_broad(handler, fctx):
                        continue
                    if _is_handled(handler):
                        continue
                    out.append(fctx.finding(
                        ID, handler,
                        "broad except swallows the exception silently in a "
                        "hot path — no log, no re-raise, no span status; "
                        "failures here must degrade LOUDLY (log through "
                        "spans.get_logger, record_exception on the span, or "
                        "re-raise)",
                        symbol=f"swallow:{handler.lineno}",
                    ))
        return out
