"""log-discipline: hot-path modules must log through the trace-aware adapter.

The port of the JAX package's ``oryx_tpu/tools/analyze/checkers/logstyle.py``
over the port's hot paths (``oryx_tpu_torch/{serving,transport,lambda_rt}/``);
its messages name the port's ``spans.get_logger``. Below, the reference's
text.

The serving/transport/lambda tiers process traced requests (common/spans.py
carries a current span per task/thread). A log line emitted there through a
bare ``logging.getLogger(__name__)`` logger loses the trace/span ids that
would let an operator jump from the line to ``GET /trace?trace_id=...`` —
and a stray ``print(...)`` bypasses logging entirely (no level, no handler,
interleaved stdout under concurrency). Both are flagged in library hot
paths in favor of ``oryx_tpu_torch.common.spans.get_logger``, whose adapter
appends ``[trace=... span=...]`` to every message under an active span.

Scope is deliberately the HOT paths only (``serving/``, ``transport/``,
``lambda_rt/``): CLI tools and benches print by design, and offline
trainers have no request context to correlate.
"""

from __future__ import annotations

import ast

ID = "log-discipline"

#: Repo-relative path prefixes where request context is live.
HOT_PATH_PREFIXES = (
    "oryx_tpu_torch/serving/",
    "oryx_tpu_torch/transport/",
    "oryx_tpu_torch/lambda_rt/",
)


class LogDisciplineChecker:
    id = ID

    def check(self, project) -> list:
        out = []
        for fctx in project.files:
            if not fctx.relpath.startswith(HOT_PATH_PREFIXES):
                continue
            for node in ast.walk(fctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                if (
                    isinstance(node.func, ast.Name)
                    and node.func.id == "print"
                    and "print" not in fctx.import_map
                ):
                    out.append(fctx.finding(
                        ID, node,
                        "print() in a library hot path — stdout has no "
                        "level, no handler, and no trace correlation; use "
                        "oryx_tpu_torch.common.spans.get_logger(__name__)",
                        symbol=f"print:{node.lineno}",
                    ))
                    continue
                resolved = fctx.resolve(node.func)
                if resolved == "logging.getLogger":
                    out.append(fctx.finding(
                        ID, node,
                        "bare logging.getLogger() in a library hot path — "
                        "its lines drop the trace/span ids; use "
                        "oryx_tpu_torch.common.spans.get_logger(__name__) so log "
                        "lines correlate with GET /trace",
                        symbol=f"getLogger:{node.lineno}",
                    ))
        return out
