"""oryx-analyze for the port: AST-based static analysis of torch/asyncio code.

The port of the JAX package's ``oryx_tpu/tools/analyze/`` (stdlib only; it
imports nothing of that package and no torch), held to the reference's
tests by ``tests/test_torch_static_analysis.py``. It scans
``oryx_tpu_torch/`` with the checkers that mean something for torch code,
under the reference's ids:

  * ``blocking-async``     — event-loop stalls in serving handlers (the
                             device waits are ``torch.cuda.synchronize`` and
                             stream/event ``synchronize()``)
  * ``lock-discipline``    — shared state written under a lock, read without
  * ``lock-order-cycle``   — interprocedural lock-acquisition-order cycles
  * ``blocking-under-lock``— await/sleep/executor/socket work (or an
                             unbounded spin) while a threading lock is held
  * ``shared-state-escape``— attributes written from both thread and
                             event-loop context with no common lock
  * ``config-key-drift``   — oryx.* keys read but undeclared in the port's
                             reference_conf, or declared but never read
  * ``log-discipline`` / ``swallowed-exception`` — hot-path logging and
                             silent broad catches
  * ``per-row-ndarray-store`` — dict-of-ndarray (or dict-of-tensor)
                             accumulation in models/serving
  * ``host-device-transfer`` — silent device→host syncs (``.item()``,
                             ``.cpu()``, ``.tolist()``, ``float(t)``, ...)
                             reachable from async handlers, inside trainer
                             loops, or per element
  * ``replicated-collective`` — a model-scaled table copied whole to every
                             shard (``parallel.mesh.replicated``)
  * ``dtype-widening``     — int8/bf16 tensors silently mixed with float32
                             on the device
  * ``protocol-model-drift`` — the protocol models' site annotations
                             against the port's transport and runtime

plus ``analyze --cost`` (the static roofline of every function holding a
torch contraction or a per-shard region) and ``analyze --protocol`` (the
explicit-state model checker of ``protocol/``). Not ported: the jit and
Pallas checkers and ``--cost``'s Pallas kernel rows (the port has no JAX
tracing and no Pallas sources).

Run it as ``python -m oryx_tpu_torch.cli analyze [--format
json|text|sarif]``; suppress a finding inline with ``# analyze:
ignore[<checker-id>] -- justification`` or in the committed baseline
(``conf/analyze-baseline-torch.json``), both of which require a
justification string (baseline entries also pin the checker version they
were judged against).
"""

from oryx_tpu_torch.tools.analyze.core import (  # noqa: F401
    AnalysisResult,
    Finding,
    analyze_project,
    analyze_source,
)
