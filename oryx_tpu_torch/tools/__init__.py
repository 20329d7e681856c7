"""Operator tools: ``trace_summary`` (profiler traces, metrics dumps, span
trees, series, bench history), ``traffic`` (the load generator),
``sanitize`` (the runtime concurrency sanitizer: lock-order cycles, long
holds and event-loop stalls, opt-in by ``ORYX_SANITIZE=locks,loop``) and
``analyze`` (the static analyser, ``python -m oryx_tpu_torch.cli
analyze``)."""
