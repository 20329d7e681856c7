"""Operator tools: ``trace_summary`` (profiler traces, metrics dumps, span
trees, series, bench history), ``traffic`` (the load generator) and
``sanitize`` (the runtime concurrency sanitizer: lock-order cycles, long
holds and event-loop stalls, opt-in by ``ORYX_SANITIZE=locks,loop``)."""
