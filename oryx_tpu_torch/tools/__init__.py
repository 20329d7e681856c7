"""Operator tools: ``trace_summary`` (profiler traces, metrics dumps, span
trees, series, bench history) and ``traffic`` (the load generator)."""
