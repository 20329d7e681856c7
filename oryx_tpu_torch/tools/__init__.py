"""Operator tools: the metrics-text readers the fleet console uses."""
