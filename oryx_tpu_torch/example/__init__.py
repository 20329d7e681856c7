"""The word-count example app on the port (host code, no device)."""
