"""Utilities of the port (tracing and timing)."""
