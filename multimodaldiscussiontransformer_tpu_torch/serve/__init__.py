"""Serving: incremental scoring, micro-batching and an HTTP endpoint."""
