"""Serving: the continuous-batching engine and KV-cache utilities."""
