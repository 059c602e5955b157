"""Optimizers: AdamW (``adamw``)."""
