"""Tracing and logging for the port: own copies of the reference's
stdlib-only ``obs/logs.py`` and of the span recorder of ``obs/tracer.py``.
The metrics registry, the Perfetto export and the fitness accounting are
not ported yet."""

from __future__ import annotations

from .logs import logger, setup_logging
from .tracer import TRACER, Span, Tracer

__all__ = ["TRACER", "Tracer", "Span", "logger", "setup_logging"]
