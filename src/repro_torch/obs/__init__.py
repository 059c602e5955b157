"""Tracing, metrics and logging for the port: own copies of the reference's
stdlib-only ``obs/logs.py``, ``obs/metrics.py`` (counters, gauges,
histograms, collectors, nearest-rank percentiles) and of ``obs/tracer.py``'s
span recorder with its virtual clock and :func:`virtual_fingerprint`.  Still
missing (ROADMAP Queue A item 5): the Perfetto export (``export.py``), the
fitness engines' compile/execute accounting (``FitnessAccounting``) and the
tracer's ``timed`` spans and ``traced`` decorator."""

from __future__ import annotations

from .logs import logger, setup_logging
from .metrics import METRICS, Counter, Gauge, Histogram, MetricsRegistry, nearest_rank
from .tracer import TRACER, Span, Tracer, virtual_fingerprint

__all__ = [
    "TRACER",
    "Tracer",
    "Span",
    "virtual_fingerprint",
    "METRICS",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "nearest_rank",
    "logger",
    "setup_logging",
]
