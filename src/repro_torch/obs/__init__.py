"""``repro_torch.obs`` — tracing, metrics and export for the port.

Three planes, one import, stdlib-only (safe to import from every module of
the port without cycles):

* **Tracing** (:mod:`.tracer`): nested spans on dual clocks — wall
  (``time.perf_counter``) and the service's deterministic virtual event
  clock.  Zero-cost when disabled; deterministic span ids so traces
  replay bit-identically at a fixed seed.  ``TRACER.timed`` always
  measures wall time and records a span only when tracing is on;
  :func:`traced` is the decorator form.
* **Metrics** (:mod:`.metrics`): process-wide counters / gauges /
  fixed-bucket histograms plus collectors registered by owning modules
  (the pack cache, the loaded kernel libraries), behind one
  ``snapshot()``/``delta()`` surface; first-call-vs-execute attribution of
  the fitness engines via :data:`FITNESS`.
* **Export** (:mod:`.export`): Chrome/Perfetto ``trace_event`` JSON,
  flat metrics JSON, and the ``telemetry`` block embedded in campaign
  results and the lanes' exports.

Typical traced run::

    from repro_torch import obs

    obs.enable_tracing()
    with obs.TRACER.span("my.workload", cat="demo"):
        ...
    obs.write_trace("out.json")          # open in ui.perfetto.dev
    obs.write_metrics("out.metrics.json")
"""

from __future__ import annotations

from .logs import logger, setup_logging
from .metrics import (
    FITNESS,
    METRICS,
    Counter,
    FitnessAccounting,
    Gauge,
    Histogram,
    MetricsRegistry,
    nearest_rank,
)
from .tracer import TRACER, Span, Tracer, traced, virtual_fingerprint
from .export import (
    flatten,
    summarize_trace,
    telemetry,
    trace_events,
    write_metrics,
    write_trace,
)

__all__ = [
    "TRACER",
    "Tracer",
    "Span",
    "traced",
    "virtual_fingerprint",
    "METRICS",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "nearest_rank",
    "FITNESS",
    "FitnessAccounting",
    "trace_events",
    "write_trace",
    "telemetry",
    "write_metrics",
    "flatten",
    "summarize_trace",
    "logger",
    "setup_logging",
    "enable_tracing",
    "disable_tracing",
]


def enable_tracing() -> None:
    """Enable the global tracer (resets the span buffer + id sequence)."""
    TRACER.enable()


def disable_tracing() -> None:
    TRACER.disable()
