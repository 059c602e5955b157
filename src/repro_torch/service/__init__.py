"""Event-driven, multi-tenant scheduling service over one shared continuum.

A deterministic simulated-clock service that admits a *stream* of tenant
workflow submissions, batches compatible solves, caches by content, executes
on the digital twin with node contention, and folds monitoring feedback back
into the model — the paper's Fig. 4 loop running continuously instead of
once.  Its GA admissions score their populations through the makespan
kernel on the card (one launch a generation, singly or for a batched group).

Quickstart::

    from repro_torch.service import ServiceConfig, generate_trace, serve_trace

    trace = generate_trace(200, seed=0, node_events=True)
    result = serve_trace(trace, config=ServiceConfig(batch_window=0.25))
    print(result.summary())

or from the CLI::

    python -m repro_torch trace trace.json -n 200 --seed 0
    python -m repro_torch serve trace.json            # --device cpu: no card
"""

from repro_torch.service.admission import AdmissionBatcher, AdmissionStats, PreparedSubmission
from repro_torch.service.cache import CacheStats, SolveCache, solve_cache_key
from repro_torch.service.events import Event, EventLoop
from repro_torch.service.service import (
    SchedulingService,
    ServiceConfig,
    ServiceResult,
    SubmissionRecord,
    retry_backoff,
    serve_trace,
)
from repro_torch.service.state import ContinuumState, NodeStatus
from repro_torch.service.traces import (
    FAMILIES,
    NodeEvent,
    Submission,
    Trace,
    arrival_times,
    chaos_events,
    continuum_system,
    generate_trace,
    load_trace,
    trace_from_json,
)

__all__ = [
    "FAMILIES",
    "AdmissionBatcher",
    "AdmissionStats",
    "CacheStats",
    "ContinuumState",
    "Event",
    "EventLoop",
    "NodeEvent",
    "NodeStatus",
    "PreparedSubmission",
    "SchedulingService",
    "ServiceConfig",
    "ServiceResult",
    "SolveCache",
    "Submission",
    "SubmissionRecord",
    "Trace",
    "arrival_times",
    "chaos_events",
    "continuum_system",
    "generate_trace",
    "load_trace",
    "retry_backoff",
    "serve_trace",
    "solve_cache_key",
    "trace_from_json",
]
