"""Exporters: Chrome/Perfetto ``trace_event`` JSON + flat metrics JSON.

The trace format is the Chrome Trace Event JSON the Perfetto UI
(https://ui.perfetto.dev) opens directly: complete-duration events
(``"ph": "X"``) with microsecond ``ts``/``dur``.  The dual-clock view maps
to two synthetic processes:

* ``pid 1`` ("wall clock") — every span, at its wall timestamps;
* ``pid 2`` ("virtual clock") — spans that ran under the service's
  deterministic event clock, at their virtual timestamps (virtual seconds
  rendered on the µs scale).

So one file shows real cost and simulated time side by side, correlated
by span id (in ``args``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping, Sequence

from .metrics import FITNESS, METRICS, MetricsRegistry
from .tracer import TRACER, Span

__all__ = [
    "trace_events",
    "write_trace",
    "telemetry",
    "write_metrics",
    "flatten",
    "summarize_trace",
]

_WALL_PID = 1
_VIRT_PID = 2


def trace_events(spans: Sequence[Span] | None = None) -> list[dict[str, Any]]:
    """Render spans as Chrome ``trace_event`` dicts (both clock views)."""
    if spans is None:
        spans = TRACER.spans
    events: list[dict[str, Any]] = [
        {"ph": "M", "pid": _WALL_PID, "tid": 0, "ts": 0,
         "name": "process_name", "args": {"name": "wall clock"}},
        {"ph": "M", "pid": _VIRT_PID, "tid": 0, "ts": 0,
         "name": "process_name", "args": {"name": "virtual clock (event loop)"}},
    ]
    for s in spans:
        args = dict(s.args, span_id=s.id)
        if s.parent is not None:
            args["parent"] = s.parent
        events.append({
            "ph": "X",
            "pid": _WALL_PID,
            "tid": 1,
            "name": s.name,
            "cat": s.cat or "repro",
            "ts": s.wall_t0 * 1e6,
            "dur": s.wall_dur * 1e6,
            "args": args,
        })
        if s.vt0 is not None:
            events.append({
                "ph": "X",
                "pid": _VIRT_PID,
                "tid": 1,
                "name": s.name,
                "cat": s.cat or "repro",
                "ts": s.vt0 * 1e6,
                "dur": (s.vdur or 0.0) * 1e6,
                "args": args,
            })
    return events


def write_trace(path: str | Path,
                spans: Sequence[Span] | None = None) -> Path:
    """Write a Perfetto-loadable ``{"traceEvents": [...]}`` file."""
    path = Path(path)
    payload = {"traceEvents": trace_events(spans),
               "displayTimeUnit": "ms"}
    path.write_text(json.dumps(payload) + "\n")
    return path


def telemetry(before: Mapping[str, Any] | None = None) -> dict[str, Any]:
    """The ``telemetry`` block attached to BENCH exports and ResultSet meta.

    ``metrics`` is the registry snapshot (delta'd against ``before`` when
    given — take ``METRICS.snapshot()`` before the workload); ``engine_fitness``
    is the process compile-vs-execute table keyed ``backend|bucket[|mode]``.
    """
    return {
        "metrics": MetricsRegistry.delta(before, METRICS.snapshot()),
        "engine_fitness": FITNESS.to_json(),
        "spans": len(TRACER.spans) if TRACER.enabled else 0,
    }


def flatten(d: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """Flatten nested mappings to dotted scalar keys (lists pass through)."""
    out: dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def write_metrics(path: str | Path,
                  block: Mapping[str, Any] | None = None) -> Path:
    """Write the flat metrics JSON next to a trace (``--trace`` companion)."""
    path = Path(path)
    payload = flatten(block if block is not None else telemetry())
    path.write_text(json.dumps(payload, indent=2, sort_keys=True,
                               default=repr) + "\n")
    return path


def summarize_trace(path: str | Path) -> dict[str, Any]:
    """Load + validate a trace file; aggregate per category and hot spans.

    Raises ``ValueError`` on malformed events (missing/ill-typed ``ph``,
    ``ts`` or ``dur``) — this is also the ``python -m repro_torch obs`` backend.
    """
    obj = json.loads(Path(path).read_text())
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("not a trace_event file: missing traceEvents list")
    cats: dict[str, dict[str, float]] = {}
    hot: dict[str, float] = {}
    n_wall = n_virtual = 0
    for ev in events:
        ph = ev.get("ph")
        if not isinstance(ph, str):
            raise ValueError(f"event without string ph: {ev!r}")
        if ph == "M":
            continue
        if ph != "X":
            raise ValueError(f"unexpected phase {ph!r}")
        ts, dur = ev.get("ts"), ev.get("dur")
        if not isinstance(ts, (int, float)) or not isinstance(dur, (int, float)):
            raise ValueError(f"X event with non-numeric ts/dur: {ev!r}")
        if dur < 0:
            raise ValueError(f"negative dur: {ev!r}")
        if ev.get("pid") == _VIRT_PID:
            n_virtual += 1
            continue  # aggregate real cost on the wall view only
        n_wall += 1
        cat = ev.get("cat", "")
        agg = cats.setdefault(cat, {"count": 0, "total_us": 0.0})
        agg["count"] += 1
        agg["total_us"] += dur
        name = ev.get("name", "?")
        hot[name] = hot.get(name, 0.0) + dur
    top = sorted(hot.items(), key=lambda kv: -kv[1])[:10]
    return {
        "events": len(events),
        "wall_spans": n_wall,
        "virtual_spans": n_virtual,
        "categories": {k: cats[k] for k in sorted(cats)},
        "top_spans_us": [{"name": n, "total_us": round(us, 1)} for n, us in top],
    }
