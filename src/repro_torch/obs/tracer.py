"""Span-based tracer: the part of the reference's ``obs/tracer.py`` that the
solve path uses.

Every span records **wall-clock** start/duration (``time.perf_counter``,
relative to the tracer origin), its parent, a name, a category and ``args``.
The reference's virtual clock, ``timed`` spans, ``traced`` decorator and
trace fingerprint serve its scheduling service and its trace export, which
are not ported yet (ROADMAP Queue A items 4 and 5).

Design constraints, in priority order:

* **Zero cost when disabled.**  ``TRACER.span(...)`` returns a shared
  no-op singleton without allocating.  To keep the disabled path
  allocation-free the API takes ``args`` as an optional *dict* parameter,
  never ``**kwargs`` (which would allocate per call).
* **Deterministic replay.**  Span ids are a sequential counter reset by
  :meth:`Tracer.enable`; names, nesting and ``args`` depend only on the
  workload + seed.  Wall times are outside the determinism contract.
* **Exceptions are data.**  A span exited by an exception records
  ``args["error"] = "Type: message"`` and re-raises; the fallback chain in
  :func:`repro_torch.core.api.solve_with_fallback` reads as a trail of attempt
  spans, failed ones carrying their error.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

__all__ = ["Span", "Tracer", "TRACER"]


@dataclass
class Span:
    """One completed (or in-flight) span; ``wall_t0``/``wall_dur`` are
    seconds relative to the tracer origin."""

    id: int
    parent: int | None
    name: str
    cat: str
    wall_t0: float
    wall_dur: float = 0.0
    args: dict[str, Any] = field(default_factory=dict)


class _Noop:
    """Shared do-nothing span — the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False

    def set(self, **kw: Any) -> "_Noop":
        return self


_NOOP = _Noop()


class _Active:
    """Context manager for one live span (tracing enabled)."""

    __slots__ = ("_tr", "_name", "_cat", "_args", "_span", "_t0")

    def __init__(self, tr: "Tracer", name: str, cat: str,
                 args: dict[str, Any] | None) -> None:
        self._tr = tr
        self._name = name
        self._cat = cat
        self._args = args
        self._span: Span | None = None

    def __enter__(self) -> "_Active":
        tr = self._tr
        sid = tr._next_id
        tr._next_id = sid + 1
        parent = tr._stack[-1] if tr._stack else None
        self._t0 = time.perf_counter()
        span = Span(
            id=sid,
            parent=parent,
            name=self._name,
            cat=self._cat,
            wall_t0=self._t0 - tr._origin,
            args=dict(self._args) if self._args else {},
        )
        self._span = span
        tr.spans.append(span)
        tr._stack.append(sid)
        return self

    def set(self, **kw: Any) -> "_Active":
        if self._span is not None:
            self._span.args.update(kw)
        return self

    def __exit__(self, et, ev, tb) -> bool:
        tr = self._tr
        span = self._span
        if span is None:  # never entered
            return False
        span.wall_dur = time.perf_counter() - self._t0
        if tr._stack and tr._stack[-1] == span.id:
            tr._stack.pop()
        if et is not None and "error" not in span.args:
            span.args["error"] = f"{et.__name__}: {ev}"
        return False


class Tracer:
    """Process-wide span recorder.  Use the module singleton :data:`TRACER`."""

    def __init__(self) -> None:
        self.enabled = False
        self.spans: list[Span] = []
        self._stack: list[int] = []
        self._origin = time.perf_counter()
        self._next_id = 0

    def enable(self) -> None:
        """Turn tracing on and reset the buffer, so span ids start from 0."""
        self.enabled = True
        self.spans = []
        self._stack = []
        self._next_id = 0
        self._origin = time.perf_counter()

    def disable(self) -> None:
        self.enabled = False

    def span(self, name: str, cat: str = "",
             args: dict[str, Any] | None = None) -> _Active | _Noop:
        """Open a span as a context manager; no-op singleton when disabled."""
        if not self.enabled:
            return _NOOP
        return _Active(self, name, cat, args)


TRACER = Tracer()
