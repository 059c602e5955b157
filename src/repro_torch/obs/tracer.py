"""Span-based tracer with dual clocks (wall + virtual).

Every span records **wall-clock** start/duration (``time.perf_counter``,
relative to the tracer origin) and, when a virtual clock is installed, the
**virtual-clock** start/duration of the deterministic event loop
(:class:`repro_torch.service.events.EventLoop`).  The two views answer
different questions: wall time shows where real compute went (solver,
kernel launches); virtual time shows where the *simulated* service spent its
deterministic clock (queueing, dispatch, retry backoff).

Design constraints, in priority order:

* **Zero cost when disabled.**  ``TRACER.span(...)`` returns a shared
  no-op singleton without allocating.  To keep the disabled path
  allocation-free the API takes ``args`` as an optional *dict* parameter,
  never ``**kwargs`` (which would allocate per call).  Hot loops
  additionally guard on ``TRACER.enabled`` so not even the call happens.
* **Deterministic replay.**  Span ids are a sequential counter reset by
  :meth:`Tracer.enable`; names, nesting, virtual timestamps and ``args``
  depend only on the workload + seed.  Wall times are outside the
  determinism contract — :func:`virtual_fingerprint` hashes everything
  *except* wall fields.
* **Exceptions are data.**  A span exited by an exception records
  ``args["error"] = "Type: message"`` and re-raises; the fallback chain in
  :func:`repro_torch.core.api.solve_with_fallback` reads as a trail of attempt
  spans, failed ones carrying their error.
"""

from __future__ import annotations

import functools
import hashlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

__all__ = ["Span", "Tracer", "TRACER", "traced", "virtual_fingerprint"]


@dataclass
class Span:
    """One completed (or in-flight) span.

    ``wall_t0``/``wall_dur`` are seconds relative to the tracer origin;
    ``vt0``/``vdur`` are virtual-clock seconds (``None`` when no virtual
    clock was installed at entry, e.g. outside a service run)."""

    id: int
    parent: int | None
    name: str
    cat: str
    wall_t0: float
    wall_dur: float = 0.0
    vt0: float | None = None
    vdur: float | None = None
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

    @property
    def wall_us(self) -> float:
        return 0.0


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
        if tr._vclock is not None:
            span.vt0 = float(tr._vclock())
        self._span = span
        tr.spans.append(span)
        tr._stack.append(sid)
        return self

    def set(self, **kw: Any) -> "_Active":
        if self._span is not None:
            self._span.args.update(kw)
        return self

    @property
    def wall_us(self) -> float:
        return 0.0 if self._span is None else self._span.wall_dur * 1e6

    def __exit__(self, et, ev, tb) -> bool:
        tr = self._tr
        span = self._span
        if span is None:  # never entered
            return False
        span.wall_dur = time.perf_counter() - self._t0
        if span.vt0 is not None and tr._vclock is not None:
            span.vdur = float(tr._vclock()) - span.vt0
        if tr._stack and tr._stack[-1] == span.id:
            tr._stack.pop()
        if et is not None and "error" not in span.args:
            span.args["error"] = f"{et.__name__}: {ev}"
        return False


class _Timed:
    """Span wrapper that *always* measures wall time, traced or not.

    Call sites that need the duration for their own bookkeeping (e.g. the
    campaign runner's per-cell ``wall_us`` column) use
    :meth:`Tracer.timed`: the measurement is taken unconditionally, and a
    span is recorded only when tracing is enabled.  ``wall_us`` is valid
    after the ``with`` block exits."""

    __slots__ = ("_inner", "_t0", "wall_us")

    def __init__(self, inner: _Active | _Noop) -> None:
        self._inner = inner
        self.wall_us = 0.0

    def __enter__(self) -> "_Timed":
        self._inner.__enter__()
        self._t0 = time.perf_counter()
        return self

    def set(self, **kw: Any) -> "_Timed":
        self._inner.set(**kw)
        return self

    def __exit__(self, *exc) -> bool:
        self.wall_us = (time.perf_counter() - self._t0) * 1e6
        return self._inner.__exit__(*exc)


class Tracer:
    """Process-wide span recorder.  Use the module singleton :data:`TRACER`."""

    def __init__(self) -> None:
        self.enabled = False
        self.spans: list[Span] = []
        self._stack: list[int] = []
        self._origin = time.perf_counter()
        self._vclock: Callable[[], float] | None = None
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

    def set_virtual_clock(
        self, clock: Callable[[], float] | None
    ) -> Callable[[], float] | None:
        """Install (or clear) the virtual clock; returns the previous one."""
        prev = self._vclock
        self._vclock = clock
        return prev

    def span(self, name: str, cat: str = "",
             args: dict[str, Any] | None = None) -> _Active | _Noop:
        """Open a span as a context manager; no-op singleton when disabled."""
        if not self.enabled:
            return _NOOP
        return _Active(self, name, cat, args)

    def timed(self, name: str, cat: str = "",
              args: dict[str, Any] | None = None) -> _Timed:
        """Like :meth:`span` but always measures wall time (see `_Timed`)."""
        return _Timed(self.span(name, cat, args))


TRACER = Tracer()


def traced(name: str | None = None, cat: str = ""):
    """Decorator form: trace every call of ``fn`` under ``name``.

    When tracing is disabled the wrapper costs one attribute check."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not TRACER.enabled:
                return fn(*a, **kw)
            with TRACER.span(label, cat):
                return fn(*a, **kw)

        return wrapper

    return deco


def virtual_fingerprint(spans: Sequence[Span] | None = None) -> str:
    """Hash of the deterministic part of a trace.

    Covers span ids, nesting, names, categories, virtual timestamps and
    args — everything except wall-clock fields, which legitimately vary
    between runs.  Two traced replays of the same workload at the same
    seed must produce equal fingerprints."""
    if spans is None:
        spans = TRACER.spans
    payload = [
        (s.id, s.parent, s.name, s.cat, s.vt0, s.vdur,
         sorted(s.args.items()))
        for s in spans
    ]
    blob = json.dumps(payload, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()
