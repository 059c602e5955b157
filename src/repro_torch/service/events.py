"""Heap-ordered virtual-clock event loop — the service's backbone.

The :class:`~repro_torch.core.api.Orchestrator` runs one scenario as a
while-drift loop; a *service* instead reacts to a stream of timestamped
events (cylc-style): workflow submissions arrive, admitted batches dispatch,
tasks finish, nodes drift or fail.  Everything the service does is a handler
for one of these kinds, driven off a deterministic simulated clock:

* events are totally ordered by ``(time, seq)`` — ``seq`` is the push order,
  so simultaneous events replay identically run over run;
* the loop never consults wall time or global RNG state: given the same
  trace and seed, the event *log* (every processed event, in order) is
  bit-identical, which the tests assert.

Event kinds (the ``kind`` field):

==================  ========================================================
``submission``      a tenant's workflow entered the admission queue
``admit``           the admission batcher drains the queue (batch window end)
``dispatch``        a solved submission started executing on the continuum
``task-finished``   one task of an in-flight submission completed
``completion``      the last task of a submission completed (monitor feeds
                    observed speeds back into the model here)
``node-drift``      ground-truth speed of a node changed (trace-injected)
``node-failure``    a node dropped out of the continuum (trace-injected)
``node-recovery``   a failed node came back (trace-injected)
``rejected``        a submission could not be scheduled (infeasible)
``preempted``       a node failure cancelled a submission's in-flight
                    remainder (salvaged prefix + requeued rest)
``requeue``         a preempted submission re-enters the admission queue
                    after its virtual-time backoff
``failed``          a submission exhausted its retry budget (terminal)
``deadline-miss``   a submission completed past its deadline / cycle deadline
``cycle-spawned``   a cycling stream's completion spawned its next cycle
``converged``       a cycling stream ended (fixed count reached, or the
                    seeded convergence predicate fired)
==================  ========================================================

Scheduled events are *cancellable*: ``push`` returns the :class:`Event` as a
cancellation token, and :meth:`EventLoop.cancel` marks it dead — a cancelled
event is silently skipped when its time comes, never handled, never logged.
This is what lets a node failure retract the pre-computed ``completion`` /
``task-finished`` events of work that will now never happen.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Iterator


@dataclasses.dataclass(frozen=True)
class Event:
    """One timestamped occurrence; ``payload`` is JSON-serializable."""

    time: float
    seq: int
    kind: str
    payload: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"time": float(self.time), "seq": self.seq,
                               "kind": self.kind}
        out.update(self.payload)
        return out


class EventLoop:
    """Priority queue of :class:`Event` on a monotonic virtual clock.

    ``push`` schedules (past timestamps clamp to *now* — an event can never
    be processed before the event that created it), ``pop`` advances the
    clock.  ``record`` appends to the replayable log; handlers log the events
    they process plus any synchronous occurrences (e.g. ``dispatch``) so the
    log is a complete, ordered account of the run."""

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = 0
        self._cancelled: set[int] = set()
        self.now = 0.0
        self.log: list[dict[str, Any]] = []

    def push(self, time: float, kind: str, **payload: Any) -> Event:
        t = max(float(time), self.now)
        ev = Event(time=t, seq=self._seq, kind=kind, payload=payload)
        self._seq += 1
        heapq.heappush(self._heap, (t, ev.seq, ev))
        return ev

    def cancel(self, ev: Event) -> bool:
        """Retract a still-pending scheduled event (``ev`` is the token
        ``push`` returned).  Idempotent; returns True when newly cancelled.
        Only pending events may be cancelled — cancelling an event that
        already popped is undefined (the caller tracks pendingness)."""
        if ev.seq in self._cancelled:
            return False
        self._cancelled.add(ev.seq)
        return True

    def pop(self) -> Event | None:
        while self._heap:
            t, seq, ev = heapq.heappop(self._heap)
            if seq in self._cancelled:
                self._cancelled.discard(seq)
                continue  # cancelled: skip without advancing the clock
            self.now = t
            return ev
        return None

    def record(self, event: Event) -> None:
        self.log.append(event.to_json())

    def emit(self, kind: str, **payload: Any) -> None:
        """Log a synchronous occurrence at the current clock (no scheduling)."""
        ev = Event(time=self.now, seq=self._seq, kind=kind, payload=payload)
        self._seq += 1
        self.record(ev)

    def __len__(self) -> int:
        return len(self._heap) - len(self._cancelled)

    def __bool__(self) -> bool:
        return len(self) > 0

    def drain(self) -> Iterator[Event]:
        """Iterate live events in clock order until the heap is empty."""
        while True:
            ev = self.pop()
            if ev is None:
                return
            yield ev
