"""Recurring & converging workflow specs (cylc-style cycling).

A :class:`CycleSpec` turns any workflow family into a *cycling* workload:
the base DAG repeats on a ``period`` with declarative cross-cycle
dependencies (``("prev_task", "next_task")`` pairs; ``"*"`` wildcards mean
the sinks of cycle ``k-1`` feed the roots of cycle ``k`` — cylc's default
inter-cycle trigger).  The same spec expands two ways, bit-identically per
seed:

* **unrolled** — :func:`unroll` produces ONE plain :class:`Workflow` with
  tasks ``T@c0, T@c1, ...`` and the cross-cycle edges materialized, so
  MILP/HEFT/GA schedule a bounded window of cycles as a single DAG
  (:func:`unroll_constraints` adds the per-cycle deadline rows
  ``(k+1) * cycle_deadline``).
* **streamed** — the service submits one :class:`~repro_torch.service.Submission`
  per cycle (``{base}@c{k}``, arrival ``base + k*period``, gated on cycle
  ``k-1`` via ``after=``).  Every cycle's workflow is content-identical, so
  its problem fingerprint — and therefore the solve/pack caches — is shared
  across cycles; cycle identity lives in the submission id alone.

*Converging* workflows don't know their cycle count up front: a seeded
:class:`ConvergeSpec` predicate is evaluated when a cycle completes, and the
service keeps spawning the next cycle until it fires (or ``max_cycles``).
The predicate is a pure function of ``(seed, workflow name, cycle)``, so
replays are bit-identical.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Mapping

import numpy as np

from repro_torch.core.workload_model import (
    Constraints,
    Task,
    Workflow,
    Workload,
)

_CONVERGE_KEYS = ("prob", "min_cycles", "max_cycles", "seed")
_SPEC_KEYS = ("cycles", "period", "cross", "converge", "cycle_deadline")


@dataclasses.dataclass(frozen=True)
class ConvergeSpec:
    """Seeded convergence predicate for converge-until-done workflows.

    After cycle ``k`` completes, :meth:`converged` draws one uniform from
    ``default_rng([seed, crc32(name), k])`` and converges when it falls
    below ``prob`` — never before ``min_cycles`` cycles have run, always by
    ``max_cycles``.  Deterministic per (seed, workflow name, cycle), so the
    revealed cycle count replays bit-identically.
    """

    prob: float = 0.5
    min_cycles: int = 1
    max_cycles: int = 8
    seed: int = 0

    def __post_init__(self) -> None:
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"converge.prob must be in [0, 1], got {self.prob}")
        if self.min_cycles < 1 or self.max_cycles < self.min_cycles:
            raise ValueError(
                f"converge needs 1 <= min_cycles <= max_cycles, got "
                f"{self.min_cycles}..{self.max_cycles}"
            )

    def converged(self, name: str, cycle: int) -> bool:
        """Has ``name`` converged after completing cycle ``cycle`` (0-based)?"""
        if cycle + 1 < self.min_cycles:
            return False
        if cycle + 1 >= self.max_cycles:
            return True
        rng = np.random.default_rng(
            [int(self.seed), zlib.crc32(name.encode("utf-8")), int(cycle)]
        )
        return bool(rng.random() < self.prob)

    def revealed_cycles(self, name: str) -> int:
        """Total cycle count the predicate reveals for ``name`` (what an
        oracle that ran the stream to completion would observe)."""
        for k in range(self.max_cycles):
            if self.converged(name, k):
                return k + 1
        return self.max_cycles

    def to_json(self) -> dict:
        return {
            "prob": float(self.prob),
            "min_cycles": int(self.min_cycles),
            "max_cycles": int(self.max_cycles),
            "seed": int(self.seed),
        }


def converge_from_json(obj: Mapping[str, Any] | None) -> ConvergeSpec | None:
    if obj is None:
        return None
    unknown = set(obj) - set(_CONVERGE_KEYS)
    if unknown:
        raise ValueError(
            f"converge: unknown keys {sorted(unknown)} (known: {list(_CONVERGE_KEYS)})"
        )
    return ConvergeSpec(
        prob=float(obj.get("prob", 0.5)),
        min_cycles=int(obj.get("min_cycles", 1)),
        max_cycles=int(obj.get("max_cycles", 8)),
        seed=int(obj.get("seed", 0)),
    )


@dataclasses.dataclass(frozen=True)
class CycleSpec:
    """How a workflow recurs.

    * ``cycles`` — fixed cycle count (``None`` for converging specs, whose
      count is revealed by ``converge`` at run time).
    * ``period`` — inter-cycle arrival spacing (stream mode) and the
      per-cycle deadline step base (unrolled mode).
    * ``cross`` — cross-cycle dependency pairs ``(prev_task, next_task)``:
      task ``next_task`` of cycle ``k`` waits on ``prev_task`` of cycle
      ``k-1``.  ``"*"`` on the prev side means *all sinks*, on the next side
      *all roots* (cylc's default chain when left at ``(("*", "*"),)``).
    * ``converge`` — seeded convergence predicate (mutually exclusive with
      a fixed ``cycles``).
    * ``cycle_deadline`` — per-cycle deadline step: cycle ``k`` must finish
      by ``(k+1) * cycle_deadline`` (unrolled via
      :func:`unroll_constraints`; the service checks it at completion).
    """

    cycles: int | None = None
    period: float = 0.0
    cross: tuple[tuple[str, str], ...] = (("*", "*"),)
    converge: ConvergeSpec | None = None
    cycle_deadline: float | None = None

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "cross", tuple((str(a), str(b)) for a, b in self.cross)
        )
        if (self.cycles is None) == (self.converge is None):
            raise ValueError(
                "cycling spec needs exactly one of a fixed 'cycles' count or "
                "a 'converge' predicate"
            )
        if self.cycles is not None and self.cycles < 1:
            raise ValueError(f"cycles must be >= 1, got {self.cycles}")
        if self.period < 0:
            raise ValueError(f"period must be >= 0, got {self.period}")
        if self.cycle_deadline is not None and self.cycle_deadline <= 0:
            raise ValueError(
                f"cycle_deadline must be > 0, got {self.cycle_deadline}"
            )

    @property
    def converging(self) -> bool:
        return self.converge is not None

    def max_cycles(self) -> int:
        """Upper bound on cycle count (fixed, or the predicate's ceiling)."""
        if self.cycles is not None:
            return self.cycles
        assert self.converge is not None
        return self.converge.max_cycles

    def to_json(self) -> dict:
        out: dict[str, Any] = {
            "period": float(self.period),
            "cross": [[a, b] for a, b in self.cross],
        }
        if self.cycles is not None:
            out["cycles"] = int(self.cycles)
        if self.converge is not None:
            out["converge"] = self.converge.to_json()
        if self.cycle_deadline is not None:
            out["cycle_deadline"] = float(self.cycle_deadline)
        return out


def cycle_spec_from_json(obj: Mapping[str, Any] | None) -> CycleSpec | None:
    if obj is None:
        return None
    unknown = set(obj) - set(_SPEC_KEYS)
    if unknown:
        raise ValueError(
            f"cycling: unknown keys {sorted(unknown)} (known: {list(_SPEC_KEYS)})"
        )
    cycles = obj.get("cycles")
    deadline = obj.get("cycle_deadline")
    return CycleSpec(
        cycles=int(cycles) if cycles is not None else None,
        period=float(obj.get("period", 0.0)),
        cross=tuple(
            (str(a), str(b)) for a, b in obj.get("cross", [["*", "*"]])
        ),
        converge=converge_from_json(obj.get("converge")),
        cycle_deadline=float(deadline) if deadline is not None else None,
    )


# -----------------------------------------------------------------------------
# Expansion
# -----------------------------------------------------------------------------


def task_cycle_name(name: str, cycle: int) -> str:
    """Canonical unrolled task name: ``T2@c3`` = base task T2, cycle 3."""
    return f"{name}@c{cycle}"


def roots_and_sinks(workflow: Workflow) -> tuple[list[str], list[str]]:
    """Task names with no predecessors / no successors, in task order."""
    has_succ = {d for t in workflow.tasks for d in t.deps}
    roots = [t.name for t in workflow.tasks if not t.deps]
    sinks = [t.name for t in workflow.tasks if t.name not in has_succ]
    return roots, sinks


def cross_edges(workflow: Workflow, spec: CycleSpec) -> tuple[tuple[str, str], ...]:
    """The spec's cross-cycle pairs with wildcards expanded against the base
    DAG: ``"*"`` on the prev side → every sink, on the next side → every
    root.  Order is deterministic (spec order, then task order); duplicates
    are dropped."""
    roots, sinks = roots_and_sinks(workflow)
    names = {t.name for t in workflow.tasks}
    out: list[tuple[str, str]] = []
    seen: set[tuple[str, str]] = set()
    for prev, nxt in spec.cross:
        for p in (sinks if prev == "*" else (prev,)):
            if p not in names:
                raise ValueError(
                    f"cycling.cross: unknown task {p!r} in workflow {workflow.name}"
                )
            for s in (roots if nxt == "*" else (nxt,)):
                if s not in names:
                    raise ValueError(
                        f"cycling.cross: unknown task {s!r} in workflow "
                        f"{workflow.name}"
                    )
                if (p, s) not in seen:
                    seen.add((p, s))
                    out.append((p, s))
    return tuple(out)


def resolve_cycles(spec: CycleSpec, cycles: int | None = None) -> int:
    """The cycle count to expand: an explicit override, the spec's fixed
    count, or (converging specs) the predicate's ``max_cycles`` bound."""
    if cycles is not None:
        if cycles < 1:
            raise ValueError(f"cycles must be >= 1, got {cycles}")
        return int(cycles)
    return spec.max_cycles()


def unroll(
    workflow: Workflow, spec: CycleSpec, cycles: int | None = None
) -> Workflow:
    """Expand ``cycles`` repetitions of ``workflow`` into ONE DAG.

    Cycle ``k``'s tasks are renamed ``T@ck``; intra-cycle dependencies are
    renamed with them, and each resolved cross pair ``(p, s)`` adds the edge
    ``p@c{k-1} → s@ck``.  Expansion is deterministic (cycles in order, tasks
    in base order) and the :class:`Workflow` constructor re-validates
    acyclicity — prev-cycle-only cross edges cannot introduce a cycle.

    The period does not appear in the unrolled DAG itself (a workflow has a
    single submission time); it enters through per-cycle deadlines
    (:func:`unroll_constraints`) in unrolled mode and through arrival times
    in stream mode.
    """
    k_total = resolve_cycles(spec, cycles)
    pairs = cross_edges(workflow, spec)
    tasks: list[Task] = []
    for k in range(k_total):
        for t in workflow.tasks:
            deps = [task_cycle_name(d, k) for d in t.deps]
            if k > 0:
                deps += [
                    task_cycle_name(p, k - 1) for p, s in pairs if s == t.name
                ]
            tasks.append(
                dataclasses.replace(
                    t, name=task_cycle_name(t.name, k), deps=tuple(deps)
                )
            )
    return Workflow(
        name=workflow.name, tasks=tuple(tasks), submission=workflow.submission
    )


def unroll_workload(
    workload: Workload, spec: CycleSpec, cycles: int | None = None
) -> Workload:
    """Apply :func:`unroll` to every workflow of a workload."""
    return Workload(tuple(unroll(w, spec, cycles) for w in workload.workflows))


def unroll_constraints(
    workload: Workload,
    spec: CycleSpec,
    cycles: int | None = None,
    base: Constraints | None = None,
) -> Constraints | None:
    """Per-cycle deadline entries for an unrolled workload, merged over
    ``base``: every task of cycle ``k`` must finish by
    ``(k+1) * cycle_deadline`` (keys are qualified unrolled task names, so
    they compose with workflow-level deadlines/budgets from ``base``).

    Returns ``base`` unchanged when the spec carries no ``cycle_deadline``.
    Base *task-qualified* deadline keys are not rewritten per cycle — the
    supported per-cycle deadline mechanism is ``cycle_deadline``.
    """
    if spec.cycle_deadline is None:
        return base
    k_total = resolve_cycles(spec, cycles)
    deadline: dict[str, float] = dict(base.deadline) if base is not None else {}
    for wf in workload.workflows:
        for k in range(k_total):
            for t in wf.tasks:
                key = f"{wf.name}/{task_cycle_name(t.name, k)}"
                deadline[key] = (k + 1) * spec.cycle_deadline
    return Constraints(
        deadline=deadline,
        budget=dict(base.budget) if base is not None else {},
        cost_rate=dict(base.cost_rate) if base is not None else {},
        placement=dict(base.placement) if base is not None else {},
    )
