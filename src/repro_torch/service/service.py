"""The event-driven, multi-tenant scheduling service.

This is the continuous counterpart of the
:class:`~repro_torch.core.api.Orchestrator`: instead of one scenario per process,
a :class:`SchedulingService` multiplexes a *stream* of tenant submissions
over one shared continuum :class:`~repro_torch.core.system_model.System`, driven
by the virtual-clock event loop of :mod:`repro_torch.service.events`:

* ``submission`` events queue work; an ``admit`` event fires one batch
  window later and drains the queue through the
  :class:`~repro_torch.service.admission.AdmissionBatcher` (cache → batched solve
  → single solve);
* dispatched work executes on the digital twin
  (:func:`repro_torch.core.simulator.execute`) under the continuum's *true* node
  speeds, shifted by the node-occupancy frontier
  (:class:`~repro_torch.service.state.ContinuumState`) so tenants contend for
  nodes instead of simulating in parallel universes;
* each ``completion`` folds observed speeds back into the model (Fig. 4
  step 4 → 1), so later admissions — including queued resubmissions of the
  same workflow — solve against reality.  Because cache keys are content
  hashes of the *refreshed* problem, this feedback invalidates exactly the
  cached solves it should, and no others;
* ``node-drift`` / ``node-failure`` / ``node-recovery`` events mutate the
  continuum mid-run; future admissions route around them.

Fault tolerance: a ``node-failure`` *preempts* every in-flight submission
with unfinished tasks on the dead node — their pre-computed
``task-finished``/``completion`` events are cancelled, the dead node's
reserved occupancy is released (lost-work seconds accounted), the finished
task prefix is salvaged, and the remainder requeues as a reduced
sub-workflow after a capped exponential backoff in *virtual* time
(:func:`retry_backoff`).  A per-submission retry budget
(``ServiceConfig.max_retries``) bounds the loop; exhausting it ends the
record in the terminal ``failed`` status with a recorded reason.  Admission
infeasibility while part of the continuum is down is treated as transient
and retried the same way.  Solver-level degradation is separate: a
``ServiceConfig.fallback`` chain routes single solves through
:func:`repro_torch.core.api.solve_with_fallback`.

Everything is deterministic: same trace + seed ⇒ bit-identical event log
and per-submission makespans (asserted in tests) — backoff is computed in
virtual time, so chaos runs replay exactly.

Where solving runs: ``device`` (default ``"cuda"``) and ``engine`` (default
``"auto"``: the makespan kernel on a CUDA device) reach every engine-aware
technique, single and batched.  They are arguments of the service, not
fields of :class:`ServiceConfig`, whose JSON is part of the result and reads
the same on any device.  A fault of the device layer propagates out of
:meth:`SchedulingService.run`; a tenant's own fault rejects one submission.
"""

from __future__ import annotations

import dataclasses
import math
import time
import zlib
from pathlib import Path
from typing import Any

import numpy as np

from repro_torch import obs
from repro_torch.core.api import REGISTRY, SolverRegistry
from repro_torch.core.simulator import ExecutionReport, execute
from repro_torch.core.system_model import System
from repro_torch.core.workload_model import Constraints, Workflow, Workload, build_problem
from repro_torch.engine.packed import pack_cache
from repro_torch.service.admission import AdmissionBatcher, PreparedSubmission
from repro_torch.service.cache import SolveCache, solve_cache_key
from repro_torch.service.events import Event, EventLoop
from repro_torch.service.state import ContinuumState
from repro_torch.service.traces import Submission, Trace, load_trace

_LOG = obs.logger("service")


def retry_backoff(attempt: int, *, base: float = 1.0, cap: float = 60.0) -> float:
    """Capped exponential backoff (virtual seconds) before retry number
    ``attempt`` (1-based): ``min(cap, base * 2**(attempt - 1))``.

    Deliberately jitter-free — backoff runs on the *virtual* clock, so a
    chaos run replays bit-identically at a fixed seed."""
    if attempt < 1:
        raise ValueError(f"attempt must be >= 1, got {attempt}")
    return min(float(cap), float(base) * 2.0 ** (attempt - 1))


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Service knobs.  ``batch_window`` is how long (virtual seconds) the
    admission queue holds a submission hoping for batchable company;
    ``max_batch`` bounds one admission's size (the rest re-admit
    immediately after, preserving order).

    Fault-tolerance knobs: ``max_retries`` is the per-submission budget of
    requeues (preemption or transient infeasibility) before the terminal
    ``failed`` status; ``backoff_base``/``backoff_cap`` shape
    :func:`retry_backoff`; ``fallback`` is the solver degradation chain for
    single solves (e.g. ``("ga", "heft")``); ``solve_budget`` optionally
    bounds one submission's whole chain in wall seconds (leaves technique
    choice timing-dependent — keep ``None`` when replay determinism
    matters)."""

    batch_window: float = 0.25
    max_batch: int = 32
    cache_capacity: int = 4096
    smoothing: float = 1.0
    jitter: float = 0.0
    seed: int = 0
    log_task_events: bool = True
    max_retries: int = 3
    backoff_base: float = 1.0
    backoff_cap: float = 60.0
    fallback: tuple[str, ...] = ()
    solve_budget: float | None = None

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            # 0 would make every admit drain nothing and reschedule itself
            # at the same virtual instant, forever
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.batch_window < 0:
            raise ValueError(f"batch_window must be >= 0, got {self.batch_window}")
        if self.cache_capacity < 1:
            raise ValueError(
                f"cache_capacity must be >= 1, got {self.cache_capacity}"
            )
        if self.jitter < 0:
            raise ValueError(f"jitter must be >= 0, got {self.jitter}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base <= 0:
            raise ValueError(f"backoff_base must be > 0, got {self.backoff_base}")
        if self.backoff_cap <= 0:
            raise ValueError(f"backoff_cap must be > 0, got {self.backoff_cap}")
        if self.solve_budget is not None and self.solve_budget <= 0:
            raise ValueError(f"solve_budget must be > 0, got {self.solve_budget}")

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SubmissionRecord:
    """Lifecycle + outcome of one submission (the per-tenant API object)."""

    id: str
    tenant: str
    family: str
    technique: str  # requested
    arrival: float
    technique_used: str = ""
    admitted: float = math.nan
    dispatched: float = math.nan
    finished: float = math.nan
    queue_delay: float = 0.0
    predicted_makespan: float = math.nan
    observed_makespan: float = math.nan
    turnaround: float = math.nan
    cache_hit: bool = False
    batched: bool = False
    retries: int = 0  # requeues consumed (preemption / transient infeasibility)
    rescheduled_tasks: int = 0  # tasks sent back to admission by preemptions
    lost_work_seconds: float = 0.0  # busy-seconds burned on cancelled windows
    reason: str | None = None  # terminal reason for rejected / failed
    fallbacks: list[str] = dataclasses.field(default_factory=list)
    constrained: bool = False  # submission carried hard constraints
    deadline_miss: bool = False  # completed past its deadline / cycle deadline
    cycle: int = 0  # cycle index for cycling streams (0 otherwise)
    status: str = "queued"  # queued | running | completed | rejected | failed

    def to_json(self) -> dict[str, Any]:
        # NaN marks not-yet/never-happened timestamps internally; serialize
        # as null so the output is strict JSON (bare NaN tokens are not)
        return {
            k: None if isinstance(v, float) and math.isnan(v) else v
            for k, v in dataclasses.asdict(self).items()
        }


@dataclasses.dataclass
class ServiceResult:
    """Everything a run produced: per-submission records, the replayable
    event log, and aggregate service metrics."""

    trace: str
    config: ServiceConfig
    records: list[SubmissionRecord]
    event_log: list[dict[str, Any]]
    cache: dict[str, Any]
    #: delta over the process-global engine pack LRU for this run — NOT part
    #: of the replay-determinism contract (a second in-process replay hits
    #: where the first missed, by design)
    pack_cache: dict[str, Any]
    solver_calls: int
    batched_groups: int
    batched_submissions: int
    clock_end: float
    wall_seconds: float
    nodes: list[dict[str, Any]]
    #: cycling stream accounting (zeros on traces without cycling specs)
    cycling: dict[str, Any] = dataclasses.field(default_factory=dict)

    def makespans(self) -> dict[str, float | None]:
        """id → observed makespan (None when rejected/unfinished) — the
        replay-determinism fingerprint used by the tests.  None, not NaN:
        two identical runs must compare equal, and NaN != NaN."""
        return {
            r.id: None if math.isnan(r.observed_makespan) else r.observed_makespan
            for r in self.records
        }

    def summary(self) -> dict[str, Any]:
        completed = [r for r in self.records if r.status == "completed"]
        turnaround = np.array([r.turnaround for r in completed], dtype=np.float64)
        delays = np.array([r.queue_delay for r in completed], dtype=np.float64)
        out: dict[str, Any] = {
            "trace": self.trace,
            "submissions": len(self.records),
            "completed": len(completed),
            "rejected": sum(1 for r in self.records if r.status == "rejected"),
            "clock_end": self.clock_end,
            "wall_seconds": self.wall_seconds,
            "throughput_per_wall_s": (
                len(completed) / self.wall_seconds if self.wall_seconds > 0 else 0.0
            ),
            "throughput_per_virtual_s": (
                len(completed) / self.clock_end if self.clock_end > 0 else 0.0
            ),
            "cache": dict(self.cache),
            "pack_cache": dict(self.pack_cache),
            "solver_calls": self.solver_calls,
            "batched_groups": self.batched_groups,
            "batched_submissions": self.batched_submissions,
            "events": len(self.event_log),
            "nodes": self.nodes,
        }
        if len(turnaround):
            # nearest-rank percentiles (repro_torch.obs.nearest_rank): always an
            # observed latency, never an interpolated one — the honest SLO
            # read for small samples
            out["turnaround"] = {
                "mean": float(turnaround.mean()),
                "p50": obs.nearest_rank(turnaround, 50),
                "p95": obs.nearest_rank(turnaround, 95),
                "max": float(turnaround.max()),
            }
            out["queue_delay_mean"] = float(delays.mean())
            out["queue_delay"] = {
                "p50": obs.nearest_rank(delays, 50),
                "p95": obs.nearest_rank(delays, 95),
                "p99": obs.nearest_rank(delays, 99),
                "max": float(delays.max()),
            }
        # SLO / robustness metrics — all-zero on a fault-free run (new keys
        # only; pre-existing fields above stay byte-compatible)
        out["failed"] = sum(1 for r in self.records if r.status == "failed")
        stretch = [
            r.observed_makespan / r.predicted_makespan
            for r in completed
            if r.retries > 0 and r.predicted_makespan > 0
        ]
        robustness: dict[str, Any] = {
            "retries": int(sum(r.retries for r in self.records)),
            "preempted_submissions": sum(
                1 for r in self.records if r.rescheduled_tasks > 0
            ),
            "rescheduled_tasks": int(
                sum(r.rescheduled_tasks for r in self.records)
            ),
            "lost_work_seconds": float(
                sum(r.lost_work_seconds for r in self.records)
            ),
        }
        if stretch:
            # failure-induced makespan stretch: observed over originally
            # predicted, for completed submissions that were preempted
            robustness["makespan_stretch"] = {
                "mean": float(np.mean(stretch)),
                "max": float(np.max(stretch)),
            }
        out["robustness"] = robustness
        # constraint / cycling accounting (new keys only; all-zero on
        # traces without constraints or cycling specs)
        out["constrained_submissions"] = sum(
            1 for r in self.records if r.constrained
        )
        out["deadline_misses"] = sum(1 for r in self.records if r.deadline_miss)
        out["cycling"] = dict(self.cycling)
        return out


def _reduced_workflow(wf: Workflow, done: set[str], attempt: int) -> Workflow:
    """The unfinished remainder of ``wf`` as a standalone workflow.

    The salvaged ``done`` set is dependency-closed by construction (a task
    can only finish after its predecessors finished), so dropping done tasks
    and their incoming dep edges leaves a valid DAG.  The ``~r<attempt>``
    name suffix keeps retry shapes distinguishable in logs and content
    hashes."""
    base = wf.name.split("~r", 1)[0]
    tasks = tuple(
        dataclasses.replace(t, deps=tuple(d for d in t.deps if d not in done))
        for t in wf.tasks
        if t.name not in done
    )
    return dataclasses.replace(wf, name=f"{base}~r{attempt}", tasks=tasks)


def _parse_cycle_id(sid: str) -> tuple[str, int]:
    """``"s003@c2"`` → ``("s003", 2)``; plain ids are cycle 0 of themselves."""
    base, sep, suffix = sid.rpartition("@c")
    if sep and suffix.isdigit():
        return base, int(suffix)
    return sid, 0


def _retarget_constraints(cons: Constraints, wf: Workflow) -> Constraints:
    """Rekey a submission's constraints onto its current workflow.

    A submission carries exactly one workflow, so every workflow-level key
    refers to it — but the workflow's *name* moves under the service's feet
    (retry remainders are renamed ``~r<n>`` and lose their finished tasks).
    Workflow-level keys follow the current name; task-qualified deadline
    keys keep only still-present tasks (a salvaged task's deadline is moot).
    """
    names = {t.name for t in wf.tasks}
    deadline: dict[str, float] = {}
    for key, value in cons.deadline.items():
        if "/" in key:
            task = key.split("/", 1)[1]
            if task in names:
                deadline[f"{wf.name}/{task}"] = float(value)
        else:
            deadline[wf.name] = float(value)
    budget = {wf.name: float(v) for v in cons.budget.values()}
    placement = {wf.name: tuple(v) for v in cons.placement.values()}
    return Constraints(
        deadline=deadline,
        budget=budget,
        cost_rate=dict(cons.cost_rate),
        placement=placement,
    )


@dataclasses.dataclass
class _InFlight:
    prepared: PreparedSubmission
    report: ExecutionReport
    t0: float
    #: seq → cancellation token for every still-scheduled task-finished /
    #: completion event of this dispatch (preemption retracts them)
    pending: dict[int, Event] = dataclasses.field(default_factory=dict)


class SchedulingService:
    """One live service instance over one shared continuum."""

    def __init__(
        self,
        system: System,
        config: ServiceConfig = ServiceConfig(),
        *,
        registry: SolverRegistry | None = None,
        device="cuda",
        engine: str = "auto",
    ) -> None:
        self.system = system
        self.config = config
        self.registry = registry if registry is not None else REGISTRY
        self.state = ContinuumState(system, smoothing=config.smoothing)
        self.cache = SolveCache(config.cache_capacity)
        self.batcher = AdmissionBatcher(
            self.registry,
            self.cache,
            fallback=config.fallback,
            solve_budget=config.solve_budget,
            device=device,
            engine=engine,
        )
        self.loop = EventLoop()
        self.records: dict[str, SubmissionRecord] = {}
        self.solver_calls = 0
        self.batched_groups = 0
        self.batched_submissions = 0
        self._submissions: dict[str, Submission] = {}
        #: as-registered workflows — preemption retries swap a reduced
        #: remainder into ``_submissions``, but a spawned next cycle must
        #: run the full original DAG
        self._originals: dict[str, Workflow] = {}
        self._queue: list[str] = []  # submission ids awaiting admission
        self._admit_scheduled = False
        self._inflight: dict[str, _InFlight] = {}
        # cross-submission dependency gating (``Submission.after``)
        self._waiting: dict[str, set[str]] = {}  # sid → unmet dep ids
        self._dependents: dict[str, list[str]] = {}  # dep id → gated sids
        self._gated = 0  # submissions that were held at least once
        self._spawned = 0  # cycle submissions synthesized at completion
        self._converged = 0  # converging streams ended by their predicate

    # ---- event handlers -----------------------------------------------------
    def _enqueue(self, sid: str) -> None:
        self._queue.append(sid)
        if not self._admit_scheduled:
            self.loop.push(self.loop.now + self.config.batch_window, "admit")
            self._admit_scheduled = True

    def _on_submission(self, ev: Event) -> None:
        sid = ev.payload["id"]
        sub = self._submissions[sid]
        unmet: set[str] = set()
        for dep in sub.after:
            status = self.records[dep].status
            if status == "completed":
                continue
            if status in ("rejected", "failed"):
                self._reject_for_dep(sid, dep)
                return
            unmet.add(dep)
        if unmet:
            self._waiting[sid] = unmet
            for dep in unmet:
                self._dependents.setdefault(dep, []).append(sid)
            self._gated += 1
            obs.METRICS.counter("service.gated").inc()
            return
        self._enqueue(sid)

    def _on_admit(self, _ev: Event) -> None:
        self._admit_scheduled = False
        if not self._queue:
            return
        batch_ids = self._queue[: self.config.max_batch]
        del self._queue[: self.config.max_batch]
        if self._queue:
            # overflow re-admits at the same virtual instant, in order
            self.loop.push(self.loop.now, "admit")
            self._admit_scheduled = True
        self._admit_batch(batch_ids)

    def _on_task_finished(self, ev: Event) -> None:
        # occupancy was reserved at dispatch; drop the cancellation token
        # (``get``: a task finishing exactly at a preemption instant may
        # outlive its submission's in-flight entry — the work did happen)
        fl = self._inflight.get(ev.payload["id"])
        if fl is not None:
            fl.pending.pop(ev.seq, None)

    def _on_completion(self, ev: Event) -> None:
        sid = ev.payload["id"]
        fl = self._inflight.pop(sid)
        self.state.retire(sid)
        with obs.TRACER.span("state.observe", cat="service.state"):
            self.state.observe(fl.prepared.problem, fl.report, fl.prepared.baked)
        obs.METRICS.counter("service.completed").inc()
        rec = self.records[sid]
        rec.finished = self.loop.now
        if rec.retries:
            # spans first dispatch → final finish, across every preemption
            # and requeue (the failure-induced stretch the summary reports)
            rec.observed_makespan = rec.finished - rec.dispatched
        else:
            rec.observed_makespan = float(fl.report.makespan)
        rec.turnaround = rec.finished - rec.arrival
        rec.status = "completed"
        sub = self._submissions[sid]
        deadline = sub.deadline
        if sub.cycling is not None and sub.cycling.cycle_deadline is not None:
            cd = sub.cycling.cycle_deadline
            deadline = cd if deadline is None else min(deadline, cd)
        if deadline is not None and rec.observed_makespan > deadline:
            rec.deadline_miss = True
            obs.METRICS.counter("service.deadline_miss").inc()
            self.loop.emit(
                "deadline-miss",
                id=sid,
                deadline=float(deadline),
                observed=float(rec.observed_makespan),
            )
        self._release_dependents(sid)
        self._maybe_spawn_cycle(sid)

    def _on_node_drift(self, ev: Event) -> None:
        self.state.set_drift(ev.payload["node"], ev.payload["factor"])

    def _on_node_failure(self, ev: Event) -> None:
        node = ev.payload["node"]
        self.state.fail(node)
        idx = self.state.index_of(node)
        now = self.loop.now
        victims = [
            sid
            for sid, fl in self._inflight.items()
            if any(
                log.node == idx and fl.t0 + log.finish > now
                for log in fl.report.logs
            )
        ]
        for sid in victims:
            self._preempt(sid, node)

    def _on_node_recovery(self, ev: Event) -> None:
        self.state.recover(ev.payload["node"])

    def _on_requeue(self, ev: Event) -> None:
        self._enqueue(ev.payload["id"])

    # ---- dependency gating + cycling ----------------------------------------
    def _release_dependents(self, dep: str) -> None:
        """``dep`` completed: admit every gated submission whose last unmet
        dependency it was (at the completion instant — never before)."""
        for sid in self._dependents.pop(dep, ()):
            unmet = self._waiting.get(sid)
            if unmet is None:
                continue
            unmet.discard(dep)
            if not unmet:
                del self._waiting[sid]
                self._enqueue(sid)

    def _reject_for_dep(self, sid: str, dep: str) -> None:
        rec = self.records[sid]
        rec.status = "rejected"
        rec.finished = self.loop.now
        rec.turnaround = rec.finished - rec.arrival
        rec.reason = f"dependency-failed: {dep}"
        obs.METRICS.counter("service.rejected").inc()
        _LOG.info("rejected %s: %s", sid, rec.reason)
        self.loop.emit("rejected", id=sid, reason=rec.reason)
        self._cascade_terminal(sid)

    def _cascade_terminal(self, sid: str) -> None:
        """``sid`` ended without completing (rejected/failed): every gated
        submission waiting on it can never run — reject them, transitively."""
        for dsid in self._dependents.pop(sid, ()):
            if self._waiting.pop(dsid, None) is not None:
                self._reject_for_dep(dsid, sid)

    def _register_spawned(self, sub: Submission, *, cycle: int) -> None:
        self._submissions[sub.id] = sub
        self._originals[sub.id] = sub.workflow
        self.records[sub.id] = SubmissionRecord(
            id=sub.id,
            tenant=sub.tenant,
            family=sub.family,
            technique=sub.technique,
            arrival=sub.time,
            constrained=bool(sub.constraints),
            cycle=cycle,
        )

    def _maybe_spawn_cycle(self, sid: str) -> None:
        """A cycling submission completed cycle ``k``: spawn cycle ``k+1``
        one period out, unless the fixed count is reached or the seeded
        convergence predicate fires.  The predicate keys on the *base*
        submission id, so each stream converges independently and replays
        bit-identically."""
        sub = self._submissions[sid]
        spec = sub.cycling
        if spec is None:
            return
        base, cycle = _parse_cycle_id(sid)
        if spec.converging:
            done = spec.converge.converged(base, cycle)
        else:
            done = cycle + 1 >= (spec.cycles or 1)
        if done:
            if spec.converging:
                self._converged += 1
            self.loop.emit("converged", id=sid, base=base, cycles=cycle + 1)
            return
        nxt = dataclasses.replace(
            sub,
            id=f"{base}@c{cycle + 1}",
            time=self.loop.now + spec.period,
            workflow=self._originals[sid],
            after=(sid,),
        )
        self._register_spawned(nxt, cycle=cycle + 1)
        self._spawned += 1
        obs.METRICS.counter("service.cycles_spawned").inc()
        self.loop.emit("cycle-spawned", id=nxt.id, base=base, cycle=cycle + 1)
        self.loop.push(
            nxt.time, "submission", id=nxt.id, tenant=nxt.tenant, family=nxt.family
        )

    # ---- fault tolerance ------------------------------------------------------
    def _preempt(self, sid: str, node: str) -> None:
        """A node failure invalidated ``sid``'s in-flight execution: cancel
        its still-scheduled events, release its reserved occupancy, salvage
        the finished task prefix, and requeue the remainder."""
        now = self.loop.now
        fl = self._inflight.pop(sid)
        for pev in fl.pending.values():
            if pev.time > now:  # same-time events already fired or will —
                self.loop.cancel(pev)  # only genuinely-future ones retract
        with obs.TRACER.span("state.release", cat="service.state",
                             args={"id": sid, "node": node}):
            lost, _cancelled = self.state.release(sid, now)
        obs.METRICS.counter("service.preemptions").inc()
        obs.METRICS.counter("service.lost_work_seconds").inc(lost)
        _LOG.info("preempted %s (failure of %s, %.1fs lost work)",
                  sid, node, lost)
        sub = self._submissions[sid]
        done = {log.task for log in fl.report.logs if fl.t0 + log.finish <= now}
        rescheduled = len(sub.workflow.tasks) - len(done)
        rec = self.records[sid]
        rec.rescheduled_tasks += rescheduled
        rec.lost_work_seconds += lost
        self._submissions[sid] = dataclasses.replace(
            sub,
            workflow=_reduced_workflow(sub.workflow, done, rec.retries + 1),
        )
        self.loop.emit(
            "preempted",
            id=sid,
            node=node,
            salvaged=len(done),
            rescheduled=rescheduled,
            lost_work=lost,
        )
        self._requeue_or_fail(sid, cause=f"preempted by failure of {node}")

    def _requeue_or_fail(self, sid: str, *, cause: str) -> None:
        """Spend one retry on ``sid`` (backoff in virtual time) or, with the
        budget exhausted, end it in the terminal ``failed`` status."""
        rec = self.records[sid]
        if rec.retries >= self.config.max_retries:
            rec.status = "failed"
            rec.finished = self.loop.now
            rec.turnaround = rec.finished - rec.arrival
            rec.reason = (
                f"retry budget exhausted ({self.config.max_retries}); "
                f"last: {cause}"
            )
            obs.METRICS.counter("service.failed").inc()
            _LOG.warning("failed %s: %s", sid, rec.reason)
            self.loop.emit("failed", id=sid, reason=rec.reason)
            self._cascade_terminal(sid)
            return
        obs.METRICS.counter("service.requeues").inc()
        rec.retries += 1
        rec.status = "queued"
        delay = retry_backoff(
            rec.retries,
            base=self.config.backoff_base,
            cap=self.config.backoff_cap,
        )
        self.loop.push(
            self.loop.now + delay,
            "requeue",
            id=sid,
            retry=rec.retries,
            backoff=delay,
            cause=cause,
        )

    # ---- admission + dispatch -----------------------------------------------
    def _admit_batch(self, batch_ids: list[str]) -> None:
        now = self.loop.now
        prepared: list[PreparedSubmission] = []
        with obs.TRACER.span("state.effective_system", cat="service.state"):
            effective = self.state.effective_system()
        baked = self.state.baked_factors()
        for sid in batch_ids:
            sub = self._submissions[sid]
            cons = None
            if sub.constraints is not None and sub.constraints:
                cons = _retarget_constraints(sub.constraints, sub.workflow)
            problem = self.state.apply_health(
                build_problem(effective, Workload((sub.workflow,)), cons)
            )
            prepared.append(
                PreparedSubmission(
                    submission=sub,
                    problem=problem,
                    key=solve_cache_key(
                        problem, sub.weights, sub.technique, sub.solver_options
                    ),
                    baked=baked,
                )
            )
        with obs.TRACER.span("service.admit", cat="service",
                             args={"batch": len(batch_ids)}):
            stats = self.batcher.admit(prepared)
        self.solver_calls += stats.solver_calls
        self.batched_groups += stats.batched_groups
        self.batched_submissions += stats.batched_submissions
        obs.METRICS.counter("service.solver_calls").inc(stats.solver_calls)
        obs.METRICS.counter("service.admission.batched_groups").inc(
            stats.batched_groups
        )
        obs.METRICS.counter("service.admission.batched_submissions").inc(
            stats.batched_submissions
        )

        for prep in prepared:
            rec = self.records[prep.submission.id]
            if math.isnan(rec.admitted):
                rec.admitted = now
            rec.cache_hit = prep.cache_hit
            rec.batched = prep.batched
            if prep.fallbacks:
                rec.fallbacks = list(prep.fallbacks)
            sched = prep.schedule
            if sched is None or sched.violations != 0:
                reason = (
                    prep.error
                    or f"violations={sched.violations if sched else 'unsolved'}"
                )
                if prep.error is None and not all(self.state.up.values()):
                    # infeasible while part of the continuum is down: treat
                    # as transient — back off and retry rather than reject
                    self._requeue_or_fail(
                        prep.submission.id, cause=f"{reason} (node down)"
                    )
                    continue
                rec.status = "rejected"
                rec.reason = reason
                obs.METRICS.counter("service.rejected").inc()
                _LOG.info("rejected %s: %s", prep.submission.id, reason)
                self.loop.emit("rejected", id=prep.submission.id, reason=reason)
                self._cascade_terminal(prep.submission.id)
                continue
            rec.technique_used = sched.technique
            self._dispatch(prep)

    def _dispatch(self, prep: PreparedSubmission) -> None:
        sub = prep.submission
        sched = prep.schedule
        assert sched is not None
        now = self.loop.now
        delay = self.state.queue_delay(sched.assignment, now)
        obs.METRICS.histogram("service.queue_delay").observe(delay)
        t0 = now + delay
        # derived, stable per-submission seed — jitter replays identically
        seed = zlib.crc32(f"{self.config.seed}:{sub.id}".encode()) & 0x7FFFFFFF
        with obs.TRACER.span("service.dispatch", cat="service",
                             args={"id": sub.id}):
            report = execute(
                prep.problem,
                sched,
                speed_factors=self.state.residual_factors(),
                jitter=self.config.jitter,
                seed=seed,
                strict=False,
            )
            with obs.TRACER.span("state.reserve", cat="service.state"):
                self.state.reserve(report, t0, sid=sub.id)
        rec = self.records[sub.id]
        if math.isnan(rec.dispatched):
            # first dispatch only — on a retry the original timestamps (and
            # the original predicted makespan, the stretch baseline) stand
            rec.dispatched = t0
            rec.predicted_makespan = float(sched.makespan)
        rec.queue_delay += delay  # accumulates across requeues
        rec.status = "running"
        extra: dict[str, Any] = {"retry": rec.retries} if rec.retries else {}
        self.loop.emit(
            "dispatch",
            id=sub.id,
            start=t0,
            queue_delay=delay,
            technique=sched.technique,
            predicted_makespan=float(sched.makespan),
            cache_hit=prep.cache_hit,
            batched=prep.batched,
            **extra,
        )
        pending: dict[int, Event] = {}
        if self.config.log_task_events:
            for log in report.logs:
                tev = self.loop.push(
                    t0 + log.finish,
                    "task-finished",
                    id=sub.id,
                    task=log.task,
                    node=self.state.node_names[log.node],
                )
                pending[tev.seq] = tev
        cev = self.loop.push(t0 + report.makespan, "completion", id=sub.id)
        pending[cev.seq] = cev
        self._inflight[sub.id] = _InFlight(
            prepared=prep, report=report, t0=t0, pending=pending
        )

    # ---- the run loop -------------------------------------------------------
    _HANDLERS = {
        "submission": _on_submission,
        "admit": _on_admit,
        "task-finished": _on_task_finished,
        "completion": _on_completion,
        "node-drift": _on_node_drift,
        "node-failure": _on_node_failure,
        "node-recovery": _on_node_recovery,
        "requeue": _on_requeue,
    }

    def run(self, trace: Trace) -> ServiceResult:
        wall0 = time.perf_counter()
        pack_stats0 = pack_cache().stats.snapshot()
        for sub in trace.submissions:
            if sub.id in self._submissions:
                # ids key every lifecycle structure; a silent overwrite
                # surfaces later as a KeyError on the twin's completion
                raise ValueError(f"duplicate submission id {sub.id!r} in trace")
            self._submissions[sub.id] = sub
            self._originals[sub.id] = sub.workflow
            _base, cycle = _parse_cycle_id(sub.id)
            self.records[sub.id] = SubmissionRecord(
                id=sub.id,
                tenant=sub.tenant,
                family=sub.family,
                technique=sub.technique,
                arrival=sub.time,
                constrained=bool(sub.constraints),
                cycle=cycle,
            )
            self.loop.push(
                sub.time, "submission",
                id=sub.id, tenant=sub.tenant, family=sub.family,
            )
        for sub in trace.submissions:
            for dep in sub.after:
                if dep not in self._submissions:
                    # same fail-fast-at-source rationale as unknown nodes
                    raise ValueError(
                        f"submission {sub.id!r} waits on unknown submission "
                        f"{dep!r}"
                    )
                if dep == sub.id:
                    raise ValueError(f"submission {sub.id!r} waits on itself")
        known = set(self.state.node_names)
        for nev in trace.events:
            if nev.node not in known:
                # fail fast and loud — deferring this surfaces as a baffling
                # KeyError at some later admission instead of at the source
                raise ValueError(
                    f"trace event {nev.kind!r} at t={nev.time} names unknown "
                    f"node {nev.node!r}; system has {sorted(known)}"
                )
            if nev.kind == "node-drift" and (
                nev.factor is None or not float(nev.factor) > 0
            ):
                # same fail-fast-at-source rationale as unknown nodes;
                # ``not >`` (rather than ``<=``) also catches NaN
                raise ValueError(
                    f"trace drift event at t={nev.time} for node "
                    f"{nev.node!r} needs a factor > 0, got {nev.factor!r}"
                )
            payload: dict[str, Any] = {"node": nev.node}
            if nev.factor is not None:
                payload["factor"] = nev.factor
            self.loop.push(nev.time, nev.kind, **payload)

        # the tracer's virtual clock follows this loop for the duration of
        # the run, so spans carry event-loop timestamps next to wall time
        tracer = obs.TRACER
        prev_clock = tracer.set_virtual_clock(lambda: self.loop.now)
        try:
            with tracer.span("service.run", cat="service",
                             args={"trace": trace.name}):
                for ev in self.loop.drain():
                    self.loop.record(ev)
                    handler = self._HANDLERS.get(ev.kind)
                    if handler is None:
                        raise ValueError(f"unknown event kind {ev.kind!r}")
                    if tracer.enabled:
                        with tracer.span("event." + ev.kind,
                                         cat="service.events",
                                         args={"seq": ev.seq}):
                            handler(self, ev)
                    else:
                        handler(self, ev)
        finally:
            tracer.set_virtual_clock(prev_clock)

        delta = pack_cache().stats.delta(pack_stats0)
        return ServiceResult(
            trace=trace.name,
            config=self.config,
            # insertion order: trace submissions first (in trace order),
            # then service-spawned cycles as they appeared
            records=list(self.records.values()),
            event_log=list(self.loop.log),
            cache=self.cache.stats.to_json(),
            pack_cache=delta.to_json(),
            solver_calls=self.solver_calls,
            batched_groups=self.batched_groups,
            batched_submissions=self.batched_submissions,
            clock_end=self.loop.now,
            wall_seconds=time.perf_counter() - wall0,
            nodes=[s.to_json() for s in self.state.status()],
            cycling={
                "streams": sum(
                    1
                    for s in trace.submissions
                    if s.cycling is not None
                ),
                "spawned_cycles": self._spawned,
                "converged_streams": self._converged,
                "gated_submissions": self._gated,
            },
        )


def serve_trace(
    trace: Trace | str | Path,
    *,
    system: System | None = None,
    config: ServiceConfig = ServiceConfig(),
    registry: SolverRegistry | None = None,
    device="cuda",
    engine: str = "auto",
) -> ServiceResult:
    """One-call entry point: trace (or path) in, :class:`ServiceResult` out.

    ``system`` overrides the trace's embedded continuum when given;
    ``device`` and ``engine`` say where and how engine-aware techniques score
    their populations (the makespan kernel on the card by default)."""
    if not isinstance(trace, Trace):
        trace = load_trace(trace)
    if system is not None:
        trace = dataclasses.replace(trace, system=system)
    service = SchedulingService(
        trace.system, config, registry=registry, device=device, engine=engine
    )
    return service.run(trace)
