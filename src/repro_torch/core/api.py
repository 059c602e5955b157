"""Scenario-first public API (paper Fig. 4): registry, policy, scenario, loop.

The paper's headline contribution is *automated orchestration* — model →
optimize → dispatch → monitor → re-solve.  This module makes that loop the
product surface:

* :class:`SolverRegistry` / :func:`register_solver` — every technique of
  Table VII is a registered plugin carrying capability metadata (exactness,
  size ceiling, batch support).  Out-of-tree solvers register with one
  decorator and are immediately routable by ``technique=`` or by policy.
* :class:`Policy` — the §VII hybrid (exact MILP when small, meta-heuristic in
  the mid range, heuristic at scale) as an inspectable, user-overridable rule
  chain instead of hard-coded thresholds.
* :class:`Scenario` — one declarative spec (system + workload + weights +
  technique/policy + executor backend + perturbation model) with JSON
  round-trip, sharing the Fig. 7/8 file format via
  :func:`repro_torch.core.snakemake_io.load_config`.
* :class:`Orchestrator` — the full Fig. 4 closed loop: build problem, solve
  via the registry, dispatch (simulate / slurm / kubernetes), fold
  :mod:`repro_torch.core.monitor` speed feedback into node properties, and re-solve
  while observed drift exceeds the threshold.  Returns a structured
  :class:`RunResult`.

Fig. 4 step → class mapping:

====  =========================  =========================================
step  paper                      here
====  =========================  =========================================
1     modeling                   ``Scenario`` (system/workload spec)
2     optimization               ``SolverRegistry`` + ``Policy``
3     sorted JSON schedule       ``Schedule.to_json`` (unchanged contract)
4     deploy & execution         ``executor.dispatch`` backends
4→1   monitoring feedback        ``MonitorState`` inside ``Orchestrator``
====  =========================  =========================================

The legacy free functions (``solve``, ``solve_problem``, ``solve_problems``,
``compare_techniques``) live here too; :mod:`repro_torch.core.solver`
re-exports them as deprecation shims.

Every entry point that reaches a metaheuristic takes ``device`` (default
``"cuda"``): it travels, like the scenario's ``engine``, as a scoped option
of each engine-aware technique only, so MILP and the heuristics, which run
on the host, never see it.  Scenario files carry no device: the same file
runs on the card or, with ``device="cpu"``, on the CPU.
"""

from __future__ import annotations

import dataclasses
import difflib
import json
import time
from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable, Iterable, Mapping, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import heuristics, metaheuristics
from repro_torch.core.evaluator import ObjectiveWeights, Schedule
from repro_torch.core.milp import MilpSizeError, solve_milp
from repro_torch.core.monitor import MonitorState
from repro_torch.core.simulator import ExecutionReport, execute
from repro_torch.core.snakemake_io import load_config
from repro_torch.core.system_model import System, system_to_json
from repro_torch.core.executor import DEFAULT_OUT_DIR
from repro_torch.core.workload_model import (
    Constraints,
    ScheduleProblem,
    Workload,
    build_problem,
    canonical_hash,
    constraints_from_json,
    workload_to_json,
)
from repro_torch.kernels._build import KernelError

if TYPE_CHECKING:  # runtime import is lazy: repro_torch.cycling imports workload_model
    from repro_torch.cycling import CycleSpec


def cycle_spec_from_json(obj: Any) -> "CycleSpec | None":
    """Lazy wrapper around :func:`repro_torch.cycling.cycle_spec_from_json` —
    imported at call time because :mod:`repro_torch.cycling` itself imports
    :mod:`repro_torch.core.workload_model`."""
    from repro_torch.cycling import cycle_spec_from_json as _parse

    return _parse(obj)


_LOG = obs.logger("core.api")

#: Faults of the device layer: a kernel that fails to build, load, launch or
#: take its inputs, the card out of memory, a CUDA error from a torch op.
#: :func:`solve_with_fallback` re-raises these instead of degrading past them,
#: so a request meant for the card never quietly becomes host work.
DEVICE_ERRORS: tuple[type[BaseException], ...] = (KernelError, torch.OutOfMemoryError) + tuple(
    e for e in (getattr(torch, "AcceleratorError", None), getattr(torch.cuda, "CudaError", None))
    if e is not None
)


def did_you_mean(key: Any, options: Iterable[Any]) -> str:
    """`` — did you mean 'x'?`` suffix for error messages (or empty)."""
    close = difflib.get_close_matches(str(key), [str(o) for o in options], n=1)
    return f" — did you mean {close[0]!r}?" if close else ""


def reject_unknown_keys(
    obj: Mapping[str, Any], known: Iterable[str], *, context: str
) -> None:
    """Raise on the first key of ``obj`` not in ``known``, with a
    did-you-mean hint.  Strict parsing beats silent fallthrough: a typo'd
    ``"tehcnique"`` must fail loudly, not quietly route to the default
    policy."""
    known = tuple(known)
    unknown = [k for k in obj if k not in known]
    if unknown:
        k = unknown[0]
        raise ValueError(
            f"unknown {context} key {k!r}{did_you_mean(k, known)}; "
            f"valid keys: {sorted(known)}"
        )


@dataclasses.dataclass
class SolveReport:
    """One solve: the chosen schedule plus provenance (Fig. 4 step 2 → 3)."""

    schedule: Schedule
    problem: ScheduleProblem
    history: np.ndarray | None = None
    fallbacks: tuple[str, ...] = ()


# -----------------------------------------------------------------------------
# Solver registry
# -----------------------------------------------------------------------------

SolverFn = Callable[..., SolveReport]
BatchSolverFn = Callable[..., "list[SolveReport] | None"]


@dataclasses.dataclass(frozen=True)
class SolverCapabilities:
    """Routing metadata a technique declares at registration time.

    ``max_tasks`` is the size ceiling above which the technique must not be
    *routed to* by a policy (it may still raise on direct calls, like MILP's
    own ``max_tasks`` guard).  ``supports_batch`` advertises a family solver
    (one batched solve over many instances, e.g. ``ga_sweep``).
    ``engine_aware`` marks techniques that take a ``backend=`` kwarg naming
    an evaluation engine from :data:`repro_torch.engine.ENGINES` — a
    scenario's ``engine`` selection, and the caller's ``device``, are
    forwarded only to these.
    ``constraint_aware`` marks techniques that *enforce* hard constraints
    (deadlines/budgets/placement, :class:`~repro_torch.core.workload_model.Constraints`)
    rather than merely having them scored as violations by the oracle —
    MILP adds rows, HEFT/OLB filter candidates, the metaheuristics penalize
    fitness in the batched engine path.
    """

    exact: bool = False
    max_tasks: int | None = None
    supports_batch: bool = False
    needs_time_limit: bool = False
    engine_aware: bool = False
    constraint_aware: bool = False


@dataclasses.dataclass(frozen=True)
class SolverEntry:
    name: str
    fn: SolverFn
    capabilities: SolverCapabilities
    batch_fn: BatchSolverFn | None = None


class SolverRegistry:
    """Name → solver mapping with capability metadata.

    Replaces the old hard-coded ``_DISPATCH`` dict: techniques self-describe,
    policies route over the metadata, and plugins register without touching
    core code."""

    def __init__(self) -> None:
        self._entries: dict[str, SolverEntry] = {}

    # ---- registration -------------------------------------------------------
    def register(
        self,
        name: str,
        fn: SolverFn | None = None,
        *,
        exact: bool = False,
        max_tasks: int | None = None,
        supports_batch: bool = False,
        needs_time_limit: bool = False,
        engine_aware: bool = False,
        constraint_aware: bool = False,
        batch_fn: BatchSolverFn | None = None,
        overwrite: bool = False,
    ):
        """Register ``fn`` under ``name``; usable directly or as a decorator.

        ``fn(problem, weights=..., **kwargs) -> SolveReport``.
        """

        caps = SolverCapabilities(
            exact=exact,
            max_tasks=max_tasks,
            supports_batch=supports_batch or batch_fn is not None,
            needs_time_limit=needs_time_limit,
            engine_aware=engine_aware,
            constraint_aware=constraint_aware,
        )

        def _add(f: SolverFn) -> SolverFn:
            if name in self._entries and not overwrite:
                raise ValueError(f"technique {name!r} already registered")
            self._entries[name] = SolverEntry(name, f, caps, batch_fn)
            return f

        return _add if fn is None else _add(fn)

    def unregister(self, name: str) -> None:
        self._entries.pop(name, None)

    # ---- lookup -------------------------------------------------------------
    def get(self, name: str) -> SolverEntry:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"unknown technique {name!r}; options {sorted(self._entries)}"
            ) from None

    def names(self) -> tuple[str, ...]:
        return tuple(self._entries)

    def capabilities(self, name: str) -> SolverCapabilities:
        return self.get(name).capabilities

    def __contains__(self, name: object) -> bool:
        return name in self._entries

    def __iter__(self):
        return iter(self._entries.values())

    # ---- solving ------------------------------------------------------------
    def solve(
        self,
        name: str,
        problem: ScheduleProblem,
        weights: ObjectiveWeights = ObjectiveWeights(),
        **kwargs: Any,
    ) -> SolveReport:
        return self.get(name).fn(problem, weights, **kwargs)

    def solve_batch(
        self,
        name: str,
        problems: Sequence[ScheduleProblem],
        weights: ObjectiveWeights = ObjectiveWeights(),
        **kwargs: Any,
    ) -> list[SolveReport]:
        """Solve a family; uses the technique's batch fast path when it can.

        A ``batch_fn`` may decline (return ``None``) — e.g. the GA sweep only
        batches through the packed device engines — in which case instances
        run one by one."""
        entry = self.get(name)
        if entry.batch_fn is not None and len(problems) > 1:
            reports = entry.batch_fn(problems, weights, **kwargs)
            if reports is not None:
                return reports
        return [entry.fn(p, weights, **kwargs) for p in problems]


REGISTRY = SolverRegistry()
"""The default process-wide registry (built-ins below; plugins welcome)."""


def register_solver(
    name: str,
    *,
    registry: SolverRegistry | None = None,
    **caps: Any,
):
    """Decorator: register a solver in the default (or given) registry.

    >>> @register_solver("my-greedy", exact=False)
    ... def my_greedy(problem, weights=ObjectiveWeights(), **kw) -> SolveReport:
    ...     ...
    """
    return (registry if registry is not None else REGISTRY).register(name, **caps)


# ---- built-in techniques (paper Table VII) ----------------------------------

def _milp_solver(capacity_mode: str) -> SolverFn:
    def run(problem, weights=ObjectiveWeights(), **kw) -> SolveReport:
        sched = solve_milp(problem, weights, capacity_mode=capacity_mode, **kw)
        return SolveReport(schedule=sched, problem=problem)

    return run


def _heuristic_solver(fn) -> SolverFn:
    def run(problem, weights=ObjectiveWeights(), **kw) -> SolveReport:
        return SolveReport(schedule=fn(problem, weights), problem=problem)

    return run


def _mh_solver(name: str) -> SolverFn:
    def run(problem, weights=ObjectiveWeights(), **kw) -> SolveReport:
        res = metaheuristics.TECHNIQUES[name](problem, weights, **kw)
        return SolveReport(schedule=res.schedule, problem=problem, history=res.history)

    return run


def _ga_batch(problems, weights=ObjectiveWeights(), **kw) -> list[SolveReport] | None:
    # the sweep scores the stacked family with one makespan call per
    # generation through a packed engine ('cuda' — which 'auto' names — or
    # the plain 'torch'); the per-candidate 'oracle' declines batching and
    # the family runs instance by instance.
    from repro_torch.engine.backends import resolve_engine

    if resolve_engine(kw.get("backend", "auto")) not in ("cuda", "torch"):
        return None
    results = metaheuristics.ga_sweep(list(problems), weights, **kw)
    return [
        SolveReport(schedule=r.schedule, problem=p, history=r.history)
        for r, p in zip(results, problems)
    ]


REGISTRY.register("milp", _milp_solver("event"), exact=True, max_tasks=60,
                  needs_time_limit=True, constraint_aware=True)
REGISTRY.register("milp-static", _milp_solver("static"), exact=True, max_tasks=60,
                  needs_time_limit=True, constraint_aware=True)
REGISTRY.register("heft", _heuristic_solver(heuristics.heft), constraint_aware=True)
REGISTRY.register("olb", _heuristic_solver(heuristics.olb), constraint_aware=True)
REGISTRY.register("ga", _mh_solver("ga"), batch_fn=_ga_batch, engine_aware=True,
                  constraint_aware=True)
REGISTRY.register("pso", _mh_solver("pso"), engine_aware=True, constraint_aware=True)
REGISTRY.register("sa", _mh_solver("sa"), engine_aware=True, constraint_aware=True)
REGISTRY.register("aco", _mh_solver("aco"), engine_aware=True, constraint_aware=True)


def __getattr__(name: str):
    if name == "ALL_TECHNIQUES":
        # live view over the open registry: plugins registered after import
        # are included (repro_torch.core and repro_torch.core.solver forward here)
        return REGISTRY.names()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# -----------------------------------------------------------------------------
# Routing policy (the §VII hybrid, data-driven)
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """One step of a routing chain: try ``technique`` when the size gate
    matches; fall through when the result misses the acceptance bar.

    ``accept_status`` are status *prefixes* (empty = any status accepted);
    ``forward_kwargs`` controls whether caller kwargs reach this technique
    (MILP, say, should not see GA population knobs)."""

    technique: str
    max_tasks: int | None = None
    min_tasks: int | None = None
    accept_status: tuple[str, ...] = ()
    require_valid: bool = True
    forward_kwargs: bool = True
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def applies(self, problem: ScheduleProblem) -> bool:
        t = problem.num_tasks
        if self.max_tasks is not None and t > self.max_tasks:
            return False
        if self.min_tasks is not None and t < self.min_tasks:
            return False
        return True

    def to_json(self) -> dict:
        return {
            "technique": self.technique,
            "max_tasks": self.max_tasks,
            "min_tasks": self.min_tasks,
            "accept_status": list(self.accept_status),
            "require_valid": self.require_valid,
            "forward_kwargs": self.forward_kwargs,
            "options": dict(self.options),
        }

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "PolicyRule":
        reject_unknown_keys(
            obj,
            (
                "technique",
                "max_tasks",
                "min_tasks",
                "accept_status",
                "require_valid",
                "forward_kwargs",
                "options",
            ),
            context="policy rule",
        )
        return cls(
            technique=obj["technique"],
            max_tasks=obj.get("max_tasks"),
            min_tasks=obj.get("min_tasks"),
            accept_status=tuple(obj.get("accept_status", ())),
            require_valid=bool(obj.get("require_valid", True)),
            forward_kwargs=bool(obj.get("forward_kwargs", True)),
            options=dict(obj.get("options", {})),
        )


@dataclasses.dataclass(frozen=True)
class Policy:
    """An ordered rule chain plus an unconditional fallback technique.

    ``Policy.paper_hybrid()`` reproduces the paper's conclusion (§VII):
    exact MILP under a size/time threshold, meta-heuristic in the mid range,
    heuristic at scale — but as data the user can inspect and override."""

    rules: tuple[PolicyRule, ...]
    final: str = "heft"

    @staticmethod
    def chain(*techniques: str) -> "Policy":
        """A pure fallback chain — try each technique in order, accept the
        first valid schedule, the last entry unconditionally final.  The
        declarative form of graceful degradation (``milp → ga → heft``):
        ``Policy.chain("milp", "ga", "heft")`` routes exactly like the
        imperative wrapper :func:`solve_with_fallback` walks its chain."""
        if not techniques:
            raise ValueError("Policy.chain needs at least one technique")
        *head, final = techniques
        return Policy(
            rules=tuple(PolicyRule(t, forward_kwargs=False) for t in head),
            final=final,
        )

    @staticmethod
    def paper_hybrid(
        milp_task_threshold: int = 25,
        mh_task_threshold: int = 600,
        milp_time_limit: float = 30.0,
    ) -> "Policy":
        return Policy(
            rules=(
                PolicyRule(
                    "milp",
                    max_tasks=milp_task_threshold,
                    accept_status=("optimal", "feasible"),
                    require_valid=False,
                    forward_kwargs=False,
                    options={"time_limit": milp_time_limit},
                ),
                PolicyRule("ga", max_tasks=mh_task_threshold),
            ),
            final="heft",
        )

    def route(
        self,
        problem: ScheduleProblem,
        weights: ObjectiveWeights = ObjectiveWeights(),
        *,
        registry: SolverRegistry | None = None,
        **kwargs: Any,
    ) -> SolveReport:
        """Route through the rule chain.

        Kwargs reach a rule's technique when the rule opts in
        (``forward_kwargs``).  A kwarg named after a registered technique
        whose value is a mapping is *scoped*: it goes only to that technique
        (overriding the rule's own defaults) — e.g.
        ``route(p, milp={"time_limit": 60.0})`` adjusts the MILP budget
        without leaking an unknown kwarg into the GA or HEFT steps."""
        reg = registry if registry is not None else REGISTRY
        scoped = {
            k: v for k, v in kwargs.items()
            if k in reg and isinstance(v, Mapping)
        }
        flat = {k: v for k, v in kwargs.items() if k not in scoped}
        fallbacks: list[str] = []
        for rule in self.rules:
            if not rule.applies(problem):
                continue
            caps = reg.capabilities(rule.technique)
            if caps.max_tasks is not None and problem.num_tasks > caps.max_tasks:
                fallbacks.append(f"{rule.technique}:size")
                continue
            kw = dict(rule.options)
            if rule.forward_kwargs:
                kw.update(flat)
            kw.update(scoped.get(rule.technique, {}))
            try:
                rep = reg.solve(rule.technique, problem, weights, **kw)
            except MilpSizeError as e:
                fallbacks.append(f"{rule.technique}:{e}")
                continue
            except ValueError as e:
                # only exact solvers get the wide defensive net (infeasible
                # models raise); approximate techniques' errors are real bugs
                if not caps.exact:
                    raise
                fallbacks.append(f"{rule.technique}:{e}")
                continue
            if rule.accept_status and not rep.schedule.status.startswith(
                tuple(rule.accept_status)
            ):
                fallbacks.append(f"{rule.technique}:{rep.schedule.status}")
                continue
            if rule.require_valid and rep.schedule.violations != 0:
                fallbacks.append(f"{rule.technique}:violations")
                continue
            rep.fallbacks = tuple(fallbacks)
            return rep
        rep = reg.solve(self.final, problem, weights, **scoped.get(self.final, {}))
        rep.fallbacks = tuple(fallbacks)
        return rep

    def to_json(self) -> dict:
        return {"rules": [r.to_json() for r in self.rules], "final": self.final}

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "Policy":
        reject_unknown_keys(obj, ("rules", "final"), context="policy")
        return cls(
            rules=tuple(PolicyRule.from_json(r) for r in obj.get("rules", ())),
            final=obj.get("final", "heft"),
        )


# -----------------------------------------------------------------------------
# Declarative Scenario
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Perturbation:
    """Ground-truth deviation model for the digital twin: per-node *true*
    speed multipliers (name → factor; 0.5 = node runs at half the modeled
    speed) plus optional lognormal per-task jitter."""

    speed_factors: Mapping[str, float] = dataclasses.field(default_factory=dict)
    jitter: float = 0.0
    seed: int | None = None

    def to_json(self) -> dict:
        return {
            "speed_factors": {k: float(v) for k, v in self.speed_factors.items()},
            "jitter": float(self.jitter),
            "seed": self.seed,
        }

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "Perturbation":
        reject_unknown_keys(
            obj, ("speed_factors", "jitter", "seed"), context="perturbation"
        )
        return cls(
            speed_factors=dict(obj.get("speed_factors", {})),
            jitter=float(obj.get("jitter", 0.0)),
            seed=obj.get("seed"),
        )


@dataclasses.dataclass(frozen=True)
class OrchestrationConfig:
    """Closed-loop knobs: how many solve→execute rounds, the observed-drift
    threshold that triggers a re-solve, and the monitor's EMA smoothing."""

    max_rounds: int = 3
    drift_threshold: float = 0.1
    smoothing: float = 1.0

    def to_json(self) -> dict:
        return {
            "max_rounds": int(self.max_rounds),
            "drift_threshold": float(self.drift_threshold),
            "smoothing": float(self.smoothing),
        }

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "OrchestrationConfig":
        reject_unknown_keys(
            obj,
            ("max_rounds", "drift_threshold", "smoothing"),
            context="orchestration",
        )
        return cls(
            max_rounds=int(obj.get("max_rounds", 3)),
            drift_threshold=float(obj.get("drift_threshold", 0.1)),
            smoothing=float(obj.get("smoothing", 1.0)),
        )


def _weights_to_json(w: ObjectiveWeights) -> dict:
    return {"alpha": float(w.alpha), "beta": float(w.beta), "usage_mode": w.usage_mode}


def _weights_from_json(obj: Mapping[str, Any]) -> ObjectiveWeights:
    reject_unknown_keys(obj, ("alpha", "beta", "usage_mode"), context="weights")
    return ObjectiveWeights(
        alpha=float(obj.get("alpha", 1.0)),
        beta=float(obj.get("beta", 1.0)),
        usage_mode=obj.get("usage_mode", "fixed"),
    )


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One declarative end-to-end run: what to schedule, how to solve it,
    where to dispatch it, and how reality may deviate from the model.

    Serializes to a single JSON file sharing the paper's Fig. 7 (``nodes``)
    and Fig. 8 (workflow) sections, with everything scenario-specific under a
    ``"scenario"`` header — so the same file still loads through
    :func:`repro_torch.core.snakemake_io.load_config`.

    ``solver_options`` reach the solver(s): flat keys are forwarded to the
    chosen technique (for ``"auto"``/``"policy"``, only to rules that opt
    into caller kwargs), while a key named after a technique whose value is
    a dict is scoped to that technique alone — e.g.
    ``{"milp": {"time_limit": 60.0}}`` tunes the MILP budget without leaking
    into GA/HEFT fallbacks.

    ``engine`` selects the schedule-evaluation backend
    (:data:`repro_torch.engine.ENGINES`: ``"auto"``, ``"cuda"``, ``"torch"``,
    ``"oracle"``, or a plugin); it reaches only engine-aware techniques.

    ``constraints`` layers hard deadlines/budgets/placement restrictions
    over the workload (:class:`~repro_torch.core.workload_model.Constraints`), and
    ``cycling`` turns it into a recurring/converging workload
    (:class:`~repro_torch.cycling.CycleSpec`) — solved here as one unrolled DAG
    over the bounded cycle window; the streaming expansion lives in
    :mod:`repro_torch.service`.  Both serialize as their own top-level sections."""

    name: str
    system: System
    workload: Workload
    weights: ObjectiveWeights = ObjectiveWeights()
    technique: str = "auto"
    policy: Policy | None = None
    backend: str = "simulate"
    engine: str = "auto"
    perturbation: Perturbation = Perturbation()
    orchestration: OrchestrationConfig = OrchestrationConfig()
    solver_options: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    constraints: Constraints | None = None
    cycling: CycleSpec | None = None

    _RESERVED_SECTIONS = (
        "scenario", "nodes", "dtr_matrix", "topology", "constraints", "cycling"
    )

    def to_json(self) -> dict:
        for wf in self.workload.workflows:
            if wf.name in self._RESERVED_SECTIONS:
                raise ValueError(
                    f"workflow name {wf.name!r} collides with a reserved "
                    f"scenario-file section {self._RESERVED_SECTIONS}"
                )
        header: dict[str, Any] = {
            "name": self.name,
            "technique": self.technique,
            "backend": self.backend,
            "engine": self.engine,
            "weights": _weights_to_json(self.weights),
            "perturbation": self.perturbation.to_json(),
            "orchestration": self.orchestration.to_json(),
            "solver_options": dict(self.solver_options),
        }
        if self.policy is not None:
            header["policy"] = self.policy.to_json()
        out: dict[str, Any] = {"scenario": header}
        out.update(system_to_json(self.system))
        out.update(workload_to_json(self.workload))
        # own top-level sections, present only when set — pre-constraint
        # scenario files (and their fingerprints) are byte-identical
        if self.constraints is not None and self.constraints:
            out["constraints"] = self.constraints.to_json()
        if self.cycling is not None:
            out["cycling"] = self.cycling.to_json()
        return out

    def expanded(self) -> tuple[Workload, Constraints | None]:
        """The workload/constraints a solver actually sees: cycling specs
        unroll into one DAG over the bounded cycle window, with per-cycle
        deadlines merged into the constraints."""
        if self.cycling is None:
            return self.workload, self.constraints
        from repro_torch.cycling import unroll_constraints, unroll_workload

        return (
            unroll_workload(self.workload, self.cycling),
            unroll_constraints(self.workload, self.cycling, base=self.constraints),
        )

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.to_json(), indent=2) + "\n")
        return path

    def replace(self, **changes: Any) -> "Scenario":
        return dataclasses.replace(self, **changes)

    def fingerprint(self) -> str:
        """Canonical content hash of the scenario (dict-order- and
        float-repr-invariant; see :func:`repro_torch.core.workload_model.canonical_hash`).
        Two scenario files that parse to the same spec share a fingerprint —
        the service's dedup/cache identity for submissions."""
        return canonical_hash(self.to_json())


_SCENARIO_HEADER_KEYS = (
    "name",
    "technique",
    "backend",
    "engine",
    "weights",
    "perturbation",
    "orchestration",
    "solver_options",
    "policy",
)


def scenario_from_json(obj: Mapping[str, Any] | str) -> Scenario:
    """Parse a scenario file/dict (the Fig. 7/8 config plus a ``scenario``
    header).  The system/workload sections go through the exact same
    :func:`snakemake_io.load_config` path as plain config files.

    Parsing is strict: an unknown ``scenario`` header key (or a top-level
    section that is neither a reserved section nor a workflow carrying a
    ``"tasks"`` mapping) raises with a did-you-mean hint instead of silently
    falling through to defaults."""
    if isinstance(obj, str):
        obj = json.loads(obj)
    for key, value in obj.items():
        if key in Scenario._RESERVED_SECTIONS:
            continue
        if isinstance(value, Mapping) and "tasks" in value:
            continue  # a workflow section (Fig. 8)
        raise ValueError(
            f"unknown scenario file section {key!r}"
            f"{did_you_mean(key, Scenario._RESERVED_SECTIONS)}; expected one "
            f"of {Scenario._RESERVED_SECTIONS} or a workflow section with a "
            f"'tasks' mapping"
        )
    system, workload = load_config(obj)
    if "topology" in obj:
        # inline generated continuum (repro_torch.topology): a seeded tiered
        # TopologySpec — or a preset name — in place of explicit "nodes"
        if system is not None:
            raise ValueError(
                "scenario file has both a 'nodes' section and a 'topology' "
                "spec; pick one system source"
            )
        from repro_torch.topology import cached_system, resolve_spec

        system = cached_system(resolve_spec(obj["topology"]))
    if system is None or workload is None:
        missing = "nodes" if system is None else "workflow"
        raise ValueError(f"scenario config is missing its {missing} section")
    header = obj.get("scenario", {})
    reject_unknown_keys(header, _SCENARIO_HEADER_KEYS, context="scenario")
    return Scenario(
        name=header.get("name", "scenario"),
        system=system,
        workload=workload,
        weights=_weights_from_json(header.get("weights", {})),
        technique=header.get("technique", "auto"),
        policy=Policy.from_json(header["policy"]) if "policy" in header else None,
        backend=header.get("backend", "simulate"),
        engine=header.get("engine", "auto"),
        perturbation=Perturbation.from_json(header.get("perturbation", {})),
        orchestration=OrchestrationConfig.from_json(header.get("orchestration", {})),
        solver_options=dict(header.get("solver_options", {})),
        constraints=constraints_from_json(obj.get("constraints")),
        cycling=cycle_spec_from_json(obj.get("cycling")),
    )


def load_scenario(path: str | Path) -> Scenario:
    return scenario_from_json(Path(path).read_text())


def route_problem(
    problem: ScheduleProblem,
    weights: ObjectiveWeights = ObjectiveWeights(),
    *,
    technique: str = "auto",
    policy: Policy | None = None,
    options: Mapping[str, Any] | None = None,
    registry: SolverRegistry | None = None,
    engine: str = "auto",
    device="cuda",
) -> SolveReport:
    """One solve with the full option semantics of a :class:`Scenario`:
    policy routing for ``"auto"``/``"policy"`` (or an explicit ``policy``),
    direct registry dispatch otherwise, with technique-scoped option dicts
    (``{"milp": {"time_limit": ...}}``) unpacked for the matching technique
    and dropped for the rest.

    ``engine`` names a schedule-evaluation backend from
    :data:`repro_torch.engine.ENGINES`; it becomes a scoped ``backend=`` option
    for every *engine-aware* technique (explicit user options win), so MILP
    or HEFT steps in a policy chain never see it; ``device`` travels the
    same way.

    This is the Fig. 4 step-2 kernel of :class:`Orchestrator`: "the
    scenario says technique X with options O"."""
    reg = registry if registry is not None else REGISTRY
    opts = fold_engine_options(reg, options, engine, device)
    with obs.TRACER.span(
        "solve.route", cat="solve",
        args={"technique": technique, "tasks": problem.num_tasks},
    ) as sp:
        if policy is not None or technique in ("auto", "policy"):
            pol = policy if policy is not None else Policy.paper_hybrid()
            rep = pol.route(problem, weights, registry=reg, **opts)
        else:
            rep = reg.solve(
                technique, problem, weights, **technique_kwargs(reg, technique, opts)
            )
        if rep.schedule is not None:
            sp.set(resolved=rep.schedule.technique)
        return rep


class FallbackExhausted(RuntimeError):
    """Every technique of a fallback chain raised; carries per-step errors."""

    def __init__(self, errors: Sequence[str]) -> None:
        super().__init__("; ".join(errors) or "empty fallback chain")
        self.errors = tuple(errors)


def solve_with_fallback(
    problem: ScheduleProblem,
    weights: ObjectiveWeights = ObjectiveWeights(),
    *,
    technique: str = "auto",
    chain: Sequence[str] = (),
    options: Mapping[str, Any] | None = None,
    registry: SolverRegistry | None = None,
    engine: str = "auto",
    policy: Policy | None = None,
    time_budget: float | None = None,
    device="cuda",
) -> SolveReport:
    """Graceful-degradation solve: the requested ``technique`` first, then
    each ``chain`` entry in order, accepting the first *valid* schedule.

    Unlike :meth:`Policy.route` (whose defensive net is deliberately narrow
    — approximate techniques' errors are bugs), this wrapper survives any
    solver-level step exception: a multi-tenant service must degrade one
    submission, not crash the run.  Every failed step is recorded in the
    returned report's ``fallbacks`` (``"tech:ErrorType: msg"``), so the
    caller can persist a per-submission error trail.  Faults of the device
    layer (:data:`DEVICE_ERRORS`) are not degraded past: they propagate.

    ``time_budget`` (wall seconds, optional) bounds the whole attempt: each
    time-limited technique (``needs_time_limit`` capability, e.g. MILP) has
    its ``time_limit`` option clamped to the remaining budget, and once the
    budget is spent every non-final step is skipped so the chain drops
    straight to its cheapest technique instead of hanging.  Budgeted routing
    trades replay determinism of the *technique choice* for bounded latency
    — leave it ``None`` (the default) when bit-identical replay matters.

    Raises :class:`FallbackExhausted` when every step raised; returns the
    last (invalid) report when steps completed but none produced a valid
    schedule, so infeasibility still surfaces as ``violations != 0``.
    """
    reg = registry if registry is not None else REGISTRY
    attempts = [technique] + [c for c in chain if c != technique]
    deadline = None if time_budget is None else time.monotonic() + float(time_budget)
    errors: list[str] = []
    invalid: SolveReport | None = None
    last = len(attempts) - 1
    with obs.TRACER.span(
        "solve.with_fallback", cat="solve", args={"technique": technique}
    ) as chain_sp:
        for i, tech in enumerate(attempts):
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0 and i < last:
                errors.append(f"{tech}:skipped(budget)")
                continue
            opts = dict(options or {})
            if (
                remaining is not None
                and tech in reg
                and reg.capabilities(tech).needs_time_limit
            ):
                scoped = opts.get(tech)
                scoped = dict(scoped) if isinstance(scoped, Mapping) else {}
                limit = scoped.get("time_limit", remaining)
                scoped["time_limit"] = min(float(limit), remaining)
                opts[tech] = scoped
            with obs.TRACER.span(
                "solve.attempt", cat="solve", args={"technique": tech, "step": i}
            ) as sp:
                try:
                    rep = route_problem(
                        problem,
                        weights,
                        technique=tech,
                        policy=policy if i == 0 else None,
                        options=opts,
                        registry=reg,
                        engine=engine,
                        device=device,
                    )
                except DEVICE_ERRORS:
                    raise
                except Exception as e:  # noqa: BLE001 — degradation is the contract
                    errors.append(f"{tech}:{type(e).__name__}: {e}")
                    sp.set(error=errors[-1])
                    _LOG.info("fallback: technique %s failed (%s: %s)",
                              tech, type(e).__name__, e)
                    continue
            if rep.schedule is not None and rep.schedule.violations == 0:
                rep.fallbacks = tuple(errors) + rep.fallbacks
                chain_sp.set(resolved=tech, steps=i + 1)
                if errors:
                    _LOG.info("fallback: degraded to %s after %d failed step(s)",
                              tech, len(errors))
                return rep
            errors.append(f"{tech}:violations={rep.schedule.violations}")
            sp.set(error=errors[-1])
            invalid = rep
        chain_sp.set(errors=tuple(errors))
    if invalid is not None:
        invalid.fallbacks = tuple(errors)
        _LOG.warning("fallback chain produced only invalid schedules: %s",
                     "; ".join(errors))
        return invalid
    raise FallbackExhausted(errors)


def fold_engine_options(
    registry: SolverRegistry,
    options: Mapping[str, Any] | None,
    engine: str,
    device=None,
) -> dict[str, Any]:
    """Fold an engine selection into ``solver_options`` as a scoped
    ``backend=`` for every *engine-aware* technique, and ``device`` as a
    scoped ``device=`` (explicit user options win; MILP/HEFT never see
    either).  The one translation shared by :func:`route_problem` and the
    legacy free functions."""
    opts = dict(options or {})
    fold = {}
    if engine and engine != "auto":
        fold["backend"] = engine
    if device is not None:
        fold["device"] = str(device)
    if fold:
        for entry in registry:
            if not entry.capabilities.engine_aware:
                continue
            scoped = opts.get(entry.name)
            scoped = dict(scoped) if isinstance(scoped, Mapping) else {}
            for k, v in fold.items():
                scoped.setdefault(k, v)
            opts[entry.name] = scoped
    return opts


def technique_kwargs(
    registry: SolverRegistry,
    technique: str,
    options: Mapping[str, Any] | None,
) -> dict[str, Any]:
    """Resolve scenario ``solver_options`` for a *direct* technique call:
    flat keys pass through, ``{"<technique>": {...}}`` dicts are unpacked for
    the matching technique and dropped for the rest (same contract as
    :meth:`Policy.route`)."""
    opts = dict(options or {})
    kw = {
        k: v for k, v in opts.items()
        if not (k in registry and isinstance(v, Mapping))
    }
    scoped = opts.get(technique)
    if isinstance(scoped, Mapping):
        kw.update(scoped)
    return kw


# -----------------------------------------------------------------------------
# Orchestrator — the Fig. 4 closed loop as a first-class object
# -----------------------------------------------------------------------------


@dataclasses.dataclass
class AdaptationEvent:
    """One solve→execute→monitor round of the loop."""

    round: int
    technique: str
    predicted_makespan: float
    observed_makespan: float
    slowdown: float
    drift: float
    resolved: bool  # did this round's drift trigger a re-solve?
    speed_estimates: dict[str, float]

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RunResult:
    """Structured outcome of an orchestrated run."""

    scenario: str
    backend: str
    schedules: list[Schedule] = dataclasses.field(default_factory=list)
    reports: list[ExecutionReport] = dataclasses.field(default_factory=list)
    adaptations: list[AdaptationEvent] = dataclasses.field(default_factory=list)
    artifacts: list[Path] = dataclasses.field(default_factory=list)
    speed_estimates: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def final_schedule(self) -> Schedule:
        return self.schedules[-1]

    @property
    def final_report(self) -> ExecutionReport | None:
        return self.reports[-1] if self.reports else None

    @property
    def adapted(self) -> bool:
        return any(a.resolved for a in self.adaptations)

    def summary(self) -> dict:
        out: dict[str, Any] = {
            "scenario": self.scenario,
            "backend": self.backend,
            "rounds": len(self.schedules),
            "adapted": self.adapted,
            "technique": self.final_schedule.technique if self.schedules else None,
            "predicted_makespan": float(self.final_schedule.makespan)
            if self.schedules
            else None,
            "adaptations": [a.to_json() for a in self.adaptations],
            "speed_estimates": dict(self.speed_estimates),
        }
        if self.reports:
            out["observed_makespan"] = float(self.reports[-1].makespan)
            out["initial_observed_makespan"] = float(self.reports[0].makespan)
            out["slowdown"] = float(self.reports[-1].slowdown)
        if self.artifacts:
            out["artifacts"] = [str(p) for p in self.artifacts]
        return out


class Orchestrator:
    """Owns the closed loop: solve via registry/policy, dispatch, fold
    monitor feedback into node properties ``P``, re-solve on drift.

    Render backends (``slurm`` / ``kubernetes``) produce artifacts and stop
    after one round — there is no feedback channel without a live cluster.
    Metaheuristics run on ``device``."""

    def __init__(
        self,
        scenario: Scenario,
        *,
        registry: SolverRegistry | None = None,
        out_dir: str | Path = DEFAULT_OUT_DIR,
        device="cuda",
    ) -> None:
        self.scenario = scenario
        self.registry = registry if registry is not None else REGISTRY
        self.out_dir = Path(out_dir)
        self.device = device
        self.monitor = MonitorState(smoothing=scenario.orchestration.smoothing)

    # ---- pieces -------------------------------------------------------------
    def solve(self, problem: ScheduleProblem) -> SolveReport:
        sc = self.scenario
        return route_problem(
            problem,
            sc.weights,
            technique=sc.technique,
            policy=sc.policy,
            options=sc.solver_options,
            registry=self.registry,
            engine=sc.engine,
            device=self.device,
        )

    def _effective_factors(self, system: System) -> np.ndarray:
        """Speed multipliers to replay the *current model* under ground truth.

        Ground-truth speed is ``base × perturbation``; the current model
        already bakes in the monitor's learned factor, so the residual the
        simulator must apply is ``perturbation / learned``.  Once the monitor
        has converged the residual is 1 — observed matches predicted."""
        truth = self.scenario.perturbation.speed_factors
        learned = self.monitor.factors
        return np.array(
            [
                truth.get(n.name, 1.0) / max(learned.get(n.name, 1.0), 1e-9)
                for n in system.nodes
            ]
        )

    # ---- the loop -----------------------------------------------------------
    def run(self) -> RunResult:
        sc = self.scenario
        from repro_torch.core.executor import dispatch  # local: executor → api users

        result = RunResult(scenario=sc.name, backend=sc.backend)
        system = sc.system
        workload, constraints = sc.expanded()
        rounds = max(1, int(sc.orchestration.max_rounds))
        for rnd in range(rounds):
            problem = build_problem(system, workload, constraints)
            rep = self.solve(problem)
            result.schedules.append(rep.schedule)

            if sc.backend != "simulate":
                artifacts = dispatch(
                    problem, rep.schedule, system,
                    backend=sc.backend, out_dir=self.out_dir,
                )
                result.artifacts = list(artifacts)
                break

            baked = dict(self.monitor.factors)
            xrep = execute(
                problem,
                rep.schedule,
                speed_factors=self._effective_factors(system),
                jitter=sc.perturbation.jitter,
                seed=sc.perturbation.seed,
            )
            result.reports.append(xrep)
            self.monitor.update(system, problem, xrep, baked=baked)

            drift = abs(xrep.slowdown - 1.0)
            resolve = (
                drift > sc.orchestration.drift_threshold and rnd + 1 < rounds
            )
            result.adaptations.append(
                AdaptationEvent(
                    round=rnd,
                    technique=rep.schedule.technique,
                    predicted_makespan=float(xrep.predicted_makespan),
                    observed_makespan=float(xrep.makespan),
                    slowdown=float(xrep.slowdown),
                    drift=float(drift),
                    resolved=resolve,
                    speed_estimates=dict(self.monitor.factors),
                )
            )
            if not resolve:
                break
            # refresh node properties P from the *base* model with the
            # absolute learned factors (Fig. 4 step 4 → step 1)
            system = self.monitor.refreshed_system(sc.system)
        result.speed_estimates = dict(self.monitor.factors)
        return result


def run_scenario(
    scenario: Scenario,
    *,
    registry: SolverRegistry | None = None,
    out_dir: str | Path = DEFAULT_OUT_DIR,
    device="cuda",
) -> RunResult:
    """One-call entry point: ``Scenario`` in, ``RunResult`` out."""
    return Orchestrator(scenario, registry=registry, out_dir=out_dir, device=device).run()


# -----------------------------------------------------------------------------
# Legacy free-function surface (re-exported by repro_torch.core.solver as shims)
# -----------------------------------------------------------------------------


def solve_problem(
    problem: ScheduleProblem,
    technique: str = "auto",
    weights: ObjectiveWeights = ObjectiveWeights(),
    *,
    milp_task_threshold: int = 25,
    mh_task_threshold: int = 600,
    milp_time_limit: float = 30.0,
    policy: Policy | None = None,
    registry: SolverRegistry | None = None,
    device="cuda",
    **kwargs: Any,
) -> SolveReport:
    reg = registry if registry is not None else REGISTRY
    if policy is not None or technique in ("auto", "policy"):
        pol = policy if policy is not None else Policy.paper_hybrid(
            milp_task_threshold, mh_task_threshold, milp_time_limit
        )
        kw = fold_engine_options(reg, kwargs, "auto", device)
        return pol.route(problem, weights, registry=reg, **kw)
    return reg.solve(technique, problem, weights, **_on_device(reg, technique, kwargs, device))


def _on_device(
    registry: SolverRegistry, technique: str, kwargs: Mapping[str, Any], device
) -> dict[str, Any]:
    """``kwargs`` plus ``device`` for an engine-aware technique."""
    kw = dict(kwargs)
    if technique in registry and registry.capabilities(technique).engine_aware:
        kw["device"] = device
    return kw


def solve(
    system: System,
    workload: Workload,
    technique: str = "auto",
    weights: ObjectiveWeights = ObjectiveWeights(),
    *,
    device="cuda",
    **kwargs: Any,
) -> SolveReport:
    problem = build_problem(system, workload)
    return solve_problem(problem, technique, weights, device=device, **kwargs)


def solve_problems(
    problems: Sequence[ScheduleProblem],
    technique: str = "ga",
    weights: ObjectiveWeights = ObjectiveWeights(),
    *,
    registry: SolverRegistry | None = None,
    device="cuda",
    **kwargs: Any,
) -> list[SolveReport]:
    """Solve a whole scenario family at once.

    Routed through the registry's batch capability: a technique advertising
    ``supports_batch`` (the GA and its ``ga_sweep`` fast path) runs the
    entire family at once, one batched makespan launch per generation on a
    CUDA device.  Others run per-instance."""
    reg = registry if registry is not None else REGISTRY
    if technique in reg and reg.capabilities(technique).supports_batch:
        return reg.solve_batch(
            technique, list(problems), weights, **_on_device(reg, technique, kwargs, device)
        )
    return [
        solve_problem(p, technique, weights, registry=reg, device=device, **kwargs)
        for p in problems
    ]


def compare_techniques(
    system: System,
    workload: Workload,
    techniques: tuple[str, ...] = ("milp", "heft", "olb", "ga", "pso", "sa", "aco"),
    weights: ObjectiveWeights = ObjectiveWeights(),
    *,
    registry: SolverRegistry | None = None,
    device="cuda",
    **kwargs: Any,
) -> dict[str, Schedule]:
    """Run several techniques on one problem — the engine behind the
    Fig. 11 / Table IX benchmarks."""
    reg = registry if registry is not None else REGISTRY
    problem = build_problem(system, workload)
    out: dict[str, Schedule] = {}
    for t in techniques:
        try:
            out[t] = solve_problem(
                problem, t, weights, registry=reg, device=device, **kwargs
            ).schedule
        except MilpSizeError:
            out[t] = Schedule(
                assignment=np.zeros(problem.num_tasks, dtype=np.int64),
                start=np.zeros(problem.num_tasks),
                finish=np.zeros(problem.num_tasks),
                makespan=float("nan"),
                usage=float("nan"),
                objective=float("nan"),
                violations=-1,
                technique=t,
                status="skipped(size)",
            )
    return out
