"""Seeded arrival traces — the workload stream the service consumes.

A trace is the service-level analogue of a :class:`~repro_torch.core.api.Scenario`:
one JSON file holding the shared continuum system (Fig. 7 ``nodes`` section,
unchanged format), a list of timestamped tenant submissions drawn from the
repo's workflow families, and optional node events (drift / failure /
recovery) to inject mid-run.

Arrival process: Poisson (exponential gaps at ``rate`` submissions per
virtual second) with optional bursts — with probability ``burst_prob`` a
gap's arrival becomes a burst of 2..``burst_size`` simultaneous submissions,
the pattern that makes the admission batcher earn its keep.

Families (mirroring the paper's test cases):

* ``mri``    — the Table V MRI workflows W1/W2, technique ``auto`` (§VII
  hybrid: MILP at this size).  Fixed DAGs → the service's cache hot path.
* ``stgs``   — the three STGS stand-ins (11–12 tasks), technique ``ga``;
  same-bucket GA submissions admit as one batched solve.
* ``random`` — random layered DAGs of varying size/seed (mostly cache
  misses), technique ``heft`` or ``ga``.
* ``tpu``    — accelerator jobs requiring feature ``F9`` so they only fit
  the continuum's accel nodes, technique ``heft``.

Everything is generated from one ``numpy`` Generator seeded by ``seed`` —
the same call is bit-identical run over run (asserted in tests).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core.evaluator import ObjectiveWeights
from repro_torch.core.system_model import Node, System, make_system, system_from_json, system_to_json
from repro_torch.core.workload_model import (
    Constraints,
    Workflow,
    Workload,
    constraints_from_json,
    mri_w1,
    mri_w2,
    random_layered_workflow,
    stgs_workflows,
    workload_from_json,
    workload_to_json,
)
from repro_torch.cycling import CycleSpec, cycle_spec_from_json

FAMILIES = ("mri", "stgs", "random", "tpu")

#: GA knobs shared by every generated ``ga`` submission — identical options
#: keep same-bucket submissions groupable by the admission batcher.
GA_OPTIONS: dict[str, Any] = {"generations": 6, "pop_size": 16, "seed": 0}


def continuum_system() -> System:
    """The default shared continuum: the paper's MRI edge/cloud/HPC triple
    plus two accelerator nodes (feature ``F9``) for the ``tpu`` family."""
    nodes = [
        Node("N1", {"cores": 8, "storage": 500}, frozenset({"F1"}),
             {"processing_speed": 1.0, "data_transfer_rate": 100.0}),
        Node("N2", {"cores": 48, "storage": 20000}, frozenset({"F1", "F2"}),
             {"processing_speed": 1.0, "data_transfer_rate": 100.0}),
        Node("N3", {"cores": 2572, "storage": 210000}, frozenset({"F1", "F2", "F3"}),
             {"processing_speed": 1.0, "data_transfer_rate": 100.0}),
        Node("A1", {"cores": 64, "storage": 1000}, frozenset({"F1", "F2", "F9", "F10"}),
             {"processing_speed": 4.0, "data_transfer_rate": 100.0}),
        Node("A2", {"cores": 64, "storage": 1000}, frozenset({"F1", "F2", "F9", "F10"}),
             {"processing_speed": 4.0, "data_transfer_rate": 100.0}),
    ]
    return make_system(nodes)


@dataclasses.dataclass(frozen=True)
class Submission:
    """One tenant request: a workflow plus how to solve it.

    ``after`` gates admission on the listed submission ids completing (a
    dep's rejection/failure cascade-rejects this one); ``deadline`` is an
    observed-makespan SLO checked at completion; ``constraints`` are hard
    scheduling constraints threaded into the solve
    (:class:`~repro_torch.core.workload_model.Constraints`); ``cycling`` makes the
    submission a recurring/converging stream — the service spawns cycle
    ``k+1`` (id ``{base}@c{k+1}``) when cycle ``k`` completes, until the
    fixed count or the seeded convergence predicate ends it."""

    id: str
    tenant: str
    time: float
    family: str
    workflow: Workflow
    technique: str = "auto"
    weights: ObjectiveWeights = dataclasses.field(default_factory=ObjectiveWeights)
    solver_options: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    after: tuple[str, ...] = ()
    deadline: float | None = None
    constraints: Constraints | None = None
    cycling: CycleSpec | None = None

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "id": self.id,
            "tenant": self.tenant,
            "time": float(self.time),
            "family": self.family,
            "technique": self.technique,
            "weights": {
                "alpha": float(self.weights.alpha),
                "beta": float(self.weights.beta),
                "usage_mode": self.weights.usage_mode,
            },
            "solver_options": dict(self.solver_options),
            "workflow": workload_to_json(Workload((self.workflow,))),
        }
        # optional sections are emitted only when set — pre-cycling trace
        # files serialize byte-identically
        if self.after:
            out["after"] = list(self.after)
        if self.deadline is not None:
            out["deadline"] = float(self.deadline)
        if self.constraints is not None and self.constraints:
            out["constraints"] = self.constraints.to_json()
        if self.cycling is not None:
            out["cycling"] = self.cycling.to_json()
        return out

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "Submission":
        w = obj.get("weights", {})
        workload = workload_from_json(obj["workflow"])
        if len(workload.workflows) != 1:
            raise ValueError(
                f"submission {obj.get('id')!r} must carry exactly one workflow"
            )
        deadline = obj.get("deadline")
        return cls(
            id=obj["id"],
            tenant=obj.get("tenant", "t0"),
            time=float(obj.get("time", 0.0)),
            family=obj.get("family", "custom"),
            workflow=workload.workflows[0],
            technique=obj.get("technique", "auto"),
            weights=ObjectiveWeights(
                alpha=float(w.get("alpha", 1.0)),
                beta=float(w.get("beta", 1.0)),
                usage_mode=w.get("usage_mode", "fixed"),
            ),
            solver_options=dict(obj.get("solver_options", {})),
            after=tuple(obj.get("after", ())),
            deadline=float(deadline) if deadline is not None else None,
            constraints=constraints_from_json(obj.get("constraints")),
            cycling=cycle_spec_from_json(obj.get("cycling")),
        )


@dataclasses.dataclass(frozen=True)
class NodeEvent:
    """A trace-injected continuum change."""

    time: float
    kind: str  # "node-drift" | "node-failure" | "node-recovery"
    node: str
    factor: float | None = None  # drift only: new true speed multiplier

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"time": float(self.time), "kind": self.kind,
                               "node": self.node}
        if self.factor is not None:
            out["factor"] = float(self.factor)
        return out

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "NodeEvent":
        return cls(
            time=float(obj["time"]),
            kind=obj["kind"],
            node=obj["node"],
            factor=float(obj["factor"]) if "factor" in obj else None,
        )


@dataclasses.dataclass(frozen=True)
class Trace:
    """A full service run input: system + submission stream + node events."""

    name: str
    system: System
    submissions: tuple[Submission, ...]
    events: tuple[NodeEvent, ...] = ()
    meta: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "trace": {"name": self.name, "meta": dict(self.meta)},
            "submissions": [s.to_json() for s in self.submissions],
            "node_events": [e.to_json() for e in self.events],
        }
        out.update(system_to_json(self.system))
        return out

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.to_json(), indent=2) + "\n")
        return path


def trace_from_json(obj: Mapping[str, Any] | str) -> Trace:
    if isinstance(obj, str):
        obj = json.loads(obj)
    if "nodes" not in obj:
        raise ValueError("trace is missing its 'nodes' (system) section")
    header = obj.get("trace", {})
    return Trace(
        name=header.get("name", "trace"),
        system=system_from_json(obj),
        submissions=tuple(Submission.from_json(s) for s in obj.get("submissions", ())),
        events=tuple(NodeEvent.from_json(e) for e in obj.get("node_events", ())),
        meta=dict(header.get("meta", {})),
    )


def load_trace(path: str | Path) -> Trace:
    return trace_from_json(Path(path).read_text())


# -----------------------------------------------------------------------------
# Generation
# -----------------------------------------------------------------------------


def chaos_events(
    system: System,
    horizon: float,
    *,
    seed: int = 0,
    failure_rate: float = 0.02,
    outage_mean: float = 40.0,
    drift_rate: float = 0.05,
    drift_range: tuple[float, float] = (0.4, 1.6),
    keep_one_up: bool = True,
) -> tuple[NodeEvent, ...]:
    """Seeded failure/recovery/drift *storms* over ``[0, horizon)`` — the
    distributional counterpart of ``generate_trace``'s three hand-placed
    node events, for chaos-style robustness campaigns.

    Two independent Poisson processes over the whole continuum:

    * **failures** at ``failure_rate`` events per virtual second; each picks
      a uniformly random currently-up node and takes it down for an
      exponential outage of mean ``outage_mean`` seconds (the paired
      ``node-recovery`` is emitted even when it lands past ``horizon``).
      With ``keep_one_up`` (default) a failure that would black out the
      last standing node is skipped — an empty continuum can only mass-fail
      every submission, which measures nothing;
    * **drifts** at ``drift_rate`` events per virtual second; each sets a
      uniformly random node's true speed to ``uniform(*drift_range)``
      (bounds must be positive — a zero speed is a failure, not a drift).

    A pure function of its arguments: one ``numpy`` Generator seeded by
    ``seed`` drives everything, so the same call is bit-identical run over
    run (hypothesis-guarded in the tests)."""
    if horizon <= 0:
        raise ValueError(f"horizon must be > 0, got {horizon}")
    if failure_rate < 0 or drift_rate < 0:
        raise ValueError("failure_rate and drift_rate must be >= 0")
    if outage_mean <= 0:
        raise ValueError(f"outage_mean must be > 0, got {outage_mean}")
    lo, hi = float(drift_range[0]), float(drift_range[1])
    if not 0 < lo <= hi:
        raise ValueError(
            f"drift_range must satisfy 0 < lo <= hi, got {drift_range!r}"
        )
    rng = np.random.default_rng(seed)
    names = [n.name for n in system.nodes]
    events: list[NodeEvent] = []

    down_until: dict[str, float] = {}
    t = 0.0
    while failure_rate > 0:
        t += float(rng.exponential(1.0 / failure_rate))
        if t >= horizon:
            break
        for node in [n for n, until in down_until.items() if until <= t]:
            del down_until[node]
        up = [n for n in names if n not in down_until]
        if keep_one_up and len(up) <= 1:
            continue  # never black out the whole continuum
        if not up:
            continue
        node = up[int(rng.integers(0, len(up)))]
        outage = float(rng.exponential(outage_mean))
        events.append(NodeEvent(time=t, kind="node-failure", node=node))
        events.append(
            NodeEvent(time=t + outage, kind="node-recovery", node=node)
        )
        down_until[node] = t + outage

    t = 0.0
    while drift_rate > 0:
        t += float(rng.exponential(1.0 / drift_rate))
        if t >= horizon:
            break
        node = names[int(rng.integers(0, len(names)))]
        factor = float(rng.uniform(lo, hi))
        events.append(
            NodeEvent(time=t, kind="node-drift", node=node, factor=factor)
        )

    return tuple(sorted(events, key=lambda e: (e.time, e.kind, e.node)))


def arrival_times(
    n: int,
    *,
    rate: float = 2.0,
    seed: int = 0,
    burst_prob: float = 0.1,
    burst_size: int = 8,
) -> list[float]:
    """Poisson arrivals with bursts: ``n`` timestamps, non-decreasing."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    rng = np.random.default_rng(seed)
    times: list[float] = []
    t = 0.0
    while len(times) < n:
        t += float(rng.exponential(1.0 / rate))
        k = 1
        if burst_size > 1 and rng.random() < burst_prob:
            k = int(rng.integers(2, burst_size + 1))
        for _ in range(min(k, n - len(times))):
            times.append(t)
    return times


def _pick_workflow(
    family: str, rng: np.random.Generator
) -> tuple[Workflow, str, dict[str, Any]]:
    """(workflow, technique, solver_options) for one submission.

    Workflow *names* are deterministic per family/shape (never per
    submission), so identical content re-submitted later fingerprints — and
    therefore caches — identically."""
    if family == "mri":
        wf = mri_w1() if rng.random() < 0.5 else mri_w2()
        return wf, "auto", {"milp": {"time_limit": 5.0}}
    if family == "stgs":
        wf = stgs_workflows()[
            ("W5_STGS1", "W6_STGS2", "W7_STGS3")[int(rng.integers(0, 3))]
        ]
        # tenants tune their own GA seed: identical *content* under varying
        # options misses the solve cache but reuses the engine's
        # fingerprint-keyed pack (the admission batcher's warming path) —
        # without this, every content-identical resubmission is absorbed by
        # the solve cache and the pack LRU never sees a repeat
        return wf, "ga", dict(GA_OPTIONS, seed=int(rng.integers(0, 4)))
    if family == "random":
        size = int(rng.choice([6, 8, 10, 12]))
        wf = random_layered_workflow(
            size, name=f"Wr{size}", seed=int(rng.integers(0, 2**31)),
            feature_pool=("F1", "F2"),
        )
        technique = "heft" if rng.random() < 0.5 else "ga"
        return wf, technique, dict(GA_OPTIONS) if technique == "ga" else {}
    if family == "tpu":
        size = int(rng.choice([8, 12, 16]))
        wf = random_layered_workflow(
            size, name=f"Wt{size}", seed=int(rng.integers(0, 2**31)),
            feature_pool=("F9",), max_cores=32,
        )
        return wf, "heft", {}
    raise ValueError(f"unknown workflow family {family!r}; options {FAMILIES}")


def generate_trace(
    num_submissions: int = 200,
    *,
    seed: int = 0,
    rate: float = 2.0,
    burst_prob: float = 0.1,
    burst_size: int = 8,
    families: Sequence[str] = FAMILIES,
    tenants: int = 8,
    node_events: bool = False,
    chaos: Mapping[str, Any] | None = None,
    cycling: Mapping[str, Any] | None = None,
    system: System | None = None,
    topology: Any = None,
    name: str = "trace",
) -> Trace:
    """Generate a seeded mixed-family arrival trace.

    ``node_events=True`` injects a mid-trace drift (the second node at half
    speed), a failure of the last node at 60% of the span and its recovery
    at 80% — the service must keep admitting around them.  Targets are drawn
    from the *embedded* system (N2 / A2 on the default continuum), so the
    generated trace is always consumable by ``serve_trace``.

    ``chaos`` (kwargs for :func:`chaos_events`, e.g. ``{"failure_rate":
    0.02, "drift_rate": 0.05}``) replaces the hand-placed events with seeded
    failure/recovery/drift storms — the robustness campaign axis.  It takes
    precedence over ``node_events``.  Storms default to the arrival span;
    pass ``"horizon"`` to stretch them over the (much longer) execution
    backlog so failures land on *running* work, not just queued work.

    ``topology`` draws the tenants' continuum from a generated tiered
    topology (:mod:`repro_torch.topology`): a preset name, spec dict, or
    :class:`~repro_torch.topology.TopologySpec`.  Note the ``"tpu"`` family
    requires F9 nodes, which tiered topologies do not provide — pick
    ``families`` accordingly.

    ``cycling`` turns a seeded fraction of submissions into recurring /
    converging streams: ``{"fraction": 0.25, **cycle_spec_json}`` — the
    non-``fraction`` keys are a :class:`~repro_torch.cycling.CycleSpec` JSON
    object (e.g. ``{"cycles": 3, "period": 5.0}`` or ``{"converge":
    {"prob": 0.5}, "period": 5.0}``).  Selection draws from its own
    derived Generator (``seed + 3``), so traces without ``cycling`` are
    byte-identical to pre-cycling output."""
    rng = np.random.default_rng(seed)
    topology_spec = None
    if topology is not None:
        if system is not None:
            raise ValueError("pass either system= or topology=, not both")
        from repro_torch.topology import cached_system, resolve_spec

        topology_spec = resolve_spec(topology)
        system = cached_system(topology_spec)
    system = system if system is not None else continuum_system()
    times = arrival_times(
        num_submissions, rate=rate, seed=seed + 1,
        burst_prob=burst_prob, burst_size=burst_size,
    )
    subs: list[Submission] = []
    for i, t in enumerate(times):
        family = str(families[int(rng.integers(0, len(families)))])
        wf, technique, options = _pick_workflow(family, rng)
        subs.append(
            Submission(
                id=f"s{i:05d}",
                tenant=f"t{int(rng.integers(0, tenants))}",
                time=t,
                family=family,
                workflow=wf,
                technique=technique,
                solver_options=options,
            )
        )
    if cycling is not None:
        ckw = dict(cycling)
        fraction = float(ckw.pop("fraction", 0.25))
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"cycling.fraction must be in [0, 1], got {fraction}")
        spec = cycle_spec_from_json(ckw)
        crng = np.random.default_rng(seed + 3)
        subs = [
            dataclasses.replace(s, cycling=spec)
            if float(crng.random()) < fraction
            else s
            for s in subs
        ]
    events: tuple[NodeEvent, ...] = ()
    span = times[-1] if times else 1.0
    if chaos is not None:
        ckw = dict(chaos)
        horizon = float(ckw.pop("horizon", span))
        events = chaos_events(system, horizon, seed=seed + 2, **ckw)
    elif node_events:
        names = [n.name for n in system.nodes]
        drift_node = names[min(1, len(names) - 1)]
        fail_node = names[-1]
        events = (
            NodeEvent(time=0.3 * span, kind="node-drift", node=drift_node,
                      factor=0.5),
            NodeEvent(time=0.6 * span, kind="node-failure", node=fail_node),
            NodeEvent(time=0.8 * span, kind="node-recovery", node=fail_node),
        )
    meta: dict[str, Any] = {
        "seed": seed,
        "rate": rate,
        "burst_prob": burst_prob,
        "burst_size": burst_size,
        "families": list(families),
        "tenants": tenants,
        "node_events": bool(node_events),
    }
    if chaos is not None:
        meta["chaos"] = {
            k: list(v) if isinstance(v, tuple) else v
            for k, v in dict(chaos).items()
        }
    if cycling is not None:
        meta["cycling"] = {
            k: list(v) if isinstance(v, tuple) else v
            for k, v in dict(cycling).items()
        }
    if topology_spec is not None:
        meta["topology"] = {
            "name": topology_spec.name,
            "fingerprint": topology_spec.fingerprint(),
        }
    return Trace(
        name=name,
        system=system,
        submissions=tuple(subs),
        events=events,
        meta=meta,
    )
