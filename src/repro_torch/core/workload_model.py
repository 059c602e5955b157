"""Workload model (paper §IV-B2) and the dense solver-facing problem.

Workloads ``L = {W_1..W_w}``; a workflow ``W = ({T_1..T_|T|}, s)`` is a DAG of
tasks; a task ``T = {R, F, U, δ}`` carries requested resources, required
features, resource usage and dependencies (Table II).

:func:`build_problem` turns a (System, Workload) pair into a
:class:`ScheduleProblem`, a dense numpy bundle (durations ``d_ij`` per Eq. 4,
transfer sizes for Eq. 5, feasibility per Eq. 1/2).  Every array, every
generator draw and :func:`problem_fingerprint` match the reference package
byte for byte, so a problem built on either side hashes and packs alike.

JSON I/O follows the paper's Fig. 8 workflow format and reads the reference
package's ``workload_to_json`` output unchanged.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import heapq
import json
import math
import struct
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core.system_model import System

BIG_PENALTY = 1e9  # fitness penalty per constraint violation (metaheuristics)


@dataclasses.dataclass(frozen=True)
class Task:
    """``T = {R, F, U, δ}`` (Table II row 3).

    ``work`` is the requested compute ``R_j`` of Eq. (4): the duration on
    node i is ``work / P_i^2`` unless ``durations`` pins explicit per-node
    values (measured at speed 1.0).  ``data`` is the output size ``R^3_j``
    that drives Eq. (5) transfers."""

    name: str
    cores: float = 1.0  # R1
    memory: float = 0.0  # R2
    data: float = 0.0  # R3
    features: frozenset[str] = frozenset()
    work: float = 1.0
    durations: Mapping[str, float] | None = None  # node-name -> duration override
    deps: tuple[str, ...] = ()  # predecessor task names (δ)


@dataclasses.dataclass(frozen=True)
class Workflow:
    """``W = ({T}, s)`` (Table II row 2)."""

    name: str
    tasks: tuple[Task, ...]
    submission: float = 0.0  # s

    def __post_init__(self) -> None:
        names = [t.name for t in self.tasks]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate task names in workflow {self.name}")
        known = set(names)
        for t in self.tasks:
            missing = set(t.deps) - known
            if missing:
                raise ValueError(f"{self.name}/{t.name}: unknown deps {missing}")
        if topological_order(self.tasks) is None:
            raise ValueError(f"workflow {self.name} is not a DAG")

    @property
    def num_tasks(self) -> int:
        return len(self.tasks)


@dataclasses.dataclass(frozen=True)
class Workload:
    """``L`` — a set of workflows (Table II row 1)."""

    workflows: tuple[Workflow, ...]

    @property
    def num_tasks(self) -> int:
        return sum(w.num_tasks for w in self.workflows)


@dataclasses.dataclass(frozen=True)
class Constraints:
    """Hard constraints layered onto a (System, Workload) pair.

    * ``deadline`` — workflow name (all its tasks) or ``"Wf/Task"`` → latest
      allowed finish time;
    * ``budget`` — workflow name → maximum total cost, where a task's cost on
      node i is ``duration * cores * cost_rate[i]``;
    * ``cost_rate`` — node name → cost per core-second (default 1.0);
    * ``placement`` — workflow name → extra node features every task of that
      workflow requires.

    A schedule that breaks one counts it into ``Schedule.violations``; the
    metaheuristics see it as a ``BIG_PENALTY`` fitness term."""

    deadline: Mapping[str, float] = dataclasses.field(default_factory=dict)
    budget: Mapping[str, float] = dataclasses.field(default_factory=dict)
    cost_rate: Mapping[str, float] = dataclasses.field(default_factory=dict)
    placement: Mapping[str, tuple[str, ...]] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "placement", {k: tuple(v) for k, v in self.placement.items()}
        )

    def __bool__(self) -> bool:
        return bool(self.deadline or self.budget or self.cost_rate or self.placement)


def topological_order(tasks: Sequence[Task]) -> list[int] | None:
    """Kahn's algorithm over intra-workflow dependency names; ties broken by
    original index.  Returns None on a cycle."""
    index = {t.name: i for i, t in enumerate(tasks)}
    indeg = [0] * len(tasks)
    succs: list[list[int]] = [[] for _ in tasks]
    for i, t in enumerate(tasks):
        for d in t.deps:
            succs[index[d]].append(i)
            indeg[i] += 1
    heap = [i for i, d in enumerate(indeg) if d == 0]
    heapq.heapify(heap)
    order: list[int] = []
    while heap:
        i = heapq.heappop(heap)
        order.append(i)
        for s in succs[i]:
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(heap, s)
    return order if len(order) == len(tasks) else None


@dataclasses.dataclass
class ScheduleProblem:
    """Dense array view over (System, Workload) for all solver techniques.

    Tasks from all workflows are concatenated in a global topological order
    (workflow submission times become per-task release times)."""

    node_cores: np.ndarray  # [N]
    dtr: np.ndarray  # [N, N], +inf diagonal
    durations: np.ndarray  # [T, N] — d_ij (Eq. 4 / Table V)
    cores: np.ndarray  # [T]
    data: np.ndarray  # [T] — output size (Eq. 5 numerator)
    feasible: np.ndarray  # [T, N] bool — Eq. (1) features ∧ Eq. (2) capacity
    release: np.ndarray  # [T] — workflow submission times
    pred_matrix: np.ndarray  # [T, maxP] int32, -1 padded, indices into topo order
    edges: np.ndarray  # [E, 2] (src, dst) in topo indices
    task_names: list[str]
    workflow_of: np.ndarray  # [T] int
    workflow_names: list[str]
    # hard constraints (None when unconstrained, which keeps fingerprints of
    # unconstrained problems byte-stable)
    deadline: np.ndarray | None = None  # [T] f64, +inf where unconstrained
    cost_rate: np.ndarray | None = None  # [N] f64 cost per core-second
    budget: np.ndarray | None = None  # [W] f64 per-workflow budget, +inf default

    @property
    def num_tasks(self) -> int:
        return int(self.durations.shape[0])

    @property
    def num_nodes(self) -> int:
        return int(self.durations.shape[1])

    @property
    def has_constraints(self) -> bool:
        return self.deadline is not None or self.budget is not None

    def cost_matrix(self) -> np.ndarray:
        """[T, N] cost of running task j on node i: ``d_ij * cores_j * rate_i``."""
        rate = (
            self.cost_rate
            if self.cost_rate is not None
            else np.ones(self.num_nodes, dtype=np.float64)
        )
        return self.durations * self.cores[:, None] * rate[None, :]

    @functools.cached_property
    def pred_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """CSR view of the dependency DAG: ``(indptr [T+1], indices [E])``,
        each row in the order of the padded ``pred_matrix`` row."""
        valid = self.pred_matrix >= 0
        indptr = np.zeros(self.num_tasks + 1, dtype=np.int64)
        np.cumsum(valid.sum(axis=1), out=indptr[1:])
        return indptr, self.pred_matrix[valid].astype(np.int64)

    @functools.cached_property
    def transfer_factor(self) -> np.ndarray:
        """[N, N] f32 reciprocal rates for Eq. (5): ``transfer_time(p, i→i')
        = data[p] * transfer_factor[i, i']`` (+ ``transfer_penalty`` on dead
        links).  The diagonal is 0: intra-node migration is free."""
        ok = np.isfinite(self.dtr) & (self.dtr > 0)
        fac = np.where(ok, 1.0 / np.maximum(self.dtr, 1e-30), 0.0).astype(np.float32)
        np.fill_diagonal(fac, 0.0)
        return fac

    @functools.cached_property
    def transfer_penalty(self) -> np.ndarray | None:
        """[N, N] f32 additive blocker (1e30) on off-diagonal dead links, or
        None when every off-diagonal rate is usable."""
        ok = np.isfinite(self.dtr) & (self.dtr > 0)
        np.fill_diagonal(ok, True)
        if ok.all():
            return None
        return np.where(ok, 0.0, 1e30).astype(np.float32)

    @property
    def usage(self) -> np.ndarray:
        """U_j in the fixed-resource case (paper §IV-C3: U_j = R_j)."""
        return self.cores

    def weighted_usage(self) -> np.ndarray:
        """U_ij per Eq. (3): ``R_j * (R_i / Σ_i' R_i')``, shape [T, N]."""
        share = self.node_cores / float(self.node_cores.sum())
        return np.outer(self.cores, share)


def build_problem(
    system: System,
    workload: Workload,
    constraints: Constraints | None = None,
) -> ScheduleProblem:
    speeds = system.speed()
    node_names = [n.name for n in system.nodes]
    node_cores = system.cores()
    n = system.num_nodes

    tasks: list[Task] = []
    wf_of: list[int] = []
    release: list[float] = []
    name_of: list[str] = []
    # global topo order = per-workflow topo orders, workflows kept contiguous
    global_index: dict[tuple[int, str], int] = {}
    for w_idx, wf in enumerate(workload.workflows):
        order = topological_order(wf.tasks)
        if order is None:
            raise ValueError(f"workflow {wf.name} is not a DAG")
        for local in order:
            t = wf.tasks[local]
            global_index[(w_idx, t.name)] = len(tasks)
            tasks.append(t)
            wf_of.append(w_idx)
            release.append(wf.submission)
            name_of.append(f"{wf.name}/{t.name}")

    t_count = len(tasks)
    durations = np.zeros((t_count, n), dtype=np.float64)
    cores = np.zeros(t_count, dtype=np.float64)
    data = np.zeros(t_count, dtype=np.float64)
    feasible = np.zeros((t_count, n), dtype=bool)
    preds: list[list[int]] = [[] for _ in range(t_count)]
    edges: list[tuple[int, int]] = []

    wf_names = [w.name for w in workload.workflows]
    placement: dict[int, frozenset[str]] = {}
    if constraints is not None and constraints.placement:
        unknown = set(constraints.placement) - set(wf_names)
        if unknown:
            raise ValueError(f"constraints.placement: unknown workflows {sorted(unknown)}")
        for w_idx, wname in enumerate(wf_names):
            extra = constraints.placement.get(wname)
            if extra:
                placement[w_idx] = frozenset(extra)

    for gi, (t, w_idx) in enumerate(zip(tasks, wf_of)):
        cores[gi] = t.cores
        data[gi] = t.data
        required = t.features | placement.get(w_idx, frozenset())
        for i in range(n):
            if t.durations is not None:
                # explicit durations are work at speed 1.0 (Eq. 4: d_ij = R_j / P_i)
                durations[gi, i] = float(
                    t.durations.get(node_names[i], math.inf)
                ) / max(speeds[i], 1e-30)
            else:
                durations[gi, i] = t.work / max(speeds[i], 1e-30)
            ok_feat = system.nodes[i].provides(required)
            ok_cap = t.cores <= node_cores[i]
            ok_dur = math.isfinite(durations[gi, i])
            feasible[gi, i] = ok_feat and ok_cap and ok_dur
        for d in t.deps:
            p = global_index[(w_idx, d)]
            preds[gi].append(p)
            edges.append((p, gi))

    maxp = max((len(p) for p in preds), default=1) or 1
    pred_matrix = -np.ones((t_count, maxp), dtype=np.int32)
    for gi, ps in enumerate(preds):
        pred_matrix[gi, : len(ps)] = ps

    deadline = cost_rate = budget = None
    if constraints is not None and (
        constraints.deadline or constraints.budget or constraints.cost_rate
    ):
        if constraints.deadline:
            deadline = np.full(t_count, np.inf, dtype=np.float64)
            name_to_gi = {nm: gi for gi, nm in enumerate(name_of)}
            wf_index = {nm: i for i, nm in enumerate(wf_names)}
            for key, value in constraints.deadline.items():
                if key in wf_index:
                    deadline[np.asarray(wf_of) == wf_index[key]] = float(value)
                elif key in name_to_gi:
                    deadline[name_to_gi[key]] = float(value)
                else:
                    raise ValueError(
                        f"constraints.deadline: unknown workflow/task {key!r}"
                    )
        if constraints.budget or constraints.cost_rate:
            cost_rate = np.ones(n, dtype=np.float64)
            unknown = set(constraints.cost_rate) - set(node_names)
            if unknown:
                raise ValueError(f"constraints.cost_rate: unknown nodes {sorted(unknown)}")
            for nm, rate in constraints.cost_rate.items():
                cost_rate[node_names.index(nm)] = float(rate)
        if constraints.budget:
            unknown = set(constraints.budget) - set(wf_names)
            if unknown:
                raise ValueError(f"constraints.budget: unknown workflows {sorted(unknown)}")
            budget = np.full(len(wf_names), np.inf, dtype=np.float64)
            for nm, value in constraints.budget.items():
                budget[wf_names.index(nm)] = float(value)

    return ScheduleProblem(
        node_cores=node_cores,
        dtr=system.dtr,
        durations=durations,
        cores=cores,
        data=data,
        feasible=feasible,
        release=np.asarray(release, dtype=np.float64),
        pred_matrix=pred_matrix,
        edges=np.asarray(edges, dtype=np.int32).reshape(-1, 2),
        task_names=name_of,
        workflow_of=np.asarray(wf_of, dtype=np.int32),
        workflow_names=wf_names,
        deadline=deadline,
        cost_rate=cost_rate,
        budget=budget,
    )


# -----------------------------------------------------------------------------
# Canonical content hashing: mappings by sorted key, every number through one
# float64 encoding, arrays by normalized dtype + shape + bytes.  Two problems
# that are semantically identical get one key, whatever JSON spelled them.
# -----------------------------------------------------------------------------


def _float64_exact(i: int) -> bool:
    """Does ``i`` survive an int → float64 → int round trip?"""
    try:
        return int(float(i)) == i
    except OverflowError:
        return False


def _hash_into(h: "hashlib._Hash", obj: Any) -> None:
    if obj is None:
        h.update(b"z")
    elif isinstance(obj, (bool, np.bool_)):
        h.update(b"b1" if obj else b"b0")
    elif isinstance(obj, (int, np.integer)) and not _float64_exact(int(obj)):
        data = str(int(obj)).encode()
        h.update(b"I" + len(data).to_bytes(8, "big") + data)
    elif isinstance(obj, (int, float, np.integer, np.floating)):
        v = float(obj)
        if v != v:
            h.update(b"n#nan")  # one canonical NaN
        else:
            if v == 0.0:
                v = 0.0  # fold -0.0 into +0.0
            h.update(b"n" + struct.pack(">d", v))
    elif isinstance(obj, str):
        data = obj.encode()
        h.update(b"s" + len(data).to_bytes(8, "big") + data)
    elif isinstance(obj, bytes):
        h.update(b"y" + len(obj).to_bytes(8, "big") + obj)
    elif isinstance(obj, np.ndarray):
        if obj.dtype == bool:
            tag, arr = b"aB", np.ascontiguousarray(obj, dtype=np.uint8)
        elif np.issubdtype(obj.dtype, np.integer):
            tag, arr = b"aI", np.ascontiguousarray(obj, dtype=np.int64)
        else:
            tag, arr = b"aF", np.ascontiguousarray(obj, dtype=np.float64)
        h.update(tag + str(obj.shape).encode() + arr.tobytes())
    elif isinstance(obj, Mapping):
        h.update(b"{")
        for k in sorted(obj, key=str):
            _hash_into(h, str(k))
            _hash_into(h, obj[k])
        h.update(b"}")
    elif isinstance(obj, (set, frozenset)):
        h.update(b"<")
        for k in sorted(obj, key=str):
            _hash_into(h, k)
        h.update(b">")
    elif isinstance(obj, Sequence):
        h.update(b"[")
        for v in obj:
            _hash_into(h, v)
        h.update(b"]")
    else:
        raise TypeError(f"canonical_hash: unhashable type {type(obj).__name__}")


def canonical_hash(obj: Any) -> str:
    """Stable content hash of a JSON-like structure, invariant under dict key
    order, int/float spelling, tuple vs. list and a JSON round trip."""
    h = hashlib.sha256()
    _hash_into(h, obj)
    return h.hexdigest()


def problem_fingerprint(problem: ScheduleProblem) -> str:
    """Canonical content hash of everything a technique can observe in the
    dense problem; constraint arrays enter only when present."""
    payload: dict[str, Any] = {
        "node_cores": problem.node_cores,
        "dtr": problem.dtr,
        "durations": problem.durations,
        "cores": problem.cores,
        "data": problem.data,
        "feasible": problem.feasible,
        "release": problem.release,
        "pred_matrix": problem.pred_matrix,
        "edges": problem.edges,
        "task_names": problem.task_names,
        "workflow_of": problem.workflow_of,
        "workflow_names": problem.workflow_names,
    }
    if problem.deadline is not None:
        payload["deadline"] = problem.deadline
    if problem.cost_rate is not None:
        payload["cost_rate"] = problem.cost_rate
    if problem.budget is not None:
        payload["budget"] = problem.budget
    return canonical_hash(payload)


# -----------------------------------------------------------------------------
# JSON I/O — paper Fig. 8 format
# -----------------------------------------------------------------------------


def _unwrap(v: Any) -> Any:
    if isinstance(v, list) and len(v) == 1:
        return v[0]
    return v


def workflow_from_json(name: str, spec: Mapping[str, Any], submission: float = 0.0) -> Workflow:
    tasks = []
    for tname, tspec in spec["tasks"].items():
        durations = None
        dur = tspec.get("duration")
        work = 1.0
        if isinstance(dur, Mapping):
            durations = {k: float(v) for k, v in dur.items()}
        elif dur is not None:
            work = float(_unwrap(dur))
        tasks.append(
            Task(
                name=tname,
                cores=float(_unwrap(tspec.get("cores", 1))),
                memory=float(_unwrap(tspec.get("memory_required", 0))),
                data=float(_unwrap(tspec.get("data", 0))),
                features=frozenset(tspec.get("features", [])),
                work=work,
                durations=durations,
                deps=tuple(tspec.get("dependencies", [])),
            )
        )
    return Workflow(name=name, tasks=tuple(tasks), submission=submission)


def workload_from_json(obj: Mapping[str, Any] | str) -> Workload:
    if isinstance(obj, str):
        obj = json.loads(obj)
    return Workload(tuple(
        workflow_from_json(name, spec, float(_unwrap(spec.get("submission", 0.0))))
        for name, spec in obj.items()
    ))


def workload_to_json(workload: Workload) -> dict:
    out: dict[str, Any] = {}
    for wf in workload.workflows:
        tasks: dict[str, Any] = {}
        for t in wf.tasks:
            tasks[t.name] = {
                "cores": [t.cores],
                "memory_required": [t.memory],
                "features": sorted(t.features),
                "data": t.data,
                "duration": dict(t.durations) if t.durations is not None else [t.work],
                "dependencies": list(t.deps),
            }
        out[wf.name] = {"submission": wf.submission, "tasks": tasks}
    return out


# -----------------------------------------------------------------------------
# Reference workloads — Table V (MRI), STGS-style and random generators.  Each
# generator makes its numpy draws in the reference's order, so one seed gives
# one workflow in both packages.
# -----------------------------------------------------------------------------


def _same_on_mri_nodes(v: float) -> dict[str, float]:
    return {"N1": v, "N2": v, "N3": v}


def mri_w1() -> Workflow:
    """W1 — MRI serial workflow (Table V / Fig. 2b): T1 -> T2 -> T3."""
    d3 = _same_on_mri_nodes
    return Workflow(
        "W1",
        (
            Task("T1", cores=8, data=2, features=frozenset({"F1"}), durations=d3(3.0)),
            Task("T2", cores=12, data=5, features=frozenset({"F1", "F2"}), durations=d3(5.0), deps=("T1",)),
            Task("T3", cores=12, data=8, features=frozenset({"F1", "F2"}), durations=d3(2.0), deps=("T2",)),
        ),
    )


def mri_w2() -> Workflow:
    """W2 — MRI parallel workflow (Table V): diamond T1 -> {T2, T3} -> T4."""
    d3 = _same_on_mri_nodes
    return Workflow(
        "W2",
        (
            Task("T1", cores=8, data=2, features=frozenset({"F1"}), durations=d3(3.0)),
            Task("T2", cores=12, data=5, features=frozenset({"F1", "F2"}), durations=d3(5.0), deps=("T1",)),
            Task("T3", cores=32, data=5, features=frozenset({"F1", "F2"}), durations=d3(2.0), deps=("T1",)),
            Task("T4", cores=12, data=10, features=frozenset({"F1", "F2"}), durations=d3(2.0), deps=("T2", "T3")),
        ),
    )


def mri_workload() -> Workload:
    return Workload((mri_w1(), mri_w2()))


def random_layered_workflow(
    num_tasks: int,
    *,
    name: str = "Wr",
    seed: int = 0,
    max_width: int = 4,
    density: float = 0.35,
    comm: bool = True,
    feature_pool: Sequence[str] = ("F1", "F2"),
    max_cores: int = 16,
) -> Workflow:
    """Layered random DAG à la the paper's random workflows W3/W4: each task
    depends on tasks of the previous 1–2 layers with probability
    ``density``, and on at least one task of the previous layer."""
    rng = np.random.default_rng(seed)
    layers: list[list[int]] = []
    remaining = num_tasks
    idx = 0
    while remaining > 0:
        width = int(min(remaining, rng.integers(1, max_width + 1)))
        layers.append(list(range(idx, idx + width)))
        idx += width
        remaining -= width
    tasks: list[Task] = []
    for li, layer in enumerate(layers):
        for t in layer:
            deps: list[str] = []
            if li > 0:
                cands = layers[li - 1] + (layers[li - 2] if li > 1 else [])
                for c in cands:
                    if rng.random() < density:
                        deps.append(f"T{c}")
                if not deps:
                    deps.append(f"T{rng.choice(layers[li - 1])}")
            tasks.append(
                Task(
                    name=f"T{t}",
                    cores=float(rng.integers(1, max_cores + 1)),
                    data=float(rng.integers(1, 9)) if comm else 0.0,
                    features=frozenset(
                        rng.choice(list(feature_pool), size=rng.integers(1, len(feature_pool) + 1), replace=False)
                    ) if feature_pool else frozenset(),
                    work=float(rng.integers(1, 9)),
                    deps=tuple(deps),
                )
            )
    return Workflow(name=name, tasks=tuple(tasks))


def stgs_workflows() -> dict[str, Workflow]:
    """Stand-ins for the paper's Standard Task Graph Set workflows (Fig. 10),
    with the paper's sizes: W5 (11 tasks, no transfers), W6 (12 tasks, with
    transfers), W7 (11 tasks, dense)."""
    return {
        "W5_STGS1": random_layered_workflow(11, name="W5_STGS1", seed=5, comm=False, density=0.3),
        "W6_STGS2": random_layered_workflow(12, name="W6_STGS2", seed=6, comm=True, density=0.3),
        "W7_STGS3": random_layered_workflow(11, name="W7_STGS3", seed=7, comm=True, density=0.9),
    }


def synthetic_workload(
    num_tasks: int,
    *,
    seed: int = 0,
    num_workflows: int = 1,
    comm: bool = True,
    max_cores: int = 16,
) -> Workload:
    """Synthetic workload for the Table IX scale tests."""
    rng = np.random.default_rng(seed)
    per = [num_tasks // num_workflows] * num_workflows
    per[-1] += num_tasks - sum(per)
    wfs = []
    for w, cnt in enumerate(per):
        wfs.append(
            random_layered_workflow(
                cnt,
                name=f"W{w}",
                seed=int(rng.integers(0, 2**31)),
                comm=comm,
                max_width=max(2, cnt // 8),
                max_cores=max_cores,
                feature_pool=("F1",),  # keep scale tests feasibility-trivial
            )
        )
    return Workload(tuple(wfs))
