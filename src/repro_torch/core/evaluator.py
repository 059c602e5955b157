"""Schedule evaluation — the paper's timing model (Eq. 4–6) made executable.

Semantics, shared by every technique so results are comparable:
*capacity-aware core-granular list scheduling*.  Each node ``i`` owns
``R_i^1`` cores, each with its own free time.  A task ``j`` on node ``i``
becomes ready at

    ready_j = max(release_j, max_{j' ∈ preds(j)} f_{j'} + d_t(j'→j))    (Eq. 12)

with the data-migration term of Eq. (5), ``d_t = R^3_{j'} / P^3_{a(j'),a(j)}``
when ``a(j') ≠ a(j)`` else 0, then starts at the earliest time ≥ ready_j at
which ``R^1_j`` cores are free and holds them for ``d_ij`` (Eq. 4).

:func:`evaluate_assignment` is the numpy oracle over
:func:`repro_torch.engine.sim.run_schedule`; population fitness on a device
lives in :mod:`repro_torch.engine.backends`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.workload_model import BIG_PENALTY, ScheduleProblem
from repro_torch.engine.sim import run_schedule


@dataclasses.dataclass(frozen=True)
class ObjectiveWeights:
    """Weights of the multi-objective function (Eq. 8):
    ``min α · Σ U_ij x_ij + β · C_max``.  Frozen, so it is hashable and safe
    as a dataclass field default."""

    alpha: float = 1.0
    beta: float = 1.0
    usage_mode: str = "fixed"  # "fixed" (U_j = R_j) | "weighted" (Eq. 3)


@dataclasses.dataclass
class Schedule:
    """Solver output — the Fig. 4 step-3 artifact (mapping + timing)."""

    assignment: np.ndarray  # [T] node index per task
    start: np.ndarray  # [T]
    finish: np.ndarray  # [T]
    makespan: float
    usage: float
    objective: float
    violations: int
    technique: str = ""
    solve_time: float = 0.0
    status: str = "feasible"


def _usage_of(problem: ScheduleProblem, assignment: np.ndarray, weights: ObjectiveWeights) -> float:
    if weights.usage_mode == "weighted":
        u = problem.weighted_usage()
        return float(u[np.arange(problem.num_tasks), assignment].sum())
    return float(problem.usage.sum())


def constraint_violations(
    problem: ScheduleProblem,
    assignment: np.ndarray,
    finish: np.ndarray,
    *,
    dtype=np.float64,
) -> int:
    """Hard-constraint violations of a timed schedule: tasks finishing past
    their deadline plus workflows whose total cost exceeds their budget.
    With ``dtype=np.float32`` the comparisons use the same f32 quantities as
    the device fitness (lateness inside the makespan kernel, budget overage
    in the objective)."""
    extra = 0
    if problem.deadline is not None:
        fin = np.asarray(finish, dtype=dtype)
        extra += int(np.sum(fin > problem.deadline.astype(dtype)))
    if problem.budget is not None:
        cost = problem.cost_matrix().astype(dtype)
        cost_t = cost[np.arange(problem.num_tasks), np.asarray(assignment, dtype=np.int64)]
        w_count = len(problem.workflow_names)
        mask = problem.workflow_of[None, :] == np.arange(w_count, dtype=np.int64)[:, None]
        wf_cost = np.sum(np.where(mask, cost_t[None, :], dtype(0)), axis=1)
        extra += int(np.sum(wf_cost > problem.budget.astype(dtype)))
    return extra


def evaluate_assignment(
    problem: ScheduleProblem,
    assignment: np.ndarray,
    weights: ObjectiveWeights = ObjectiveWeights(),
    technique: str = "",
    *,
    dtype=np.float64,
) -> Schedule:
    """Numpy oracle: ``assignment[j]`` is the node of topo-ordered task j.
    ``dtype=np.float32`` follows the makespan kernel's operation order, so
    its makespans equal the kernel's bit for bit."""
    assignment = np.asarray(assignment, dtype=np.int64)
    start, finish, violations = run_schedule(problem, assignment, dtype=dtype)
    if problem.has_constraints:
        violations = int(violations) + constraint_violations(
            problem, assignment, finish, dtype=dtype
        )
    makespan = float(finish.max(initial=0.0))
    usage = _usage_of(problem, assignment, weights)
    objective = weights.alpha * usage + weights.beta * makespan + BIG_PENALTY * violations
    return Schedule(
        assignment=assignment,
        start=start,
        finish=finish,
        makespan=makespan,
        usage=usage,
        objective=objective,
        violations=violations,
        technique=technique,
    )
