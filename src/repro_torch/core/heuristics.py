"""Heuristic ("H") techniques from the paper's Table VII: HEFT and OLB.

Both emit an *assignment* (task → node); the canonical timing is always
recomputed by the numpy oracle
(:func:`repro_torch.core.evaluator.evaluate_assignment`), so every technique
is scored under identical semantics.

Core bookkeeping and per-task ready times come from the one incremental
simulator (:mod:`repro_torch.engine.sim`), vectorised over nodes per task
step.  Plain numpy on the host, as in the reference: a list heuristic is a
sequential walk over the tasks, and each step scans only N nodes.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.evaluator import ObjectiveWeights, Schedule, evaluate_assignment
from repro_torch.core.workload_model import ScheduleProblem
from repro_torch.engine.sim import CoreSim, ready_times_all

_INF = 1e30


def _mean_durations(problem: ScheduleProblem) -> np.ndarray:
    """Mean duration per task over feasible nodes (HEFT's w̄_j)."""
    d = np.where(problem.feasible, problem.durations, np.nan)
    with np.errstate(invalid="ignore"):
        m = np.nanmean(d, axis=1)
    return np.where(np.isnan(m), problem.durations.mean(axis=1), m)


def upward_ranks(problem: ScheduleProblem) -> np.ndarray:
    """HEFT upward rank: rank(j) = w̄_j + max_{succ s} (c̄_js + rank(s)).

    Successors are folded through a CSR view with one vectorized max per
    task (``max_s(c̄+rank_s) == c̄ + max_s(rank_s)`` — fp addition is
    monotonic, so the fold is exact)."""
    T = problem.num_tasks
    wbar = _mean_durations(problem)
    off = problem.dtr[np.isfinite(problem.dtr)]
    mean_rate = float(off.mean()) if off.size else _INF
    cbar = problem.data / max(mean_rate, 1e-30)  # mean comm cost of task j's output
    rank = wbar.copy()
    edges = problem.edges
    if len(edges):
        order = np.argsort(edges[:, 0], kind="stable")
        src, dst = edges[order, 0], edges[order, 1]
        indptr = np.searchsorted(src, np.arange(T + 1))
        for j in range(T - 1, -1, -1):  # reverse topo order
            lo, hi = indptr[j], indptr[j + 1]
            if hi > lo:
                rank[j] = wbar[j] + cbar[j] + rank[dst[lo:hi]].max()
    return rank


def _constraint_mask(
    problem: ScheduleProblem,
    j: int,
    score: np.ndarray,
    finish_if: np.ndarray,
    spent: np.ndarray | None,
    cost: np.ndarray | None,
) -> np.ndarray:
    """Feasibility-filter a per-task candidate score vector for constraints.

    Candidates whose finish time would exceed the task's deadline, or whose
    cost would overrun the workflow's remaining budget, are masked to
    ``_INF``.  If that would mask *every* candidate the original scores
    stand — the greedy pick proceeds and the shared oracle flags the
    violation, so the heuristics degrade gracefully instead of failing on
    over-tight constraints (MILP is the technique that proves infeasibility).
    """
    masked = score
    if problem.deadline is not None:
        masked = np.where(finish_if > problem.deadline[j], _INF, masked)
    if cost is not None and spent is not None:
        w = int(problem.workflow_of[j])
        bud = problem.budget[w]  # type: ignore[index]
        if np.isfinite(bud):
            masked = np.where(spent[w] + cost[j] > bud, _INF, masked)
    if float(masked.min()) >= _INF:
        return score
    return masked


def heft(
    problem: ScheduleProblem,
    weights: ObjectiveWeights = ObjectiveWeights(),
) -> Schedule:
    """Heterogeneous Earliest Finish Time [36] under core-granular capacity."""
    t0 = time.perf_counter()
    T = problem.num_tasks
    rank = upward_ranks(problem)
    # decreasing rank is a valid topological order for positive durations;
    # stable tie-break by topo index keeps it valid in general
    order = np.lexsort((np.arange(T), -rank))
    assignment = np.zeros(T, dtype=np.int64)
    finish = np.zeros(T)
    state = CoreSim(problem)
    c_need = np.maximum(problem.cores.astype(np.int64), 1)
    cost = problem.cost_matrix() if problem.budget is not None else None
    spent = np.zeros(len(problem.workflow_names)) if cost is not None else None

    for j in order:
        ready = ready_times_all(problem, j, assignment, finish)
        c = np.minimum(c_need[j], np.maximum(state.caps, 1))
        kth = state.kth_free_all(c)
        start = np.maximum(ready, kth)
        eft = start + problem.durations[j]
        eft = np.where(problem.feasible[j], eft, _INF)
        if problem.has_constraints:
            eft = _constraint_mask(problem, j, eft, eft, spent, cost)
        i = int(np.argmin(eft))
        assignment[j] = i
        finish[j] = start[i] + problem.durations[j, i]
        if cost is not None:
            spent[problem.workflow_of[j]] += cost[j, i]
        state.commit(i, int(c[i]), float(finish[j]))

    sched = evaluate_assignment(problem, assignment, weights, technique="heft")
    sched.solve_time = time.perf_counter() - t0
    return sched


def olb(
    problem: ScheduleProblem,
    weights: ObjectiveWeights = ObjectiveWeights(),
) -> Schedule:
    """Opportunistic Load Balancing [38]: next task goes to the node that is
    available soonest, ignoring execution time."""
    t0 = time.perf_counter()
    T = problem.num_tasks
    assignment = np.zeros(T, dtype=np.int64)
    finish = np.zeros(T)
    state = CoreSim(problem)
    c_need = np.maximum(problem.cores.astype(np.int64), 1)
    cost = problem.cost_matrix() if problem.budget is not None else None
    spent = np.zeros(len(problem.workflow_names)) if cost is not None else None

    for j in range(T):  # topo order
        ready = ready_times_all(problem, j, assignment, finish)
        c = np.minimum(c_need[j], np.maximum(state.caps, 1))
        kth = state.kth_free_all(c)
        avail = np.maximum(ready, kth)
        avail = np.where(problem.feasible[j], avail, _INF)
        if problem.has_constraints:
            avail = _constraint_mask(
                problem, j, avail, avail + problem.durations[j], spent, cost
            )
        i = int(np.argmin(avail))
        assignment[j] = i
        f = max(ready[i], kth[i]) + problem.durations[j, i]
        finish[j] = f
        if cost is not None:
            spent[problem.workflow_of[j]] += cost[j, i]
        state.commit(i, int(c[i]), float(f))

    sched = evaluate_assignment(problem, assignment, weights, technique="olb")
    sched.solve_time = time.perf_counter() - t0
    return sched
