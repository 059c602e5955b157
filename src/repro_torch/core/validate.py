"""Schedule validity checker — the invariants every technique must satisfy."""

from __future__ import annotations

import numpy as np

from repro_torch.core.evaluator import Schedule
from repro_torch.core.workload_model import ScheduleProblem


def verify_schedule(
    problem: ScheduleProblem,
    schedule: Schedule,
    *,
    tol: float = 1e-5,
    check_capacity: bool = True,
) -> list[str]:
    """Returns a list of violation strings (empty == valid)."""
    errs: list[str] = []
    a = schedule.assignment
    s = schedule.start
    f = schedule.finish

    for j in range(problem.num_tasks):
        i = int(a[j])
        if not (0 <= i < problem.num_nodes):
            errs.append(f"task {j}: node index {i} out of range")
            continue
        if not problem.feasible[j, i]:
            errs.append(f"task {problem.task_names[j]}: infeasible node {i} (Eq.1/2)")
        if s[j] < problem.release[j] - tol:
            errs.append(f"task {problem.task_names[j]}: starts before release")
        expected_f = s[j] + problem.durations[j, i]
        if abs(f[j] - expected_f) > tol * max(1.0, abs(expected_f)):
            errs.append(
                f"task {problem.task_names[j]}: finish {f[j]} != start+dur {expected_f}"
            )

    # dependencies + data migration (Eq. 12 / Eq. 5)
    for p, j in problem.edges:
        p, j = int(p), int(j)
        transfer = 0.0
        if a[p] != a[j]:
            rate = problem.dtr[int(a[p]), int(a[j])]
            transfer = float(problem.data[p] / rate) if np.isfinite(rate) else np.inf
        if s[j] + tol < f[p] + transfer:
            errs.append(
                f"edge {problem.task_names[p]}->{problem.task_names[j]}: "
                f"start {s[j]:.4f} < finish+transfer {f[p] + transfer:.4f}"
            )

    if check_capacity:
        # peak cumulative usage occurs at some start event — check each
        for j in range(problem.num_tasks):
            i = int(a[j])
            active = (a == i) & (s <= s[j] + tol) & (f > s[j] + tol)
            used = problem.cores[active].sum()
            cap = problem.node_cores[i]
            if used > cap + tol:
                errs.append(f"node {i} over capacity at t={s[j]:.4f}: {used} > {cap}")

    mk = float(f.max(initial=0.0))
    if abs(mk - schedule.makespan) > tol * max(1.0, mk) and np.isfinite(schedule.makespan):
        # a time-limited solver may report C_max above max f; only lower is wrong
        if schedule.makespan + tol < mk:
            errs.append(f"reported makespan {schedule.makespan} < max finish {mk}")
    return errs
