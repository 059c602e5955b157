"""Exact MILP mapping & scheduling — the paper's Algorithm 1.

Decision variables (paper §IV-C6/7):
  * ``x_ij``  — binary, task j on node i (only feasible pairs materialized)
  * ``s_j``   — start time;  ``f_j = s_j + Σ_i d_ij x_ij`` (kept as expression)
  * ``C_max`` — makespan
  * transfer/overlap indicator binaries (the paper's ``y``, refined below)

Objective (Eq. 8): ``min α Σ_j Σ_i U_ij x_ij + β C_max``.

Constraints: assignment (Eq. 9), features (Eq. 11 — folded into the feasible
pair set), dependencies with data migration (Eq. 12/13 — big-M over node
pairs, which subsumes the paper's ``y_{ii'j} ≥ x_ij + x_i'j' − 1``), release
times, deadlines and budgets, and node capacity.

Capacity has two modes:

* ``capacity_mode="event"`` (default, *exact*): cumulative core usage is
  enforced at every task-start event.  For any schedule the peak cumulative
  usage on a node occurs at some task start, so checking
  ``c_j + Σ_k c_k·[k active at start of j on i] ≤ R_i`` at every (j, i) is
  exact.  Activity is linearized with binaries ``b_kj`` (k started no later
  than j) and ``e_kj`` (k unfinished at j's start).
* ``capacity_mode="static"`` (*paper-faithful*): the literal Algorithm-1
  line 20 constraint ``Σ_j U_j x_ij ≤ R_i`` with no time dimension.

Backend: ``scipy.optimize.milp`` (HiGHS), with the reference's constraint
rows in the reference's order, so HiGHS sees the same model.  Branch and
bound is irregular host control flow with nothing for a GPU to batch: the
exact method stays a host solver, the paper's own non-scaling component
(Table IX).  The reference's PuLP front-end is not ported: PuLP is not a
dependency of this package.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp as scipy_milp

from repro_torch.core.evaluator import ObjectiveWeights, Schedule
from repro_torch.core.workload_model import ScheduleProblem

_EPS = 1e-4


class MilpSizeError(ValueError):
    """Instance too large for the exact solver (the paper's Table IX '-')."""


def _ancestry(problem: ScheduleProblem) -> np.ndarray:
    """Boolean [T, T]: anc[a, b] = a is a (transitive) predecessor of b."""
    T = problem.num_tasks
    anc = np.zeros((T, T), dtype=bool)
    for s, d in problem.edges:
        anc[int(s), int(d)] = True
    for j in range(T):  # topo order: fold predecessors' ancestries forward
        for p in problem.pred_matrix[j]:
            if p >= 0:
                anc[:, j] |= anc[:, int(p)]
    return anc


def _transfer_time(problem: ScheduleProblem, p: int, ip: int, ij: int) -> float:
    if ip == ij:
        return 0.0
    rate = problem.dtr[ip, ij]
    if not np.isfinite(rate) or rate <= 0:
        return float("inf")
    return float(problem.data[p] / rate)


def solve_milp(
    problem: ScheduleProblem,
    weights: ObjectiveWeights = ObjectiveWeights(),
    *,
    capacity_mode: str = "event",
    time_limit: float | None = None,
    max_tasks: int = 60,
    mip_rel_gap: float = 0.0,
) -> Schedule:
    """Solve Algorithm 1 exactly. Raises :class:`MilpSizeError` above
    ``max_tasks`` (exact solving is for small instances, per the paper)."""
    t0 = time.perf_counter()
    T, N = problem.num_tasks, problem.num_nodes
    if T > max_tasks:
        raise MilpSizeError(f"{T} tasks > max_tasks={max_tasks}")

    feas_pairs: list[tuple[int, int]] = [
        (j, i) for j in range(T) for i in range(N) if problem.feasible[j, i]
    ]
    if any(not problem.feasible[j].any() for j in range(T)):
        bad = [problem.task_names[j] for j in range(T) if not problem.feasible[j].any()]
        raise ValueError(f"no feasible node for tasks {bad}")

    x_index = {pair: k for k, pair in enumerate(feas_pairs)}
    nx = len(feas_pairs)

    # variable layout: [x (nx) | s (T) | C_max (1) | b,e,w ...]
    s_off = nx
    c_off = nx + T
    nvar = nx + T + 1

    # horizon / big-M
    dmax = np.where(problem.feasible, problem.durations, 0.0).max(axis=1)
    tt_max = 0.0
    for p, _ in problem.edges:
        finite = problem.dtr[np.isfinite(problem.dtr)]
        rate_min = float(finite.min()) if finite.size else 1.0
        tt_max += float(problem.data[int(p)]) / max(rate_min, 1e-30)
    horizon = float(problem.release.max(initial=0.0) + dmax.sum() + tt_max) + 1.0
    M = horizon

    pair_list: list[tuple[int, int]] = []
    b_index: dict[tuple[int, int], int] = {}
    e_index: dict[tuple[int, int], int] = {}
    w_index: dict[tuple[int, int, int], int] = {}
    if capacity_mode == "event":
        anc = _ancestry(problem)
        for k in range(T):
            for j in range(T):
                if k == j or anc[k, j] or anc[j, k]:
                    continue  # ancestry forbids overlap; prune
                # only matters if k and j share some feasible node
                if not (problem.feasible[k] & problem.feasible[j]).any():
                    continue
                pair_list.append((k, j))
        for k, j in pair_list:
            b_index[(k, j)] = nvar
            nvar += 1
            e_index[(k, j)] = nvar
            nvar += 1
            for i in range(N):
                if problem.feasible[k, i] and problem.feasible[j, i]:
                    w_index[(k, j, i)] = nvar
                    nvar += 1

    # objective
    c = np.zeros(nvar)
    if weights.usage_mode == "weighted":
        u = problem.weighted_usage()
        for (j, i), k in x_index.items():
            c[k] = weights.alpha * u[j, i]
    else:
        for (j, i), k in x_index.items():
            c[k] = weights.alpha * problem.usage[j]
    c[c_off] = weights.beta

    rows: list[dict[int, float]] = []
    lbs: list[float] = []
    ubs: list[float] = []

    def add(row: dict[int, float], lb: float, ub: float) -> None:
        rows.append(row)
        lbs.append(lb)
        ubs.append(ub)

    # (Eq. 9) assignment: Σ_i x_ij = 1
    for j in range(T):
        row = {x_index[(j, i)]: 1.0 for i in range(N) if problem.feasible[j, i]}
        add(row, 1.0, 1.0)

    # C_max ≥ f_j  →  C_max − s_j − Σ_i d_ij x_ij ≥ 0
    for j in range(T):
        row = {c_off: 1.0, s_off + j: -1.0}
        for i in range(N):
            if problem.feasible[j, i]:
                row[x_index[(j, i)]] = -problem.durations[j, i]
        add(row, 0.0, np.inf)

    # (Eq. 12/13) dependencies with data migration, big-M over node pairs
    for p, j in problem.edges:
        p, j = int(p), int(j)
        # base: s_j ≥ f_p (transfer ≥ 0 tightening)
        row = {s_off + j: 1.0, s_off + p: -1.0}
        for i in range(N):
            if problem.feasible[p, i]:
                row[x_index[(p, i)]] = -problem.durations[p, i]
        add(row, 0.0, np.inf)
        for ip in range(N):
            if not problem.feasible[p, ip]:
                continue
            for ij in range(N):
                if not problem.feasible[j, ij] or ip == ij:
                    continue
                tt = _transfer_time(problem, p, ip, ij)
                if tt <= 0.0:
                    continue
                if not np.isfinite(tt):
                    # forbid this node pair outright: x_p,ip + x_j,ij ≤ 1
                    add({x_index[(p, ip)]: 1.0, x_index[(j, ij)]: 1.0}, -np.inf, 1.0)
                    continue
                # s_j − s_p − Σ d_pi x_pi + M x_p,ip + M x_j,ij ≤ ... rewritten:
                # s_j − f_p − tt + M(2 − x_p,ip − x_j,ij) ≥ 0
                row = {s_off + j: 1.0, s_off + p: -1.0}
                for i in range(N):
                    if problem.feasible[p, i]:
                        row[x_index[(p, i)]] = row.get(x_index[(p, i)], 0.0) - problem.durations[p, i]
                row[x_index[(p, ip)]] = row.get(x_index[(p, ip)], 0.0) - M
                row[x_index[(j, ij)]] = row.get(x_index[(j, ij)], 0.0) - M
                add(row, tt - 2 * M, np.inf)

    # hard constraints (arxiv 2511.07466): deadlines as finish-time rows and
    # budgets as cost rows over the feasible pairs.  Placement restrictions
    # need no rows — they are already folded into the feasible pair set by
    # build_problem.  An unsatisfiable combination makes the LP infeasible
    # (status "failed(2)"), which ResultSet.deviation_vs reports as an
    # infeasible baseline rather than a silent drop.
    if problem.deadline is not None:
        for j in range(T):
            dl = float(problem.deadline[j])
            if not np.isfinite(dl):
                continue
            # f_j = s_j + Σ_i d_ij x_ij ≤ deadline_j
            row = {s_off + j: 1.0}
            for i in range(N):
                if problem.feasible[j, i]:
                    row[x_index[(j, i)]] = problem.durations[j, i]
            add(row, -np.inf, dl)
    if problem.budget is not None:
        cost = problem.cost_matrix()
        for w in range(len(problem.workflow_names)):
            bud = float(problem.budget[w])
            if not np.isfinite(bud):
                continue
            # Σ_{j ∈ w, i} cost_ij x_ij ≤ budget_w
            row = {}
            for j in np.nonzero(problem.workflow_of == w)[0]:
                j = int(j)
                for i in range(N):
                    if problem.feasible[j, i]:
                        row[x_index[(j, i)]] = float(cost[j, i])
            if row:
                add(row, -np.inf, bud)

    integrality = np.zeros(nvar)
    lo = np.zeros(nvar)
    hi = np.full(nvar, np.inf)
    for k in range(nx):
        integrality[k] = 1
        hi[k] = 1.0
    for j in range(T):
        lo[s_off + j] = problem.release[j]
        hi[s_off + j] = horizon
    hi[c_off] = horizon

    if capacity_mode == "static":
        # paper-faithful Algorithm-1 line 20: Σ_j U_j x_ij ≤ R_i
        for i in range(N):
            row = {}
            for j in range(T):
                if problem.feasible[j, i]:
                    row[x_index[(j, i)]] = problem.usage[j]
            if row:
                add(row, -np.inf, float(problem.node_cores[i]))
    elif capacity_mode == "event":
        for k, j in pair_list:
            bi, ei = b_index[(k, j)], e_index[(k, j)]
            integrality[bi] = integrality[ei] = 1
            hi[bi] = hi[ei] = 1.0
            # b_kj = 0 ⇒ s_k ≥ s_j + ε:  s_k − s_j + M b_kj ≥ ε
            add({s_off + k: 1.0, s_off + j: -1.0, bi: M}, _EPS, np.inf)
            # e_kj = 0 ⇒ f_k ≤ s_j:  s_j − s_k − Σ d_ki x_ki + M e_kj ≥ 0
            row = {s_off + j: 1.0, s_off + k: -1.0, ei: M}
            for i in range(N):
                if problem.feasible[k, i]:
                    row[x_index[(k, i)]] = -problem.durations[k, i]
            add(row, 0.0, np.inf)
        for (k, j, i), wi in w_index.items():
            integrality[wi] = 1
            hi[wi] = 1.0
            bi, ei = b_index[(k, j)], e_index[(k, j)]
            # w ≥ x_ik + b + e − 2
            add({wi: 1.0, x_index[(k, i)]: -1.0, bi: -1.0, ei: -1.0}, -2.0, np.inf)
        # capacity at start of j on node i: c_j + Σ_k c_k w_kji ≤ R_i + M(1 − x_ij)
        for j in range(T):
            for i in range(N):
                if not problem.feasible[j, i]:
                    continue
                row = {x_index[(j, i)]: M}
                for (k, j2, i2), wi in w_index.items():
                    if j2 == j and i2 == i:
                        row[wi] = float(problem.cores[k])
                add(row, -np.inf, float(problem.node_cores[i]) - float(problem.cores[j]) + M)
    else:
        raise ValueError(f"unknown capacity_mode {capacity_mode!r}")

    # assemble sparse A
    data, ri, ci = [], [], []
    for r, row in enumerate(rows):
        for col, v in row.items():
            ri.append(r)
            ci.append(col)
            data.append(v)
    A = sp.csc_matrix((data, (ri, ci)), shape=(len(rows), nvar))

    options: dict = {"disp": False}
    if time_limit is not None:
        options["time_limit"] = time_limit
    if mip_rel_gap:
        options["mip_rel_gap"] = mip_rel_gap

    res = scipy_milp(
        c=c,
        constraints=LinearConstraint(A, np.asarray(lbs), np.asarray(ubs)),
        integrality=integrality,
        bounds=Bounds(lo, hi),
        options=options,
    )
    solve_time = time.perf_counter() - t0
    if res.x is None:
        return Schedule(
            assignment=np.zeros(T, dtype=np.int64),
            start=np.zeros(T),
            finish=np.zeros(T),
            makespan=float("inf"),
            usage=float("inf"),
            objective=float("inf"),
            violations=T,
            technique=f"milp[{capacity_mode}]",
            solve_time=solve_time,
            status=f"failed({res.status})",
        )

    xv = res.x
    assignment = np.zeros(T, dtype=np.int64)
    for (j, i), k in x_index.items():
        if xv[k] > 0.5:
            assignment[j] = i
    start = xv[s_off : s_off + T].copy()
    dur = problem.durations[np.arange(T), assignment]
    finish = start + dur
    makespan = float(xv[c_off])
    if weights.usage_mode == "weighted":
        u = problem.weighted_usage()
        usage = float(u[np.arange(T), assignment].sum())
    else:
        usage = float(problem.usage.sum())
    status = {0: "optimal", 1: "iteration_limit", 2: "infeasible", 3: "unbounded", 4: "other"}.get(
        res.status, str(res.status)
    )
    if res.status == 1 and res.x is not None:
        status = "feasible(time_limit)"
    # Canonical rescoring: the event-capacity linearization separates start
    # events by ε (1e-4), which leaks into the reported C_max (e.g. Table VI
    # MRI solves to 10.0001 instead of 10.0).  Re-time the MILP's assignment
    # under the shared oracle semantics — every technique is scored
    # identically — and keep the oracle timing whenever it is at least as
    # good (it strips the ε slack; the assignment itself stays optimal).
    if status.startswith(("optimal", "feasible")):
        from repro_torch.engine.backends import ENGINES  # lazy: api → milp → engine

        oracle = ENGINES.get("oracle").evaluate(problem, assignment, weights)
        if oracle.violations == 0 and oracle.makespan <= makespan + 1e-6:
            return Schedule(
                assignment=assignment,
                start=oracle.start,
                finish=oracle.finish,
                makespan=oracle.makespan,
                usage=oracle.usage,
                objective=oracle.objective,
                violations=0,
                technique=f"milp[{capacity_mode}]",
                solve_time=solve_time,
                status=status,
            )
    return Schedule(
        assignment=assignment,
        start=start,
        finish=finish,
        makespan=makespan,
        usage=usage,
        objective=float(res.fun),
        violations=0,
        technique=f"milp[{capacity_mode}]",
        solve_time=solve_time,
        status=status,
    )
