"""Discrete-event executor / digital twin (paper Fig. 4, steps 3–4).

The paper dispatches the solver's sorted JSON schedule to SLURM/Kubernetes;
without a live cluster the executor is a discrete-event simulator with the
*same JSON contract*.  It serves two purposes:

1. **Validation** — replays a schedule under the system model with optional
   per-node speed perturbations and reports predicted vs. observed makespan
   (the experiments' "adaptability to variations" axis, §VI).
2. **Monitoring feedback** — emits per-task logs that
   :mod:`repro_torch.core.monitor` folds back into node properties ``P``
   (the digital-twin loop: next solve uses measured speeds).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.evaluator import Schedule
from repro_torch.core.validate import verify_schedule
from repro_torch.core.workload_model import ScheduleProblem
from repro_torch.engine.sim import run_schedule


@dataclasses.dataclass
class TaskLog:
    task: str
    node: int
    start: float
    finish: float
    predicted_finish: float


@dataclasses.dataclass
class ExecutionReport:
    logs: list[TaskLog]
    makespan: float
    predicted_makespan: float
    slowdown: float  # observed / predicted

    def observed_speed_factors(self, problem: ScheduleProblem) -> dict[int, float]:
        """Per-node observed speed multiplier (1.0 = as modeled)."""
        num = {}
        den = {}
        # one name→index map instead of list.index per log: the orchestrator
        # calls this every feedback round, and at 5000 tasks the repeated
        # linear scans were O(T²)
        index = {name: j for j, name in enumerate(problem.task_names)}
        for log in self.logs:
            j = index[log.task]
            pred = problem.durations[j, log.node]
            obs = log.finish - log.start
            if obs > 0 and pred > 0:
                num[log.node] = num.get(log.node, 0.0) + pred
                den[log.node] = den.get(log.node, 0.0) + obs
        return {i: num[i] / den[i] for i in num}


def execute(
    problem: ScheduleProblem,
    schedule: Schedule,
    *,
    speed_factors: np.ndarray | None = None,
    seed: int | None = None,
    jitter: float = 0.0,
    strict: bool = True,
) -> ExecutionReport:
    """Replay ``schedule`` keeping its *assignment* but re-deriving timing
    under perturbed node speeds (``speed_factors[i]`` multiplies node i's
    throughput; ``jitter`` adds lognormal noise per task).

    With no perturbation the replay reproduces the oracle timing exactly —
    asserted in tests (executor and solver agree on the model).
    """
    if strict:
        errs = verify_schedule(problem, schedule)
        if errs:
            raise ValueError(f"refusing to execute invalid schedule: {errs[:3]}")

    T = problem.num_tasks
    a = schedule.assignment
    factors = np.ones(problem.num_nodes) if speed_factors is None else np.asarray(speed_factors)
    mults = None
    if jitter > 0:
        # one draw per task in topo order — same stream as per-task draws
        mults = np.random.default_rng(seed).lognormal(0.0, jitter, size=T)

    # the one incremental simulator (repro_torch.engine.sim) replays the schedule
    # under perturbed speeds — identical semantics to the solver-side oracle
    start, finish, _ = run_schedule(
        problem, a, speed_factors=factors, jitter_mults=mults
    )
    logs = [
        TaskLog(
            task=problem.task_names[j],
            node=int(a[j]),
            start=float(start[j]),
            finish=float(finish[j]),
            predicted_finish=float(schedule.finish[j]),
        )
        for j in range(T)
    ]
    mk = float(finish.max(initial=0.0))
    pred = float(schedule.makespan)
    return ExecutionReport(
        logs=logs,
        makespan=mk,
        predicted_makespan=pred,
        slowdown=mk / pred if pred > 0 else float("nan"),
    )
