"""Continuum scheduling of ML jobs onto a modelled TPU fleet: the paper's
workflow-driven mapping applied to the model zoo's own workloads.

Ported from the reference's ``repro/core/continuum.py``.  Two levels, both
solved with the paper's solver suite:

1. **Job level** (:func:`schedule_jobs`): each (arch x shape) cell is a
   paper task whose per-node duration ``d_ij`` (Eq. 4) comes from the
   analytic roofline model (``core/autoshard.py``) evaluated on that node's
   slice size.  A job whose resident bytes exceed the slice's HBM gets an
   infinite duration there (the Eq. 2 analogue), which packing and the
   scorers treat as infeasible, as the reference's do.  Data edges
   (checkpoints handed from train to eval to serve) carry Eq. 5 transfer
   times over ICI or DCN.

2. **Step level** (:func:`training_step_workflow`): one training step as
   per-layer-group forward, backward and update tasks with activation
   transfer edges.

The solvers run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.shapes import SHAPES
from repro_torch.core import autoshard
from repro_torch.core.api import Scenario, SolveReport, solve_problem
from repro_torch.core.evaluator import ObjectiveWeights
from repro_torch.core.system_model import System, tpu_fleet
from repro_torch.core.workload_model import Task, Workflow, Workload, build_problem
from repro_torch.models.registry import get_model


@dataclasses.dataclass(frozen=True)
class Job:
    """One schedulable ML job (the continuum 'task')."""

    name: str
    arch: str
    shape: str
    steps: int = 100  # train steps or serve batches
    deps: tuple[str, ...] = ()
    data_gb: float = 0.0  # artifact handed to dependents (checkpoint size)


def default_job_mix() -> tuple[Job, ...]:
    """A representative train→eval→serve mix over the assigned archs."""
    return (
        Job("train-qwen", "qwen2.5-3b", "train_4k", steps=200, data_gb=7.0),
        Job("eval-qwen", "qwen2.5-3b", "prefill_32k", steps=20, deps=("train-qwen",)),
        Job("serve-qwen", "qwen2.5-3b", "decode_32k", steps=500, deps=("train-qwen",), data_gb=0.0),
        Job("train-moe", "qwen3-moe-30b-a3b", "train_4k", steps=100, data_gb=61.0),
        Job("serve-moe", "qwen3-moe-30b-a3b", "decode_32k", steps=500, deps=("train-moe",)),
        Job("train-mamba", "mamba2-780m", "train_4k", steps=300, data_gb=1.6),
        Job("long-mamba", "mamba2-780m", "long_500k", steps=1000, deps=("train-mamba",)),
        Job("serve-mixtral", "mixtral-8x7b", "decode_32k", steps=400, data_gb=0.0),
    )


def job_durations(jobs: tuple[Job, ...], system: System) -> np.ndarray:
    """d_ij matrix: job j on slice-node i → steps × analytic step time.

    The paper's Eq. (4) ``d_ij = R_j / P_i`` with ``R_j`` = job FLOPs and
    ``P_i`` = the roofline-effective throughput of that slice for this
    job's shape (compute/memory/collective max — not the nameplate peak)."""
    out = np.zeros((len(jobs), system.num_nodes))
    for j, job in enumerate(jobs):
        cfg = get_model(job.arch).config
        suite = SHAPES[job.shape]
        for i, node in enumerate(system.nodes):
            chips = int(node.cores)
            tp = min(16, chips)
            lay = autoshard.Layout(dp=max(chips // tp, 1), tp=tp, pods=1)
            est = autoshard.estimate(cfg, suite, lay)
            # HBM capacity check — the Eq. (2) analogue
            hbm = chips * 16 * 1024**3
            if est.hbm_per_chip * chips > hbm * 1.0:
                out[j, i] = np.inf
            else:
                out[j, i] = job.steps * est.step_s
    return out


def jobs_to_workload(jobs: tuple[Job, ...], system: System) -> Workload:
    durations = job_durations(jobs, system)
    node_names = [n.name for n in system.nodes]
    # a job occupies its whole slice (R1 = slice chip count): one job per
    # slice at a time, the fleet-level analogue of Eq. (2)
    slice_chips = int(min(n.cores for n in system.nodes))
    # durations are roofline-derived (already speed-adjusted) — neutralize
    # the Eq. 4 speed division by passing speed-1-normalized values
    speeds = {n.name: n.processing_speed for n in system.nodes}
    tasks = []
    for j, job in enumerate(jobs):
        dur = {
            node_names[i]: float(durations[j, i]) * speeds[node_names[i]]
            for i in range(system.num_nodes)
        }
        tasks.append(
            Task(
                name=job.name,
                cores=slice_chips,
                data=job.data_gb,  # Eq. 5 numerator (GB over GB/s DTR)
                features=frozenset({"F9"}),
                durations=dur,
                deps=job.deps,
            )
        )
    return Workload((Workflow("jobmix", tuple(tasks)),))


def schedule_jobs(
    jobs: tuple[Job, ...] | None = None,
    *,
    num_pods: int = 2,
    slices_per_pod: int = 4,
    technique: str = "auto",
    weights: ObjectiveWeights = ObjectiveWeights(),
    **kwargs,
) -> tuple[SolveReport, System]:
    """Map the job mix onto the fleet with the paper's solver
    (:func:`~repro_torch.core.api.solve_problem`, on the card unless
    ``device="cpu"`` is among ``kwargs``: the GA scores its populations on
    the makespan kernel there)."""
    jobs = jobs or default_job_mix()
    system = tpu_fleet(num_pods=num_pods, slices_per_pod=slices_per_pod)
    workload = jobs_to_workload(jobs, system)
    problem = build_problem(system, workload)
    report = solve_problem(problem, technique, weights, **kwargs)
    return report, system


def jobs_scenario(
    jobs: tuple[Job, ...] | None = None,
    *,
    num_pods: int = 2,
    slices_per_pod: int = 4,
    technique: str = "auto",
    weights: ObjectiveWeights = ObjectiveWeights(),
    name: str = "tpu-jobmix",
) -> Scenario:
    """The job mix as a declarative :class:`~repro_torch.core.api.Scenario`,
    runnable through ``Orchestrator``/``run_scenario`` or saved to one JSON
    file for ``python -m repro_torch run``."""
    jobs = jobs or default_job_mix()
    system = tpu_fleet(num_pods=num_pods, slices_per_pod=slices_per_pod)
    workload = jobs_to_workload(jobs, system)
    return Scenario(
        name=name,
        system=system,
        workload=workload,
        weights=weights,
        technique=technique,
    )


# -----------------------------------------------------------------------------
# Step-level workflow view
# -----------------------------------------------------------------------------

def training_step_workflow(arch: str, shape: str = "train_4k", groups: int = 8) -> Workflow:
    """One training step as a paper DAG: fwd chain -> bwd chain -> update,
    with activation-transfer edges (Eq. 5) between layer groups."""
    cfg = get_model(arch).config
    suite = SHAPES[shape]
    tokens = suite.global_batch * suite.seq_len
    n = cfg.active_param_count()
    flops_per_group_fwd = 2 * n * tokens / groups
    act_gb = 2 * tokens * cfg.d_model / 1e9  # bf16 activations between groups

    tasks: list[Task] = []
    for g in range(groups):
        deps = (f"fwd{g-1}",) if g else ()
        tasks.append(
            Task(f"fwd{g}", cores=1, data=act_gb, features=frozenset({"F9"}),
                 work=flops_per_group_fwd, deps=deps)
        )
    for g in range(groups - 1, -1, -1):
        deps = [f"fwd{groups-1}"] if g == groups - 1 else [f"bwd{g+1}"]
        deps.append(f"fwd{g}")
        tasks.append(
            Task(f"bwd{g}", cores=1, data=act_gb, features=frozenset({"F9"}),
                 work=2 * flops_per_group_fwd, deps=tuple(deps))
        )
    tasks.append(
        Task("update", cores=1, data=0.0, features=frozenset({"F9"}),
             work=flops_per_group_fwd * 0.05, deps=tuple(f"bwd{g}" for g in range(groups)))
    )
    return Workflow(f"{arch}-step", tuple(tasks))
