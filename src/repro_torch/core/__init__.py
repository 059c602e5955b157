"""System and workload modelling, the numpy oracle and the metaheuristics."""

from repro_torch.core.evaluator import ObjectiveWeights, Schedule, evaluate_assignment
from repro_torch.core.metaheuristics import MHResult, ga, ga_sweep
from repro_torch.core.system_model import (
    Node,
    System,
    make_system,
    mri_system,
    synthetic_system,
    system_from_json,
    system_to_json,
)
from repro_torch.core.validate import verify_schedule
from repro_torch.core.workload_model import (
    BIG_PENALTY,
    Constraints,
    ScheduleProblem,
    Task,
    Workflow,
    Workload,
    build_problem,
    canonical_hash,
    mri_w1,
    mri_w2,
    mri_workload,
    problem_fingerprint,
    random_layered_workflow,
    stgs_workflows,
    synthetic_workload,
    workload_from_json,
    workload_to_json,
)
