"""repro_torch.cycling — recurring & converging workflows (see :mod:`.spec`).

Public surface::

    CycleSpec / ConvergeSpec          # declarative, JSON round-trippable
    cycle_spec_from_json / converge_from_json
    unroll / unroll_workload          # bounded window → one DAG (MILP/HEFT/GA)
    unroll_constraints                # per-cycle deadlines for the window
    cross_edges / roots_and_sinks / task_cycle_name / resolve_cycles
"""

from repro_torch.cycling.spec import (
    ConvergeSpec,
    CycleSpec,
    converge_from_json,
    cross_edges,
    cycle_spec_from_json,
    resolve_cycles,
    roots_and_sinks,
    task_cycle_name,
    unroll,
    unroll_constraints,
    unroll_workload,
)

__all__ = [
    "ConvergeSpec",
    "CycleSpec",
    "converge_from_json",
    "cross_edges",
    "cycle_spec_from_json",
    "resolve_cycles",
    "roots_and_sinks",
    "task_cycle_name",
    "unroll",
    "unroll_constraints",
    "unroll_workload",
]
