"""Where a schedule gets executed against a problem: the packed problem,
the host simulator and the registry of fitness engines."""

from repro_torch.engine.backends import (
    ENGINES,
    EngineCapabilities,
    EngineRegistry,
    ScheduleEngine,
    batched_population_fitness_fn,
    population_fitness_fn,
    population_fitness_from_arrays,
    register_engine,
    resolve_engine,
)
from repro_torch.engine.packed import (
    FITNESS_ARRAY_KEYS,
    PackedProblem,
    bucket_of,
    common_bucket,
    exact_bucket,
    from_arrays,
    pack,
    pack_cache,
    stack_packed,
)
from repro_torch.engine.sim import CoreSim, commit_sorted, ready_times_all, run_schedule
