"""Where a schedule gets executed against a problem: the packed problem,
the host simulator, the registry of fitness engines and the multi-device
instance axis (:mod:`repro_torch.engine.shard`)."""

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
from repro_torch.engine.shard import (
    ShardedStack,
    choose_shards,
    instance_mesh,
    local_device_count,
    sharded_batched_fitness,
    stack_packed_sharded,
)
from repro_torch.engine.sim import CoreSim, commit_sorted, ready_times_all, run_schedule
