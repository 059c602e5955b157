"""Seeded continuum topology generation and digital-twin calibration.

``generate`` expands a declarative :class:`TopologySpec` (SPEC-RG-style
iot/edge/cloud/hpc tiers with latency/bandwidth/jitter link profiles and
NUMA-ish HPC islands) into a paper
:class:`~repro_torch.core.system_model.System` bit-identically per seed;
``calibrate`` fits per-node speed and per-link transfer factors back from
noisy observed durations (Adam on the device) and quantifies twin-vs-truth
makespan error.  See ``python -m repro_torch topology --help``.
"""

from repro_torch.topology.calibrate import (
    CalibrationResult,
    Observations,
    apply_factors,
    calibrate,
    calibration_report,
    least_squares_factors,
    perturbed_truth,
    synthesize_observations,
    twin_makespan_error,
)
from repro_torch.topology.generate import (
    PRESETS,
    TIER_ORDER,
    LinkProfile,
    TierSpec,
    TopologySpec,
    cached_system,
    generate,
    island_ids,
    load_spec,
    resolve_spec,
    spec_from_json,
    tier_slices,
    tiered_spec,
)

__all__ = [
    "CalibrationResult",
    "LinkProfile",
    "Observations",
    "PRESETS",
    "TIER_ORDER",
    "TierSpec",
    "TopologySpec",
    "apply_factors",
    "cached_system",
    "calibrate",
    "calibration_report",
    "generate",
    "island_ids",
    "least_squares_factors",
    "load_spec",
    "perturbed_truth",
    "resolve_spec",
    "spec_from_json",
    "synthesize_observations",
    "tier_slices",
    "tiered_spec",
    "twin_makespan_error",
]
