"""Solve cache — the "millions of users" hot path.

A service multiplexing many tenants over one continuum sees the same
workloads over and over (the paper's MRI pipelines are per-patient instances
of two fixed DAGs).  Solving is the expensive step, so repeat submissions
must skip it entirely: the cache keys on a canonical *content* hash of
everything a solver can observe —

    key = canonical_hash(problem_fingerprint ⊕ weights ⊕ technique ⊕ options)

(:func:`repro_torch.core.workload_model.problem_fingerprint`).  Because durations
bake in monitor-learned node speeds and feasibility bakes in node health,
drift and failures change the key automatically — a stale schedule can never
be replayed against a changed continuum, no invalidation protocol needed.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Mapping

from repro_torch import obs
from repro_torch.core.evaluator import ObjectiveWeights, Schedule
from repro_torch.core.workload_model import (
    ScheduleProblem,
    canonical_hash,
    problem_fingerprint,
)


def solve_cache_key(
    problem: ScheduleProblem,
    weights: ObjectiveWeights,
    technique: str,
    options: Mapping[str, Any] | None = None,
) -> str:
    """Content-addressed identity of one solve request."""
    return canonical_hash(
        {
            "problem": problem_fingerprint(problem),
            "weights": {
                "alpha": weights.alpha,
                "beta": weights.beta,
                "usage_mode": weights.usage_mode,
            },
            "technique": technique,
            "options": dict(options or {}),
        }
    )


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def to_json(self) -> dict[str, Any]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }


class SolveCache:
    """Bounded LRU of key → :class:`Schedule` (valid schedules only).

    Entries are treated as immutable — the service dispatches a cached
    schedule without mutating its arrays, so one stored instance serves any
    number of repeat submissions."""

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self._entries: OrderedDict[str, Schedule] = OrderedDict()
        self.stats = CacheStats()

    def get(self, key: str) -> Schedule | None:
        sched = self._entries.get(key)
        if sched is None:
            self.stats.misses += 1
            obs.METRICS.counter("service.solve_cache.misses").inc()
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        obs.METRICS.counter("service.solve_cache.hits").inc()
        return sched

    def put(self, key: str, schedule: Schedule) -> None:
        if schedule.violations != 0:
            return  # never serve an invalid schedule from cache
        self._entries[key] = schedule
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
            obs.METRICS.counter("service.solve_cache.evictions").inc()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: object) -> bool:
        return key in self._entries
