"""Admission batching: amortize solver work across concurrent tenants.

The batcher is the service's step 2 (optimization), run once per admission
window over everything queued.  Per submission it does the cheapest thing
that yields a valid schedule:

1. **cache** — a content-identical solve was done before: zero solver work
   (:mod:`repro_torch.service.cache`);
2. **batched solve** — cache misses whose ``(technique, shape bucket,
   weights, options)`` coincide and whose technique advertises a batch fast
   path (registry ``supports_batch`` — ``ga_sweep``) are solved as ONE
   batched call: one makespan-kernel launch a generation for the whole
   group.  Padded shape buckets (:func:`repro_torch.engine.bucket_of`) make
   "coincide" common, not lucky — every 11- and 12-task STGS submission
   lands in the same bucket;
3. **single solve** — everything else routes through
   :func:`repro_torch.core.api.route_problem` (policy or direct), exactly like
   a one-shot Orchestrator run would.

Solved schedules go back into the cache keyed by content, so the *next*
window starts from step 1.

A tenant's own fault (bad options, an oversized MILP, a solver bug) rejects
that one submission with its reason recorded; a fault of the device layer
(:data:`repro_torch.core.api.DEVICE_ERRORS`: a kernel that fails to build or
launch, the card out of memory, a CUDA error) propagates out of the service
on both paths, so a broken card never shows as rejected tenants.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch import obs
from repro_torch.core.api import (
    DEVICE_ERRORS,
    FallbackExhausted,
    SolverRegistry,
    fold_engine_options,
    route_problem,
    solve_with_fallback,
    technique_kwargs,
)
from repro_torch.core.evaluator import Schedule
from repro_torch.core.workload_model import ScheduleProblem, canonical_hash
from repro_torch.engine.packed import bucket_of
from repro_torch.engine.shard import choose_shards
from repro_torch.service.cache import SolveCache
from repro_torch.service.traces import Submission


@dataclasses.dataclass
class PreparedSubmission:
    """A queued submission bound to the continuum model it will solve
    against (problem built from the *current* effective system)."""

    submission: Submission
    problem: ScheduleProblem
    key: str  # solve-cache content key
    baked: dict[str, float]  # monitor factors baked into ``problem``
    schedule: Schedule | None = None
    cache_hit: bool = False
    batched: bool = False
    error: str | None = None
    #: per-step error trail when a fallback chain degraded this solve
    fallbacks: tuple[str, ...] = ()


@dataclasses.dataclass
class AdmissionStats:
    solver_calls: int = 0  # problems that actually reached a solver
    batched_groups: int = 0  # batch-fn invocations covering > 1 problem
    batched_submissions: int = 0  # problems covered by those invocations
    sharded_groups: int = 0  # batched groups striped across > 1 device

    def merge(self, other: "AdmissionStats") -> None:
        self.solver_calls += other.solver_calls
        self.batched_groups += other.batched_groups
        self.batched_submissions += other.batched_submissions
        self.sharded_groups += other.sharded_groups


class AdmissionBatcher:
    def __init__(
        self,
        registry: SolverRegistry,
        cache: SolveCache,
        *,
        fallback: tuple[str, ...] = (),
        solve_budget: float | None = None,
        device="cuda",
        engine: str = "auto",
    ) -> None:
        self.registry = registry
        self.cache = cache
        #: graceful-degradation chain for single solves (e.g. ``("ga",
        #: "heft")``): when the requested technique raises or yields an
        #: invalid schedule, each chain entry is tried in order via
        #: :func:`repro_torch.core.api.solve_with_fallback`.  Empty ⇒ the
        #: one-shot route.
        self.fallback = tuple(fallback)
        #: optional wall-clock budget (seconds) for one submission's whole
        #: chain — clamps MILP time limits and skips to the last resort once
        #: spent.  None keeps routing fully deterministic.
        self.solve_budget = solve_budget
        #: where engine-aware techniques score their populations, and with
        #: which engine; folded into their options at solve time only, so
        #: cache keys and batch groups hash the tenant's own options
        self.device = device
        self.engine = engine

    def _group_key(self, prep: PreparedSubmission) -> tuple[Any, ...] | None:
        """Batch-compatibility key, or None when the submission can only be
        solved singly (policy routing, unknown technique, no batch path)."""
        sub = prep.submission
        if sub.technique in ("auto", "policy") or sub.technique not in self.registry:
            return None
        if self.registry.get(sub.technique).batch_fn is None:
            return None
        # bucket_of == PackedProblem.bucket without building the arrays; the
        # batch solve packs grouped members once (memoized by fingerprint,
        # so same-content resubmissions reuse arrays and device buffers)
        return (
            sub.technique,
            bucket_of(prep.problem),
            canonical_hash(
                {
                    "alpha": sub.weights.alpha,
                    "beta": sub.weights.beta,
                    "usage_mode": sub.weights.usage_mode,
                    "options": dict(sub.solver_options),
                }
            ),
        )

    def _solve_single(self, prep: PreparedSubmission, sub: Submission):
        """One per-submission solve (fallback chain when configured)."""
        if self.fallback:
            rep = solve_with_fallback(
                prep.problem,
                sub.weights,
                technique=sub.technique,
                chain=self.fallback,
                options=sub.solver_options,
                registry=self.registry,
                time_budget=self.solve_budget,
                engine=self.engine,
                device=self.device,
            )
            prep.fallbacks = rep.fallbacks
            return rep
        return route_problem(
            prep.problem,
            sub.weights,
            technique=sub.technique,
            options=sub.solver_options,
            registry=self.registry,
            engine=self.engine,
            device=self.device,
        )

    def admit(self, prepared: list[PreparedSubmission]) -> AdmissionStats:
        """Fill each ``PreparedSubmission.schedule`` in place; returns stats.

        Deterministic: cache lookups, grouping, and solves all follow the
        input (arrival) order."""
        stats = AdmissionStats()

        # 1. cache — one lookup per distinct content key; duplicates inside
        # this window coalesce onto the first occurrence and resolve after
        # the solves (a burst of identical submissions solves once)
        first_of: dict[str, PreparedSubmission] = {}
        twins: dict[str, list[PreparedSubmission]] = {}
        misses: list[PreparedSubmission] = []
        for prep in prepared:
            if prep.key in first_of:
                twins.setdefault(prep.key, []).append(prep)
                continue
            first_of[prep.key] = prep
            cached = self.cache.get(prep.key)
            if cached is not None:
                prep.schedule = cached
                prep.cache_hit = True
            else:
                misses.append(prep)

        # 2. group compatible misses for the registry's batch fast path
        groups: dict[tuple[Any, ...], list[PreparedSubmission]] = {}
        singles: list[PreparedSubmission] = []
        for prep in misses:
            key = self._group_key(prep)
            if key is None:
                singles.append(prep)
            else:
                groups.setdefault(key, []).append(prep)

        for members in groups.values():
            if len(members) == 1:
                singles.append(members[0])
                continue
            first = members[0].submission
            kw = technique_kwargs(
                self.registry,
                first.technique,
                fold_engine_options(
                    self.registry, first.solver_options, self.engine, self.device
                ),
            )
            batch_fn = self.registry.get(first.technique).batch_fn
            assert batch_fn is not None  # _group_key guarantees it
            # how the sweep will stripe this group over the local devices
            # (repro_torch.engine.shard): 1 on a one-device host
            shards = choose_shards(len(members), device=self.device)
            try:
                # call the batch fn directly (not solve_batch) so a runtime
                # decline (None — e.g. a per-instance-only backend option)
                # is visible and routes to singles instead of being counted
                # as a batch that never happened
                with obs.TRACER.span(
                    "admission.batch_solve", cat="service",
                    args={"technique": first.technique, "size": len(members),
                          "shards": shards},
                ):
                    reports = batch_fn(
                        [m.problem for m in members], first.weights, **kw
                    )
            except DEVICE_ERRORS:
                raise
            except Exception:  # noqa: BLE001
                # a bad member must not take the whole group down with it —
                # whatever the batch backend raised, retry one by one so only
                # the culprit is rejected (and its error recorded)
                singles.extend(members)
                continue
            if reports is None:
                singles.extend(members)
                continue
            stats.solver_calls += len(members)
            stats.batched_groups += 1
            stats.batched_submissions += len(members)
            if shards > 1:
                stats.sharded_groups += 1
                obs.METRICS.counter("service.admission.sharded_groups").inc()
            for prep, rep in zip(members, reports):
                prep.schedule = rep.schedule
                prep.batched = True
                self.cache.put(prep.key, rep.schedule)

        # 3. per-submission solves (policy routing or no batch path)
        for prep in singles:
            sub = prep.submission
            try:
                with obs.TRACER.span(
                    "admission.solve", cat="service",
                    args={"id": sub.id, "technique": sub.technique},
                ):
                    rep = self._solve_single(prep, sub)
            except DEVICE_ERRORS:
                raise
            except FallbackExhausted as e:
                # every chain step raised; the message is the full trail
                prep.error = f"FallbackExhausted: {e}"
                continue
            except Exception as e:  # noqa: BLE001 — a tenant's bad options
                # (misspelled kwargs → TypeError, oversized MILP → size
                # error, or any solver bug) must reject the one submission
                # with a recorded reason, not crash the multi-tenant service
                prep.error = f"{type(e).__name__}: {e}"
                continue
            stats.solver_calls += 1
            prep.schedule = rep.schedule
            self.cache.put(prep.key, rep.schedule)

        # 4. resolve coalesced duplicates: share the representative's
        # outcome; only a *servable* result (what put() would have cached —
        # a valid schedule) counts as a hit, else the twin is a miss that is
        # about to be rejected alongside its representative
        for key, dup in twins.items():
            rep = first_of[key]
            servable = rep.schedule is not None and rep.schedule.violations == 0
            for prep in dup:
                prep.schedule = rep.schedule
                prep.error = rep.error
                prep.fallbacks = rep.fallbacks
                if servable:
                    prep.cache_hit = True
                    self.cache.stats.hits += 1
                    obs.METRICS.counter("service.solve_cache.hits").inc()
                else:
                    self.cache.stats.misses += 1
                    obs.METRICS.counter("service.solve_cache.misses").inc()
        return stats
