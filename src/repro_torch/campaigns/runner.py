"""Campaign runners — how an expanded grid actually gets solved.

Runners are pluggable by name (:func:`register_runner`, mirroring the solver
and engine registries); a :class:`~repro_torch.campaigns.spec.Campaign` picks one
with its ``runner`` field and :func:`run_campaign` dispatches.  Built-ins:

* ``inline`` — solve every cell in-process through the solver registry,
  with the two service-grade amortizations applied to a *static* grid:

  1. **fingerprint dedupe** — cells whose solve identity (problem content
     hash × weights × technique × policy × options × engine) coincides are
     solved once; duplicates share the representative's schedule, with the
     service cache's hit/miss accounting
     (:class:`~repro_torch.service.cache.CacheStats`) as the proof (asserted
     in tests);
  2. **shape-bucket batching** — distinct cells whose ``(technique, pack
     bucket, weights, options, engine)`` coincide and whose technique
     registers a batch fast path run as ONE batched solve via the
     registry's ``batch_fn`` (the GA's ``ga_sweep``: one makespan launch a
     generation for the whole group on the card), warming the engine's
     fingerprint-keyed pack LRU as a side effect.

  ``runner_options={"execute": true}`` additionally replays each solved
  schedule on the digital twin under the cell's perturbation, adding
  ``observed_makespan`` / ``slowdown`` columns.

* ``service`` — stream the grid through the event-driven
  :class:`~repro_torch.service.SchedulingService` as an arrival trace (one
  submission per cell, spaced ``arrival_spacing`` virtual seconds apart), so
  a campaign exercises admission batching, the solve cache, and node
  contention exactly like production traffic.  Requires one shared system
  across cells and single-workflow families.

Both produce a :class:`~repro_torch.campaigns.results.ResultSet` whose rows follow
the campaign's deterministic cell order and whose ``meta["stats"]`` carries
the cache / batching / pack counters.

Every runner takes ``device`` (default ``"cuda"``), which reaches every
engine-aware solve.  Two departures from the reference: a fault of the
device layer (:data:`~repro_torch.core.api.DEVICE_ERRORS`) propagates out of
both solve paths instead of becoming a failed row or a silent retry, and the
stripes that ``sharded_groups`` and ``shard_devices`` count are those of the
run's ``device`` kind (:mod:`repro_torch.engine.shard`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np

from repro_torch import obs
from repro_torch.core.api import (
    DEVICE_ERRORS,
    REGISTRY,
    Scenario,
    SolverRegistry,
    did_you_mean,
    fold_engine_options,
    route_problem,
    technique_kwargs,
    _weights_to_json,
)
from repro_torch.core.evaluator import Schedule
from repro_torch.core.milp import MilpSizeError
from repro_torch.core.simulator import execute
from repro_torch.core.system_model import system_to_json
from repro_torch.core.workload_model import (
    ScheduleProblem,
    build_problem,
    canonical_hash,
    problem_fingerprint,
)
from repro_torch.engine.packed import bucket_of, pack_cache
from repro_torch.engine.shard import choose_shards, local_device_count
from repro_torch.service.cache import CacheStats
from repro_torch.campaigns.results import ResultSet
from repro_torch.campaigns.spec import Campaign, CampaignCell, cell_scenario

RunnerFn = Callable[..., ResultSet]

RUNNERS: dict[str, RunnerFn] = {}


def register_runner(name: str, fn: RunnerFn | None = None):
    """Register a campaign runner; usable directly or as a decorator.

    ``fn(campaign, *, registry=None, device="cuda") -> ResultSet``."""

    def _add(f: RunnerFn) -> RunnerFn:
        RUNNERS[name] = f
        return f

    return _add if fn is None else _add(fn)


def run_campaign(
    campaign: Campaign,
    *,
    runner: str | None = None,
    registry: SolverRegistry | None = None,
    device="cuda",
) -> ResultSet:
    """Execute a campaign with its declared (or an overriding) runner;
    engine-aware solves score their populations on ``device``."""
    name = runner if runner is not None else campaign.runner
    fn = RUNNERS.get(name)
    if fn is None:
        raise KeyError(
            f"unknown campaign runner {name!r}{did_you_mean(name, RUNNERS)}; "
            f"options {sorted(RUNNERS)}"
        )
    # every runner gets the same telemetry treatment: a campaign-level span
    # and a meta["telemetry"] block of the metrics accumulated by this run
    metrics0 = obs.METRICS.snapshot()
    with obs.TRACER.span(
        "campaign.run", cat="campaign",
        args={"campaign": campaign.name, "runner": name},
    ):
        result = fn(campaign, registry=registry, device=device)
    result.meta["telemetry"] = obs.telemetry(metrics0)
    return result


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


#: Scenario ``solver_options`` with the engine selection folded in as a
#: scoped ``backend=`` (and a ``device`` as a scoped ``device=``) —
#: :func:`repro_torch.core.api.fold_engine_options`, the exact translation
#: :func:`route_problem` applies, re-exported for runners.
effective_options = fold_engine_options


def solve_identity(problem: ScheduleProblem, scenario: Scenario) -> str:
    """Canonical content hash of one cell's solve request — the dedupe key.

    Everything a solver can observe: the problem fingerprint (durations
    bake in node speeds, feasibility bakes in features/health), weights,
    technique, custom routing policy, options, engine."""
    return canonical_hash(
        {
            "problem": problem_fingerprint(problem),
            "weights": _weights_to_json(scenario.weights),
            "technique": scenario.technique,
            "policy": scenario.policy.to_json() if scenario.policy else None,
            "options": dict(scenario.solver_options),
            "engine": scenario.engine,
        }
    )


@dataclasses.dataclass
class _Prep:
    """One cell bound to its compiled scenario/problem and, later, outcome."""

    cell: CampaignCell
    scenario: Scenario | None = None
    problem: ScheduleProblem | None = None
    key: str = ""
    schedule: Schedule | None = None
    fallbacks: tuple[str, ...] = ()
    status: str = "pending"
    error: str | None = None
    batched: bool = False
    group_size: int = 1
    constrained: bool = False
    dedup_of: int | None = None
    wall_us: float | None = None
    observed_makespan: float | None = None
    slowdown: float | None = None


def _base_row(
    prep: _Prep, coord_cols: list[str], *, executed: bool
) -> dict[str, Any]:
    cell = prep.cell
    row: dict[str, Any] = {"cell": cell.index}
    for k in coord_cols:
        row[k] = cell.coords.get(k)
    sched = prep.schedule
    row.update(
        status=prep.status,
        technique_used=sched.technique if sched is not None else None,
        solve_status=sched.status if sched is not None else None,
        makespan=float(sched.makespan) if sched is not None else None,
        usage=float(sched.usage) if sched is not None else None,
        objective=float(sched.objective) if sched is not None else None,
        violations=int(sched.violations) if sched is not None else None,
        solve_time_s=float(sched.solve_time) if sched is not None else None,
        wall_us=prep.wall_us,
        batched=prep.batched,
        group_size=prep.group_size,
        constrained=prep.constrained,
        # None when the cell has no hard constraints — a satisfaction *rate*
        # over a mixed grid must not count unconstrained cells as satisfied
        satisfied=(
            (int(sched.violations) == 0)
            if prep.constrained and sched is not None
            else None
        ),
        dedup=prep.dedup_of is not None,
        dedup_of=prep.dedup_of,
        fingerprint=prep.key or None,
        fallbacks=";".join(prep.fallbacks) if prep.fallbacks else None,
        error=prep.error,
    )
    if executed:
        row["observed_makespan"] = prep.observed_makespan
        row["slowdown"] = prep.slowdown
    return row


_ROW_DTYPES = {
    "cell": "int",
    "violations": "int",
    "group_size": "int",
    "dedup_of": "int",
    "makespan": "float",
    "usage": "float",
    "objective": "float",
    "solve_time_s": "float",
    "wall_us": "float",
    "observed_makespan": "float",
    "slowdown": "float",
    "batched": "bool",
    "constrained": "bool",
    "satisfied": "bool",
    "dedup": "bool",
}


# ---------------------------------------------------------------------------
# Inline runner
# ---------------------------------------------------------------------------


def _group_key(
    prep: _Prep, registry: SolverRegistry
) -> tuple[Any, ...] | None:
    """Batch-compatibility key (None = single solve only) — the admission
    batcher's grouping applied to a static grid."""
    assert prep.scenario is not None and prep.problem is not None
    technique = prep.scenario.technique
    if technique in ("auto", "policy") or prep.scenario.policy is not None:
        return None
    if technique not in registry or registry.get(technique).batch_fn is None:
        return None
    return (
        technique,
        bucket_of(prep.problem),
        canonical_hash(
            {
                "weights": _weights_to_json(prep.scenario.weights),
                "options": dict(prep.scenario.solver_options),
                "engine": prep.scenario.engine,
            }
        ),
    )


@register_runner("inline")
def run_inline(
    campaign: Campaign, *, registry: SolverRegistry | None = None, device="cuda"
) -> ResultSet:
    reg = registry if registry is not None else REGISTRY
    wall0 = time.perf_counter()
    pack0 = pack_cache().stats.snapshot()
    cells = campaign.expand()
    coord_cols = campaign.coord_names(cells)
    do_execute = bool(campaign.runner_options.get("execute", False))
    cache_stats = CacheStats()

    preps: list[_Prep] = []
    reps: dict[str, _Prep] = {}
    solver_calls = 0
    batched_groups = 0
    batched_submissions = 0
    sharded_groups = 0
    for cell in cells:
        prep = _Prep(cell=cell)
        preps.append(prep)
        if cell.skipped is not None:
            prep.status = f"skipped({cell.skipped})"
            continue
        prep.scenario = cell_scenario(campaign, cell)
        # cycling cells unroll here; constraints ride into the problem (and
        # thereby its fingerprint, so the dedupe key sees them for free)
        workload, constraints = prep.scenario.expanded()
        prep.problem = build_problem(prep.scenario.system, workload, constraints)
        prep.constrained = prep.problem.has_constraints
        prep.key = solve_identity(prep.problem, prep.scenario)
        if prep.key in reps:
            prep.dedup_of = reps[prep.key].cell.index
        else:
            reps[prep.key] = prep

    # group batchable representatives by (technique, bucket, weights/options)
    groups: dict[tuple[Any, ...], list[_Prep]] = {}
    singles: list[_Prep] = []
    for prep in reps.values():
        key = _group_key(prep, reg)
        if key is None:
            singles.append(prep)
        else:
            groups.setdefault(key, []).append(prep)

    for members in groups.values():
        if len(members) == 1:
            singles.append(members[0])
            continue
        first = members[0].scenario
        assert first is not None
        opts = effective_options(reg, first.solver_options, first.engine, device)
        kw = technique_kwargs(reg, first.technique, opts)
        batch_fn = reg.get(first.technique).batch_fn
        assert batch_fn is not None  # _group_key guarantees it
        # the striping the batched sweep will apply (repro_torch.engine.shard):
        # >1 means this group's instances run one slice per local device
        # instead of all on one
        shards = choose_shards(len(members), device=device)
        sp = obs.TRACER.timed(
            "campaign.batch", cat="campaign",
            args={"technique": first.technique, "size": len(members),
                  "shards": shards},
        )
        try:
            # direct batch_fn call (not solve_batch) so a runtime decline
            # (None) is visible and falls back to singles, mirroring the
            # service's admission batcher
            with sp:
                reports = batch_fn(
                    [m.problem for m in members], first.weights, **kw
                )
        except DEVICE_ERRORS:
            # a kernel that refuses its inputs is a KernelInputError, a
            # ValueError: without this it would retry singly on the host
            raise
        except (MilpSizeError, ValueError, KeyError, TypeError):
            singles.extend(members)  # retry singly; only the culprit fails
            continue
        if reports is None:
            singles.extend(members)
            continue
        wall_us = sp.wall_us
        solver_calls += len(members)
        batched_groups += 1
        batched_submissions += len(members)
        if shards > 1:
            sharded_groups += 1
        for prep, rep in zip(members, reports):
            prep.schedule = rep.schedule
            prep.status = "ok"
            prep.batched = True
            prep.group_size = len(members)
            prep.wall_us = wall_us

    for prep in singles:
        sc = prep.scenario
        assert sc is not None and prep.problem is not None
        sp = obs.TRACER.timed(
            "campaign.cell", cat="campaign",
            args={"cell": prep.cell.index, "technique": sc.technique},
        )
        try:
            with sp:
                rep = route_problem(
                    prep.problem,
                    sc.weights,
                    technique=sc.technique,
                    policy=sc.policy,
                    options=sc.solver_options,
                    registry=reg,
                    engine=sc.engine,
                    device=device,
                )
        except DEVICE_ERRORS:
            raise  # a device fault is never a failed(...) row
        except (MilpSizeError, ValueError, KeyError, TypeError) as e:
            prep.wall_us = sp.wall_us
            prep.status = f"failed({type(e).__name__})"
            prep.error = str(e)
            continue
        prep.wall_us = sp.wall_us
        prep.schedule = rep.schedule
        prep.fallbacks = rep.fallbacks
        prep.status = "ok"
        solver_calls += 1

    # resolve duplicates: share the representative's outcome outright
    # (including a violated schedule — the row must show its violations,
    # not a hole), with the admission batcher's twin accounting: only a
    # *servable* result counts as a cache hit — those hits are the
    # "identical cells solved once" proof
    for prep in preps:
        if prep.dedup_of is None:
            continue
        rep_prep = reps[prep.key]
        prep.wall_us = 0.0
        prep.schedule = rep_prep.schedule
        prep.fallbacks = rep_prep.fallbacks
        prep.status = rep_prep.status
        prep.error = rep_prep.error
        servable = (
            rep_prep.schedule is not None and rep_prep.schedule.violations == 0
        )
        if servable:
            cache_stats.hits += 1
        else:
            cache_stats.misses += 1

    if do_execute:
        for prep in preps:
            if prep.schedule is None or prep.scenario is None:
                continue
            sc = prep.scenario
            factors = np.array(
                [
                    sc.perturbation.speed_factors.get(n.name, 1.0)
                    for n in sc.system.nodes
                ]
            )
            xrep = execute(
                prep.problem,
                prep.schedule,
                speed_factors=factors,
                jitter=sc.perturbation.jitter,
                seed=sc.perturbation.seed,
                strict=False,
            )
            prep.observed_makespan = float(xrep.makespan)
            prep.slowdown = float(xrep.slowdown)

    pack_delta = pack_cache().stats.delta(pack0)
    rows = [_base_row(p, coord_cols, executed=do_execute) for p in preps]
    meta = {
        "campaign": campaign.name,
        "runner": "inline",
        "coords": coord_cols,
        "stats": {
            "cells": len(cells),
            "skipped": sum(1 for c in cells if c.skipped is not None),
            "solver_calls": solver_calls,
            "batched_groups": batched_groups,
            "batched_submissions": batched_submissions,
            "sharded_groups": sharded_groups,
            "shard_devices": local_device_count(device),
            "dedup_hits": cache_stats.hits,
            "cache": cache_stats.to_json(),
            "pack_cache": pack_delta.to_json(),
            "wall_seconds": time.perf_counter() - wall0,
        },
    }
    return ResultSet.from_rows(
        rows, name=campaign.name, meta=meta, dtypes=_ROW_DTYPES
    )


# ---------------------------------------------------------------------------
# Service runner — the grid as an arrival trace
# ---------------------------------------------------------------------------


@register_runner("service")
def run_service(
    campaign: Campaign, *, registry: SolverRegistry | None = None, device="cuda"
) -> ResultSet:
    from repro_torch.service import ServiceConfig, serve_trace
    from repro_torch.service.traces import Submission, Trace

    reg = registry if registry is not None else REGISTRY
    wall0 = time.perf_counter()
    ro = campaign.runner_options
    spacing = float(ro.get("arrival_spacing", 0.25))
    config = ServiceConfig(
        batch_window=float(ro.get("batch_window", 0.25)),
        max_batch=int(ro.get("max_batch", 32)),
        jitter=float(ro.get("jitter", 0.0)),
        seed=int(ro.get("seed", 0)),
    )
    cells = campaign.expand()
    coord_cols = campaign.coord_names(cells)
    live = [c for c in cells if c.skipped is None]

    # a Submission has no channel for these — dropping them silently would
    # run the cell under default routing / an unperturbed twin, the exact
    # fallthrough this package's strict parsing exists to prevent
    unsupported = ("policy", "perturbation", "orchestration")
    for cell in live:
        bad = [k for k in unsupported if k in cell.coords]
        if bad:
            raise ValueError(
                f"cell {cell.index} carries {bad} coordinates, which the "
                "service runner cannot honor (submissions carry only "
                "technique/weights/solver_options); use the inline runner"
            )

    scenarios: dict[int, Scenario] = {
        c.index: cell_scenario(campaign, c) for c in live
    }
    systems = {
        canonical_hash(system_to_json(sc.system)): sc.system
        for sc in scenarios.values()
    }
    if len(systems) > 1:
        raise ValueError(
            "service runner needs one shared continuum system across all "
            "cells (vary workload/technique axes instead); got "
            f"{len(systems)} distinct systems"
        )
    if not live:
        raise ValueError(f"campaign {campaign.name!r} expanded to zero live cells")
    system = next(iter(systems.values()))

    submissions = []
    for i, cell in enumerate(live):
        sc = scenarios[cell.index]
        wfs = sc.workload.workflows
        if len(wfs) != 1:
            raise ValueError(
                f"cell {cell.index} (family "
                f"{cell.coords.get('family')!r}) compiles to {len(wfs)} "
                "workflows; service submissions carry exactly one — use a "
                "single-workflow family (layered / mri-w1 / mri-w2)"
            )
        submissions.append(
            Submission(
                id=f"c{cell.index:05d}",
                tenant=str(cell.coords.get("tenant", "t0")),
                time=i * spacing,
                family=str(cell.coords.get("family", "custom")),
                workflow=wfs[0],
                technique=sc.technique,
                weights=sc.weights,
                solver_options=effective_options(reg, sc.solver_options, sc.engine),
                # cycling streams per-cycle instead of unrolling: the row
                # reports the cycle-0 record; spawned cycles land in the
                # summary's cycling counters
                constraints=sc.constraints,
                cycling=sc.cycling,
            )
        )
    trace = Trace(name=campaign.name, system=system, submissions=tuple(submissions))
    result = serve_trace(trace, config=config, registry=registry, device=device)

    by_id = {r.id: r for r in result.records}
    rows: list[dict[str, Any]] = []
    for cell in cells:
        row: dict[str, Any] = {"cell": cell.index}
        for k in coord_cols:
            row[k] = cell.coords.get(k)
        rec = by_id.get(f"c{cell.index:05d}")
        if rec is None:
            row.update(status=f"skipped({cell.skipped})")
        else:
            rec_json = rec.to_json()
            row.update(
                status=rec.status,
                technique_used=rec.technique_used or None,
                makespan=rec_json["observed_makespan"],
                predicted_makespan=rec_json["predicted_makespan"],
                queue_delay=rec_json["queue_delay"],
                turnaround=rec_json["turnaround"],
                cache_hit=rec.cache_hit,
                batched=rec.batched,
                arrival=rec_json["arrival"],
                finished=rec_json["finished"],
            )
        rows.append(row)
    summary = {k: v for k, v in result.summary().items() if k != "nodes"}
    meta = {
        "campaign": campaign.name,
        "runner": "service",
        "coords": coord_cols,
        "stats": {
            "cells": len(cells),
            "skipped": len(cells) - len(live),
            "summary": summary,
            "wall_seconds": time.perf_counter() - wall0,
        },
    }
    return ResultSet.from_rows(
        rows,
        name=campaign.name,
        meta=meta,
        dtypes={
            "cell": "int",
            "makespan": "float",
            "predicted_makespan": "float",
            "queue_delay": "float",
            "turnaround": "float",
            "arrival": "float",
            "finished": "float",
            "cache_hit": "bool",
            "batched": "bool",
        },
    )
