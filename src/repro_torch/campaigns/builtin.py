"""Built-in campaigns — the reference's standing benchmarks as declarative
specs, run by the port.

Every lane is a named campaign here, executed by the shared campaign
machinery, with a thin exporter that writes the reference's ``BENCH_*.json``
payloads (same keys).  The exporters keep the reference's default output
names, which are files of the reference package in the repository root:
callers of the port pass an ``out_path`` elsewhere.

* ``smoke``   — the CI Table IX scale points (5×5, 50×50 × MILP/GA/HEFT)
  through the ``inline`` runner → ``BENCH_table9.json`` (same names, same
  derived makespans as the pre-campaign harness);
* ``table9``  — the full Table-IX-style comparison grid (families × sizes ×
  seeds × {milp, heft, olb, ga}) whose
  :meth:`~repro_torch.campaigns.results.ResultSet.deviation_vs` reproduces the
  paper's optimality-gap analysis;
* ``service`` — the 200-submission mixed-family arrival trace through the
  event-driven service (``trace`` runner) → ``BENCH_service.json``;
* ``chaos``   — the robustness lane: the same trace runner under seeded
  failure/recovery/drift storms (:func:`repro_torch.service.chaos_events`) with
  retries and a solver fallback chain enabled → ``BENCH_chaos.json``;
* ``engine``  — per-engine population-evaluation throughput at three shape
  buckets (``engine-bench`` runner: ``torch``, ``oracle`` and the makespan
  kernel's ``cuda``) → ``BENCH_engine.json``;
* ``topology`` — generated tiered continua (:mod:`repro_torch.topology`):
  tier scale × technique, plus the digital-twin calibration headline
  (twin-vs-truth makespan error before/after) → ``BENCH_topology.json``;
* ``cycling`` — recurring workflows under hard constraints
  (:mod:`repro_torch.cycling`): a deadline-tightening sweep over a 3-cycle
  unrolled DAG × {milp, heft, ga} with the constraint-satisfaction /
  makespan trade-off report, plus a converging-stream service section
  (warm solve-cache re-solves, replay fingerprint) → ``BENCH_cycling.json``.

Use :func:`builtin_campaign` to get a spec by name (it round-trips through
JSON like any user spec) and :func:`run_named_campaign` / the per-lane
helpers to execute + export.  Every runner and exporter takes ``device``
(default ``"cuda"``): the GA cells and the engine lane's ``cuda`` rows run the
makespan kernel there.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.api import SolverRegistry, did_you_mean
from repro_torch.campaigns.results import ResultSet
from repro_torch.campaigns.spec import Axis, Campaign, SkipRule
from repro_torch.campaigns.runner import register_runner, run_campaign

# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

#: Table IX square scaling: nodes = tasks = workload seed (one canonical
#: instance per scale point, matching the pre-campaign harness).
SMOKE_SCALES = ({"size": 5, "nodes": 5, "seed": 5},
                {"size": 50, "nodes": 50, "seed": 50})

#: MILP's practical exact-solve ceiling in the benchmarks (the paper's '-').
MILP_SKIP = SkipRule(where={"technique": "milp", "size": {"min": 26}},
                     reason="size")


def smoke_campaign() -> Campaign:
    """The CI smoke lane: small Table IX scale points, MILP/GA/HEFT."""
    return Campaign(
        name="smoke",
        axes=(
            Axis("scale", SMOKE_SCALES, zipped=True),
            Axis("technique", ("milp", "ga", "heft")),
        ),
        defaults={
            "family": "synthetic",
            "engine": "auto",
            "solver_options": {
                "milp": {"time_limit": 60.0},
                "ga": {"seed": 0, "pop_size": 32, "generations": 20},
            },
        },
        skip=(MILP_SKIP,),
        runner="inline",
    )


def table9_campaign(
    *,
    families: tuple[str, ...] = ("layered", "synthetic"),
    sizes: tuple[int, ...] = (5, 10, 20),
    seeds: tuple[int, ...] = (0, 1),
    techniques: tuple[str, ...] = ("milp", "heft", "olb", "ga"),
    nodes: int = 3,
    milp_time_limit: float = 10.0,
) -> Campaign:
    """The paper's comparative grid: families × sizes × seeds × techniques
    on one small continuum, MILP as the exact baseline for
    ``deviation_vs("milp")`` (Table IX / §VIII: heuristics within 5–10%)."""
    return Campaign(
        name="table9",
        axes=(
            Axis("family", tuple(families)),
            Axis("size", tuple(sizes)),
            Axis("seed", tuple(seeds)),
            Axis("technique", tuple(techniques)),
        ),
        defaults={
            "nodes": nodes,
            "engine": "auto",
            "solver_options": {
                "milp": {"time_limit": milp_time_limit},
                "ga": {"seed": 0, "pop_size": 32, "generations": 12},
            },
        },
        skip=(MILP_SKIP,),
        runner="inline",
    )


def service_campaign(num_submissions: int = 200, seed: int = 0) -> Campaign:
    """The CI service lane: a seeded mixed-family arrival stream (not a
    grid) replayed through the event-driven scheduler."""
    return Campaign(
        name="service",
        runner="trace",
        runner_options={
            "num_submissions": num_submissions,
            "seed": seed,
            "rate": 4.0,
            "burst_prob": 0.15,
            "burst_size": 8,
            "node_events": True,
            "batch_window": 0.5,
            "max_batch": 32,
        },
    )


def chaos_campaign(num_submissions: int = 120, seed: int = 0) -> Campaign:
    """The CI robustness lane: a seeded arrival stream under failure /
    recovery / drift storms, with retries + a ``ga → heft`` fallback chain.

    Rates are calibrated to the *execution backlog*, not the ~30-second
    arrival span: the 120-submission stream keeps nodes busy for upwards of
    a thousand virtual seconds, so storms run over ``horizon=1200`` at
    rates giving a handful of outages and drifts landing on in-flight work
    (real salvage + lost-work accounting) without degenerating into a
    blackout."""
    return Campaign(
        name="chaos",
        runner="trace",
        runner_options={
            "num_submissions": num_submissions,
            "seed": seed,
            "rate": 4.0,
            "burst_prob": 0.15,
            "burst_size": 8,
            "chaos": {
                "horizon": 1200.0,
                "failure_rate": 0.004,
                "outage_mean": 60.0,
                "drift_rate": 0.01,
                "drift_range": [0.4, 1.6],
            },
            "batch_window": 0.5,
            "max_batch": 32,
            "max_retries": 4,
            "backoff_base": 0.5,
            "backoff_cap": 30.0,
            "fallback": ["ga", "heft"],
        },
    )


#: topology-lane scale points: generated-continuum preset × workload size.
#: Sizes follow the node counts (16 / 64) so each cell has work to spread.
TOPOLOGY_SCALES = ({"topology": "tiny", "size": 24},
                   {"topology": "small", "size": 48})


def topology_campaign(
    *,
    scales: tuple[dict, ...] = TOPOLOGY_SCALES,
    techniques: tuple[str, ...] = ("heft", "ga"),
) -> Campaign:
    """The topology lane: generated tiered continua
    (:mod:`repro_torch.topology`) swept over tier scale × technique through
    the inline runner.  Cells compile their ``topology`` coordinate through
    the fingerprint-keyed spec → ``System`` cache, so both techniques share
    one expansion."""
    return Campaign(
        name="topology",
        axes=(
            Axis("scale", tuple(scales), zipped=True),
            Axis("technique", tuple(techniques)),
        ),
        defaults={
            "system": "topology",
            "family": "layered",
            "engine": "auto",
            "solver_options": {
                "ga": {"seed": 0, "pop_size": 24, "generations": 8},
            },
        },
        runner="inline",
    )


#: (label, tasks, nodes, population) — three distinct pow2 shape buckets
ENGINE_SHAPES = (
    {"shape": "small", "size": 24, "nodes": 4, "population": 64},
    {"shape": "medium", "size": 96, "nodes": 8, "population": 64},
    {"shape": "large", "size": 384, "nodes": 16, "population": 32},
)

#: backend → (population divisor, iters) — the numpy oracle scores one
#: candidate at a time on the host, so it gets a reduced load; ``torch`` (the
#: plain version) and ``cuda`` (the makespan kernel) run the full population
ENGINE_BACKENDS = {"torch": (1, 3), "oracle": (8, 1), "cuda": (1, 3)}


def engine_campaign() -> Campaign:
    """The CI engine lane: per-backend evaluation throughput by shape."""
    return Campaign(
        name="engine",
        axes=(
            Axis("shape", ENGINE_SHAPES, zipped=True),
            Axis("backend", tuple(ENGINE_BACKENDS)),
        ),
        runner="engine-bench",
    )


#: the cycling lane's deadline-tightening sweep.  The unrolled 3-cycle
#: layered(8) workload has an unconstrained optimum of 27.0 on the 3-node
#: synthetic system (MILP = HEFT), so ``loose``/``snug`` are satisfiable,
#: ``tight`` (24 < 27) is provably unsatisfiable — the MILP cell goes
#: infeasible and the heuristics/GA report violated schedules.
CYCLING_TIGHTNESS = (
    {"tightness": "none"},
    {"tightness": "loose", "constraints": {"deadline": {"W8": 40.0}}},
    {"tightness": "snug", "constraints": {"deadline": {"W8": 28.0}}},
    {"tightness": "tight", "constraints": {"deadline": {"W8": 24.0}}},
)

#: cycle structure shared by every cycling-lane cell (3 cycles, sink→root
#: cross-cycle edges), unrolled to 24 tasks — inside MILP's exact window
CYCLING_SPEC = {"cycles": 3, "period": 4.0, "cross": [["*", "*"]]}


def cycling_campaign(
    *,
    techniques: tuple[str, ...] = ("milp", "heft", "ga"),
    tightness: tuple[dict, ...] = CYCLING_TIGHTNESS,
) -> Campaign:
    """The CI cycling lane: recurring workflows × deadline tightness ×
    technique through the inline runner, all three solver families under
    the same hard constraints (MILP rows / HEFT filtering / GA penalty)."""
    return Campaign(
        name="cycling",
        axes=(
            Axis("tightness", tuple(tightness), zipped=True),
            Axis("technique", tuple(techniques)),
        ),
        defaults={
            "family": "layered",
            "size": 8,
            "seed": 8,
            "nodes": 3,
            "engine": "auto",
            "cycling": CYCLING_SPEC,
            "solver_options": {
                "milp": {"time_limit": 30.0},
                "ga": {"seed": 0, "pop_size": 48, "generations": 20},
            },
        },
        runner="inline",
    )


BUILTIN_CAMPAIGNS: dict[str, Callable[[], Campaign]] = {
    "smoke": smoke_campaign,
    "table9": table9_campaign,
    "service": service_campaign,
    "chaos": chaos_campaign,
    "engine": engine_campaign,
    "topology": topology_campaign,
    "cycling": cycling_campaign,
}


def builtin_campaign(name: str) -> Campaign:
    factory = BUILTIN_CAMPAIGNS.get(name)
    if factory is None:
        raise KeyError(
            f"unknown built-in campaign {name!r}"
            f"{did_you_mean(name, BUILTIN_CAMPAIGNS)}; "
            f"options {sorted(BUILTIN_CAMPAIGNS)}"
        )
    return factory()


# ---------------------------------------------------------------------------
# Specialized runners for the non-grid lanes
# ---------------------------------------------------------------------------


@register_runner("trace")
def run_trace(
    campaign: Campaign, *, registry: SolverRegistry | None = None, device="cuda"
) -> ResultSet:
    """Generate a seeded arrival trace and replay it through the service.

    Unlike the grid-streaming ``service`` runner, this reproduces the
    benchmark's *random* multi-tenant stream (Poisson + bursts + node
    events) — the campaign spec is the trace's parameters."""
    from repro_torch.service import ServiceConfig, generate_trace, serve_trace

    ro = campaign.runner_options
    n = int(ro.get("num_submissions", 200))
    seed = int(ro.get("seed", 0))
    chaos = ro.get("chaos")
    trace = generate_trace(
        n,
        seed=seed,
        rate=float(ro.get("rate", 2.0)),
        burst_prob=float(ro.get("burst_prob", 0.1)),
        burst_size=int(ro.get("burst_size", 8)),
        node_events=bool(ro.get("node_events", False)),
        chaos=dict(chaos) if chaos is not None else None,
    )
    t0 = time.perf_counter()
    solve_budget = ro.get("solve_budget")
    result = serve_trace(
        trace,
        config=ServiceConfig(
            batch_window=float(ro.get("batch_window", 0.25)),
            max_batch=int(ro.get("max_batch", 32)),
            seed=seed,
            max_retries=int(ro.get("max_retries", 3)),
            backoff_base=float(ro.get("backoff_base", 1.0)),
            backoff_cap=float(ro.get("backoff_cap", 60.0)),
            fallback=tuple(ro.get("fallback", ())),
            solve_budget=None if solve_budget is None else float(solve_budget),
        ),
        registry=registry,
        device=device,
    )
    wall = time.perf_counter() - t0
    rows = []
    for i, rec in enumerate(result.records):
        rec_json = rec.to_json()
        rows.append(
            {
                "cell": i,
                "id": rec.id,
                "tenant": rec.tenant,
                "family": rec.family,
                "technique": rec.technique,
                "technique_used": rec.technique_used or None,
                "status": rec.status,
                "arrival": rec_json["arrival"],
                "queue_delay": rec_json["queue_delay"],
                "turnaround": rec_json["turnaround"],
                "predicted_makespan": rec_json["predicted_makespan"],
                "makespan": rec_json["observed_makespan"],
                "cache_hit": rec.cache_hit,
                "batched": rec.batched,
                "retries": rec.retries,
                "rescheduled_tasks": rec.rescheduled_tasks,
                "lost_work_seconds": rec.lost_work_seconds,
                "reason": rec.reason or "",
            }
        )
    meta = {
        "campaign": campaign.name,
        "runner": "trace",
        "coords": ["family", "technique", "tenant"],
        "stats": {
            "num_submissions": n,
            "seed": seed,
            "wall_seconds": wall,
            "summary": {k: v for k, v in result.summary().items() if k != "nodes"},
        },
    }
    return ResultSet.from_rows(
        rows,
        name=campaign.name,
        meta=meta,
        dtypes={"cell": "int", "cache_hit": "bool", "batched": "bool",
                "makespan": "float", "predicted_makespan": "float",
                "arrival": "float", "queue_delay": "float",
                "turnaround": "float", "retries": "int",
                "rescheduled_tasks": "int", "lost_work_seconds": "float"},
    )


def _sync(out) -> None:
    """Wait for the device work behind a fitness call's output (the
    reference's ``block_until_ready``): a CUDA launch returns before its
    kernel ends."""
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if torch.is_tensor(t) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def _time_fitness(fn, *args, iters=3, warmup=1):
    for _ in range(warmup):
        _sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
        _sync(out)
    del out
    return (time.perf_counter() - t0) / iters * 1e6


#: device-scaling probe: shard counts tried (stripes permitting) per shape
DEVICE_SCALING_SHARDS = (1, 2, 4, 8)
#: instance-family width of the probe (a realistic batch group)
DEVICE_SCALING_INSTANCES = 8


def _device_scaling_section(rng: np.random.Generator, device) -> dict[str, Any]:
    """Striped batched-fitness throughput at 1/2/4/8 stripes (medium +
    large) through the default engine (``cuda``: the makespan kernel).

    Per shape: an 8-instance family (one bucket, distinct workflows) scored
    by ``batched_fitness`` with ``shard=None`` (the unsharded baseline) and
    with ``shard=d`` over ``d`` stripes of ``device``'s kind
    (:mod:`repro_torch.engine.shard`); each striped output is checked
    bit-identical to the baseline beside the times it justifies."""
    from repro_torch.core import Workload, build_problem, synthetic_system
    from repro_torch.core.workload_model import random_layered_workflow
    from repro_torch.engine import ENGINES
    from repro_torch.engine.shard import local_device_count

    devices = local_device_count(device)
    section: dict[str, Any] = {
        "instances": DEVICE_SCALING_INSTANCES,
        "devices_available": devices,
        "shapes": {},
    }
    engine = ENGINES.get("auto")
    for spec in ENGINE_SHAPES:
        label = str(spec["shape"])
        if label == "small":
            continue  # launch overhead dominates; scaling is meaningless there
        tasks, nodes = int(spec["size"]), int(spec["nodes"])
        pop = int(spec["population"])
        system = synthetic_system(nodes, seed=nodes)
        problems = [
            build_problem(
                system,
                Workload((random_layered_workflow(
                    tasks, seed=tasks + i, max_cores=8, feature_pool=("F1",)
                ),)),
            )
            for i in range(DEVICE_SCALING_INSTANCES)
        ]
        baseline = engine.batched_fitness(problems, device=device, shard=None)
        Tb = baseline.bucket[0]
        A = np.zeros((DEVICE_SCALING_INSTANCES, pop, Tb), np.int32)
        A[:, :, :tasks] = rng.integers(
            0, problems[0].num_nodes, (DEVICE_SCALING_INSTANCES, pop, tasks)
        )
        # the baseline's bits, to hold each striped row to (one stripe: none)
        ref = [x.cpu() for x in baseline(A)] if devices > 1 else None
        per_device: dict[str, Any] = {}
        identical = True
        for d in DEVICE_SCALING_SHARDS:
            if d > devices:
                continue
            fitness = baseline if d == 1 else engine.batched_fitness(
                problems, device=device, shard=d
            )
            us = _time_fitness(fitness, A, iters=3, warmup=1)
            if d > 1:
                out = [x.cpu() for x in fitness(A)]
                identical = identical and all(torch.equal(a, b) for a, b in zip(ref, out))
            cand = DEVICE_SCALING_INSTANCES * pop
            per_device[str(d)] = {
                "us_per_call": float(us),
                "candidates_per_second": cand / (us / 1e6),
            }
        base = per_device["1"]["candidates_per_second"]
        best_d = max(per_device, key=int)
        section["shapes"][label] = {
            "population": pop,
            "bucket": list(baseline.bucket),
            "per_device": per_device,
            "speedup_at_max_devices": per_device[best_d]["candidates_per_second"] / base,
            "bit_identical_to_single_device": bool(identical),
        }
    return section


@register_runner("engine-bench")
def run_engine_bench(
    campaign: Campaign, *, registry: SolverRegistry | None = None, device="cuda"
) -> ResultSet:
    """Time ``population_fitness`` per engine at each shape cell.

    Not a solver campaign: cells name a (shape, backend) pair and the
    "result" is throughput.  Loads follow :data:`ENGINE_BACKENDS`; a
    backend that ran a reduced population is also timed against ``torch``
    at that population (``equal_population``)."""
    from repro_torch.core import Workload, build_problem, synthetic_system
    from repro_torch.core.workload_model import random_layered_workflow
    from repro_torch.engine import ENGINES, pack, pack_cache

    cells = campaign.expand()
    coord_cols = campaign.coord_names(cells)
    rows = []
    equal_pop: list[dict[str, Any]] = []
    rng = np.random.default_rng(0)
    problems: dict[str, Any] = {}
    buckets: dict[str, tuple] = {}
    for cell in cells:
        c = cell.coords
        label, tasks, nodes = str(c["shape"]), int(c["size"]), int(c["nodes"])
        pop = int(c["population"])
        backend = str(c["backend"])
        if label not in problems:
            system = synthetic_system(nodes, seed=nodes)
            wf = random_layered_workflow(
                tasks, seed=tasks, max_cores=8, feature_pool=("F1",)
            )
            problems[label] = build_problem(system, Workload((wf,)))
            # warm the pack cache once; the device backends then share it
            buckets[label] = pack(problems[label], pad=False).bucket
        problem = problems[label]
        bucket = buckets[label]
        divisor, iters = ENGINE_BACKENDS[backend]
        p = max(pop // divisor, 2)
        A = rng.integers(0, problem.num_nodes, (p, problem.num_tasks))
        fitness = ENGINES.get(backend).population_fitness(problem, device=device)
        if backend == "oracle":
            fitness(A)  # warm caches (pred_csr etc.)
            t0 = time.perf_counter()
            fitness(A)
            us = (time.perf_counter() - t0) * 1e6
        else:
            us = _time_fitness(fitness, A, iters=iters, warmup=1)
        if backend != "torch" and p != pop:
            # equal-population comparison: this backend ran a reduced load,
            # so its cand/s is NOT comparable to the torch row's — time torch
            # at the same population for an apples-to-apples ratio
            torch_fit = ENGINES.get("torch").population_fitness(problem, device=device)
            torch_us = _time_fitness(torch_fit, A, iters=iters, warmup=1)
            equal_pop.append({
                "shape": label, "backend": backend, "population": p,
                "us_per_call": float(us), "torch_us_per_call": float(torch_us),
                "torch_speedup": float(us / torch_us),
            })
        rows.append(
            {
                "cell": cell.index,
                "shape": label,
                "size": tasks,
                "nodes": nodes,
                "backend": backend,
                "population": p,
                "requested_population": p,
                "capped": False,
                "bucket": list(bucket),
                "us_per_call": float(us),
                "candidates_per_second": p / (us / 1e6),
            }
        )
    meta = {
        "campaign": campaign.name,
        "runner": "engine-bench",
        "coords": coord_cols,
        "stats": {
            "pack_cache": pack_cache().stats.to_json(),
            "equal_population": equal_pop,
            "device_scaling": _device_scaling_section(rng, device),
        },
    }
    return ResultSet.from_rows(
        rows,
        name=campaign.name,
        meta=meta,
        dtypes={"cell": "int", "size": "int", "nodes": "int",
                "population": "int", "requested_population": "int",
                "capped": "bool", "bucket": "json",
                "us_per_call": "float", "candidates_per_second": "float"},
    )


# ---------------------------------------------------------------------------
# Legacy exporters — byte-compatible BENCH_*.json + CSV rows
# ---------------------------------------------------------------------------

#: campaign technique → legacy Table IX row label
_TABLE9_LABEL = {"milp": "milp", "ga": "mh", "heft": "h"}


def table9_rows(rs: ResultSet) -> list[tuple]:
    """Legacy ``(name, us_per_call, derived)`` rows from a smoke ResultSet."""
    rows: list[tuple] = []
    for r in rs:
        label = _TABLE9_LABEL.get(r["technique"], r["technique"])
        name = f"table9_{r['nodes']}x{r['size']}_{label}"
        if r["makespan"] is None:
            rows.append((name, float("nan"), r["status"]))
        elif r["technique"] == "milp":
            rows.append((name, r["wall_us"],
                         f"makespan={r['makespan']:.2f};status={r['solve_status']}"))
        else:
            rows.append((name, r["wall_us"], f"makespan={r['makespan']:.2f}"))
    return rows


def run_smoke(
    out_path: str | Path = "BENCH_table9.json", *, device="cuda"
) -> list[tuple]:
    """The smoke campaign → legacy rows + ``BENCH_table9.json``."""
    rs = run_campaign(smoke_campaign(), device=device)
    rows = table9_rows(rs)
    payload: dict[str, Any] = {
        name: {"us_per_call": None if us != us else float(us), "derived": derived}
        for name, us, derived in rows
    }
    payload["telemetry"] = rs.meta.get("telemetry", {})
    Path(out_path).write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return rows


def run_service_bench(
    num_submissions: int = 200,
    *,
    seed: int = 0,
    out_path: str | Path = "BENCH_service.json",
    device="cuda",
) -> list[tuple]:
    """The service trace campaign → legacy rows + ``BENCH_service.json``."""
    rs = run_campaign(service_campaign(num_submissions, seed), device=device)
    stats = rs.meta["stats"]
    s = stats["summary"]
    wall = stats["wall_seconds"]
    payload = {
        "num_submissions": num_submissions,
        "seed": seed,
        "wall_seconds": wall,
        "summary": s,
        "telemetry": rs.meta.get("telemetry", {}),
    }
    Path(out_path).write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    ta = s.get("turnaround", {})
    return [
        ("service_completed", wall * 1e6,
         f"completed={s['completed']}/{s['submissions']};rejected={s['rejected']}"),
        ("service_throughput", wall * 1e6 / max(s["completed"], 1),
         f"per_wall_s={s['throughput_per_wall_s']:.2f};"
         f"per_virtual_s={s['throughput_per_virtual_s']:.3f}"),
        ("service_turnaround", float("nan"),
         f"p50={ta.get('p50', float('nan')):.2f};"
         f"p95={ta.get('p95', float('nan')):.2f};"
         f"mean={ta.get('mean', float('nan')):.2f}"),
        ("service_cache", float("nan"),
         f"hit_rate={s['cache']['hit_rate']:.3f};hits={s['cache']['hits']};"
         f"misses={s['cache']['misses']};solver_calls={s['solver_calls']}"),
        ("service_pack_cache", float("nan"),
         f"hit_rate={s['pack_cache']['hit_rate']:.3f};"
         f"hits={s['pack_cache']['hits']};misses={s['pack_cache']['misses']}"),
        ("service_batching", float("nan"),
         f"groups={s['batched_groups']};submissions={s['batched_submissions']}"),
        ("service_events", float("nan"), f"count={s['events']}"),
    ]


def run_chaos_bench(
    num_submissions: int = 120,
    *,
    seed: int = 0,
    out_path: str | Path = "BENCH_chaos.json",
    device="cuda",
) -> list[tuple]:
    """Seeded failure storms through the fault-tolerant service →
    robustness rows + ``BENCH_chaos.json``."""
    rs = run_campaign(chaos_campaign(num_submissions, seed), device=device)
    stats = rs.meta["stats"]
    s = stats["summary"]
    wall = stats["wall_seconds"]
    rb = s["robustness"]
    qd = s.get("queue_delay", {})
    stretch = rb.get("makespan_stretch", {})
    payload = {
        "num_submissions": num_submissions,
        "seed": seed,
        "wall_seconds": wall,
        "summary": s,
        "telemetry": rs.meta.get("telemetry", {}),
    }
    Path(out_path).write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return [
        ("chaos_outcomes", wall * 1e6,
         f"completed={s['completed']}/{s['submissions']};"
         f"rejected={s['rejected']};failed={s['failed']}"),
        ("chaos_retries", float("nan"),
         f"retries={rb['retries']};preempted={rb['preempted_submissions']};"
         f"rescheduled_tasks={rb['rescheduled_tasks']}"),
        ("chaos_lost_work", float("nan"),
         f"seconds={rb['lost_work_seconds']:.3f}"),
        ("chaos_queue_delay", float("nan"),
         f"p95={qd.get('p95', float('nan')):.2f};"
         f"p99={qd.get('p99', float('nan')):.2f}"),
        ("chaos_stretch", float("nan"),
         f"mean={stretch.get('mean', float('nan')):.2f};"
         f"max={stretch.get('max', float('nan')):.2f}"),
    ]


def run_engine_bench_export(
    out_path: str | Path = "BENCH_engine.json", *, device="cuda"
) -> list[tuple]:
    """The engine campaign → legacy rows + ``BENCH_engine.json``."""
    rs = run_campaign(engine_campaign(), device=device)
    rows: list[tuple] = []
    payload: dict[str, Any] = {}
    for r in rs:
        name = f"engine_{r['shape']}_{r['backend']}"
        bucket = r["bucket"]
        derived = (
            f"bucket={'x'.join(str(b) for b in bucket)};pop={r['population']};"
            f"cand_per_s={r['candidates_per_second']:.1f}"
        )
        if r["capped"]:
            derived += f";capped_from={r['requested_population']}"
        rows.append((name, r["us_per_call"], derived))
        payload[name] = {
            "us_per_call": float(r["us_per_call"]),
            "bucket": list(bucket),
            "population": int(r["population"]),
            "requested_population": int(r["requested_population"]),
            "capped": bool(r["capped"]),
            "candidates_per_second": float(r["candidates_per_second"]),
        }
    stats = rs.meta["stats"]
    for eq in stats.get("equal_population", ()):
        rows.append(
            (f"engine_{eq['shape']}_{eq['backend']}_eqpop", eq["us_per_call"],
             f"pop={eq['population']};"
             f"torch_us={eq['torch_us_per_call']:.1f};"
             f"torch_speedup={eq['torch_speedup']:.1f}x")
        )
    scaling = stats.get("device_scaling", {})
    for label, s in scaling.get("shapes", {}).items():
        per = s["per_device"]
        best = max(per, key=int)
        rows.append(
            (f"engine_{label}_shard{best}", per[best]["us_per_call"],
             f"pop={s['population']};instances={scaling['instances']};"
             f"cand_per_s={per[best]['candidates_per_second']:.1f};"
             f"speedup_vs_1dev={s['speedup_at_max_devices']:.2f}x;"
             f"bit_identical={s['bit_identical_to_single_device']}")
        )
    payload["equal_population"] = stats.get("equal_population", [])
    payload["device_scaling"] = scaling
    payload["pack_cache"] = stats["pack_cache"]
    payload["telemetry"] = rs.meta.get("telemetry", {})
    Path(out_path).write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return rows


def run_topology_bench(
    out_path: str | Path = "BENCH_topology.json", *, device="cuda"
) -> list[tuple]:
    """The topology lane: tier scale × technique over generated continua
    plus the digital-twin calibration headline → ``BENCH_topology.json``.

    Per scale point, the twin experiment perturbs node speeds by seeded
    0.5–2.0× factors, synthesizes noisy monitor observations, calibrates
    (:func:`repro_torch.topology.calibrate`, on ``device``), and reports
    twin-vs-truth makespan error before and after.  A 1008-node generation
    timing row tracks the generator's scale budget."""
    from repro_torch.core.workload_model import Workload, random_layered_workflow
    from repro_torch.topology import PRESETS, cached_system, calibration_report, generate

    rs = run_campaign(topology_campaign(), device=device)
    rows = campaign_rows(rs)
    calibration: dict[str, Any] = {}
    for scale in TOPOLOGY_SCALES:
        preset = str(scale["topology"])
        system = cached_system(PRESETS[preset]())
        size = int(scale["size"])
        workload = Workload(
            (
                random_layered_workflow(
                    size, name=f"W{size}", seed=size, max_cores=4,
                    feature_pool=("F1",),
                ),
            )
        )
        rep = calibration_report(
            system, workload, perturb_seed=7, samples_per_node=16,
            noise=0.05, steps=200, device=device,
        )
        calibration[preset] = rep
        rows.append(
            (f"topology_{preset}_twin", float("nan"),
             f"err_before={rep['twin_error_before']:.3f};"
             f"err_after={rep['twin_error_after']:.3f};"
             f"factor_rel_mae={rep['speed_factor_rel_mae']:.4f}")
        )
    t0 = time.perf_counter()
    large = generate(PRESETS["large"]())
    gen_seconds = time.perf_counter() - t0
    rows.append(
        ("topology_generate_large", gen_seconds * 1e6,
         f"nodes={large.num_nodes}")
    )
    payload = {
        "campaign": rs.to_json(),
        "calibration": calibration,
        "generate_large": {"nodes": large.num_nodes, "seconds": gen_seconds},
        "telemetry": rs.meta.get("telemetry", {}),
    }
    Path(out_path).write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return rows


#: converging-stream service fixture: (id, family workflow, cycling json).
#: W1/W2 both run 10.02 virtual seconds per cycle on the continuum system,
#: so ``cycle_deadline=12`` always meets and ``8`` always misses — the
#: deadline-miss counter is exercised deterministically, not by luck.
_CYCLING_STREAMS = (
    ("s-meet", "mri-w1",
     {"converge": {"prob": 0.5, "min_cycles": 2, "max_cycles": 6, "seed": 3},
      "period": 5.0, "cycle_deadline": 12.0}),
    ("s-miss", "mri-w2",
     {"converge": {"prob": 0.5, "min_cycles": 2, "max_cycles": 6, "seed": 3},
      "period": 5.0, "cycle_deadline": 8.0}),
    ("s-fixed", "mri-w1", {"cycles": 3, "period": 5.0}),
)


def _converging_service_section(device="cuda") -> dict[str, Any]:
    """Converging/recurring streams through the live service, twice.

    Runs with ``jitter=0`` and no node events so observed speeds match the
    model exactly — every spawned cycle resubmits a content-identical
    workflow, and the solve cache must serve it warm (the re-solve hit
    counts below are the acceptance numbers).  The second run proves the
    whole thing replays bit-identically; the fingerprint is what the
    pinned-replay test asserts."""
    from repro_torch.core.workload_model import canonical_hash, mri_w1, mri_w2
    from repro_torch.cycling import cycle_spec_from_json
    from repro_torch.service import SchedulingService, ServiceConfig
    from repro_torch.service.traces import Submission, Trace, continuum_system

    wfs = {"mri-w1": mri_w1(), "mri-w2": mri_w2()}
    subs = tuple(
        Submission(
            id=sid, tenant="t0", time=float(i), family=fam,
            workflow=wfs[fam], technique="heft",
            cycling=cycle_spec_from_json(dict(spec)),
        )
        for i, (sid, fam, spec) in enumerate(_CYCLING_STREAMS)
    )
    trace = Trace(name="cycling", system=continuum_system(), submissions=subs)
    results = [
        SchedulingService(trace.system, ServiceConfig(seed=0), device=device).run(trace)
        for _ in range(2)
    ]
    a, b = results
    fp = [
        canonical_hash(
            {"events": r.event_log, "records": [x.to_json() for x in r.records]}
        )
        for r in results
    ]
    s = a.summary()
    return {
        "streams": a.cycling,
        "submissions_total": len(a.records),
        "completed": s["completed"],
        "deadline_misses": s["deadline_misses"],
        "solve_cache": s["cache"],
        "solver_calls": a.solver_calls,
        "replay_fingerprint": fp[0],
        "replay_bit_identical": fp[0] == fp[1],
    }


def run_cycling_bench(
    out_path: str | Path = "BENCH_cycling.json", *, device="cuda"
) -> list[tuple]:
    """The deadline-tightening sweep (satisfaction vs makespan trade-off
    across MILP/HEFT/GA) plus the converging-stream service section →
    ``BENCH_cycling.json``."""
    rs = run_campaign(cycling_campaign(), device=device)
    rows = campaign_rows(rs)
    report = rs.constraint_report(by=("technique",))
    dev = rs.deviation_vs("milp")
    for r in report:
        rows.append(
            (f"cycling_satisfaction_{r['technique']}", float("nan"),
             f"rate={r['satisfaction_rate']:.2f};"
             f"satisfied={r['satisfied_cells']}/{r['constrained_cells']};"
             f"makespan_mean={r['makespan_mean']:.2f}")
        )
    infeasible = len(dev.select(baseline_status="infeasible"))
    service = _converging_service_section(device)
    rows.append(
        ("cycling_deviation_cells", float("nan"),
         f"rows={len(dev)};infeasible_baseline={infeasible}")
    )
    rows.append(
        ("cycling_converging_service", float("nan"),
         f"spawned={service['streams']['spawned_cycles']};"
         f"converged={service['streams']['converged_streams']};"
         f"cache_hits={service['solve_cache']['hits']};"
         f"deadline_misses={service['deadline_misses']};"
         f"replay_ok={service['replay_bit_identical']}")
    )
    payload = {
        "campaign": rs.to_json(),
        "constraint_report": report.to_json(),
        "deviation_vs_milp": dev.to_json(),
        "converging_service": service,
        "telemetry": rs.meta.get("telemetry", {}),
    }
    Path(out_path).write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return rows


# ---------------------------------------------------------------------------
# Generic campaign export (NAME|spec.json → BENCH_campaign.json)
# ---------------------------------------------------------------------------


def campaign_rows(rs: ResultSet) -> list[tuple]:
    """Generic ``(name, us_per_call, derived)`` rows for any solver-campaign
    ResultSet — the CI-printable view of the columnar results."""
    rows: list[tuple] = []
    for r in rs:
        tech = r.get("technique", r.get("technique_used", ""))
        name = f"campaign_{rs.name}_c{r['cell']:04d}_{tech}"
        if r.get("makespan") is None:
            # prefer the solver's own verdict ("failed(2)" = infeasible)
            # over the runner's "ok" when the cell produced no makespan
            rows.append(
                (name, float("nan"), r.get("solve_status") or r.get("status", ""))
            )
            continue
        bits = [f"makespan={r['makespan']:.2f}"]
        if r.get("status") not in (None, "ok", "completed"):
            bits.append(f"status={r['status']}")
        if r.get("dedup"):
            bits.append("dedup")
        if r.get("batched"):
            bits.append("batched")
        rows.append((name, r.get("wall_us") or 0.0, ";".join(bits)))
    return rows


@dataclasses.dataclass
class CampaignRun:
    """One executed campaign: the spec, the columnar results, legacy rows."""

    campaign: Campaign
    result: ResultSet
    rows: list[tuple]
    wall_seconds: float


def resolve_campaign(name_or_path: str) -> Campaign:
    """One resolution rule for every CLI: an existing *file* loads as a
    spec, otherwise the name must be a built-in campaign (a stray directory
    named like a built-in must not shadow it)."""
    from repro_torch.campaigns.spec import load_campaign

    if Path(name_or_path).is_file():
        return load_campaign(name_or_path)
    if name_or_path in BUILTIN_CAMPAIGNS:
        return builtin_campaign(name_or_path)
    raise ValueError(
        f"{name_or_path!r} is neither a campaign spec file nor a "
        f"built-in campaign{did_you_mean(name_or_path, BUILTIN_CAMPAIGNS)}; "
        f"built-ins: {sorted(BUILTIN_CAMPAIGNS)}"
    )


def run_named_campaign(
    name_or_path: str,
    *,
    runner: str | None = None,
    registry: SolverRegistry | None = None,
    out_path: str | Path | None = "BENCH_campaign.json",
    vs: str | None = "milp",
    device="cuda",
) -> CampaignRun:
    """Resolve (file path or built-in name), run, and export one campaign.

    Writes ``BENCH_campaign.json`` holding the full columnar ResultSet plus
    an optimality-gap report when an exact baseline technique is present."""
    campaign = resolve_campaign(name_or_path)
    t0 = time.perf_counter()
    rs = run_campaign(campaign, runner=runner, registry=registry, device=device)
    wall = time.perf_counter() - t0
    rows = campaign_rows(rs)
    if out_path is not None:
        payload: dict[str, Any] = {
            "campaign": campaign.name,
            "wall_seconds": wall,
            "results": rs.to_json(),
            "telemetry": rs.meta.get("telemetry", {}),
        }
        if vs and rs.baseline_present(vs):
            payload["deviation_vs"] = rs.deviation_report(vs).to_json()
        Path(out_path).write_text(
            json.dumps(payload, indent=2, sort_keys=True) + "\n"
        )
    return CampaignRun(campaign=campaign, result=rs, rows=rows, wall_seconds=wall)
