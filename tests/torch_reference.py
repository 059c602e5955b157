"""Reference outputs for the port's parity tests, computed by the JAX
package in a child Python process.

The reference package does not import on Python >= 3.11 as it stands:
``repro/core/api.py`` uses the unhashable dataclass ``ObjectiveWeights`` as a
field default.  The child works around it without editing a reference file
(:func:`_load_reference`): it stubs ``repro.core``, imports the evaluator,
gives ``ObjectiveWeights`` a ``__hash__``, drops the stub and imports
``repro.core`` for real.  That patch must never reach a pytest worker, where
it would make other reference suites pass or fail by collection order, so it
runs only here, in a process of its own.

Parent side: :func:`run` writes the job's parameters, starts
``python tests/torch_reference.py <job> <params.json> <inputs.npz> <out.npz>``
and returns the child's arrays.  Problems cross the process boundary as
specs (:func:`build`), which both packages build with their own model layer;
inputs such as assignments are made in the parent from numpy seeds.

Child side: the ``JOBS`` below, each ``(params, inputs) -> {name: array}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"


# -----------------------------------------------------------------------------
# problem specs, built with either package's model layer
# -----------------------------------------------------------------------------


def build(spec: dict, sm, wm):
    """A ``ScheduleProblem`` from a spec, using the system-model module
    ``sm`` and the workload-model module ``wm`` of either package."""
    return wm.build_problem(system_of(spec, sm), workload_of(spec, wm), constraints_of(spec, wm))


def system_of(spec: dict, sm):
    if spec["kind"] == "mri":
        return sm.mri_system()
    system = sm.synthetic_system(spec["nodes"], seed=spec["seed"])
    if spec["kind"] == "deadlink":  # a dead link (+inf rate) between nodes 0 and 1
        dtr = system.dtr.copy()
        dtr[0, 1] = dtr[1, 0] = np.inf
        system = sm.make_system(system.nodes, dtr)
    return system


def workload_of(spec: dict, wm):
    kind = spec["kind"]
    if kind == "mri":
        return wm.mri_workload()
    if kind in ("layered", "deadlink"):
        return wm.Workload((wm.random_layered_workflow(spec["tasks"], seed=spec["seed"], max_cores=8),))
    if kind == "synthetic":
        return wm.synthetic_workload(spec["tasks"], seed=spec["seed"])
    if kind == "constrained":
        return wm.synthetic_workload(spec["tasks"], seed=spec["seed"], num_workflows=2)
    raise ValueError(f"unknown problem kind {kind!r}")


def constraints_of(spec: dict, wm):
    """The constraints of a ``constrained`` spec (None for other kinds)."""
    if spec["kind"] != "constrained":
        return None
    return wm.Constraints(
        deadline={"W0": spec["deadline"]},
        budget={"W1": spec["budget"]},
        cost_rate={"n0": 2.0, "n1": 0.5},
        placement={"W1": ("F1",)},
    )


def scenario_of(spec: dict, api, sm, wm):
    """A ``Scenario`` from a scenario spec (``{"name", "problem", ...}``),
    using either package's ``core.api`` and model modules."""
    prob = spec["problem"]
    kw = {}
    if "weights" in spec:
        kw["weights"] = api.ObjectiveWeights(**spec["weights"])
    if "perturbation" in spec:
        kw["perturbation"] = api.Perturbation(**spec["perturbation"])
    if "orchestration" in spec:
        kw["orchestration"] = api.OrchestrationConfig(**spec["orchestration"])
    if "policy" in spec:
        kw["policy"] = api.Policy.chain(*spec["policy"])
    return api.Scenario(
        name=spec["name"],
        system=system_of(prob, sm),
        workload=workload_of(prob, wm),
        technique=spec.get("technique", "auto"),
        backend=spec.get("backend", "simulate"),
        engine=spec.get("engine", "auto"),
        solver_options=spec.get("solver_options", {}),
        constraints=constraints_of(prob, wm),
        **kw,
    )


FIG6_SNAKEFILE = """
rule T1: # dependencies
 input:
 experiment.conf
 output:
 product1.dat
 resources:
 mem_mb = [1024] # memory_required, (R2)
 features = ["F1", "F2"] # requested features
 data = 2GiB # estimated output size, (R3)
 duration = [1000] # usage, in seconds
 run:
 # Execute shell command/script

rule T2:
 input:
 product1.dat
 output:
 product2.dat
 resources:
 features = ["F1"]
 runtime = 0:01:30
"""


def standin_registry(api, heuristics):
    """A copy of ``api.REGISTRY`` (either package's) whose ``ga`` entry is a
    deterministic stand-in: HEFT, and HEFT mapped over a batched group.  The
    GA's draws differ between the packages (``torch.Generator`` against
    JAX's PRNG), so service runs that must match the reference event for
    event solve their GA submissions with this; batching, coalescing, the
    caches and preemption run as with the real GA."""
    reg = api.SolverRegistry()
    for e in api.REGISTRY:
        if e.name == "ga":
            continue
        caps = e.capabilities
        reg.register(e.name, e.fn, batch_fn=e.batch_fn, exact=caps.exact, max_tasks=caps.max_tasks,
                     needs_time_limit=caps.needs_time_limit, engine_aware=caps.engine_aware,
                     constraint_aware=caps.constraint_aware)

    def heft_ga(problem, weights=api.ObjectiveWeights(), **kw):
        return api.SolveReport(schedule=heuristics.heft(problem, weights), problem=problem)

    def heft_batch(problems, weights=api.ObjectiveWeights(), **kw):
        return [heft_ga(p, weights, **kw) for p in problems]

    reg.register("ga", heft_ga, batch_fn=heft_batch, constraint_aware=True)
    return reg


#: the summary fields a replay may change (SKILL.md §4): wall time, and the
#: process-global pack LRU's delta
WALL_FIELDS = ("wall_seconds", "throughput_per_wall_s", "pack_cache")


def service_outputs(result, metrics: dict) -> dict[str, str]:
    """A served trace's deterministic outputs as JSON texts: the event log,
    the records, the makespans, the summary without :data:`WALL_FIELDS` and
    the counters and histograms of a metrics snapshot taken after the run
    (the registry reset before it)."""
    summary = {k: v for k, v in result.summary().items() if k not in WALL_FIELDS}
    return {
        "events": json.dumps(result.event_log, sort_keys=True),
        "records": json.dumps([r.to_json() for r in result.records], sort_keys=True),
        "makespans": json.dumps(result.makespans(), sort_keys=True),
        "summary": json.dumps(summary, sort_keys=True),
        "metrics": json.dumps({k: metrics[k] for k in ("counters", "histograms")}, sort_keys=True),
    }


#: the columns of a campaign row that a replay may change: wall time
CAMPAIGN_WALL_COLUMNS = ("wall_us", "solve_time_s")


def campaign_outputs(rs) -> dict[str, str]:
    """A campaign ResultSet's deterministic outputs as JSON texts: its
    columns, its rows without :data:`CAMPAIGN_WALL_COLUMNS`, its meta
    (telemetry aside) with the stats' wall time and pack-cache delta
    dropped, and the gap report against MILP where the grid has MILP."""
    stats = dict(rs.meta.get("stats", {}))
    for k in ("wall_seconds", "pack_cache"):
        stats.pop(k, None)
    if "summary" in stats:
        stats["summary"] = {k: v for k, v in stats["summary"].items() if k not in WALL_FIELDS}
    meta = {k: v for k, v in rs.meta.items() if k not in ("stats", "telemetry")}
    rows = [{k: v for k, v in r.items() if k not in CAMPAIGN_WALL_COLUMNS} for r in rs]
    out = {
        "columns": json.dumps([c.to_json() for c in rs.columns]),
        "rows": json.dumps(rows, sort_keys=True),
        "stats": json.dumps(stats, sort_keys=True),
        "meta": json.dumps(meta, sort_keys=True),
    }
    if rs.baseline_present("milp"):
        out["report"] = rs.deviation_report("milp").to_csv()
    return out


def scripted_spans(obs) -> str:
    """Drive either package's tracer through a fixed script (nested spans,
    ``timed``, ``traced``, ``set``, a span left by an exception, a virtual
    clock) and return the recorded spans' deterministic fields as JSON."""
    clock = iter(float(i) for i in range(100))
    tr = obs.TRACER
    tr.enable()

    @obs.traced("deco.fn", cat="deco")
    def fn(x):
        return x + 1

    try:
        with tr.span("outer", cat="a", args={"k": 1}) as sp:
            sp.set(extra="x")
            with tr.timed("timed.inner", cat="b") as t:
                fn(1)
            assert t.wall_us >= 0.0
            try:
                with tr.span("failing", cat="c"):
                    raise ValueError("boom")
            except ValueError:
                pass
        prev = tr.set_virtual_clock(lambda: next(clock))
        with tr.span("virtual", cat="v"):
            with tr.timed("virtual.timed", cat="v"):
                pass
        tr.set_virtual_clock(prev)
        spans = [[s.id, s.parent, s.name, s.cat, s.vt0, s.vdur, sorted(s.args.items())] for s in tr.spans]
        return json.dumps([spans, obs.virtual_fingerprint()])
    finally:
        tr.disable()


def fitness_table(metrics, calls) -> str:
    """The :class:`FitnessAccounting` table (``to_json``) of a fixed call
    sequence, through either package's ``obs.metrics`` module, on a fake
    clock: each call is ``[backend, bucket, mode, dt_us, grows]``; ``grows``
    None means no cache probe, else whether the probed cache grows during
    the call."""
    import types

    acct = metrics.FitnessAccounting()
    now = [0.0]
    real_time = metrics.time
    metrics.time = types.SimpleNamespace(perf_counter=lambda: now[0])
    try:
        for backend, bucket, mode, dt, grows in calls:
            size = [0]
            probe = None if grows is None else (lambda: size[0])
            with acct.measure(backend, bucket, mode, cache_size=probe):
                now[0] += dt * 1e-6
                if grows:
                    size[0] += 1
    finally:
        metrics.time = real_time
    return json.dumps(acct.to_json(), sort_keys=True)


def export_outputs(obs, spans: list[dict], block: dict, bad: list[str], tmp: Path) -> dict[str, str]:
    """Either package's exporters on the same spans, metrics block and
    malformed trace files: the texts they write, the summary of the written
    trace and the error each bad file gives."""
    from dataclasses import fields

    names = {f.name for f in fields(obs.Span)}
    sp = [obs.Span(**{k: v for k, v in d.items() if k in names}) for d in spans]
    out = {"events": json.dumps(obs.trace_events(sp))}
    trace = obs.write_trace(tmp / "trace.json", sp)
    out["trace"] = trace.read_text()
    out["flat"] = json.dumps(obs.flatten(block))
    out["metrics"] = obs.write_metrics(tmp / "metrics.json", block).read_text()
    out["summary"] = json.dumps(obs.summarize_trace(trace))
    for i, text in enumerate(bad):
        path = tmp / f"bad{i}.json"
        path.write_text(text)
        try:
            obs.summarize_trace(path)
            out[f"bad/{i}"] = ""
        except ValueError as e:
            out[f"bad/{i}"] = f"{type(e).__name__}: {e}"
    return out


def cell_keys(campaigns, wm, campaign) -> str:
    """Each cell's index, label and skip reason and, for a live cell of an
    inline campaign, its ``solve_identity`` key, as JSON, through either
    package's ``campaigns`` and workload-model modules."""
    keys = []
    for cell in campaign.expand():
        key = None
        if cell.skipped is None and campaign.runner == "inline":
            sc = campaigns.cell_scenario(campaign, cell)
            workload, constraints = sc.expanded()
            key = campaigns.solve_identity(wm.build_problem(sc.system, workload, constraints), sc)
        keys.append([cell.index, cell.label(), cell.skipped, key])
    return json.dumps(keys)


def name_of(spec: dict) -> str:
    return "-".join(str(spec[k]) for k in sorted(spec))


# -----------------------------------------------------------------------------
# parent side
# -----------------------------------------------------------------------------


def run(job: str, params: dict, inputs: dict[str, np.ndarray] | None = None,
        timeout: float = 300.0, devices: int = 1) -> dict[str, np.ndarray]:
    """Run ``job`` in a child process on the reference package and return
    its arrays.  Raises with the child's output if it fails.  ``devices``
    is the number of virtual CPU devices the child's JAX sees (the
    reference's instance mesh)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    # ``devices`` CPU devices, whatever an earlier test in this worker left
    # in os.environ (importing repro.launch.dryrun sets 512 devices)
    env["JAX_PLATFORMS"] = "cpu"
    # and one thread: a test run may start several pytest workers side by
    # side, and oversubscribed thread pools slow every process
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={int(devices)} "
        "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    )
    env.pop("REPRO_SHARD_DEVICES", None)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "params.json").write_text(json.dumps(params))
        np.savez(tmp / "inputs.npz", **(inputs or {}))
        proc = subprocess.run(
            [sys.executable, __file__, job, str(tmp / "params.json"),
             str(tmp / "inputs.npz"), str(tmp / "out.npz")],
            env=env, capture_output=True, text=True, timeout=timeout,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"reference job {job!r} failed:\n{proc.stdout}\n{proc.stderr}")
        with np.load(tmp / "out.npz") as out:
            return {k: out[k] for k in out.files}


# -----------------------------------------------------------------------------
# child side
# -----------------------------------------------------------------------------


def _load_reference():
    """Import the reference package with the ``ObjectiveWeights`` hash patch."""
    import dataclasses
    import types

    stub = types.ModuleType("repro.core")
    stub.__path__ = [str(SRC / "repro" / "core")]
    sys.modules["repro.core"] = stub
    from repro.core import evaluator

    evaluator.ObjectiveWeights.__hash__ = lambda self: hash(dataclasses.astuple(self))
    del sys.modules["repro.core"]
    import repro.core  # noqa: F401
    import repro.engine  # noqa: F401


def _modules():
    from repro.core import system_model as sm
    from repro.core import workload_model as wm

    return sm, wm


def _schedule_arrays(out: dict, prefix: str, s) -> None:
    out[f"{prefix}/start"] = np.asarray(s.start)
    out[f"{prefix}/finish"] = np.asarray(s.finish)
    out[f"{prefix}/stats"] = np.array(
        [s.makespan, s.usage, s.objective, s.violations], dtype=np.float64
    )


def job_model(params: dict, inputs: dict) -> dict:
    """Packed arrays, fingerprints, JSON, oracle schedules, ready times and
    validity messages of each spec's problem."""
    from repro.core.evaluator import ObjectiveWeights, evaluate_assignment
    from repro.core.validate import verify_schedule
    from repro.engine.packed import pack
    from repro.engine.sim import ready_times_all, run_schedule

    sm, wm = _modules()
    out: dict[str, np.ndarray] = {}
    for spec in params["specs"]:
        name = name_of(spec)
        prob = build(spec, sm, wm)
        out[f"{name}/fingerprint"] = np.array(wm.problem_fingerprint(prob))
        out[f"{name}/system_json"] = np.array(json.dumps(sm.system_to_json(system_of(spec, sm))))
        out[f"{name}/workload_json"] = np.array(json.dumps(wm.workload_to_json(workload_of(spec, wm))))
        for pad in (False, True):
            packed = pack(prob, pad=pad, use_cache=False)
            tag = f"{name}/pad{int(pad)}"
            for k, v in packed.numpy_arrays().items():
                out[f"{tag}/{k}"] = v
            out[f"{tag}/meta"] = np.array(
                [*packed.bucket, packed.num_tasks, packed.num_nodes, packed.cmax,
                 int(packed.constrained)], dtype=np.int64,
            )
        A = inputs[f"{name}/assignments"]
        for k, a in enumerate(A):
            for dtype in ("float64", "float32"):
                for mode in ("fixed", "weighted"):
                    s = evaluate_assignment(
                        prob, a, ObjectiveWeights(usage_mode=mode), dtype=np.dtype(dtype).type
                    )
                    _schedule_arrays(out, f"{name}/{k}/{dtype}/{mode}", s)
            _, finish, _ = run_schedule(prob, a)
            out[f"{name}/{k}/ready"] = np.stack(
                [ready_times_all(prob, j, a, finish) for j in range(prob.num_tasks)]
            )
            out[f"{name}/{k}/verify"] = np.array(
                json.dumps(verify_schedule(prob, evaluate_assignment(prob, a)))
            )
    return out


def job_engine(params: dict, inputs: dict) -> dict:
    """The ``jax`` and ``oracle`` engines' objective and makespan per spec
    and usage mode, and the batched ``jax`` fitness over the whole family."""
    from repro.core.evaluator import ObjectiveWeights
    from repro.engine.backends import batched_population_fitness_fn, population_fitness_fn

    sm, wm = _modules()
    out: dict[str, np.ndarray] = {}
    problems = []
    for spec in params["specs"]:
        name = name_of(spec)
        prob = build(spec, sm, wm)
        problems.append(prob)
        A = inputs[f"{name}/assignments"]
        for mode in ("fixed", "weighted"):
            w = ObjectiveWeights(alpha=params["alpha"], beta=params["beta"], usage_mode=mode)
            for engine in ("jax", "oracle"):
                obj, mk = population_fitness_fn(prob, w, engine=engine)(A)
                out[f"{name}/{engine}/{mode}/obj"] = np.asarray(obj)
                out[f"{name}/{engine}/{mode}/mk"] = np.asarray(mk)
    fitness = batched_population_fitness_fn(problems, ObjectiveWeights(), engine="jax")
    obj, mk = fitness(inputs["batch/assignments"])
    out["batch/obj"], out["batch/mk"] = np.asarray(obj), np.asarray(mk)
    out["batch/bucket"] = np.asarray(fitness.bucket)
    return out


def _ga_draws(key, logits, pop, generations, tournament, rate) -> dict:
    """The draws the reference ``_ga_loop`` makes from ``key``, with the
    same key splits."""
    import jax

    key, k0 = jax.random.split(key)
    T = logits.shape[0]
    draws = {"initial": jax.random.categorical(k0, logits, axis=-1, shape=(pop, T))}
    seq: dict[str, list] = {"cand": [], "xmask": [], "mmask": [], "fresh": []}
    for _ in range(generations):
        key, kt, kc, km, kn = jax.random.split(key, 5)
        seq["cand"].append(jax.random.randint(kt, (2, pop, tournament), 0, pop))
        seq["xmask"].append(jax.random.bernoulli(kc, 0.5, (pop, T)))
        seq["mmask"].append(jax.random.bernoulli(km, rate, (pop, T)))
        seq["fresh"].append(jax.random.categorical(kn, logits, axis=-1, shape=(pop, T)))
    draws.update({k: np.stack([np.asarray(x) for x in v]) for k, v in seq.items()})
    return {k: np.asarray(v) for k, v in draws.items()}


def job_ga(params: dict, inputs: dict) -> dict:
    """Reference ``ga`` on each spec and ``ga_sweep`` over the family, with
    the exact draws each made."""
    import jax
    import jax.numpy as jnp

    from repro.core.metaheuristics import _mask_logits, _safe_feasible, ga, ga_sweep
    from repro.engine.packed import common_bucket

    sm, wm = _modules()
    pop, gens, k, rate = params["pop_size"], params["generations"], params["tournament"], params["mutation_rate"]
    opts = dict(pop_size=pop, generations=gens, tournament=k, mutation_rate=rate, elite=params["elite"])
    out: dict[str, np.ndarray] = {}
    problems = [build(spec, sm, wm) for spec in params["specs"]]
    for spec, prob in zip(params["specs"], problems):
        name = name_of(spec)
        res = ga(prob, seed=spec["ga_seed"], backend="jax", **opts)
        out[f"{name}/best"] = np.asarray(res.schedule.assignment)
        out[f"{name}/history"] = np.asarray(res.history)
        out[f"{name}/makespan"] = np.array(res.schedule.makespan)
        draws = _ga_draws(jax.random.PRNGKey(spec["ga_seed"]), _mask_logits(prob), pop, gens, k, rate)
        for key, v in draws.items():
            out[f"{name}/draws/{key}"] = v

    seed = params["sweep_seed"]
    results = ga_sweep(problems, seed=seed, shard=None, **opts)
    Tb, Nb = common_bucket(problems)[:2]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(problems))
    for b, (prob, res) in enumerate(zip(problems, results)):
        out[f"sweep/{b}/best"] = np.asarray(res.schedule.assignment)
        out[f"sweep/{b}/history"] = np.asarray(res.history)
        logits = np.full((Tb, Nb), -1e30, dtype=np.float32)
        logits[: prob.num_tasks, : prob.num_nodes][_safe_feasible(prob)] = 0.0
        logits[prob.num_tasks :, 0] = 0.0
        draws = _ga_draws(keys[b], jnp.asarray(logits), pop, gens, k, rate)
        for key, v in draws.items():
            out[f"sweep/{b}/draws/{key}"] = v
    return out


def job_pallas(params: dict, inputs: dict) -> dict:
    """The reference Pallas makespan kernel in interpret mode on each case's
    arrays (``<case>/<array>``, ``<case>/assignments``, optional
    ``<case>/deadline``).

    JAX 0.9 removed ``pallas.load``, which the kernel still calls; here it
    gets the plain ref indexing it stood for."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    if not hasattr(pl, "load"):
        pl.load = lambda ref, idx: ref[idx]
    from repro.kernels.makespan import population_makespan_pallas

    keys = ("durations", "cores", "data", "feasible", "release", "pred_matrix", "dtr", "init_free")
    out: dict[str, np.ndarray] = {}
    for case in params["cases"]:
        dl = inputs.get(f"{case}/deadline")
        mk, viol = population_makespan_pallas(
            jnp.asarray(inputs[f"{case}/assignments"]),
            *(jnp.asarray(inputs[f"{case}/{k}"]) for k in keys),
            None if dl is None else jnp.asarray(dl),
            tile=params["tile"],
            interpret=True,
        )
        out[f"{case}/makespan"], out[f"{case}/violations"] = np.asarray(mk), np.asarray(viol)
    return out


def _pso_draws(key, pop, T, N, iterations) -> dict:
    """The draws the reference ``pso`` makes from ``key``."""
    import jax

    key, k0, _k1 = jax.random.split(key, 3)
    r1, r2 = [], []
    for _ in range(iterations):
        key, kr1, kr2 = jax.random.split(key, 3)
        r1.append(np.asarray(jax.random.uniform(kr1, (pop, T, N))))
        r2.append(np.asarray(jax.random.uniform(kr2, (pop, T, N))))
    return {
        "initial": np.asarray(jax.random.normal(k0, (pop, T, N))),
        "r1": np.stack(r1),
        "r2": np.stack(r2),
    }


def _sa_draws(key, logits, chains, steps) -> dict:
    """The draws the reference ``sa`` makes from ``key``."""
    import jax

    T = logits.shape[0]
    key, k0 = jax.random.split(key)
    seq: dict[str, list] = {"tsel": [], "newnode": [], "uniform": []}
    for _ in range(steps):
        key, kt, kn, ka = jax.random.split(key, 4)
        tsel = jax.random.randint(kt, (chains,), 0, T)
        seq["tsel"].append(np.asarray(tsel))
        seq["newnode"].append(np.asarray(jax.random.categorical(kn, logits[tsel], axis=-1)))
        seq["uniform"].append(np.asarray(jax.random.uniform(ka, (chains,))))
    out = {k: np.stack(v) for k, v in seq.items()}
    out["initial"] = np.asarray(jax.random.categorical(k0, logits, axis=-1, shape=(chains, T)))
    return out


def _aco_draws(key, ants, T, N, iterations) -> dict:
    """The Gumbel noise behind the reference ``aco``'s per-iteration
    ``categorical`` (``argmax(gumbel(key, (ants, T, N)) + logits)``)."""
    import jax
    import jax.numpy as jnp

    noise = []
    for _ in range(iterations):
        key, ks = jax.random.split(key)
        noise.append(np.asarray(jax.random.gumbel(ks, (ants, T, N), jnp.float32)))
    return {"gumbel": np.stack(noise)}


def job_mh(params: dict, inputs: dict) -> dict:
    """Reference ``pso``, ``sa`` and ``aco`` (those in ``techniques``) on
    each spec with the exact draws each made, and, where the inputs hold
    them, XLA's ``log``/``exp``/``pow`` of the given values."""
    import jax
    import jax.numpy as jnp

    from repro.core.evaluator import ObjectiveWeights
    from repro.core.metaheuristics import _mask_logits, aco, pso, sa

    sm, wm = _modules()
    opts = params["opts"]
    out: dict[str, np.ndarray] = {}
    for spec in params["specs"]:
        name = name_of(spec)
        prob = build(spec, sm, wm)
        T, N = prob.num_tasks, prob.num_nodes
        w = ObjectiveWeights(usage_mode=spec.get("usage_mode", "fixed"))
        seed = spec["mh_seed"]
        key = jax.random.PRNGKey(seed)
        runs = {
            "pso": (pso, lambda: _pso_draws(key, opts["pso"]["pop_size"], T, N, opts["pso"]["iterations"])),
            "sa": (sa, lambda: _sa_draws(key, _mask_logits(prob), opts["sa"]["chains"], opts["sa"]["steps"])),
            "aco": (aco, lambda: _aco_draws(key, opts["aco"]["ants"], T, N, opts["aco"]["iterations"])),
        }
        for tech in params["techniques"]:
            fn, draws = runs[tech][0], runs[tech][1]()
            res = fn(prob, w, seed=seed, backend="jax", **opts[tech])
            out[f"{name}/{tech}/best"] = np.asarray(res.schedule.assignment)
            out[f"{name}/{tech}/history"] = np.asarray(res.history)
            out[f"{name}/{tech}/makespan"] = np.array(res.schedule.makespan)
            for k, v in draws.items():
                out[f"{name}/{tech}/draws/{k}"] = v
    if "log_x" in inputs:
        out["log"] = np.asarray(jax.jit(jnp.log)(inputs["log_x"]))
        out["exp"] = np.asarray(jax.jit(jnp.exp)(inputs["exp_x"]))
        its = jnp.arange(params["pow_steps"])
        for c in params["coolings"]:
            out[f"pow/{c}"] = np.asarray(jax.jit(lambda i, c=c: c**i)(its))
    return out


def job_heuristics(params: dict, inputs: dict) -> dict:
    """Reference ``heft`` and ``olb`` schedules and HEFT's upward ranks."""
    from repro.core.heuristics import heft, olb, upward_ranks

    sm, wm = _modules()
    out: dict[str, np.ndarray] = {}
    for spec in params["specs"]:
        name = name_of(spec)
        prob = build(spec, sm, wm)
        out[f"{name}/ranks"] = upward_ranks(prob)
        for fn in (heft, olb):
            s = fn(prob)
            out[f"{name}/{fn.__name__}/assignment"] = np.asarray(s.assignment)
            _schedule_arrays(out, f"{name}/{fn.__name__}", s)
    return out


def job_milp(params: dict, inputs: dict) -> dict:
    """Reference ``solve_milp`` in each capacity mode."""
    from repro.core.milp import solve_milp

    sm, wm = _modules()
    out: dict[str, np.ndarray] = {}
    for spec in params["specs"]:
        name = name_of(spec)
        prob = build(spec, sm, wm)
        for mode in params["modes"]:
            s = solve_milp(prob, capacity_mode=mode)
            out[f"{name}/{mode}/assignment"] = np.asarray(s.assignment)
            out[f"{name}/{mode}/status"] = np.array(s.status)
            _schedule_arrays(out, f"{name}/{mode}", s)
    return out


def _error_of(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the message is what is compared
        return f"{type(e).__name__}: {e}"
    return ""


def job_scenario(params: dict, inputs: dict) -> dict:
    """The scenario API of the reference: each scenario's JSON text and
    fingerprint, the re-serialised text of each port-written file, the
    errors of malformed files, each run's summary and rendered artifacts,
    policy routing by size, a replay under jitter, the Fig. 6 parse, the
    model-layer pieces, the fitness functions, ``kth_smallest`` on rows with
    ties, and a traced fallback chain."""
    import tempfile

    from repro.core import api
    from repro.core.heuristics import heft
    from repro.core.simulator import execute
    from repro.core.snakemake_io import parse_rules

    sm, wm = _modules()
    out: dict[str, np.ndarray] = {}
    for spec in params["scenarios"]:
        name = spec["name"]
        sc = scenario_of(spec, api, sm, wm)
        out[f"{name}/json"] = np.array(json.dumps(sc.to_json(), indent=2))
        out[f"{name}/fingerprint"] = np.array(sc.fingerprint())
        port_text = str(inputs[f"{name}/port_json"])
        again = api.scenario_from_json(port_text)
        out[f"{name}/reparsed"] = np.array(json.dumps(again.to_json(), indent=2))
        if spec.get("run"):
            with tempfile.TemporaryDirectory() as tmp:
                result = api.Orchestrator(sc, out_dir=tmp).run()
                summary = result.summary()
                arts = summary.pop("artifacts", [])
                out[f"{name}/summary"] = np.array(json.dumps(summary, sort_keys=True))
                out[f"{name}/artifacts"] = np.array(json.dumps(
                    {Path(p).name: Path(p).read_text() for p in arts}, sort_keys=True
                ))
    for i, text in enumerate(params["bad"]):
        out[f"bad/{i}"] = np.array(_error_of(lambda: api.scenario_from_json(text)))
    for spec in params["route"]:
        name = name_of(spec)
        rep = api.route_problem(build(spec, sm, wm), technique="auto", options=params["route_options"])
        out[f"route/{name}/technique"] = np.array(rep.schedule.technique)
        out[f"route/{name}/fallbacks"] = np.array(json.dumps(list(rep.fallbacks)))
        out[f"route/{name}/makespan"] = np.array(rep.schedule.makespan)
    prob = build({"kind": "mri"}, sm, wm)
    xrep = execute(prob, heft(prob), speed_factors=np.array([1.0, 0.5, 1.3]), jitter=0.1, seed=3)
    out["execute/start"] = np.array([log.start for log in xrep.logs])
    out["execute/finish"] = np.array([log.finish for log in xrep.logs])
    out["execute/factors"] = np.array(json.dumps(xrep.observed_speed_factors(prob), sort_keys=True))
    out["fig6"] = np.array(json.dumps(wm.workload_to_json(wm.Workload((parse_rules(FIG6_SNAKEFILE),)))))
    # the model-layer pieces the scenario path needs
    tc1 = wm.testcase1_workloads()
    out["testcase1"] = np.array(json.dumps(wm.workload_to_json(wm.Workload(tuple(tc1.values())))))
    out["testcase1/names"] = np.array(json.dumps(list(tc1)))
    cons = constraints_of(params["constrained"], wm)
    out["constraints"] = np.array(json.dumps(cons.to_json()))
    out["constraints/reparsed"] = np.array(json.dumps(wm.constraints_from_json(cons.to_json()).to_json()))
    system = system_of(params["constrained"], sm)
    out["features"] = system.feature_matrix(["F1", "F2", "F3", "F9"])
    out["memory"] = system.memory()
    out["index"] = np.array(system.index(system.nodes[-1].name))
    out["schedule_json"] = np.array(json.dumps(heft(prob).to_json(prob, [n.name for n in sm.mri_system().nodes])))
    from repro.core.evaluator import evaluate_population_batch

    fam = [build(spec, sm, wm) for spec in params["family"]]
    for b, (o, m) in enumerate(evaluate_population_batch(fam, [inputs[f"family/{b}"] for b in range(len(fam))])):
        out[f"family/{b}/obj"], out[f"family/{b}/mk"] = o, m
    from repro.core.evaluator import ObjectiveWeights, fitness_from_arrays, make_fitness_fn
    from repro.engine.packed import pack
    from repro.kernels.select import kth_smallest

    out["kth"] = np.asarray(kth_smallest(inputs["kth/rows"], inputs["kth/c"]))
    for i, w in enumerate(params["weights"]):
        weights = ObjectiveWeights(**w)
        for b, prob in enumerate(fam):
            pop = inputs[f"family/{b}"]
            o, m = make_fitness_fn(prob, weights)(pop)
            out[f"fitness/{i}/{b}/obj"], out[f"fitness/{i}/{b}/mk"] = np.asarray(o), np.asarray(m)
            o, m = fitness_from_arrays(pop, pack(prob, pad=False).device_arrays(), weights.alpha,
                                       weights.beta, weights.usage_mode)
            out[f"arrays/{i}/{b}/obj"], out[f"arrays/{i}/{b}/mk"] = np.asarray(o), np.asarray(m)
    # a fallback chain past a failing step, traced
    from repro import obs

    obs.TRACER.enable()
    try:
        rep = api.solve_with_fallback(build(params["fallback"], sm, wm), technique="milp", chain=("heft",))
    finally:
        obs.TRACER.disable()
    out["fallback/trail"] = np.array(json.dumps(list(rep.fallbacks)))
    out["fallback/spans"] = np.array(json.dumps(
        [[s.id, s.parent, s.name, s.cat, sorted(s.args.items())] for s in obs.TRACER.spans]
    ))
    return out


def job_service(params: dict, inputs: dict) -> dict:
    """The reference service: each generated trace's JSON text and that text
    parsed and written again, and each serve's outputs (:func:`service_outputs`) on a generated trace or on a
    trace file the parent wrote, with the real registry or the stand-in
    (:func:`standin_registry`), traced (the virtual fingerprint) or not."""
    from repro import obs
    from repro.core import api, heuristics
    from repro.service import ServiceConfig, SchedulingService, generate_trace, trace_from_json

    out: dict[str, np.ndarray] = {}
    for name, kw in params["traces"].items():
        text = json.dumps(generate_trace(**kw).to_json(), indent=2)
        out[f"trace/{name}"] = np.array(text)
        out[f"trace/{name}/reparsed"] = np.array(json.dumps(trace_from_json(text).to_json(), indent=2))
    for case in params["serves"]:
        name = case["name"]
        if "gen" in case:
            trace = generate_trace(**case["gen"])
        else:
            trace = trace_from_json(str(inputs[f"{name}/trace"]))
        reg = standin_registry(api, heuristics) if case.get("standin") else None
        config = dict(case.get("config", {}))
        config["fallback"] = tuple(config.get("fallback", ()))
        obs.METRICS.reset()
        if case.get("traced"):
            obs.TRACER.enable()
        try:
            result = SchedulingService(trace.system, ServiceConfig(**config), registry=reg).run(trace)
        finally:
            obs.TRACER.disable()
        for k, v in service_outputs(result, obs.METRICS.snapshot()).items():
            out[f"{name}/{k}"] = np.array(v)
        if case.get("traced"):
            out[f"{name}/fingerprint"] = np.array(obs.virtual_fingerprint())
            out[f"{name}/spans"] = np.array(len(obs.TRACER.spans))
    return out


def job_cycling(params: dict, inputs: dict) -> dict:
    """The reference's cycling layer: each spec's JSON round trip, unrolled
    workflows, per-cycle deadlines, cross edges and convergence predicate;
    the errors of malformed specs; a scenario with a ``cycling`` section
    (its JSON text, the port's file written again, and its run's summary);
    and the converging-stream
    service fixture's replay fingerprint."""
    import dataclasses
    import tempfile

    from repro.campaigns.builtin import _converging_service_section
    from repro.core import api
    from repro.cycling import (
        cross_edges,
        cycle_spec_from_json,
        resolve_cycles,
        unroll_constraints,
        unroll_workload,
    )

    sm, wm = _modules()
    out: dict[str, np.ndarray] = {}
    for i, (spec_json, prob) in enumerate(params["specs"]):
        spec = cycle_spec_from_json(spec_json)
        workload = workload_of(prob, wm)
        out[f"spec/{i}/json"] = np.array(json.dumps(spec.to_json(), sort_keys=True))
        out[f"spec/{i}/unrolled"] = np.array(json.dumps(wm.workload_to_json(unroll_workload(workload, spec))))
        cons = unroll_constraints(workload, spec, base=constraints_of(prob, wm))
        out[f"spec/{i}/constraints"] = np.array(json.dumps(None if cons is None else cons.to_json()))
        out[f"spec/{i}/cross"] = np.array(json.dumps(cross_edges(workload.workflows[0], spec)))
        out[f"spec/{i}/cycles"] = np.array(resolve_cycles(spec))
        if spec.converging:
            out[f"spec/{i}/converged"] = np.array(
                [[spec.converge.converged(n, k) for k in range(spec.converge.max_cycles)]
                 for n in params["stream_names"]]
            )
            out[f"spec/{i}/revealed"] = np.array([spec.converge.revealed_cycles(n) for n in params["stream_names"]])
    for i, bad in enumerate(params["bad"]):
        out[f"bad/{i}"] = np.array(_error_of(lambda: cycle_spec_from_json(bad)))
    for spec in params["scenarios"]:
        name = spec["name"]
        sc = dataclasses.replace(scenario_of(spec, api, sm, wm), cycling=cycle_spec_from_json(spec["cycling"]))
        out[f"{name}/json"] = np.array(json.dumps(sc.to_json(), indent=2))
        again = api.scenario_from_json(str(inputs[f"{name}/port_json"]))
        out[f"{name}/reparsed"] = np.array(json.dumps(again.to_json(), indent=2))
        with tempfile.TemporaryDirectory() as tmp:
            summary = api.Orchestrator(sc, out_dir=tmp).run().summary()
        summary.pop("artifacts", None)
        out[f"{name}/summary"] = np.array(json.dumps(summary, sort_keys=True))
    section = _converging_service_section()
    out["converging/fingerprint"] = np.array(section["replay_fingerprint"])
    out["converging/section"] = np.array(json.dumps(section, sort_keys=True))
    return out


def job_obs(params: dict, inputs: dict) -> dict:
    """The reference's tracer on :func:`scripted_spans`, its fitness
    accounting on :func:`fitness_table` and its exporters on
    :func:`export_outputs`."""
    import tempfile

    from repro import obs
    from repro.obs import metrics

    out = {"script": np.array(scripted_spans(obs)),
           "fitness": np.array(fitness_table(metrics, params["calls"]))}
    with tempfile.TemporaryDirectory() as tmp:
        for k, v in export_outputs(obs, params["spans"], params["block"], params["bad"], Path(tmp)).items():
            out[f"export/{k}"] = np.array(v)
    return out


def job_campaigns(params: dict, inputs: dict) -> dict:
    """The reference's campaigns: each built-in's and each spec file's JSON
    text, expansion and solve keys; a ResultSet of the given rows through
    its JSON, CSV, grouping and reports; each campaign run's outputs
    (:func:`campaign_outputs`) with the real registry or the stand-in,
    traced (the virtual fingerprint and the span names) or not."""
    import collections

    from repro import campaigns, obs
    from repro.campaigns import ResultSet, builtin_campaign, campaign_from_json, load_campaign, run_campaign
    from repro.core import api, heuristics

    sm, wm = _modules()
    out: dict[str, np.ndarray] = {}
    specs = {name: builtin_campaign(name) for name in params["builtins"]}
    specs.update({path: load_campaign(path) for path in params["files"]})
    for name, c in specs.items():
        out[f"spec/{name}/json"] = np.array(json.dumps(c.to_json(), indent=2))
        out[f"spec/{name}/reparsed"] = np.array(json.dumps(campaign_from_json(c.to_json()).to_json(), indent=2))
        out[f"spec/{name}/cells"] = np.array(cell_keys(campaigns, wm, c))
    for i, text in enumerate(params["bad"]):
        out[f"bad/{i}"] = np.array(_error_of(lambda: campaign_from_json(text)))
    rs = ResultSet.from_rows(params["rows"], name="rows", meta={"coords": params["coords"]},
                             dtypes=params["dtypes"])
    out["rs/json"] = np.array(json.dumps(rs.to_json(), indent=2, sort_keys=True))
    out["rs/csv"] = np.array(rs.to_csv())
    out["rs/csv_reparsed"] = np.array(ResultSet.from_csv(rs.to_csv()).to_csv())
    out["rs/json_reparsed"] = np.array(json.dumps(ResultSet.from_json(rs.to_json()).to_json(), sort_keys=True))
    out["rs/groups"] = np.array(json.dumps([[list(kv), len(g)] for kv, g in rs.group_by("family", "size")]))
    out["rs/aggregate"] = np.array(rs.aggregate("makespan", by=("technique",)).to_csv())
    out["rs/deviation"] = np.array(rs.deviation_vs("milp").to_csv())
    out["rs/report"] = np.array(rs.deviation_report("milp").to_csv())
    out["rs/constraints"] = np.array(rs.constraint_report().to_csv())
    out["rs/baseline"] = np.array([rs.baseline_present("milp"), rs.baseline_present("pso")])
    for case in params["runs"]:
        name = case["name"]
        reg = standin_registry(api, heuristics) if case.get("standin") else None
        obs.METRICS.reset()
        if case.get("traced"):
            obs.TRACER.enable()
        try:
            rs = run_campaign(campaign_from_json(case["campaign"]), registry=reg)
        finally:
            obs.TRACER.disable()
        for k, v in campaign_outputs(rs).items():
            out[f"run/{name}/{k}"] = np.array(v)
        if case.get("traced"):
            out[f"run/{name}/fingerprint"] = np.array(obs.virtual_fingerprint())
            names = collections.Counter(s.name for s in obs.TRACER.spans)
            out[f"run/{name}/span_names"] = np.array(json.dumps(dict(sorted(names.items()))))
    return out


def job_cli(params: dict, inputs: dict) -> dict:
    """The reference CLI (``python -m repro``, run in process: it cannot
    import on its own here) on each argument list: its exit code and
    standard output."""
    import contextlib
    import io

    from repro.__main__ import main

    out: dict[str, np.ndarray] = {}
    for i, argv in enumerate(params["argvs"]):
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            try:
                rc = main(argv)
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else 1
        out[f"{i}/rc"] = np.array(rc)
        out[f"{i}/stdout"] = np.array(buf.getvalue())
    return out


def job_shard(params: dict, inputs: dict) -> dict:
    """The reference's instance axis over its virtual devices: the device
    count, ``choose_shards`` on each batch, ``sharded_batched_fitness`` at
    each shard count (and the unsharded core) in each usage mode on the
    given candidates, and ``ga_sweep`` at each sweep shard count with the
    draws of each instance.

    On JAX 0.9 the reference's sharded ``ga_sweep`` does not trace: its
    ``shard_map`` checks replication, and the ``lax.scan`` inside the GA
    carries a value whose type gains the mesh axis.  Here ``shard_map`` gets
    ``check_rep=False``; that check is static and changes no value."""
    import functools

    import jax
    import jax.experimental.shard_map as shard_map_mod
    import jax.numpy as jnp

    shard_map_mod.shard_map = functools.partial(shard_map_mod.shard_map, check_rep=False)

    from repro.core.evaluator import ObjectiveWeights
    from repro.core.metaheuristics import _safe_feasible, ga_sweep
    from repro.engine import ENGINES, choose_shards, local_device_count, sharded_batched_fitness
    from repro.engine.packed import common_bucket

    sm, wm = _modules()
    problems = [build(spec, sm, wm) for spec in params["specs"]]
    out: dict[str, np.ndarray] = {"devices": np.array(local_device_count())}
    out["choose"] = np.array([choose_shards(b) for b in params["batches"]])
    A = inputs["assignments"]
    for mode in ("fixed", "weighted"):
        w = ObjectiveWeights(usage_mode=mode)
        obj, mk = ENGINES.get("jax").batched_fitness(problems, w, shard=None)(A)
        out[f"{mode}/off/obj"], out[f"{mode}/off/mk"] = np.asarray(obj), np.asarray(mk)
        for d in params["shards"]:
            fitness = sharded_batched_fitness(problems, w, shards=d)
            obj, mk = fitness(A)
            out[f"{mode}/{d}/obj"], out[f"{mode}/{d}/mk"] = np.asarray(obj), np.asarray(mk)
            out[f"{mode}/{d}/shards"] = np.array(fitness.shards)
    opts = params["ga"]
    seed = params["sweep_seed"]
    for d in params["sweep_shards"]:
        for b, res in enumerate(ga_sweep(problems, seed=seed, shard=d, **opts)):
            out[f"sweep/{d}/{b}/best"] = np.asarray(res.schedule.assignment)
            out[f"sweep/{d}/{b}/history"] = np.asarray(res.history)
    Tb, Nb = common_bucket(problems)[:2]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(problems))
    for b, prob in enumerate(problems):
        logits = np.full((Tb, Nb), -1e30, dtype=np.float32)
        logits[: prob.num_tasks, : prob.num_nodes][_safe_feasible(prob)] = 0.0
        logits[prob.num_tasks :, 0] = 0.0
        draws = _ga_draws(keys[b], jnp.asarray(logits), opts["pop_size"], opts["generations"],
                          opts["tournament"], opts["mutation_rate"])
        for key, v in draws.items():
            out[f"draws/{b}/{key}"] = v
    return out


def job_topology(params: dict, inputs: dict) -> dict:
    """The reference's topology layer: each preset and seed's spec JSON,
    fingerprint, node JSON and dtr; observations, the closed-form factors
    and the Adam fit on each calibration case; a calibration report; an
    inline-topology scenario's JSON and run summary; a topology trace's
    text; the topology lane's campaign outputs (:func:`campaign_outputs`)
    with the real registry or the stand-in; and the CLI's outputs."""
    import tempfile

    from repro.campaigns import campaign_from_json, run_campaign
    from repro.core import api, heuristics
    from repro.core.system_model import system_to_json
    from repro.engine.packed import pack
    from repro.service import generate_trace
    from repro.topology import (
        PRESETS,
        calibrate,
        calibration_report,
        generate,
        least_squares_factors,
        perturbed_truth,
        synthesize_observations,
        tiered_spec,
    )

    sm, wm = _modules()
    out: dict[str, np.ndarray] = {}
    for preset in params["presets"]:
        for seed in params["seeds"]:
            spec = PRESETS[preset]().replace(seed=seed)
            system = generate(spec)
            tag = f"gen/{preset}/{seed}"
            out[f"{tag}/spec"] = np.array(json.dumps(spec.to_json(), sort_keys=True))
            out[f"{tag}/fingerprint"] = np.array(spec.fingerprint())
            obj = system_to_json(system)
            out[f"{tag}/nodes"] = np.array(json.dumps({k: v for k, v in obj.items() if k != "dtr_matrix"},
                                                      sort_keys=True))
            out[f"{tag}/dtr"] = system.dtr
    for i, case in enumerate(params["calibration"]):
        system = generate(tiered_spec(case["scale"], seed=case["seed"]))
        wf = wm.random_layered_workflow(case["tasks"], name="probe", seed=case["tasks"], max_cores=4,
                                        feature_pool=("F1",))
        packed = pack(wm.build_problem(system, wm.Workload((wf,))), pad=False)
        _, f_true, g_true = perturbed_truth(system, seed=case["perturb_seed"],
                                            link_range=tuple(case["link_range"]))
        obs = synthesize_observations(packed, speed_factors=f_true, link_factors=g_true,
                                      samples_per_node=case["samples"],
                                      transfer_samples=case["transfer_samples"], noise=case["noise"],
                                      seed=case["perturb_seed"] + 1)
        for k in ("task", "node", "duration", "src", "dst", "data", "xfer_duration"):
            out[f"cal/{i}/obs/{k}"] = getattr(obs, k)
        out[f"cal/{i}/f_true"], out[f"cal/{i}/g_true"] = f_true, g_true
        f, g = least_squares_factors(packed, obs)
        out[f"cal/{i}/lsq/f"], out[f"cal/{i}/lsq/g"] = f, g
        res = calibrate(packed, obs, steps=case["steps"])
        out[f"cal/{i}/fit/f"], out[f"cal/{i}/fit/g"] = res.speed_factors, res.link_factors
        out[f"cal/{i}/fit/base"] = res.baseline_speed_factors
        out[f"cal/{i}/fit/loss"] = np.array(res.loss)
        out[f"cal/{i}/fit/coverage"] = res.coverage
    rep_case = params["report"]
    system = generate(tiered_spec(1, seed=rep_case["seed"]))
    wf = wm.random_layered_workflow(rep_case["tasks"], name="probe", seed=rep_case["tasks"], max_cores=4,
                                    feature_pool=("F1",))
    report = calibration_report(system, wm.Workload((wf,)), perturb_seed=7,
                                samples_per_node=rep_case["samples"], noise=0.05, steps=rep_case["steps"])
    out["report"] = np.array(json.dumps(report, sort_keys=True))
    sc = api.scenario_from_json(params["scenario"])
    out["scenario/json"] = np.array(json.dumps(sc.to_json(), indent=2))
    with tempfile.TemporaryDirectory() as tmp:
        summary = api.Orchestrator(sc, out_dir=tmp).run().summary()
    summary.pop("artifacts", None)
    out["scenario/summary"] = np.array(json.dumps(summary, sort_keys=True))
    for name, kw in params["traces"].items():
        out[f"trace/{name}"] = np.array(json.dumps(generate_trace(**kw).to_json(), indent=2))
    for case in params["runs"]:
        reg = standin_registry(api, heuristics) if case.get("standin") else None
        rs = run_campaign(campaign_from_json(case["campaign"]), registry=reg)
        for k, v in campaign_outputs(rs).items():
            out[f"run/{case['name']}/{k}"] = np.array(v)
    for k, v in job_cli({"argvs": params["argvs"]}, inputs).items():
        out[f"cli/{k}"] = v
    return out


def job_continuum(params: dict, inputs: dict) -> dict:
    """The reference's ML-job continuum: the roofline estimates, KV bytes
    and best layouts of each arch and applicable shape, the fleets, the job
    durations (with their infinities), the HEFT and GA schedules of the job
    mix (the GA with the draws it made), the step workflows, and the job
    scenario's JSON and run summary."""
    import dataclasses
    import tempfile

    import jax

    from repro.configs.shapes import SHAPES, applicable_shapes
    from repro.core import api, autoshard, continuum
    from repro.core.heuristics import heft
    from repro.core.metaheuristics import _mask_logits
    from repro.engine.packed import pack
    from repro.models.registry import get_model

    sm, wm = _modules()
    out: dict[str, np.ndarray] = {}
    for arch in params["archs"]:
        cfg = get_model(arch).config
        out[f"{arch}/shapes"] = np.array(json.dumps(applicable_shapes(arch)))
        for shape in applicable_shapes(arch):
            suite = SHAPES[shape]
            tag = f"{arch}/{shape}"
            layouts = autoshard.enumerate_layouts(256, 1, train=suite.kind == "train")
            layouts += [autoshard.Layout(**kw) for kw in params["layouts"]]
            rows = []
            for lay in layouts:
                e = autoshard.estimate(cfg, suite, lay)
                rows.append([e.compute_s, e.memory_s, e.collective_s, e.hbm_per_chip, e.step_s])
            out[f"{tag}/layouts"] = np.array(json.dumps([dataclasses.asdict(lay) for lay in layouts]))
            out[f"{tag}/estimates"] = np.array(rows, dtype=np.float64)
            out[f"{tag}/kv"] = np.array(autoshard.kv_cache_bytes(cfg, suite.global_batch, suite.seq_len))
            for i, kw in enumerate(params["best"]):
                lay, e = autoshard.best_layout(cfg, suite, **kw)
                out[f"{tag}/best/{i}"] = np.array(json.dumps(
                    [dataclasses.asdict(lay), [e.compute_s, e.memory_s, e.collective_s, e.hbm_per_chip],
                     e.bottleneck]))
        wf = continuum.training_step_workflow(arch)
        out[f"{arch}/step"] = np.array(json.dumps(wm.workload_to_json(wm.Workload((wf,)))))

    jobs = continuum.default_job_mix()
    fleets = {f"fleet{i}": sm.tpu_fleet(**kw) for i, kw in enumerate(params["fleets"])}
    fleets["mixed"] = sm.make_system(
        [sm.tpu_slice_node(f"s{i}", chips, fabric=fabric) for i, (chips, fabric) in enumerate(params["mixed"])]
    )
    for name, system in fleets.items():
        out[f"{name}/system"] = np.array(json.dumps(sm.system_to_json(system)))
        out[f"{name}/dtr"] = system.dtr
        out[f"{name}/durations"] = continuum.job_durations(jobs, system)
        prob = wm.build_problem(system, continuum.jobs_to_workload(jobs, system))
        out[f"{name}/workload"] = np.array(json.dumps(wm.workload_to_json(continuum.jobs_to_workload(jobs, system))))
        for k, v in pack(prob, pad=False).numpy_arrays().items():
            out[f"{name}/packed/{k}"] = v
        sched = heft(prob)
        out[f"{name}/heft/assignment"] = np.asarray(sched.assignment)
        out[f"{name}/heft/makespan"] = np.array(sched.makespan)

    rep, system = continuum.schedule_jobs(technique="heft")
    out["schedule/heft/assignment"] = np.asarray(rep.schedule.assignment)
    out["schedule/heft/makespan"] = np.array(rep.schedule.makespan)
    ga = params["ga"]
    seed = ga["seed"]
    opts = {k: v for k, v in ga.items() if k != "seed"}
    rep, system = continuum.schedule_jobs(technique="ga", seed=seed, **opts)
    out["schedule/ga/assignment"] = np.asarray(rep.schedule.assignment)
    out["schedule/ga/history"] = np.asarray(rep.history)
    out["schedule/ga/makespan"] = np.array(rep.schedule.makespan)
    draws = _ga_draws(jax.random.PRNGKey(seed), _mask_logits(rep.problem), opts["pop_size"],
                      opts["generations"], opts["tournament"], opts["mutation_rate"])
    for key, v in draws.items():
        out[f"schedule/ga/draws/{key}"] = v

    for technique in ("auto", "heft"):
        sc = continuum.jobs_scenario(technique=technique)
        tag = f"scenario/{technique}"
        out[f"{tag}/json"] = np.array(json.dumps(sc.to_json(), indent=2))
        out[f"{tag}/fingerprint"] = np.array(sc.fingerprint())
        with tempfile.TemporaryDirectory() as tmp:
            run = []
            out[f"{tag}/error"] = np.array(_error_of(lambda: run.append(api.Orchestrator(sc, out_dir=tmp).run())))
            if run:
                summary = run[0].summary()
                summary.pop("artifacts", None)
                out[f"{tag}/summary"] = np.array(json.dumps(summary, sort_keys=True))
    return out


def job_kvcache(params: dict, inputs: dict) -> dict:
    """The reference's int8 KV storage (``repro.serve.kvcache``, which
    reaches ``repro.core``): each input quantized as f32 and as bf16, its
    codes, scales and the dequantized values in f32 and bf16 (as f32); and
    ``cache_bytes_report`` of each (arch, batch, seq)."""
    import jax.numpy as jnp

    from repro.models.registry import get_model
    from repro.serve.kvcache import cache_bytes_report, dequantize_kv, quantize_kv

    out: dict[str, np.ndarray] = {}
    for name, x in inputs.items():
        for dtype in ("float32", "bfloat16"):
            codes, scale = quantize_kv(jnp.asarray(x).astype(dtype))
            out[f"{name}/{dtype}/codes"] = np.asarray(codes)
            out[f"{name}/{dtype}/scale"] = np.asarray(scale)
            for back in ("float32", "bfloat16"):
                deq = dequantize_kv(codes, scale, jnp.dtype(back))
                out[f"{name}/{dtype}/back/{back}"] = np.asarray(deq.astype(jnp.float32))
    for arch, batch, seq in params["reports"]:
        report = cache_bytes_report(get_model(arch).config, batch, seq)
        out[f"report/{arch}/{batch}/{seq}"] = np.array(json.dumps(report, sort_keys=True))
    return out


def job_replacement(params: dict, inputs: dict) -> dict:
    """The reference's ``replacement_schedule`` (HEFT on ``tpu_fleet``, which
    reaches ``repro.core``) for each (jobs, surviving pods) case."""
    from repro.distributed.fault_tolerance import replacement_schedule

    out: dict[str, np.ndarray] = {}
    for i, case in enumerate(params["cases"]):
        rep = replacement_schedule(case["jobs"], case["pods"])
        _schedule_arrays(out, f"{i}", rep.schedule)
        out[f"{i}/assignment"] = np.asarray(rep.schedule.assignment)
    return out


def _path_keys(path) -> list[str]:
    return [str(getattr(k, "key", getattr(k, "idx", None))) for k in path]


def _stacked(keys: list[str]) -> tuple[str, str] | None:
    """(the port's name before the layer index, the path after it) of a
    stacked reference leaf's keys (``blocks/<slot>/...`` of a transformer,
    ``blocks/...`` of the ssm and hybrid families, ``enc_blocks/...``,
    ``dec_blocks/...``), or None for a leaf of its own."""
    if keys[0] not in ("blocks", "enc_blocks", "dec_blocks"):
        return None
    n = 2 if keys[1].isdigit() else 1  # a transformer's window slot
    return ".".join(keys[:n]), ".".join(keys[n:])


def tree_from_named(named: dict, template):
    """A reference parameter tree shaped as ``template`` from the port's
    named arrays: ``blocks.<slot>.<group>.<path>`` (a transformer),
    ``blocks.<layer>.<path>`` (ssm, hybrid), ``enc_blocks.<layer>.<path>``
    and ``dec_blocks.<layer>.<path>`` (encdec) stacked on the leading axis
    of the reference's leaf, every other name its leaf."""
    import jax
    import jax.numpy as jnp

    def leaf(path, like):
        keys = _path_keys(path)
        stacked = _stacked(keys)
        if stacked:
            head, rest = stacked
            parts = [named[f"{head}.{g}.{rest}"] for g in range(like.shape[0])]
            return jnp.asarray(np.stack(parts)).astype(like.dtype)
        return jnp.asarray(named[".".join(keys)]).astype(like.dtype)

    return jax.tree_util.tree_map_with_path(leaf, template)


def named_from_tree(tree) -> dict[str, np.ndarray]:
    """The inverse of :func:`tree_from_named`: ``{port name: array}``."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys, a = _path_keys(path), np.asarray(leaf)
        stacked = _stacked(keys)
        if stacked:
            head, rest = stacked
            out.update({f"{head}.{g}.{rest}": a[g] for g in range(a.shape[0])})
        else:
            out[".".join(keys)] = a
    return out


def _reduced_tree(arch: str, overrides: dict, named: dict):
    """The reference's api, reduced config in f32 (``overrides`` replaced)
    and parameter tree from the port's named arrays."""
    import dataclasses

    import jax

    from repro.models.registry import get_model

    api = get_model(arch)
    cfg = dataclasses.replace(api.reduced, dtype="float32", **overrides)
    template = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0), cfg))
    if set(named) != set(named_from_tree(jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), template))):
        raise ValueError("the port's parameter names are not the reference's tree")
    return api, cfg, template, tree_from_named(named, template)


def _weights(inputs: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in inputs.items() if k.startswith(prefix + "/")}


def job_sharded_steps(params: dict, inputs: dict) -> dict:
    """``tests/test_distributed.py:142``'s sharded step, two of them, on the
    port's reduced weights and tokens: for each case (name, (data, model),
    policy, remat[, arch, overrides]; qwen2.5-3b when no arch is named),
    ``jax.jit(step, in_shardings=...)`` on a mesh of the first data·model
    devices under ``ShardingPolicy`` (``seqpar`` with the residual stream's
    hint, as the reference's dry-run sets it), from the weights ``qwen/<name>``
    (qwen2.5-3b) or ``<case>/<name>``, behind the case's frames or patches
    where it has them (``extra/<case>/frames``, ``extra/<case>/patches``,
    cut by ``batch_shardings`` as the reference's dry-run cuts them); its
    losses and parameters by port name."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.distributed import hints
    from repro.distributed.sharding import (ShardingPolicy, batch_shardings, make_opt_shardings,
                                            make_param_shardings)
    from repro.optim import adamw
    from repro.train.train_step import make_train_step

    tokens = jnp.asarray(inputs["qwen_tokens"])
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    out = {}
    for case in params["train_cases"]:
        name, shape, policy, remat = case[:4]
        batch = {"tokens": tokens, **{k: jnp.asarray(inputs[f"extra/{name}/{k}"]) for k in ("frames", "patches")
                                      if f"extra/{name}/{k}" in inputs}}
        arch, overrides = (case[4], case[5] or {}) if len(case) > 4 else ("qwen2.5-3b", {})
        prefix = "qwen" if len(case) == 4 else name
        api, cfg, template, tree = _reduced_tree(arch, overrides, _weights(inputs, prefix))
        n = int(np.prod(shape))
        mesh = jax.make_mesh(tuple(shape), ("data", "model"), (jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:n])
        seqpar = policy == "seqpar"
        pol = ShardingPolicy(dp_axes=("data",), tp_axes=("model",), sequence_parallel=seqpar)
        act = NamedSharding(mesh, P("data", "model", None)) if seqpar else None
        opt = adamw.init(opt_cfg, tree)
        psh = make_param_shardings(mesh, cfg, template, pol)
        osh = make_opt_shardings(mesh, cfg, opt, psh, pol)
        bsh = batch_shardings(mesh, cfg, jax.eval_shape(lambda: batch), pol)
        step = jax.jit(make_train_step(api, cfg, opt_cfg, remat=remat), in_shardings=(psh, osh, bsh))
        p, o, b = jax.device_put(tree, psh), jax.device_put(opt, osh), jax.device_put(batch, bsh)
        losses = []
        with hints.activation_pspec(act):  # read when the step is traced, at its first call
            for _ in range(2):
                p, o, m = step(p, o, b)
                losses.append(float(m["loss"]))
                p, o = jax.device_put(p, psh), jax.device_put(o, osh)  # the outputs' layout is XLA's choice
        out[f"train/{name}/losses"] = np.asarray(losses)
        out.update({f"train/{name}/p/{k}": v for k, v in named_from_tree(p).items()})
    return out


def job_sharded_serve(params: dict, inputs: dict) -> dict:
    """The reference dry-run's ``prefill_fn`` and ``decode_fn``
    (``src/repro/launch/dryrun.py:113``), jitted with their ``in_shardings``
    and ``out_shardings`` on a mesh of the first data·model devices under
    ``serve-tp`` (TP-only parameters), on the port's reduced weights
    (``<case>/<name>``): the prompts ``<case>/prompt``, behind the family's
    extras where the case has them (``<case>/patches``, ``<case>/frames``, cut by
    ``batch_shardings`` as ``dryrun.py:116-121`` cuts them), into a zero
    cache of ``max_len`` positions, then one tick for each token of
    ``<case>/tokens`` (the port's greedy tokens, teacher-forced); each
    step's logits."""
    import jax
    import jax.numpy as jnp

    from repro.distributed.sharding import (ShardingPolicy, batch_shardings, logits_sharding,
                                            make_cache_shardings, make_param_shardings)

    out = {}
    pol = ShardingPolicy(dp_axes=("data",), tp_axes=("model",), param_fsdp_axes=())
    for name, arch, shape, policy in params["serve_cases"]:
        if policy != "serve-tp":
            raise ValueError(f"no reference policy {policy!r} here")
        api, cfg, template, tree = _reduced_tree(arch, {}, _weights(inputs, f"{name}/w"))
        prompt = jnp.asarray(inputs[f"{name}/prompt"])
        extras = {k: jnp.asarray(inputs[f"{name}/{k}"]) for k in ("patches", "frames") if f"{name}/{k}" in inputs}
        B = prompt.shape[0]
        n = int(np.prod(shape))
        mesh = jax.make_mesh(tuple(shape), ("data", "model"), (jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:n])
        cache = api.init_cache(B, params["max_len"], cfg)
        psh = make_param_shardings(mesh, cfg, template, pol)
        csh = make_cache_shardings(mesh, cfg, jax.eval_shape(lambda: cache), pol)
        tsh = batch_shardings(mesh, cfg, {"tokens": jax.ShapeDtypeStruct(prompt.shape, prompt.dtype)}, pol)
        ksh = batch_shardings(mesh, cfg, {"token": jax.ShapeDtypeStruct((B,), jnp.int32)}, pol)
        esh = batch_shardings(mesh, cfg, jax.eval_shape(lambda: extras), pol)
        lsh = logits_sharding(mesh, cfg, B, pol)

        def prefill_fn(params, tokens, cache, extra):
            return api.module.prefill(params, cfg, tokens, cache, **extra)

        def decode_fn(params, token, cache):
            return api.module.decode_step(params, cfg, token, cache)

        prefill = jax.jit(prefill_fn, in_shardings=(psh, tsh["tokens"], csh, esh), out_shardings=(lsh, csh))
        decode = jax.jit(decode_fn, in_shardings=(psh, ksh["token"], csh), out_shardings=(lsh, csh))
        p = jax.device_put(tree, psh)
        logits, cache = prefill(p, jax.device_put(prompt, tsh["tokens"]), jax.device_put(cache, csh),
                                jax.device_put(extras, esh))
        steps = [np.asarray(logits)]
        for tok in inputs[f"{name}/tokens"]:
            logits, cache = decode(p, jax.device_put(jnp.asarray(tok), ksh["token"]), cache)
            steps.append(np.asarray(logits))
        out[f"serve/{name}/logits"] = np.stack(steps)
    return out


def job_long_decode(params: dict, inputs: dict) -> dict:
    """The reference dry-run's ``decode_fn`` (``src/repro/launch/dryrun.py:113``)
    of each ``long_500k`` case (name, arch, overrides), jitted with its
    ``in_shardings`` and ``out_shardings`` on a mesh of the first 4 devices,
    (data 1, model 4), under ``serve-tp``, on the port's reduced weights
    (``<case>/w/<name>``, ``overrides`` replaced in the config) from the
    port's whole cache (``<case>/cache/<path>``: every leaf by its ``/``
    path, ``pos`` too), one tick for each token of ``<case>/tokens``
    (teacher-forced); each tick's logits."""
    import jax
    import jax.numpy as jnp

    from repro.distributed.sharding import (ShardingPolicy, batch_shardings, logits_sharding,
                                            make_cache_shardings, make_param_shardings)

    out = {}
    pol = ShardingPolicy(dp_axes=("data",), tp_axes=("model",), param_fsdp_axes=())
    mesh = jax.make_mesh((1, 4), ("data", "model"), (jax.sharding.AxisType.Auto,) * 2, devices=jax.devices()[:4])
    for name, arch, overrides in params["long_cases"]:
        api, cfg, template, tree = _reduced_tree(arch, overrides or {}, _weights(inputs, f"{name}/w"))
        leaves = _weights(inputs, f"{name}/cache")

        def leaf(path, like):
            a = leaves["/".join(_path_keys(path))]
            return jnp.asarray(a).astype(like.dtype).reshape(like.shape)

        cache = jax.tree_util.tree_map_with_path(leaf, api.init_cache(1, params["seq_len"], cfg))
        psh = make_param_shardings(mesh, cfg, template, pol)
        csh = make_cache_shardings(mesh, cfg, jax.eval_shape(lambda: cache), pol)
        ksh = batch_shardings(mesh, cfg, {"token": jax.ShapeDtypeStruct((1,), jnp.int32)}, pol)

        def decode_fn(params, token, cache):
            return api.module.decode_step(params, cfg, token, cache)

        decode = jax.jit(decode_fn, in_shardings=(psh, ksh["token"], csh),
                         out_shardings=(logits_sharding(mesh, cfg, 1, pol), csh))
        p, cache = jax.device_put(tree, psh), jax.device_put(cache, csh)
        steps = []
        for tok in inputs[f"{name}/tokens"]:
            logits, cache = decode(p, jax.device_put(jnp.asarray(tok), ksh["token"]), cache)
            steps.append(np.asarray(logits))
        out[f"long/{name}/logits"] = np.stack(steps)
    return out


def job_distributed(params: dict, inputs: dict) -> dict:
    """The reference's layouts and collectives on 8 forced devices:
    ``devices_indices_map`` of each (mesh, spec, shape) case, a device's
    entry at its row-major place on the mesh; ``compressed_psum_pod`` on
    (pod 4, x 2) at ``tests/test_distributed.py:181``'s input; the pipeline
    of ``:204`` (its weights, input, and output on 4 of the devices)."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.distributed.compression import compressed_psum_pod
    from repro.distributed.pipeline import pipeline_forward, split_stages
    from repro.launch.mesh import make_mesh

    out: dict[str, np.ndarray] = {}
    for i, case in enumerate(params["slice_cases"]):
        mesh = make_mesh(tuple(case["mesh"]), tuple(case["axes"]))
        spec = P(*(tuple(e) if isinstance(e, list) else e for e in case["spec"]))
        imap = NamedSharding(mesh, spec).devices_indices_map(tuple(case["shape"]))
        rows = []
        for _, dev in np.ndenumerate(mesh.devices):  # row-major: rank order
            rows.append([[s.start or 0, n if s.stop is None else s.stop]
                         for s, n in zip(imap[dev], case["shape"])])
        out[f"slices_{i}"] = np.asarray(rows)
    mesh = make_mesh((4, 2), ("pod", "x"))
    x = jnp.asarray(np.random.default_rng(0).standard_normal((4, 256)).astype(np.float32))
    f = shard_map(functools.partial(compressed_psum_pod, axis_name="pod"), mesh=mesh,
                  in_specs=P("pod", None), out_specs=P("pod", None))
    out["psum_x"] = np.asarray(x)
    out["psum"] = np.asarray(f(x))
    L, d, M, mb, S = 8, 16, 4, 2, 8
    w = jax.random.normal(jax.random.PRNGKey(0), (L, d, d)) * 0.3
    xs = jax.random.normal(jax.random.PRNGKey(1), (M, mb, S, d))

    def block_fn(stage_w, h):
        def one(h, wi):
            return jnp.tanh(h @ wi), None

        h, _ = jax.lax.scan(one, h, stage_w)
        return h

    stage_mesh = Mesh(np.asarray(jax.devices()[:4]), ("stage",))
    out["pipe_w"], out["pipe_x"] = np.asarray(w), np.asarray(xs)
    out["pipe_ref"] = np.asarray(pipeline_forward(block_fn, split_stages(w, 4), xs, stage_mesh))
    out["pipe_seq_ref"] = np.asarray(jax.vmap(lambda xm: block_fn(w, xm))(xs))
    return out


JOBS = {
    "distributed": job_distributed,
    "sharded_steps": job_sharded_steps,
    "sharded_serve": job_sharded_serve,
    "long_decode": job_long_decode,
    "replacement": job_replacement,
    "kvcache": job_kvcache,
    "obs": job_obs, "campaigns": job_campaigns, "cli": job_cli,
    "shard": job_shard, "topology": job_topology,
    "service": job_service, "cycling": job_cycling,
    "scenario": job_scenario,
    "model": job_model, "engine": job_engine, "ga": job_ga, "pallas": job_pallas,
    "mh": job_mh, "heuristics": job_heuristics, "milp": job_milp,
    "continuum": job_continuum,
}


if __name__ == "__main__":
    job, params_path, inputs_path, out_path = sys.argv[1:5]
    _load_reference()
    with np.load(inputs_path) as f:
        inputs = {k: f[k] for k in f.files}
    result = JOBS[job](json.loads(Path(params_path).read_text()), inputs)
    np.savez(out_path, **result)
