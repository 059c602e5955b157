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


def name_of(spec: dict) -> str:
    return "-".join(str(spec[k]) for k in sorted(spec))


# -----------------------------------------------------------------------------
# parent side
# -----------------------------------------------------------------------------


def run(job: str, params: dict, inputs: dict[str, np.ndarray] | None = None,
        timeout: float = 300.0) -> dict[str, np.ndarray]:
    """Run ``job`` in a child process on the reference package and return
    its arrays.  Raises with the child's output if it fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    # one CPU device, whatever an earlier test in this worker left in
    # os.environ (importing repro.launch.dryrun sets 512 devices)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
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


JOBS = {"model": job_model, "engine": job_engine, "ga": job_ga, "pallas": job_pallas}


if __name__ == "__main__":
    job, params_path, inputs_path, out_path = sys.argv[1:5]
    _load_reference()
    with np.load(inputs_path) as f:
        inputs = {k: f[k] for k in f.files}
    result = JOBS[job](json.loads(Path(params_path).read_text()), inputs)
    np.savez(out_path, **result)
