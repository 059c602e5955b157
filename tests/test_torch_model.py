"""Model layer of the PyTorch port against the JAX package: the same specs
give identical packed arrays, fingerprints and oracle schedules, bit for
bit.  The reference runs in a child process (tests/torch_reference.py)."""

import json
import zlib

import numpy as np
import pytest
import torch

import torch_reference as ref_harness
from repro_torch.core import evaluator, system_model as sm, workload_model as wm
from repro_torch.core.validate import verify_schedule
from repro_torch.engine import packed as packed_mod, population_fitness_fn
from repro_torch.engine.sim import ready_times_all, run_schedule

SPECS = [
    {"kind": "mri"},
    {"kind": "layered", "tasks": 12, "nodes": 4, "seed": 2},
    {"kind": "layered", "tasks": 24, "nodes": 6, "seed": 3},
    {"kind": "synthetic", "tasks": 20, "nodes": 20, "seed": 1},
    {"kind": "deadlink", "tasks": 12, "nodes": 5, "seed": 4},
    {"kind": "constrained", "tasks": 20, "nodes": 20, "seed": 5, "deadline": 9.0, "budget": 120.0},
]
IDS = [ref_harness.name_of(s) for s in SPECS]
N_ASSIGN = 3


def _problem(spec):
    return ref_harness.build(spec, sm, wm)


def _assignments(spec, problem):
    """Rows 0..1 random over feasible nodes, row 2 uniformly random (so it
    can break feasibility): numpy-seeded, shared with the child."""
    rng = np.random.default_rng(zlib.crc32(ref_harness.name_of(spec).encode()))
    T, N = problem.num_tasks, problem.num_nodes
    A = rng.integers(0, N, (N_ASSIGN, T))
    for k in range(N_ASSIGN - 1):
        for j in range(T):
            ok = np.flatnonzero(problem.feasible[j])
            A[k, j] = rng.choice(ok) if ok.size else 0
    return A


@pytest.fixture(scope="module")
def cases():
    problems = {ref_harness.name_of(s): _problem(s) for s in SPECS}
    assignments = {n: _assignments(s, problems[n]) for n, s in zip(IDS, SPECS)}
    ref = ref_harness.run(
        "model",
        {"specs": SPECS},
        {f"{n}/assignments": a for n, a in assignments.items()},
    )
    return problems, assignments, ref


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_fingerprint_identical(cases, spec):
    problems, _, ref = cases
    name = ref_harness.name_of(spec)
    assert wm.problem_fingerprint(problems[name]) == str(ref[f"{name}/fingerprint"])


@pytest.mark.parametrize("pad", [False, True], ids=["exact", "bucket"])
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_packed_arrays_identical(cases, spec, pad):
    problems, _, ref = cases
    name = ref_harness.name_of(spec)
    p = packed_mod.pack(problems[name], pad=pad, use_cache=False)
    tag = f"{name}/pad{int(pad)}"
    meta = [*p.bucket, p.num_tasks, p.num_nodes, p.cmax, int(p.constrained)]
    assert meta == ref[f"{tag}/meta"].tolist()
    for k, v in p.numpy_arrays().items():
        r = ref[f"{tag}/{k}"]
        assert v.dtype == r.dtype, k
        np.testing.assert_array_equal(v, r, err_msg=k)


def test_dead_link_encoding(cases):
    """+inf in JSON travels as -1.0, and packs as 1e30 in ``dtr``."""
    problems, _, ref = cases
    spec = next(s for s in SPECS if s["kind"] == "deadlink")
    name = ref_harness.name_of(spec)
    js = sm.system_to_json(ref_harness.system_of(spec, sm))
    assert js["dtr_matrix"][0][1] == -1.0 and js["dtr_matrix"][0][0] == -1.0
    assert js == json.loads(str(ref[f"{name}/system_json"]))
    dtr = packed_mod.pack(problems[name], pad=False).dtr
    assert dtr[0, 1] == np.float32(1e30) and dtr[1, 0] == np.float32(1e30)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_reference_json_builds_identical_problem(cases, spec):
    """The reference's system_to_json / workload_to_json output, read by
    the port unchanged, builds a problem with the reference's fingerprint."""
    _, _, ref = cases
    name = ref_harness.name_of(spec)
    system = sm.system_from_json(str(ref[f"{name}/system_json"]))
    workload = wm.workload_from_json(str(ref[f"{name}/workload_json"]))
    problem = wm.build_problem(system, workload, ref_harness.constraints_of(spec, wm))
    assert wm.problem_fingerprint(problem) == str(ref[f"{name}/fingerprint"])


@pytest.mark.parametrize("mode", ["fixed", "weighted"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_oracle_schedule_identical(cases, spec, dtype, mode):
    problems, assignments, ref = cases
    name = ref_harness.name_of(spec)
    for k, a in enumerate(assignments[name]):
        s = evaluator.evaluate_assignment(
            problems[name], a, evaluator.ObjectiveWeights(usage_mode=mode), dtype=np.dtype(dtype).type
        )
        tag = f"{name}/{k}/{dtype}/{mode}"
        np.testing.assert_array_equal(s.start, ref[f"{tag}/start"])
        np.testing.assert_array_equal(s.finish, ref[f"{tag}/finish"])
        np.testing.assert_array_equal(
            [s.makespan, s.usage, s.objective, s.violations], ref[f"{tag}/stats"]
        )


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_ready_times_and_validity_identical(cases, spec):
    problems, assignments, ref = cases
    name = ref_harness.name_of(spec)
    prob = problems[name]
    for k, a in enumerate(assignments[name]):
        _, finish, _ = run_schedule(prob, a)
        ready = np.stack([ready_times_all(prob, j, a, finish) for j in range(prob.num_tasks)])
        np.testing.assert_array_equal(ready, ref[f"{name}/{k}/ready"])
        errs = verify_schedule(prob, evaluator.evaluate_assignment(prob, a))
        assert errs == json.loads(str(ref[f"{name}/{k}/verify"]))


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_from_arrays_round_trips(cases, spec):
    """The reference's packed arrays become the port's PackedProblem, with
    the kernel's dtypes on the device."""
    problems, _, ref = cases
    name = ref_harness.name_of(spec)
    tag = f"{name}/pad1"
    Tb, Nb, Cb, Pb, T, N, cmax, constrained = ref[f"{tag}/meta"].tolist()
    arrays = {k: ref[f"{tag}/{k}"] for k in packed_mod.FITNESS_ARRAY_KEYS}
    p = packed_mod.from_arrays(
        arrays, bucket=(Tb, Nb, Cb, Pb), num_tasks=T, num_nodes=N, cmax=cmax,
        constrained=bool(constrained),
    )
    mine = packed_mod.pack(problems[name])
    assert (p.bucket, p.num_tasks, p.num_nodes, p.cmax, p.constrained) == (
        mine.bucket, mine.num_tasks, mine.num_nodes, mine.cmax, mine.constrained
    )
    for k in packed_mod.FITNESS_ARRAY_KEYS:
        np.testing.assert_array_equal(getattr(p, k), getattr(mine, k), err_msg=k)
    dev = p.device_arrays("cpu")
    assert dev["feasible"].dtype == torch.uint8 and dev["cores"].dtype == torch.int32
    assert dev["pred_matrix"].dtype == torch.int32 and dev["durations"].dtype == torch.float32
    assert all(t.is_contiguous() for t in dev.values())
    # an engine scores candidates against it as against the problem itself
    A = cases[1][name]
    obj, mk = population_fitness_fn(p, engine="torch", device="cpu")(A)
    obj2, mk2 = population_fitness_fn(problems[name], engine="torch", device="cpu")(A)
    assert torch.equal(mk, mk2) and torch.equal(obj, obj2)
    with pytest.raises(ValueError, match="shape"):
        packed_mod.from_arrays(
            {**arrays, "dtr": arrays["dtr"][:1]}, bucket=(Tb, Nb, Cb, Pb), num_tasks=T,
            num_nodes=N, cmax=cmax, constrained=bool(constrained),
        )


def test_objective_weights_frozen_and_hashable():
    w = evaluator.ObjectiveWeights()
    assert hash(w) == hash(evaluator.ObjectiveWeights())
    with pytest.raises(AttributeError):
        w.alpha = 2.0  # type: ignore[misc]


def test_pack_cache_reuses_content_identical_problems():
    cache = packed_mod.pack_cache()
    before = (cache.stats.hits, cache.stats.misses)
    a = packed_mod.pack(_problem(SPECS[1]))
    b = packed_mod.pack(_problem(SPECS[1]))
    assert a is b
    assert cache.stats.hits - before[0] >= 1
    assert a.device_arrays("cpu")["durations"] is b.device_arrays("cpu")["durations"]
