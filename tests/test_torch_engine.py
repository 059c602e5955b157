"""Fitness engines of the PyTorch port against the JAX package's ``jax`` and
``oracle`` engines (run in a child process, tests/torch_reference.py).

In ``usage_mode="fixed"`` the objective is bit-identical: the usage term
sums integer core counts, exact in any order, and the port rounds the
weighted sum as the reference's jitted program does (fused multiply-adds).
The weights here are not powers of two, so a plain ``a*b + c`` would round
differently.  In ``"weighted"`` mode it sums
T non-integer f32 shares, and XLA and PyTorch add them in different orders;
the difference is bounded by the recursive-summation bound
``(T - 1) * 2**-24 * Σ|u|`` (Higham, Accuracy and Stability of Numerical
Algorithms, §4.2), with ``Σ|u| ≤ objective`` here since every term is
positive.  Makespans are bit-identical in both modes."""

import numpy as np
import pytest
import torch

import torch_reference as ref_harness
from repro_torch.core import ObjectiveWeights, system_model as sm, workload_model as wm
from repro_torch.engine import (
    ENGINES,
    ScheduleEngine,
    batched_population_fitness_fn,
    population_fitness_fn,
    register_engine,
    resolve_engine,
)
from repro_torch.engine.backends import _fma
from repro_torch.kernels.makespan import population_makespan_cuda

SPECS = [
    {"kind": "mri"},
    {"kind": "layered", "tasks": 12, "nodes": 4, "seed": 2},
    {"kind": "synthetic", "tasks": 20, "nodes": 20, "seed": 1},
    {"kind": "constrained", "tasks": 20, "nodes": 20, "seed": 5, "deadline": 9.0, "budget": 120.0},
]
IDS = [ref_harness.name_of(s) for s in SPECS]
ALPHA, BETA = 0.3, 0.7
POP = 8


def _assignments(problem, seed):
    rng = np.random.default_rng(seed)
    A = rng.integers(0, problem.num_nodes, (POP, problem.num_tasks))
    feasible = problem.feasible[np.arange(problem.num_tasks), A]
    A[: POP // 2] = np.where(feasible[: POP // 2], A[: POP // 2], A[-1])  # mostly feasible rows
    return A.astype(np.int32)


@pytest.fixture(scope="module")
def cases():
    problems = [ref_harness.build(s, sm, wm) for s in SPECS]
    assignments = {n: _assignments(p, k) for k, (n, p) in enumerate(zip(IDS, problems))}
    fitness = batched_population_fitness_fn(problems, engine="torch", device="cpu")
    batch = np.zeros((len(problems), POP, fitness.bucket[0]), np.int32)
    for b, (n, p) in enumerate(zip(IDS, problems)):
        batch[b, :, : p.num_tasks] = assignments[n]
    inputs = {f"{n}/assignments": a for n, a in assignments.items()}
    inputs["batch/assignments"] = batch
    ref = ref_harness.run("engine", {"specs": SPECS, "alpha": ALPHA, "beta": BETA}, inputs)
    return dict(zip(IDS, problems)), assignments, batch, fitness, ref


def _port(problem, A, engine, mode):
    w = ObjectiveWeights(alpha=ALPHA, beta=BETA, usage_mode=mode)
    obj, mk = population_fitness_fn(problem, w, engine=engine, device="cpu")(A)
    return obj.numpy(), mk.numpy()


@pytest.mark.parametrize("engine", ["torch", "oracle"])
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_fixed_usage_objective_bit_identical(cases, spec, engine):
    problems, assignments, _, _, ref = cases
    name = ref_harness.name_of(spec)
    obj, mk = _port(problems[name], assignments[name], engine, "fixed")
    ref_engine = "jax" if engine == "torch" else "oracle"
    np.testing.assert_array_equal(obj, ref[f"{name}/{ref_engine}/fixed/obj"])
    np.testing.assert_array_equal(mk, ref[f"{name}/{ref_engine}/fixed/mk"])
    np.testing.assert_array_equal(mk, ref[f"{name}/jax/fixed/mk"])


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_weighted_usage_objective_within_summation_bound(cases, spec):
    problems, assignments, _, _, ref = cases
    name = ref_harness.name_of(spec)
    obj, mk = _port(problems[name], assignments[name], "torch", "weighted")
    ref_obj = ref[f"{name}/jax/weighted/obj"]
    np.testing.assert_array_equal(mk, ref[f"{name}/jax/weighted/mk"])
    T = problems[name].num_tasks
    bound = (T - 1) * 2.0**-24 * np.abs(ref_obj.astype(np.float64)) + np.spacing(np.abs(ref_obj))
    assert (np.abs(obj.astype(np.float64) - ref_obj) <= bound).all()


def test_constraints_reach_the_objective(cases):
    """Deadline lateness and budget overage are counted, each as the
    reference counts them, on the constrained problem."""
    problems, assignments, _, _, ref = cases
    spec = SPECS[-1]
    name = ref_harness.name_of(spec)
    obj, mk = _port(problems[name], assignments[name], "torch", "fixed")
    penalties = np.round((obj - ALPHA * problems[name].cores.sum() - BETA * mk) / 1e9)
    assert penalties.max() >= 2  # late tasks and an overspent workflow
    np.testing.assert_array_equal(obj, ref[f"{name}/jax/fixed/obj"])


def test_batched_fitness_matches_reference_batch(cases):
    """One batched call over the stacked family equals the reference's
    vmapped batch and each instance alone."""
    problems, assignments, batch, fitness, ref = cases
    assert list(fitness.bucket) == ref["batch/bucket"].tolist()
    obj, mk = fitness(torch.from_numpy(batch))
    np.testing.assert_array_equal(obj.numpy(), ref["batch/obj"])
    np.testing.assert_array_equal(mk.numpy(), ref["batch/mk"])
    for b, name in enumerate(IDS):
        one_obj, one_mk = _port(problems[name], assignments[name], "torch", "fixed")
        np.testing.assert_array_equal(mk[b].numpy(), one_mk)


def test_registry_resolves_auto_by_device(cases):
    """``auto`` is the kernel's engine on every device; the device alone then
    picks the implementation inside the kernel's wrapper (the plain version
    here on the CPU, with no kernel launch)."""
    assert {"oracle", "torch", "cuda"} <= set(ENGINES.names())
    assert resolve_engine("auto") == resolve_engine("") == "cuda"
    assert resolve_engine("numpy") == "oracle"
    assert ENGINES.get("auto").name == "cuda"
    with pytest.raises(KeyError, match="unknown engine"):
        ENGINES.get("pallas")
    problems, assignments, _, _, ref = cases
    name = IDS[1]
    before = population_makespan_cuda.launches
    obj, mk = _port(problems[name], assignments[name], "auto", "fixed")
    assert population_makespan_cuda.launches == before
    np.testing.assert_array_equal(obj, ref[f"{name}/jax/fixed/obj"])
    np.testing.assert_array_equal(mk, ref[f"{name}/jax/fixed/mk"])


def test_oracle_has_no_batched_path(cases):
    problems = list(cases[0].values())
    with pytest.raises(ValueError, match="batched"):
        batched_population_fitness_fn(problems, engine="oracle", device="cpu")


def test_register_engine_plugs_into_fitness_routing():
    calls = []

    @register_engine("counting-test", overwrite=True)
    class Counting(ScheduleEngine):
        def population_fitness(self, problem, weights=None, *, core_cap=None, device="cuda"):
            inner = ENGINES.get("torch").population_fitness(problem, weights, device=device)

            def fitness(a):
                calls.append(1)
                return inner(a)

            return fitness

    try:
        prob = ref_harness.build(SPECS[0], sm, wm)
        A = np.zeros((2, prob.num_tasks), np.int32) + 2
        obj, mk = population_fitness_fn(prob, engine="counting-test", device="cpu")(A)
        assert calls and mk.shape == (2,)
    finally:
        ENGINES.unregister("counting-test")


def _f32_round(q):
    """The f32 nearest the rational ``q``, ties to even (exact reference)."""
    from fractions import Fraction

    f = np.float32(float(q))
    cands = [f, np.nextafter(f, np.float32(np.inf)), np.nextafter(f, np.float32(-np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - q), int(c.view(np.int32)) & 1))


def test_fma_rounds_once_like_a_fused_multiply_add():
    """``_fma`` equals the exact ``x*y + z`` rounded once to f32, where the
    f64 sum is inexact too: the first case's f64 sum lands on a midpoint
    of f32 values (2**24 + 1), which a second rounding would send to even
    (2**24) though the exact sum lies above it.  The sweep mixes objective
    magnitudes of a Table IX run (usage 1e3-1e4 weighted by alpha, makespans
    of 10-1e3 by beta, BIG_PENALTY counts) with random exponents."""
    from fractions import Fraction

    x = float(np.float32(1 + 2**-12))
    y = np.array([1 - 2**-12 + 2**-24], np.float32)
    z = np.array([2**24], np.float32)
    assert float(np.float32(x * np.float64(y[0]) + np.float64(z[0]))) == 2**24  # twice rounded
    got = _fma(x, torch.from_numpy(y), torch.from_numpy(z)).numpy()
    assert got[0] == np.float32(2**24 + 2)

    rng = np.random.default_rng(0)
    n = 4000
    xs = np.float32(rng.uniform(0.01, 1.0, n)) * np.float32(2.0) ** rng.integers(-30, 30, n)
    ys = np.concatenate([
        np.float32(rng.uniform(1e3, 1e4, n // 2)),
        np.float32(rng.uniform(-1, 1, n // 2)) * np.float32(2.0) ** rng.integers(-40, 40, n // 2),
    ])
    zs = np.concatenate([
        np.float32(rng.uniform(10, 1e3, n // 2)),
        np.float32(rng.uniform(-1, 1, n // 2)) * np.float32(2.0) ** rng.integers(-40, 40, n // 2),
    ]).astype(np.float32)
    for x, y, z in zip(xs[:200], ys.reshape(200, -1), zs.reshape(200, -1)):
        got = _fma(float(x), torch.from_numpy(y), torch.from_numpy(z)).numpy()
        want = [_f32_round(Fraction(float(x)) * Fraction(float(b)) + Fraction(float(c)))
                for b, c in zip(y, z)]
        np.testing.assert_array_equal(got, np.array(want, np.float32))
