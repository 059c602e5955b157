"""The port's GA against the JAX package's: fed the reference's exact
``jax.random`` draws (rebuilt in a child process with the same key splits,
tests/torch_reference.py), ``_ga_loop``, ``ga`` and ``ga_sweep`` reproduce
the reference's best assignments and histories bit for bit."""

import numpy as np
import pytest
import torch

import torch_reference as ref_harness
from repro_torch.core import ga, ga_sweep, system_model as sm, verify_schedule, workload_model as wm
from repro_torch.core.metaheuristics import ArrayDraws, TorchDraws, _ga_loop, _mask_logits
from repro_torch.engine import population_fitness_fn

SPECS = [
    {"kind": "mri", "ga_seed": 0},
    {"kind": "layered", "tasks": 12, "nodes": 5, "seed": 2, "ga_seed": 3},
    {"kind": "layered", "tasks": 24, "nodes": 6, "seed": 3, "ga_seed": 7},
]
IDS = [ref_harness.name_of(s) for s in SPECS]
OPTS = {"pop_size": 16, "generations": 8, "tournament": 3, "mutation_rate": 0.1, "elite": 2}
SWEEP_SEED = 11


def _problem(spec):
    return ref_harness.build(spec, sm, wm)


@pytest.fixture(scope="module")
def ref():
    return ref_harness.run("ga", {"specs": SPECS, "sweep_seed": SWEEP_SEED, **OPTS})


def _draws(ref, prefix):
    d = {k: ref[f"{prefix}/draws/{k}"][None] for k in ("initial", "cand", "xmask", "mmask", "fresh")}
    return ArrayDraws(d["initial"], d["cand"], d["xmask"], d["mmask"], d["fresh"], device="cpu")


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_ga_loop_reproduces_reference(ref, spec):
    name = ref_harness.name_of(spec)
    fitness = population_fitness_fn(_problem(spec), engine="torch", device="cpu")

    def family_of_one(pop):
        obj, mk = fitness(pop[0])
        return obj[None], mk[None]

    best, hist = _ga_loop(
        family_of_one, _draws(ref, name), generations=OPTS["generations"], elite=OPTS["elite"]
    )
    np.testing.assert_array_equal(best[0].numpy(), ref[f"{name}/best"])
    np.testing.assert_array_equal(hist[0].numpy(), ref[f"{name}/history"])


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_ga_reproduces_reference_schedule(ref, spec):
    name = ref_harness.name_of(spec)
    prob = _problem(spec)
    res = ga(prob, device="cpu", draws=_draws(ref, name), seed=spec["ga_seed"], **OPTS)
    np.testing.assert_array_equal(res.schedule.assignment, ref[f"{name}/best"])
    np.testing.assert_array_equal(res.history, ref[f"{name}/history"])
    assert res.schedule.makespan == float(ref[f"{name}/makespan"])
    assert verify_schedule(prob, res.schedule) == []


def test_ga_sweep_reproduces_reference_family(ref):
    problems = [_problem(s) for s in SPECS]
    keys = ("initial", "cand", "xmask", "mmask", "fresh")
    stacked = {k: np.stack([ref[f"sweep/{b}/draws/{k}"] for b in range(len(problems))]) for k in keys}
    draws = ArrayDraws(*(stacked[k] for k in keys), device="cpu")
    results = ga_sweep(problems, device="cpu", draws=draws, seed=SWEEP_SEED, **OPTS)
    for b, res in enumerate(results):
        np.testing.assert_array_equal(res.schedule.assignment, ref[f"sweep/{b}/best"])
        np.testing.assert_array_equal(res.history, ref[f"sweep/{b}/history"])


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_default_draws_give_valid_improving_schedules(spec):
    prob = _problem(spec)
    res = ga(prob, device="cpu", seed=1, **OPTS)
    assert verify_schedule(prob, res.schedule) == []
    assert res.history.shape == (OPTS["generations"],)
    assert (np.diff(res.history) <= 0).all()  # elitism: the best never gets worse


def test_default_sweep_gives_valid_schedules():
    problems = [_problem(s) for s in SPECS]
    results = ga_sweep(problems, device="cpu", seed=2, **OPTS)
    for prob, res in zip(problems, results):
        assert verify_schedule(prob, res.schedule) == []
        assert res.schedule.assignment.shape == (prob.num_tasks,)


def test_torch_draws_sample_only_samplable_nodes():
    prob = _problem(SPECS[2])
    logits = _mask_logits(prob, "cpu")[None]
    draws = TorchDraws(logits, pop_size=64, tournament=3, mutation_rate=0.1, seed=0)
    pop = draws.initial()
    assert pop.shape == (1, 64, prob.num_tasks) and pop.dtype == torch.int32
    samplable = logits[0] == 0
    assert samplable[torch.arange(prob.num_tasks), pop[0]].all()
    cand, xmask, mmask, fresh = draws.generation(0)
    assert cand.shape == (1, 2, 64, 3) and int(cand.min()) >= 0 and int(cand.max()) < 64
    assert samplable[torch.arange(prob.num_tasks), fresh[0]].all()
    assert 0.02 < float(mmask.float().mean()) < 0.2 and 0.4 < float(xmask.float().mean()) < 0.6
    # every samplable node of a task gets drawn, about equally often
    counts = torch.bincount(pop[0, :, 0].long(), minlength=prob.num_nodes)
    assert (counts[samplable[0]] > 0).all()


def test_default_device_is_cuda_not_a_hidden_cpu_path():
    """Without a CUDA device, ``ga`` on its default device raises rather
    than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    prob = _problem(SPECS[0])
    with pytest.raises((RuntimeError, AssertionError)):
        ga(prob, **OPTS)
    with pytest.raises((RuntimeError, AssertionError)):
        population_fitness_fn(prob)
