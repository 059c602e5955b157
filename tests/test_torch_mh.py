"""The port's PSO, SA and ACO against the JAX package's: fed the
reference's exact ``jax.random`` draws (rebuilt in a child process with the
same key splits, tests/torch_reference.py), each reproduces the reference's
best assignment and history bit for bit.

Two ops are held within a bound instead of bit for bit: ``log`` (ACO's
sampling logits) and ``exp`` (SA's acceptance) are PyTorch's, which stay
within one f32 ulp of XLA's CPU polynomials.  A one-ulp change moves an
ACO sample only where two nodes' noisy logits tie to the last bit, and an
SA acceptance only where the uniform lands between the two values; neither
happens on these inputs, so the end-to-end checks stay exact.  In
``usage_mode="weighted"`` the objective sums T f32 usage shares in another
order than XLA's (the engine's stated bound, tests/test_torch_engine.py);
the history is held to that bound and the best assignment exactly."""

import numpy as np
import pytest
import torch

import torch_reference as ref_harness
from repro_torch.core import ObjectiveWeights, system_model as sm, verify_schedule, workload_model as wm
from repro_torch.core import metaheuristics as mh

SPECS = [
    {"kind": "mri", "mh_seed": 0},
    {"kind": "layered", "tasks": 24, "nodes": 6, "seed": 3, "mh_seed": 5},
    {"kind": "constrained", "tasks": 20, "nodes": 8, "seed": 5, "deadline": 9.0,
     "budget": 120.0, "mh_seed": 2},
    {"kind": "synthetic", "tasks": 40, "nodes": 10, "seed": 1, "mh_seed": 9,
     "usage_mode": "weighted"},
]
IDS = [ref_harness.name_of(s) for s in SPECS]
OPTS = {
    "pso": {"pop_size": 16, "iterations": 8},
    "sa": {"chains": 8, "steps": 10},
    "aco": {"ants": 12, "iterations": 8},
}
TECHS = ("pso", "sa", "aco")

rng = np.random.default_rng(0)
LOG_X = np.concatenate([
    rng.uniform(1e-6, 3.0, 20000), rng.uniform(0, 1, 20000) ** 8 + 1e-12,
]).astype(np.float32)
EXP_X = (-rng.exponential(3.0, 40000)).astype(np.float32)


POW_STEPS, COOLINGS = 400, (0.97, 0.9, 0.999)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These loops run thousands of small ops; with the several pytest
    workers a test run starts side by side, each op's intra-op thread team
    waits on the others' and the file takes ten times as long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(spec):
    return ref_harness.build(spec, sm, wm)


@pytest.fixture(scope="module")
def ref():
    """One child per technique, run side by side: each compiles the
    reference's scans for every spec, which takes most of this file's time."""
    from concurrent.futures import ThreadPoolExecutor

    params = {"specs": SPECS, "opts": OPTS, "pow_steps": POW_STEPS, "coolings": list(COOLINGS)}

    def one(tech):
        inputs = {"log_x": LOG_X, "exp_x": EXP_X} if tech == TECHS[0] else {}
        return ref_harness.run("mh", {**params, "techniques": [tech]}, inputs)

    with ThreadPoolExecutor(len(TECHS)) as pool:
        parts = list(pool.map(one, TECHS))
    return {k: v for part in parts for k, v in part.items()}


def _draws(ref, prefix, tech):
    d = lambda k: ref[f"{prefix}/{tech}/draws/{k}"]  # noqa: E731
    if tech == "pso":
        return mh.ArrayPSODraws(d("initial"), d("r1"), d("r2"), device="cpu")
    if tech == "sa":
        return mh.ArraySADraws(d("initial"), d("tsel"), d("newnode"), d("uniform"), device="cpu")
    return mh.ArrayACODraws(d("gumbel"), device="cpu")


@pytest.mark.parametrize("tech", TECHS)
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_reproduces_reference_best_and_history(ref, spec, tech):
    name = ref_harness.name_of(spec)
    prob = _problem(spec)
    w = ObjectiveWeights(usage_mode=spec.get("usage_mode", "fixed"))
    res = mh.TECHNIQUES[tech](
        prob, w, device="cpu", draws=_draws(ref, name, tech), seed=spec["mh_seed"], **OPTS[tech]
    )
    want = ref[f"{name}/{tech}/history"]
    np.testing.assert_array_equal(res.schedule.assignment, ref[f"{name}/{tech}/best"])
    assert res.history.dtype == want.dtype
    if w.usage_mode == "fixed":
        np.testing.assert_array_equal(res.history, want)
    else:
        # the weighted usage is a sum of T f32 shares, which XLA and PyTorch
        # add in different orders (tests/test_torch_engine.py states the bound)
        bound = (prob.num_tasks - 1) * 2.0**-24 * np.abs(want.astype(np.float64)) + np.spacing(np.abs(want))
        assert (np.abs(res.history.astype(np.float64) - want) <= bound).all()
    assert res.schedule.makespan == float(ref[f"{name}/{tech}/makespan"])
    assert res.schedule.technique == tech


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("op", ["log", "exp"])
def test_log_and_exp_within_one_ulp_of_xla(ref, op):
    """The bound held instead of bit identity: PyTorch's ``log``/``exp``
    against XLA's on the ranges the loops feed them (pheromone and
    desirability + 1e-12; negative Metropolis exponents).  They differ in
    the last bit on a share of inputs, never by more than one ulp."""
    x = LOG_X if op == "log" else EXP_X
    got = getattr(torch, op)(torch.from_numpy(x)).numpy()
    d = _ulps(got, ref[op])
    assert d.max() <= 1
    assert 0 < (d == 1).mean() < 0.2  # they do differ: the bound is not vacuous


@pytest.mark.parametrize("cooling", COOLINGS)
def test_cooling_factor_is_xlas_pow_bit_for_bit(ref, cooling):
    """SA's ``temp0 * cooling**it``: XLA's f32 ``pow`` is correctly rounded
    here, and the port takes it in f64 on the host, rounded once."""
    got = np.array([mh._cooling_factor(cooling, it) for it in range(POW_STEPS)], np.float32)
    np.testing.assert_array_equal(got, ref[f"pow/{cooling}"])


@pytest.mark.parametrize("n", [31, 32])
def test_median_is_the_mean_of_the_middle_pair(n):
    """SA's default temperature needs ``jnp.median``; ``torch.median``
    returns the lower middle value of an even count."""
    x = torch.from_numpy(np.random.default_rng(n).normal(size=n).astype(np.float32))
    s = np.sort(x.numpy())
    want = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / np.float32(2)
    assert mh._median(x).item() == want
    if n % 2 == 0:
        assert torch.median(x).item() != want


@pytest.mark.parametrize("tech", TECHS)
@pytest.mark.parametrize("spec", SPECS[:3], ids=IDS[:3])
def test_default_draws_give_valid_improving_schedules(spec, tech):
    prob = _problem(spec)
    res = mh.TECHNIQUES[tech](prob, device="cpu", seed=1, **OPTS[tech])
    assert np.all(np.diff(res.history) <= 0)
    assert np.isfinite(res.schedule.makespan)
    if spec["kind"] != "constrained":
        assert verify_schedule(prob, res.schedule) == []


@pytest.mark.parametrize("tech", TECHS)
def test_seed_fixes_the_run(tech):
    prob = _problem(SPECS[1])
    a = mh.TECHNIQUES[tech](prob, device="cpu", seed=4, **OPTS[tech])
    b = mh.TECHNIQUES[tech](prob, device="cpu", seed=4, **OPTS[tech])
    np.testing.assert_array_equal(a.schedule.assignment, b.schedule.assignment)
    np.testing.assert_array_equal(a.history, b.history)


def test_torch_draws_never_sample_an_infeasible_node():
    prob = _problem(SPECS[2])
    logits = mh._mask_logits(prob, "cpu")
    draws = mh.TorchSADraws(logits, chains=64, seed=0)
    feasible = torch.from_numpy(mh._safe_feasible(prob))
    init = draws.initial().long()
    assert feasible[torch.arange(prob.num_tasks)[None], init].all()
    for it in range(20):
        tsel, node, u = draws.step(it)
        assert feasible[tsel, node.long()].all()
        assert ((u >= 0) & (u < 1)).all()


def test_techniques_table_lists_the_four():
    assert set(mh.TECHNIQUES) == {"ga", "pso", "sa", "aco"}
