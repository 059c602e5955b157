"""The port's makespan function and select primitive against the JAX
package's: the plain PyTorch version equals the reference's jnp oracle and
its Pallas kernel (interpret mode) bit for bit, with and without deadlines.

In process, only ``repro.kernels.{select,ref}`` is imported from the
reference.  Its Pallas kernel needs a patch on this JAX and runs in a child
process (tests/torch_reference.py).  Problems are built and packed with the
port's model layer, which tests/test_torch_model.py holds to the
reference's arrays."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_reference as ref_harness
from hypothesis import given, settings
from hypothesis import strategies as st
from repro.kernels import select as jselect
from repro.kernels.ref import population_makespan_ref as jax_makespan_ref

from repro_torch.core import (
    Workload,
    build_problem,
    mri_system,
    mri_workload,
    random_layered_workflow,
    synthetic_system,
)
from repro_torch.engine import pack, stack_packed
from repro_torch.kernels import _build, select
from repro_torch.kernels.makespan import population_makespan_cuda, population_makespan_ref

KEYS = ("durations", "cores", "data", "feasible", "release", "pred_matrix", "dtr", "init_free")


def _problem(num_tasks, num_nodes, seed):
    if num_tasks == 0:
        return build_problem(mri_system(), mri_workload())
    wf = random_layered_workflow(num_tasks, seed=seed, max_cores=8)
    return build_problem(synthetic_system(num_nodes, seed=seed), Workload((wf,)))


def _both(A, arrays, deadline=None):
    """(port plain, reference jnp oracle) results on the same inputs."""
    mk, v = population_makespan_ref(
        torch.from_numpy(A), **{k: torch.from_numpy(np.array(arrays[k])) for k in KEYS},
        deadline=None if deadline is None else torch.from_numpy(np.array(deadline)),
    )
    rmk, rv = jax_makespan_ref(
        jnp.asarray(A), **{k: jnp.asarray(arrays[k]) for k in KEYS},
        deadline=None if deadline is None else jnp.asarray(deadline),
    )
    return (mk.numpy(), v.numpy()), (np.asarray(rmk), np.asarray(rv))


CASES = [  # (num_tasks (0: MRI), num_nodes, seed, pop, deadlines)
    (t, n, s, p, dl)
    for (t, n, s, p) in [(0, 3, 0, 8), (5, 2, 1, 4), (12, 4, 2, 8), (24, 6, 3, 8), (40, 8, 4, 4)]
    for dl in (False, True)
]
CASE_IDS = [f"{t}x{n}-seed{s}-pop{p}" + ("-deadlines" if dl else "") for t, n, s, p, dl in CASES]


def _case_inputs(num_tasks, num_nodes, seed, pop, deadlines):
    """Packed arrays, numpy-seeded assignments and, when asked, deadlines
    that some tasks of those assignments miss."""
    prob = _problem(num_tasks, num_nodes, seed)
    packed = pack(prob, pad=False).numpy_arrays()
    arrays = {k: packed[k] for k in KEYS}
    rng = np.random.default_rng(seed)
    arrays["assignments"] = rng.integers(0, prob.num_nodes, (pop, prob.num_tasks)).astype(np.int32)
    if deadlines:
        horizon = float(arrays["durations"].sum(axis=0).min())
        arrays["deadline"] = rng.uniform(0.0, horizon, prob.num_tasks).astype(np.float32)
    return arrays


@pytest.fixture(scope="module")
def pallas_results():
    """The reference Pallas kernel (interpret mode) on every case."""
    inputs = {}
    for case_id, case in zip(CASE_IDS, CASES):
        arrays = _case_inputs(*case)
        inputs.update({f"{case_id}/{k}": v for k, v in arrays.items()})
    return ref_harness.run("pallas", {"cases": CASE_IDS, "tile": 4}, inputs)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_matches_reference_oracle_and_pallas(case, pallas_results):
    arrays = _case_inputs(*case)
    A, dl = arrays["assignments"], arrays.get("deadline")
    mine, oracle = _both(A, arrays, dl)
    case_id = CASE_IDS[CASES.index(case)]
    pallas = pallas_results[f"{case_id}/makespan"], pallas_results[f"{case_id}/violations"]
    for ref in (oracle, pallas):
        np.testing.assert_array_equal(mine[0], ref[0])
        np.testing.assert_array_equal(mine[1], ref[1])
    if dl is not None and case[0]:
        _, no_dl = _both(A, arrays)
        assert (oracle[1] > no_dl[1]).any()  # some deadline was missed


@st.composite
def _random_instance(draw):
    """Arrays straight from a numpy seed, with ties in the core-free rows,
    dead links, zero-capacity nodes and data/rate quotients that round."""
    T = draw(st.integers(1, 10))
    N = draw(st.integers(1, 5))
    C = draw(st.integers(1, 8))
    maxp = draw(st.integers(1, 3))
    P = draw(st.integers(1, 6))
    rng = np.random.default_rng(draw(st.integers(0, 2**31)))
    preds = -np.ones((T, maxp), np.int32)
    for j in range(1, T):
        k = rng.integers(0, min(j, maxp) + 1)
        preds[j, :k] = rng.choice(j, size=k, replace=False)
    dtr = rng.choice([0.3, 1.7, 10.0, 1e30], size=(N, N)).astype(np.float32)
    init_free = np.full((N, C), 1e30, np.float32)
    for i in range(N):
        init_free[i, : rng.integers(0, C + 1)] = rng.choice([0.0, 1.0, 2.5], size=1)
    arrays = {
        "durations": rng.choice([0.0, 0.7, 1.0, 3.3], size=(T, N)).astype(np.float32),
        "cores": rng.integers(1, C + 1, T).astype(np.int32),
        "data": rng.choice([0.0, 1.0, 2.9], size=T).astype(np.float32),
        "feasible": rng.random((T, N)) < 0.8,
        "release": rng.choice([0.0, 0.5, 4.0], size=T).astype(np.float32),
        "pred_matrix": preds,
        "dtr": dtr,
        "init_free": init_free,
    }
    A = rng.integers(0, N, (P, T)).astype(np.int32)
    deadline = rng.uniform(0, 10, T).astype(np.float32) if draw(st.booleans()) else None
    return A, arrays, deadline


@settings(max_examples=12, deadline=None)
@given(_random_instance())
def test_plain_matches_reference_oracle_on_random_shapes(case):
    A, arrays, deadline = case
    mine, oracle = _both(A, arrays, deadline)
    np.testing.assert_array_equal(mine[0], oracle[0])
    np.testing.assert_array_equal(mine[1], oracle[1])


@settings(max_examples=15, deadline=None)
@given(
    st.integers(1, 16),
    st.integers(1, 3),
    st.integers(0, 2**31),
)
def test_select_matches_reference(C, rows, seed):
    rng = np.random.default_rng(seed)
    row = rng.choice([0.0, 1.0, 2.0, 1e30], size=(rows, C)).astype(np.float32)  # many ties
    c = rng.integers(1, C + 1, rows)
    fill = rng.uniform(0, 3, rows).astype(np.float32)
    ranks = select.stable_ranks(torch.from_numpy(row))
    jranks = jselect.stable_ranks(jnp.asarray(row))
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jranks))
    stable_order = np.argsort(row, axis=-1, kind="stable")
    np.testing.assert_array_equal(ranks.numpy(), np.argsort(stable_order, axis=-1).astype(np.float32))
    kth = select.kth_from_ranks(torch.from_numpy(row), ranks, torch.from_numpy(c))
    np.testing.assert_array_equal(kth.numpy(), np.asarray(jselect.kth_from_ranks(jnp.asarray(row), jranks, jnp.asarray(c))))
    np.testing.assert_array_equal(kth.numpy(), np.sort(row, -1)[np.arange(rows), c - 1])
    upd = select.update_from_ranks(torch.from_numpy(row), ranks, torch.from_numpy(c), torch.from_numpy(fill))
    jupd = jselect.update_from_ranks(jnp.asarray(row), jranks, jnp.asarray(c), jnp.asarray(fill))
    np.testing.assert_array_equal(upd.numpy(), np.asarray(jupd))


def test_batched_family_equals_each_instance():
    """A stacked family ([B, P, T], padded to one bucket) gives each
    instance's own results."""
    probs = [_problem(0, 3, 0), _problem(12, 4, 2), _problem(24, 6, 3)]
    arrays, bucket = stack_packed(probs, device="cpu")
    rng = np.random.default_rng(7)
    A = np.zeros((len(probs), 6, bucket[0]), np.int32)
    for b, p in enumerate(probs):
        A[b, :, : p.num_tasks] = rng.integers(0, p.num_nodes, (6, p.num_tasks))
    mk, v = population_makespan_ref(
        torch.from_numpy(A), **{k: arrays[k] for k in KEYS},
        node_cores=arrays["node_cores"],
    )
    for b, p in enumerate(probs):
        one = pack(p, pad=False).device_arrays("cpu")
        mk1, v1 = population_makespan_ref(
            torch.from_numpy(A[b, :, : p.num_tasks]), **{k: one[k] for k in KEYS}
        )
        np.testing.assert_array_equal(mk[b].numpy(), mk1.numpy())
        np.testing.assert_array_equal(v[b].numpy(), v1.numpy())


def test_dispatch_sends_cpu_tensors_to_the_plain_version():
    """The kernel's wrapper runs the plain version on CPU tensors, and only
    then; no kernel launch is counted."""
    prob = _problem(12, 4, 2)
    arrays = pack(prob, pad=False).device_arrays("cpu")
    A = torch.from_numpy(np.random.default_rng(0).integers(0, 4, (5, 12)).astype(np.int32))
    before = population_makespan_cuda.launches
    mk, v = population_makespan_cuda(A, **{k: arrays[k] for k in KEYS})
    mk_ref, v_ref = population_makespan_ref(A, **{k: arrays[k] for k in KEYS})
    assert torch.equal(mk, mk_ref) and torch.equal(v, v_ref)
    assert population_makespan_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    """On the CPU the wrapper holds its inputs to the kernel's contract as
    on the card: other types, shapes or devices are refused, not converted."""
    prob = _problem(5, 2, 1)
    arrays = pack(prob, pad=False).device_arrays("cpu")
    kw = {k: arrays[k] for k in KEYS}
    A = torch.zeros(3, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        population_makespan_cuda(A.long(), **kw)
    with pytest.raises(ValueError, match="dtr"):
        population_makespan_cuda(A, **{**kw, "dtr": kw["dtr"].double()})
    with pytest.raises(ValueError, match="shape"):
        population_makespan_cuda(A, **{**kw, "release": kw["release"][:-1]})
    with pytest.raises(ValueError, match="CUDA or CPU"):
        population_makespan_cuda(A.to("meta"), **{k: v.to("meta") for k, v in kw.items()})


def test_build_raises_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.nvcc()


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.sources() == ["makespan"]
    with pytest.raises(_build.KernelBuildError, match="refused"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))
