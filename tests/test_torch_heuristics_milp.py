"""The port's HEFT, OLB and exact MILP against the JAX package's: the same
problem gives identical assignments, start and finish times and makespans.
All three are host solvers in both packages (numpy, and scipy's HiGHS with
the same constraint rows in the same order)."""

import numpy as np
import pytest
import torch

import torch_reference as ref_harness
from repro_torch.core import system_model as sm, verify_schedule, workload_model as wm
from repro_torch.core.heuristics import heft, olb, upward_ranks
from repro_torch.core.milp import MilpSizeError, solve_milp

H_SPECS = [
    {"kind": "mri"},
    {"kind": "synthetic", "tasks": 40, "nodes": 10, "seed": 1},
    {"kind": "synthetic", "tasks": 30, "nodes": 8, "seed": 7},
    {"kind": "constrained", "tasks": 20, "nodes": 8, "seed": 5, "deadline": 9.0, "budget": 120.0},
]
M_SPECS = [
    {"kind": "mri"},
    {"kind": "layered", "tasks": 8, "nodes": 4, "seed": 4},
    {"kind": "synthetic", "tasks": 10, "nodes": 4, "seed": 1},
]
MODES = ("event", "static")
H_IDS = [ref_harness.name_of(s) for s in H_SPECS]
M_IDS = [ref_harness.name_of(s) for s in M_SPECS]


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
def href():
    return ref_harness.run("heuristics", {"specs": H_SPECS})


@pytest.fixture(scope="module")
def mref():
    return ref_harness.run("milp", {"specs": M_SPECS, "modes": list(MODES)})


def _same_schedule(s, ref, prefix):
    np.testing.assert_array_equal(s.assignment, ref[f"{prefix}/assignment"])
    np.testing.assert_array_equal(s.start, ref[f"{prefix}/start"])
    np.testing.assert_array_equal(s.finish, ref[f"{prefix}/finish"])
    np.testing.assert_array_equal(
        [s.makespan, s.usage, s.objective, s.violations], ref[f"{prefix}/stats"]
    )


@pytest.mark.parametrize("fn", [heft, olb], ids=["heft", "olb"])
@pytest.mark.parametrize("spec", H_SPECS, ids=H_IDS)
def test_heuristics_reproduce_reference(href, spec, fn):
    name = ref_harness.name_of(spec)
    s = fn(_problem(spec))
    _same_schedule(s, href, f"{name}/{fn.__name__}")
    assert s.technique == fn.__name__


@pytest.mark.parametrize("spec", H_SPECS, ids=H_IDS)
def test_upward_ranks_match(href, spec):
    np.testing.assert_array_equal(upward_ranks(_problem(spec)), href[f"{ref_harness.name_of(spec)}/ranks"])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spec", M_SPECS, ids=M_IDS)
def test_milp_reproduces_reference(mref, spec, mode):
    name = ref_harness.name_of(spec)
    prob = _problem(spec)
    s = solve_milp(prob, capacity_mode=mode)
    assert s.status == str(mref[f"{name}/{mode}/status"])
    _same_schedule(s, mref, f"{name}/{mode}")
    if mode == "event":
        assert verify_schedule(prob, s) == []


def test_milp_mri_makespan_is_ten(mref):
    """Table VI: the exact MRI optimum is 10 s.  The oracle's float64
    re-timing lands one ulp above it (10.000000000000002) in both
    packages; the port equals the reference bit for bit."""
    s = solve_milp(_problem(M_SPECS[0]))
    assert s.status == "optimal"
    assert s.makespan == float(mref["mri/event/stats"][0])
    assert abs(s.makespan - 10.0) <= np.spacing(10.0)


def test_milp_refuses_oversized_instances():
    prob = _problem({"kind": "synthetic", "tasks": 61, "nodes": 4, "seed": 0})
    with pytest.raises(MilpSizeError):
        solve_milp(prob)
