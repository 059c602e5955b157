"""The port's ML-job continuum (``configs/shapes``, ``core/autoshard``,
``core/continuum``, ``system_model.tpu_fleet``) against the JAX package's.

The reference's ``repro.core`` does not import here, so its side runs in a
child process (``tests/torch_reference.py``, job ``continuum``).  Everything
here is host arithmetic copied in the reference's order, so every number is
held bit for bit: the roofline estimates, KV bytes and best layouts of each
arch and applicable shape, the fleets, the job durations with their
infinities (a job that does not fit a slice's HBM), the packed problem, the
HEFT schedules, the GA fed the reference's exact draws, the step workflows
and the job scenario's JSON and run summary.  The solvers run on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import torch_reference as ref_harness
from repro_torch.configs.shapes import SHAPES, applicable_shapes
from repro_torch.core import api, autoshard, continuum, system_model as sm, tpu_fleet, verify_schedule
from repro_torch.core import workload_model as wm
from repro_torch.core.heuristics import heft
from repro_torch.core.metaheuristics import ArrayDraws
from repro_torch.engine.packed import pack
from repro_torch.models.registry import ALL_ARCHS, get_model
from repro_torch.serve import kvcache

LAYOUTS = [{"dp": 16, "tp": 8, "pods": 2}, {"dp": 32, "tp": 4, "pods": 2, "compress_dcn": True},
           {"dp": 64, "tp": 1, "fsdp": False}]
BEST = [{}, {"chips": 64, "pods": 2}, {"chips": 16, "hbm_per_chip": 1e9}]  # the last: nothing fits
FLEETS = [{}, {"num_pods": 3, "slices_per_pod": 8}, {"num_pods": 1, "chips_per_pod": 64, "slices_per_pod": 2}]
MIXED = [[128, "ici"], [16, "ici"], [4, "dcn"], [64, "ici"], [8, "ici"]]  # some jobs fit only some slices
GA = {"seed": 5, "pop_size": 16, "generations": 6, "tournament": 3, "mutation_rate": 0.1, "elite": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The GA and the solvers run many small ops; with the several pytest
    workers a test run starts side by side, each op's intra-op thread team
    waits on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    return ref_harness.run("continuum", {"archs": list(ALL_ARCHS), "layouts": LAYOUTS, "best": BEST,
                                         "fleets": FLEETS, "mixed": MIXED, "ga": GA}, timeout=600)


def _fleets():
    fleets = {f"fleet{i}": tpu_fleet(**kw) for i, kw in enumerate(FLEETS)}
    fleets["mixed"] = sm.make_system([sm.tpu_slice_node(f"s{i}", chips, fabric=fabric)
                                      for i, (chips, fabric) in enumerate(MIXED)])
    return fleets


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_estimates_kv_bytes_and_best_layouts_equal_reference(ref, arch):
    cfg = get_model(arch).config
    assert json.dumps(applicable_shapes(arch)) == str(ref[f"{arch}/shapes"])
    for shape in applicable_shapes(arch):
        suite, tag = SHAPES[shape], f"{arch}/{shape}"
        layouts = autoshard.enumerate_layouts(256, 1, train=suite.kind == "train")
        layouts += [autoshard.Layout(**kw) for kw in LAYOUTS]
        assert json.dumps([dataclasses.asdict(lay) for lay in layouts]) == str(ref[f"{tag}/layouts"])
        rows = []
        for lay in layouts:
            e = autoshard.estimate(cfg, suite, lay)
            rows.append([e.compute_s, e.memory_s, e.collective_s, e.hbm_per_chip, e.step_s])
        np.testing.assert_array_equal(np.array(rows, dtype=np.float64), ref[f"{tag}/estimates"])
        kv = autoshard.kv_cache_bytes(cfg, suite.global_batch, suite.seq_len)
        assert kv == float(ref[f"{tag}/kv"])
        for i, kw in enumerate(BEST):
            lay, e = autoshard.best_layout(cfg, suite, **kw)
            got = [dataclasses.asdict(lay), [e.compute_s, e.memory_s, e.collective_s, e.hbm_per_chip], e.bottleneck]
            assert json.dumps(got) == str(ref[f"{tag}/best/{i}"]), (shape, kw)


def test_kv_cache_bytes_has_one_owner():
    """``serve/kvcache.py`` re-exports the cost model's count, as the
    reference's does."""
    assert kvcache.kv_cache_bytes is autoshard.kv_cache_bytes


@pytest.mark.parametrize("name", ["fleet0", "fleet1", "fleet2", "mixed"])
def test_fleets_durations_and_packed_problems_equal_reference(ref, name):
    """The fleet's nodes and rates, each job's duration on each slice (inf
    where it does not fit), the workload and its packed arrays, bit for
    bit; and HEFT's schedule of it."""
    system = _fleets()[name]
    assert json.dumps(sm.system_to_json(system)) == str(ref[f"{name}/system"])
    np.testing.assert_array_equal(system.dtr, ref[f"{name}/dtr"])
    jobs = continuum.default_job_mix()
    durations = continuum.job_durations(jobs, system)
    np.testing.assert_array_equal(durations, ref[f"{name}/durations"])
    workload = continuum.jobs_to_workload(jobs, system)
    assert json.dumps(wm.workload_to_json(workload)) == str(ref[f"{name}/workload"])
    prob = wm.build_problem(system, workload)
    for k, v in pack(prob, pad=False).numpy_arrays().items():
        r = ref[f"{name}/packed/{k}"]
        assert v.dtype == r.dtype, k
        np.testing.assert_array_equal(v, r, err_msg=k)
    sched = heft(prob)
    np.testing.assert_array_equal(sched.assignment, ref[f"{name}/heft/assignment"])
    assert sched.makespan == float(ref[f"{name}/heft/makespan"])
    if name == "mixed":
        assert np.isinf(durations).any() and np.isfinite(durations).any(axis=1).all()
        assert np.isfinite(sched.makespan) and verify_schedule(prob, sched) == []


def test_tpu_fleet_structure():
    """The reference's tests/test_system.py::test_tpu_fleet_structure on
    the port: 2 pods x 4 slices of 64 chips, ICI within a pod, DCN between."""
    system = tpu_fleet(num_pods=2, chips_per_pod=256, slices_per_pod=4)
    assert system.num_nodes == 8
    assert all(n.cores == 64 for n in system.nodes)
    assert system.dtr[0, 1] == sm.TPU_V5E_ICI_BW * 32 and system.dtr[0, 4] == sm.DCN_BW
    assert np.isinf(np.diag(system.dtr)).all()
    assert all(n.provides({"F9", "F10"}) for n in system.nodes)


def test_schedule_jobs_heft_equals_reference(ref):
    rep, system = continuum.schedule_jobs(technique="heft", device="cpu")
    np.testing.assert_array_equal(rep.schedule.assignment, ref["schedule/heft/assignment"])
    assert rep.schedule.makespan == float(ref["schedule/heft/makespan"])
    assert system.num_nodes == 8 and verify_schedule(rep.problem, rep.schedule) == []


def test_schedule_jobs_ga_from_the_reference_draws(ref):
    """The job mix's GA, fed the draws the reference's ``schedule_jobs(
    technique="ga")`` made: the same best assignment, history and makespan."""
    opts = {k: v for k, v in GA.items() if k != "seed"}
    keys = ("initial", "cand", "xmask", "mmask", "fresh")
    draws = ArrayDraws(*(ref[f"schedule/ga/draws/{k}"][None] for k in keys), device="cpu")
    rep, _ = continuum.schedule_jobs(technique="ga", device="cpu", draws=draws, seed=GA["seed"], **opts)
    np.testing.assert_array_equal(rep.schedule.assignment, ref["schedule/ga/assignment"])
    np.testing.assert_array_equal(rep.history, ref["schedule/ga/history"])
    assert rep.schedule.makespan == float(ref["schedule/ga/makespan"])
    assert verify_schedule(rep.problem, rep.schedule) == []


@pytest.mark.parametrize("technique", ["ga", "auto"])
def test_schedule_jobs_on_the_cpu_gives_valid_schedules(technique):
    rep, _ = continuum.schedule_jobs(technique=technique, device="cpu", seed=0)
    assert verify_schedule(rep.problem, rep.schedule) == []
    assert np.isfinite(rep.schedule.makespan)
    assert rep.schedule.technique == ("ga" if technique == "ga" else "milp[event]")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_training_step_workflow_equals_reference(ref, arch):
    wf = continuum.training_step_workflow(arch)
    assert json.dumps(wm.workload_to_json(wm.Workload((wf,)))) == str(ref[f"{arch}/step"])


@pytest.mark.parametrize("technique", ["auto", "heft"])
def test_jobs_scenario_equals_reference(ref, technique, tmp_path):
    """The job scenario's JSON and fingerprint, and its run through the
    ``Orchestrator``: with HEFT, summary for summary; with ``auto`` (the
    policy routes 8 jobs to the MILP) both packages refuse to execute the
    plan with the same message, a fault of the reference that the port
    reproduces (ROADMAP Queue C)."""
    sc = continuum.jobs_scenario(technique=technique)
    tag = f"scenario/{technique}"
    assert json.dumps(sc.to_json(), indent=2) == str(ref[f"{tag}/json"])
    assert sc.fingerprint() == str(ref[f"{tag}/fingerprint"])
    run = []
    assert ref_harness._error_of(
        lambda: run.append(api.Orchestrator(sc, out_dir=tmp_path, device="cpu").run())) == str(ref[f"{tag}/error"])
    if technique == "auto":
        assert str(ref[f"{tag}/error"]).startswith("ValueError: refusing to execute invalid schedule")
        return
    summary = run[0].summary()
    summary.pop("artifacts", None)
    assert json.dumps(summary, sort_keys=True) == str(ref[f"{tag}/summary"])
