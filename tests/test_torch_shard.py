"""The port's multi-device instance axis (``repro_torch.engine.shard``)
against itself and against the JAX package's.

The port stripes one process's family over the local devices of a kind;
``REPRO_TORCH_VIRTUAL_DEVICES=k`` makes ``k`` stripes on one device, read at
each call, so the striped path runs here on the CPU.  Covered:

* in process, one stripe — shard-count and padding arithmetic, the
  one-device degenerate path (``shard="auto"`` is exactly the unsharded
  path), the per-stripe pack LRU and its collector, option plumbing, the
  ``REPRO_SHARD_DEVICES`` clamp and a forced count above the stripes;
* in process, 8 virtual CPU stripes — striped batched fitness bit-identical
  to the unsharded path and to the numpy oracle, the pad edge (3 stripes
  over 8 instances), ``ga_sweep`` at shard 8 and 3 equal to ``shard="off"``,
  residency on all 8 stripes, the admission batcher's ``sharded_groups``;
* a child process started with the variable set (as a user sets it);
* the reference's ``sharded_batched_fitness`` and ``ga_sweep(shard=...)``
  on 8 XLA CPU devices (``tests/torch_reference.py`` job ``shard``): the
  port's striped results equal them bit for bit.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_reference as ref_harness
from repro_torch import obs
from repro_torch.core import ObjectiveWeights, Workload, build_problem, synthetic_system
from repro_torch.core import system_model as sm
from repro_torch.core import workload_model as wm
from repro_torch.core.metaheuristics import ArrayDraws, ga, ga_sweep
from repro_torch.core.workload_model import random_layered_workflow
from repro_torch.engine import (
    ENGINES,
    choose_shards,
    instance_mesh,
    local_device_count,
    pack_cache,
    sharded_batched_fitness,
    stack_packed,
    stack_packed_sharded,
)
from repro_torch.engine.packed import _pack_cache_collector
from repro_torch.engine.shard import VIRTUAL_DEVICES_ENV, pad_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These loops run thousands of small ops; with the several pytest
    workers a test run starts side by side, each op's intra-op thread team
    waits on the others' and the file takes ten times as long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"


def _family(n, tasks=10, nodes=3, seed0=100):
    system = synthetic_system(nodes, seed=nodes)
    return [
        build_problem(
            system,
            Workload((random_layered_workflow(tasks, seed=seed0 + i, max_cores=4, feature_pool=("F1",)),)),
        )
        for i in range(n)
    ]


def _candidates(problems, pop, seed=0):
    rng = np.random.default_rng(seed)
    Tb = stack_packed(problems, device=CPU)[1][0]
    A = np.zeros((len(problems), pop, Tb), np.int32)
    T = problems[0].num_tasks
    A[:, :, :T] = rng.integers(0, problems[0].num_nodes, (len(problems), pop, T))
    return A


@pytest.fixture
def stripes8(monkeypatch):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")
    monkeypatch.delenv("REPRO_SHARD_DEVICES", raising=False)


# -----------------------------------------------------------------------------
# shard-count / padding arithmetic (counts passed explicitly)
# -----------------------------------------------------------------------------


def test_choose_shards_prefers_divisors():
    assert choose_shards(8, 8) == 8
    assert choose_shards(12, 8) == 6  # largest divisor <= fleet, zero pad
    assert choose_shards(16, 8) == 8
    assert choose_shards(9, 8) == 3


def test_choose_shards_small_batches_spread_one_per_device():
    assert choose_shards(6, 8) == 6
    assert choose_shards(2, 8) == 2


def test_choose_shards_degenerate_cases():
    assert choose_shards(0, 8) == 1
    assert choose_shards(1, 8) == 1
    assert choose_shards(64, 1) == 1


def test_choose_shards_falls_back_to_padding():
    assert choose_shards(5, 2) == 2  # pad 5 -> 6
    assert choose_shards(7, 4) == 4  # pad 7 -> 8


def test_pad_batch():
    assert pad_batch(5, 2) == 6
    assert pad_batch(7, 4) == 8
    assert pad_batch(8, 8) == 8
    assert pad_batch(3, 1) == 3
    assert pad_batch(8, 3) == 9


# -----------------------------------------------------------------------------
# one stripe: the unsharded path
# -----------------------------------------------------------------------------


def test_auto_shard_on_single_device_is_unsharded_path(monkeypatch):
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    assert local_device_count(CPU) == 1
    assert choose_shards(8, device=CPU) == 1
    problems = _family(4)
    auto = ENGINES.get("cuda").batched_fitness(problems, device=CPU)  # shard="auto"
    base = ENGINES.get("cuda").batched_fitness(problems, device=CPU, shard=None)
    assert auto.shards == 1 and base.shards == 1
    A = _candidates(problems, 6)
    for got, want in zip(auto(A), base(A)):
        assert torch.equal(got, want)


def test_cuda_kind_counts_the_cards(monkeypatch):
    """The ``cuda`` kind's stripes are the cards (none here): no stripe
    stands in for a card that is not there."""
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    assert local_device_count("cuda") == torch.cuda.device_count()
    assert choose_shards(8, device="cuda") == (1 if torch.cuda.device_count() <= 1 else choose_shards(8, torch.cuda.device_count()))
    with pytest.raises(ValueError, match="no instance stripes"):
        local_device_count("meta")


def test_sharded_stack_single_device_matches_stack_packed():
    problems = _family(3)
    stack = stack_packed_sharded(problems, device=CPU, use_cache=False)
    assert stack.shards == 1 and stack.instances == 3 and stack.padded == 3
    arrays, bucket = stack_packed(problems, device=CPU)
    assert stack.bucket == bucket
    for k, v in arrays.items():
        assert torch.equal(stack.arrays[0][k], v)


def test_sharded_fitness_rejects_wrong_instance_count():
    problems = _family(3)
    fitness = sharded_batched_fitness(problems, shards=1, device=CPU)
    with pytest.raises(ValueError, match="instance rows"):
        fitness(np.zeros((2, 4, fitness.bucket[0]), np.int32))


def test_forced_shard_count_above_the_stripes_raises(monkeypatch):
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    problems = _family(4)
    with pytest.raises(ValueError, match="mesh wants 2 devices, have 1"):
        ENGINES.get("cuda").batched_fitness(problems, device=CPU, shard=2)
    with pytest.raises(ValueError, match="mesh wants 0 devices"):
        instance_mesh(0, CPU)


def test_kernel_plans_and_launches_on_the_card_of_its_tensors(monkeypatch):
    """The makespan library plans and launches on the current device, so the
    wrapper makes its tensors' card current for both: a stripe on a second
    card launches there, whichever card was current.  No card here: the
    device switch, the plan and the launch are stand-ins that record it."""
    from types import SimpleNamespace

    from repro_torch.kernels import makespan as makespan_mod

    current, seen = ["cuda:0"], []

    class Current:
        def __init__(self, device):
            self.device = str(torch.device(device))

        def __enter__(self):
            self.prev, current[0] = current[0], self.device

        def __exit__(self, *exc):
            current[0] = self.prev

    def plan(B, P, T, N, C, index):
        seen.append(("plan", current[0], (B, P, T, N, C, index)))
        return "plan"

    def launch(a, arr, p):
        seen.append(("launch", current[0], p))
        return "makespan", "violations"

    monkeypatch.setattr(torch.cuda, "device", Current)
    monkeypatch.setattr(makespan_mod, "_plan", plan)
    monkeypatch.setattr(makespan_mod, "_launch", launch)
    a = SimpleNamespace(shape=(2, 3, 5), device=torch.device("cuda", 1))
    out = makespan_mod._on_card(a, {"init_free": torch.zeros(2, 4, 8)})
    assert out == ("makespan", "violations")
    assert seen == [("plan", "cuda:1", (2, 3, 5, 4, 8, 1)), ("launch", "cuda:1", "plan")]
    assert current == ["cuda:0"]


def test_pack_cache_is_mesh_aware():
    problems = _family(3, seed0=700)
    cache = pack_cache()
    stack_packed_sharded(problems, device=CPU)
    first = {d: dict(s) for d, s in cache.device_stats.items()}
    assert first, "device_stats must populate on a sharded stack build"
    assert all(s["resident_bytes"] > 0 for s in first.values())
    again = stack_packed_sharded(problems, device=CPU)
    assert again.shards == 1
    assert any(cache.device_stats[d]["hits"] > first[d]["hits"] for d in first), \
        "second stack of the same family must hit the LRU's stripe tensors"
    cache.clear()  # eviction/clear releases the per-stripe resident bytes
    assert all(s["resident_bytes"] == 0 for s in cache.device_stats.values())


def test_pack_cache_collector_reports_device_stats():
    stack_packed_sharded(_family(2, seed0=800), device=CPU)
    snap = _pack_cache_collector()
    assert any(k.startswith("device.cpu.") for k in snap)


def test_uncached_stacks_hold_no_resident_bytes(stripes8):
    """A stack built outside the LRU never counts as resident: its bytes
    could not be released."""
    before = {d: dict(s) for d, s in pack_cache().device_stats.items()}
    stack = stack_packed_sharded(_family(8, seed0=850), shards=3, device=CPU, use_cache=False)
    assert stack.padded == 9 and stack.nbytes > 0
    assert {d: dict(s) for d, s in pack_cache().device_stats.items()} == before


def test_ga_accepts_and_ignores_shard_option():
    problem = _family(1)[0]
    res = ga(problem, pop_size=8, generations=2, seed=0, shard=4, device=CPU)
    assert res.schedule is not None


def test_ga_sweep_shard_off_matches_default_on_one_device(monkeypatch):
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    problems = _family(2)
    a = ga_sweep(problems, pop_size=8, generations=3, seed=0, device=CPU)
    b = ga_sweep(problems, pop_size=8, generations=3, seed=0, device=CPU, shard="off")
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.schedule.assignment, rb.schedule.assignment)
        np.testing.assert_array_equal(ra.history, rb.history)


def test_shard_devices_env_clamp(monkeypatch):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")
    monkeypatch.setenv("REPRO_SHARD_DEVICES", "2")
    assert local_device_count(CPU) == 2
    assert choose_shards(8, device=CPU) == 2
    assert len(instance_mesh(8, CPU)) == 8  # the clamp bounds "auto", not the stripes
    monkeypatch.setenv("REPRO_SHARD_DEVICES", "1")
    assert choose_shards(8, device=CPU) == 1


# -----------------------------------------------------------------------------
# 8 virtual CPU stripes
# -----------------------------------------------------------------------------


def test_virtual_stripes_have_distinct_names(stripes8):
    mesh = instance_mesh(8, CPU)
    assert [s.name for s in mesh] == [f"cpu/s{i}" for i in range(8)]
    assert all(s.device == torch.device("cpu") for s in mesh)
    assert local_device_count(CPU) == 8
    assert choose_shards(8, device=CPU) == 8 and choose_shards(12, device=CPU) == 6
    assert choose_shards(5, device=CPU) == 5


@pytest.mark.parametrize("engine", ["cuda", "torch"])
@pytest.mark.parametrize("mode", ["fixed", "weighted"])
def test_striped_fitness_is_bit_identical_to_unsharded_and_oracle(stripes8, engine, mode):
    problems = _family(8)
    w = ObjectiveWeights(usage_mode=mode)
    eng = ENGINES.get(engine)
    auto = eng.batched_fitness(problems, w, device=CPU)
    assert auto.shards == 8
    base = eng.batched_fitness(problems, w, device=CPU, shard=None)
    A = _candidates(problems, 6)
    obj_s, mk_s = auto(A)
    obj_1, mk_1 = base(A)
    assert torch.equal(obj_s, obj_1) and torch.equal(mk_s, mk_1)
    if mode == "fixed":
        oracle = ENGINES.get("oracle")
        for i, p in enumerate(problems):
            obj_o, mk_o = oracle.population_fitness(p, w, device=CPU)(A[i, :, :p.num_tasks])
            assert torch.equal(mk_o.float(), mk_s[i]), i
            assert torch.equal(obj_o.float(), obj_s[i]), i


def test_pad_edge_three_stripes_over_eight(stripes8):
    problems = _family(8, seed0=300)
    fitness = ENGINES.get("cuda").batched_fitness(problems, device=CPU, shard=3)
    assert fitness.shards == 3 and fitness.num_instances == 8
    base = ENGINES.get("cuda").batched_fitness(problems, device=CPU, shard=None)
    A = _candidates(problems, 4, seed=1)
    for g, want in zip(fitness(A), base(A)):
        assert g.shape == (8, 4)
        assert torch.equal(g, want)


def test_pad_rows_stay_inside_the_fitness_call(stripes8):
    """The replicas of instance 0 never reach ``FITNESS`` under a key of
    their own, and the padded stack counts its stripes once each."""
    problems = _family(8, seed0=320)
    before = {d: dict(s) for d, s in pack_cache().device_stats.items()}
    fitness = sharded_batched_fitness(problems, shards=3, device=CPU)
    fitness(_candidates(problems, 4))
    keys = [k for k in obs.FITNESS.to_json() if k.startswith("cuda-shard3|")]
    assert keys, obs.FITNESS.to_json().keys()
    after = pack_cache().device_stats
    grew = [d for d in after if after[d]["misses"] > before.get(d, {}).get("misses", 0)]
    assert grew == ["cpu/s0", "cpu/s1", "cpu/s2"]


@pytest.mark.parametrize("shard", [8, 3])
def test_ga_sweep_striped_equals_shard_off(stripes8, shard):
    problems = _family(8, seed0=400)
    on = ga_sweep(problems, pop_size=8, generations=3, seed=0, device=CPU, shard=shard)
    off = ga_sweep(problems, pop_size=8, generations=3, seed=0, device=CPU, shard="off")
    for ra, rb in zip(on, off):
        np.testing.assert_array_equal(ra.schedule.assignment, rb.schedule.assignment)
        np.testing.assert_array_equal(ra.history, rb.history)


def test_ga_sweep_reports_its_shards(stripes8):
    obs.METRICS.reset()
    obs.TRACER.enable()
    try:
        ga_sweep(_family(8, seed0=450), pop_size=8, generations=2, seed=0, device=CPU)
    finally:
        obs.TRACER.disable()
    span = [s for s in obs.TRACER.spans if s.name == "mh.ga_sweep"][-1]
    assert span.args["shards"] == 8
    snap = obs.METRICS.snapshot()
    assert snap["gauges"]["mh.ga_sweep.shards"] == 8
    assert snap["gauges"]["engine.shard.devices"] == 8
    assert any(s.name == "engine.shard_stack" for s in obs.TRACER.spans)


def test_residency_on_all_eight_stripes(stripes8):
    problems = _family(8, seed0=500)
    cache = pack_cache()
    stack_packed_sharded(problems, device=CPU)
    stats0 = {d: dict(s) for d, s in cache.device_stats.items() if d.startswith("cpu/s")}
    assert sorted(stats0) == [f"cpu/s{i}" for i in range(8)]
    assert all(s["resident_bytes"] > 0 for s in stats0.values())
    stack = stack_packed_sharded(problems, device=CPU)
    assert stack.shards == 8 and stack.padded == 8
    assert all(cache.device_stats[d]["hits"] > stats0[d]["hits"] for d in stats0)


def test_admission_counts_sharded_groups(stripes8):
    from repro_torch.service import ServiceConfig, SchedulingService, generate_trace

    trace = generate_trace(24, seed=3, families=("stgs",), rate=50.0, burst_prob=0.0)
    obs.METRICS.reset()
    result = SchedulingService(trace.system, ServiceConfig(batch_window=1.0, max_batch=8), device=CPU).run(trace)
    summary = result.summary()
    assert summary["completed"] == 24 and summary["batched_groups"] > 0
    # every batched group has >= 2 members, so each stripes over >= 2 stripes
    counters = obs.METRICS.snapshot()["counters"]
    assert counters["service.admission.sharded_groups"] == summary["batched_groups"]


# -----------------------------------------------------------------------------
# a child started with the stripes in its environment
# -----------------------------------------------------------------------------

_CHILD = textwrap.dedent(
    """
    import numpy as np, torch
    from repro_torch.core import Workload, build_problem, ga_sweep, synthetic_system
    from repro_torch.core.workload_model import random_layered_workflow
    from repro_torch.engine import ENGINES, local_device_count, pack_cache

    assert local_device_count("cpu") == 8, local_device_count("cpu")
    system = synthetic_system(3, seed=3)
    problems = [build_problem(system, Workload((random_layered_workflow(
        10, seed=100 + i, max_cores=4, feature_pool=("F1",)),))) for i in range(8)]
    eng = ENGINES.get("auto")
    auto, base = eng.batched_fitness(problems, device="cpu"), eng.batched_fitness(problems, device="cpu", shard="off")
    A = np.zeros((8, 6, auto.bucket[0]), np.int32)
    A[:, :, :10] = np.random.default_rng(0).integers(0, 3, (8, 6, 10))
    assert auto.shards == 8
    assert all(torch.equal(a, b) for a, b in zip(auto(A), base(A)))
    on = ga_sweep(problems, pop_size=8, generations=3, seed=0, device="cpu")
    off = ga_sweep(problems, pop_size=8, generations=3, seed=0, device="cpu", shard="off")
    assert all(np.array_equal(a.schedule.assignment, b.schedule.assignment) for a, b in zip(on, off))
    assert len([d for d in pack_cache().device_stats if d.startswith("cpu/s")]) == 8
    print("STRIPES-OK")
    """
)


def test_virtual_stripes_from_the_environment_in_a_child():
    env = dict(os.environ)
    env[VIRTUAL_DEVICES_ENV] = "8"
    env.pop("REPRO_SHARD_DEVICES", None)
    env["PYTHONPATH"] = str(REPO / "src")
    env["OMP_NUM_THREADS"] = "1"  # small ops, beside the other pytest workers
    proc = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    assert "STRIPES-OK" in proc.stdout


# -----------------------------------------------------------------------------
# against the reference's 8-device instance mesh
# -----------------------------------------------------------------------------

SPECS = [{"kind": "layered", "tasks": 10, "nodes": 3, "seed": 100 + i} for i in range(8)]
GA_OPTS = {"pop_size": 8, "generations": 3, "tournament": 3, "mutation_rate": 0.1, "elite": 2}
SWEEP_SEED = 5
BATCHES = [0, 1, 2, 5, 6, 8, 9, 12, 16]


def _ref_family():
    return [ref_harness.build(s, sm, wm) for s in SPECS]


@pytest.fixture(scope="module")
def family_candidates():
    problems = _ref_family()
    return problems, _candidates(problems, 6, seed=7)


@pytest.fixture(scope="module")
def ref(family_candidates):
    _, A = family_candidates
    return ref_harness.run(
        "shard",
        {"specs": SPECS, "batches": BATCHES, "shards": [8, 3], "sweep_shards": [8],
         "ga": GA_OPTS, "sweep_seed": SWEEP_SEED},
        {"assignments": A},
        devices=8,
    )


def test_reference_mesh_and_shard_choice_match_the_stripes(ref, stripes8):
    assert int(ref["devices"]) == local_device_count(CPU) == 8
    assert [choose_shards(b, device=CPU) for b in BATCHES] == ref["choose"].tolist()


@pytest.mark.parametrize("mode", ["fixed", "weighted"])
@pytest.mark.parametrize("shard", [8, 3])
def test_striped_fitness_equals_reference_mesh(ref, family_candidates, stripes8, mode, shard):
    problems, A = family_candidates
    fitness = ENGINES.get("cuda").batched_fitness(problems, ObjectiveWeights(usage_mode=mode), device=CPU,
                                                  shard=shard)
    assert fitness.shards == int(ref[f"{mode}/{shard}/shards"])
    obj, mk = fitness(A)
    np.testing.assert_array_equal(obj.numpy(), ref[f"{mode}/{shard}/obj"])
    np.testing.assert_array_equal(mk.numpy(), ref[f"{mode}/{shard}/mk"])
    np.testing.assert_array_equal(obj.numpy(), ref[f"{mode}/off/obj"])
    np.testing.assert_array_equal(mk.numpy(), ref[f"{mode}/off/mk"])


@pytest.mark.parametrize("shard", [8, 3, "off"])
def test_striped_ga_sweep_equals_reference_mesh(ref, stripes8, shard):
    problems = _ref_family()
    keys = ("initial", "cand", "xmask", "mmask", "fresh")
    stacked = {k: np.stack([ref[f"draws/{b}/{k}"] for b in range(len(problems))]) for k in keys}
    draws = ArrayDraws(*(stacked[k] for k in keys), device=CPU)
    results = ga_sweep(problems, device=CPU, draws=draws, seed=SWEEP_SEED, shard=shard, **GA_OPTS)
    for b, res in enumerate(results):
        np.testing.assert_array_equal(res.schedule.assignment, ref[f"sweep/8/{b}/best"])
        np.testing.assert_array_equal(res.history, ref[f"sweep/8/{b}/history"])
