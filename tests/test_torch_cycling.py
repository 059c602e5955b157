"""The port's recurring and converging workflows against the JAX package's.

Cycle specs round-trip to the reference's JSON, unroll into the same DAGs
with the same cross-cycle edges and per-cycle deadlines, and their seeded
convergence predicate (keyed on ``zlib.crc32`` of the stream's name) fires
on the same cycles; malformed specs fail with the reference's message; a
scenario with a ``cycling`` section round-trips and runs to the reference's
summary; and the converging-stream service fixture reproduces the
reference's pinned replay fingerprint.  The behaviour tests of the
reference's ``tests/test_cycling.py`` that reach the port's modules run
here too."""

import dataclasses
import json

import numpy as np
import pytest

import torch_reference as ref_harness
from repro_torch.core import api, canonical_hash, system_model as sm, workload_model as wm
from repro_torch.core.workload_model import Workload, mri_w1, mri_w2, random_layered_workflow, topological_order
from repro_torch.cycling import (
    ConvergeSpec,
    CycleSpec,
    cross_edges,
    cycle_spec_from_json,
    resolve_cycles,
    roots_and_sinks,
    task_cycle_name,
    unroll,
    unroll_constraints,
    unroll_workload,
)
from repro_torch.service import SchedulingService, ServiceConfig, Submission, Trace, continuum_system

MRI = {"kind": "mri"}
CONSTRAINED = {"kind": "constrained", "tasks": 12, "nodes": 6, "seed": 5, "deadline": 40.0, "budget": 300.0}
SPECS = [
    ({"cycles": 3, "period": 5.0}, MRI),
    ({"cycles": 2, "period": 4.0, "cross": [["T3", "T1"], ["*", "T2"]], "cycle_deadline": 30.0}, MRI),
    ({"cycles": 2, "cross": [["*", "*"]]}, {"kind": "layered", "tasks": 12, "nodes": 4, "seed": 4}),
    ({"converge": {"prob": 0.4, "min_cycles": 2, "max_cycles": 5, "seed": 7}, "period": 2.0,
      "cycle_deadline": 12.0}, CONSTRAINED),
    ({"converge": {"prob": 0.5, "min_cycles": 2, "max_cycles": 6, "seed": 3}, "period": 5.0,
      "cycle_deadline": 8.0}, MRI),
]
BAD = [
    {"cycles": 2, "converge": {"prob": 0.5}},
    {},
    {"cycles": 0},
    {"cycles": 2, "period": -1.0},
    {"cycles": 1, "cycle_deadline": 0.0},
    {"cycles": 2, "perod": 1.0},
    {"converge": {"prob": 2.0}},
    {"converge": {"min_cycles": 3, "max_cycles": 2}},
    {"converge": {"probb": 0.1}},
]
STREAM_NAMES = ["s-meet", "s-miss", "s-fixed", "cvg", "s00003"]
SCENARIOS = [
    {"name": "cyc-heft", "problem": MRI, "technique": "heft", "cycling": {"cycles": 2, "period": 4.0}},
    {"name": "cyc-auto", "problem": MRI, "cycling": {"cycles": 2, "period": 4.0, "cycle_deadline": 30.0}},
    {"name": "cyc-constrained", "problem": CONSTRAINED, "technique": "heft",
     "cycling": {"converge": {"prob": 0.5, "min_cycles": 1, "max_cycles": 3, "seed": 1}, "period": 2.0,
                 "cycle_deadline": 60.0}},
]
#: the reference's converging-stream service fixture
#: (``campaigns/builtin.py::_CYCLING_STREAMS``): W1 and W2 run 10.02 virtual
#: seconds a cycle on the continuum, so ``cycle_deadline`` 12 always meets
#: and 8 always misses
STREAMS = (
    ("s-meet", "mri-w1", {"converge": {"prob": 0.5, "min_cycles": 2, "max_cycles": 6, "seed": 3},
                          "period": 5.0, "cycle_deadline": 12.0}),
    ("s-miss", "mri-w2", {"converge": {"prob": 0.5, "min_cycles": 2, "max_cycles": 6, "seed": 3},
                          "period": 5.0, "cycle_deadline": 8.0}),
    ("s-fixed", "mri-w1", {"cycles": 3, "period": 5.0}),
)
PINNED = "820bbd5dcab25e9a644031ba39cdcd0ed4e0e34b33bf20c0e3c0d8844d2d15cb"


def _scenario(spec: dict) -> api.Scenario:
    sc = ref_harness.scenario_of(spec, api, sm, wm)
    return sc.replace(cycling=cycle_spec_from_json(spec["cycling"]))


@pytest.fixture(scope="module")
def ref():
    inputs = {f"{s['name']}/port_json": np.array(json.dumps(_scenario(s).to_json(), indent=2))
              for s in SCENARIOS}
    return ref_harness.run("cycling", {"specs": SPECS, "bad": BAD, "stream_names": STREAM_NAMES,
                                       "scenarios": SCENARIOS}, inputs, timeout=600)


def _error_of(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the message is what is compared
        return f"{type(e).__name__}: {e}"
    return ""


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(SPECS)))
def test_spec_unrolls_as_the_reference(ref, i):
    spec_json, prob = SPECS[i]
    spec = cycle_spec_from_json(spec_json)
    workload = ref_harness.workload_of(prob, wm)
    assert json.dumps(spec.to_json(), sort_keys=True) == str(ref[f"spec/{i}/json"])
    assert cycle_spec_from_json(spec.to_json()) == spec
    assert json.dumps(wm.workload_to_json(unroll_workload(workload, spec))) == str(ref[f"spec/{i}/unrolled"])
    cons = unroll_constraints(workload, spec, base=ref_harness.constraints_of(prob, wm))
    assert json.dumps(None if cons is None else cons.to_json()) == str(ref[f"spec/{i}/constraints"])
    assert json.dumps(cross_edges(workload.workflows[0], spec)) == str(ref[f"spec/{i}/cross"])
    assert resolve_cycles(spec) == int(ref[f"spec/{i}/cycles"])
    if spec.converging:
        got = [[spec.converge.converged(n, k) for k in range(spec.converge.max_cycles)] for n in STREAM_NAMES]
        np.testing.assert_array_equal(np.array(got), ref[f"spec/{i}/converged"])
        assert [spec.converge.revealed_cycles(n) for n in STREAM_NAMES] == ref[f"spec/{i}/revealed"].tolist()


@pytest.mark.parametrize("i", range(len(BAD)))
def test_malformed_spec_fails_with_the_reference_message(ref, i):
    msg = _error_of(lambda: cycle_spec_from_json(BAD[i]))
    assert msg and msg == str(ref[f"bad/{i}"])


@pytest.mark.parametrize("spec", SCENARIOS, ids=[s["name"] for s in SCENARIOS])
def test_cycling_scenario_round_trips_and_runs_as_the_reference(ref, spec, tmp_path):
    name = spec["name"]
    text = json.dumps(_scenario(spec).to_json(), indent=2)
    assert text == str(ref[f"{name}/json"])
    sc = api.scenario_from_json(text)
    assert json.dumps(sc.to_json(), indent=2) == str(ref[f"{name}/reparsed"])
    assert sc.cycling == cycle_spec_from_json(spec["cycling"])
    assert sc.fingerprint() == api.scenario_from_json(str(ref[f"{name}/json"])).fingerprint()
    summary = api.Orchestrator(sc, out_dir=tmp_path, device="cpu").run().summary()
    summary.pop("artifacts", None)
    assert json.dumps(summary, sort_keys=True) == str(ref[f"{name}/summary"])


def _converging_section() -> dict:
    """The reference's converging-stream fixture, served twice by the port."""
    wfs = {"mri-w1": mri_w1(), "mri-w2": mri_w2()}
    subs = tuple(
        Submission(id=sid, tenant="t0", time=float(i), family=fam, workflow=wfs[fam], technique="heft",
                   cycling=cycle_spec_from_json(dict(spec)))
        for i, (sid, fam, spec) in enumerate(STREAMS)
    )
    trace = Trace(name="cycling", system=continuum_system(), submissions=subs)
    results = [SchedulingService(trace.system, ServiceConfig(seed=0), device="cpu").run(trace) for _ in range(2)]
    fp = [canonical_hash({"events": r.event_log, "records": [x.to_json() for x in r.records]}) for r in results]
    return {"result": results[0], "fingerprints": fp}


def test_converging_replay_fingerprint_pinned(ref):
    section = _converging_section()
    a, b = section["fingerprints"]
    assert a == b == PINNED == str(ref["converging/fingerprint"])
    res = section["result"]
    expect = json.loads(str(ref["converging/section"]))
    assert res.cycling == expect["streams"]
    assert res.cycling["converged_streams"] == 2 and res.cycling["spawned_cycles"] > 0
    s = res.summary()
    assert s["cache"] == expect["solve_cache"] and s["deadline_misses"] == expect["deadline_misses"] > 0
    assert (len(res.records), res.solver_calls) == (expect["submissions_total"], expect["solver_calls"])


# ---------------------------------------------------------------------------
# behaviour, ported from the reference's tests/test_cycling.py
# ---------------------------------------------------------------------------

def test_cycle_spec_validation_and_defaults():
    assert CycleSpec(cycles=2).cross == (("*", "*"),)
    assert CycleSpec(cycles=2, cross=[["a", "b"]]).cross == (("a", "b"),)
    with pytest.raises(ValueError, match="exactly one"):
        CycleSpec()
    with pytest.raises(ValueError, match="exactly one"):
        CycleSpec(cycles=2, converge=ConvergeSpec())
    with pytest.raises(ValueError, match="unknown keys"):
        cycle_spec_from_json({"cycles": 2, "perod": 1.0})
    assert cycle_spec_from_json(None) is None


def test_converge_predicate_seeded_and_bounded():
    c = ConvergeSpec(prob=0.5, min_cycles=2, max_cycles=5, seed=11)
    for name in ("a", "b", "stream-7"):
        assert not c.converged(name, 0)  # never before min_cycles
        assert c.converged(name, 4)  # always by max_cycles
        assert c.revealed_cycles(name) == c.revealed_cycles(name)
        assert 2 <= c.revealed_cycles(name) <= 5
    assert ConvergeSpec(prob=1.0, min_cycles=1).revealed_cycles("x") == 1
    assert ConvergeSpec(prob=0.0, max_cycles=4).revealed_cycles("x") == 4


def test_unroll_names_deps_and_cross_edges():
    wf = mri_w2()
    spec = CycleSpec(cycles=3)
    un = unroll(wf, spec)
    assert len(un.tasks) == 3 * len(wf.tasks)
    roots, sinks = roots_and_sinks(wf)
    assert (roots, sinks) == (["T1"], ["T4"])
    t1c2 = next(t for t in un.tasks if t.name == task_cycle_name("T1", 2))
    assert set(t1c2.deps) == {"T4@c1"}
    order = [un.tasks[i].name for i in topological_order(un.tasks)]
    assert order.index("T4@c0") < order.index("T1@c1") < order.index("T4@c2")
    with pytest.raises(ValueError, match="unknown task"):
        cross_edges(wf, CycleSpec(cycles=2, cross=(("T9", "T1"),)))
    with pytest.raises(ValueError, match="cycles must be >= 1"):
        resolve_cycles(spec, 0)


def test_unroll_is_deterministic_and_acyclic_over_seeds():
    for seed in range(6):
        wf = random_layered_workflow(8, seed=seed)
        spec = CycleSpec(cycles=1 + seed % 3, cross=(("*", "*"),))
        a, b = unroll(wf, spec), unroll(wf, spec)
        assert a == b
        assert len(topological_order(a.tasks)) == len(a.tasks)


def test_unroll_constraints_per_cycle_deadlines():
    wl = Workload((mri_w1(),))
    spec = CycleSpec(cycles=2, cycle_deadline=10.0)
    cons = unroll_constraints(wl, spec, base=wm.Constraints(deadline={"W1": 25.0}))
    assert cons.deadline["W1"] == 25.0
    assert cons.deadline["W1/T1@c0"] == 10.0 and cons.deadline["W1/T3@c1"] == 20.0
    assert unroll_constraints(wl, CycleSpec(cycles=2)) is None


def _stream(sid, wf, t, cycling=None, after=(), technique="heft"):
    return Submission(id=sid, tenant="t0", time=float(t), family="mri", workflow=wf, technique=technique,
                      cycling=cycling, after=tuple(after))


def _run(trace: Trace):
    return SchedulingService(trace.system, ServiceConfig(seed=0), device="cpu").run(trace)


def test_service_spawns_fixed_cycles_with_warm_cache():
    spec = CycleSpec(cycles=3, period=5.0)
    res = _run(Trace(name="fix", system=continuum_system(),
                     submissions=(_stream("s0", mri_w1(), 0.0, cycling=spec),)))
    assert [r.id for r in res.records] == ["s0", "s0@c1", "s0@c2"]
    assert [r.cycle for r in res.records] == [0, 1, 2]
    assert all(r.status == "completed" for r in res.records)
    assert res.cycling["spawned_cycles"] == 2 and res.solver_calls == 1 and res.cache["hits"] == 2
    done = {e["id"]: e["time"] for e in res.event_log if e["kind"] == "completion"}
    start = {e["id"]: e["time"] for e in res.event_log if e["kind"] == "dispatch"}
    assert start["s0@c1"] >= done["s0"] and start["s0@c2"] >= done["s0@c1"]


def test_service_converging_stream_ends_by_predicate():
    conv = CycleSpec(converge=ConvergeSpec(prob=0.5, min_cycles=2, max_cycles=6, seed=3), period=2.0)
    res = _run(Trace(name="cvg", system=continuum_system(),
                     submissions=(_stream("cvg", mri_w1(), 0.0, cycling=conv),)))
    revealed = conv.converge.revealed_cycles("cvg")
    assert len(res.records) == revealed
    assert res.cycling["converged_streams"] == 1 and res.cycling["spawned_cycles"] == revealed - 1


def test_service_cycle_deadline_misses_counted():
    spec = CycleSpec(cycles=2, period=0.0, cycle_deadline=8.0)
    res = _run(Trace(name="dl", system=continuum_system(),
                     submissions=(_stream("d", mri_w1(), 0.0, cycling=spec),)))
    assert all(r.deadline_miss for r in res.records)
    assert res.summary()["deadline_misses"] == 2
    assert any(e["kind"] == "deadline-miss" for e in res.event_log)


def test_service_after_gates_and_cascades():
    wf = mri_w1()
    res = _run(Trace(name="gate", system=continuum_system(),
                     submissions=(_stream("a", wf, 0.0), _stream("b", wf, 0.5, after=("a",)))))
    recs = {r.id: r for r in res.records}
    assert recs["a"].status == recs["b"].status == "completed"
    assert res.cycling["gated_submissions"] == 1
    assert recs["b"].dispatched >= recs["a"].finished
    bad = dataclasses.replace(wf, tasks=tuple(
        dataclasses.replace(t, features=frozenset({"NO_SUCH_FEATURE"})) for t in wf.tasks))
    res = _run(Trace(name="cascade", system=continuum_system(),
                     submissions=(_stream("a", bad, 0.0), _stream("b", wf, 0.5, after=("a",)),
                                  _stream("c", wf, 0.7, after=("b",)))))
    recs = {r.id: r for r in res.records}
    assert [recs[k].status for k in "abc"] == ["rejected"] * 3
    assert recs["b"].reason == "dependency-failed: a" and recs["c"].reason == "dependency-failed: b"


def test_service_unknown_or_self_after_fails_fast():
    for after, match in ((("ghost",), "ghost"), (("b",), "waits on itself")):
        trace = Trace(name="bad", system=continuum_system(),
                      submissions=(_stream("b", mri_w1(), 0.0, after=after),))
        with pytest.raises(ValueError, match=match):
            _run(trace)
