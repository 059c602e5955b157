"""The port's scheduling service against the JAX package's.

Generated traces equal the reference's byte for byte, and each package reads
the other's trace files.  Served traces whose solves draw no random numbers
(MILP, HEFT, and the GA replaced by a deterministic stand-in in both
packages, ``torch_reference.standin_registry``) give the reference's event
log, records, makespans, summary and metric counters exactly, and a traced
run its virtual fingerprint.  The real GA draws from a ``torch.Generator``,
not JAX's PRNG, so on the CPU it is held to itself: a replay is bit for bit,
groups batch and every tenant completes.  The behaviour tests of the
reference's ``tests/test_service.py`` run here on the port, and a fault of
the device layer propagates out of the service on both admission paths."""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_reference as ref_harness
from repro_torch import obs
from repro_torch.core import Node, Task, Workflow, api, heuristics, make_system
from repro_torch.core.workload_model import mri_w1
from repro_torch.engine import backends
from repro_torch.kernels._build import KernelError
from repro_torch.service import (
    ContinuumState,
    EventLoop,
    SchedulingService,
    ServiceConfig,
    Submission,
    Trace,
    continuum_system,
    generate_trace,
    load_trace,
    retry_backoff,
    serve_trace,
    trace_from_json,
)
from repro_torch.service.traces import GA_OPTIONS, NodeEvent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These loops run thousands of small ops; with the several pytest
    workers a test run starts side by side, each op's intra-op thread team
    waits on the others' and the file takes ten times as long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]

#: the reference's chaos lane (``campaigns/builtin.py::chaos_campaign``)
CHAOS = {"horizon": 1200.0, "failure_rate": 0.004, "outage_mean": 60.0, "drift_rate": 0.01,
         "drift_range": [0.4, 1.6]}
CHAOS_CONFIG = {"batch_window": 0.5, "max_batch": 32, "seed": 0, "max_retries": 4,
                "backoff_base": 0.5, "backoff_cap": 30.0}
TRACES = {
    "mixed": {"num_submissions": 40, "seed": 0},
    "node-events": {"num_submissions": 200, "seed": 0, "node_events": True},
    "chaos": {"num_submissions": 120, "seed": 0, "rate": 4.0, "burst_prob": 0.15, "burst_size": 8,
              "chaos": CHAOS},
    "cycling-chaos": {"num_submissions": 10, "seed": 5, "rate": 2.0, "families": ["mri"],
                      "chaos": {"horizon": 120.0, "failure_rate": 0.01, "drift_rate": 0.02},
                      "cycling": {"fraction": 0.4, "cycles": 2, "period": 3.0}},
    "converging": {"num_submissions": 12, "seed": 9, "families": ["mri", "random"],
                   "cycling": {"fraction": 0.5, "converge": {"prob": 0.5, "seed": 2}, "period": 5.0,
                               "cycle_deadline": 50.0}},
}
SERVES = [
    # GA-free traces with the real registry
    {"name": "mri-tpu-events", "traced": True, "config": {"seed": 11},
     "gen": {"num_submissions": 24, "seed": 11, "rate": 3.0, "families": ["mri", "tpu"], "node_events": True}},
    {"name": "chaos-heft", "config": {**CHAOS_CONFIG, "fallback": ["heft"]},
     "gen": {"num_submissions": 80, "seed": 0, "rate": 4.0, "burst_prob": 0.15, "burst_size": 8,
             "families": ["mri", "tpu"], "chaos": CHAOS}},
    {"name": "cycling-chaos", "config": {"seed": 5, "max_retries": 3, "fallback": ["heft"]},
     "gen": TRACES["cycling-chaos"]},
    {"name": "jitter", "config": {"seed": 5, "jitter": 0.1},
     "gen": {"num_submissions": 8, "seed": 2, "families": ["tpu"]}},
    # GA-bearing traces with the stand-in GA in both packages
    {"name": "mixed-standin", "standin": True, "traced": True, "config": {"seed": 0},
     "gen": {"num_submissions": 60, "seed": 0, "node_events": True}},
    {"name": "chaos-standin", "standin": True, "config": {**CHAOS_CONFIG, "fallback": ["ga", "heft"]},
     "gen": TRACES["chaos"]},
    # a trace file written by the port: coalesced twins, max_batch overflow
    # and a same-bucket GA group, read by the reference
    {"name": "port-file", "standin": True, "config": {"batch_window": 1.0, "max_batch": 3}},
]


def _config(case: dict) -> ServiceConfig:
    kw = dict(case.get("config", {}))
    if "fallback" in kw:
        kw["fallback"] = tuple(kw["fallback"])
    return ServiceConfig(**kw)


def _gen(kw: dict) -> Trace:
    return generate_trace(**{k: tuple(v) if k == "families" else v for k, v in kw.items()})


def _port_file_trace() -> Trace:
    subs = tuple(_sub(i, mri_w1(), t=0.0, technique="auto") for i in range(4))
    subs += tuple(
        _sub(10 + i, _chain(f"G{i}", [1.0 + i, 2.0, 3.0, 1.0 + i]), t=0.5, technique="ga",
             solver_options=dict(GA_OPTIONS))
        for i in range(3)
    )
    return Trace(name="port-file", system=continuum_system(), submissions=subs,
                 events=(NodeEvent(time=0.2, kind="node-drift", node="N2", factor=0.5),))


def _trace_of(case: dict) -> Trace:
    return _gen(case["gen"]) if "gen" in case else _port_file_trace()


@pytest.fixture(scope="module")
def ref():
    inputs = {f"{c['name']}/trace": np.array(json.dumps(_trace_of(c).to_json()))
              for c in SERVES if "gen" not in c}
    return ref_harness.run("service", {"traces": TRACES, "serves": SERVES}, inputs, timeout=600)


def _serve(case: dict, trace: Trace | None = None) -> tuple[dict, str | None]:
    """The port's outputs for one case (``ref_harness.service_outputs``)
    and, when traced, its virtual fingerprint."""
    trace = _trace_of(case) if trace is None else trace
    reg = ref_harness.standin_registry(api, heuristics) if case.get("standin") else None
    obs.METRICS.reset()
    if case.get("traced"):
        obs.TRACER.enable()
    try:
        result = SchedulingService(trace.system, _config(case), registry=reg, device="cpu").run(trace)
    finally:
        obs.TRACER.disable()
    out = ref_harness.service_outputs(result, obs.METRICS.snapshot())
    return out, obs.virtual_fingerprint() if case.get("traced") else None


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TRACES))
def test_generated_trace_equals_the_reference_byte_for_byte(ref, name):
    text = json.dumps(_gen(TRACES[name]).to_json(), indent=2)
    assert text == str(ref[f"trace/{name}"])


@pytest.mark.parametrize("name", list(TRACES))
def test_reference_trace_file_round_trips_through_the_port(ref, name, tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(str(ref[f"trace/{name}"]) + "\n")
    trace = load_trace(path)
    assert trace.to_json() == json.loads(str(ref[f"trace/{name}"]))
    assert json.dumps(trace.to_json(), indent=2) == str(ref[f"trace/{name}/reparsed"])
    again = trace_from_json(json.loads(json.dumps(trace.to_json())))
    assert [s.cycling for s in again.submissions] == [s.cycling for s in trace.submissions]
    assert again.events == trace.events and again.meta == trace.meta


@pytest.mark.parametrize("case", SERVES, ids=[c["name"] for c in SERVES])
def test_served_trace_equals_the_reference(ref, case):
    """Event log, records, makespans, summary (without the wall fields) and
    the run's metric counters and histograms, exactly."""
    out, fingerprint = _serve(case)
    for key, text in out.items():
        assert text == str(ref[f"{case['name']}/{key}"]), key
    summary = json.loads(out["summary"])
    assert summary["completed"] + summary["rejected"] + summary["failed"] == summary["submissions"]
    if case.get("traced"):
        assert fingerprint == str(ref[f"{case['name']}/fingerprint"])
        assert len(obs.TRACER.spans) == int(ref[f"{case['name']}/spans"])


def test_the_parity_cases_reach_every_admission_path(ref):
    """What the cases above hold the port to: batched groups, coalesced
    twins and cache hits, preemptions and retries, cycle spawns."""
    s = {c["name"]: json.loads(str(ref[f"{c['name']}/summary"])) for c in SERVES}
    assert s["mixed-standin"]["batched_groups"] > 0 and s["port-file"]["batched_groups"] == 1
    assert s["port-file"]["cache"]["hits"] == 3  # the three twins of the first MRI submission
    assert s["chaos-standin"]["robustness"]["preempted_submissions"] > 0
    assert s["chaos-heft"]["robustness"]["retries"] > 0
    assert s["cycling-chaos"]["cycling"]["spawned_cycles"] > 0
    events = json.loads(str(ref["port-file/events"]))
    assert sum(e["kind"] == "admit" for e in events) >= 3  # 7 submissions / max_batch 3


def test_topology_traces_are_refused():
    """A trace takes its continuum from ``system`` or ``topology``, not both,
    as in the reference (topology traces against the reference:
    tests/test_torch_topology.py)."""
    with pytest.raises(ValueError, match="either system= or topology="):
        generate_trace(4, topology="tiny", system=continuum_system())
    assert generate_trace(4, topology="tiny").meta["topology"]["name"] == "tiny"


# ---------------------------------------------------------------------------
# the real GA, on the CPU
# ---------------------------------------------------------------------------

def test_real_ga_replays_bit_identically_and_batches():
    trace = generate_trace(10, seed=4, rate=8.0, burst_prob=0.6, families=("stgs", "random", "tpu"))
    runs = [serve_trace(trace, config=ServiceConfig(batch_window=0.5), device="cpu") for _ in range(2)]
    a, b = runs
    assert a.event_log == b.event_log
    assert a.makespans() == b.makespans()
    assert [r.to_json() for r in a.records] == [r.to_json() for r in b.records]
    assert a.batched_groups > 0
    assert all(r.status == "completed" for r in a.records)
    assert all(not r.fallbacks for r in a.records)
    assert any(r.technique_used == "ga" for r in a.records)


# ---------------------------------------------------------------------------
# device faults propagate on both admission paths
# ---------------------------------------------------------------------------

def _ga_trace(n: int) -> Trace:
    subs = tuple(
        _sub(i, _chain(f"F{i}", [1.0 + i, 2.0, 3.0]), t=0.0, technique="ga",
             solver_options={"generations": 1, "pop_size": 4, "seed": 0})
        for i in range(n)
    )
    return Trace(name="fault", system=_two_node_system(), submissions=subs)


@pytest.mark.parametrize("fallback", [(), ("ga", "heft")], ids=["no-fallback", "fallback"])
@pytest.mark.parametrize("n", [1, 2], ids=["single", "batch"])
@pytest.mark.parametrize("fault", [KernelError("synthetic launch failure"),
                                   torch.OutOfMemoryError("synthetic out of memory")],
                         ids=["kernel", "out-of-memory"])
def test_device_faults_propagate_out_of_the_service(monkeypatch, fault, n, fallback):
    """The makespan wrapper failing on the single path (one GA tenant) or
    the batch path (two in one group) ends the run with that fault: no
    tenant is rejected and none is degraded to HEFT."""
    calls = []

    def failing(*args, **kw):
        calls.append(args[0].shape[0])
        raise fault

    monkeypatch.setattr(backends.CudaEngine, "makespan_fn", staticmethod(failing))
    svc = SchedulingService(_two_node_system(), ServiceConfig(batch_window=0.5, fallback=fallback),
                            device="cpu")
    with pytest.raises(type(fault), match="synthetic"):
        svc.run(_ga_trace(n))
    assert calls == [n]  # one call: the batched pair's [2, P, T], or one instance's [1, P, T]
    assert all(r.status != "rejected" and not r.fallbacks for r in svc.records.values())
    assert svc.solver_calls == 0


def test_a_tenants_bad_option_still_rejects_one_submission():
    """The departure is for device faults only: a zero-size population in a
    batched group fails the group, whose members then run singly and are
    rejected one by one, as in the reference."""
    bad = {"generations": 2, "pop_size": 0, "seed": 0}
    subs = (
        _sub(0, _chain("A", [1.0, 2.0]), t=0.0, technique="ga", solver_options=bad),
        _sub(1, _chain("B", [2.0, 3.0]), t=0.0, technique="ga", solver_options=bad),
        _sub(2, _chain("C", [1.0, 1.0]), t=0.0, technique="heft"),
    )
    trace = Trace(name="badbatch", system=_two_node_system(), submissions=subs)
    r = SchedulingService(trace.system, ServiceConfig(batch_window=1.0), device="cpu").run(trace)
    assert [rec.status for rec in r.records] == ["rejected", "rejected", "completed"]


def test_device_and_engine_reach_both_paths_but_not_the_keys():
    """``device``/``engine`` are folded into the GA's options at solve time;
    the cache keys and batch groups hash the tenant's own options."""
    seen = []
    real_batch, real_fn = api.REGISTRY.get("ga").batch_fn, api.REGISTRY.get("ga").fn

    def spy_batch(problems, weights=None, **kw):
        seen.append(("batch", kw.get("device"), kw.get("backend")))
        return real_batch(problems, weights, **kw)

    def spy_fn(problem, weights=None, **kw):
        seen.append(("single", kw.get("device"), kw.get("backend")))
        return real_fn(problem, weights, **kw)

    reg = api.SolverRegistry()
    for e in api.REGISTRY:
        reg.register(e.name, spy_fn if e.name == "ga" else e.fn,
                     batch_fn=spy_batch if e.name == "ga" else e.batch_fn, engine_aware=e.capabilities.engine_aware)
    trace = _ga_trace(2)
    trace = dataclasses.replace(trace, submissions=trace.submissions + (
        _sub(9, _chain("Z", [1.0] * 9), t=3.0, technique="ga", solver_options=trace.submissions[0].solver_options),))
    svc = SchedulingService(trace.system, ServiceConfig(batch_window=0.5), registry=reg, device="cpu",
                            engine="torch")
    r = svc.run(trace)
    assert seen == [("batch", "cpu", "torch"), ("single", "cpu", "torch")]
    assert r.batched_groups == 1
    # the batched pair's cache keys hash the tenant's options, unfolded
    from repro_torch.core.workload_model import Workload, build_problem
    from repro_torch.service import solve_cache_key

    for sub in trace.submissions[:2]:
        problem = build_problem(trace.system, Workload((sub.workflow,)))
        assert solve_cache_key(problem, sub.weights, "ga", sub.solver_options) in svc.cache


# ---------------------------------------------------------------------------
# behaviour, ported from the reference's tests/test_service.py
# ---------------------------------------------------------------------------

def _single_node_system(speed: float = 1.0):
    return make_system([
        Node("N1", {"cores": 8}, frozenset({"F1"}),
             {"processing_speed": speed, "data_transfer_rate": 100.0}),
    ])


def _two_node_system():
    return make_system([
        Node("N1", {"cores": 8}, frozenset({"F1"}),
             {"processing_speed": 1.0, "data_transfer_rate": 100.0}),
        Node("N2", {"cores": 8}, frozenset({"F1"}),
             {"processing_speed": 4.0, "data_transfer_rate": 100.0}),
    ])


def _chain(name: str, works) -> Workflow:
    tasks = [
        Task(f"T{i}", cores=2, work=float(w), features=frozenset({"F1"}),
             deps=(f"T{i - 1}",) if i else ())
        for i, w in enumerate(works)
    ]
    return Workflow(name, tuple(tasks))


def _sub(i, wf, t, technique="heft", **kw) -> Submission:
    return Submission(id=f"s{i:03d}", tenant="t0", time=float(t), family="test",
                      workflow=wf, technique=technique, **kw)


def _run(trace: Trace, config: ServiceConfig = ServiceConfig(), **kw):
    return SchedulingService(trace.system, config, device="cpu", **kw).run(trace)


def test_event_loop_orders_by_time_then_push_order_and_clamps():
    loop = EventLoop()
    loop.push(5.0, "b")
    loop.push(1.0, "a")
    loop.push(5.0, "c")
    assert [ev.kind for ev in loop.drain()] == ["a", "b", "c"]
    assert loop.now == 5.0
    ev = loop.push(3.0, "too-early")  # in the past: clamps to now
    assert ev.time == 5.0


def test_event_loop_cancellation_skips_silently():
    loop = EventLoop()
    keep = loop.push(1.0, "keep")
    drop = loop.push(2.0, "drop")
    loop.push(3.0, "tail")
    assert loop.cancel(drop) is True
    assert loop.cancel(drop) is False  # idempotent
    assert len(loop) == 2
    assert [ev.kind for ev in loop.drain()] == ["keep", "tail"]
    assert keep.seq not in loop._cancelled


def test_retry_backoff_doubles_then_caps():
    assert [retry_backoff(i, base=1.0, cap=10.0) for i in range(1, 6)] == [1.0, 2.0, 4.0, 8.0, 10.0]
    with pytest.raises(ValueError, match="attempt"):
        retry_backoff(0)


@pytest.mark.parametrize("kw, match", [
    ({"max_batch": 0}, "max_batch"), ({"batch_window": -1.0}, "batch_window"),
    ({"cache_capacity": 0}, "cache_capacity"), ({"max_retries": -1}, "max_retries"),
    ({"backoff_base": 0.0}, "backoff_base"), ({"backoff_cap": 0.0}, "backoff_cap"),
    ({"solve_budget": 0.0}, "solve_budget"), ({"jitter": -0.1}, "jitter"),
], ids=lambda v: str(v) if isinstance(v, str) else None)
def test_service_config_rejects_degenerate_knobs(kw, match):
    with pytest.raises(ValueError, match=match):
        ServiceConfig(**kw)


def test_unknown_node_and_duplicate_ids_fail_fast():
    trace = Trace(name="badnode", system=_single_node_system(),
                  submissions=(_sub(0, _chain("C", [1.0]), t=1.0),),
                  events=(NodeEvent(time=0.0, kind="node-failure", node="N9"),))
    with pytest.raises(ValueError, match="unknown node 'N9'"):
        _run(trace)
    subs = (_sub(0, _chain("A", [1.0]), t=0.0), _sub(0, _chain("B", [2.0]), t=1.0))
    with pytest.raises(ValueError, match="duplicate submission id"):
        _run(Trace(name="dupid", system=_single_node_system(), submissions=subs))


def test_repeat_identical_submission_zero_solver_invocations():
    subs = tuple(_sub(i, mri_w1(), t=i * 30.0) for i in range(4))
    r = _run(Trace(name="rep", system=continuum_system(), submissions=subs))
    assert [rec.status for rec in r.records] == ["completed"] * 4
    assert r.solver_calls == 1
    assert [rec.cache_hit for rec in r.records] == [False, True, True, True]
    assert r.cache["hits"] == 3 and r.cache["misses"] == 1


def test_burst_of_identical_submissions_coalesces_in_one_window():
    subs = tuple(_sub(i, mri_w1(), t=0.0) for i in range(5))
    r = _run(Trace(name="burst", system=continuum_system(), submissions=subs), ServiceConfig(batch_window=1.0))
    assert r.solver_calls == 1
    assert sum(rec.cache_hit for rec in r.records) == 4
    assert r.cache["hits"] == 4 and r.cache["misses"] == 1


def test_coalesced_twin_of_rejected_solve_is_not_a_cache_hit():
    wf = Workflow("needs-f2", (Task("T0", features=frozenset({"F2"})),))
    trace = Trace(name="twin-rej", system=_single_node_system(), submissions=(_sub(0, wf, t=0.0), _sub(1, wf, t=0.0)))
    r = _run(trace, ServiceConfig(batch_window=1.0))
    assert [rec.status for rec in r.records] == ["rejected", "rejected"]
    assert not any(rec.cache_hit for rec in r.records)
    assert r.cache["hits"] == 0 and r.cache["misses"] == 2
    obj = r.records[0].to_json()
    assert obj["finished"] is None and obj["observed_makespan"] is None
    json.dumps([rec.to_json() for rec in r.records], allow_nan=False)


def test_max_batch_overflow_readmits_in_order():
    subs = tuple(_sub(i, mri_w1(), t=0.0) for i in range(5))
    r = _run(Trace(name="overflow", system=continuum_system(), submissions=subs),
             ServiceConfig(batch_window=0.5, max_batch=2))
    assert all(rec.status == "completed" for rec in r.records)
    assert sum(e["kind"] == "admit" for e in r.event_log) >= 3


def test_admission_batches_same_bucket_ga_submissions():
    opts = {"generations": 2, "pop_size": 8, "seed": 0}
    subs = tuple(_sub(i, _chain(f"C{i}", [1.0 + i, 2.0, 3.0 + i, 1.0, 2.0, 1.0]), t=0.0, technique="ga",
                      solver_options=opts) for i in range(3))
    r = _run(Trace(name="batch", system=_two_node_system(), submissions=subs), ServiceConfig(batch_window=1.0))
    assert r.batched_groups == 1 and r.batched_submissions == 3 and r.solver_calls == 3
    assert all(rec.batched and rec.status == "completed" for rec in r.records)


def test_declined_batch_is_not_reported_as_batched():
    """The per-candidate oracle engine declines the batch fast path."""
    opts = {"generations": 2, "pop_size": 8, "seed": 0, "backend": "oracle"}
    subs = tuple(_sub(i, _chain(f"D{i}", [1.0 + i, 2.0]), t=0.0, technique="ga", solver_options=opts)
                 for i in range(2))
    r = _run(Trace(name="decline", system=_two_node_system(), submissions=subs), ServiceConfig(batch_window=0.5))
    assert [rec.status for rec in r.records] == ["completed", "completed"]
    assert r.batched_groups == 0 and not any(rec.batched for rec in r.records)
    assert r.solver_calls == 2


def test_typoed_option_and_solver_crash_reject_one_tenant():
    subs = (_sub(0, _chain("A", [1.0, 2.0]), t=0.0, technique="ga", solver_options={"popsize": 8}),
            _sub(1, _chain("B", [2.0, 1.0]), t=0.0, technique="heft"))
    r = _run(Trace(name="typo", system=_two_node_system(), submissions=subs), ServiceConfig(batch_window=0.5))
    assert [rec.status for rec in r.records] == ["rejected", "completed"]
    reg = api.SolverRegistry()

    def boom(problem, weights=None, **kw):
        raise RuntimeError("synthetic solver crash")

    reg.register("boom", boom)
    reg.register("heft", api.REGISTRY.get("heft").fn)
    subs = (_sub(0, _chain("A", [1.0, 2.0]), t=0.0, technique="boom"), subs[1])
    trace = Trace(name="crash", system=_two_node_system(), submissions=subs)
    r = _run(trace, ServiceConfig(batch_window=0.5), registry=reg)
    assert [rec.status for rec in r.records] == ["rejected", "completed"]
    assert r.records[0].reason == "RuntimeError: synthetic solver crash"
    r = _run(Trace(name="fb", system=trace.system, submissions=subs[:1]), ServiceConfig(fallback=("heft",)),
             registry=reg)
    assert r.records[0].status == "completed" and r.records[0].technique_used == "heft"
    assert r.records[0].fallbacks[0].startswith("boom:RuntimeError")


def test_drift_invalidates_cache_and_model_converges():
    wf = _chain("C", [2.0, 3.0, 1.0])
    trace = Trace(name="drift", system=_single_node_system(), submissions=(_sub(0, wf, t=0.0), _sub(1, wf, t=50.0)),
                  events=(NodeEvent(time=0.0, kind="node-drift", node="N1", factor=0.5),))
    r = _run(trace)
    r0, r1 = r.records
    assert r0.observed_makespan == pytest.approx(2.0 * r0.predicted_makespan)
    assert not r1.cache_hit and r.solver_calls == 2
    assert r1.observed_makespan == pytest.approx(r1.predicted_makespan)


def test_node_failure_routes_around_and_recovery_restores():
    wf = _chain("C", [2.0, 1.0])
    trace = Trace(name="fail", system=_two_node_system(), submissions=(_sub(0, wf, t=1.0), _sub(1, wf, t=30.0)),
                  events=(NodeEvent(time=0.0, kind="node-failure", node="N2"),
                          NodeEvent(time=20.0, kind="node-recovery", node="N2")))
    r = _run(trace)
    used: dict[str, set] = {"s000": set(), "s001": set()}
    for e in r.event_log:
        if e["kind"] == "task-finished":
            used[e["id"]].add(e["node"])
    assert used["s000"] == {"N1"} and "N2" in used["s001"]
    assert r.solver_calls == 2


def test_contention_delays_overlapping_tenants():
    wf = _chain("C", [4.0, 4.0])
    trace = Trace(name="contend", system=_single_node_system(), submissions=(_sub(0, wf, t=0.0), _sub(1, wf, t=0.0)))
    r0, r1 = _run(trace, ServiceConfig(batch_window=0.5)).records
    assert r0.queue_delay == 0.0
    assert r1.queue_delay == pytest.approx(r0.observed_makespan)


def test_release_drops_cancelled_occupancy_and_recover_does_not_resurrect():
    from repro_torch.core.simulator import ExecutionReport, TaskLog

    st = ContinuumState(_single_node_system())
    rep = ExecutionReport(logs=[TaskLog("T0", 0, 0.0, 10.0, 10.0)], makespan=10.0,
                          predicted_makespan=10.0, slowdown=1.0)
    st.reserve(rep, t0=0.0, sid="s0")
    assert st.frontier["N1"] == 10.0
    st.fail("N1")
    lost, cancelled = st.release("s0", at=1.0)
    assert lost == pytest.approx(1.0) and cancelled == 1
    st.recover("N1")
    assert st.frontier["N1"] == pytest.approx(1.0) and st.busy_seconds["N1"] == pytest.approx(1.0)
    assert st.release("s0", at=5.0) == (0.0, 0)
    for bad in (0.0, -1.0, float("nan")):
        with pytest.raises(ValueError, match="drift factor"):
            st.set_drift("N1", bad)


def test_midrun_failure_preempts_salvages_and_completes_after_recovery():
    wf = _chain("C", [2.0, 2.0, 2.0])
    trace = Trace(name="preempt", system=_single_node_system(), submissions=(_sub(0, wf, t=0.0),),
                  events=(NodeEvent(time=3.0, kind="node-failure", node="N1"),
                          NodeEvent(time=10.0, kind="node-recovery", node="N1")))
    cfg = ServiceConfig(max_retries=5, backoff_base=1.0, backoff_cap=8.0)
    r = _run(trace, cfg)
    rec = r.records[0]
    assert rec.status == "completed" and rec.retries >= 2
    assert rec.rescheduled_tasks == 2 and rec.lost_work_seconds == pytest.approx(0.75)
    pre = [e for e in r.event_log if e["kind"] == "preempted"]
    assert len(pre) == 1 and pre[0]["salvaged"] == 1
    comps = [e for e in r.event_log if e["kind"] == "completion"]
    assert len(comps) == 1 and comps[0]["time"] > 10.0
    assert r.summary()["robustness"]["makespan_stretch"]["mean"] > 1.0
    assert _run(trace, cfg).event_log == r.event_log


def test_retry_budget_exhaustion_is_terminal_failed_with_reason():
    trace = Trace(name="budget", system=_single_node_system(), submissions=(_sub(0, _chain("C", [4.0]), t=0.0),),
                  events=(NodeEvent(time=1.0, kind="node-failure", node="N1"),))
    rec = _run(trace, ServiceConfig(max_retries=1, backoff_base=0.5)).records[0]
    assert rec.status == "failed" and "retry budget exhausted (1)" in rec.reason
    assert math.isnan(rec.observed_makespan)
    json.dumps(rec.to_json(), allow_nan=False)


def test_summary_percentiles_are_nearest_rank():
    trace = generate_trace(12, seed=1, families=("tpu",))
    s = serve_trace(trace, device="cpu").summary()
    json.dumps(s, allow_nan=False)
    assert obs.nearest_rank([1.0, 2.0, 3.0, 4.0], 50) == 2.0
    assert obs.nearest_rank([3.0, 1.0, 2.0], 95) == 3.0
    assert obs.nearest_rank([5.0], 1) == 5.0
    h = obs.Histogram([1.0, 2.0])
    for v in (0.5, 1.5, 9.0):
        h.observe(v)
    assert (h.percentile(50), h.percentile(100)) == (2.0, 9.0)
    with pytest.raises(ValueError, match="empty"):
        obs.nearest_rank([], 50)
    assert s["turnaround"]["p50"] <= s["turnaround"]["p95"] <= s["turnaround"]["max"]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_trace_and_serve_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    trace_path, out_path = tmp_path / "trace.json", tmp_path / "result.json"
    gen = subprocess.run([sys.executable, "-m", "repro_torch", "trace", str(trace_path), "-n", "6", "--seed", "3",
                          "--families", "mri,tpu", "--node-events"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert gen.returncode == 0, gen.stderr
    assert trace_path.read_text() == json.dumps(
        generate_trace(6, seed=3, families=("mri", "tpu"), node_events=True).to_json(), indent=2) + "\n"
    serve = subprocess.run([sys.executable, "-m", "repro_torch", "serve", str(trace_path), "--jitter", "0.05",
                            "--seed", "7", "--records", "--device", "cpu", "--out", str(out_path)],
                           capture_output=True, text=True, env=env, timeout=300)
    assert serve.returncode == 0, serve.stderr
    summary = json.loads(serve.stdout)
    assert summary["submissions"] == summary["completed"] == 6
    assert len(summary["records"]) == 6
    assert json.loads(out_path.read_text(), parse_constant=lambda c: pytest.fail(f"bare {c}")) == summary
