"""The port's scenario API, orchestrator and CLI against the JAX
package's: scenario files round-trip byte for byte between the two
packages with equal fingerprints, malformed files fail with the same
did-you-mean text, the §VII policy routes each size to the same technique,
the closed loop gives the same summaries and rendered artifacts, and
``python -m repro_torch`` runs on the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_reference as ref_harness
from repro_torch.core import api, ga_sweep, system_model as sm, verify_schedule, workload_model as wm
from repro_torch.core.heuristics import heft
from repro_torch.core.simulator import execute
from repro_torch.core.snakemake_io import parse_rules
from repro_torch.kernels._build import KernelError

REPO = Path(__file__).resolve().parents[1]
MRI = {"kind": "mri"}
SCENARIOS = [
    {"name": "mri-auto", "problem": MRI, "run": True},
    {"name": "mri-drift-heft", "problem": MRI, "technique": "heft", "run": True,
     "perturbation": {"speed_factors": {"N2": 0.4}},
     "orchestration": {"max_rounds": 3, "drift_threshold": 0.1, "smoothing": 1.0}},
    {"name": "mri-drift-auto", "problem": MRI, "run": True,
     "perturbation": {"speed_factors": {"N2": 0.4}}},
    {"name": "mri-slurm", "problem": MRI, "technique": "heft", "backend": "slurm", "run": True},
    {"name": "mri-k8s", "problem": MRI, "technique": "olb", "backend": "kubernetes", "run": True},
    {"name": "constrained-chain",
     "problem": {"kind": "constrained", "tasks": 20, "nodes": 8, "seed": 5,
                 "deadline": 9.0, "budget": 120.0},
     "technique": "ga", "engine": "oracle", "policy": ["milp", "ga", "heft"],
     "weights": {"alpha": 0.5, "beta": 2.0, "usage_mode": "weighted"},
     "solver_options": {"ga": {"pop_size": 8}, "milp": {"time_limit": 5.0}},
     "perturbation": {"speed_factors": {"n1": 0.7}, "jitter": 0.05, "seed": 3}},
]
ROUTE = [
    {"kind": "synthetic", "tasks": 10, "nodes": 4, "seed": 1},
    {"kind": "synthetic", "tasks": 30, "nodes": 8, "seed": 7},
    {"kind": "synthetic", "tasks": 700, "nodes": 20, "seed": 0},
]
ROUTE_OPTIONS = {"ga": {"pop_size": 8, "generations": 2}}
CONSTRAINED = SCENARIOS[-1]["problem"]
WEIGHTS = [{}, {"alpha": 0.5, "beta": 2.0, "usage_mode": "weighted"}]
FALLBACK = {"kind": "synthetic", "tasks": 61, "nodes": 4, "seed": 0}  # past MILP's size limit
FAMILY = [
    {"kind": "synthetic", "tasks": 20, "nodes": 6, "seed": 1},
    {"kind": "synthetic", "tasks": 13, "nodes": 5, "seed": 2},
    {"kind": "mri"},
]


def _populations():
    rng = np.random.default_rng(4)
    out = {}
    for b, spec in enumerate(FAMILY):
        prob = ref_harness.build(spec, sm, wm)
        out[f"family/{b}"] = rng.integers(0, prob.num_nodes, (5 + b, prob.num_tasks)).astype(np.int32)
    # rows with ties, and which smallest to take in each
    out["kth/rows"] = rng.integers(0, 4, (4, 3, 8)).astype(np.float32)
    out["kth/c"] = rng.integers(1, 9, (4, 3)).astype(np.int32)
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These loops run thousands of small ops; with the several pytest
    workers a test run starts side by side, each op's intra-op thread team
    waits on the others' and the file takes ten times as long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scenario(spec):
    return ref_harness.scenario_of(spec, api, sm, wm)


def _text(sc) -> str:
    return json.dumps(sc.to_json(), indent=2)


def _bad_files() -> list[str]:
    base = _scenario(SCENARIOS[0]).to_json()

    def edit(fn):
        obj = json.loads(json.dumps(base))
        fn(obj)
        return json.dumps(obj)

    return [
        edit(lambda o: o["scenario"].update(tehcnique="ga")),
        edit(lambda o: o.update(nodez=o.pop("nodes"))),
        edit(lambda o: o["scenario"]["perturbation"].update(speed_factor={})),
        edit(lambda o: o["scenario"]["orchestration"].update(max_round=2)),
        edit(lambda o: o["scenario"].update(policy={"rules": [{"techniqe": "ga"}]})),
        edit(lambda o: o["scenario"]["weights"].update(alfa=2.0)),
        edit(lambda o: o.update(constraints={"deadlines": {}})),
        edit(lambda o: o["scenario"].update(policy={"rulez": []})),
    ]


@pytest.fixture(scope="module")
def ref():
    inputs = {f"{s['name']}/port_json": np.array(_text(_scenario(s))) for s in SCENARIOS}
    inputs.update(_populations())
    return ref_harness.run(
        "scenario",
        {"scenarios": SCENARIOS, "bad": _bad_files(), "route": ROUTE, "route_options": ROUTE_OPTIONS,
         "constrained": CONSTRAINED, "family": FAMILY, "weights": WEIGHTS, "fallback": FALLBACK},
        inputs,
    )


@pytest.mark.parametrize("spec", SCENARIOS, ids=[s["name"] for s in SCENARIOS])
def test_scenario_json_round_trips_byte_for_byte(ref, spec):
    """Written by either package, the file is the same; read and written
    again by either, it is the same again (the first read turns integer
    resources into floats, in both packages), and then a fixed point."""
    name = spec["name"]
    ref_text = str(ref[f"{name}/json"])
    assert _text(_scenario(spec)) == ref_text
    reread = _text(api.scenario_from_json(ref_text))
    assert reread == str(ref[f"{name}/reparsed"])
    assert _text(api.scenario_from_json(reread)) == reread
    assert _scenario(spec).fingerprint() == str(ref[f"{name}/fingerprint"])
    assert api.scenario_from_json(reread).fingerprint() == api.scenario_from_json(ref_text).fingerprint()


@pytest.mark.parametrize("i", range(len(_bad_files())))
def test_malformed_files_fail_with_the_reference_message(ref, i):
    text = _bad_files()[i]
    with pytest.raises(ValueError) as e:
        api.scenario_from_json(text)
    assert f"ValueError: {e.value}" == str(ref[f"bad/{i}"])
    assert "did you mean" in str(e.value) or "unknown keys" in str(e.value)


@pytest.mark.parametrize("spec", ROUTE, ids=[ref_harness.name_of(s) for s in ROUTE])
def test_policy_routes_each_size_as_the_reference(ref, spec):
    name = ref_harness.name_of(spec)
    prob = ref_harness.build(spec, sm, wm)
    rep = api.route_problem(prob, technique="auto", options=ROUTE_OPTIONS, device="cpu")
    assert rep.schedule.technique == str(ref[f"route/{name}/technique"])
    assert json.dumps(list(rep.fallbacks)) == str(ref[f"route/{name}/fallbacks"])
    if rep.schedule.technique != "ga":  # GA's draws differ between the packages
        assert rep.schedule.makespan == float(ref[f"route/{name}/makespan"])


@pytest.mark.parametrize("spec", [s for s in SCENARIOS if s.get("run")],
                         ids=[s["name"] for s in SCENARIOS if s.get("run")])
def test_orchestrator_summary_equals_reference(ref, spec, tmp_path):
    name = spec["name"]
    result = api.Orchestrator(_scenario(spec), out_dir=tmp_path, device="cpu").run()
    summary = result.summary()
    arts = summary.pop("artifacts", [])
    assert json.dumps(summary, sort_keys=True) == str(ref[f"{name}/summary"])
    got = json.dumps({Path(p).name: Path(p).read_text() for p in arts}, sort_keys=True)
    assert got == str(ref[f"{name}/artifacts"])


def test_drift_run_adapts_from_25_to_10_02(ref):
    """The reference's recorded adaptation (N2 at 0.4× its modelled speed):
    observed 25.0 s before the re-solve, 10.02 s after."""
    s = api.run_scenario(_scenario(SCENARIOS[1]), device="cpu").summary()
    assert s["adapted"] and s["initial_observed_makespan"] == 25.0
    assert s["observed_makespan"] == pytest.approx(10.02)


def test_replay_under_jitter_and_fig6_parse_match(ref):
    prob = ref_harness.build(MRI, sm, wm)
    xrep = execute(prob, heft(prob), speed_factors=np.array([1.0, 0.5, 1.3]), jitter=0.1, seed=3)
    np.testing.assert_array_equal([log.start for log in xrep.logs], ref["execute/start"])
    np.testing.assert_array_equal([log.finish for log in xrep.logs], ref["execute/finish"])
    assert json.dumps(xrep.observed_speed_factors(prob), sort_keys=True) == str(ref["execute/factors"])
    wf = parse_rules(ref_harness.FIG6_SNAKEFILE)
    assert json.dumps(wm.workload_to_json(wm.Workload((wf,)))) == str(ref["fig6"])


def test_model_layer_pieces_match(ref):
    """The pieces of the model layer the scenario path needs: the Test
    Case I workflows, constraints JSON both ways, the node views and the
    executor's sorted schedule JSON."""
    tc1 = wm.testcase1_workloads()
    assert json.dumps(list(tc1)) == str(ref["testcase1/names"])
    assert json.dumps(wm.workload_to_json(wm.Workload(tuple(tc1.values())))) == str(ref["testcase1"])
    cons = ref_harness.constraints_of(CONSTRAINED, wm)
    assert json.dumps(cons.to_json()) == str(ref["constraints"])
    assert json.dumps(wm.constraints_from_json(cons.to_json()).to_json()) == str(ref["constraints/reparsed"])
    with pytest.raises(ValueError, match="unknown keys"):
        wm.constraints_from_json({"deadlines": {}})
    system = ref_harness.system_of(CONSTRAINED, sm)
    np.testing.assert_array_equal(system.feature_matrix(["F1", "F2", "F3", "F9"]), ref["features"])
    np.testing.assert_array_equal(system.memory(), ref["memory"])
    assert system.index(system.nodes[-1].name) == int(ref["index"])
    with pytest.raises(KeyError):
        system.index("nowhere")
    dc = sm.DataCenter("dc", (sm.Cluster("a", system.nodes[:2]), sm.Cluster("b", system.nodes[2:])))
    assert dc.all_nodes() == system.nodes
    prob = ref_harness.build(MRI, sm, wm)
    names = [n.name for n in sm.mri_system().nodes]
    assert json.dumps(heft(prob).to_json(prob, names)) == str(ref["schedule_json"])


@pytest.mark.parametrize("engine", ["torch", "oracle"])
def test_evaluate_population_batch_matches(ref, engine):
    """Per-instance populations over a family of three shape buckets: each
    instance's objectives and makespans equal the reference's batched jax
    engine's (fixed usage: bit for bit)."""
    from repro_torch.core import evaluate_population_batch

    fam = [ref_harness.build(spec, sm, wm) for spec in FAMILY]
    pops = _populations()
    if engine == "oracle":  # the per-candidate oracle has no batched path
        from repro_torch.engine import ENGINES

        got = [ENGINES.get("oracle").evaluate_population(p, pops[f"family/{b}"], device="cpu")
               for b, p in enumerate(fam)]
    else:
        got = evaluate_population_batch(fam, [pops[f"family/{b}"] for b in range(len(fam))],
                                        backend=engine, device="cpu")
    for b, (obj, mk) in enumerate(got):
        np.testing.assert_array_equal(mk, ref[f"family/{b}/mk"])
        np.testing.assert_array_equal(obj.astype(np.float32), ref[f"family/{b}/obj"])


def test_select_kth_smallest_is_stable(ref):
    from repro_torch.kernels.select import kth_smallest

    row = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.0, 0.0, 5.0, -1.0]])
    np.testing.assert_array_equal(kth_smallest(row, torch.tensor([2, 3])).numpy(), [1.0, 0.0])
    np.testing.assert_array_equal(kth_smallest(row, torch.tensor([4, 1])).numpy(), [3.0, -1.0])
    # rows with ties: the reference's values, bit for bit
    pops = _populations()
    got = kth_smallest(torch.from_numpy(pops["kth/rows"]), torch.from_numpy(pops["kth/c"]))
    np.testing.assert_array_equal(got.numpy(), ref["kth"])


@pytest.mark.parametrize("engine", ["auto", "torch"])
def test_fitness_functions_match(ref, engine):
    """``make_fitness_fn`` and ``fitness_from_arrays`` on each instance of
    the family, under fixed and weighted usage: the reference's objectives
    and makespans bit for bit."""
    from repro_torch.core import ObjectiveWeights
    from repro_torch.core.evaluator import fitness_from_arrays, make_fitness_fn
    from repro_torch.engine.packed import pack

    pops = _populations()
    for i, w in enumerate(WEIGHTS):
        weights = ObjectiveWeights(**w)
        for b, spec in enumerate(FAMILY):
            prob = ref_harness.build(spec, sm, wm)
            pop = torch.from_numpy(pops[f"family/{b}"])
            obj, mk = make_fitness_fn(prob, weights, backend=engine, device="cpu")(pop)
            np.testing.assert_array_equal(mk.numpy(), ref[f"fitness/{i}/{b}/mk"])
            np.testing.assert_array_equal(obj.numpy(), ref[f"fitness/{i}/{b}/obj"])
            obj, mk = fitness_from_arrays(pop, pack(prob, pad=False).device_arrays("cpu"), weights.alpha,
                                          weights.beta, weights.usage_mode, engine=engine)
            np.testing.assert_array_equal(mk.numpy(), ref[f"arrays/{i}/{b}/mk"])
            np.testing.assert_array_equal(obj.numpy(), ref[f"arrays/{i}/{b}/obj"])


def test_solve_problems_batches_the_ga_family():
    """``solve_problems(technique="ga")`` goes through ``ga_sweep``: one
    batched fitness call per generation, the same schedules as a direct
    sweep at the same seed."""
    probs = [ref_harness.build({"kind": "synthetic", "tasks": 12 + b, "nodes": 5, "seed": b}, sm, wm)
             for b in range(3)]
    opts = {"pop_size": 8, "generations": 3, "seed": 2}
    reps = api.solve_problems(probs, "ga", device="cpu", **opts)
    direct = ga_sweep(probs, device="cpu", **opts)
    for rep, d, p in zip(reps, direct, probs):
        np.testing.assert_array_equal(rep.schedule.assignment, d.schedule.assignment)
        np.testing.assert_array_equal(rep.history, d.history)
        assert verify_schedule(p, rep.schedule) == []
    # the per-candidate oracle declines batching and runs instance by instance
    assert api._ga_batch(probs, backend="oracle", device="cpu", **opts) is None


def test_device_reaches_engine_aware_techniques_only():
    opts = api.fold_engine_options(api.REGISTRY, {"milp": {"time_limit": 3.0}}, "torch", "cpu")
    for t in ("ga", "pso", "sa", "aco"):
        assert opts[t] == {"backend": "torch", "device": "cpu"}
    assert opts["milp"] == {"time_limit": 3.0}
    assert "heft" not in opts


def test_topology_section_is_refused():
    """A scenario file names one system source: a ``topology`` section beside
    ``nodes`` is refused, as in the reference; alone, it generates the
    continuum (tests/test_torch_topology.py holds that to the reference)."""
    obj = _scenario(SCENARIOS[0]).to_json()
    with pytest.raises(ValueError, match="pick one system source"):
        api.scenario_from_json(obj | {"topology": "tiny"})
    alone = api.scenario_from_json({k: v for k, v in obj.items() if k not in ("nodes", "dtr_matrix")}
                                   | {"topology": "tiny"})
    assert alone.system.num_nodes == 16


def test_fallback_chain_survives_a_failing_step(ref):
    """MILP refuses 61 tasks and the chain degrades to HEFT: the same error
    trail as the reference's, and the same spans when traced."""
    from repro_torch import obs

    prob = ref_harness.build(FALLBACK, sm, wm)
    obs.TRACER.enable()
    try:
        rep = api.solve_with_fallback(prob, technique="milp", chain=("heft",), device="cpu")
    finally:
        obs.TRACER.disable()
    assert rep.schedule.technique == "heft"
    assert rep.fallbacks and rep.fallbacks[0].startswith("milp:MilpSizeError")
    assert json.dumps(list(rep.fallbacks)) == str(ref["fallback/trail"])
    spans = [[s.id, s.parent, s.name, s.cat, sorted(s.args.items())] for s in obs.TRACER.spans]
    assert json.dumps(spans) == str(ref["fallback/spans"])


@pytest.mark.parametrize("fault", [KernelError("synthetic launch failure"),
                                   torch.OutOfMemoryError("synthetic out of memory")],
                         ids=["kernel", "out-of-memory"])
def test_fallback_re_raises_device_faults(monkeypatch, fault):
    """A fault of the device layer inside a GA step propagates: the chain
    does not degrade past it to HEFT on the host."""
    import repro_torch.kernels.makespan as mk

    def failing(*args, **kw):
        raise fault

    monkeypatch.setattr(mk, "population_makespan_ref", failing)  # what the wrapper runs for CPU tensors
    prob = ref_harness.build({"kind": "synthetic", "tasks": 12, "nodes": 4, "seed": 0}, sm, wm)
    with pytest.raises(type(fault), match="synthetic"):
        api.solve_with_fallback(prob, technique="ga", chain=("heft",), engine="cuda", device="cpu",
                                options={"ga": {"pop_size": 8, "generations": 2}})


def test_fallback_degrades_past_a_crashing_solver():
    """A solver-level fault still degrades, as in the reference."""
    reg = api.SolverRegistry()

    def boom(problem, weights=None, **kw):
        raise RuntimeError("synthetic solver crash")

    reg.register("boom", boom)
    reg.register("heft", api.REGISTRY.get("heft").fn)
    rep = api.solve_with_fallback(ref_harness.build(MRI, sm, wm), technique="boom", chain=("heft",),
                                  registry=reg, device="cpu")
    assert rep.schedule.technique == "heft" and rep.schedule.violations == 0
    assert rep.fallbacks[0] == "boom:RuntimeError: synthetic solver crash"


@pytest.mark.parametrize("args", [["techniques"], ["engines"], ["run", "{path}", "--device", "cpu"]],
                         ids=["techniques", "engines", "run"])
def test_cli_runs_on_the_cpu(ref, args, tmp_path):
    path = tmp_path / "mri.json"
    path.write_text(str(ref["mri-auto/json"]))
    out = tmp_path / "out.json"
    argv = [a.format(path=path) for a in args] + (["--out", str(out)] if args[0] == "run" else [])
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", *argv], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")}, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    if args[0] == "run":
        summary = json.loads(out.read_text())
        assert summary["technique"] == "milp[event]"
        assert summary["predicted_makespan"] == json.loads(str(ref["mri-auto/summary"]))["predicted_makespan"]
        assert abs(summary["predicted_makespan"] - 10.0) <= np.spacing(10.0)
    else:
        assert "ga" in proc.stdout or "cuda" in proc.stdout


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 40
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"
