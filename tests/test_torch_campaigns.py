"""The port's campaigns against the JAX package's.

Specs round-trip and expand to the reference's cells and solve keys; a
ResultSet of the same rows writes the reference's JSON, CSV, groups and gap
reports byte for byte; campaigns whose solves draw no random numbers (MILP,
HEFT, OLB, and the GA replaced by a deterministic stand-in in both packages,
``torch_reference.standin_registry``) give the reference's rows and stats
(wall columns and the pack-cache delta aside), and a traced one its virtual
fingerprint.  The real GA draws from a ``torch.Generator``, so it is held to
its own replay and to the reference's span names.  A fault of the device
layer propagates out of a campaign, and the CLI's ``campaign`` and ``obs``
print what the reference's print."""

import csv
import io
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_reference as ref_harness
from repro_torch import campaigns, obs
from repro_torch.campaigns import (
    Campaign,
    ResultSet,
    builtin,
    builtin_campaign,
    campaign_from_json,
    load_campaign,
    run_campaign,
)
from repro_torch.core import api, heuristics
from repro_torch.core import workload_model as wm
from repro_torch.engine import backends
from repro_torch.kernels._build import KernelInputError
from repro_torch.kernels.makespan import makespan_plan, population_makespan_cuda


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
EXAMPLE = str(REPO / "examples" / "campaign_table9.json")
BUILTINS = ["smoke", "table9", "service", "chaos", "engine", "cycling"]
#: the engine lane names the port's engines where the reference names its own
ENGINE_NAMES = {'"jax"': '"torch"', '"pallas"': '"cuda"', "backend=jax": "backend=torch",
                "backend=pallas": "backend=cuda"}

GA_OPTIONS = {"seed": 0, "pop_size": 16, "generations": 6}


def _grid(name, techniques, *, families=("layered", "synthetic"), sizes=(5, 10), seeds=(0,), **header):
    """The parity grid: families × sizes × seeds × techniques on 3 nodes."""
    spec = {"name": name, "runner": "inline",
            "axes": [{"name": "family", "values": list(families)}, {"name": "size", "values": list(sizes)},
                     {"name": "seed", "values": list(seeds)}, {"name": "technique", "values": list(techniques)}],
            "defaults": {"nodes": 3, "engine": "auto",
                         "solver_options": {"milp": {"time_limit": 10.0}, "ga": GA_OPTIONS}}}
    spec.update(header)
    return {"campaign": spec}


RUNS = [
    {"name": "gafree", "traced": True, "campaign": _grid("gafree", ["milp", "heft", "olb"])},
    {"name": "standin", "standin": True, "campaign": _grid("standin", ["milp", "heft", "olb", "ga"])},
    {"name": "execute", "campaign": _grid(
        "execute", ["heft", "olb"], families=("layered",), sizes=(6,), seeds=(0, 1),
        runner_options={"execute": True})},
    {"name": "perturbed", "campaign": {"campaign": {
        "name": "perturbed",
        "axes": [{"name": "perturbation", "values": [{"jitter": 0.0}, {"jitter": 0.2, "seed": 3}]}],
        "defaults": {"family": "mri", "system": "mri", "technique": "heft"},
        "runner_options": {"execute": True}}}},
    {"name": "mri-dedup", "campaign": {"campaign": {
        "name": "mri-dedup", "axes": [{"name": "size", "values": [3, 4, 5]}],
        "defaults": {"family": "mri", "system": "mri", "technique": "heft"}}}},
    {"name": "service", "standin": True, "campaign": {"campaign": {
        "name": "svc", "runner": "service",
        "axes": [{"name": "size", "values": [5, 10, 12]}, {"name": "technique", "values": ["heft", "olb", "ga"]}],
        "defaults": {"family": "layered", "nodes": 3, "seed": 0}, "runner_options": {"arrival_spacing": 0.02}}}},
    {"name": "cycling", "standin": True, "campaign": builtin_campaign("cycling").to_json()},
    {"name": "ga-traced", "traced": True, "campaign": _grid("ga", ["heft", "ga"])},
]
GA_FREE = [r["name"] for r in RUNS if r["name"] != "ga-traced"]

BAD = [
    json.dumps({"campaign": {"name": "x", "tehcniques": []}}),
    json.dumps({"campaign": {"axes": []}}),
    json.dumps({"campaing": {"name": "x"}}),
    json.dumps({"campaign": {"name": "x", "axes": [{"name": "scale", "values": [5], "zip": True}]}}),
    json.dumps({"campaign": {"name": "x", "axes": [{"name": "size", "values": [1]},
                                                   {"name": "s", "zip": True, "values": [{"size": 2}]}]}}),
    json.dumps({"campaign": {"name": "x", "axes": [{"name": "size", "values": []}]}}),
    json.dumps({"campaign": {"name": "x", "skip": [{"where": {}, "reasn": "y"}]}}),
]


def _rows() -> tuple[list[dict], list[str], dict]:
    """Result rows made from a numpy seed: a group with a failed MILP, one
    with the MILP skipped, a non-finite makespan, constrained cells, a json
    and a bool column."""
    rng = np.random.default_rng(7)
    rows = []
    for family in ("layered", "synthetic"):
        for size in (5, 10, 20):
            for tech in ("milp", "heft", "olb", "ga"):
                mk = float(np.round(rng.uniform(5, 50), 3))
                status, solve_status = "ok", "optimal" if tech == "milp" else "feasible"
                if tech == "milp" and size == 20:
                    status, mk, solve_status = "skipped(size)", None, None
                if tech == "milp" and (family, size) == ("synthetic", 10):
                    solve_status = "failed(2)"
                if (family, size, tech) == ("layered", 10, "olb"):
                    mk = float("inf")
                constrained = size == 5
                rows.append({"cell": len(rows), "family": family, "size": size, "technique": tech,
                             "solver_options": {"ga": {"seed": size}}, "status": status,
                             "solve_status": solve_status, "makespan": mk, "wall_us": float(rng.uniform(1, 1e4)),
                             "batched": bool(rng.integers(2)), "constrained": constrained,
                             "satisfied": bool(rng.integers(2)) if constrained else None,
                             "fallbacks": None if rng.integers(3) else "ga:ValueError: x"})
    return rows, ["family", "size", "technique", "solver_options"], {"makespan": "float", "cell": "int"}


ROWS, COORDS, DTYPES = _rows()


@pytest.fixture(scope="module")
def ref():
    return ref_harness.run("campaigns", {
        "builtins": BUILTINS, "files": [EXAMPLE], "bad": BAD, "rows": ROWS, "coords": COORDS,
        "dtypes": DTYPES, "runs": RUNS,
    }, timeout=600)


def _run(case: dict, **kw):
    """The port's outputs of one run case (``ref_harness.campaign_outputs``),
    its fingerprint and span names when traced, and its ResultSet."""
    reg = ref_harness.standin_registry(api, heuristics) if case.get("standin") else None
    obs.METRICS.reset()
    if case.get("traced"):
        obs.TRACER.enable()
    try:
        rs = run_campaign(campaign_from_json(case["campaign"]), registry=reg, device="cpu", **kw)
    finally:
        obs.TRACER.disable()
    out = ref_harness.campaign_outputs(rs)
    if case.get("traced"):
        out["fingerprint"] = obs.virtual_fingerprint()
        out["span_names"] = json.dumps(dict(sorted(Counter(s.name for s in obs.TRACER.spans).items())))
    return out, rs


def _ref_text(ref, key: str, spec: str) -> str:
    text = str(ref[key])
    if spec == "engine":
        for a, b in ENGINE_NAMES.items():
            text = text.replace(a, b)
    return text


def _specs():
    return {**{name: builtin_campaign(name) for name in BUILTINS}, EXAMPLE: load_campaign(EXAMPLE)}


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", BUILTINS + [EXAMPLE], ids=BUILTINS + ["example"])
def test_spec_round_trips_as_the_reference(ref, name):
    c = _specs()[name]
    assert json.dumps(c.to_json(), indent=2) == _ref_text(ref, f"spec/{name}/json", name)
    assert campaign_from_json(c.to_json()) == c
    assert json.dumps(campaign_from_json(json.dumps(c.to_json())).to_json(), indent=2) == _ref_text(
        ref, f"spec/{name}/reparsed", name)


@pytest.mark.parametrize("name", BUILTINS + [EXAMPLE], ids=BUILTINS + ["example"])
def test_expansion_and_solve_keys_equal_the_reference(ref, name):
    assert ref_harness.cell_keys(campaigns, wm, _specs()[name]) == _ref_text(ref, f"spec/{name}/cells", name)


def test_the_example_is_the_documented_48_cell_grid():
    cells = load_campaign(EXAMPLE).expand()
    assert len(cells) == 48 and not any(c.skipped for c in cells)
    assert Counter(c.coords["technique"] for c in cells) == {t: 12 for t in ("milp", "heft", "olb", "ga")}


@pytest.mark.parametrize("i", range(len(BAD)))
def test_malformed_specs_fail_as_the_reference(ref, i):
    try:
        campaign_from_json(BAD[i])
        got = ""
    except Exception as e:  # noqa: BLE001 — the message is what is compared
        got = f"{type(e).__name__}: {e}"
    assert got and got == str(ref[f"bad/{i}"])


def test_topology_is_refused():
    """A ``system: "topology"`` cell without its ``topology`` coordinate is
    refused, as in the reference; with one it runs on the generated
    continuum (the lane itself: tests/test_torch_topology.py)."""
    assert builtin_campaign("topology").defaults["system"] == "topology"
    c = Campaign(name="topo", axes=({"name": "technique", "values": ["heft"]},),
                 defaults={"system": "topology", "family": "layered", "size": 8})
    with pytest.raises(ValueError, match="'topology' coordinate"):
        run_campaign(c, device="cpu")
    rs = run_campaign(c.replace(defaults=c.defaults | {"topology": "tiny"}), device="cpu")
    assert [r["status"] for r in rs] == ["ok"]


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

def _resultset() -> ResultSet:
    return ResultSet.from_rows(ROWS, name="rows", meta={"coords": COORDS}, dtypes=DTYPES)


@pytest.mark.parametrize("key", ["json", "csv", "csv_reparsed", "json_reparsed", "groups", "aggregate",
                                 "deviation", "report", "constraints", "baseline"])
def test_resultset_equals_the_reference(ref, key):
    rs = _resultset()
    got = {
        "json": lambda: json.dumps(rs.to_json(), indent=2, sort_keys=True),
        "csv": rs.to_csv,
        "csv_reparsed": lambda: ResultSet.from_csv(rs.to_csv()).to_csv(),
        "json_reparsed": lambda: json.dumps(ResultSet.from_json(rs.to_json()).to_json(), sort_keys=True),
        "groups": lambda: json.dumps([[list(kv), len(g)] for kv, g in rs.group_by("family", "size")]),
        "aggregate": lambda: rs.aggregate("makespan", by=("technique",)).to_csv(),
        "deviation": lambda: rs.deviation_vs("milp").to_csv(),
        "report": lambda: rs.deviation_report("milp").to_csv(),
        "constraints": lambda: rs.constraint_report().to_csv(),
    }
    if key == "baseline":
        assert [rs.baseline_present("milp"), rs.baseline_present("pso")] == ref["rs/baseline"].tolist()
    else:
        assert got[key]() == str(ref[f"rs/{key}"])


def test_resultset_reports_why_a_group_has_no_baseline():
    dev = _resultset().deviation_vs("milp")
    status = {(r["family"], r["size"]): r["baseline_status"] for r in dev}
    assert status[("synthetic", 10)] == "infeasible" and status[("layered", 20)] == "skipped"
    assert status[("layered", 5)] == "ok"


# ---------------------------------------------------------------------------
# runners: parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", GA_FREE)
def test_campaign_run_equals_the_reference(ref, name):
    case = next(r for r in RUNS if r["name"] == name)
    out, _ = _run(case)
    for key in ("columns", "rows", "stats", "meta", "report"):
        if f"run/{name}/{key}" in ref:
            assert out[key] == str(ref[f"run/{name}/{key}"]), key
        else:
            assert key not in out
    if case.get("traced"):
        assert out["fingerprint"] == str(ref[f"run/{name}/fingerprint"])


def test_the_parity_cases_reach_every_path(ref):
    stats = {r["name"]: json.loads(str(ref[f"run/{r['name']}/stats"])) for r in RUNS}
    assert stats["standin"]["batched_groups"] >= 1 and stats["gafree"]["batched_groups"] == 0
    assert (stats["mri-dedup"]["solver_calls"], stats["mri-dedup"]["dedup_hits"]) == (1, 2)
    rows = json.loads(str(ref["run/execute/rows"]))
    assert all(r["observed_makespan"] is not None and r["slowdown"] is not None for r in rows)
    assert stats["service"]["summary"]["completed"] == 9 and stats["service"]["summary"]["batched_groups"] >= 1
    cyc = json.loads(str(ref["run/cycling/rows"]))
    assert any(r["status"] == "ok" and r["satisfied"] is False for r in cyc)


def test_real_ga_traced_span_names_equal_the_reference(ref):
    """The GA's draws differ between the packages, so its rows do; its
    trace has the reference's spans all the same: a batched group is one
    ``campaign.batch`` around one ``mh.ga_sweep``, every pack an
    ``engine.pack``."""
    case = next(r for r in RUNS if r["name"] == "ga-traced")
    out, rs = _run(case)
    names = json.loads(out["span_names"])
    assert names == json.loads(str(ref["run/ga-traced/span_names"]))
    assert names["mh.ga_sweep"] == json.loads(out["stats"])["batched_groups"] >= 1
    assert names["engine.pack"] > 0
    assert out["stats"] == str(ref["run/ga-traced/stats"])


# ---------------------------------------------------------------------------
# runners: the reference's invariants, on the port
# ---------------------------------------------------------------------------

def test_identical_cells_solve_once():
    _, rs = _run(next(r for r in RUNS if r["name"] == "mri-dedup"))
    stats = rs.meta["stats"]
    assert (stats["solver_calls"], stats["dedup_hits"]) == (1, 2)
    assert rs.column("dedup") == [False, True, True] and rs.column("dedup_of") == [None, 0, 0]
    assert len(set(rs.column("makespan"))) == 1


def test_same_bucket_ga_cells_batch_and_a_rerun_hits_the_pack_cache():
    c = campaign_from_json(_grid("pair", ["ga"], families=("layered",), sizes=(10, 12)))
    first = run_campaign(c, device="cpu")
    assert first.meta["stats"]["batched_groups"] == 1
    assert first.column("batched") == [True, True] and first.column("group_size") == [2, 2]
    again = run_campaign(c, device="cpu")
    pack = again.meta["stats"]["pack_cache"]
    assert pack["misses"] == 0 and pack["hits"] >= 2
    assert again.column("makespan") == first.column("makespan")


def test_real_ga_grid_replays_identically_on_the_cpu():
    c = campaign_from_json(_grid("replay", ["heft", "ga"]))
    a, b = (ref_harness.campaign_outputs(run_campaign(c, device="cpu")) for _ in range(2))
    assert a == b
    rows = json.loads(a["rows"])
    assert all(r["status"] == "ok" for r in rows) and any(r["batched"] for r in rows)


def test_device_reaches_every_engine_aware_solve(monkeypatch):
    seen = []
    entry = api.REGISTRY.get("ga")

    def spy_batch(problems, weights=None, **kw):
        seen.append(("batch", kw.get("device")))
        return entry.batch_fn(problems, weights, **kw)

    def spy_fn(problem, weights=None, **kw):
        seen.append(("single", kw.get("device")))
        return entry.fn(problem, weights, **kw)

    reg = api.SolverRegistry()
    for e in api.REGISTRY:
        reg.register(e.name, spy_fn if e.name == "ga" else e.fn, batch_fn=spy_batch if e.name == "ga" else e.batch_fn,
                     engine_aware=e.capabilities.engine_aware)
    c = campaign_from_json(_grid("dev", ["heft", "ga"], families=("layered",), sizes=(5, 10, 12)))
    run_campaign(c, registry=reg, device="cpu")
    assert sorted(seen) == [("batch", "cpu"), ("single", "cpu")]


# ---------------------------------------------------------------------------
# device faults propagate; a tenant's own fault is still a failed row
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [(10, 12), (5,)], ids=["batch", "single"])
@pytest.mark.parametrize("fault", [KernelInputError("synthetic refusal"),
                                   torch.OutOfMemoryError("synthetic out of memory")],
                         ids=["kernel-input", "out-of-memory"])
def test_device_faults_propagate_out_of_a_campaign(monkeypatch, fault, sizes):
    calls = []

    def failing(*args, **kw):
        calls.append(tuple(args[0].shape))
        raise fault

    monkeypatch.setattr(backends.CudaEngine, "makespan_fn", staticmethod(failing))
    c = campaign_from_json(_grid("fault", ["ga"], families=("layered",), sizes=sizes))
    with pytest.raises(type(fault), match="synthetic"):
        run_campaign(c, device="cpu")
    assert len(calls) == 1 and calls[0][0] == len(sizes)  # one call, no retry singly


def test_a_bad_option_is_still_a_failed_row():
    """The departure is for device faults only: an option the GA does not
    take fails the batched group, whose members then run singly and fail
    one row each, as in the reference."""
    c = campaign_from_json(_grid("bad", ["ga", "heft"], families=("layered",), sizes=(10, 12)))
    c = c.replace(defaults={**c.defaults, "solver_options": {"ga": {"popsize": 8}}})
    rs = run_campaign(c, device="cpu")
    status = dict(zip(zip(rs.column("size"), rs.column("technique")), rs.column("status")))
    assert status[(10, "heft")] == status[(12, "heft")] == "ok"
    assert status[(10, "ga")] == status[(12, "ga")] == "failed(TypeError)"
    assert rs.meta["stats"]["batched_groups"] == 0


def test_cli_exits_non_zero_on_a_device_fault(tmp_path):
    (tmp_path / "c.json").write_text(json.dumps(_grid("fault", ["heft", "ga"], families=("layered",), sizes=(10, 12))))
    code = (
        "import sys, torch\n"
        "from repro_torch.engine import backends\n"
        "from repro_torch.kernels._build import KernelInputError\n"
        "def failing(*a, **k):\n"
        "    raise KernelInputError('synthetic refusal')\n"
        "backends.CudaEngine.makespan_fn = staticmethod(failing)\n"
        "from repro_torch.__main__ import main\n"
        f"sys.exit(main(['campaign', 'run', {str(tmp_path / 'c.json')!r}, '--device', 'cpu']))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode != 0
    assert "KernelInputError: synthetic refusal" in proc.stderr
    assert "failed(" not in proc.stdout


# ---------------------------------------------------------------------------
# the kernel's launch plan at every lane's bucket
# ---------------------------------------------------------------------------

H100 = {"sm_count": 132, "max_smem": 232448}  # SMs and opt-in shared memory a block


def _lane_shapes(monkeypatch) -> dict[str, set]:
    """Every (B, P, T, N, CMAX) the makespan wrapper receives on the
    campaign lanes' GA and ``cuda`` paths, recorded on the CPU."""
    shapes: dict[str, set] = {}
    lane = ["?"]

    def spy(assignments, **arrays):
        a = assignments if assignments.dim() == 3 else assignments[None]
        n, c = arrays["init_free"].shape[-2:]
        shapes.setdefault(lane[0], set()).add((a.shape[0], a.shape[1], a.shape[2], n, c))
        return population_makespan_cuda(assignments, **arrays)

    monkeypatch.setattr(backends.CudaEngine, "makespan_fn", staticmethod(spy))
    ga_only = {"technique": ["ga"]}
    for name, c in (("table9", load_campaign(EXAMPLE).replace(include=(ga_only,))),
                    ("smoke", builtin_campaign("smoke").replace(include=(ga_only,))),
                    ("cycling", builtin_campaign("cycling").replace(include=(ga_only,)))):
        lane[0] = name
        run_campaign(c, device="cpu")
    lane[0] = "engine"
    run_campaign(builtin_campaign("engine").replace(include=({"backend": ["cuda"]},)), device="cpu")
    return shapes


def test_every_campaign_lane_bucket_fits_the_kernel_plan(monkeypatch):
    shapes = _lane_shapes(monkeypatch)
    assert set(shapes) == {"table9", "smoke", "cycling", "engine"}
    # the engine lane's three buckets, singly and as the 8-instance families
    assert {(s[2], s[3]) for s in shapes["engine"]} >= {(24, 4), (96, 8), (384, 16)}
    assert any(s[0] == 8 for s in shapes["engine"]) and any(s[0] > 1 for s in shapes["table9"])
    for name, lane in shapes.items():
        for B, P, T, N, C in lane:
            plan = makespan_plan(B, P, T, N, C, **H100)
            assert plan.blocks * plan.warps >= B * P and plan.smem <= H100["max_smem"], (name, B, P, T, N, C)


# ---------------------------------------------------------------------------
# the lanes' exporters (to a temporary directory, never the repo's BENCH files)
# ---------------------------------------------------------------------------

def test_exporters_write_only_where_they_are_told(tmp_path):
    before = {p.name: p.stat().st_mtime_ns for p in REPO.glob("BENCH_*.json")}
    rows = builtin.run_smoke(tmp_path / "t9.json", device="cpu")
    payload = json.loads((tmp_path / "t9.json").read_text())
    assert [r[0] for r in rows] == ["table9_5x5_milp", "table9_5x5_mh", "table9_5x5_h", "table9_50x50_milp",
                                    "table9_50x50_mh", "table9_50x50_h"]
    assert payload["table9_5x5_milp"]["derived"].startswith("makespan=6.15;status=optimal")
    assert set(payload["telemetry"]) == {"metrics", "engine_fitness", "spans"}
    run = builtin.run_named_campaign("smoke", out_path=tmp_path / "c.json", device="cpu")
    assert len(run.result) == 6 and json.loads((tmp_path / "c.json").read_text())["deviation_vs"]
    eng = builtin.run_engine_bench_export(tmp_path / "eng.json", device="cpu")
    names = [r[0] for r in eng]
    assert {"engine_small_oracle", "engine_small_torch", "engine_small_cuda", "engine_large_shard1"} <= set(names)
    scaling = json.loads((tmp_path / "eng.json").read_text())["device_scaling"]
    assert scaling["devices_available"] == 1 and set(scaling["shapes"]) == {"medium", "large"}
    assert all(set(s["per_device"]) == {"1"} for s in scaling["shapes"].values())
    assert {p.name: p.stat().st_mtime_ns for p in REPO.glob("BENCH_*.json")} == before


def test_cycling_lane_with_the_standin_and_its_converging_section(ref, tmp_path, monkeypatch):
    monkeypatch.setattr(campaigns.runner, "REGISTRY", ref_harness.standin_registry(api, heuristics))
    rows = builtin.run_cycling_bench(tmp_path / "cyc.json", device="cpu")
    payload = json.loads((tmp_path / "cyc.json").read_text())
    lane = ResultSet.from_json(payload["campaign"])
    assert ref_harness.campaign_outputs(lane)["rows"] == str(ref["run/cycling/rows"])
    service = payload["converging_service"]
    assert service["replay_bit_identical"] is True
    assert service["replay_fingerprint"] == "820bbd5dcab25e9a644031ba39cdcd0ed4e0e34b33bf20c0e3c0d8844d2d15cb"
    assert any(r[0] == "cycling_deviation_cells" and "infeasible_baseline=" in r[2] for r in rows)


# ---------------------------------------------------------------------------
# CLI: campaign expand | run | report, and obs, against the reference's
# ---------------------------------------------------------------------------

def _cli(*argv):
    proc = subprocess.run([sys.executable, "-m", "repro_torch", *argv], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    return proc


def _drop_wall(text: str) -> list[dict]:
    """A ``campaign run`` CSV's rows without the wall columns, and the gap
    report after it."""
    table, _, report = text.partition("# deviation")
    rows = [{k: v for k, v in r.items() if k not in ref_harness.CAMPAIGN_WALL_COLUMNS}
            for r in csv.DictReader(io.StringIO(table))]
    return [rows, report]


def test_cli_equals_the_reference_cli(tmp_path):
    spec = tmp_path / "grid.json"
    spec.write_text(json.dumps(_grid("cli", ["milp", "heft", "olb"])))
    # a trace the port writes, for both packages' ``obs``
    obs.TRACER.enable()
    try:
        run_campaign(campaign_from_json(_grid("t", ["heft"], sizes=(5,))), device="cpu")
    finally:
        obs.TRACER.disable()
    trace = obs.write_trace(tmp_path / "port.trace.json")
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    argvs = [["campaign", "expand", str(spec)], ["campaign", "expand", "table9"],
             ["campaign", "run", str(spec), "--out", str(ref_out)],
             ["obs", str(trace)], ["obs", str(trace), "--json"], ["obs", str(spec)]]
    ref = ref_harness.run("cli", {"argvs": argvs})
    port_argvs = [a + ["--device", "cpu", "--out", str(port_out)] if a[:2] == ["campaign", "run"] else a
                  for a in argvs]
    port_argvs[2] = ["campaign", "run", str(spec), "--device", "cpu", "--out", str(port_out)]
    for i, argv in enumerate(port_argvs):
        proc = _cli(*argv)
        assert proc.returncode == int(ref[f"{i}/rc"]), (argv, proc.stderr)
        if argv[:2] == ["campaign", "run"]:
            assert _drop_wall(proc.stdout) == _drop_wall(str(ref[f"{i}/stdout"]))
        else:
            assert proc.stdout == str(ref[f"{i}/stdout"]), argv
    # each package's report on the other's saved results
    reports = [["campaign", "report", str(ref_out)], ["campaign", "report", str(port_out), "--per-cell"],
               ["campaign", "report", str(port_out), "--vs", "heft"]]
    ref = ref_harness.run("cli", {"argvs": reports})
    for i, argv in enumerate(reports):
        proc = _cli(*argv)
        assert proc.returncode == 0 == int(ref[f"{i}/rc"]), proc.stderr
        assert proc.stdout == str(ref[f"{i}/stdout"]), argv
