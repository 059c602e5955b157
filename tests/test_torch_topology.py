"""The port's topology layer (``repro_torch.topology``): the reference's
own cases (``tests/test_topology.py``) run against the port, then the port
held to the reference itself through one child job (``tests/torch_reference.py``
job ``topology``).

The reference's cases:

* determinism — same spec/seed ⇒ byte-identical System JSON (fuzzed),
* spec JSON round trip + strict parsing,
* tier invariants — counts, speed ranges, and the latency hierarchy
  (HPC island links > intra-HPC > any inter-tier path),
* System dtr validation fail-fast (NaN / negative / non-square) and the
  lossless +inf ↔ -1.0 JSON round trip,
* calibration recovery (Adam on the CPU here) — 0.5–2.0× perturbed speeds fitted back within
  5% relative MAE, twin makespan error shrinking after calibration,
* integration — campaign `topology` axis, inline Scenario topology.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.core import Workload, build_problem, random_layered_workflow
from repro_torch.engine import pack
from repro_torch.core.system_model import (
    System,
    make_system,
    mri_system,
    system_from_json,
    system_to_json,
)
from repro_torch.topology import (
    LinkProfile,
    PRESETS,
    TierSpec,
    TopologySpec,
    cached_system,
    calibrate,
    calibration_report,
    generate,
    island_ids,
    least_squares_factors,
    perturbed_truth,
    resolve_spec,
    spec_from_json,
    synthesize_observations,
    tier_slices,
    tiered_spec,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These loops run thousands of small ops; with the several pytest
    workers a test run starts side by side, each op's intra-op thread team
    waits on the others' and the file takes ten times as long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system_bytes(system) -> bytes:
    return json.dumps(system_to_json(system), sort_keys=True).encode()


# ---------------------------------------------------------------------------
# spec validation + round trip
# ---------------------------------------------------------------------------


def test_link_profile_folds_latency_into_rate():
    # effective rate = S / (latency + S / bandwidth): latency-free links
    # saturate at the bandwidth, chatty links are dominated by latency
    ideal = LinkProfile(bandwidth=1.25)
    assert ideal.effective_rate(0.0625) == pytest.approx(1.25)
    wan = LinkProfile(bandwidth=1.25, latency=2e-2)
    assert wan.effective_rate(0.0625) < 1.25
    # smaller reference transfers pay proportionally more latency
    assert wan.effective_rate(0.001) < wan.effective_rate(0.0625)


def test_path_profile_chains_uplinks():
    spec = tiered_spec(1)
    iot, hpc = 0, 3
    path = spec.path_profile(iot, hpc)
    uplinks = [spec.tiers[i].uplink for i in range(iot, hpc)]
    assert path.bandwidth == min(u.bandwidth for u in uplinks)
    assert path.latency == pytest.approx(sum(u.latency for u in uplinks))
    # symmetric: same path class in both directions
    back = spec.path_profile(hpc, iot)
    assert back == path


def test_spec_json_round_trip_and_fingerprint():
    spec = tiered_spec(2, seed=11, name="rt")
    again = spec_from_json(spec.to_json())
    assert again == spec
    assert again.fingerprint() == spec.fingerprint()
    # bare header (no {"topology": ...} wrapper) parses too
    assert spec_from_json(spec.to_json()["topology"]) == spec
    # a spec edit changes the fingerprint
    assert spec.replace(seed=12).fingerprint() != spec.fingerprint()


def test_spec_validation_fails_fast():
    with pytest.raises(ValueError, match="at least one tier"):
        TopologySpec(name="empty", tiers=())
    tier = tiered_spec(1).tiers[0]
    with pytest.raises(ValueError, match="duplicate tier"):
        TopologySpec(name="dup", tiers=(tier, tier))
    with pytest.raises(ValueError, match="ref_transfer_mb"):
        TopologySpec(name="bad", tiers=(tier,), ref_transfer_mb=0.0)
    with pytest.raises(ValueError, match="island_link"):
        TierSpec(
            name="hpc", count=4, speed=(1.0, 2.0), cores=(8,),
            memory=(1.0, 2.0), features=("F1",),
            link=LinkProfile(bandwidth=1.0),
            uplink=LinkProfile(bandwidth=1.0),
            islands=2,  # islands > 1 without an island_link
        )
    with pytest.raises(ValueError, match="unknown"):
        spec_from_json({"name": "x", "tiers": [], "bogus": 1})


def test_resolve_spec_presets_and_errors():
    assert resolve_spec("tiny").num_nodes == 16
    assert resolve_spec("small").num_nodes == 64
    spec = tiered_spec(1)
    assert resolve_spec(spec) is spec
    assert resolve_spec(spec.to_json()) == spec
    assert resolve_spec(json.dumps(spec.to_json())) == spec
    with pytest.raises(ValueError, match="unknown topology preset"):
        resolve_spec("tinny")


# ---------------------------------------------------------------------------
# deterministic expansion
# ---------------------------------------------------------------------------


def test_generate_bit_identical_at_fixed_seed():
    spec = tiered_spec(2, seed=3)
    assert _system_bytes(generate(spec)) == _system_bytes(generate(spec))
    # a different seed reshuffles draws (jitter + speeds)
    other = generate(spec.replace(seed=4))
    assert _system_bytes(other) != _system_bytes(generate(spec))


def test_cached_system_memoizes_by_fingerprint():
    spec = tiered_spec(1, seed=9, name="memo")
    first = cached_system(spec)
    # an equal-but-distinct spec object maps to the same System instance
    assert cached_system(tiered_spec(1, seed=9, name="memo")) is first


def test_tier_invariants_small_preset():
    spec = PRESETS["small"]()
    system = generate(spec)
    slices = tier_slices(spec)
    assert system.num_nodes == spec.num_nodes == 64
    for tier in spec.tiers:
        sl = slices[tier.name]
        nodes = system.nodes[sl]
        assert len(nodes) == tier.count
        lo, hi = tier.speed
        for node in nodes:
            assert node.name.startswith(tier.name)
            assert lo <= node.properties["processing_speed"] <= hi
            assert node.resources["cores"] in tier.cores
            assert tier.memory[0] <= node.resources["memory"] <= tier.memory[1]
            assert frozenset(tier.features) == node.features

    # latency hierarchy: island links beat the HPC fabric, which beats
    # every cross-tier path (jitter is mean-preserving and small)
    isl = island_ids(spec)
    hpc = slices["hpc"]
    dtr = system.dtr
    same_island = (isl[:, None] == isl[None, :]) & (isl[:, None] >= 0)
    np.fill_diagonal(same_island, False)
    hpc_mask = np.zeros_like(same_island)
    hpc_mask[hpc, hpc] = True
    np.fill_diagonal(hpc_mask, False)
    intra_hpc = hpc_mask & ~same_island
    tier_of = np.repeat(
        np.arange(len(spec.tiers)), [t.count for t in spec.tiers]
    )
    inter_tier = tier_of[:, None] != tier_of[None, :]
    assert dtr[same_island].min() > dtr[intra_hpc].max()
    assert dtr[intra_hpc].min() > dtr[inter_tier].max()


def test_island_ids_contiguous_and_unique():
    spec = PRESETS["small"]()  # hpc tier: 8 nodes in 2 islands
    isl = island_ids(spec)
    hpc = tier_slices(spec)["hpc"]
    assert (isl[: hpc.start] == -1).all()  # only hpc is islanded
    hpc_ids = isl[hpc]
    assert set(hpc_ids) == {0, 1}
    assert (np.diff(hpc_ids) >= 0).all()  # contiguous blocks


# ---------------------------------------------------------------------------
# System dtr validation + lossless JSON round trip (satellite)
# ---------------------------------------------------------------------------


def _two_nodes():
    return mri_system().nodes[:2]


def test_system_rejects_bad_dtr():
    nodes = _two_nodes()
    with pytest.raises(ValueError, match="square"):
        make_system(nodes, np.ones((2, 3)))
    with pytest.raises(ValueError, match="NaN"):
        make_system(nodes, np.array([[np.inf, np.nan], [1.0, np.inf]]))
    with pytest.raises(ValueError, match="negative"):
        make_system(nodes, np.array([[np.inf, -0.5], [1.0, np.inf]]))


def test_system_json_rejects_ragged_dtr():
    obj = system_to_json(make_system(_two_nodes()))
    obj["dtr_matrix"][0] = obj["dtr_matrix"][0][:1]
    with pytest.raises(ValueError, match="square"):
        system_from_json(obj)


def test_system_json_round_trips_infinite_links():
    dtr = np.array([[np.inf, 0.125], [np.inf, np.inf]])  # dead 1→0 link
    system = make_system(_two_nodes(), dtr)
    obj = system_to_json(system)
    # JSON has no Infinity: encoded as the -1.0 sentinel...
    assert obj["dtr_matrix"][1][0] == -1.0
    # ...and decoded back to +inf, losslessly
    again = system_from_json(obj)
    assert np.array_equal(again.dtr, dtr)
    assert _system_bytes(again) == _system_bytes(system)


def test_generated_topology_round_trips_through_system_json():
    system = generate(tiered_spec(1, seed=5))
    assert _system_bytes(system_from_json(system_to_json(system))) == (
        _system_bytes(system)
    )


# ---------------------------------------------------------------------------
# digital-twin calibration
# ---------------------------------------------------------------------------


def _tiny_packed():
    system = generate(tiered_spec(1, seed=2))
    wf = random_layered_workflow(
        24, name="probe", seed=24, max_cores=4, feature_pool=("F1",)
    )
    workload = Workload((wf,))
    return system, workload, pack(build_problem(system, workload), pad=False)


def test_calibration_recovers_perturbed_speeds_within_5pct():
    system, _, packed = _tiny_packed()
    _, f_true, _ = perturbed_truth(system, seed=7, link_range=(1.0, 1.0))
    obs = synthesize_observations(
        packed, speed_factors=f_true, samples_per_node=32, noise=0.05, seed=8
    )
    result = calibrate(packed, obs, steps=300, device="cpu")
    covered = result.coverage > 0
    assert covered.all()  # every node drew samples
    rel = np.abs(result.speed_factors[covered] / f_true[covered] - 1.0)
    assert rel.mean() < 0.05
    # GD converged onto the closed-form separable optimum
    np.testing.assert_allclose(
        result.speed_factors, result.baseline_speed_factors, rtol=1e-3
    )
    assert result.loss[1] < result.loss[0]


def test_least_squares_shrinks_unobserved_nodes_to_one():
    _, _, packed = _tiny_packed()
    n = packed.num_nodes
    f_true = np.full(n, 2.0)
    obs = synthesize_observations(
        packed, speed_factors=f_true, samples_per_node=4, noise=0.0, seed=1
    )
    # keep observations for node 0 only
    keep = obs.node == 0
    import dataclasses

    pruned = dataclasses.replace(
        obs,
        task=obs.task[keep],
        node=obs.node[keep],
        duration=obs.duration[keep],
    )
    f, _ = least_squares_factors(packed, pruned, l2=1e-6)
    assert f[0] == pytest.approx(2.0, rel=1e-2)
    np.testing.assert_allclose(f[1:], 1.0)


def test_calibration_report_shrinks_twin_error():
    system, workload, _ = _tiny_packed()
    report = calibration_report(
        system, workload, perturb_seed=7, samples_per_node=32,
        noise=0.05, steps=300, device="cpu",
    )
    assert report["nodes"] == 16
    assert report["speed_factor_rel_mae"] < 0.05
    assert report["twin_error_after"] < report["twin_error_before"]
    assert report["twin_error_after"] < 0.05
    # the fitted factors beat (or match) nothing-fitted by construction;
    # the closed-form baseline is in the same band as the GD fit
    assert report["baseline_rel_mae"] < 0.10


# ---------------------------------------------------------------------------
# integration: campaign axis + inline Scenario topology
# ---------------------------------------------------------------------------


def test_cell_system_topology_axis():
    from repro_torch.campaigns.spec import cell_system

    system = cell_system({"system": "topology", "topology": "tiny"})
    assert system is cached_system(resolve_spec("tiny"))
    inline = tiered_spec(1, seed=21).to_json()
    assert cell_system({"system": "topology", "topology": inline}).num_nodes == 16
    with pytest.raises(ValueError, match="'topology' coordinate"):
        cell_system({"system": "topology"})


def test_scenario_inline_topology():
    from repro_torch.core.api import scenario_from_json

    wf_section = {
        "t1": {"work": 1.0, "resources": {"cores": 1}, "features": ["F1"]}
    }
    scenario = scenario_from_json(
        {
            "scenario": {"name": "topo", "technique": "heft"},
            "topology": tiered_spec(1, seed=13).to_json()["topology"],
            "wf": {"tasks": wf_section},
        }
    )
    assert scenario.system.num_nodes == 16
    with pytest.raises(ValueError, match="pick one system source"):
        scenario_from_json(
            {
                "scenario": {"name": "topo"},
                "nodes": system_to_json(mri_system())["nodes"],
                "topology": "tiny",
                "wf": {"tasks": wf_section},
            }
        )


# ---------------------------------------------------------------------------
# hypothesis fuzz (optional dependency, mirrored from test_property.py)
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - container without hypothesis
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:

    @settings(max_examples=10, deadline=None)
    @given(
        scale=st.integers(min_value=1, max_value=4),
        seed=st.integers(min_value=0, max_value=2**31 - 1),
    )
    def test_topology_expansion_deterministic(scale, seed):
        spec = tiered_spec(scale, seed=seed)
        a, b = generate(spec), generate(spec)
        assert _system_bytes(a) == _system_bytes(b)
        assert a.num_nodes == 16 * scale
        # spec JSON survives a round trip under fuzzed parameters too
        assert spec_from_json(spec.to_json()) == spec

    @settings(max_examples=10, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=2**31 - 1))
    def test_topology_dtr_always_valid(seed):
        system = generate(tiered_spec(1, seed=seed))
        off = ~np.eye(system.num_nodes, dtype=bool)
        assert np.isfinite(system.dtr[off]).all()
        assert (system.dtr[off] > 0).all()
        assert np.isinf(np.diag(system.dtr)).all()


# ---------------------------------------------------------------------------
# against the reference (one child job)
# ---------------------------------------------------------------------------

import contextlib  # noqa: E402
import io  # noqa: E402

import torch_reference as ref_harness  # noqa: E402
from repro_torch.campaigns import builtin, campaign_from_json, run_campaign  # noqa: E402
from repro_torch.core import api, heuristics  # noqa: E402
from repro_torch.core import workload_model as wm  # noqa: E402
from repro_torch.service import generate_trace  # noqa: E402

PRESET_NAMES = ["tiny", "small", "medium", "large"]
SEEDS = [0, 11]
CAL_CASES = [
    # the reference's recovery case: speeds only, links truthful
    {"scale": 1, "seed": 2, "tasks": 24, "perturb_seed": 7, "link_range": [1.0, 1.0], "samples": 32,
     "transfer_samples": 0, "noise": 0.05, "steps": 300},
    # speeds and links, with transfer observations
    {"scale": 1, "seed": 5, "tasks": 24, "perturb_seed": 3, "link_range": [0.5, 2.0], "samples": 16,
     "transfer_samples": 200, "noise": 0.05, "steps": 300},
]
REPORT = {"seed": 2, "tasks": 24, "samples": 32, "steps": 300}
SCENARIO = {
    "scenario": {"name": "topo", "technique": "heft"},
    "topology": tiered_spec(1, seed=13).to_json()["topology"],
    "wf": {"tasks": {
        "t1": {"work": 4.0, "resources": {"cores": 2}, "features": ["F1"], "data": 0.5},
        "t2": {"work": 2.0, "resources": {"cores": 1}, "features": ["F1"], "dependencies": ["t1"]},
        "t3": {"work": 3.0, "resources": {"cores": 4}, "features": ["F2"], "dependencies": ["t1"]},
        "t4": {"work": 1.0, "resources": {"cores": 1}, "features": ["F1"], "dependencies": ["t2", "t3"]},
    }},
}
TRACES = {"tiny": {"num_submissions": 12, "seed": 1, "topology": "tiny", "families": ["mri", "stgs", "random"]},
          "small-nodes": {"num_submissions": 6, "seed": 4, "topology": "small", "families": ["random"],
                          "node_events": True}}
RUNS = [
    {"name": "gafree", "campaign": builtin.topology_campaign(techniques=("heft",)).to_json()},
    {"name": "standin", "standin": True, "campaign": builtin.topology_campaign().to_json()},
]
ARGVS = [["topology", "generate", "tiny"], ["topology", "generate", "small", "--seed", "3"],
         ["topology", "generate", "tinny"],
         ["topology", "calibrate", "tiny", "--steps", "100", "--samples", "8", "--tasks", "16"]]
#: where the port's Adam may differ from the reference's: the f32 loss and
#: its gradient are sums the two libraries add in their own orders, and XLA
#: fuses multiply-adds (one rounding each) where PyTorch rounds twice.
#: Measured on CAL_CASES on the CPU: relative differences of at most 3.0e-8
#: in the speed factors, 8.9e-8 in the link factors and 1.9e-7 in the
#: losses; the bound is the target of the port, 1e-5
ADAM_RTOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    return ref_harness.run("topology", {
        "presets": PRESET_NAMES, "seeds": SEEDS, "calibration": CAL_CASES, "report": REPORT,
        "scenario": SCENARIO, "traces": TRACES, "runs": RUNS, "argvs": ARGVS,
    })


def _cal_case(i):
    case = CAL_CASES[i]
    system = generate(tiered_spec(case["scale"], seed=case["seed"]))
    wf = random_layered_workflow(case["tasks"], name="probe", seed=case["tasks"], max_cores=4, feature_pool=("F1",))
    packed = pack(build_problem(system, Workload((wf,))), pad=False)
    _, f_true, g_true = perturbed_truth(system, seed=case["perturb_seed"], link_range=tuple(case["link_range"]))
    obs = synthesize_observations(packed, speed_factors=f_true, link_factors=g_true,
                                  samples_per_node=case["samples"], transfer_samples=case["transfer_samples"],
                                  noise=case["noise"], seed=case["perturb_seed"] + 1)
    return packed, obs, f_true, g_true


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_generate_equals_reference_per_preset_and_seed(ref, preset):
    for seed in SEEDS:
        tag = f"gen/{preset}/{seed}"
        spec = PRESETS[preset]().replace(seed=seed)
        system = generate(spec)
        assert json.dumps(spec.to_json(), sort_keys=True) == str(ref[f"{tag}/spec"])
        assert spec.fingerprint() == str(ref[f"{tag}/fingerprint"])
        obj = system_to_json(system)
        assert json.dumps({k: v for k, v in obj.items() if k != "dtr_matrix"}, sort_keys=True) == str(ref[f"{tag}/nodes"])
        np.testing.assert_array_equal(system.dtr, ref[f"{tag}/dtr"])


@pytest.mark.parametrize("case", range(len(CAL_CASES)))
def test_observations_and_least_squares_equal_reference(ref, case):
    packed, obs, f_true, g_true = _cal_case(case)
    np.testing.assert_array_equal(f_true, ref[f"cal/{case}/f_true"])
    np.testing.assert_array_equal(g_true, ref[f"cal/{case}/g_true"])
    for k in ("task", "node", "duration", "src", "dst", "data", "xfer_duration"):
        np.testing.assert_array_equal(getattr(obs, k), ref[f"cal/{case}/obs/{k}"], err_msg=k)
    f, g = least_squares_factors(packed, obs)
    np.testing.assert_array_equal(f, ref[f"cal/{case}/lsq/f"])
    np.testing.assert_array_equal(g, ref[f"cal/{case}/lsq/g"])


@pytest.mark.parametrize("case", range(len(CAL_CASES)))
def test_calibrate_within_tolerance_of_reference(ref, case):
    packed, obs, f_true, _ = _cal_case(case)
    res = calibrate(packed, obs, steps=CAL_CASES[case]["steps"], device="cpu")
    np.testing.assert_allclose(res.speed_factors, ref[f"cal/{case}/fit/f"], rtol=ADAM_RTOL, atol=0)
    np.testing.assert_allclose(res.link_factors, ref[f"cal/{case}/fit/g"], rtol=ADAM_RTOL, atol=0)
    np.testing.assert_allclose(np.array(res.loss), ref[f"cal/{case}/fit/loss"], rtol=ADAM_RTOL, atol=0)
    np.testing.assert_array_equal(res.baseline_speed_factors, ref[f"cal/{case}/fit/base"])
    np.testing.assert_array_equal(res.coverage, ref[f"cal/{case}/fit/coverage"])
    # and within the reference's own bounds (tests/test_topology.py)
    covered = res.coverage > 0
    assert np.abs(res.speed_factors[covered] / f_true[covered] - 1.0).mean() < 0.05
    np.testing.assert_allclose(res.speed_factors, res.baseline_speed_factors, rtol=1e-3)
    assert res.loss[1] < res.loss[0]


#: report fields that come from the Adam fit (held within ADAM_RTOL); the
#: rest are numpy and HEFT on the host, held exactly
ADAM_FIELDS = ("loss_initial", "loss_final", "speed_factor_mae", "speed_factor_rel_mae",
               "twin_error_after", "predicted_makespan_after")


def test_calibration_report_equals_reference(ref):
    system = generate(tiered_spec(1, seed=REPORT["seed"]))
    wf = random_layered_workflow(REPORT["tasks"], name="probe", seed=REPORT["tasks"], max_cores=4,
                                 feature_pool=("F1",))
    got = calibration_report(system, Workload((wf,)), perturb_seed=7, samples_per_node=REPORT["samples"],
                             noise=0.05, steps=REPORT["steps"], device="cpu")
    want = json.loads(str(ref["report"]))
    assert set(got) == set(want)
    for k, v in want.items():
        if k in ADAM_FIELDS:
            assert got[k] == pytest.approx(v, rel=ADAM_RTOL), k
        else:
            assert got[k] == v, k


def test_calibrate_runs_on_the_card_by_default():
    """``calibrate`` without ``device`` asks for the card; without one it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    packed, obs, _, _ = _cal_case(0)
    with pytest.raises((RuntimeError, AssertionError)):
        calibrate(packed, obs, steps=2)


def test_inline_topology_scenario_equals_reference(ref, tmp_path):
    sc = api.scenario_from_json(SCENARIO)
    assert json.dumps(sc.to_json(), indent=2) == str(ref["scenario/json"])
    summary = api.Orchestrator(sc, out_dir=tmp_path).run().summary()
    summary.pop("artifacts", None)
    assert json.dumps(summary, sort_keys=True) == str(ref["scenario/summary"])


@pytest.mark.parametrize("name", sorted(TRACES))
def test_topology_trace_equals_reference_byte_for_byte(ref, name):
    trace = generate_trace(**TRACES[name])
    assert json.dumps(trace.to_json(), indent=2) == str(ref[f"trace/{name}"])


@pytest.mark.parametrize("case", RUNS, ids=[c["name"] for c in RUNS])
def test_topology_lane_equals_reference(ref, case):
    reg = ref_harness.standin_registry(api, heuristics) if case.get("standin") else None
    rs = run_campaign(campaign_from_json(case["campaign"]), registry=reg, device="cpu")
    for k, v in ref_harness.campaign_outputs(rs).items():
        assert v == str(ref[f"run/{case['name']}/{k}"]), k


def test_topology_bench_writes_where_it_is_told(tmp_path):
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    before = {p.name: p.stat().st_mtime_ns for p in repo.glob("BENCH_*.json")}
    rows = builtin.run_topology_bench(tmp_path / "topo.json", device="cpu")
    payload = json.loads((tmp_path / "topo.json").read_text())
    assert {r[0] for r in rows} >= {"topology_tiny_twin", "topology_small_twin", "topology_generate_large"}
    for preset in ("tiny", "small"):
        cal = payload["calibration"][preset]
        assert cal["twin_error_after"] < cal["twin_error_before"]
        assert cal["speed_factor_rel_mae"] < 0.05
    assert payload["generate_large"]["nodes"] == 1008
    assert {p.name: p.stat().st_mtime_ns for p in repo.glob("BENCH_*.json")} == before


def _port_cli(argv):
    from repro_torch.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
    return rc, buf.getvalue()


@pytest.mark.parametrize("i", range(len(ARGVS)), ids=["-".join(a[1:3]) + f"-{i}" for i, a in enumerate(ARGVS)])
def test_cli_topology_equals_reference_cli(ref, i):
    argv = ARGVS[i]
    rc, out = _port_cli(argv + (["--device", "cpu"] if argv[1] == "calibrate" else []))
    assert rc == int(ref[f"cli/{i}/rc"])
    want = str(ref[f"cli/{i}/stdout"])
    if argv[1] != "calibrate":
        assert out == want
        return
    got, want = json.loads(out), json.loads(want)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == (pytest.approx(v, rel=ADAM_RTOL) if k in ADAM_FIELDS else v), k
