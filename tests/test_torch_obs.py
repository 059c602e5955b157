"""The port's observability layer against the JAX package's.

The tracer's spans on a fixed script (nested, ``timed``, ``traced``, a span
left by an exception, a virtual clock), the fitness accounting's table for a
fixed call sequence and every exporter's text equal the reference's byte for
byte; ``summarize_trace`` refuses the same malformed files with the same
messages.  The port's own wiring is held here too: ``pack`` and ``ga_sweep``
emit the reference's spans and metrics, the engines feed ``FITNESS``, the
loaded kernel libraries are a collector, disabled tracing allocates nothing,
and ``--trace`` writes the trace and its metrics on ``run``, ``serve`` and
``campaign run``."""

import ast
import json
import os
import subprocess
import sys
import tracemalloc
from pathlib import Path

import numpy as np
import pytest

import torch_reference as ref_harness
from repro_torch import obs
from repro_torch.core import api, metaheuristics as mh
from repro_torch.core import system_model as sm
from repro_torch.core import workload_model as wm
from repro_torch.engine import backends, packed
from repro_torch.kernels import _build
from repro_torch.obs import metrics as metrics_mod
from repro_torch.obs import tracer as tracer_mod

REPO = Path(__file__).resolve().parents[1]

#: fixed fitness-call sequences: [backend, bucket, mode, dt_us, grows]
CALLS = {
    "first-call": [["cuda", [8, 4, 64, 3], "fixed", 900.0, None],
                   ["cuda", [8, 4, 64, 3], "fixed", 12.5, None],
                   ["cuda", [8, 4, 64, 3], "fixed", 10.25, None],
                   ["cuda-batch", [16, 4, 64, 3], "weighted", 40.0, None],
                   ["torch", [5, 3, 64, 2], "", 3.0, None]],
    "cache-probe": [["jax", [8, 4, 64, 3], "fixed", 500.0, True],
                    ["jax", [8, 4, 64, 3], "fixed", 7.0, False],
                    ["jax", [8, 4, 64, 3], "fixed", 400.0, True],
                    ["jax", [8, 4, 64, 3], "fixed", 6.0, False]],
}
SPANS = [
    {"id": 0, "parent": None, "name": "campaign.run", "cat": "campaign", "wall_t0": 0.001,
     "wall_dur": 0.5, "args": {"campaign": "t9", "runner": "inline"}},
    {"id": 1, "parent": 0, "name": "engine.pack", "cat": "engine", "wall_t0": 0.002,
     "wall_dur": 0.000125, "args": {"bucket": "8x4x64x3"}},
    {"id": 2, "parent": 0, "name": "service.event", "cat": "", "wall_t0": 0.01, "wall_dur": 0.25,
     "vt0": 1.5, "vdur": 0.75, "args": {"kind": "arrival"}},
    {"id": 3, "parent": 2, "name": "admission", "cat": "service", "wall_t0": 0.02, "wall_dur": 0.0,
     "vt0": 2.0, "vdur": None, "args": {"error": "ValueError: boom"}},
]
BLOCK = {"metrics": {"counters": {"a.b": 3}, "gauges": {"g": 1.5}, "pack_cache": {"hits": 2}},
         "engine_fitness": {"cuda|8x4x64x3|fixed": {"calls": 3, "compile_us": 900.0}},
         "spans": 4, "list": [1, 2]}
BAD = [
    '{"events": []}',
    '{"traceEvents": [{"ts": 0}]}',
    '{"traceEvents": [{"ph": "B", "ts": 0, "dur": 1}]}',
    '{"traceEvents": [{"ph": "X", "ts": "0", "dur": 1}]}',
    '{"traceEvents": [{"ph": "X", "ts": 0, "dur": -1}]}',
    '{"traceEvents": [{"ph": "M", "name": "process_name"}, {"ph": "X", "ts": 0, "dur": 2, "cat": "c"}]}',
]


@pytest.fixture(scope="module")
def ref():
    return ref_harness.run("obs", {"calls": CALLS["first-call"] + CALLS["cache-probe"],
                                   "spans": SPANS, "block": BLOCK, "bad": BAD})


@pytest.fixture(autouse=True)
def _pristine_tracer():
    obs.TRACER.disable()
    yield
    obs.TRACER.disable()


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def test_obs_exports_the_reference_all():
    tree = ast.parse((REPO / "src" / "repro" / "obs" / "__init__.py").read_text())
    ref_all = next(ast.literal_eval(n.value) for n in tree.body
                   if isinstance(n, ast.Assign) and n.targets[0].id == "__all__")
    assert obs.__all__ == ref_all
    assert all(hasattr(obs, name) for name in obs.__all__)


def test_scripted_spans_equal_the_reference(ref):
    assert ref_harness.scripted_spans(obs) == str(ref["script"])


def test_fitness_table_equals_the_reference(ref):
    assert ref_harness.fitness_table(metrics_mod, CALLS["first-call"] + CALLS["cache-probe"]) == str(ref["fitness"])


@pytest.mark.parametrize("name", list(CALLS))
def test_fitness_table_counts_first_calls_or_cache_growth(name):
    table = json.loads(ref_harness.fitness_table(metrics_mod, CALLS[name]))
    if name == "first-call":
        rec = table["cuda|8x4x64x3|fixed"]
        assert (rec["calls"], rec["compiles"], rec["execute_calls"]) == (3, 1, 2)
        # the fake clock advances in seconds, so the microseconds round
        assert rec["compile_us"] == pytest.approx(900.0)
        assert rec["execute_us_mean"] == pytest.approx((12.5 + 10.25) / 2)
        assert table["torch|5x3x64x2"]["compiles"] == 1 and "cuda-batch|16x4x64x3|weighted" in table
    else:
        rec = table["jax|8x4x64x3|fixed"]
        assert (rec["calls"], rec["compiles"]) == (4, 2)
        assert (rec["compile_us"], rec["execute_us"]) == (pytest.approx(900.0), pytest.approx(13.0))


@pytest.mark.parametrize("key", ["events", "trace", "flat", "metrics", "summary"])
def test_exports_equal_the_reference(ref, key, tmp_path):
    out = ref_harness.export_outputs(obs, SPANS, BLOCK, BAD, tmp_path)
    assert out[key] == str(ref[f"export/{key}"])


@pytest.mark.parametrize("i", range(len(BAD)))
def test_summarize_trace_refuses_what_the_reference_refuses(ref, i, tmp_path):
    out = ref_harness.export_outputs(obs, SPANS, BLOCK, BAD, tmp_path)
    assert out[f"bad/{i}"] == str(ref[f"export/bad/{i}"])
    assert bool(out[f"bad/{i}"]) == (i < len(BAD) - 1)  # the last file is valid


# ---------------------------------------------------------------------------
# the tracer's semantics
# ---------------------------------------------------------------------------

def test_timed_measures_wall_even_when_disabled():
    tr = obs.Tracer()
    with tr.timed("cell") as sp:
        sum(range(1000))
    assert sp.wall_us > 0.0 and tr.spans == []
    tr.enable()
    with tr.timed("cell", cat="campaign", args={"cell": 3}) as sp:
        sp.set(technique="heft")
    assert sp.wall_us >= 0.0
    (span,) = tr.spans
    assert (span.name, span.cat, span.args) == ("cell", "campaign", {"cell": 3, "technique": "heft"})


def test_a_span_exited_by_an_exception_is_still_recorded():
    tr = obs.TRACER
    tr.enable()

    @obs.traced("deco.fail", cat="t")
    def fail():
        raise KeyError("missing")

    with pytest.raises(ValueError, match="boom"):
        with tr.timed("timed.fail") as t:
            raise ValueError("boom")
    with pytest.raises(KeyError):
        fail()
    assert t.wall_us > 0.0
    assert [(s.name, s.args["error"]) for s in tr.spans] == [
        ("timed.fail", "ValueError: boom"), ("deco.fail", "KeyError: 'missing'")]
    assert tr._stack == []


def test_traced_decorator_is_a_passthrough_when_disabled():
    calls = []

    @obs.traced()
    def fn(x):
        calls.append(x)
        return x + 1

    n0 = len(obs.TRACER.spans)
    assert fn(1) == 2 and len(obs.TRACER.spans) == n0
    obs.TRACER.enable()
    assert fn(2) == 3
    assert obs.TRACER.spans[-1].name.endswith("fn") and calls == [1, 2]


def test_disabled_tracing_allocates_nothing():
    assert obs.TRACER.span("a") is obs.TRACER.span("b")
    n0 = len(obs.TRACER.spans)
    for _ in range(10):
        with obs.TRACER.span("hot"):
            pass
    only_tracer = [tracemalloc.Filter(True, tracer_mod.__file__)]
    tracemalloc.start()
    snap1 = tracemalloc.take_snapshot().filter_traces(only_tracer)
    for _ in range(1000):
        with obs.TRACER.span("hot"):
            pass
    snap2 = tracemalloc.take_snapshot().filter_traces(only_tracer)
    tracemalloc.stop()
    assert len(obs.TRACER.spans) == n0
    grew = [s for s in snap2.compare_to(snap1, "lineno") if s.size_diff > 0]
    assert sum(s.count_diff for s in grew) < 50
    assert sum(s.size_diff for s in grew) < 4096


# ---------------------------------------------------------------------------
# the port's wiring: pack, ga_sweep, the engines, the collector
# ---------------------------------------------------------------------------

def _problems(n: int = 2, tasks: int = 6):
    system = sm.synthetic_system(3, seed=3)
    return [wm.build_problem(system, wm.Workload((wm.random_layered_workflow(tasks, seed=tasks + i),)))
            for i in range(n)]


def test_pack_emits_one_span_hit_or_miss():
    (problem,) = _problems(1, 7)
    obs.TRACER.enable()
    a = packed.pack(problem)
    b = packed.pack(problem)  # a cache hit
    packed.pack(problem, use_cache=False)
    assert a is b
    bucket = "x".join(str(d) for d in a.bucket)
    assert [(s.name, s.cat, s.args) for s in obs.TRACER.spans] == [("engine.pack", "engine", {"bucket": bucket})] * 3


def test_ga_sweep_emits_its_span_and_metrics():
    problems = _problems(3)
    obs.METRICS.reset()
    obs.TRACER.enable()
    mh.ga_sweep(problems, pop_size=8, generations=2, device="cpu")
    sweep = [s for s in obs.TRACER.spans if s.name == "mh.ga_sweep"]
    bucket = packed.common_bucket(problems)
    assert [(s.cat, s.args) for s in sweep] == [
        ("engine", {"instances": 3, "shards": 1, "bucket": "x".join(str(d) for d in bucket)})]
    # the sweep packs every instance before its span opens, as the reference does
    assert [s.name for s in obs.TRACER.spans] == ["engine.pack"] * 3 + ["mh.ga_sweep"]
    snap = obs.METRICS.snapshot()
    assert snap["counters"]["mh.ga_sweep.instances"] == 3
    assert snap["gauges"]["mh.ga_sweep.shards"] == 1


@pytest.mark.parametrize("engine", ["cuda", "torch"])
def test_engines_feed_the_fitness_accounting(engine):
    problems = _problems(2)
    obs.FITNESS.reset()
    try:
        fit = backends.population_fitness_fn(problems[0], engine=engine, device="cpu")
        pop = np.zeros((4, problems[0].num_tasks), np.int32)
        fit(pop)
        fit(pop)
        batched = backends.batched_population_fitness_fn(problems, engine=engine, device="cpu")
        batched(np.zeros((2, 4, batched.bucket[0]), np.int32))
        table = obs.FITNESS.to_json()
    finally:
        obs.FITNESS.reset()
    single = "x".join(str(d) for d in packed.pack(problems[0], pad=False).bucket)
    batch = "x".join(str(d) for d in batched.bucket)
    assert sorted(table) == sorted([f"{engine}|{single}|fixed", f"{engine}-batch|{batch}|fixed"])
    rec = table[f"{engine}|{single}|fixed"]
    assert (rec["calls"], rec["compiles"], rec["execute_calls"]) == (2, 1, 1)


def test_the_loaded_kernel_libraries_are_a_collector(monkeypatch):
    assert obs.METRICS.snapshot()["engine_kernel_libraries"]["loaded"] == len(_build._LOADED)
    monkeypatch.setattr(_build, "_LOADED", {"makespan": object()})
    assert obs.METRICS.snapshot()["engine_kernel_libraries"] == {"loaded": 1, "makespan": 1}


# ---------------------------------------------------------------------------
# --trace on the CLI
# ---------------------------------------------------------------------------

def _cli(*argv, cwd=None):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch", *argv], capture_output=True, text=True,
                          env=env, timeout=300, cwd=cwd)
    assert proc.returncode == 0, proc.stderr
    return proc


def _check_trace(path: Path, names: set[str]) -> dict:
    summary = obs.summarize_trace(path)
    got = {e["name"] for e in json.loads(path.read_text())["traceEvents"] if e["ph"] == "X"}
    assert names <= got, got
    metrics = json.loads(path.with_suffix(".metrics.json").read_text())
    assert "spans" in metrics and summary["wall_spans"] == metrics["spans"]
    return metrics


def test_trace_on_run_writes_the_trace_and_its_metrics(tmp_path):
    sc = api.Scenario(name="t", system=sm.synthetic_system(3, seed=3),
                      workload=wm.Workload((wm.random_layered_workflow(6, seed=6),)), technique="ga",
                      solver_options={"ga": {"pop_size": 8, "generations": 2}})
    sc.save(tmp_path / "sc.json")
    _cli("run", str(tmp_path / "sc.json"), "--device", "cpu", "--out-dir", str(tmp_path / "exec"),
         "--trace", str(tmp_path / "run.json"))
    metrics = _check_trace(tmp_path / "run.json", {"engine.pack", "solve.route"})
    assert any(k.startswith("engine_fitness.cuda|") for k in metrics)


def test_trace_on_serve_writes_the_trace_metrics_and_telemetry(tmp_path):
    _cli("trace", str(tmp_path / "t.json"), "-n", "6", "--seed", "3", "--families", "mri,random")
    out = _cli("serve", str(tmp_path / "t.json"), "--device", "cpu", "--trace", str(tmp_path / "serve.json"))
    payload = json.loads(out.stdout)
    assert payload["completed"] == 6 and set(payload["telemetry"]) == {"metrics", "engine_fitness", "spans"}
    assert payload["telemetry"]["spans"] > 0
    summary = obs.summarize_trace(tmp_path / "serve.json")
    assert summary["virtual_spans"] > 0  # the service's spans on the virtual clock too
    _check_trace(tmp_path / "serve.json", {"service.admit", "admission.solve"})


def test_trace_on_campaign_run_writes_the_trace_and_its_metrics(tmp_path):
    spec = {"campaign": {"name": "tiny", "runner": "inline",
                         "axes": [{"name": "size", "values": [5, 6]}, {"name": "technique", "values": ["heft", "ga"]}],
                         "defaults": {"family": "layered", "nodes": 3,
                                      "solver_options": {"ga": {"pop_size": 8, "generations": 2}}}}}
    (tmp_path / "c.json").write_text(json.dumps(spec))
    _cli("campaign", "run", str(tmp_path / "c.json"), "--device", "cpu", "--trace", str(tmp_path / "c.trace.json"))
    metrics = _check_trace(tmp_path / "c.trace.json",
                           {"campaign.run", "campaign.batch", "mh.ga_sweep", "engine.pack", "campaign.cell"})
    assert any(k.startswith("engine_fitness.cuda-batch|") for k in metrics)
