"""Scenario runner CLI of the port.

    PYTHONPATH=src python -m repro_torch run scenario.json [--technique heft]
                                                           [--backend simulate]
                                                           [--engine cuda]
                                                           [--device cuda]
                                                           [--out result.json]
                                                           [--out-dir DIR]
                                                           [--trace PATH]
    PYTHONPATH=src python -m repro_torch techniques
    PYTHONPATH=src python -m repro_torch engines
    PYTHONPATH=src python -m repro_torch trace trace.json [-n 200] [--seed 0]
                                                          [--rate 2.0]
                                                          [--families mri,stgs]
                                                          [--node-events]
                                                          [--chaos '{"horizon": 1200}']
                                                          [--cycling '{"cycles": 3}']
    PYTHONPATH=src python -m repro_torch serve trace.json [--out result.json]
                                                          [--batch-window 0.25]
                                                          [--max-batch 32]
                                                          [--max-retries 3]
                                                          [--fallback ga,heft]
                                                          [--records]
                                                          [--device cuda]
                                                          [--trace PATH]
    PYTHONPATH=src python -m repro_torch campaign expand (spec.json | smoke|table9|…)
    PYTHONPATH=src python -m repro_torch campaign run (spec.json | builtin-name)
                                                      [--runner inline|service]
                                                      [--out results.json]
                                                      [--csv results.csv]
                                                      [--vs milp] [--metric makespan]
                                                      [--device cuda]
                                                      [--trace PATH]
    PYTHONPATH=src python -m repro_torch campaign report results.json [--vs milp]
    PYTHONPATH=src python -m repro_torch obs trace.json [--json]
    PYTHONPATH=src python -m repro_torch topology generate (spec.json | tiny|small|medium|large)
                                                           [--seed N] [--out system.json]
    PYTHONPATH=src python -m repro_torch topology calibrate (spec.json | preset)
                                                            [--samples 32] [--steps 300]
                                                            [--device cuda] [--out report.json]

``run`` loads a declarative :class:`repro_torch.core.api.Scenario` (the
reference's file format, unchanged), drives the
:class:`repro_torch.core.api.Orchestrator` closed loop and prints
(optionally saves) the :class:`repro_torch.core.api.RunResult` summary JSON.
Metaheuristics run on ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch makespan version).  ``techniques`` lists the solver registry with
capability metadata, ``engines`` the fitness engines.  ``trace`` generates a
seeded multi-tenant arrival trace (:mod:`repro_torch.service.traces`, the
reference's file format); ``serve`` replays one through the event-driven
:class:`repro_torch.service.SchedulingService` and prints throughput /
turnaround / cache metrics, its GA admissions on ``--device``.  ``campaign``
is the multi-scenario experiment API (:mod:`repro_torch.campaigns`, the
reference's spec files): ``expand`` previews the deterministic cell grid of a
spec (file or built-in name), ``run`` executes it (GA cells on ``--device``)
and can save the typed columnar ResultSet as JSON/CSV, and ``report``
recomputes the Table IX-style optimality-gap table from saved results.
``--trace PATH`` on ``run``, ``serve`` and ``campaign run`` writes a Perfetto
trace of the run and ``PATH.metrics.json`` beside it; ``obs`` validates and
summarizes such a trace.  ``topology generate`` expands a tiered continuum
spec (:mod:`repro_torch.topology`, the reference's spec files) into a system
JSON, bit-identical per seed; ``topology calibrate`` perturbs the continuum,
fits speed factors from noisy observations (Adam on ``--device``) and
reports the twin's makespan error before and after.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _resolve_campaign(spec: str):
    from repro_torch.campaigns import resolve_campaign

    try:
        return resolve_campaign(spec)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def _campaign_main(args) -> int:
    from repro_torch.campaigns import ResultSet, run_campaign
    from repro_torch.core.api import DEVICE_ERRORS

    if args.campaign_cmd == "expand":
        campaign = _resolve_campaign(args.spec)
        cells = campaign.expand()
        for cell in cells:
            mark = f"  [skip:{cell.skipped}]" if cell.skipped else ""
            print(f"c{cell.index:04d}  {cell.label()}{mark}")
        skipped = sum(1 for c in cells if c.skipped)
        print(f"# {len(cells)} cells ({skipped} skipped), "
              f"runner={campaign.runner}")
        return 0

    if args.campaign_cmd == "report":
        rs = ResultSet.load(args.results)
        rep = (rs.deviation_vs(args.vs, metric=args.metric) if args.per_cell
               else rs.deviation_report(args.vs, metric=args.metric))
        print(rep.to_csv(), end="")
        return 0

    campaign = _resolve_campaign(args.spec)
    try:
        rs = run_campaign(campaign, runner=args.runner, device=args.device)
    except DEVICE_ERRORS:
        raise  # a fault of the card is not a user error: traceback, exit 1
    except (KeyError, ValueError) as e:
        # unknown runner / unsolvable spec are user errors, not tracebacks
        raise SystemExit(str(e).strip('"')) from None
    stats = rs.meta.get("stats", {})
    print(f"# campaign {campaign.name}: {len(rs)} rows", file=sys.stderr)
    for k in ("solver_calls", "dedup_hits", "batched_groups", "skipped"):
        if k in stats:
            print(f"#   {k}={stats[k]}", file=sys.stderr)
    print(rs.to_csv(), end="")
    if args.out:
        rs.save(args.out)
    if args.csv:
        rs.save_csv(args.csv)
    vs = None if args.vs in ("none", "") else args.vs
    if vs and rs.baseline_present(vs):
        print(f"# deviation vs {vs} ({args.metric}):")
        print(rs.deviation_report(vs, metric=args.metric).to_csv(), end="")
    return 0


def _resolve_topology(spec: str, seed: int | None):
    from repro_torch.topology import load_spec, resolve_spec

    try:
        ts = load_spec(spec) if Path(spec).is_file() else resolve_spec(spec)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if seed is not None:
        ts = ts.replace(seed=seed)
    return ts


def _topology_main(args) -> int:
    import time

    from repro_torch.topology import cached_system, calibration_report, tier_slices

    spec = _resolve_topology(args.spec, args.seed)

    if args.topology_cmd == "generate":
        from repro_torch.core.system_model import system_to_json

        t0 = time.perf_counter()
        system = cached_system(spec)
        seconds = time.perf_counter() - t0
        tiers = " ".join(
            f"{name}={sl.stop - sl.start}" for name, sl in tier_slices(spec).items()
        )
        print(f"# {spec.name}: {system.num_nodes} nodes ({tiers}) "
              f"generated in {seconds:.3f}s, seed={spec.seed}", file=sys.stderr)
        payload = json.dumps(system_to_json(system), indent=2, sort_keys=True)
        if args.out:
            Path(args.out).write_text(payload + "\n")
            print(f"wrote {args.out}", file=sys.stderr)
        else:
            print(payload)
        return 0

    # calibrate: perturb the twin, observe noisily, fit, report twin error
    from repro_torch.core.workload_model import Workload, random_layered_workflow

    system = cached_system(spec)
    size = args.tasks
    workload = Workload(
        (
            random_layered_workflow(
                size, name=f"W{size}", seed=size, max_cores=4,
                feature_pool=("F1",),
            ),
        )
    )
    report = calibration_report(
        system,
        workload,
        perturb_seed=args.perturb_seed,
        samples_per_node=args.samples,
        transfer_samples=args.transfer_samples,
        noise=args.noise,
        steps=args.steps,
        device=args.device,
    )
    payload = json.dumps(report, indent=2, sort_keys=True)
    print(payload)
    if args.out:
        Path(args.out).write_text(payload + "\n")
    return 0


def _obs_main(args) -> int:
    from repro_torch import obs

    try:
        summary = obs.summarize_trace(args.trace_file)
    except (OSError, ValueError) as e:
        raise SystemExit(f"invalid trace file {args.trace_file!r}: {e}") from None
    if args.json:
        print(json.dumps(summary, indent=2))
        return 0
    print(f"# {args.trace_file}: {summary['events']} events "
          f"({summary['wall_spans']} wall spans, "
          f"{summary['virtual_spans']} virtual spans) — valid trace_event JSON")
    print(f"{'category':24s} {'count':>8s} {'total_ms':>10s}")
    for cat, agg in summary["categories"].items():
        print(f"{cat or '-':24s} {agg['count']:8d} {agg['total_us'] / 1e3:10.1f}")
    print("# hottest spans (cumulative wall time):")
    for row in summary["top_spans_us"]:
        print(f"  {row['name']:32s} {row['total_us'] / 1e3:10.1f} ms")
    return 0


def main(argv: list[str] | None = None) -> int:
    from repro_torch.core.executor import DEFAULT_OUT_DIR

    parser = argparse.ArgumentParser(prog="repro_torch", description=__doc__)
    parser.add_argument("--verbose", action="store_true",
                        help="enable INFO logging on the repro_torch.* namespace")
    sub = parser.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="run a scenario through the orchestrator")
    run_p.add_argument("scenario", help="path to a Scenario JSON file")
    run_p.add_argument("--technique", help="override the scenario's technique")
    run_p.add_argument("--backend", help="override the executor backend "
                       "(simulate | slurm | kubernetes)")
    run_p.add_argument("--engine", help="override the schedule-evaluation "
                       "engine (auto | cuda | torch | oracle | plugin)")
    run_p.add_argument("--device", default="cuda",
                       help="device of the metaheuristics' fitness (default cuda)")
    run_p.add_argument("--out", help="also write the summary JSON here")
    run_p.add_argument("--out-dir", default=str(DEFAULT_OUT_DIR),
                       help="artifact directory for render backends")
    run_p.add_argument("--trace", dest="trace_out", metavar="PATH",
                       help="write a Perfetto trace of this run to PATH "
                       "(+ PATH-adjacent .metrics.json)")

    sub.add_parser("techniques", help="list registered solver techniques")
    sub.add_parser("engines", help="list registered evaluation engines")

    trace_p = sub.add_parser("trace", help="generate a service arrival trace")
    trace_p.add_argument("out", help="path to write the trace JSON")
    trace_p.add_argument("-n", "--num-submissions", type=int, default=200)
    trace_p.add_argument("--seed", type=int, default=0)
    trace_p.add_argument("--rate", type=float, default=2.0,
                         help="mean arrivals per virtual second")
    trace_p.add_argument("--families", default="mri,stgs,random,tpu",
                         help="comma-separated workflow families")
    trace_p.add_argument("--node-events", action="store_true",
                         help="inject mid-trace drift/failure/recovery events")
    trace_p.add_argument("--chaos", metavar="JSON",
                         help="inject seeded failure/drift storms instead: "
                         "chaos_events kwargs as JSON, e.g. "
                         '\'{"failure_rate": 0.01, "horizon": 1200}\' '
                         "({} for defaults; overrides --node-events)")
    trace_p.add_argument("--cycling", metavar="JSON",
                         help="turn a seeded fraction of submissions into "
                         "recurring/converging streams: a CycleSpec JSON "
                         'plus "fraction", e.g. \'{"fraction": 0.25, '
                         '"cycles": 3, "period": 5.0}\'')

    serve_p = sub.add_parser("serve", help="run a trace through the "
                             "event-driven scheduling service")
    serve_p.add_argument("trace", help="path to a trace JSON file "
                         "(python -m repro_torch trace)")
    serve_p.add_argument("--out", help="also write the summary JSON here")
    serve_p.add_argument("--batch-window", type=float, default=0.25,
                         help="admission batch window (virtual seconds)")
    serve_p.add_argument("--max-batch", type=int, default=32)
    serve_p.add_argument("--jitter", type=float, default=0.0,
                         help="lognormal per-task duration noise sigma")
    serve_p.add_argument("--seed", type=int, default=0,
                         help="service seed (drives --jitter noise; "
                         "replays are deterministic per seed)")
    serve_p.add_argument("--records", action="store_true",
                         help="include per-submission records in the output")
    serve_p.add_argument("--max-retries", type=int, default=3,
                         help="per-submission requeue budget after "
                         "preemption / transient infeasibility")
    serve_p.add_argument("--backoff-base", type=float, default=1.0,
                         help="first-retry backoff (virtual seconds; "
                         "doubles per retry up to --backoff-cap)")
    serve_p.add_argument("--backoff-cap", type=float, default=60.0)
    serve_p.add_argument("--fallback", default="",
                         help="comma-separated solver degradation chain "
                         "for single solves, e.g. ga,heft")
    serve_p.add_argument("--device", default="cuda",
                         help="device of the metaheuristics' fitness (default cuda)")
    serve_p.add_argument("--trace", dest="trace_out", metavar="PATH",
                         help="write a Perfetto trace of this run to PATH "
                         "(+ PATH-adjacent .metrics.json)")

    camp_p = sub.add_parser("campaign", help="declarative multi-scenario "
                            "experiments (repro_torch.campaigns)")
    csub = camp_p.add_subparsers(dest="campaign_cmd", required=True)

    cexp = csub.add_parser("expand", help="preview a campaign's cell grid")
    cexp.add_argument("spec", help="campaign spec JSON file or built-in name")

    crun = csub.add_parser("run", help="execute a campaign")
    crun.add_argument("spec", help="campaign spec JSON file or built-in name")
    crun.add_argument("--runner", help="override the spec's runner "
                      "(inline | service | ...)")
    crun.add_argument("--out", help="save the columnar ResultSet JSON here")
    crun.add_argument("--csv", help="save the ResultSet as CSV here")
    crun.add_argument("--vs", default="milp",
                      help="exact baseline technique for the gap report "
                      "(default milp; 'none' disables)")
    crun.add_argument("--metric", default="makespan",
                      help="metric column for the gap report")
    crun.add_argument("--device", default="cuda",
                      help="device of the metaheuristics' fitness (default cuda)")
    crun.add_argument("--trace", dest="trace_out", metavar="PATH",
                      help="write a Perfetto trace of this run to PATH "
                      "(+ PATH-adjacent .metrics.json)")

    crep = csub.add_parser("report", help="optimality-gap report from saved "
                           "ResultSet JSON")
    crep.add_argument("results", help="path to a ResultSet JSON "
                      "(campaign run --out)")
    crep.add_argument("--vs", default="milp", help="exact baseline technique")
    crep.add_argument("--metric", default="makespan")
    crep.add_argument("--per-cell", action="store_true",
                      help="print per-cell gaps instead of the aggregate")

    obs_p = sub.add_parser("obs", help="summarize + validate a Perfetto "
                           "trace written by a --trace run")
    obs_p.add_argument("trace_file", help="trace_event JSON file")
    obs_p.add_argument("--json", action="store_true",
                       help="print the machine-readable summary JSON")

    top_p = sub.add_parser("topology", help="generated tiered continua + "
                           "digital-twin calibration (repro_torch.topology)")
    tsub = top_p.add_subparsers(dest="topology_cmd", required=True)

    tgen = tsub.add_parser("generate", help="expand a topology spec into a "
                           "system JSON (Fig. 7 format + dtr matrix)")
    tgen.add_argument("spec", help="topology spec JSON file or preset name "
                      "(tiny | small | medium | large)")
    tgen.add_argument("--seed", type=int, help="override the spec's seed")
    tgen.add_argument("--out", help="write the system JSON here "
                      "(default: stdout)")

    tcal = tsub.add_parser("calibrate", help="perturb a generated continuum, "
                           "fit factors from noisy observations, report "
                           "twin-vs-truth makespan error before/after")
    tcal.add_argument("spec", help="topology spec JSON file or preset name")
    tcal.add_argument("--seed", type=int, help="override the spec's seed")
    tcal.add_argument("--perturb-seed", type=int, default=7,
                      help="seed for the 0.5-2.0x truth speed factors")
    tcal.add_argument("--samples", type=int, default=32,
                      help="observed task durations per node")
    tcal.add_argument("--transfer-samples", type=int, default=0,
                      help="observed link transfers (0 = speeds only)")
    tcal.add_argument("--noise", type=float, default=0.05,
                      help="lognormal observation noise sigma")
    tcal.add_argument("--steps", type=int, default=300,
                      help="gradient-descent steps")
    tcal.add_argument("--tasks", type=int, default=48,
                      help="size of the probe workload")
    tcal.add_argument("--device", default="cuda",
                      help="device of the calibration's gradient descent (default cuda)")
    tcal.add_argument("--out", help="also write the report JSON here")

    args = parser.parse_args(argv)

    from repro_torch import obs

    if args.verbose:
        obs.setup_logging()
    trace_out = getattr(args, "trace_out", None)
    if trace_out:
        obs.enable_tracing()
    try:
        return _dispatch(args)
    finally:
        if trace_out:
            out = Path(trace_out)
            obs.write_trace(out)
            metrics_path = out.with_suffix(".metrics.json")
            obs.write_metrics(metrics_path)
            print(f"# wrote trace {out} (open in https://ui.perfetto.dev) "
                  f"and metrics {metrics_path}", file=sys.stderr)


def _dispatch(args) -> int:
    if args.cmd == "obs":
        return _obs_main(args)

    if args.cmd == "campaign":
        return _campaign_main(args)

    if args.cmd == "topology":
        return _topology_main(args)

    from repro_torch.core import api

    if args.cmd == "engines":
        from repro_torch.engine import ENGINES, resolve_engine

        auto = resolve_engine("auto")
        for eng in sorted(ENGINES, key=lambda e: e.name):
            caps = eng.capabilities
            flags = ", ".join(
                s for s, on in (
                    ("population", caps.supports_population),
                    ("batch", caps.supports_batch),
                    ("exact-f32", caps.exact_f32),
                    ("auto-default", eng.name == auto),
                ) if on
            ) or "-"
            print(f"{eng.name:12s} {flags}")
        return 0

    if args.cmd == "techniques":
        for entry in sorted(api.REGISTRY, key=lambda e: e.name):
            caps = entry.capabilities
            flags = ", ".join(
                s for s, on in (
                    ("exact", caps.exact),
                    (f"max_tasks={caps.max_tasks}", caps.max_tasks is not None),
                    ("batch", caps.supports_batch),
                    ("time-limited", caps.needs_time_limit),
                    ("engine-aware", caps.engine_aware),
                ) if on
            ) or "heuristic/approximate"
            print(f"{entry.name:12s} {flags}")
        return 0

    if args.cmd == "trace":
        from repro_torch.service import generate_trace

        trace = generate_trace(
            args.num_submissions,
            seed=args.seed,
            rate=args.rate,
            families=tuple(f.strip() for f in args.families.split(",") if f.strip()),
            node_events=args.node_events,
            chaos=json.loads(args.chaos) if args.chaos else None,
            cycling=json.loads(args.cycling) if args.cycling else None,
        )
        path = trace.save(args.out)
        cyc = sum(1 for s in trace.submissions if s.cycling is not None)
        print(f"wrote {len(trace.submissions)} submissions "
              f"({len(trace.events)} node events, {cyc} cycling) to {path}")
        return 0

    if args.cmd == "serve":
        from repro_torch.service import ServiceConfig, serve_trace

        result = serve_trace(
            args.trace,
            config=ServiceConfig(
                batch_window=args.batch_window,
                max_batch=args.max_batch,
                jitter=args.jitter,
                seed=args.seed,
                max_retries=args.max_retries,
                backoff_base=args.backoff_base,
                backoff_cap=args.backoff_cap,
                fallback=tuple(
                    t.strip() for t in args.fallback.split(",") if t.strip()
                ),
            ),
            device=args.device,
        )
        payload = result.summary()
        if args.trace_out:
            from repro_torch import obs

            payload["telemetry"] = obs.telemetry()
        if args.records:
            payload["records"] = [r.to_json() for r in result.records]
        summary = json.dumps(payload, indent=2)
        print(summary)
        if args.out:
            Path(args.out).write_text(summary + "\n")
        return 0

    scenario = api.load_scenario(args.scenario)
    if args.technique:
        scenario = scenario.replace(technique=args.technique)
    if args.backend:
        scenario = scenario.replace(backend=args.backend)
    if args.engine:
        scenario = scenario.replace(engine=args.engine)

    result = api.run_scenario(scenario, out_dir=args.out_dir, device=args.device)
    summary = json.dumps(result.summary(), indent=2)
    print(summary)
    if args.out:
        Path(args.out).write_text(summary + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
