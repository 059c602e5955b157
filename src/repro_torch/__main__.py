"""Scenario runner CLI of the port.

    PYTHONPATH=src python -m repro_torch run scenario.json [--technique heft]
                                                           [--backend simulate]
                                                           [--engine cuda]
                                                           [--device cuda]
                                                           [--out result.json]
                                                           [--out-dir DIR]
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
turnaround / cache metrics, its GA admissions on ``--device``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


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

    args = parser.parse_args(argv)
    if args.verbose:
        from repro_torch import obs

        obs.setup_logging()

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
