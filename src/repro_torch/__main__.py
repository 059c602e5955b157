"""Scenario runner CLI of the port.

    PYTHONPATH=src python -m repro_torch run scenario.json [--technique heft]
                                                           [--backend simulate]
                                                           [--engine cuda]
                                                           [--device cuda]
                                                           [--out result.json]
                                                           [--out-dir DIR]
    PYTHONPATH=src python -m repro_torch techniques
    PYTHONPATH=src python -m repro_torch engines

``run`` loads a declarative :class:`repro_torch.core.api.Scenario` (the
reference's file format, unchanged), drives the
:class:`repro_torch.core.api.Orchestrator` closed loop and prints
(optionally saves) the :class:`repro_torch.core.api.RunResult` summary JSON.
Metaheuristics run on ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch makespan version).  ``techniques`` lists the solver registry with
capability metadata, ``engines`` the fitness engines.
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
