"""Snakemake-compatible input formats (paper §V-A/B, Figs. 5–8).

Two entry points:

* :func:`parse_rules` — parses the paper's *annotated Snakefile rule*
  dialect (Fig. 6): ``rule <name>:`` blocks with ``input/output/resources``
  sections where resources carry the model attributes
  (``mem_mb``, ``features``, ``data``, ``duration``, ``cores``).
  Dependencies are inferred from input/output file products, exactly like
  Snakemake wires its DAG — plus an explicit ``dependencies`` escape hatch.
* :func:`load_config` — the JSON config route (Figs. 7/8), shared with
  :mod:`repro_torch.core.system_model` / :mod:`repro_torch.core.workload_model`.

The emitted sorted schedule (Fig. 4 step 3) is produced by
``Schedule.to_json`` and consumed by the executor/simulator.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Mapping

from repro_torch.core.system_model import System, system_from_json
from repro_torch.core.workload_model import Task, Workflow, Workload, workload_from_json

_RULE_RE = re.compile(r"^rule\s+([A-Za-z0-9_]+)\s*:")
_SECTION_RE = re.compile(r"^\s+(input|output|resources|run|shell)\s*:\s*(.*)$")
_KV_RE = re.compile(r"^\s+([A-Za-z_][A-Za-z0-9_]*)\s*=\s*(.+?)\s*(#.*)?$")


def _parse_value(raw: str) -> Any:
    raw = raw.strip().rstrip(",")
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        pass
    m = re.match(r"^(\d+(?:\.\d+)?)\s*GiB$", raw)
    if m:
        return float(m.group(1))
    m = re.match(r"^(\d+):(\d+):(\d+)$", raw)  # runtime hh:mm:ss
    if m:
        h, mn, s = map(int, m.groups())
        return float(h * 3600 + mn * 60 + s)
    return raw.strip("\"'")


def parse_rules(text: str) -> Workflow:
    """Parse an annotated Snakefile (Fig. 6 dialect) into a Workflow.

    Inter-rule dependencies come from matching ``input`` files to another
    rule's ``output`` files (Snakemake's product wiring).
    """
    rules: list[dict[str, Any]] = []
    current: dict[str, Any] | None = None
    section: str | None = None
    for line in text.splitlines():
        if not line.strip() or line.strip().startswith("#"):
            continue
        m = _RULE_RE.match(line)
        if m:
            current = {"name": m.group(1), "input": [], "output": [], "resources": {}}
            rules.append(current)
            section = None
            continue
        if current is None:
            continue
        m = _SECTION_RE.match(line)
        if m and not _KV_RE.match(line):
            section = m.group(1)
            continue
        if section in ("input", "output"):
            item = line.strip().rstrip(",")
            if item and not item.startswith("#"):
                current[section].append(item.split("#")[0].strip())
        elif section == "resources":
            kv = _KV_RE.match(line)
            if kv:
                current["resources"][kv.group(1)] = _parse_value(kv.group(2))

    producers: dict[str, str] = {}
    for r in rules:
        for out in r["output"]:
            producers[out] = r["name"]

    tasks: list[Task] = []
    for r in rules:
        res = r["resources"]
        deps = sorted(
            {producers[i] for i in r["input"] if i in producers}
            | set(res.get("dependencies", []))
        )
        dur = res.get("duration")
        durations = None
        work = 1.0
        if isinstance(dur, Mapping):
            durations = {k: float(v) for k, v in dur.items()}
        elif isinstance(dur, list):
            work = float(dur[0])
        elif dur is not None:
            work = float(dur)
        elif "runtime" in res:
            work = float(res["runtime"])
        tasks.append(
            Task(
                name=r["name"],
                cores=float(res.get("cores", 1)),
                memory=float(res["mem_mb"][0] if isinstance(res.get("mem_mb"), list) else res.get("mem_mb", 0)),
                data=float(res.get("data", 0.0)),
                features=frozenset(res.get("features", [])),
                work=work,
                durations=durations,
                deps=tuple(deps),
            )
        )
    return Workflow(name="snakefile", tasks=tuple(tasks))


def load_config(source: str | Path | Mapping[str, Any]) -> tuple[System | None, Workload | None]:
    """Load a combined JSON config holding Fig. 7 ``nodes`` and/or Fig. 8
    workflow sections (Snakemake ``configfile:`` style).

    Accepts a path or an already-parsed mapping — scenario files
    (:func:`repro_torch.core.api.scenario_from_json`) route their system/workload
    sections through this same parser; their ``"scenario"`` header is ignored
    here."""
    obj = source if isinstance(source, Mapping) else json.loads(Path(source).read_text())
    system = system_from_json(obj) if "nodes" in obj else None
    wf_obj = {
        k: v
        for k, v in obj.items()
        if k not in ("nodes", "dtr_matrix", "scenario")
        and isinstance(v, Mapping) and "tasks" in v
    }
    workload = workload_from_json(wf_obj) if wf_obj else None
    return system, workload


def dump_schedule(schedule_json: dict, path: str | Path) -> None:
    Path(path).write_text(json.dumps(schedule_json, indent=2))
