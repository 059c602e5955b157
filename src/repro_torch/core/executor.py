"""Executor façade (paper Fig. 4, step 4): dispatch a solved schedule to
backends.

Backends:

* ``simulate``  — the discrete-event digital twin (the default)
* ``slurm``     — renders one ``sbatch`` script per task with ``--dependency``
  chains and resource flags (dry: writes scripts, does not submit)
* ``kubernetes``— renders one Job manifest per task with initContainer waits

The renderers make the SLURM/K8s integration contract concrete (what the
paper's DECICE executor consumes) while remaining runnable offline.
"""

from __future__ import annotations

import json
import re
import tempfile
from pathlib import Path

from repro_torch.core.evaluator import Schedule
from repro_torch.core.simulator import execute
from repro_torch.core.system_model import System
from repro_torch.core.workload_model import ScheduleProblem

DEFAULT_OUT_DIR = Path(tempfile.gettempdir()) / "repro_torch_executor"
"""Where the render backends write when the caller names no directory."""


def dispatch(
    problem: ScheduleProblem,
    schedule: Schedule,
    system: System,
    *,
    backend: str = "simulate",
    out_dir: str | Path = DEFAULT_OUT_DIR,
    **kwargs,
):
    if backend == "simulate":
        return execute(problem, schedule, **kwargs)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if backend == "slurm":
        return _render_slurm(problem, schedule, system, out)
    if backend == "kubernetes":
        return _render_k8s(problem, schedule, system, out)
    raise ValueError(f"unknown backend {backend!r}")


def _render_slurm(problem, schedule, system, out: Path) -> list[Path]:
    """One ``.sbatch`` per task plus a ``submit_all.sh`` driver.

    ``#SBATCH --dependency`` lines cannot reference other jobs by name before
    those jobs exist, so dependencies are wired at submit time: the driver
    submits in topological order (the problem's task order), captures each
    real job id via ``sbatch --parsable`` into a ``JOB_<name>`` variable, and
    passes ``--dependency=afterok:<ids>`` on the command line."""
    node_names = [n.name for n in system.nodes]
    paths = []
    submit = [
        "#!/bin/bash",
        "# submit the schedule in dependency (topological) order, capturing",
        "# real sbatch job ids so --dependency chains reference them",
        "set -euo pipefail",
        'DIR="$(cd "$(dirname "$0")" && pwd)"',
    ]
    # task names become bash variable names and filenames: restrict to
    # [A-Za-z0-9_] and uniquify collisions ('a/b' vs 'a_b')
    safe_names: dict[int, str] = {}
    used: set[str] = set()
    for j in range(problem.num_tasks):
        s = re.sub(r"[^A-Za-z0-9_]", "_", problem.task_names[j])
        if s in used:
            s = f"{s}_{j}"
        while s in used:  # the indexed fallback may itself be a raw name
            s += "_x"
        used.add(s)
        safe_names[j] = s
    # problem task indices are already topologically ordered (build_problem),
    # so every JOB_<dep> variable is defined before it is referenced
    for j in range(problem.num_tasks):
        name = safe_names[j]
        script = (
            "#!/bin/bash\n"
            f"#SBATCH --job-name={name}\n"
            f"#SBATCH --nodelist={node_names[int(schedule.assignment[j])]}\n"
            f"#SBATCH --cpus-per-task={int(problem.cores[j])}\n"
            f"# planned window: [{schedule.start[j]:.2f}, {schedule.finish[j]:.2f}] s\n"
            "srun run_task.sh\n"
        )
        p = out / f"{name}.sbatch"
        p.write_text(script)
        paths.append(p)
        deps = [int(pp) for pp in problem.pred_matrix[j] if pp >= 0]
        dep_flag = ""
        if deps:
            ids = ":".join("${JOB_%s}" % safe_names[pp] for pp in deps)
            dep_flag = f" --dependency=afterok:{ids}"
        submit.append(f'JOB_{name}=$(sbatch --parsable{dep_flag} "$DIR/{name}.sbatch")')
    submit.append(f'echo "submitted {problem.num_tasks} jobs"')
    driver = out / "submit_all.sh"
    driver.write_text("\n".join(submit) + "\n")
    driver.chmod(0o755)
    paths.append(driver)
    return paths


def _render_k8s(problem, schedule, system, out: Path) -> list[Path]:
    """One Job manifest per task plus an ``apply_all.sh`` wave driver.

    The ``repro/wait-for`` annotation documents dependencies but nothing in
    stock Kubernetes *enforces* it — Jobs all start at apply time.  The
    driver makes the dependency contract real (k8s parity with the SLURM
    ``submit_all.sh``): manifests are applied in topological *waves* (tasks
    whose predecessors all live in earlier waves), and each wave is gated on
    ``kubectl wait --for=condition=complete`` of the previous one."""
    node_names = [n.name for n in system.nodes]
    paths = []
    # DNS-1123 job names: lowercase alphanumerics and '-', ≤63 chars (base
    # truncated to leave suffix room), uniquified
    safe_names: dict[int, str] = {}
    used: set[str] = set()
    for j in range(problem.num_tasks):
        s = re.sub(r"[^a-z0-9-]", "-", problem.task_names[j].lower())
        s = s[:52].strip("-") or "task"
        if s in used:
            s = f"{s}-{j}"
        while s in used:  # the indexed fallback may itself be a raw name
            s += "-x"
        used.add(s)
        safe_names[j] = s
    for j in range(problem.num_tasks):
        name = safe_names[j]
        manifest = {
            "apiVersion": "batch/v1",
            "kind": "Job",
            "metadata": {"name": name, "labels": {"repro-schedule": "true"}},
            "spec": {
                "template": {
                    "spec": {
                        "nodeSelector": {
                            "repro/node": node_names[int(schedule.assignment[j])]
                        },
                        "containers": [
                            {
                                "name": "task",
                                "image": "repro/task:latest",
                                "resources": {
                                    "requests": {"cpu": str(int(problem.cores[j]))}
                                },
                            }
                        ],
                        "restartPolicy": "Never",
                    }
                }
            },
        }
        deps = [safe_names[int(p)] for p in problem.pred_matrix[j] if p >= 0]
        if deps:
            manifest["metadata"]["annotations"] = {"repro/wait-for": ",".join(deps)}
        p = out / f"{name}.json"
        p.write_text(json.dumps(manifest, indent=2))
        paths.append(p)

    # topological waves: wave(j) = 1 + max(wave(pred)); problem task order is
    # already topological (build_problem), so one forward pass suffices
    wave = [0] * problem.num_tasks
    for j in range(problem.num_tasks):
        preds = [int(p) for p in problem.pred_matrix[j] if p >= 0]
        if preds:
            wave[j] = 1 + max(wave[p] for p in preds)
    waves: dict[int, list[int]] = {}
    for j, w in enumerate(wave):
        waves.setdefault(w, []).append(j)

    driver = [
        "#!/bin/bash",
        "# apply the schedule in dependency (topological) waves; each wave",
        "# starts only after the previous wave's Jobs completed",
        "set -euo pipefail",
        'DIR="$(cd "$(dirname "$0")" && pwd)"',
        'TIMEOUT="${REPRO_WAIT_TIMEOUT:-3600s}"',
    ]
    for w in sorted(waves):
        members = waves[w]
        driver.append(f"# wave {w}: {len(members)} job(s)")
        apply_args = " ".join(f'-f "$DIR/{safe_names[j]}.json"' for j in members)
        driver.append(f"kubectl apply {apply_args}")
        wait_args = " ".join(f"job/{safe_names[j]}" for j in members)
        driver.append(
            f'kubectl wait --for=condition=complete --timeout="$TIMEOUT" {wait_args}'
        )
    driver.append(f'echo "completed {problem.num_tasks} jobs in {len(waves)} waves"')
    drv = out / "apply_all.sh"
    drv.write_text("\n".join(driver) + "\n")
    drv.chmod(0o755)
    paths.append(drv)
    return paths
