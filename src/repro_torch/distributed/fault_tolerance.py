"""Fault tolerance and elasticity for a training fleet: straggler
detection, re-meshing after a pod is lost, and re-placing the interrupted
jobs with the paper's own scheduler.

Ported from the reference's ``repro/distributed/fault_tolerance.py``.  The
failure model at 1000+ nodes: slow hosts (stragglers) that drag synchronous
steps, lost pods, planned rescales.

* :class:`StragglerDetector`: an EWMA of the step time and a z-score;
  persistent outliers are flagged (the trainer records them).
* :func:`plan_remesh`: given the surviving pods, the new mesh and the
  global-batch scale; checkpoints restore across meshes, since leaves are
  stored whole.
* :func:`replacement_schedule`: the interrupted jobs placed across the
  surviving pods by HEFT on the port's ``tpu_fleet``.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class StragglerDetector:
    """EWMA step-time outlier detection with hysteresis."""

    alpha: float = 0.1
    z_threshold: float = 3.0
    patience: int = 3  # consecutive outlier steps before flagging

    mean: float = 0.0
    var: float = 0.0
    count: int = 0
    consecutive: int = 0
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, step_time: float) -> bool:
        """True when this step is flagged as straggling."""
        if self.count < 5:  # warm-up
            self.mean = (self.mean * self.count + step_time) / (self.count + 1)
            self.count += 1
            return False
        std = math.sqrt(max(self.var, 1e-12))
        z = (step_time - self.mean) / max(std, 0.05 * self.mean, 1e-9)
        if z > self.z_threshold:
            self.consecutive += 1
        else:
            self.consecutive = 0
            # only non-outliers move the baseline (hysteresis)
            delta = step_time - self.mean
            self.mean += self.alpha * delta
            self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        self.count += 1
        if self.consecutive >= self.patience:
            self.flagged.append(step)
            self.consecutive = 0
            return True
        return False


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    global_batch_scale: float  # keep the per-chip batch constant
    reason: str


def plan_remesh(*, surviving_pods: int, chips_per_pod: int = 256,
                model_parallel: int = 16) -> RemeshPlan:
    """The elastic response to losing pods: shrink the pod axis, keep the
    intra-pod (data, model) structure, scale the global batch to hold the
    per-chip batch constant."""
    if surviving_pods < 1:
        raise ValueError("no surviving pods")
    data = chips_per_pod // model_parallel
    if surviving_pods == 1:
        return RemeshPlan(mesh_shape=(data, model_parallel), axis_names=("data", "model"),
                          global_batch_scale=1.0 / 2.0, reason="single pod: drop the pod axis entirely")
    return RemeshPlan(mesh_shape=(surviving_pods, data, model_parallel),
                      axis_names=("pod", "data", "model"), global_batch_scale=surviving_pods / 2.0,
                      reason=f"{surviving_pods} pods survive: rescale pod axis")


def replacement_schedule(jobs: list[dict], surviving_pods: int):
    """Re-place interrupted jobs across the surviving pods with HEFT (fast
    enough for the failure path); returns the solver's report.

    jobs: ``[{"name": str, "flops": float, "bytes_in": float}]``, e.g. the
    (arch × shape) cells that were running on the lost pod."""
    from repro_torch.core.api import solve
    from repro_torch.core.system_model import tpu_fleet
    from repro_torch.core.workload_model import Task, Workflow, Workload

    system = tpu_fleet(num_pods=surviving_pods, slices_per_pod=1)
    tasks = tuple(
        Task(name=j["name"], cores=1, data=float(j.get("bytes_in", 0.0)), features=frozenset({"F9"}),
             work=float(j["flops"]))
        for j in jobs
    )
    return solve(system, Workload((Workflow("restart", tasks),)), technique="heft")
