"""Digital-twin calibration: fit node speeds and link rates from noise.

Given a pile of noisy observed task and transfer durations from the real
continuum, recover per-node **speed factors** and per-link **transfer
factors** so the twin's :class:`~repro_torch.engine.packed.PackedProblem`
timings match reality.

Model (log space, so the fit is a separable linear least squares)::

    observed task duration      d_k  =  durations[t_k, n_k] / f_{n_k} · ε
    observed transfer duration  x_m  =  data_m / (dtr[i_m, j_m] · g_{i_m j_m}) · ε

where ``durations`` / ``dtr`` are the twin's packed engine arrays and ε is
multiplicative lognormal noise.  Two fitters share the residual:

* :func:`least_squares_factors` — the closed-form log-space solution
  (per-node / per-link mean of log residuals, with L2 shrinkage toward 1.0);
* :func:`calibrate` — Adam written out in PyTorch on the device, f32
  parameters, the gradient from ``torch.autograd``: the reference's update,
  bias correction, ``l2`` term and step count, which generalizes to coupled
  residuals the closed form cannot express.

:func:`calibration_report` wires it end to end for a generated topology:
perturb a twin by seeded truth factors, synthesize observations, fit, and
report twin-vs-truth **makespan error before and after** calibration.
Everything but :func:`calibrate` is numpy and gives the reference's bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

import torch

from repro_torch.core.system_model import Node, System
from repro_torch.core.workload_model import ScheduleProblem, Workload, build_problem
from repro_torch.engine.packed import PackedProblem, pack
from repro_torch.engine.sim import run_schedule
from repro_torch.obs import TRACER

# ---------------------------------------------------------------------------
# Observations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Observations:
    """Noisy monitor samples against a twin's packed timings.

    Compute: ``duration[k]`` observed for task ``task[k]`` on node
    ``node[k]``.  Transfer: ``xfer_duration[m]`` observed moving
    ``data[m]`` GB over the ``src[m] → dst[m]`` link.  Either side may be
    empty."""

    task: np.ndarray  # [K] i64 — packed task row
    node: np.ndarray  # [K] i64 — packed node column
    duration: np.ndarray  # [K] f64 seconds
    src: np.ndarray  # [M] i64
    dst: np.ndarray  # [M] i64
    data: np.ndarray  # [M] f64 GB
    xfer_duration: np.ndarray  # [M] f64 seconds

    def __post_init__(self) -> None:
        if not (len(self.task) == len(self.node) == len(self.duration)):
            raise ValueError("compute observation arrays disagree in length")
        if not (
            len(self.src) == len(self.dst) == len(self.data) == len(self.xfer_duration)
        ):
            raise ValueError("transfer observation arrays disagree in length")
        if len(self.duration) and not (self.duration > 0).all():
            raise ValueError("observed durations must be > 0")
        if len(self.xfer_duration) and not (self.xfer_duration > 0).all():
            raise ValueError("observed transfer durations must be > 0")


def synthesize_observations(
    packed: PackedProblem,
    *,
    speed_factors: np.ndarray,
    link_factors: np.ndarray | None = None,
    samples_per_node: int = 32,
    transfer_samples: int = 0,
    noise: float = 0.05,
    seed: int = 0,
) -> Observations:
    """Draw what a monitor would have seen if the continuum ran at
    ``speed_factors`` / ``link_factors`` instead of the twin's book values:
    seeded (task, node) samples over the packed ``durations`` matrix and
    (src, dst) samples over ``dtr``, each with mean-preserving lognormal
    noise of sigma ``noise``."""
    rng = np.random.default_rng(seed)
    T, N = packed.num_tasks, packed.num_nodes
    durations = np.asarray(packed.durations[:T, :N], dtype=np.float64)
    feasible = np.asarray(packed.feasible[:T, :N], dtype=bool)
    ok = feasible & np.isfinite(durations) & (durations > 0)

    tasks: list[int] = []
    nodes: list[int] = []
    for n in range(N):
        pool = np.flatnonzero(ok[:, n])
        if len(pool) == 0:
            continue
        picks = rng.choice(pool, size=samples_per_node, replace=True)
        tasks.extend(int(t) for t in picks)
        nodes.extend([n] * samples_per_node)
    task = np.asarray(tasks, dtype=np.int64)
    node = np.asarray(nodes, dtype=np.int64)
    eps = np.exp(noise * rng.standard_normal(len(task)) - 0.5 * noise * noise)
    duration = durations[task, node] / speed_factors[node] * eps

    if transfer_samples and N > 1:
        dtr = np.asarray(packed.dtr[:N, :N], dtype=np.float64)
        g = np.ones((N, N)) if link_factors is None else np.asarray(link_factors)
        src = rng.integers(0, N, size=transfer_samples)
        dst = rng.integers(0, N - 1, size=transfer_samples)
        dst = np.where(dst >= src, dst + 1, dst)  # never the diagonal
        data = rng.uniform(0.01, 0.25, size=transfer_samples)
        xeps = np.exp(
            noise * rng.standard_normal(transfer_samples) - 0.5 * noise * noise
        )
        xfer = data / (dtr[src, dst] * g[src, dst]) * xeps
        keep = np.isfinite(xfer) & (xfer > 0)
        src, dst, data, xfer = src[keep], dst[keep], data[keep], xfer[keep]
    else:
        src = dst = np.zeros(0, dtype=np.int64)
        data = xfer = np.zeros(0, dtype=np.float64)
    return Observations(
        task=task,
        node=node,
        duration=duration,
        src=src.astype(np.int64),
        dst=dst.astype(np.int64),
        data=np.asarray(data, dtype=np.float64),
        xfer_duration=np.asarray(xfer, dtype=np.float64),
    )


# ---------------------------------------------------------------------------
# Fitters
# ---------------------------------------------------------------------------


def _log_residual_terms(
    packed: PackedProblem, obs: Observations
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-observation log targets: ``log f`` should equal ``base_c -
    log(obs)`` per compute sample (and likewise per link).  Returns
    ``(target_c, node_idx, target_x, link_src, link_dst)``."""
    T, N = packed.num_tasks, packed.num_nodes
    durations = np.asarray(packed.durations[:T, :N], dtype=np.float64)
    base_c = np.log(durations[obs.task, obs.node])
    target_c = base_c - np.log(obs.duration)
    if len(obs.src):
        dtr = np.asarray(packed.dtr[:N, :N], dtype=np.float64)
        base_x = np.log(obs.data) - np.log(dtr[obs.src, obs.dst])
        target_x = base_x - np.log(obs.xfer_duration)
    else:
        target_x = np.zeros(0, dtype=np.float64)
    return target_c, obs.node, target_x, obs.src, obs.dst


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Fitted factors plus fit diagnostics.

    ``speed_factors[n]`` multiplies node n's processing speed;
    ``link_factors[i, j]`` multiplies ``dtr[i, j]`` (1.0 where no
    observation constrained the link).  ``coverage`` counts observations
    per node."""

    speed_factors: np.ndarray  # [N]
    link_factors: np.ndarray  # [N, N], 1.0 where unobserved
    baseline_speed_factors: np.ndarray  # closed-form comparison fit
    loss: tuple[float, float]  # (initial, final) GD loss
    steps: int
    coverage: np.ndarray  # [N] compute observations per node

    def to_json(self, node_names: list[str] | None = None) -> dict[str, Any]:
        names = node_names or [f"n{i}" for i in range(len(self.speed_factors))]
        return {
            "speed_factors": {
                nm: float(f) for nm, f in zip(names, self.speed_factors)
            },
            "loss_initial": float(self.loss[0]),
            "loss_final": float(self.loss[1]),
            "steps": self.steps,
            "observed_nodes": int((self.coverage > 0).sum()),
        }


def least_squares_factors(
    packed: PackedProblem, obs: Observations, *, l2: float = 1e-3
) -> tuple[np.ndarray, np.ndarray]:
    """Closed-form log-space solution: the model is separable, so the exact
    minimizer of the GD loss is a shrunk per-node / per-link mean of the log
    residual targets.  Returns ``(speed_factors [N], link_factors [N, N])``."""
    N = packed.num_nodes
    target_c, node_idx, target_x, src, dst = _log_residual_terms(packed, obs)
    K = max(len(target_c), 1)
    count = np.bincount(node_idx, minlength=N).astype(np.float64)
    total = np.bincount(node_idx, weights=target_c, minlength=N)
    # minimize 0.5/K Σ (t_k - log f_n)² + l2 Σ log f² ⇒
    #   log f_n = Σ_k t_k / (count_n + 2 l2 K)
    log_f = total / (count + 2.0 * l2 * K)
    link = np.ones((N, N), dtype=np.float64)
    if len(target_x):
        M = len(target_x)
        flat = src * N + dst
        xcount = np.bincount(flat, minlength=N * N).astype(np.float64)
        xtotal = np.bincount(flat, weights=target_x, minlength=N * N)
        with np.errstate(invalid="ignore"):
            log_g = np.where(
                xcount > 0, xtotal / (xcount + 2.0 * l2 * M), 0.0
            )
        link = np.exp(log_g).reshape(N, N)
    return np.exp(log_f), link


def calibrate(
    packed: PackedProblem,
    obs: Observations,
    *,
    steps: int = 300,
    lr: float = 0.05,
    l2: float = 1e-3,
    device="cuda",
) -> CalibrationResult:
    """Adam gradient descent on the log residual, on ``device``.

    ``steps`` updates of f32 parameters ``(log f [N], log g [N·N] or [1])``
    from zero, each with the gradient of the loss by ``torch.autograd`` and
    Adam's moments (β₁ 0.9, β₂ 0.999, ε 1e-8) and bias correction at step
    ``t = i + 1``, as the reference's ``lax.scan`` runs them; no
    ``torch.optim``, whose update order is not the reference's.  The losses
    stay on the device until the last step.  Unobserved nodes/links stay at
    factor 1.0 (the L2 term pulls their free parameters to ``log 1 = 0``)."""
    N = packed.num_nodes
    target_c, node_idx, target_x, src, dst = _log_residual_terms(packed, obs)
    has_x = len(target_x) > 0
    dev = torch.device(device)
    f32 = torch.float32
    t_c = torch.as_tensor(target_c, dtype=f32, device=dev)
    n_idx = torch.as_tensor(node_idx, dtype=torch.int64, device=dev)
    t_x = torch.as_tensor(target_x if has_x else np.zeros(1), dtype=f32, device=dev)
    l_idx = torch.as_tensor((src * N + dst) if has_x else np.zeros(1, np.int64), dtype=torch.int64, device=dev)

    def loss_fn(log_f, log_g):
        res_c = log_f[n_idx] - t_c
        loss = 0.5 * torch.mean(res_c**2)
        if has_x:
            res_x = log_g[l_idx] - t_x
            loss = loss + 0.5 * torch.mean(res_x**2)
        return loss + l2 * (torch.sum(log_f**2) + torch.sum(log_g**2))

    params = [torch.zeros(N, dtype=f32, device=dev), torch.zeros(N * N if has_x else 1, dtype=f32, device=dev)]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses = torch.empty(steps, dtype=f32, device=dev)
    for i in range(steps):
        leaves = [p.requires_grad_() for p in params]
        loss = loss_fn(*leaves)
        grads = torch.autograd.grad(loss, leaves)
        t = np.float32(i) + np.float32(1.0)
        bc1 = float(np.float32(1.0) - np.float32(0.9) ** t)
        bc2 = float(np.float32(1.0) - np.float32(0.999) ** t)
        with torch.no_grad():
            losses[i] = loss
            for k, g in enumerate(grads):
                m[k] = 0.9 * m[k] + 0.1 * g
                v[k] = 0.999 * v[k] + 0.001 * g * g
                params[k] = params[k].detach() - lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + 1e-8)
    log_f = params[0].detach().cpu().numpy().astype(np.float64)
    losses_h = losses.cpu().numpy()
    coverage = np.bincount(node_idx, minlength=N)
    link = np.ones((N, N), dtype=np.float64)
    if has_x:
        observed = np.zeros(N * N, dtype=bool)
        observed[np.asarray(src) * N + np.asarray(dst)] = True
        g = np.where(observed, params[1].detach().cpu().numpy().astype(np.float64), 0.0)
        link = np.exp(g).reshape(N, N)
    base_f, _ = least_squares_factors(packed, obs, l2=l2)
    return CalibrationResult(
        speed_factors=np.exp(log_f),
        link_factors=link,
        baseline_speed_factors=base_f,
        loss=(float(losses_h[0]), float(losses_h[-1])),
        steps=steps,
        coverage=coverage,
    )


# ---------------------------------------------------------------------------
# Applying factors / twin error
# ---------------------------------------------------------------------------


def apply_factors(
    system: System,
    speed_factors: np.ndarray | Mapping[str, float],
    link_factors: np.ndarray | None = None,
) -> System:
    """A new :class:`System` with node speeds scaled by ``speed_factors``
    and ``dtr`` scaled entrywise by ``link_factors`` (diagonal stays +inf)."""
    if isinstance(speed_factors, Mapping):
        speed_factors = np.array(
            [float(speed_factors.get(n.name, 1.0)) for n in system.nodes]
        )
    nodes = []
    for node, f in zip(system.nodes, speed_factors):
        props = dict(node.properties)
        props["processing_speed"] = float(node.processing_speed * f)
        nodes.append(
            Node(
                name=node.name,
                resources=node.resources,
                features=node.features,
                properties=props,
            )
        )
    dtr = system.dtr.copy()
    if link_factors is not None:
        dtr = dtr * np.asarray(link_factors, dtype=np.float64)
        np.fill_diagonal(dtr, np.inf)
    return System(nodes=tuple(nodes), dtr=dtr)


def twin_makespan_error(
    twin: System,
    truth: System,
    workload: Workload,
    *,
    technique: str = "heft",
    options: Mapping[str, Any] | None = None,
    device="cuda",
) -> dict[str, float]:
    """Schedule on the twin, replay the assignment under the truth timings;
    report predicted vs observed makespan and the relative twin error.
    ``device`` reaches an engine-aware ``technique`` (the GA's fitness)."""
    from repro_torch.core.api import route_problem

    problem = build_problem(twin, workload)
    report = route_problem(problem, technique=technique, options=options or {}, device=device)
    predicted = float(report.schedule.makespan)
    truth_problem = build_problem(truth, workload)
    _, finish, violations = run_schedule(
        truth_problem, report.schedule.assignment
    )
    observed = float(finish.max()) if len(finish) else 0.0
    return {
        "predicted_makespan": predicted,
        "observed_makespan": observed,
        "relative_error": abs(predicted - observed) / max(observed, 1e-12),
        "violations": int(violations),
    }


def perturbed_truth(
    system: System,
    *,
    seed: int = 0,
    speed_range: tuple[float, float] = (0.5, 2.0),
    link_range: tuple[float, float] = (0.5, 2.0),
) -> tuple[System, np.ndarray, np.ndarray]:
    """A seeded 'real continuum' deviating from the twin: per-node speed
    factors and per-link transfer factors drawn uniformly.  Returns
    ``(truth_system, speed_factors, link_factors)``."""
    rng = np.random.default_rng(seed)
    n = system.num_nodes
    f = rng.uniform(speed_range[0], speed_range[1], n)
    g = rng.uniform(link_range[0], link_range[1], (n, n))
    np.fill_diagonal(g, 1.0)
    return apply_factors(system, f, g), f, g


def calibration_report(
    system: System,
    workload: Workload,
    *,
    perturb_seed: int = 7,
    samples_per_node: int = 32,
    transfer_samples: int = 0,
    noise: float = 0.05,
    steps: int = 300,
    technique: str = "heft",
    options: Mapping[str, Any] | None = None,
    device="cuda",
) -> dict[str, Any]:
    """End-to-end twin-calibration experiment on one system + workload:

    1. perturb the twin into a seeded truth continuum (0.5–2.0× speeds);
    2. synthesize noisy monitor observations from the truth;
    3. fit factors (Adam on ``device`` + closed-form baseline);
    4. report factor-recovery MAE and twin-vs-truth makespan error
       **before and after** applying the calibration.
    """
    # only perturb what the observations can constrain: with no transfer
    # samples the links stay truthful, so the before/after error isolates
    # the speed miscalibration being fitted
    link_range = (0.5, 2.0) if transfer_samples else (1.0, 1.0)
    truth, f_true, g_true = perturbed_truth(
        system, seed=perturb_seed, link_range=link_range
    )
    problem = build_problem(system, workload)
    packed = pack(problem, pad=False)
    with TRACER.span("calibrate.synthesize", cat="topology",
                     args={"samples_per_node": samples_per_node}):
        obs = synthesize_observations(
            packed,
            speed_factors=f_true,
            link_factors=g_true,
            samples_per_node=samples_per_node,
            transfer_samples=transfer_samples,
            noise=noise,
            seed=perturb_seed + 1,
        )
    with TRACER.span("calibrate.fit", cat="topology", args={"steps": steps}):
        result = calibrate(packed, obs, steps=steps, device=device)
    calibrated = apply_factors(
        system,
        result.speed_factors,
        result.link_factors if transfer_samples else None,
    )
    with TRACER.span("calibrate.evaluate", cat="topology"):
        before = twin_makespan_error(
            system, truth, workload, technique=technique, options=options, device=device
        )
        after = twin_makespan_error(
            calibrated, truth, workload, technique=technique, options=options, device=device
        )
    covered = result.coverage > 0
    mae = float(
        np.abs(result.speed_factors[covered] - f_true[covered]).mean()
    ) if covered.any() else float("nan")
    mae_rel = float(
        np.abs(
            result.speed_factors[covered] / f_true[covered] - 1.0
        ).mean()
    ) if covered.any() else float("nan")
    base_rel = float(
        np.abs(
            result.baseline_speed_factors[covered] / f_true[covered] - 1.0
        ).mean()
    ) if covered.any() else float("nan")
    return {
        "nodes": system.num_nodes,
        "observations": int(len(obs.duration)),
        "transfer_observations": int(len(obs.xfer_duration)),
        "noise": noise,
        "steps": result.steps,
        "loss_initial": result.loss[0],
        "loss_final": result.loss[1],
        "speed_factor_mae": mae,
        "speed_factor_rel_mae": mae_rel,
        "baseline_rel_mae": base_rel,
        "twin_error_before": before["relative_error"],
        "twin_error_after": after["relative_error"],
        "predicted_makespan_before": before["predicted_makespan"],
        "predicted_makespan_after": after["predicted_makespan"],
        "observed_makespan": before["observed_makespan"],
    }
