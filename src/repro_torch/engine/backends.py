"""Backend-pluggable schedule evaluation behind one interface.

Every way of scoring schedules against a
:class:`~repro_torch.engine.packed.PackedProblem` is a registered
:class:`ScheduleEngine` with capability metadata:

* ``oracle`` — the numpy incremental simulator (:mod:`repro_torch.engine.sim`);
  ground truth, per-task start/finish times;
* ``torch`` — the plain PyTorch makespan version on any device (what the
  CPU runs, and the yardstick the kernel is held to);
* ``cuda`` — the hand-written Hopper kernel (``kernels/csrc/makespan.cu``)
  through its wrapper, which alone chooses by the tensors' device: the
  kernel on a CUDA device, the plain version on the CPU.

All three are bit-for-bit equivalent in f32 (``exact_f32``).  ``auto`` is
``cuda``.  The device is always the caller's choice; it defaults to
``"cuda"`` and is never guessed from what the machine has.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.workload_model import BIG_PENALTY, ScheduleProblem
from repro_torch.engine.packed import PackedProblem, _round_up_pow2, bucket_of, pack, stack_packed
from repro_torch.kernels import _build
from repro_torch.kernels.makespan import population_makespan_cuda, population_makespan_ref

_ALIASES = {"numpy": "oracle", "auto": "cuda"}


def _weights(weights):
    # imported at call time: repro_torch.core.evaluator imports this package
    from repro_torch.core.evaluator import ObjectiveWeights

    return weights or ObjectiveWeights()


def _usage_term(arrays, assignments: torch.Tensor, usage_mode: str) -> torch.Tensor:
    """Σ_j U_j(a_j) per candidate: ``assignments [B, P, T]`` → ``[B, P]``.
    In ``fixed`` mode it is the instance's usage sum ``usage_total``, made
    with the arrays (:func:`repro_torch.engine.packed.fitness_tensors`)."""
    B, P, T = assignments.shape
    if usage_mode == "weighted":
        uw = arrays["usage_weighted"][:, None].expand(B, P, T, -1)
        return torch.gather(uw, 3, assignments.long()[..., None])[..., 0].sum(dim=-1)
    return arrays["usage_total"][:, None].expand(B, P)


def _budget_overage(arrays, assignments: torch.Tensor) -> torch.Tensor:
    """Per-candidate count of workflows whose total cost exceeds their
    budget: ``assignments [B, P, T]`` → ``[B, P]`` f32.  Workflow sums are
    masked row reductions, as in the reference."""
    B, P, T = assignments.shape
    cost = arrays["cost"][:, None].expand(B, P, T, -1)
    cost_t = torch.gather(cost, 3, assignments.long()[..., None])[..., 0]  # [B, P, T]
    rows = torch.arange(T, device=assignments.device)
    wf_rows = arrays["wf"][:, None, :] == rows[None, :, None]  # [B, T(wf rows), T]
    wf_cost = torch.where(wf_rows[:, None], cost_t[:, :, None, :], 0.0).sum(dim=-1)
    return (wf_cost > arrays["wf_budget"][:, None, :]).sum(dim=-1).to(torch.float32)


def _fma(x: float | torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``x * y + z`` for an f32-valued scalar or f32 tensor ``x`` and f32
    tensors, rounded once to f32, as a fused multiply-add rounds it on any
    device.

    The product of two f32 values is exact in f64.  Their f64 sum ``s`` need
    not be, and rounding an inexact ``s`` to f32 could round twice (when
    ``s`` lands on a midpoint of f32 values).  So ``s`` is rounded to odd
    instead: where the error of the sum (Knuth's TwoSum) is not zero and
    ``s`` is even, ``s`` steps one f64 ulp towards the exact sum.  A value
    rounded to odd with 53 bits rounds to nearest at 24 bits exactly as the
    exact value does (Boldo and Melquiond, IEEE Trans. Computers 57(4),
    2008)."""
    p, zd = (x.double() if torch.is_tensor(x) else x) * y.double(), z.double()
    s = p + zd
    pv = s - zd
    err = (p - pv) + (zd - (s - pv))
    even = (s.view(torch.int64) & 1) == 0
    towards = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, towards), s)
    return s.to(torch.float32)


def _objective(alpha: float, beta: float, usage, makespan, violations, usage_mode: str) -> torch.Tensor:
    """``α·usage + β·makespan + BIG_PENALTY·violations`` in f32, rounded as
    the reference's jitted XLA program rounds it on the CPU, where each
    multiply-add is fused.  In ``fixed`` mode the usage is one number per
    instance, so ``α·usage`` is a plain product and ``β·makespan`` fuses into
    the add; in ``weighted`` mode it is ``α·usage`` that fuses.  The weights
    are rounded to f32 first, as the reference's weakly typed scalars are."""
    a, b = float(np.float32(alpha)), float(np.float32(beta))
    if usage_mode == "weighted":
        weighted_sum = _fma(a, usage, b * makespan)
    else:
        weighted_sum = _fma(b, makespan, a * usage)
    return _fma(BIG_PENALTY, violations, weighted_sum)


def population_fitness_from_arrays(
    assignments: torch.Tensor,
    arrays: dict,
    alpha: float,
    beta: float,
    usage_mode: str,
    constrained: bool = False,
    *,
    makespan_fn: Callable,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fitness over packed arrays: ``assignments [P, T]`` with one
    instance's arrays, or ``[B, P, T]`` with a stacked family's, →
    ``(objective, makespan)`` of shape ``[P]`` or ``[B, P]``.  The arrays
    are those :func:`repro_torch.engine.packed.fitness_tensors` makes
    (``PackedProblem.device_arrays``, ``stack_packed``).

    ``constrained=True`` counts late tasks inside the makespan pass and adds
    the budget overage, each worth ``BIG_PENALTY``.  ``makespan_fn`` is the
    makespan implementation, an engine's."""
    batched = assignments.dim() == 3
    if not batched:
        assignments = assignments[None]
        arrays = {k: v[None] for k, v in arrays.items()}
    makespan, violations = makespan_fn(
        assignments,
        durations=arrays["durations"],
        cores=arrays["cores"],
        data=arrays["data"],
        feasible=arrays["feasible"],
        release=arrays["release"],
        pred_matrix=arrays["pred_matrix"],
        dtr=arrays["dtr"],
        init_free=arrays["init_free"],
        node_cores=arrays["node_cores"],
        deadline=arrays["deadline"] if constrained else None,
    )
    if constrained:
        violations = violations + _budget_overage(arrays, assignments)
    usage = _usage_term(arrays, assignments, usage_mode)
    obj = _objective(alpha, beta, usage, makespan, violations, usage_mode)
    if not batched:
        return obj[0], makespan[0]
    return obj, makespan


def _kernel_library_collector() -> dict[str, int]:
    """What plays the part of a jit cache in the port: the kernel libraries
    loaded so far (each ``csrc/<name>.cu`` is built and loaded once per
    process, at its first launch)."""
    return {"loaded": len(_build._LOADED), **{name: 1 for name in sorted(_build._LOADED)}}


obs.METRICS.register_collector("engine_kernel_libraries", _kernel_library_collector)


def _pad_population(assignments, tasks_bucket: int, device) -> torch.Tensor:
    """Contiguous int32 population on ``device`` with its task columns padded
    to the bucket; padded tasks are pinned to node 0 (their only node)."""
    a = torch.as_tensor(assignments, device=device).to(torch.int32)
    gap = tasks_bucket - a.shape[-1]
    if gap < 0:
        raise ValueError(f"population has {a.shape[-1]} task columns > bucket {tasks_bucket}")
    if gap:
        a = torch.cat([a, a.new_zeros(a.shape[:-1] + (gap,))], dim=-1)
    return a.contiguous()


@dataclasses.dataclass(frozen=True)
class EngineCapabilities:
    """``supports_population`` — scores [P, T] candidate batches;
    ``supports_batch`` — scores stacked multi-instance families at once;
    ``exact_f32`` — bit-for-bit equal to every other exact backend in f32."""

    supports_population: bool = True
    supports_batch: bool = False
    exact_f32: bool = False


class ScheduleEngine:
    """One way of executing schedules against a problem."""

    name: str = ""
    capabilities = EngineCapabilities()

    def evaluate(self, problem: ScheduleProblem, assignment, weights=None, technique: str = "", *, dtype=np.float64):
        """Canonical per-task timing (a ``Schedule``) from the oracle, the
        one backend that produces start and finish times."""
        from repro_torch.core.evaluator import evaluate_assignment

        return evaluate_assignment(
            problem, assignment, _weights(weights), technique=technique, dtype=dtype
        )

    def population_fitness(
        self, problem, weights=None, *, core_cap: int | None = None, device="cuda"
    ) -> Callable:
        """Returns ``fitness(assignments [P, T]) -> (objective [P], makespan [P])``."""
        raise NotImplementedError(f"engine {self.name!r} has no population path")

    def evaluate_population(self, problem, assignments, weights=None, *, device="cuda"):
        """``(objective [P], makespan [P])`` as numpy arrays."""
        obj, mk = self.population_fitness(problem, weights, device=device)(assignments)
        return obj.cpu().numpy(), mk.cpu().numpy()


class EngineRegistry:
    """Name → engine mapping with capability metadata."""

    def __init__(self) -> None:
        self._entries: dict[str, ScheduleEngine] = {}

    def register(self, name: str, engine=None, *, overwrite: bool = False):
        """Register an engine instance (or decorate a ``ScheduleEngine``
        class, which is instantiated)."""

        def _add(obj):
            inst = obj() if isinstance(obj, type) else obj
            if name in self._entries and not overwrite:
                raise ValueError(f"engine {name!r} already registered")
            inst.name = name
            self._entries[name] = inst
            return obj

        return _add if engine is None else _add(engine)

    def unregister(self, name: str) -> None:
        self._entries.pop(name, None)

    def get(self, name: str) -> ScheduleEngine:
        resolved = resolve_engine(name)
        try:
            return self._entries[resolved]
        except KeyError:
            raise KeyError(f"unknown engine {name!r}; options {sorted(self._entries)}") from None

    def names(self) -> tuple[str, ...]:
        return tuple(self._entries)

    def capabilities(self, name: str) -> EngineCapabilities:
        return self.get(name).capabilities

    def __contains__(self, name: object) -> bool:
        return isinstance(name, str) and resolve_engine(name) in self._entries

    def __iter__(self):
        return iter(self._entries.values())


ENGINES = EngineRegistry()
"""The default process-wide engine registry (built-ins below)."""


def register_engine(name: str, *, overwrite: bool = False):
    """Decorator: register a :class:`ScheduleEngine` subclass under ``name``."""
    return ENGINES.register(name, overwrite=overwrite)


def resolve_engine(name: str) -> str:
    """Resolve aliases (``numpy`` → ``oracle``, ``auto`` → ``cuda``)."""
    name = name or "auto"
    return _ALIASES.get(name, name)


@register_engine("oracle")
class OracleEngine(ScheduleEngine):
    """The numpy incremental simulator, candidate by candidate in f32 — the
    device engines' operation order, bit for bit."""

    capabilities = EngineCapabilities(supports_population=True, supports_batch=False, exact_f32=True)

    def population_fitness(self, problem, weights=None, *, core_cap: int | None = None, device="cuda"):
        w = _weights(weights)

        def fitness(assignments):
            A = np.asarray(torch.as_tensor(assignments).cpu())
            obj = np.empty(A.shape[0], np.float64)
            mk = np.empty(A.shape[0], np.float32)
            for k in range(A.shape[0]):
                s = self.evaluate(problem, A[k], w, dtype=np.float32)
                obj[k], mk[k] = s.objective, np.float32(s.makespan)
            return torch.from_numpy(obj).to(device), torch.from_numpy(mk).to(device)

        return fitness


class _PackedEngine(ScheduleEngine):
    """Population fitness over packed device tensors through one makespan
    implementation (``makespan_fn``)."""

    capabilities = EngineCapabilities(supports_population=True, supports_batch=True, exact_f32=True)
    makespan_fn: Callable

    def population_fitness(self, problem, weights=None, *, core_cap: int | None = None, device="cuda"):
        w = _weights(weights)
        # one instance keeps its exact shapes: padding to the pow2 bucket would
        # inflate every fitness call by up to 2x; buckets pay off when batching
        packed = (
            problem if isinstance(problem, PackedProblem)
            else pack(problem, core_cap=core_cap, pad=False)
        )
        arrays = packed.device_arrays(device)
        tb, constrained, fn = packed.bucket[0], packed.constrained, type(self).makespan_fn
        bucket, name = packed.bucket, self.name

        def fitness(assignments):
            # no cache probe: the first call per bucket (the one that loads
            # the kernel library on the card) counts as the compile
            with obs.FITNESS.measure(name, bucket, w.usage_mode):
                a = _pad_population(assignments, tb, device)
                return population_fitness_from_arrays(
                    a, arrays, w.alpha, w.beta, w.usage_mode, constrained, makespan_fn=fn
                )

        return fitness

    def batched_fitness(
        self, problems: Sequence[ScheduleProblem], weights=None, *, device="cuda",
        shard: int | str | None = "auto",
    ):
        """Fitness over a family stacked into one bucket:
        ``fitness(assignments [B, P, Tb]) -> (objective [B, P], makespan [B, P])``,
        one makespan call for the whole family.

        ``shard="auto"`` stripes the instance axis over ``device``'s stripes
        (:mod:`repro_torch.engine.shard`) when there is more than one; an int
        forces that shard count; ``None``/``1``/``"off"`` keeps the family on
        ``device`` in one call.  All choices give the same bits."""
        from repro_torch.engine import shard as shard_mod

        w = _weights(weights)
        if shard == "auto":
            shards = shard_mod.choose_shards(len(problems), device=device)
        elif shard in (None, "off", ""):
            shards = 1
        else:
            shards = int(shard)
        if shards > 1:
            return shard_mod.sharded_batched_fitness(
                problems, w, shards=shards, engine=self.name, device=device
            )
        arrays, bucket = stack_packed(problems, device=device)
        return _family_fitness(
            [(arrays, torch.device(device))], len(problems), bucket, w,
            any(p.has_constraints for p in problems), type(self).makespan_fn, f"{self.name}-batch",
        )


def _family_fitness(
    slices: Sequence[tuple[dict, torch.device]],
    instances: int,
    bucket,
    w,
    constrained: bool,
    makespan_fn: Callable,
    key: str,
) -> Callable:
    """``fitness(assignments [B, P, Tb]) -> (objective [B, P], makespan [B, P])``
    over a stacked family held as ``slices``: ``(arrays, device)`` pairs of
    equal row counts in instance order, of whose rows the first
    ``instances`` are real and the rest replicate instance 0.  One slice
    scores the whole family in one call; more are the stripes of
    :mod:`repro_torch.engine.shard`, each scored on its device (one launch
    a stripe) and gathered onto the first once all are launched."""
    padded = sum(int(arr["durations"].shape[0]) for arr, _ in slices)
    first = slices[0][1]

    def score(a: torch.Tensor, arrays: dict):
        return population_fitness_from_arrays(
            a, arrays, w.alpha, w.beta, w.usage_mode, constrained, makespan_fn=makespan_fn
        )

    def fitness(assignments):
        if assignments.shape[0] != instances:
            raise ValueError(f"expected {instances} instance rows, got {assignments.shape[0]}")
        with obs.FITNESS.measure(key, bucket, w.usage_mode):
            a = _pad_population(assignments, bucket[0], first)
            if len(slices) == 1:
                return score(a, slices[0][0])
            from repro_torch.engine.shard import shard_population

            if padded != instances:  # replicate instance 0's candidates into the pad rows
                a = torch.cat([a, a[:1].expand(padded - instances, -1, -1)])
            outs = [
                score(chunk, arrays)
                for chunk, (arrays, _) in zip(shard_population(a, [d for _, d in slices]), slices)
            ]
            obj = torch.cat([o.to(first) for o, _ in outs])[:instances]
            mk = torch.cat([m.to(first) for _, m in outs])[:instances]
        return obj, mk

    fitness.bucket = bucket  # type: ignore[attr-defined]
    fitness.num_instances = instances  # type: ignore[attr-defined]
    fitness.shards = len(slices)  # type: ignore[attr-defined]
    return fitness


@register_engine("torch")
class TorchEngine(_PackedEngine):
    """The plain PyTorch makespan version, on any device."""

    makespan_fn = staticmethod(population_makespan_ref)


@register_engine("cuda")
class CudaEngine(_PackedEngine):
    """The hand-written Hopper makespan kernel through its wrapper (the
    plain version for CPU tensors)."""

    makespan_fn = staticmethod(population_makespan_cuda)


def population_fitness_fn(
    problem,
    weights=None,
    *,
    engine: str = "auto",
    core_cap: int | None = None,
    device="cuda",
) -> Callable:
    """Registry-routed ``fitness(assignments [P, T]) -> (obj [P], mk [P])``
    on ``device``."""
    return ENGINES.get(engine).population_fitness(
        problem, weights, core_cap=core_cap, device=device
    )


def batched_population_fitness_fn(
    problems: Sequence[ScheduleProblem],
    weights=None,
    *,
    engine: str = "auto",
    device="cuda",
    shard: int | str | None = "auto",
) -> Callable:
    """Registry-routed fitness over one stacked instance family (needs a
    backend with ``supports_batch``), striped by ``shard`` as
    ``batched_fitness`` stripes it."""
    eng = ENGINES.get(engine)
    if not eng.capabilities.supports_batch:
        raise ValueError(f"engine {eng.name!r} does not support batched families")
    return eng.batched_fitness(problems, weights, device=device, shard=shard)  # type: ignore[attr-defined]


def evaluate_population_batch(
    problems: Sequence[ScheduleProblem],
    populations: Sequence[np.ndarray],
    weights=None,
    *,
    engine: str = "auto",
    device="cuda",
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Evaluate per-instance candidate populations for a list of problems.

    Instances are grouped by shape bucket; each group is padded, stacked and
    scored by one batched fitness call.  Returns, per instance and in the
    input order, ``(objective [P_i], makespan [P_i])`` as numpy arrays."""
    if len(problems) != len(populations):
        raise ValueError("need one population per problem")
    groups: dict[tuple[int, int, int, int], list[int]] = {}
    pops = [np.asarray(p) for p in populations]
    for idx, problem in enumerate(problems):
        groups.setdefault(bucket_of(problem), []).append(idx)

    out: list[tuple[np.ndarray, np.ndarray] | None] = [None] * len(problems)
    for bucket, members in groups.items():
        pb = _round_up_pow2(max(pops[m].shape[0] for m in members))
        batch = np.zeros((len(members), pb, bucket[0]), np.int32)
        for row, m in enumerate(members):
            batch[row, : pops[m].shape[0], : pops[m].shape[1]] = pops[m]
        fitness = batched_population_fitness_fn(
            [problems[m] for m in members], weights, engine=engine, device=device
        )
        obj, mk = (x.cpu().numpy() for x in fitness(batch))
        for row, m in enumerate(members):
            P = pops[m].shape[0]
            out[m] = (obj[row, :P], mk[row, :P])
    return out  # type: ignore[return-value]
