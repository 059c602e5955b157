"""Meta-heuristic ("MH") techniques from the paper's Table VII, on a device.

Fitness of a population of candidate assignments is the paper's scale
bottleneck (Table IX: GA at 500×500), and it is embarrassingly parallel
across candidates: every generation scores the whole population through the
engine registry (:func:`repro_torch.engine.population_fitness_fn`; on a
CUDA device that is one launch of the makespan kernel).  The generation
loop is plain PyTorch on the device, with no host synchronisation until the
best assignment comes back.

Random draws come from a *draw source* (:class:`GADraws`).  The default,
:class:`TorchDraws`, draws from a ``torch.Generator`` on the device;
:class:`ArrayDraws` replays recorded draws, which lets a test feed the loop
the reference's exact ``jax.random`` streams and hold it to the reference's
best assignment and history bit for bit.

All techniques emit assignments; their canonical timing comes from the
numpy oracle, so every technique is scored under identical semantics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Protocol, Sequence

import numpy as np
import torch

from repro_torch.core.evaluator import ObjectiveWeights, Schedule, evaluate_assignment
from repro_torch.core.workload_model import ScheduleProblem
from repro_torch.engine.backends import batched_population_fitness_fn, population_fitness_fn

_NEG = -1e30


@dataclasses.dataclass
class MHResult:
    schedule: Schedule
    history: np.ndarray  # best objective per generation


class GADraws(Protocol):
    """The random draws of one GA run over a family of ``B`` instances,
    in the reference's order (``metaheuristics.py`` ``_ga_loop``)."""

    def initial(self) -> torch.Tensor:
        """Initial population ``[B, P, T]``: a categorical sample per task."""
        ...

    def generation(self, g: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Generation ``g``'s draws: tournament candidates ``[B, 2, P, K]`` in
        ``[0, P)``, the crossover mask ``[B, P, T]`` (take parent a where
        true), the mutation mask ``[B, P, T]`` and fresh categorical samples
        ``[B, P, T]``."""
        ...


class TorchDraws:
    """Draws from a ``torch.Generator`` on the logits' device.  Categorical
    samples invert each task's CDF, so a task never draws a node of
    probability 0 (a masked, infeasible node)."""

    def __init__(
        self,
        logits: torch.Tensor,  # [B, T, N]
        *,
        pop_size: int,
        tournament: int,
        mutation_rate: float,
        seed: int,
    ) -> None:
        self.pop_size, self.tournament, self.mutation_rate = pop_size, tournament, mutation_rate
        self.device = logits.device
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        probs = torch.softmax(logits.float(), dim=-1)
        self.cdf = torch.cumsum(probs, dim=-1).contiguous()  # [B, T, N]
        nodes = torch.arange(logits.shape[-1], device=self.device)
        self.last = torch.where(probs > 0, nodes, 0).amax(dim=-1, keepdim=True)  # [B, T, 1]

    def _rand(self, *shape: int) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)

    def _categorical(self) -> torch.Tensor:
        B, T, _ = self.cdf.shape
        u = self._rand(B, T, self.pop_size)
        idx = torch.searchsorted(self.cdf, u, right=True)  # [B, T, P]
        return torch.minimum(idx, self.last).transpose(1, 2).to(torch.int32)

    def initial(self) -> torch.Tensor:
        return self._categorical()

    def generation(self, g: int):
        B, T, _ = self.cdf.shape
        P = self.pop_size
        cand = torch.randint(
            0, P, (B, 2, P, self.tournament), generator=self.gen, device=self.device
        )
        xmask = self._rand(B, P, T) < 0.5
        mmask = self._rand(B, P, T) < self.mutation_rate
        return cand, xmask, mmask, self._categorical()


class ArrayDraws:
    """Replays recorded draws: ``initial [B, P, T]`` and, per generation on
    axis 1, ``cand [B, G, 2, P, K]``, ``xmask``/``mmask``/``fresh [B, G, P, T]``."""

    def __init__(self, initial, cand, xmask, mmask, fresh, *, device="cuda") -> None:
        self._initial = torch.as_tensor(np.asarray(initial), device=device).to(torch.int32)
        self.cand = torch.as_tensor(np.asarray(cand), device=device).long()
        self.xmask = torch.as_tensor(np.asarray(xmask), device=device).bool()
        self.mmask = torch.as_tensor(np.asarray(mmask), device=device).bool()
        self.fresh = torch.as_tensor(np.asarray(fresh), device=device).to(torch.int32)

    def initial(self) -> torch.Tensor:
        return self._initial

    def generation(self, g: int):
        return self.cand[:, g], self.xmask[:, g], self.mmask[:, g], self.fresh[:, g]


def _safe_feasible(problem: ScheduleProblem) -> np.ndarray:
    """Feasibility mask with at least one samplable node per task, even an
    infeasible one (the fitness penalty then makes the candidate die off)."""
    safe = problem.feasible.copy()
    dead = ~safe.any(axis=1)
    if dead.any():
        safe[dead, 0] = True
    return safe


def _mask_logits(problem: ScheduleProblem, device="cuda") -> torch.Tensor:
    """[T, N] f32 logits: 0 on samplable nodes, -1e30 elsewhere."""
    safe = torch.from_numpy(_safe_feasible(problem)).to(device)
    return torch.where(safe, 0.0, _NEG).to(torch.float32)


def _finish(
    problem: ScheduleProblem,
    weights: ObjectiveWeights,
    best_assignment: np.ndarray,
    technique: str,
    t0: float,
    history: np.ndarray,
) -> MHResult:
    sched = evaluate_assignment(problem, best_assignment, weights, technique=technique)
    sched.solve_time = time.perf_counter() - t0
    return MHResult(schedule=sched, history=history)


def _ga_loop(
    fitness: Callable,
    draws: GADraws,
    *,
    generations: int,
    elite: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """GA generation loop over a family of ``B`` instances on the draws'
    device → ``(best assignment [B, T], history [B, G])``.

    ``fitness(pop [B, P, T]) -> (objective [B, P], makespan [B, P])``.  The
    draw source holds everything random, and with it the sampling logits,
    the population and tournament sizes and the mutation rate.  Ties break
    as in the reference: stable argsort for the elites, first-index argmin
    for tournaments and the final pick.  Nothing here waits for the device."""
    pop = draws.initial().to(torch.int32)
    B = pop.shape[0]
    bi = torch.arange(B, device=pop.device)[:, None]
    history = []
    for g in range(generations):
        obj, _mk = fitness(pop)  # [B, P]
        cand, xmask, mmask, fresh = draws.generation(g)
        elites = pop[bi, torch.argsort(obj, dim=-1, stable=True)[:, :elite]]  # [B, E, T]
        # tournament selection: two parents per child
        cand_obj = torch.gather(obj, 1, cand.reshape(B, -1)).reshape(cand.shape)
        winners = torch.gather(cand, 3, cand_obj.argmin(dim=-1, keepdim=True))[..., 0]  # [B, 2, P]
        child = torch.where(xmask, pop[bi, winners[:, 0]], pop[bi, winners[:, 1]])  # uniform crossover
        child = torch.where(mmask, fresh.to(torch.int32), child)  # mutation
        child[:, :elite] = elites
        history.append(obj.amin(dim=-1))
        pop = child
    obj, _mk = fitness(pop)
    best = pop[bi[:, 0], obj.argmin(dim=-1)]
    hist = torch.stack(history, dim=-1) if history else obj.new_zeros(B, 0)
    return best, hist


def ga(
    problem: ScheduleProblem,
    weights: ObjectiveWeights = ObjectiveWeights(),
    *,
    pop_size: int = 64,
    generations: int = 60,
    tournament: int = 4,
    mutation_rate: float = 0.08,
    elite: int = 2,
    seed: int = 0,
    backend: str = "auto",
    device="cuda",
    draws: GADraws | None = None,
) -> MHResult:
    """Genetic algorithm [24] on ``device`` with fitness from the ``backend``
    engine (``auto``: the CUDA kernel on a CUDA device).  ``draws``
    replaces the default ``torch.Generator`` draws seeded by ``seed``."""
    t0 = time.perf_counter()
    fitness = population_fitness_fn(problem, weights, engine=backend, device=device)
    logits = _mask_logits(problem, device)[None]
    if draws is None:
        draws = TorchDraws(
            logits, pop_size=pop_size, tournament=tournament,
            mutation_rate=mutation_rate, seed=seed,
        )

    def family_of_one(pop):
        obj, mk = fitness(pop[0])
        return obj[None], mk[None]

    best, hist = _ga_loop(family_of_one, draws, generations=generations, elite=elite)
    return _finish(
        problem, weights, best[0].cpu().numpy().astype(np.int64), "ga", t0, hist[0].cpu().numpy()
    )


def ga_sweep(
    problems: Sequence[ScheduleProblem],
    weights: ObjectiveWeights = ObjectiveWeights(),
    *,
    pop_size: int = 64,
    generations: int = 60,
    tournament: int = 4,
    mutation_rate: float = 0.08,
    elite: int = 2,
    seed: int = 0,
    backend: str = "auto",
    device="cuda",
    draws: GADraws | None = None,
) -> list[MHResult]:
    """The GA on a whole family of instances at once: the instances are
    padded into one shape bucket and stacked, and each generation scores
    every instance's population in one batched fitness call.  Per-result
    ``solve_time`` is the sweep's wall time."""
    t0 = time.perf_counter()
    B = len(problems)
    fitness = batched_population_fitness_fn(problems, weights, engine=backend, device=device)
    Tb, Nb = fitness.bucket[:2]
    logits = np.full((B, Tb, Nb), _NEG, dtype=np.float32)
    for b, problem in enumerate(problems):
        logits[b, : problem.num_tasks, : problem.num_nodes][_safe_feasible(problem)] = 0.0
        logits[b, problem.num_tasks :, 0] = 0.0  # padded tasks pin to node 0
    logits_t = torch.from_numpy(logits).to(device)
    if draws is None:
        draws = TorchDraws(
            logits_t, pop_size=pop_size, tournament=tournament,
            mutation_rate=mutation_rate, seed=seed,
        )
    best, hist = _ga_loop(fitness, draws, generations=generations, elite=elite)
    best, hist = best.cpu().numpy(), hist.cpu().numpy()
    return [
        _finish(problem, weights, best[b, : problem.num_tasks].astype(np.int64), "ga", t0, hist[b])
        for b, problem in enumerate(problems)
    ]

