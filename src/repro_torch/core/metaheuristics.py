"""Meta-heuristic ("MH") techniques from the paper's Table VII — GA, PSO,
SA, ACO — on a device.

Fitness of a population of candidate assignments is the paper's scale
bottleneck (Table IX: GA at 500×500), and it is embarrassingly parallel
across candidates: every generation scores the whole population through the
engine registry (:func:`repro_torch.engine.population_fitness_fn`; on a
CUDA device that is one launch of the makespan kernel).  The generation
loop is plain PyTorch on the device, with no host synchronisation until the
best assignment comes back.

Random draws come from a *draw source*, one protocol per technique
(:class:`GADraws`, :class:`PSODraws`, :class:`SADraws`, :class:`ACODraws`).
The defaults (:class:`TorchDraws`, :class:`TorchPSODraws`, ...) draw from a
``torch.Generator`` on the device; the ``Array*Draws`` replay recorded
draws, which lets a test feed a loop the reference's exact ``jax.random``
streams and hold it to the reference's best assignment and history bit for
bit.

All techniques emit assignments; their canonical timing comes from the
numpy oracle, so every technique is scored under identical semantics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Protocol, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.evaluator import ObjectiveWeights, Schedule, evaluate_assignment
from repro_torch.core.workload_model import ScheduleProblem
# the module, not its names: repro_torch.engine.backends imports this package
# while it initialises, so its functions are looked up at call time
from repro_torch.engine import backends as _backends

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


def _categorical_tables(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cdf, last)`` of the categorical over the last axis of ``logits``:
    sampling inverts the CDF and clamps to the last node of nonzero
    probability, so a masked (infeasible) node is never drawn."""
    probs = torch.softmax(logits.float(), dim=-1)
    nodes = torch.arange(logits.shape[-1], device=logits.device)
    last = torch.where(probs > 0, nodes, 0).amax(dim=-1)
    return torch.cumsum(probs, dim=-1).contiguous(), last


def _invert_cdf(cdf: torch.Tensor, last: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Samples ``k`` with ``cdf[k-1] <= u < cdf[k]``: ``cdf [..., N]``,
    ``last [...]``, uniforms ``u [..., S]`` → ``[..., S]`` int32."""
    idx = torch.searchsorted(cdf, u.contiguous(), right=True)
    return torch.minimum(idx, last[..., None]).to(torch.int32)


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
        self.cdf, self.last = _categorical_tables(logits)  # [B, T, N], [B, T]

    def _rand(self, *shape: int) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)

    def _categorical(self) -> torch.Tensor:
        B, T, _ = self.cdf.shape
        u = self._rand(B, T, self.pop_size)
        return _invert_cdf(self.cdf, self.last, u).transpose(1, 2)  # [B, P, T]

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
    shard: int | str | None = None,
) -> MHResult:
    """Genetic algorithm [24] on ``device`` with fitness from the ``backend``
    engine (``auto``: the CUDA kernel on a CUDA device).  ``draws``
    replaces the default ``torch.Generator`` draws seeded by ``seed``.
    ``shard`` is accepted and ignored, so that solver options meant for the
    batched :func:`ga_sweep` do not fail a single solve of the same family."""
    del shard
    t0 = time.perf_counter()
    fitness = _backends.population_fitness_fn(problem, weights, engine=backend, device=device)
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
    shard: int | str | None = "auto",
) -> list[MHResult]:
    """The GA on a whole family of instances at once: the instances are
    padded into one shape bucket and stacked, and each generation scores
    every instance's population in one batched fitness call.  Per-result
    ``solve_time`` is the sweep's wall time.

    ``shard`` stripes that fitness call over the local devices of
    ``device``'s kind (``"auto"``: all of them, when there is more than one;
    an int forces a count; ``"off"``/``None``/``1`` keeps one device;
    :mod:`repro_torch.engine.shard`).  The loop and its draws stay over the
    ``B`` real instances, so every choice gives the same schedules and
    histories bit for bit."""
    t0 = time.perf_counter()
    B = len(problems)
    fitness = _backends.batched_population_fitness_fn(
        problems, weights, engine=backend, device=device, shard=shard
    )
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
    shards = fitness.shards
    with obs.TRACER.span(
        "mh.ga_sweep", cat="engine",
        args={"instances": B, "shards": shards,
              "bucket": "x".join(str(x) for x in fitness.bucket)},
    ):
        best, hist = _ga_loop(fitness, draws, generations=generations, elite=elite)
        best, hist = best.cpu().numpy(), hist.cpu().numpy()
    obs.METRICS.counter("mh.ga_sweep.instances").inc(B)
    obs.METRICS.gauge("mh.ga_sweep.shards").set(shards)
    return [
        _finish(problem, weights, best[b, : problem.num_tasks].astype(np.int64), "ga", t0, hist[b])
        for b, problem in enumerate(problems)
    ]


# -----------------------------------------------------------------------------
# PSO, SA and ACO: the reference's arithmetic, op for op
# -----------------------------------------------------------------------------
#
# The reference runs each loop as one ``lax.scan``, which XLA compiles with
# its multiply-adds fused (one rounding each).  Where the loop feeds such a
# sum back into its state, the port rounds it the same way through ``_fma``;
# constants are rounded to f32 first, as the reference's weakly typed Python
# scalars are.  ``log`` and ``exp`` are PyTorch's, within one f32 ulp of
# XLA's (tests/test_torch_mh.py states and checks the bound).


def _f32(x: float) -> float:
    return float(np.float32(x))


# ---- PSO — Particle Swarm Optimization [26] (softmax-position decoding) -----


class PSODraws(Protocol):
    """The random draws of one PSO run, in the reference's order
    (``metaheuristics.py`` ``pso``)."""

    def initial(self) -> torch.Tensor:
        """Standard normal positions ``[P, T, N]`` (scaled by 0.1 in the loop)."""
        ...

    def iteration(self, it: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Iteration ``it``'s uniforms ``r1``, ``r2`` ``[P, T, N]`` in [0, 1)."""
        ...


class TorchPSODraws:
    """PSO draws from a ``torch.Generator`` on ``device``."""

    def __init__(self, shape: tuple[int, int, int], *, seed: int, device="cuda") -> None:
        self.shape, self.device = shape, device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)

    def initial(self) -> torch.Tensor:
        return torch.randn(self.shape, generator=self.gen, device=self.device)

    def iteration(self, it: int):
        r1 = torch.rand(self.shape, generator=self.gen, device=self.device)
        return r1, torch.rand(self.shape, generator=self.gen, device=self.device)


class ArrayPSODraws:
    """Replays recorded PSO draws: ``initial [P, T, N]``, ``r1``/``r2``
    ``[I, P, T, N]``."""

    def __init__(self, initial, r1, r2, *, device="cuda") -> None:
        self._initial = torch.as_tensor(np.asarray(initial), device=device).float()
        self.r1 = torch.as_tensor(np.asarray(r1), device=device).float()
        self.r2 = torch.as_tensor(np.asarray(r2), device=device).float()

    def initial(self) -> torch.Tensor:
        return self._initial

    def iteration(self, it: int):
        return self.r1[it], self.r2[it]


def pso(
    problem: ScheduleProblem,
    weights: ObjectiveWeights = ObjectiveWeights(),
    *,
    pop_size: int = 64,
    iterations: int = 60,
    inertia: float = 0.7,
    c1: float = 1.5,
    c2: float = 1.5,
    seed: int = 0,
    backend: str = "auto",
    device="cuda",
    draws: PSODraws | None = None,
) -> MHResult:
    """Discrete particle swarm [26]: each particle is a ``[T, N]`` position
    decoded to the assignment ``argmax(position + feasibility logits)``."""
    t0 = time.perf_counter()
    T, N = problem.num_tasks, problem.num_nodes
    fitness = _backends.population_fitness_fn(problem, weights, engine=backend, device=device)
    logits = _mask_logits(problem, device)
    if draws is None:
        draws = TorchPSODraws((pop_size, T, N), seed=seed, device=device)
    w, k1, k2 = _f32(inertia), _f32(c1), _f32(c2)
    fma = _backends._fma

    def decode(p):
        return torch.argmax(p + logits, dim=-1).to(torch.int32)

    pos = draws.initial() * _f32(0.1)
    vel = torch.zeros_like(pos)
    pbest_obj, _mk = fitness(decode(pos))
    pbest_pos = pos
    g = torch.argmin(pbest_obj)
    gbest_pos, gbest_obj = pos[g], pbest_obj[g]
    history = []
    for it in range(iterations):
        r1, r2 = draws.iteration(it)
        # XLA's tree: fma(c2·r2, gbest − pos, fma(w, vel, (c1·r1)·(pbest − pos)))
        vel = fma(k2 * r2, gbest_pos[None] - pos, fma(w, vel, (k1 * r1) * (pbest_pos - pos)))
        pos = pos + vel
        obj, _mk = fitness(decode(pos))
        improved = obj < pbest_obj
        pbest_pos = torch.where(improved[:, None, None], pos, pbest_pos)
        pbest_obj = torch.where(improved, obj, pbest_obj)
        gi = torch.argmin(pbest_obj)
        gbest_pos = torch.where(pbest_obj[gi] < gbest_obj, pbest_pos[gi], gbest_pos)
        gbest_obj = torch.minimum(pbest_obj[gi], gbest_obj)
        history.append(gbest_obj)
    best = decode(gbest_pos[None])[0]
    hist = torch.stack(history) if history else logits.new_zeros(0)
    return _finish(
        problem, weights, best.cpu().numpy().astype(np.int64), "pso", t0, hist.cpu().numpy()
    )


# ---- SA — Simulated Annealing [20] (independent chains) ---------------------


class SADraws(Protocol):
    """The random draws of one SA run, in the reference's order
    (``metaheuristics.py`` ``sa``)."""

    def initial(self) -> torch.Tensor:
        """Initial states ``[C, T]``: a categorical sample per task."""
        ...

    def step(self, it: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Step ``it``: the task each chain moves ``[C]`` in ``[0, T)``, its
        new node ``[C]`` (a categorical sample of that task's row) and the
        acceptance uniform ``[C]``."""
        ...


class TorchSADraws:
    """SA draws from a ``torch.Generator`` on the logits' device."""

    def __init__(self, logits: torch.Tensor, *, chains: int, seed: int) -> None:
        self.chains, self.device = chains, logits.device
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.cdf, self.last = _categorical_tables(logits)  # [T, N], [T]

    def _rand(self, *shape: int) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)

    def initial(self) -> torch.Tensor:
        T = self.cdf.shape[0]
        return _invert_cdf(self.cdf, self.last, self._rand(T, self.chains)).T

    def step(self, it: int):
        T = self.cdf.shape[0]
        tsel = torch.randint(0, T, (self.chains,), generator=self.gen, device=self.device)
        newnode = _invert_cdf(self.cdf[tsel], self.last[tsel], self._rand(self.chains, 1))[:, 0]
        return tsel, newnode, self._rand(self.chains)


class ArraySADraws:
    """Replays recorded SA draws: ``initial [C, T]``; ``tsel``,
    ``newnode``, ``uniform`` ``[S, C]``."""

    def __init__(self, initial, tsel, newnode, uniform, *, device="cuda") -> None:
        self._initial = torch.as_tensor(np.asarray(initial), device=device).to(torch.int32)
        self.tsel = torch.as_tensor(np.asarray(tsel), device=device).long()
        self.newnode = torch.as_tensor(np.asarray(newnode), device=device).to(torch.int32)
        self.uniform = torch.as_tensor(np.asarray(uniform), device=device).float()

    def initial(self) -> torch.Tensor:
        return self._initial

    def step(self, it: int):
        return self.tsel[it], self.newnode[it], self.uniform[it]


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the middle value, or the mean of the two middle
    values of an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(x, stable=True).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) / 2


def _cooling_factor(cooling: float, it: int) -> float:
    """``cooling**it`` in f32 as the reference's XLA ``pow`` gives it:
    correctly rounded, so computed in f64 on the host and rounded once."""
    return float(np.float32(np.float64(np.float32(cooling)) ** it))


def sa(
    problem: ScheduleProblem,
    weights: ObjectiveWeights = ObjectiveWeights(),
    *,
    chains: int = 32,
    steps: int = 200,
    t_initial: float | None = None,
    cooling: float = 0.97,
    seed: int = 0,
    backend: str = "auto",
    device="cuda",
    draws: SADraws | None = None,
) -> MHResult:
    """Simulated annealing [20] over independent chains; each step moves one
    task per chain to a fresh feasible node and accepts by Metropolis."""
    t0 = time.perf_counter()
    fitness = _backends.population_fitness_fn(problem, weights, engine=backend, device=device)
    logits = _mask_logits(problem, device)
    if draws is None:
        draws = TorchSADraws(logits, chains=chains, seed=seed)
    state = draws.initial().to(torch.int32)
    C = state.shape[0]
    rows = torch.arange(C, device=state.device)
    obj, _mk = fitness(state)
    if t_initial is not None:
        temp0 = torch.tensor(_f32(t_initial), device=obj.device)
    else:
        temp0 = _median(obj) * _f32(0.05) + _f32(1e-6)
    best_state, best_obj = state, obj
    history = []
    for it in range(steps):
        temp = temp0 * _cooling_factor(cooling, it)
        tsel, newnode, u = draws.step(it)
        prop = state.clone()
        prop[rows, tsel] = newnode.to(torch.int32)
        pobj, _mk = fitness(prop)
        accept = (pobj <= obj) | (u < torch.exp(-(pobj - obj) / torch.clamp(temp, min=_f32(1e-9))))
        state = torch.where(accept[:, None], prop, state)
        obj = torch.where(accept, pobj, obj)
        better = obj < best_obj
        best_state = torch.where(better[:, None], state, best_state)
        best_obj = torch.where(better, obj, best_obj)
        history.append(best_obj.amin())
    best = best_state[torch.argmin(best_obj)]
    hist = torch.stack(history) if history else obj.new_zeros(0)
    return _finish(
        problem, weights, best.cpu().numpy().astype(np.int64), "sa", t0, hist.cpu().numpy()
    )


# ---- ACO — Ant Colony Optimization [29] -------------------------------------


class ACODraws(Protocol):
    """The random draws of one ACO run.  The reference samples each ant's
    nodes as ``categorical(key, logits)``, which is ``argmax(gumbel +
    logits)``; its logits follow the pheromone state, so the draw is the
    Gumbel noise, not the node indices."""

    def iteration(self, it: int) -> torch.Tensor:
        """Iteration ``it``'s standard Gumbel noise ``[ants, T, N]``."""
        ...


class TorchACODraws:
    """Gumbel noise ``-log(E)``, ``E ~ Exp(1)``, from a ``torch.Generator``."""

    def __init__(self, shape: tuple[int, int, int], *, seed: int, device="cuda") -> None:
        self.shape, self.device = shape, device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)

    def iteration(self, it: int) -> torch.Tensor:
        e = torch.empty(self.shape, device=self.device).exponential_(generator=self.gen)
        return -torch.log(e)


class ArrayACODraws:
    """Replays recorded Gumbel noise ``[I, ants, T, N]``."""

    def __init__(self, gumbel, *, device="cuda") -> None:
        self.gumbel = torch.as_tensor(np.asarray(gumbel), device=device).float()

    def iteration(self, it: int) -> torch.Tensor:
        return self.gumbel[it]


def aco(
    problem: ScheduleProblem,
    weights: ObjectiveWeights = ObjectiveWeights(),
    *,
    ants: int = 48,
    iterations: int = 60,
    alpha: float = 1.0,
    beta: float = 1.0,
    rho: float = 0.15,
    seed: int = 0,
    backend: str = "auto",
    device="cuda",
    draws: ACODraws | None = None,
) -> MHResult:
    """Ant colony optimisation [29]: ants sample nodes from pheromone ×
    desirability ``η = 1 / d_ij``; the best-so-far trail gets the deposit."""
    t0 = time.perf_counter()
    T, N = problem.num_tasks, problem.num_nodes
    fitness = _backends.population_fitness_fn(problem, weights, engine=backend, device=device)
    logits = _mask_logits(problem, device)
    # η in float64 on the host, cast to f32 at the same point as the reference
    eta = 1.0 / np.maximum(problem.durations, 1e-9)
    eta = torch.from_numpy(eta / eta.max()).to(device=device, dtype=torch.float32)
    if draws is None:
        draws = TorchACODraws((ants, T, N), seed=seed, device=device)
    a, b = _f32(alpha), _f32(beta)
    keep, r, tiny = _f32(1 - rho), _f32(rho), _f32(1e-12)
    fma = _backends._fma
    log_eta = torch.log(eta + tiny)
    tau = torch.ones(T, N, device=logits.device)
    best_a = torch.zeros(T, dtype=torch.int32, device=logits.device)
    best_obj = torch.tensor(np.inf, dtype=torch.float32, device=logits.device)
    history = []
    for it in range(iterations):
        # XLA's tree: fma(α, log τ, β·log η) + mask logits
        sample_logits = fma(a, torch.log(tau + tiny), b * log_eta) + logits
        pop = torch.argmax(draws.iteration(it) + sample_logits, dim=-1).to(torch.int32)
        obj, _mk = fitness(pop)
        bi = torch.argmin(obj)
        best_a = torch.where(obj[bi] < best_obj, pop[bi], best_a)
        best_obj = torch.minimum(obj[bi], best_obj)
        # evaporation + elite deposit: fma(ρ·onehot, 1 + 1/(1e-9 + best), (1−ρ)·τ)
        onehot = torch.nn.functional.one_hot(best_a.long(), N).to(torch.float32)
        deposit = 1.0 + 1.0 / (_f32(1e-9) + best_obj)
        tau = fma(r * onehot, deposit.expand(T, N), keep * tau)
        history.append(best_obj)
    hist = torch.stack(history) if history else tau.new_zeros(0)
    return _finish(
        problem, weights, best_a.cpu().numpy().astype(np.int64), "aco", t0, hist.cpu().numpy()
    )


TECHNIQUES: dict[str, Callable[..., MHResult]] = {"ga": ga, "pso": pso, "sa": sa, "aco": aco}
