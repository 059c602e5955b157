"""The incremental core-state simulator (paper Eq. 4–6, 12) on the host.

* :class:`CoreSim` — per-node core-free times kept sorted ascending, so "the
  earliest time c cores are free" is a row lookup and a commit is an
  O(CMAX) merge-insert (:func:`commit_sorted`);
* :func:`ready_times_all` — task j's ready time on every node at once
  (Eq. 12 with the Eq. 5 data-migration term), in f32 reciprocal rates;
* :func:`run_schedule` — the list-scheduling replay of a fixed assignment.
  With ``dtype=float32`` its arithmetic order is that of the makespan kernel
  and its plain version, bit for bit; with ``float64`` it is the oracle;
* :func:`accumulate_occupancy` — the per-node occupancy fold behind the
  service's node frontiers.

Plain numpy, as in the reference: the oracle re-scores one schedule, which
is a sequential walk with nothing to batch.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.workload_model import ScheduleProblem

_INF = 1e30  # finite stand-in for +inf (matches the device evaluators)


def commit_sorted(row: np.ndarray, c: int, fill) -> np.ndarray:
    """Replace the ``c`` smallest entries of an ascending ``row`` with
    ``fill`` (≥ row[c-1] by construction) and return it still sorted."""
    rest = row[c:]
    pos = int(np.searchsorted(rest, fill))
    merged = np.empty_like(row)
    merged[:pos] = rest[:pos]
    merged[pos : pos + c] = fill
    merged[pos + c :] = rest[pos:]
    return merged


class CoreSim:
    """Per-node core-free-time state, every row sorted ascending.

    * ``exact=True`` — one ragged row per node sized to its true capacity
      (``max(cap, 1)``): the oracle's flavour, used by :func:`run_schedule`;
    * ``exact=False`` — a dense ``[N, CMAX]`` matrix (+INF padding, CMAX
      capped at 512 like the device evaluators) with the vectorised
      all-nodes lookup :meth:`kth_free_all` that list heuristics scan."""

    def __init__(self, problem: ScheduleProblem, *, dtype=np.float64, exact: bool = False) -> None:
        caps = problem.node_cores.astype(np.int64)
        self.caps = caps
        self.exact = exact
        if exact:
            self.cmax = int(max(caps.max(initial=1), problem.cores.max(initial=1), 1))
            self.width = np.maximum(caps, 1)
            self._rows = [np.zeros(max(int(c), 1), dtype=dtype) for c in caps]
        else:
            widest = int(min(caps.max(initial=1), 512))
            self.cmax = int(max(widest, problem.cores.max(initial=1), 1))
            self.width = np.minimum(np.maximum(caps, 1), self.cmax)
            self.free = np.full((problem.num_nodes, self.cmax), _INF, dtype=dtype)
            for i, c in enumerate(caps):
                self.free[i, : min(int(c), self.cmax)] = 0.0
            self._node_idx = np.arange(problem.num_nodes)

    def kth_free_all(self, c: np.ndarray) -> np.ndarray:
        """Earliest time each node has ``c_i`` cores free (dense mode only)."""
        idx = np.clip(c - 1, 0, self.cmax - 1)
        return self.free[self._node_idx, idx]

    def kth_free(self, i: int, c: int) -> float:
        """Earliest time node ``i`` has ``c`` cores free (``c`` clamped to the
        node's modelled width)."""
        if self.exact:
            row = self._rows[i]
            return row[max(1, min(c, row.size)) - 1]
        c = max(1, min(c, int(self.width[i])))
        return self.free[i, c - 1]

    def commit(self, i: int, c: int, finish) -> None:
        if self.exact:
            row = self._rows[i]
            self._rows[i] = commit_sorted(row, max(1, min(c, row.size)), finish)
        else:
            c = max(1, min(c, self.cmax))
            self.free[i] = commit_sorted(self.free[i], c, finish)


def ready_times_all(
    problem: ScheduleProblem,
    j: int,
    assignment: np.ndarray,
    finish: np.ndarray,
) -> np.ndarray:
    """Ready time of task j on every node ([N]), Eq. (12) with Eq. (5), as
    one multiply-add-max over the CSR predecessor slice."""
    N = problem.num_nodes
    indptr, indices = problem.pred_csr
    ps = indices[indptr[j] : indptr[j + 1]]
    ready = np.full(N, problem.release[j], dtype=np.float64)
    if ps.size == 0:
        return ready
    ips = assignment[ps]
    cand = problem.data[ps, None].astype(np.float32) * problem.transfer_factor[ips]
    if problem.transfer_penalty is not None:
        cand += problem.transfer_penalty[ips]
    cand += finish[ps, None].astype(np.float32)
    return np.maximum(ready, cand.max(axis=0))


def run_schedule(
    problem: ScheduleProblem,
    assignment: np.ndarray,
    *,
    dtype=np.float64,
    speed_factors: np.ndarray | None = None,
    jitter_mults: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Replay a fixed task→node assignment under capacity-aware,
    core-granular list scheduling; returns ``(start, finish, violations)``.

    ``speed_factors[i]`` multiplies node i's throughput and
    ``jitter_mults[j]`` task j's duration (the executor's perturbation
    model); without them this is the oracle timing."""
    assignment = np.asarray(assignment, dtype=np.int64)
    T = problem.num_tasks
    caps = problem.node_cores.astype(np.int64)
    durations = problem.durations
    if speed_factors is not None:
        factors = np.asarray(speed_factors)
        if np.any(factors != 1.0):
            durations = durations / np.maximum(factors, 1e-9)[None, :]
    durations = durations.astype(dtype, copy=False)
    data = problem.data.astype(dtype, copy=False)
    release = problem.release.astype(dtype, copy=False)
    dtr = problem.dtr.astype(dtype, copy=False)
    indptr, indices = problem.pred_csr
    sim = CoreSim(problem, dtype=dtype, exact=True)
    start = np.zeros(T, dtype=dtype)
    finish = np.zeros(T, dtype=dtype)
    inf = dtype(_INF) if dtype is not np.float64 else _INF
    violations = 0

    for j in range(T):
        i = int(assignment[j])
        if not problem.feasible[j, i]:
            violations += 1
        ready = release[j]
        lo, hi = indptr[j], indptr[j + 1]
        if hi > lo:
            ps = indices[lo:hi]
            ips = assignment[ps]
            rates = dtr[ips, i]
            ok = np.isfinite(rates) & (rates > 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                transfer = np.where(
                    ips == i, dtype(0.0), np.where(ok, data[ps] / np.where(ok, rates, 1), inf)
                )
            ready = np.maximum(ready, (finish[ps] + transfer).max())
        c = int(max(1, min(problem.cores[j], caps[i])))
        kth = sim.kth_free(i, c)
        s = np.maximum(ready, kth)
        dur = durations[j, i]
        if jitter_mults is not None:
            dur = dur * jitter_mults[j]
        f = s + dur
        sim.commit(i, c, f)
        start[j], finish[j] = s, f
    return start, finish, violations


def accumulate_occupancy(
    frontier: np.ndarray,
    busy: np.ndarray,
    nodes: np.ndarray,
    starts: np.ndarray,
    finishes: np.ndarray,
) -> None:
    """Fold one execution's per-task windows into per-node occupancy state
    in place: ``frontier[i]`` becomes the latest finish seen on node i,
    ``busy[i]`` accumulates busy seconds.  The service's occupancy frontiers
    are views over this (no second bookkeeping implementation)."""
    np.maximum.at(frontier, nodes, finishes)
    np.add.at(busy, nodes, finishes - starts)
