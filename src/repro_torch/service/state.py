"""Live continuum state — what the service knows about the shared system.

One :class:`ContinuumState` is the single source of truth behind every
solve the service performs:

* **learned speeds** — a :class:`repro_torch.core.monitor.MonitorState` folds each
  completed submission's observed per-node speeds into the model (Fig. 4
  step 4 → 1), so the *next* problem is built from the refreshed system;
* **ground truth** — per-node true speed multipliers, mutated by trace
  ``node-drift`` events; executions run at ``truth / learned`` residual
  factors exactly like the scenario orchestrator, so once the monitor converges
  observed matches predicted;
* **health** — ``node-failure`` / ``node-recovery`` events flip nodes out
  of / into the feasibility mask of future problems (failed nodes are never
  removed — indices stay stable for the monitor and the cache);
* **reserved windows** — per-node occupancy frontiers from dispatched work,
  accumulated by the shared engine simulator's occupancy fold
  (:func:`repro_torch.engine.sim.accumulate_occupancy`) over the truth execution's
  per-task windows — the frontiers are views over the same simulator state
  that produced the timing, not a second bookkeeping implementation.  A new
  submission landing on a busy node waits for the frontier (one
  deterministic queueing delay per dispatch), which is what turns 200 near
  simultaneous tenants into a meaningful p95 turnaround instead of 200
  independent simulations.

Reservations are *revocable*: each dispatched submission's windows are held
under its id until the work either completes (:meth:`ContinuumState.retire`
folds them into the permanent occupancy base) or is preempted by a node
failure (:meth:`ContinuumState.release` drops the unfinished windows,
keeping only the time the nodes really spent, and reports the lost-work
seconds).  Releasing rebuilds the frontiers from the retained base plus the
surviving live reservations, so a dead node's queue-delay frontier never
keeps inflating with work that was cancelled — and a later ``recover`` does
not resurrect it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.monitor import MonitorState
from repro_torch.core.simulator import ExecutionReport
from repro_torch.core.system_model import System
from repro_torch.core.workload_model import ScheduleProblem
from repro_torch.engine.sim import accumulate_occupancy


@dataclasses.dataclass
class NodeStatus:
    """Snapshot of one node for metrics/logs."""

    name: str
    up: bool
    true_factor: float
    learned_factor: float
    frontier: float
    busy_seconds: float

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


class ContinuumState:
    def __init__(self, system: System, *, smoothing: float = 1.0) -> None:
        self.base_system = system
        self.monitor = MonitorState(smoothing=smoothing)
        self.node_names = [n.name for n in system.nodes]
        self._index = {name: i for i, name in enumerate(self.node_names)}
        self.true_factors = {name: 1.0 for name in self.node_names}
        self.up = {name: True for name in self.node_names}
        # occupancy state, indexed like the problem's node axis; the dict
        # views below are derived from these arrays.  The live arrays are
        # always retired-base ⊕ live reservations, so a release can rebuild
        # them exactly (frontier is a max — it cannot be "subtracted")
        n = len(self.node_names)
        self._frontier = np.zeros(n)
        self._busy = np.zeros(n)
        self._retired_frontier = np.zeros(n)
        self._retired_busy = np.zeros(n)
        #: submission id → (nodes, starts, finishes) of its reserved windows
        self._live: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self.windows = 0  # reserved windows committed so far

    @property
    def frontier(self) -> dict[str, float]:
        """Name-keyed view over the per-node occupancy frontier."""
        return {n: float(self._frontier[i]) for i, n in enumerate(self.node_names)}

    @property
    def busy_seconds(self) -> dict[str, float]:
        return {n: float(self._busy[i]) for i, n in enumerate(self.node_names)}

    # ---- model refresh (Fig. 4 step 1) --------------------------------------
    def effective_system(self) -> System:
        """The system future solves see: base P scaled by learned factors."""
        if not self.monitor.factors:
            return self.base_system
        return self.monitor.refreshed_system(self.base_system)

    def apply_health(self, problem: ScheduleProblem) -> ScheduleProblem:
        """Mask failed nodes out of a freshly built problem's feasibility."""
        down = [self._index[n] for n, ok in self.up.items() if not ok]
        if down:
            problem.feasible[:, down] = False
        return problem

    def residual_factors(self) -> np.ndarray:
        """Speed multipliers the *executor* applies on top of the current
        model: ground truth over learned (1.0 once the monitor converged)."""
        learned = self.monitor.factors
        return np.array(
            [
                self.true_factors[n] / max(learned.get(n, 1.0), 1e-9)
                for n in self.node_names
            ]
        )

    # ---- occupancy ----------------------------------------------------------
    def queue_delay(self, assignment: np.ndarray, now: float) -> float:
        """How long a schedule touching ``assignment``'s nodes must wait for
        the continuum to drain already-reserved work.

        The whole submission shifts by one delay (per-node shifts could break
        cross-node dependency timing), so the bound is the latest frontier
        among the nodes it uses."""
        used = np.unique(assignment)
        latest = float(self._frontier[used].max()) if used.size else now
        return max(0.0, latest - now)

    def reserve(self, report: ExecutionReport, t0: float, sid: str | None = None) -> None:
        """Commit an execution's observed per-task windows (absolute time
        ``t0 + log``) into the node frontiers — one vectorized occupancy
        fold shared with the engine simulator.

        With ``sid`` the windows are held as a *revocable* reservation under
        that submission id (``retire`` on completion, ``release`` on
        preemption); without it they fold permanently."""
        if report.logs:
            nodes = np.array([log.node for log in report.logs], dtype=np.int64)
            starts = t0 + np.array([log.start for log in report.logs])
            finishes = t0 + np.array([log.finish for log in report.logs])
            accumulate_occupancy(self._frontier, self._busy, nodes, starts, finishes)
            if sid is not None:
                self._live[sid] = (nodes, starts, finishes)
            else:
                accumulate_occupancy(
                    self._retired_frontier, self._retired_busy,
                    nodes, starts, finishes,
                )
        self.windows += len(report.logs)

    def retire(self, sid: str) -> None:
        """A reserved submission completed: fold its windows into the
        permanent occupancy base and drop the revocable handle."""
        win = self._live.pop(sid, None)
        if win is not None:
            accumulate_occupancy(self._retired_frontier, self._retired_busy, *win)

    def release(self, sid: str, at: float) -> tuple[float, int]:
        """A reserved submission was preempted at time ``at``: drop its
        unfinished windows and rebuild the frontiers.

        Windows that finished by ``at`` are kept whole (that work really
        happened); windows straddling ``at`` are truncated — the node *was*
        busy until the preemption, but the partial execution is wasted.
        Returns ``(lost_work_seconds, cancelled_windows)``: the busy-seconds
        burned on tasks that will be re-run and how many windows were cut."""
        win = self._live.pop(sid, None)
        if win is None:
            return 0.0, 0
        nodes, starts, finishes = win
        done = finishes <= at
        truncated = np.minimum(finishes, at)
        keep = done | (truncated > starts)
        accumulate_occupancy(
            self._retired_frontier, self._retired_busy,
            nodes[keep], starts[keep], truncated[keep],
        )
        lost = float(np.clip(truncated - starts, 0.0, None)[~done].sum())
        self._rebuild_occupancy()
        return lost, int((~done).sum())

    def _rebuild_occupancy(self) -> None:
        """Recompute the live frontiers: retired base ⊕ live reservations."""
        self._frontier = self._retired_frontier.copy()
        self._busy = self._retired_busy.copy()
        for win in self._live.values():
            accumulate_occupancy(self._frontier, self._busy, *win)

    # ---- feedback + trace events --------------------------------------------
    def baked_factors(self) -> dict[str, float]:
        """Snapshot of the learned factors — capture this when *building* a
        problem so the eventual observation composes against the model that
        actually produced it (other tenants may update the monitor between
        dispatch and completion)."""
        return dict(self.monitor.factors)

    def observe(
        self,
        problem: ScheduleProblem,
        report: ExecutionReport,
        baked: dict[str, float],
    ) -> None:
        """Fold one completed execution's observed speeds into the model."""
        self.monitor.update(self.base_system, problem, report, baked=baked)

    def _known(self, node: str) -> str:
        if node not in self.up:
            raise KeyError(
                f"unknown node {node!r}; system has {sorted(self.up)}"
            )
        return node

    def index_of(self, node: str) -> int:
        """Node-axis index of ``node`` (the problem/report node numbering)."""
        return self._index[self._known(node)]

    def set_drift(self, node: str, factor: float) -> None:
        f = float(factor)
        if not f > 0:  # also catches NaN
            raise ValueError(
                f"drift factor must be > 0, got {factor!r} for node {node!r} "
                "(a stopped node is a node-failure event, not a zero speed)"
            )
        self.true_factors[self._known(node)] = f

    def fail(self, node: str) -> None:
        self.up[self._known(node)] = False

    def recover(self, node: str) -> None:
        self.up[self._known(node)] = True

    # ---- introspection ------------------------------------------------------
    def status(self) -> list[NodeStatus]:
        return [
            NodeStatus(
                name=n,
                up=self.up[n],
                true_factor=self.true_factors[n],
                learned_factor=self.monitor.factors.get(n, 1.0),
                frontier=float(self._frontier[i]),
                busy_seconds=float(self._busy[i]),
            )
            for i, n in enumerate(self.node_names)
        ]
