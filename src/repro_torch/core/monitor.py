"""Monitoring / digital-twin feedback (paper Fig. 4, step 4 → step 1).

"After execution, the monitoring component collects logs and performance
metrics, updating node properties for subsequent runs."  Here: observed
per-node speed factors from :class:`repro_torch.core.simulator.ExecutionReport`
are folded into the ``System``'s node properties with exponential smoothing,
and the refreshed system is what the next solve sees.  On the first run
(no data) the theoretical seed values are used, exactly as §IV-A.1 states.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.simulator import ExecutionReport
from repro_torch.core.system_model import Node, System
from repro_torch.core.workload_model import ScheduleProblem


@dataclasses.dataclass
class MonitorState:
    """Smoothed per-node speed estimates (node name -> multiplier)."""

    smoothing: float = 0.5
    factors: dict[str, float] = dataclasses.field(default_factory=dict)

    def update(
        self,
        system: System,
        problem: ScheduleProblem,
        report: ExecutionReport,
        *,
        baked: dict[str, float] | None = None,
    ) -> None:
        """Fold one execution's observed speeds into the estimates.

        ``observed_speed_factors`` are *relative to the model that produced*
        ``problem``; when that model already carried learned factors (a
        refreshed system inside the orchestrator loop), pass them as
        ``baked`` so the update composes to an absolute multiplier over the
        base system rather than drifting relatively."""
        observed = report.observed_speed_factors(problem)
        for i, f in observed.items():
            name = system.nodes[i].name
            if baked:
                f *= baked.get(name, 1.0)
            prev = self.factors.get(name, 1.0)
            self.factors[name] = (1 - self.smoothing) * prev + self.smoothing * f

    def refreshed_system(self, system: System) -> System:
        """System with properties P scaled by the learned factors."""
        nodes = []
        for n in system.nodes:
            f = self.factors.get(n.name, 1.0)
            props = dict(n.properties)
            props["processing_speed"] = n.processing_speed * f
            nodes.append(
                Node(
                    name=n.name,
                    resources=n.resources,
                    features=n.features,
                    properties=props,
                )
            )
        return System(nodes=tuple(nodes), dtr=system.dtr)
