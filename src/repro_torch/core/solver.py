"""Deprecated shim — the solver surface moved to :mod:`repro_torch.core.api`.

The old free-function entry points (``solve``, ``solve_problem``,
``solve_problems``, ``compare_techniques``) and :class:`SolveReport` remain
importable from here, but they are the *same objects* as the scenario-first
API in ``repro_torch.core.api``; new code should import from there (or use
:class:`repro_torch.core.api.Scenario` +
:class:`repro_torch.core.api.Orchestrator` for the full Fig. 4 loop).

Techniques live in ``repro_torch.core.api.REGISTRY`` (a
:class:`~repro_torch.core.api.SolverRegistry`), and the ``technique="auto"``
hybrid is the data-driven ``repro_torch.core.api.Policy.paper_hybrid()``
rule chain.
"""

from __future__ import annotations

import warnings

from repro_torch.core import api as _api

_SHIMMED = (
    "SolveReport",
    "solve",
    "solve_problem",
    "solve_problems",
    "compare_techniques",
    "ALL_TECHNIQUES",
)

__all__ = list(_SHIMMED)


def __getattr__(name: str):
    if name == "ALL_TECHNIQUES":
        # live view: plugins registered after import are included
        return _api.REGISTRY.names()
    if name in _SHIMMED:
        warnings.warn(
            f"repro_torch.core.solver.{name} is deprecated; import it from "
            "repro_torch.core.api (or use the Scenario/Orchestrator surface)",
            DeprecationWarning,
            stacklevel=2,
        )
        return getattr(_api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SHIMMED))
