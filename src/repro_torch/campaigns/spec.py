"""Declarative multi-scenario campaigns (the paper's comparative evaluation
as data).

A :class:`Campaign` is a named grid over experiment axes — workflow family /
size / seed, technique, evaluation engine, :class:`ObjectiveWeights`,
perturbation — plus per-axis defaults and include / exclude / skip filters.
:meth:`Campaign.expand` turns it into a deterministic list of
:class:`CampaignCell` coordinates (first axis outermost, values in listed
order, indices assigned after filtering), and :func:`cell_scenario` compiles
any cell into a :class:`~repro_torch.core.api.Scenario` — so one spec file
expresses "run this grid and compare" the way SPEC-RG frames continuum
benchmarking: systematic sweeps over application × infrastructure × policy.

Axes
----
* A **scalar axis** contributes one coordinate per value::

      {"name": "technique", "values": ["milp", "heft", "olb", "ga"]}

* A **zipped axis** (``"zip": true``) takes mapping values whose keys are
  merged into the cell's coordinates together — correlated coordinates that
  must move in lockstep (the Table IX square ``nodes × tasks`` scaling)::

      {"name": "scale", "zip": true,
       "values": [{"size": 5, "nodes": 5, "seed": 5},
                  {"size": 50, "nodes": 50, "seed": 50}]}

* Structured coordinates (``weights``, ``perturbation``, ``solver_options``,
  ``orchestration``) are plain JSON dicts in the spec and are compiled into
  their typed objects per cell.

Filters
-------
A *matcher* is a mapping of coordinate → condition, where a condition is a
scalar (equality), a list (membership) or ``{"min": x, "max": y}`` (numeric
range).  ``include`` keeps only matching cells (empty = keep all),
``exclude`` drops matching cells entirely, and ``skip`` rules keep the cell
in the expansion but mark it not-to-be-solved with a reason — reproducing
the paper's '-' table entries (e.g. MILP above its size ceiling) without
losing the cell's coordinates from the result grid.

Everything round-trips through JSON (``Campaign.to_json`` /
:func:`campaign_from_json`), with unknown keys rejected with a did-you-mean
error — a typo'd ``"tehcniques"`` axis never silently falls back to a
default grid.

The spec format is the reference's, file for file.  A ``"system":
"topology"`` cell takes a generated tiered continuum
(:mod:`repro_torch.topology`) from its ``topology`` coordinate.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core.api import (
    OrchestrationConfig,
    Perturbation,
    Policy,
    Scenario,
    _weights_from_json,
    cycle_spec_from_json,
    did_you_mean,
    reject_unknown_keys,
)
from repro_torch.core.system_model import System, mri_system, synthetic_system
from repro_torch.core.workload_model import (
    Workload,
    constraints_from_json,
    mri_w1,
    mri_w2,
    mri_workload,
    random_layered_workflow,
    stgs_workflows,
    synthetic_workload,
)

# ---------------------------------------------------------------------------
# Axes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Axis:
    """One named experiment dimension.

    ``zipped`` axes take mapping values that are merged into the cell's
    coordinates as a unit (correlated coordinates); scalar axes contribute
    ``coords[name] = value``."""

    name: str
    values: tuple[Any, ...]
    zipped: bool = False

    def __post_init__(self) -> None:
        if not self.values:
            raise ValueError(f"axis {self.name!r} has no values")
        if self.zipped:
            bad = [v for v in self.values if not isinstance(v, Mapping)]
            if bad:
                raise ValueError(
                    f"zipped axis {self.name!r} requires mapping values; "
                    f"got {bad[0]!r}"
                )

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"name": self.name, "values": list(self.values)}
        if self.zipped:
            out["zip"] = True
        return out

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "Axis":
        reject_unknown_keys(obj, ("name", "values", "zip"), context="campaign axis")
        return cls(
            name=obj["name"],
            values=tuple(obj["values"]),
            zipped=bool(obj.get("zip", False)),
        )


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------


def matches(where: Mapping[str, Any], coords: Mapping[str, Any]) -> bool:
    """Does a cell's coordinate mapping satisfy a matcher?

    Conditions: scalar = equality, list = membership, ``{"min"/"max"}`` =
    inclusive numeric range.  A coordinate the cell does not have never
    matches."""
    for key, cond in where.items():
        if key not in coords:
            return False
        val = coords[key]
        if isinstance(cond, Mapping):
            reject_unknown_keys(cond, ("min", "max"), context="range condition")
            if not isinstance(val, (int, float)) or isinstance(val, bool):
                return False
            if "min" in cond and val < cond["min"]:
                return False
            if "max" in cond and val > cond["max"]:
                return False
        elif isinstance(cond, (list, tuple, set, frozenset)):
            if val not in cond:
                return False
        elif val != cond:
            return False
    return True


@dataclasses.dataclass(frozen=True)
class SkipRule:
    """Keep matching cells in the grid but do not solve them."""

    where: Mapping[str, Any]
    reason: str = "filtered"

    def to_json(self) -> dict[str, Any]:
        return {"where": dict(self.where), "reason": self.reason}

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "SkipRule":
        reject_unknown_keys(obj, ("where", "reason"), context="campaign skip rule")
        return cls(where=dict(obj["where"]), reason=str(obj.get("reason", "filtered")))


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CampaignCell:
    """One point of the expanded grid: stable index + coordinate mapping.

    ``skipped`` carries the skip-rule reason (``None`` = solve it)."""

    index: int
    coords: Mapping[str, Any]
    skipped: str | None = None

    def label(self) -> str:
        parts = []
        for k, v in self.coords.items():
            if isinstance(v, Mapping):
                continue  # structured coords are noise in a one-line label
            parts.append(f"{k}={v}")
        return ";".join(parts)


# ---------------------------------------------------------------------------
# Campaign
# ---------------------------------------------------------------------------

_CAMPAIGN_KEYS = (
    "name",
    "axes",
    "defaults",
    "include",
    "exclude",
    "skip",
    "runner",
    "runner_options",
)


@dataclasses.dataclass(frozen=True)
class Campaign:
    """A declarative multi-scenario experiment: axes × defaults × filters,
    executed by a named runner (:mod:`repro_torch.campaigns.runner`)."""

    name: str
    axes: tuple[Axis, ...] = ()
    defaults: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    include: tuple[Mapping[str, Any], ...] = ()
    exclude: tuple[Mapping[str, Any], ...] = ()
    skip: tuple[SkipRule, ...] = ()
    runner: str = "inline"
    runner_options: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        # accept the JSON spec shape directly (dicts/lists for axes and
        # skip rules) so the documented literal syntax works in Python too
        object.__setattr__(
            self,
            "axes",
            tuple(a if isinstance(a, Axis) else Axis.from_json(a) for a in self.axes),
        )
        object.__setattr__(
            self,
            "skip",
            tuple(
                r if isinstance(r, SkipRule) else SkipRule.from_json(r)
                for r in self.skip
            ),
        )
        object.__setattr__(self, "include", tuple(dict(m) for m in self.include))
        object.__setattr__(self, "exclude", tuple(dict(m) for m in self.exclude))
        names = [a.name for a in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis names in {names}")
        # no two axes may write the same coordinate — a zipped axis's value
        # keys clobbering another axis would yield a silently wrong grid
        owned: dict[str, str] = {}
        for ax in self.axes:
            keys = (
                {k for v in ax.values for k in v} if ax.zipped else {ax.name}
            )
            for k in keys:
                if k in owned:
                    raise ValueError(
                        f"coordinate {k!r} is set by both axis "
                        f"{owned[k]!r} and axis {ax.name!r}"
                    )
                owned[k] = ax.name

    # ---- expansion ----------------------------------------------------------
    def expand(self) -> list[CampaignCell]:
        """Deterministic cell list: product of axes in listed order (first
        axis outermost), defaults filled in, include/exclude applied, skip
        rules marked.  Indices are contiguous post-filter."""
        cells: list[CampaignCell] = []
        value_lists = [a.values for a in self.axes] or [(None,)]
        for combo in itertools.product(*value_lists):
            coords: dict[str, Any] = dict(self.defaults)
            if self.axes:
                for ax, v in zip(self.axes, combo):
                    if ax.zipped:
                        coords.update(v)
                    else:
                        coords[ax.name] = v
            if self.include and not any(matches(m, coords) for m in self.include):
                continue
            if any(matches(m, coords) for m in self.exclude):
                continue
            skipped = next(
                (r.reason for r in self.skip if matches(r.where, coords)), None
            )
            cells.append(CampaignCell(index=len(cells), coords=coords, skipped=skipped))
        return cells

    def coord_names(self, cells: Sequence[CampaignCell] | None = None) -> list[str]:
        """Ordered union of coordinate keys across the expansion."""
        cells = self.expand() if cells is None else cells
        order: list[str] = []
        for cell in cells:
            for k in cell.coords:
                if k not in order:
                    order.append(k)
        return order

    # ---- serialization ------------------------------------------------------
    def to_json(self) -> dict[str, Any]:
        header: dict[str, Any] = {
            "name": self.name,
            "runner": self.runner,
            "axes": [a.to_json() for a in self.axes],
        }
        if self.defaults:
            header["defaults"] = dict(self.defaults)
        if self.include:
            header["include"] = [dict(m) for m in self.include]
        if self.exclude:
            header["exclude"] = [dict(m) for m in self.exclude]
        if self.skip:
            header["skip"] = [r.to_json() for r in self.skip]
        if self.runner_options:
            header["runner_options"] = dict(self.runner_options)
        return {"campaign": header}

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.to_json(), indent=2) + "\n")
        return path

    def replace(self, **changes: Any) -> "Campaign":
        return dataclasses.replace(self, **changes)


def campaign_from_json(obj: Mapping[str, Any] | str) -> Campaign:
    """Parse a campaign spec (dict or JSON text) with strict key checking."""
    if isinstance(obj, str):
        obj = json.loads(obj)
    reject_unknown_keys(obj, ("campaign",), context="campaign file")
    header = obj.get("campaign")
    if not isinstance(header, Mapping):
        raise ValueError("campaign file is missing its 'campaign' section")
    reject_unknown_keys(header, _CAMPAIGN_KEYS, context="campaign")
    if "name" not in header:
        raise ValueError("campaign spec needs a 'name'")
    return Campaign(
        name=str(header["name"]),
        axes=tuple(Axis.from_json(a) for a in header.get("axes", ())),
        defaults=dict(header.get("defaults", {})),
        include=tuple(dict(m) for m in header.get("include", ())),
        exclude=tuple(dict(m) for m in header.get("exclude", ())),
        skip=tuple(SkipRule.from_json(r) for r in header.get("skip", ())),
        runner=str(header.get("runner", "inline")),
        runner_options=dict(header.get("runner_options", {})),
    )


def load_campaign(path: str | Path) -> Campaign:
    return campaign_from_json(Path(path).read_text())


# ---------------------------------------------------------------------------
# Cell → Scenario compilation
# ---------------------------------------------------------------------------

#: family name → builder(coords) -> Workload.  Extend for out-of-tree
#: families: ``WORKLOAD_FAMILIES["mine"] = lambda c: ...``.
WORKLOAD_FAMILIES: dict[str, Callable[[Mapping[str, Any]], Workload]] = {}


def _family(name: str):
    def _register(fn):
        WORKLOAD_FAMILIES[name] = fn
        return fn

    return _register


def _size_seed(coords: Mapping[str, Any]) -> tuple[int, int]:
    size = coords.get("size")
    if size is None:
        raise ValueError(
            f"family {coords.get('family')!r} needs a 'size' coordinate"
        )
    # Table IX convention: an unseeded scale point is seeded by its size,
    # so 50×50 is THE 50×50 instance, not a different draw per campaign
    return int(size), int(coords.get("seed", size))


@_family("synthetic")
def _synthetic(coords: Mapping[str, Any]) -> Workload:
    size, seed = _size_seed(coords)
    return synthetic_workload(size, seed=seed, max_cores=int(coords.get("max_cores", 16)))


@_family("layered")
def _layered(coords: Mapping[str, Any]) -> Workload:
    size, seed = _size_seed(coords)
    return Workload(
        (
            random_layered_workflow(
                size,
                name=f"W{size}",
                seed=seed,
                max_cores=int(coords.get("max_cores", 4)),
                feature_pool=("F1",),
            ),
        )
    )


@_family("mri")
def _mri(coords: Mapping[str, Any]) -> Workload:
    return mri_workload()


@_family("mri-w1")
def _mri1(coords: Mapping[str, Any]) -> Workload:
    return Workload((mri_w1(),))


@_family("mri-w2")
def _mri2(coords: Mapping[str, Any]) -> Workload:
    return Workload((mri_w2(),))


@_family("stgs")
def _stgs(coords: Mapping[str, Any]) -> Workload:
    return Workload(tuple(stgs_workflows().values()))


def cell_workload(coords: Mapping[str, Any]) -> Workload:
    family = str(coords.get("family", "synthetic"))
    builder = WORKLOAD_FAMILIES.get(family)
    if builder is None:
        raise ValueError(
            f"unknown workflow family {family!r}; options "
            f"{sorted(WORKLOAD_FAMILIES)}{did_you_mean(family, WORKLOAD_FAMILIES)}"
        )
    return builder(coords)


def cell_system(coords: Mapping[str, Any]) -> System:
    kind = str(coords.get("system", "synthetic"))
    if kind == "mri":
        return mri_system()
    if kind == "continuum":
        from repro_torch.service.traces import continuum_system

        return continuum_system()
    if kind == "synthetic":
        nodes = coords.get("nodes", coords.get("size"))
        if nodes is None:
            raise ValueError("synthetic system needs a 'nodes' (or 'size') coordinate")
        # seeded by its own size, mirroring bench_table9_scale
        return synthetic_system(int(nodes), seed=int(nodes))
    if kind == "topology":
        from repro_torch.topology import cached_system, resolve_spec

        spec = coords.get("topology")
        if spec is None:
            raise ValueError(
                "topology system needs a 'topology' coordinate "
                "(a preset name or an inline spec dict)"
            )
        # fingerprint-keyed memo: cells sharing a topology expand it once
        return cached_system(resolve_spec(spec))
    options = ("synthetic", "mri", "continuum", "topology")
    raise ValueError(
        f"unknown system kind {kind!r}; options {options}{did_you_mean(kind, options)}"
    )


def cell_scenario(campaign: Campaign, cell: CampaignCell) -> Scenario:
    """Compile one cell into a runnable declarative Scenario.

    ``constraints`` / ``cycling`` coordinates are the Scenario sections as
    JSON dicts — a cell can sweep deadline tightness or cycle counts like
    any other axis; :meth:`Scenario.expanded` then unrolls cycling into the
    solver-visible workload."""
    c = cell.coords
    return Scenario(
        name=f"{campaign.name}/c{cell.index:04d}",
        system=cell_system(c),
        workload=cell_workload(c),
        weights=_weights_from_json(dict(c.get("weights", {}))),
        technique=str(c.get("technique", "auto")),
        policy=Policy.from_json(c["policy"]) if "policy" in c else None,
        backend=str(c.get("backend", "simulate")),
        engine=str(c.get("engine", "auto")),
        perturbation=Perturbation.from_json(dict(c.get("perturbation", {}))),
        orchestration=OrchestrationConfig.from_json(dict(c.get("orchestration", {}))),
        solver_options=dict(c.get("solver_options", {})),
        constraints=constraints_from_json(c.get("constraints")),
        cycling=cycle_spec_from_json(c.get("cycling")),
    )
