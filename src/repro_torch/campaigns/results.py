"""Typed columnar results — the campaign's output surface.

A :class:`ResultSet` is a small, dependency-free column store: every row is
one campaign cell (or one service submission), every column carries a
declared dtype (``int`` / ``float`` / ``str`` / ``bool`` / ``json``), and the
row order is the campaign's deterministic cell order.  It round-trips
through JSON and CSV byte-stably, supports ``select`` / ``group_by`` /
``aggregate`` in plain Python, and ships the paper's Table IX analysis as a
first-class report: :meth:`ResultSet.deviation_vs` computes per-technique
optimality gaps against an exact baseline (MILP) over matching cell
coordinates.

Design notes:

* ``None`` is the universal missing value (a skipped cell has no makespan);
  ``float`` columns expose it as NaN through :meth:`ResultSet.array` and as
  ``null`` in JSON (bare NaN is not strict JSON).
* ``json`` columns hold structured coordinates (an ``ObjectiveWeights`` dict,
  a shape bucket) canonically serialized (sorted keys) in CSV so exports are
  deterministic.
"""

from __future__ import annotations

import csv
import dataclasses
import io
import json
import math
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator, Mapping, Sequence

import numpy as np

DTYPES = ("int", "float", "str", "bool", "json")


@dataclasses.dataclass(frozen=True)
class Column:
    """One typed column: name + declared dtype."""

    name: str
    dtype: str

    def __post_init__(self) -> None:
        if self.dtype not in DTYPES:
            raise ValueError(
                f"column {self.name!r}: unknown dtype {self.dtype!r}; "
                f"options {DTYPES}"
            )

    def to_json(self) -> dict[str, str]:
        return {"name": self.name, "dtype": self.dtype}

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "Column":
        return cls(name=obj["name"], dtype=obj["dtype"])


def _infer_dtype(values: Iterable[Any]) -> str:
    """Scan ALL values: int promotes to float when mixed; any other mixture
    degrades to ``json`` (which passes scalars through) rather than
    crashing construction after a whole campaign has already run."""
    dtype: str | None = None
    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            cand = "bool"
        elif isinstance(v, (dict, list, tuple)):
            cand = "json"
        elif isinstance(v, (int, np.integer)):
            cand = "int"
        elif isinstance(v, (float, np.floating)):
            cand = "float"
        else:
            cand = "str"
        if dtype is None or dtype == cand:
            dtype = cand
        elif {dtype, cand} == {"int", "float"}:
            dtype = "float"
        else:
            return "json"
    return dtype or "str"


def _check(value: Any, col: Column) -> Any:
    """Normalize ``value`` into ``col``'s dtype (None passes through)."""
    if value is None:
        return None
    if col.dtype == "float":
        v = float(value)
        # non-finite normalizes to the universal missing value: an
        # infeasible MILP's makespan=inf is "no result", and bare
        # NaN/Infinity would break the strict-JSON round trip anyway
        return None if not math.isfinite(v) else v
    if col.dtype == "int":
        if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
            raise TypeError(f"column {col.name!r} is int; got {value!r}")
        return int(value)
    if col.dtype == "bool":
        if not isinstance(value, (bool, np.bool_)):
            raise TypeError(f"column {col.name!r} is bool; got {value!r}")
        return bool(value)
    if col.dtype == "json":
        return _plain_json(value)
    return str(value)


def _plain_json(value: Any) -> Any:
    """Recursively coerce to plain JSON types (tuples → lists, numpy → py)."""
    if isinstance(value, Mapping):
        return {str(k): _plain_json(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain_json(v) for v in value]
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, np.bool_):
        return bool(value)
    return value


def _csv_cell(value: Any, dtype: str) -> str:
    if value is None:
        return ""
    if dtype == "json":
        return json.dumps(value, sort_keys=True, separators=(",", ":"))
    if dtype == "bool":
        return "true" if value else "false"
    return str(value)


def _csv_parse(text: str, dtype: str) -> Any:
    if text == "":
        return None
    if dtype == "int":
        return int(text)
    if dtype == "float":
        return float(text)
    if dtype == "bool":
        return text == "true"
    if dtype == "json":
        return json.loads(text)
    return text


class ResultSet:
    """An ordered, typed, columnar table of campaign results."""

    def __init__(
        self,
        columns: Sequence[Column],
        data: Mapping[str, Sequence[Any]],
        *,
        name: str = "results",
        meta: Mapping[str, Any] | None = None,
    ) -> None:
        names = [c.name for c in columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in {names}")
        if set(data) != set(names):
            raise ValueError(
                f"data keys {sorted(data)} do not match columns {sorted(names)}"
            )
        lengths = {len(v) for v in data.values()} or {0}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: lengths {sorted(lengths)}")
        self.columns: tuple[Column, ...] = tuple(columns)
        self._data: dict[str, list[Any]] = {
            c.name: [_check(v, c) for v in data[c.name]] for c in self.columns
        }
        self.name = name
        self.meta: dict[str, Any] = dict(meta or {})

    # ---- construction -------------------------------------------------------
    @classmethod
    def from_rows(
        cls,
        rows: Sequence[Mapping[str, Any]],
        *,
        name: str = "results",
        meta: Mapping[str, Any] | None = None,
        dtypes: Mapping[str, str] | None = None,
    ) -> "ResultSet":
        """Build from row dicts.  Column order is first-seen key order;
        missing keys become ``None``; dtypes are inferred unless declared."""
        order: list[str] = []
        for r in rows:
            for k in r:
                if k not in order:
                    order.append(k)
        dtypes = dict(dtypes or {})
        columns = [
            Column(k, dtypes.get(k) or _infer_dtype(r.get(k) for r in rows))
            for k in order
        ]
        data = {k: [r.get(k) for r in rows] for k in order}
        return cls(columns, data, name=name, meta=meta)

    # ---- row access ---------------------------------------------------------
    def __len__(self) -> int:
        return len(next(iter(self._data.values()), []))

    def row(self, i: int) -> dict[str, Any]:
        return {c.name: self._data[c.name][i] for c in self.columns}

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return (self.row(i) for i in range(len(self)))

    def rows(self) -> list[dict[str, Any]]:
        return list(self)

    def column(self, name: str) -> list[Any]:
        try:
            return list(self._data[name])
        except KeyError:
            raise KeyError(
                f"unknown column {name!r}; options "
                f"{[c.name for c in self.columns]}"
            ) from None

    def array(self, name: str) -> np.ndarray:
        """Numeric column as a float array (``None`` → NaN)."""
        return np.array(
            [math.nan if v is None else float(v) for v in self.column(name)],
            dtype=np.float64,
        )

    def dtype(self, name: str) -> str:
        for c in self.columns:
            if c.name == name:
                return c.dtype
        raise KeyError(name)

    def has_column(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    def baseline_present(
        self, technique: str, *, column: str = "technique"
    ) -> bool:
        """Can :meth:`deviation_vs` use ``technique`` as its exact baseline?
        The one gating predicate shared by the CLI and the exporters."""
        return self.has_column(column) and technique in set(self.column(column))

    # ---- relational helpers -------------------------------------------------
    def _subset(self, idx: Sequence[int], *, name: str | None = None) -> "ResultSet":
        data = {c.name: [self._data[c.name][i] for i in idx] for c in self.columns}
        return ResultSet(self.columns, data, name=name or self.name, meta=self.meta)

    def select(self, **where: Any) -> "ResultSet":
        """Rows whose columns equal (or are contained in) the given values."""

        def ok(r: Mapping[str, Any]) -> bool:
            for k, cond in where.items():
                v = r.get(k)
                if isinstance(cond, (list, tuple, set, frozenset)):
                    if v not in cond:
                        return False
                elif v != cond:
                    return False
            return True

        return self._subset([i for i in range(len(self)) if ok(self.row(i))])

    def filter(self, fn: Callable[[Mapping[str, Any]], bool]) -> "ResultSet":
        return self._subset([i for i in range(len(self)) if fn(self.row(i))])

    def group_by(self, *keys: str) -> list[tuple[tuple[Any, ...], "ResultSet"]]:
        """Stable grouping: groups appear in first-row order."""
        groups: dict[str, tuple[tuple[Any, ...], list[int]]] = {}
        for i in range(len(self)):
            r = self.row(i)
            kv = tuple(r.get(k) for k in keys)
            kid = json.dumps(_plain_json(list(kv)), sort_keys=True)
            groups.setdefault(kid, (kv, []))[1].append(i)
        return [(kv, self._subset(idx)) for kv, idx in groups.values()]

    def aggregate(
        self,
        metric: str,
        by: Sequence[str],
        aggs: Sequence[str] = ("mean", "min", "max", "count"),
    ) -> "ResultSet":
        """Aggregate a numeric column per group → new ResultSet."""
        fns: dict[str, Callable[[np.ndarray], float]] = {
            "mean": lambda a: float(a.mean()),
            "min": lambda a: float(a.min()),
            "max": lambda a: float(a.max()),
            "count": lambda a: float(a.size),
        }
        out_rows: list[dict[str, Any]] = []
        for kv, grp in self.group_by(*by):
            vals = grp.array(metric)
            vals = vals[~np.isnan(vals)]
            row: dict[str, Any] = dict(zip(by, kv))
            for agg in aggs:
                if agg not in fns:
                    raise ValueError(f"unknown aggregate {agg!r}; options {sorted(fns)}")
                v = fns[agg](vals) if vals.size else None
                row[f"{metric}_{agg}"] = int(v) if agg == "count" and v is not None else v
            out_rows.append(row)
        dtypes = {f"{metric}_count": "int"}
        dtypes.update({f"{metric}_{a}": "float" for a in aggs if a != "count"})
        return ResultSet.from_rows(
            out_rows, name=f"{self.name}:agg", meta=self.meta, dtypes=dtypes
        )

    # ---- the Table IX report ------------------------------------------------
    def deviation_vs(
        self,
        exact: str = "milp",
        *,
        metric: str = "makespan",
        technique_col: str = "technique",
        within: Sequence[str] | None = None,
    ) -> "ResultSet":
        """Per-cell deviation from an exact technique's metric — the paper's
        optimality-gap analysis (Table IX: heuristics within 5–10% of MILP).

        Rows are grouped by ``within`` (default: the campaign's coordinate
        columns minus ``technique_col``); inside each group the ``exact``
        technique's finite ``metric`` is the baseline and every row gains
        ``{metric}_exact``, ``gap`` (absolute), ``gap_pct`` and
        ``baseline_status``.  Groups with no usable baseline are NOT
        dropped: their rows carry ``gap`` / ``gap_pct`` of ``None`` and a
        ``baseline_status`` saying *why* — ``"infeasible"`` when the exact
        solve ran and failed (a constraint-unsatisfiable MILP is a finding,
        not a hole in the table), ``"skipped"`` when the exact cell was
        filtered away (the paper's '-' entries, e.g. MILP above its size
        ceiling) or absent entirely."""
        if within is None:
            coords = self.meta.get("coords")
            if not coords:
                raise ValueError(
                    "no coordinate columns recorded in meta['coords']; "
                    "pass within=(...) explicitly"
                )
            within = [c for c in coords if c != technique_col]
        out: list[dict[str, Any]] = []
        for kv, grp in self.group_by(*within):
            base: float | None = None
            base_status = "skipped"
            for r in grp:
                if r.get(technique_col) != exact:
                    continue
                failed = "failed" in str(r.get("status") or "") or (
                    "failed" in str(r.get("solve_status") or "")
                )
                if r.get(metric) is not None and not failed:
                    base = float(r[metric])
                    base_status = "ok"
                    break
                if failed:
                    # the exact solver ran and could not produce a feasible
                    # optimum — don't let a fallback makespan pose as one
                    base_status = "infeasible"
            for r in grp:
                v = r.get(metric)
                if v is None:
                    continue
                row = dict(zip(within, kv))
                row[technique_col] = r.get(technique_col)
                row[metric] = float(v)
                row["baseline_status"] = base_status
                row[f"{metric}_exact"] = base
                if base is None:
                    row["gap"] = None
                    row["gap_pct"] = None
                else:
                    row["gap"] = float(v) - base
                    row["gap_pct"] = (
                        100.0 * (float(v) - base) / base if base else None
                    )
                out.append(row)
        return ResultSet.from_rows(
            out,
            name=f"{self.name}:deviation_vs_{exact}",
            meta={**self.meta, "exact": exact, "metric": metric},
            dtypes={metric: "float", f"{metric}_exact": "float",
                    "gap": "float", "gap_pct": "float",
                    "baseline_status": "str"},
        )

    def deviation_report(
        self,
        exact: str = "milp",
        *,
        metric: str = "makespan",
        technique_col: str = "technique",
        within: Sequence[str] | None = None,
    ) -> "ResultSet":
        """Aggregated gaps per technique (mean/max/count of ``gap_pct``)."""
        dev = self.deviation_vs(
            exact, metric=metric, technique_col=technique_col, within=within
        )
        return dev.aggregate("gap_pct", by=(technique_col,))

    def constraint_report(
        self, by: Sequence[str] = ("technique",)
    ) -> "ResultSet":
        """Constraint-satisfaction rate per group, next to mean makespan.

        Counts only ``constrained`` rows (the inline runner marks them);
        a row is *satisfied* when its solved schedule met every hard
        constraint (``violations == 0``).  A failed or skipped constrained
        cell counts as unsatisfied — the rate answers "how often did this
        technique deliver a constraint-clean schedule", not "how often did
        it succeed given that it produced one"."""
        for col in ("constrained", "satisfied"):
            if not self.has_column(col):
                raise ValueError(
                    f"no {col!r} column — constraint_report needs a "
                    "ResultSet from a constraint-aware runner"
                )
        sub = self.select(constrained=True)
        out: list[dict[str, Any]] = []
        for kv, grp in sub.group_by(*by):
            total = len(grp)
            sat = sum(1 for r in grp if r.get("satisfied"))
            mk = grp.array("makespan")
            mk = mk[~np.isnan(mk)]
            row: dict[str, Any] = dict(zip(by, kv))
            row.update(
                constrained_cells=total,
                satisfied_cells=sat,
                satisfaction_rate=(sat / total) if total else None,
                makespan_mean=float(mk.mean()) if mk.size else None,
                makespan_max=float(mk.max()) if mk.size else None,
            )
            out.append(row)
        return ResultSet.from_rows(
            out,
            name=f"{self.name}:constraints",
            meta=self.meta,
            dtypes={"constrained_cells": "int", "satisfied_cells": "int",
                    "satisfaction_rate": "float", "makespan_mean": "float",
                    "makespan_max": "float"},
        )

    # ---- serialization ------------------------------------------------------
    def to_json(self) -> dict[str, Any]:
        return {
            "resultset": {"name": self.name, "meta": _plain_json(self.meta)},
            "columns": [c.to_json() for c in self.columns],
            "data": {c.name: _plain_json(self._data[c.name]) for c in self.columns},
        }

    @classmethod
    def from_json(cls, obj: Mapping[str, Any] | str) -> "ResultSet":
        if isinstance(obj, str):
            obj = json.loads(obj)
        header = obj.get("resultset", {})
        columns = [Column.from_json(c) for c in obj.get("columns", ())]
        return cls(
            columns,
            {c.name: obj["data"][c.name] for c in columns},
            name=header.get("name", "results"),
            meta=header.get("meta", {}),
        )

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.to_json(), indent=2, sort_keys=True) + "\n")
        return path

    @classmethod
    def load(cls, path: str | Path) -> "ResultSet":
        return cls.from_json(json.loads(Path(path).read_text()))

    def to_csv(self) -> str:
        buf = io.StringIO()
        w = csv.writer(buf, lineterminator="\n")
        w.writerow([c.name for c in self.columns])
        for i in range(len(self)):
            w.writerow(
                [_csv_cell(self._data[c.name][i], c.dtype) for c in self.columns]
            )
        return buf.getvalue()

    @classmethod
    def from_csv(
        cls,
        text: str,
        *,
        columns: Sequence[Column] | None = None,
        name: str = "results",
        meta: Mapping[str, Any] | None = None,
    ) -> "ResultSet":
        """Parse :meth:`to_csv` output.  Without an explicit schema, dtypes
        are inferred per column (int ⊂ float ⊂ str; ``true``/``false`` →
        bool; ``{``/``[`` prefixed → json).

        CSV is the *export* format; JSON is the lossless one.  Known CSV
        round-trip caveats (pass ``columns=`` to pin dtypes where they
        matter): ``None`` and ``""`` both serialize to an empty cell and
        parse back as ``None``; a str column whose every value looks like a
        number / ``true``/``false`` / JSON re-infers as that richer
        dtype."""
        reader = csv.reader(io.StringIO(text))
        try:
            header = next(reader)
        except StopIteration:
            return cls((), {}, name=name, meta=meta)
        raw = list(reader)
        if columns is None:
            columns = [
                Column(h, _infer_csv_dtype([r[j] for r in raw]))
                for j, h in enumerate(header)
            ]
        by_name = {c.name: c for c in columns}
        data = {
            h: [_csv_parse(r[j], by_name[h].dtype) for r in raw]
            for j, h in enumerate(header)
        }
        return cls([by_name[h] for h in header], data, name=name, meta=meta)

    def save_csv(self, path: str | Path) -> Path:
        path = Path(path)
        path.write_text(self.to_csv())
        return path


def _infer_csv_dtype(cells: Sequence[str]) -> str:
    dtype = None
    for cell in cells:
        if cell == "":
            continue
        if cell in ("true", "false"):
            cand = "bool"
        elif cell[:1] in ("{", "["):
            cand = "json"
        else:
            try:
                int(cell)
                cand = "int"
            except ValueError:
                try:
                    float(cell)
                    cand = "float"
                except ValueError:
                    cand = "str"
        if dtype is None:
            dtype = cand
        elif dtype != cand:
            if {dtype, cand} == {"int", "float"}:
                dtype = "float"
            else:
                return "str"
    return dtype or "str"
