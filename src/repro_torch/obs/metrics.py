"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms
and pluggable *collectors* (callables owned by other modules, such as the
pack cache's, registered at import time so this module stays stdlib-only and
importable from anywhere without cycles).

Two operations matter:

* :meth:`MetricsRegistry.snapshot` — a plain-JSON dict of everything.
* :meth:`MetricsRegistry.delta` — recursive numeric subtraction of two
  snapshots (counters/histograms/collectors), with **gauges kept at their
  "after" value** (a gauge is a level, not a flow).

Percentiles use the **nearest-rank** definition throughout the package: the
``q``-th percentile of ``n`` sorted values is the element at index
``ceil(q/100 * n) - 1`` — the smallest value whose cumulative rank covers
``q`` percent.  Unlike interpolating definitions (``numpy.percentile``
default) the result is always an observed value, which keeps service
latency summaries honest for small samples.

The reference's compile/execute accounting of the fitness engines
(``FitnessAccounting``) is not here yet (ROADMAP Queue A item 5).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable, Mapping, Sequence

__all__ = [
    "nearest_rank",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "METRICS",
]


def _rank_index(n: int, q: float) -> int:
    """Nearest-rank index into a sorted sample of size ``n`` (see module doc)."""
    if n <= 0:
        raise ValueError("percentile of empty sample")
    if not 0.0 < q <= 100.0:
        raise ValueError(f"percentile q must be in (0, 100], got {q}")
    return max(1, math.ceil(q / 100.0 * n)) - 1


def nearest_rank(values: Iterable[float], q: float) -> float:
    """Nearest-rank percentile of raw values (always an observed value)."""
    xs = sorted(float(v) for v in values)
    return xs[_rank_index(len(xs), q)]


class Counter:
    """Monotonic counter (int or float increments)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0

    def inc(self, amount: float = 1) -> None:
        self.value += amount


class Gauge:
    """Last-write-wins level (queue depth, cache size, ...)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0

    def set(self, value: float) -> None:
        self.value = value


# default geometric bounds: 1µs .. ~100s in decades (values are seconds)
_DEFAULT_BOUNDS = tuple(10.0 ** e for e in range(-6, 3))


class Histogram:
    """Fixed-bucket histogram with nearest-rank percentile estimation.

    ``bounds`` are inclusive upper bounds; one implicit +inf bucket is
    appended.  ``percentile`` returns the upper bound of the bucket holding
    the nearest-rank element (the recorded ``max`` for the overflow
    bucket) — an upper-bound estimate, which is the right bias for SLO
    reporting."""

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, bounds: Sequence[float] | None = None) -> None:
        self.bounds = tuple(float(b) for b in (bounds or _DEFAULT_BOUNDS))
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram bounds must be sorted ascending")
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        i = 0
        for i, b in enumerate(self.bounds):
            if value <= b:
                break
        else:
            i = len(self.bounds)
        self.counts[i] += 1
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def percentile(self, q: float) -> float:
        rank = _rank_index(self.count, q) + 1  # 1-based cumulative rank
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max  # unreachable when count > 0

    def to_json(self) -> dict[str, Any]:
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }


class MetricsRegistry:
    """Create-on-demand registry; use the module singleton :data:`METRICS`."""

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}
        self._collectors: dict[str, Callable[[], Mapping[str, Any]]] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  bounds: Sequence[float] | None = None) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(bounds)
        return h

    def register_collector(
        self, name: str, fn: Callable[[], Mapping[str, Any]]
    ) -> None:
        """Register a callable polled at snapshot time (owned elsewhere)."""
        self._collectors[name] = fn

    def reset(self) -> None:
        """Zero all instruments (collectors stay registered)."""
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()

    def snapshot(self) -> dict[str, Any]:
        snap: dict[str, Any] = {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.to_json() for k, h in sorted(self._hists.items())},
        }
        for name, fn in sorted(self._collectors.items()):
            try:
                snap[name] = dict(fn())
            except Exception as e:  # a broken collector must not sink a run
                snap[name] = {"error": f"{type(e).__name__}: {e}"}
        return snap

    @staticmethod
    def delta(before: Mapping[str, Any] | None,
              after: Mapping[str, Any]) -> dict[str, Any]:
        """Recursive ``after - before``; gauges keep their "after" level."""
        if before is None:
            return dict(after)
        out: dict[str, Any] = {}
        for key, b in after.items():
            if key == "gauges":
                out[key] = dict(b)
                continue
            out[key] = _sub(before.get(key), b)
        return out


def _sub(a: Any, b: Any) -> Any:
    if isinstance(b, Mapping):
        a = a if isinstance(a, Mapping) else {}
        return {k: _sub(a.get(k), v) for k, v in b.items()}
    if isinstance(b, (list, tuple)):
        a = a if isinstance(a, (list, tuple)) and len(a) == len(b) else [None] * len(b)
        return [_sub(x, y) for x, y in zip(a, b)]
    if isinstance(b, bool) or not isinstance(b, (int, float)):
        return b
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return b - a
    return b


METRICS = MetricsRegistry()
