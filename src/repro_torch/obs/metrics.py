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

:data:`FITNESS` attributes each fitness-engine call to a first call (the
one that loads the kernel library on the card) or a steady-state execute.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Iterable, Mapping, Sequence

__all__ = [
    "nearest_rank",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "METRICS",
    "FitnessAccounting",
    "FITNESS",
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


class _Measure:
    """Context manager for one timed engine-fitness call (see below)."""

    __slots__ = ("_acct", "_key", "_cache_size", "_t0", "_size0")

    def __init__(self, acct: "FitnessAccounting", key: str,
                 cache_size: Callable[[], int] | None) -> None:
        self._acct = acct
        self._key = key
        self._cache_size = cache_size

    def __enter__(self) -> "_Measure":
        self._size0 = self._cache_size() if self._cache_size is not None else None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        # Host wall time, with no device synchronisation: a kernel launch
        # returns before the kernel ends, so on the card ``execute_us`` is
        # launch and host time unless the call reads its result back.  A
        # synchronize here would change the timing of the loop it measures.
        dt_us = (time.perf_counter() - self._t0) * 1e6
        if et is None:
            self._acct._record(self._key, dt_us, self._size0, self._cache_size)
        return False


class FitnessAccounting:
    """Per-(backend, shape-bucket, mode) first-call-vs-execute attribution.

    A call counts as a **compile** when the backend's cache grew during it
    (``cache_size`` callable) or, when no cache probe is given, when it is
    the first call for its key: on the card, the call that loads the kernel
    library.  Everything else is steady-state **execute**.  ``calls -
    compiles`` is therefore the cache hit count."""

    __slots__ = ("_table",)

    def __init__(self) -> None:
        self._table: dict[str, dict[str, float]] = {}

    def measure(self, backend: str, bucket: Any, mode: str = "",
                cache_size: Callable[[], int] | None = None) -> _Measure:
        key = f"{backend}|{'x'.join(str(d) for d in bucket)}" + (
            f"|{mode}" if mode else "")
        return _Measure(self, key, cache_size)

    def _record(self, key: str, dt_us: float, size0: int | None,
                cache_size: Callable[[], int] | None) -> None:
        rec = self._table.get(key)
        if rec is None:
            rec = self._table[key] = {
                "calls": 0, "compiles": 0,
                "compile_us": 0.0, "execute_us": 0.0,
            }
        rec["calls"] += 1
        if cache_size is not None and size0 is not None:
            is_compile = cache_size() > size0
        else:
            is_compile = rec["calls"] == 1
        if is_compile:
            rec["compiles"] += 1
            rec["compile_us"] += dt_us
        else:
            rec["execute_us"] += dt_us

    def reset(self) -> None:
        self._table.clear()

    def to_json(self) -> dict[str, dict[str, float]]:
        out: dict[str, dict[str, float]] = {}
        for key, rec in sorted(self._table.items()):
            executes = rec["calls"] - rec["compiles"]
            out[key] = dict(
                rec,
                execute_calls=executes,
                execute_us_mean=(rec["execute_us"] / executes) if executes else 0.0,
            )
        return out


FITNESS = FitnessAccounting()
