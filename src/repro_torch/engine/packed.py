"""The canonical device-ready problem representation.

One :class:`PackedProblem` is the unit every engine evaluates against: the
problem padded to a shape bucket, in f32/i32 numpy arrays, with torch copies
made once per device (:meth:`PackedProblem.device_arrays`).

Padding is objective-neutral by construction:

* padded tasks have zero duration/data/usage, no predecessors, release 0,
  and are feasible only on node 0; pinned there they finish at node 0's
  earliest core-free time (≤ makespan) and leave the core state untouched;
* padded nodes are infeasible for every real task and own no cores
  (``init_free`` all 1e30), so a correct sampler never selects them.

:func:`pack` memoizes by ``(problem fingerprint, bucket, core_cap)`` in an
entry- and byte-bounded LRU, so a content-identical problem reuses the padded
arrays and their device copies.  :func:`from_arrays` takes the reference
package's ``PackedProblem.numpy_arrays()`` and builds the port's equivalent.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.workload_model import ScheduleProblem, problem_fingerprint

_INF = 1e30  # dead links (+inf in JSON) and never-free core slots

#: arrays consumed by the fitness cores
FITNESS_ARRAY_KEYS = (
    "durations",
    "cores",
    "data",
    "feasible",
    "release",
    "pred_matrix",
    "dtr",
    "init_free",
    "node_cores",
    "usage_fixed",
    "usage_weighted",
    # hard-constraint arrays (neutral when unconstrained: 1e30 deadlines and
    # budgets, zero costs)
    "deadline",
    "cost",
    "wf",
    "wf_budget",
)

Bucket = tuple[int, int, int, int]


def _round_up_pow2(x: int, floor: int = 4) -> int:
    x = max(int(x), 1)
    out = floor
    while out < x:
        out *= 2
    return out


def _cmax_of(problem: ScheduleProblem, core_cap: int | None) -> int:
    caps = problem.node_cores.astype(np.int64)
    cmax = int(core_cap if core_cap is not None else min(caps.max(initial=1), 512))
    return max(cmax, int(problem.cores.max(initial=1)), 1)


def exact_bucket(problem: ScheduleProblem, core_cap: int | None = None) -> Bucket:
    """The problem's own shapes ``(T, N, CMAX, MAXP)`` — no padding."""
    return (
        problem.num_tasks,
        problem.num_nodes,
        _cmax_of(problem, core_cap),
        max(int(problem.pred_matrix.shape[1]), 1),
    )


def bucket_of(problem: ScheduleProblem, core_cap: int | None = None) -> Bucket:
    """Shape bucket ``(T, N, CMAX, MAXP)``, each dim rounded up to a power of
    two so unequal instances stack into one family."""
    t, n, cmax, maxp = exact_bucket(problem, core_cap)
    return (
        _round_up_pow2(t),
        _round_up_pow2(n),
        _round_up_pow2(cmax),
        _round_up_pow2(maxp, floor=1),
    )


def common_bucket(problems: Sequence[ScheduleProblem]) -> Bucket:
    """Elementwise-max bucket covering every problem in the list."""
    buckets = [bucket_of(p) for p in problems]
    return tuple(max(b[d] for b in buckets) for d in range(4))  # type: ignore[return-value]


def _to_device(arrays: Mapping[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """Contiguous torch copies in the kernel's dtypes: bool → uint8, ints →
    int32, floats → float32."""
    out = {}
    for k, a in arrays.items():
        if a.dtype == bool:
            a = a.astype(np.uint8)
        elif np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int32)
        else:
            a = a.astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class PackedProblem:
    """Frozen, padded, f32 dense problem — the engine's unit of work.

    The numpy arrays are read-only; torch copies are built lazily and cached
    per device, so one packed problem pays one host→device transfer however
    many solves reuse it."""

    durations: np.ndarray  # [Tb, Nb] f32
    cores: np.ndarray  # [Tb] i32 (≥ 1)
    data: np.ndarray  # [Tb] f32
    feasible: np.ndarray  # [Tb, Nb] bool
    release: np.ndarray  # [Tb] f32
    pred_matrix: np.ndarray  # [Tb, Pb] i32, -1 padded
    dtr: np.ndarray  # [Nb, Nb] f32, 1e30 for +inf rates
    init_free: np.ndarray  # [Nb, Cb] f32, 1e30 core padding
    node_cores: np.ndarray  # [Nb] i32
    usage_fixed: np.ndarray  # [Tb] f32
    usage_weighted: np.ndarray  # [Tb, Nb] f32
    deadline: np.ndarray  # [Tb] f32 latest finish per task (1e30 = none)
    cost: np.ndarray  # [Tb, Nb] f32 cost of task j on node i (0 when unbudgeted)
    wf: np.ndarray  # [Tb] i32 workflow id per task (pad rows → first pad id)
    wf_budget: np.ndarray  # [Tb] f32 budget by workflow id row (1e30 = none)
    bucket: Bucket
    num_tasks: int  # real tasks (≤ bucket[0])
    num_nodes: int  # real nodes (≤ bucket[1])
    cmax: int  # modelled core window (≤ bucket[2])
    fingerprint: str | None = None
    constrained: bool = False  # any deadline/budget packed
    _device: dict[str, dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    def numpy_arrays(self) -> dict[str, np.ndarray]:
        """The fitness-core array dict (host copies, read-only)."""
        return {k: getattr(self, k) for k in FITNESS_ARRAY_KEYS}

    @property
    def nbytes(self) -> int:
        """Host bytes held by the padded arrays."""
        return sum(getattr(self, k).nbytes for k in FITNESS_ARRAY_KEYS)

    def device_arrays(self, device="cuda") -> dict[str, torch.Tensor]:
        """Torch copies of :meth:`numpy_arrays` on ``device``, made once and
        cached: ``feasible`` as uint8, integer arrays as int32, the rest
        float32, all contiguous."""
        key = str(torch.device(device))
        if key not in self._device:
            self._device[key] = _to_device(self.numpy_arrays(), device)
        return dict(self._device[key])


def _frozen(arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    for a in arrays.values():
        a.setflags(write=False)
    return arrays


def _build(
    problem: ScheduleProblem,
    bucket: Bucket,
    fingerprint: str | None,
    core_cap: int | None = None,
) -> PackedProblem:
    Tb, Nb, Cb, Pb = bucket
    T, N = problem.num_tasks, problem.num_nodes
    maxp = problem.pred_matrix.shape[1]
    if T > Tb or N > Nb or maxp > Pb:
        raise ValueError(f"problem {T}x{N} (maxp={maxp}) exceeds bucket {bucket}")
    caps = problem.node_cores.astype(np.int64)
    if int(problem.cores.max(initial=1)) > Cb:
        raise ValueError(f"task core request exceeds bucket cmax {Cb}")

    durations = np.zeros((Tb, Nb), np.float32)
    durations[:T, :N] = problem.durations
    cores = np.ones(Tb, np.int32)
    cores[:T] = np.maximum(problem.cores, 1.0).astype(np.int32)
    data = np.zeros(Tb, np.float32)
    data[:T] = problem.data
    feasible = np.zeros((Tb, Nb), bool)
    feasible[:T, :N] = problem.feasible
    feasible[T:, 0] = True  # padded tasks live on node 0
    release = np.zeros(Tb, np.float32)
    release[:T] = problem.release
    pred_matrix = -np.ones((Tb, Pb), np.int32)
    pred_matrix[:T, :maxp] = problem.pred_matrix
    dtr = np.ones((Nb, Nb), np.float32)
    dtr[:N, :N] = np.where(np.isfinite(problem.dtr), problem.dtr, _INF)
    init_free = np.full((Nb, Cb), _INF, np.float32)
    for i, c in enumerate(caps):
        init_free[i, : min(int(c), Cb)] = 0.0
    node_cores = np.ones(Nb, np.int32)
    node_cores[:N] = np.minimum(np.maximum(caps, 1), Cb)
    usage_fixed = np.zeros(Tb, np.float32)
    usage_fixed[:T] = problem.usage
    usage_weighted = np.zeros((Tb, Nb), np.float32)
    usage_weighted[:T, :N] = problem.weighted_usage()
    deadline = np.full(Tb, _INF, np.float32)
    if problem.deadline is not None:
        deadline[:T] = np.minimum(problem.deadline, _INF)
    cost = np.zeros((Tb, Nb), np.float32)
    # pad rows join a phantom workflow (first free id) whose budget is 1e30
    # and whose packed costs are 0 — penalty-neutral
    w_count = len(problem.workflow_names)
    wf = np.full(Tb, min(w_count, Tb - 1), np.int32)
    wf[:T] = problem.workflow_of
    wf_budget = np.full(Tb, _INF, np.float32)
    if problem.budget is not None:
        cost[:T, :N] = problem.cost_matrix()
        wf_budget[:w_count] = np.minimum(problem.budget, _INF)
    arrays = _frozen({
        "durations": durations,
        "cores": cores,
        "data": data,
        "feasible": feasible,
        "release": release,
        "pred_matrix": pred_matrix,
        "dtr": dtr,
        "init_free": init_free,
        "node_cores": node_cores,
        "usage_fixed": usage_fixed,
        "usage_weighted": usage_weighted,
        "deadline": deadline,
        "cost": cost,
        "wf": wf,
        "wf_budget": wf_budget,
    })
    return PackedProblem(
        bucket=bucket,
        num_tasks=T,
        num_nodes=N,
        cmax=min(_cmax_of(problem, core_cap), Cb),
        fingerprint=fingerprint,
        constrained=problem.has_constraints,
        **arrays,
    )


_NUMPY_DTYPES = {
    "cores": np.int32, "pred_matrix": np.int32, "node_cores": np.int32,
    "wf": np.int32, "feasible": bool,
}


def from_arrays(
    arrays: Mapping[str, np.ndarray],
    *,
    bucket: Bucket,
    num_tasks: int,
    num_nodes: int,
    cmax: int,
    constrained: bool,
) -> PackedProblem:
    """Build a :class:`PackedProblem` from another packing's fitness arrays —
    for example the reference package's ``PackedProblem.numpy_arrays()`` —
    checking every key and shape against ``bucket``."""
    Tb, Nb, Cb, Pb = bucket
    shapes = {
        "durations": (Tb, Nb), "cores": (Tb,), "data": (Tb,), "feasible": (Tb, Nb),
        "release": (Tb,), "pred_matrix": (Tb, Pb), "dtr": (Nb, Nb), "init_free": (Nb, Cb),
        "node_cores": (Nb,), "usage_fixed": (Tb,), "usage_weighted": (Tb, Nb),
        "deadline": (Tb,), "cost": (Tb, Nb), "wf": (Tb,), "wf_budget": (Tb,),
    }
    missing = set(FITNESS_ARRAY_KEYS) - set(arrays)
    if missing:
        raise ValueError(f"from_arrays: missing arrays {sorted(missing)}")
    out = {}
    for k in FITNESS_ARRAY_KEYS:
        a = np.array(arrays[k], dtype=_NUMPY_DTYPES.get(k, np.float32))
        if a.shape != shapes[k]:
            raise ValueError(f"from_arrays: {k} has shape {a.shape}, bucket {bucket} needs {shapes[k]}")
        out[k] = a
    return PackedProblem(
        bucket=tuple(int(d) for d in bucket),  # type: ignore[arg-type]
        num_tasks=int(num_tasks),
        num_nodes=int(num_nodes),
        cmax=int(cmax),
        constrained=bool(constrained),
        **_frozen(out),
    )


@dataclasses.dataclass
class PackStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0


class PackCache:
    """Entry- and byte-bounded LRU of pack key → :class:`PackedProblem`.

    ``max_bytes`` bounds the retained host bytes (the cached device copies
    take about as much again on each device); a single pack larger than the
    whole budget is served uncached."""

    def __init__(self, capacity: int = 256, max_bytes: int = 1 << 30) -> None:
        if capacity < 1:
            raise ValueError("pack cache capacity must be >= 1")
        if max_bytes < 1:
            raise ValueError("pack cache max_bytes must be >= 1")
        self.capacity = capacity
        self.max_bytes = max_bytes
        self._entries: OrderedDict[tuple, PackedProblem] = OrderedDict()
        self._bytes = 0
        self.stats = PackStats()

    def get_or_build(self, key: tuple, build: Callable[[], PackedProblem]) -> PackedProblem:
        packed = self._entries.get(key)
        if packed is not None:
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return packed
        self.stats.misses += 1
        packed = build()
        size = packed.nbytes
        if size > self.max_bytes:
            return packed
        self._entries[key] = packed
        self._bytes += size
        while len(self._entries) > self.capacity or self._bytes > self.max_bytes:
            _, evicted = self._entries.popitem(last=False)
            self._bytes -= evicted.nbytes
            self.stats.evictions += 1
        return packed

    def clear(self) -> None:
        self._entries.clear()
        self._bytes = 0

    @property
    def retained_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)


_PACK_CACHE = PackCache()


def pack_cache() -> PackCache:
    """The process-wide pack LRU (every :func:`pack` call flows through it)."""
    return _PACK_CACHE


def pack(
    problem: ScheduleProblem,
    bucket: Bucket | None = None,
    *,
    core_cap: int | None = None,
    pad: bool = True,
    use_cache: bool = True,
) -> PackedProblem:
    """The canonical packing entry point.

    ``bucket=None`` picks the problem's pow2 bucket (``pad=False``: its
    exact shapes).  Memoized by ``(fingerprint, bucket, core_cap)``;
    ``use_cache=False`` forces a rebuild."""
    if bucket is None:
        bucket = bucket_of(problem, core_cap) if pad else exact_bucket(problem, core_cap)
    if not use_cache:
        return _build(problem, bucket, None, core_cap)
    fingerprint = problem_fingerprint(problem)
    return _PACK_CACHE.get_or_build(
        (fingerprint, bucket, core_cap),
        lambda: _build(problem, bucket, fingerprint, core_cap),
    )


def stack_packed(
    problems: Sequence[ScheduleProblem],
    bucket: Bucket | None = None,
    *,
    device="cuda",
) -> tuple[dict[str, torch.Tensor], Bucket]:
    """Stack padded instances along a leading instance axis: one shared
    bucket, one transfer to ``device`` for the whole family."""
    bucket = common_bucket(problems) if bucket is None else bucket
    packed = [pack(p, bucket) for p in problems]
    stacked = {k: np.stack([pp.numpy_arrays()[k] for pp in packed]) for k in FITNESS_ARRAY_KEYS}
    return _to_device(stacked, device), bucket
