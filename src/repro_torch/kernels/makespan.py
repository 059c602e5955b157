"""Population makespan — the metaheuristics' fitness hot spot.

Two versions of one function, ``(assignments, problem arrays) ->
(makespan, violations)``, capacity-aware core-granular list scheduling of
every candidate assignment (see :mod:`repro_torch.core.evaluator` for the
semantics):

* :func:`population_makespan_ref` — the plain PyTorch version, vectorised
  over instances and candidates with a Python loop over the T tasks.  It is
  the counterpart of the reference's ``kernels/ref.py`` oracle and what the
  CPU runs;
* :func:`population_makespan_cuda` — the wrapper of the hand-written Hopper
  kernel ``csrc/makespan.cu``, which replaces the reference's Pallas kernel.
  It is the one place that chooses an implementation, by the tensors'
  device alone: on CPU tensors it runs the plain version, on CUDA tensors
  it launches the kernel or raises.  ``population_makespan_cuda.launches``
  counts its kernel launches.

Both take one instance (``assignments [P, T]``, arrays without an instance
axis) or a stacked family (``assignments [B, P, T]``, every array with a
leading ``B``), and agree bit for bit.

:func:`makespan_plan` is how the wrapper lays the kernel out on the card
(slots a lane, candidates a block, shared memory, and whether the
candidates' core-free rows live in shared memory or in L2); it reads only
shapes and the card's SM count and shared-memory limit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.select import kth_from_ranks, stable_ranks, update_from_ranks

_NEG = -1e30
WARP_SLOTS = (1, 2, 4, 8, 16, 32)  # core slots a lane: CMAX up to 1024
MAX_WARPS = 4  # candidates (one warp each) a block at most


def _default_node_cores(init_free: torch.Tensor) -> torch.Tensor:
    # padding entries are "never free" (1e30); real cores start at 0
    return (init_free < 1e29).sum(dim=-1).clamp(min=1).to(torch.int32)


def _batched(assignments: torch.Tensor, arrays: dict) -> tuple[bool, torch.Tensor, dict]:
    """Give a single instance a leading instance axis of 1."""
    if assignments.dim() == 3:
        return True, assignments, arrays
    if assignments.dim() != 2:
        raise _build.KernelInputError(f"assignments must be [P, T] or [B, P, T], got {tuple(assignments.shape)}")
    return False, assignments[None], {k: None if v is None else v[None] for k, v in arrays.items()}


def population_makespan_ref(
    assignments: torch.Tensor,  # [P, T] or [B, P, T] (tasks topologically ordered)
    *,
    durations: torch.Tensor,  # [T, N] f32
    cores: torch.Tensor,  # [T] int (>= 1)
    data: torch.Tensor,  # [T] f32 output sizes
    feasible: torch.Tensor,  # [T, N] bool/uint8
    release: torch.Tensor,  # [T] f32
    pred_matrix: torch.Tensor,  # [T, MAXP] int, -1 padded
    dtr: torch.Tensor,  # [N, N] f32 (1e30 for +inf)
    init_free: torch.Tensor,  # [N, CMAX] f32 (1e30 beyond node cores)
    node_cores: torch.Tensor | None = None,  # [N] int
    deadline: torch.Tensor | None = None,  # [T] f32 latest finish (1e30 = none)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch list scheduling; returns ``(makespan, violations)``
    (f32, shape ``[P]`` or ``[B, P]``).  ``deadline`` adds one violation per
    task finishing past it."""
    if node_cores is None:
        node_cores = _default_node_cores(init_free)
    batched, a, arr = _batched(assignments, dict(
        durations=durations, cores=cores, data=data, feasible=feasible, release=release,
        pred_matrix=pred_matrix, dtr=dtr, init_free=init_free, node_cores=node_cores,
        deadline=deadline,
    ))
    a = a.long()
    B, P, T = a.shape
    C = arr["init_free"].shape[-1]
    dev = a.device
    bi = torch.arange(B, device=dev)[:, None]  # [B, 1]
    pi = torch.arange(P, device=dev)[None, :]  # [1, P]
    preds = arr["pred_matrix"].long()
    cores_t = arr["cores"].long()
    ncores = arr["node_cores"].long()
    data_t, dtr_t, dur_t = arr["data"], arr["dtr"], arr["durations"]
    core_free = arr["init_free"][:, None].expand(B, P, -1, C).clone()  # [B, P, N, C]
    fin = torch.zeros(B, P, T, dtype=torch.float32, device=dev)

    for j in range(T):
        i = a[:, :, j]  # [B, P]
        ps = preds[:, j, :]  # [B, MAXP]
        valid = (ps >= 0)[:, None, :]
        psafe = ps.clamp(min=0)
        pidx = psafe[:, None, :].expand(B, P, -1)  # [B, P, MAXP]
        p_nodes = torch.gather(a, 2, pidx)
        rate = dtr_t[bi[..., None], p_nodes, i[..., None]]
        d_p = torch.gather(data_t, 1, psafe)[:, None, :]
        transfer = torch.where(p_nodes == i[..., None], 0.0, d_p / rate)
        terms = torch.where(valid, torch.gather(fin, 2, pidx) + transfer, _NEG)
        ready = torch.maximum(arr["release"][:, j, None], terms.amax(dim=-1))
        row = core_free[bi, pi, i]  # [B, P, C]
        ranks = stable_ranks(row)
        c = torch.clamp(torch.minimum(cores_t[:, j, None], ncores[bi, i]), min=1)
        kth = kth_from_ranks(row, ranks, c)
        f = torch.maximum(ready, kth) + dur_t[bi, j, i]
        core_free[bi, pi, i] = update_from_ranks(row, ranks, c, f)
        fin[:, :, j] = f

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    makespan = torch.maximum(fin.amax(dim=-1), zero) if T else fin.new_zeros(B, P)
    tj = torch.arange(T, device=dev)[None, None, :]
    feas = arr["feasible"][bi[..., None], tj, a].bool()  # [B, P, T]
    violations = (~feas).sum(dim=-1).to(torch.float32)
    if arr["deadline"] is not None:
        violations = violations + (fin > arr["deadline"][:, None, :]).sum(dim=-1).to(torch.float32)
    if not batched:
        return makespan[0], violations[0]
    return makespan, violations


@dataclasses.dataclass(frozen=True)
class MakespanPlan:
    """How the kernel runs one shape: ``slots`` core slots a lane (the row
    padded to ``32 * slots``), ``warps`` candidates a block, ``blocks``
    blocks, ``smem`` bytes of dynamic shared memory a block, and where the
    candidates' core-free rows and their ranks live (``rows_in_smem``, else
    a device-memory scratch ``[B, P, N, 32 * slots]`` kept in L2)."""

    slots: int
    warps: int
    blocks: int
    smem: int
    rows_in_smem: bool


def warp_smem(T: int, N: int, slots: int, rows_in_smem: bool) -> int:
    """Bytes of shared memory one candidate's warp takes (``csrc/makespan.cu::
    warp_floats``), rows padded to ``32 * slots`` slots: the rows and their
    u16 ranks when they live there; a broadcast row; three prefetch slots of
    a row and its ranks; the assignment and finish times; the ring of
    prefetched inputs (9 steps of 64 predecessors, their data and rates, and
    8 values); a first-written byte per node; a multiple of 16."""
    cp = 32 * slots
    rank_words = slots // 2 if slots > 1 else 1
    floats = ((N * cp + -(-N * cp // 2)) if rows_in_smem else 0) + 4 * cp + 96 * rank_words \
        + 2 * T + 9 * (3 * 64 + 8) + -(-N // 4)
    return 4 * (-(-floats // 4) * 4)


def makespan_plan(B: int, P: int, T: int, N: int, C: int, sm_count: int, max_smem: int,
                  rows_in_smem: bool | None = None) -> MakespanPlan:
    """The launch of ``B`` instances of ``P`` candidates on a card of
    ``sm_count`` SMs that allows ``max_smem`` bytes a block.  The rows go to
    shared memory (one warp a block) when they fit and there are no more
    candidates than SMs; otherwise they stay in L2, and up to
    :data:`MAX_WARPS` candidates share a block so that the candidates spread
    evenly over the SMs.  ``rows_in_smem`` forces the place (for measuring
    both).  Raises on a CMAX or T the kernel cannot take."""
    slots = next((s for s in WARP_SLOTS if 32 * s >= C), None)
    if slots is None:
        raise _build.KernelInputError(f"CMAX={C} exceeds the kernel's {32 * WARP_SLOTS[-1]} core slots")
    cands = B * P
    fits = warp_smem(T, N, slots, True) <= max_smem
    if rows_in_smem is None:
        rows_in_smem = fits and cands <= sm_count
    if rows_in_smem and not fits:
        raise _build.KernelInputError(f"{N} rows of {32 * slots} slots and T={T} need "
                         f"{warp_smem(T, N, slots, True)} B of shared memory (> {max_smem})")
    per_warp = warp_smem(T, N, slots, rows_in_smem)
    if per_warp > max_smem:
        raise _build.KernelInputError(f"T={T} needs {per_warp} B of shared memory per candidate (> {max_smem})")
    warps = 1 if rows_in_smem else min(MAX_WARPS, max(1, -(-cands // sm_count)), max_smem // per_warp)
    return MakespanPlan(slots=slots, warps=warps, blocks=-(-cands // warps), smem=warps * per_warp,
                        rows_in_smem=rows_in_smem)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared."""
    lib = _build.load("makespan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.population_makespan.argtypes = [ptr] * 16 + [i32] * 9 + [ctypes.c_longlong, ptr]
    lib.population_makespan.restype = i32
    lib.population_makespan_warp_smem.argtypes = [i32] * 4
    lib.population_makespan_warp_smem.restype = ctypes.c_longlong
    lib.population_makespan_max_smem.argtypes = []
    lib.population_makespan_max_smem.restype = ctypes.c_longlong
    return lib


_KERNEL_DTYPES = {
    "durations": torch.float32, "cores": torch.int32, "data": torch.float32,
    "feasible": torch.uint8, "release": torch.float32, "deadline": torch.float32,
    "pred_matrix": torch.int32, "dtr": torch.float32, "init_free": torch.float32,
    "node_cores": torch.int32,
}


def population_makespan_cuda(
    assignments: torch.Tensor,  # [P, T] or [B, P, T] int32
    *,
    durations: torch.Tensor,
    cores: torch.Tensor,
    data: torch.Tensor,
    feasible: torch.Tensor,
    release: torch.Tensor,
    pred_matrix: torch.Tensor,
    dtr: torch.Tensor,
    init_free: torch.Tensor,
    node_cores: torch.Tensor | None = None,
    deadline: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel ``csrc/makespan.cu`` on PyTorch's current stream, or,
    for tensors on the CPU, :func:`population_makespan_ref`.

    Takes exactly the kernel's types (assignments and the integer arrays
    int32, ``feasible`` uint8, the rest float32), contiguous, all on one
    device, on the CPU as on the card, and raises on anything else and on
    shapes beyond the kernel's launch limits.  Same results either way."""
    if node_cores is None:
        node_cores = _default_node_cores(init_free)
    batched, a, arr = _batched(assignments, dict(
        durations=durations, cores=cores, data=data, feasible=feasible, release=release,
        pred_matrix=pred_matrix, dtr=dtr, init_free=init_free, node_cores=node_cores,
        deadline=deadline,
    ))
    B, P, T = a.shape
    N, C = arr["init_free"].shape[-2:]
    maxp = arr["pred_matrix"].shape[-1]
    shapes = {
        "durations": (B, T, N), "cores": (B, T), "data": (B, T), "feasible": (B, T, N),
        "release": (B, T), "deadline": (B, T), "pred_matrix": (B, T, maxp),
        "dtr": (B, N, N), "init_free": (B, N, C), "node_cores": (B, N),
    }
    device = a.device
    if device.type not in ("cuda", "cpu"):
        raise _build.KernelInputError(f"population_makespan_cuda takes CUDA or CPU tensors, got {device}")
    if a.dtype != torch.int32 or not a.is_contiguous():
        raise _build.KernelInputError("assignments must be contiguous int32")
    for k, t in arr.items():
        if t is None:
            continue
        if t.device != device or t.dtype != _KERNEL_DTYPES[k] or not t.is_contiguous():
            raise _build.KernelInputError(
                f"{k}: need contiguous {_KERNEL_DTYPES[k]} on {device}, "
                f"got {t.dtype} on {t.device}"
            )
        if tuple(t.shape) != shapes[k]:
            raise _build.KernelInputError(f"{k}: shape {tuple(t.shape)} != {shapes[k]}")
    if device.type == "cpu":
        return population_makespan_ref(
            assignments, durations=durations, cores=cores, data=data, feasible=feasible,
            release=release, pred_matrix=pred_matrix, dtr=dtr, init_free=init_free,
            node_cores=node_cores, deadline=deadline,
        )
    if B * P > 2**31 - 1:
        raise _build.KernelInputError(f"{B} x {P} candidates exceed the kernel grid's 2**31 - 1 warps")
    if max(T * N, N * N, N * 1024, T * maxp) >= 2**31:
        raise _build.KernelInputError(f"T={T}, N={N}, MAXP={maxp}: an instance's tables exceed the kernel's 32-bit indices")

    makespan, violations = _on_card(a, arr)
    population_makespan_cuda.launches += int(B * P > 0)
    if not batched:
        return makespan[0], violations[0]
    return makespan, violations


population_makespan_cuda.launches = 0


def _on_card(a: torch.Tensor, arr: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Plan and launch on ``a``'s card.  The library queries and launches on
    the current device, so ``a``'s is made current for both: a stripe of a
    family on a second card launches there and not on the first."""
    B, P, T = a.shape
    N, C = arr["init_free"].shape[-2:]
    with torch.cuda.device(a.device):
        return _launch(a, arr, _plan(B, P, T, N, C, a.device.index))


@functools.lru_cache(maxsize=64)
def _plan(B: int, P: int, T: int, N: int, C: int, device: int) -> MakespanPlan:
    """The plan of one shape on one card, kept per shape: the GA asks for the
    same one every generation."""
    lib = _library()
    max_smem = lib.population_makespan_max_smem()  # the card's opt-in limit
    if max_smem < 0:
        _build.check(lib, int(-max_smem), "population_makespan shared-memory query")
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    return makespan_plan(B, P, T, N, C, sm_count, max_smem)


def _launch(a: torch.Tensor, arr: dict, plan: MakespanPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on checked CUDA tensors (``a [B, P, T]`` and
    the batched arrays) by ``plan``; returns ``(makespan, violations)``
    ``[B, P]``.  The wrapper's device path, and what ``chip_smoke.py`` times
    with either place of the rows."""
    B, P, T = a.shape
    N, C = arr["init_free"].shape[-2:]
    lib = _library()
    if lib.population_makespan_warp_smem(T, N, plan.slots, int(plan.rows_in_smem)) * plan.warps != plan.smem:
        raise _build.KernelInputError(f"{plan} does not match the kernel's shared-memory layout")
    makespan = torch.empty(B, P, dtype=torch.float32, device=a.device)
    violations = torch.empty(B, P, dtype=torch.float32, device=a.device)
    if B * P == 0:
        return makespan, violations
    # scratch: the initial rows' u16 ranks, and on the L2 path each
    # candidate's rows and ranks, rows padded to 32 * slots
    cp = 32 * plan.slots
    init_rank = torch.empty(B, N, cp, dtype=torch.int16, device=a.device)
    core_free = core_rank = None
    if not plan.rows_in_smem:
        core_free = torch.empty(B, P, N, cp, dtype=torch.float32, device=a.device)
        core_rank = torch.empty(B, P, N, cp, dtype=torch.int16, device=a.device)
    dl = arr["deadline"]
    err = lib.population_makespan(
        a.data_ptr(), arr["durations"].data_ptr(), arr["cores"].data_ptr(),
        arr["data"].data_ptr(), arr["feasible"].data_ptr(), arr["release"].data_ptr(),
        None if dl is None else dl.data_ptr(), arr["pred_matrix"].data_ptr(),
        arr["dtr"].data_ptr(), arr["init_free"].data_ptr(), init_rank.data_ptr(),
        arr["node_cores"].data_ptr(), makespan.data_ptr(), violations.data_ptr(),
        None if core_free is None else core_free.data_ptr(),
        None if core_rank is None else core_rank.data_ptr(),
        B, P, T, N, C, arr["pred_matrix"].shape[-1], plan.slots, plan.warps, int(plan.rows_in_smem),
        plan.smem, torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(lib, err, "population_makespan launch")
    return makespan, violations
