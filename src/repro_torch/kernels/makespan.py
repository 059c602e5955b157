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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.select import kth_from_ranks, stable_ranks, update_from_ranks

_NEG = -1e30
_MAX_THREADS = 1024  # threads per block on Hopper


def _default_node_cores(init_free: torch.Tensor) -> torch.Tensor:
    # padding entries are "never free" (1e30); real cores start at 0
    return (init_free < 1e29).sum(dim=-1).clamp(min=1).to(torch.int32)


def _batched(assignments: torch.Tensor, arrays: dict) -> tuple[bool, torch.Tensor, dict]:
    """Give a single instance a leading instance axis of 1."""
    if assignments.dim() == 3:
        return True, assignments, arrays
    if assignments.dim() != 2:
        raise ValueError(f"assignments must be [P, T] or [B, P, T], got {tuple(assignments.shape)}")
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


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared."""
    lib = _build.load("makespan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.population_makespan.argtypes = [ptr] * 14 + [i32] * 6 + [ptr]
    lib.population_makespan.restype = i32
    lib.population_makespan_threads.argtypes = [i32]
    lib.population_makespan_threads.restype = i32
    lib.population_makespan_smem.argtypes = [i32, i32]
    lib.population_makespan_smem.restype = ctypes.c_longlong
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
        raise ValueError(f"population_makespan_cuda takes CUDA or CPU tensors, got {device}")
    if a.dtype != torch.int32 or not a.is_contiguous():
        raise ValueError("assignments must be contiguous int32")
    for k, t in arr.items():
        if t is None:
            continue
        if t.device != device or t.dtype != _KERNEL_DTYPES[k] or not t.is_contiguous():
            raise ValueError(
                f"{k}: need contiguous {_KERNEL_DTYPES[k]} on {device}, "
                f"got {t.dtype} on {t.device}"
            )
        if tuple(t.shape) != shapes[k]:
            raise ValueError(f"{k}: shape {tuple(t.shape)} != {shapes[k]}")
    if device.type == "cpu":
        return population_makespan_ref(
            assignments, durations=durations, cores=cores, data=data, feasible=feasible,
            release=release, pred_matrix=pred_matrix, dtr=dtr, init_free=init_free,
            node_cores=node_cores, deadline=deadline,
        )
    if B > 65535:
        raise ValueError(f"{B} instances exceed the kernel grid's 65535")

    lib = _library()
    threads = lib.population_makespan_threads(C)
    smem = lib.population_makespan_smem(T, threads)
    if threads > _MAX_THREADS:
        raise ValueError(f"CMAX={C} needs {threads} threads per block (> {_MAX_THREADS})")
    max_smem = lib.population_makespan_max_smem()  # the card's opt-in limit less static smem
    if max_smem < 0:
        _build.check(lib, int(-max_smem), "population_makespan shared-memory query")
    if smem > max_smem:
        raise ValueError(f"T={T} needs {smem} B of shared memory per block (> {max_smem})")

    makespan = torch.empty(B, P, dtype=torch.float32, device=device)
    violations = torch.empty(B, P, dtype=torch.float32, device=device)
    if B and P:
        core_free = torch.empty(B, P, N, C, dtype=torch.float32, device=device)
        dl = arr["deadline"]
        err = lib.population_makespan(
            a.data_ptr(), arr["durations"].data_ptr(), arr["cores"].data_ptr(),
            arr["data"].data_ptr(), arr["feasible"].data_ptr(), arr["release"].data_ptr(),
            None if dl is None else dl.data_ptr(), arr["pred_matrix"].data_ptr(),
            arr["dtr"].data_ptr(), arr["init_free"].data_ptr(), arr["node_cores"].data_ptr(),
            makespan.data_ptr(), violations.data_ptr(), core_free.data_ptr(),
            B, P, T, N, C, maxp, torch.cuda.current_stream(device).cuda_stream,
        )
        _build.check(lib, err, "population_makespan launch")
        population_makespan_cuda.launches += 1
    if not batched:
        return makespan[0], violations[0]
    return makespan, violations


population_makespan_cuda.launches = 0
