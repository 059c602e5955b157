"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. build every kernel under src/repro_torch/kernels/csrc with nvcc (sm_90a);
2. hold each kernel against its plain PyTorch version on the card, exactly,
   at the shapes the main path gives it, and time both with CUDA events;
3. the Table IX GA: ``ga`` on a 500-node x 500-task problem at the ``ga()``
   defaults (population 64, 60 generations), engine ``auto`` on ``cuda``;
   every generation's fitness must go through the kernel, the schedule must
   be valid, and the f32 oracle must re-score the best assignment to the
   kernel's makespan;
4. ``ga_sweep`` over eight such instances (seeds 0-7) through the batched
   kernel, with the same checks;
5. the same GA through the plain version, and a ``torch.profiler`` pass
   over the kernel GA that splits its wall time into device kernel time by
   kernel name and the rest.

The last lines are the kernels' record (JSON), the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.  Needs one
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and f32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
GA = {"pop_size": 64, "generations": 60}
SWEEP_SEEDS = range(8)
KEYS = ("durations", "cores", "data", "feasible", "release", "pred_matrix", "dtr",
        "init_free", "node_cores")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_assignments(problem, pop: int, seed: int) -> np.ndarray:
    """Candidates over each task's feasible nodes (node 0 where none is)."""
    rng = np.random.default_rng(seed)
    feas = problem.feasible
    A = np.zeros((pop, problem.num_tasks), np.int32)
    for j in range(problem.num_tasks):
        ok = np.flatnonzero(feas[j])
        A[:, j] = rng.choice(ok, pop) if ok.size else 0
    return A


def makespan_work(A: torch.Tensor, kw: dict) -> tuple[int, int]:
    """(bytes, operations) that one makespan call on ``A [P, T]`` needs with
    this data, whatever the implementation.

    Bytes: the assignments, the per-task vectors (cores, data, release,
    deadline) and the predecessor lists read once, the two outputs written
    once, and of the tables only the entries this population reaches: the
    durations and feasibility of each distinct (task, node) pair, the rate
    of each distinct (pred node, node) pair that a cross-node edge uses, and
    the initial core-free row and core count of each node used.
    Operations: per candidate and task, a linear selection of the c-th
    smallest of CMAX free times and a CMAX-wide overwrite of the c smallest
    (2*CMAX), and four more (release max, start max, add the duration, the
    feasibility or deadline test); per candidate and edge, a divide, an add
    and a max across nodes, one max on the same node."""
    P, T = A.shape
    N, C = kw["init_free"].shape
    a = A.long()
    preds = kw["pred_matrix"].long()
    q_task, q_slot = torch.nonzero(preds >= 0, as_tuple=True)  # every edge p -> j
    p_node = a[:, preds[q_task, q_slot]]  # [P, E]
    j_node = a[:, q_task]
    cross = p_node != j_node
    n_cross, n_edges = int(cross.sum()), P * q_task.numel()
    pairs_tn = torch.unique(torch.arange(T, device=a.device) * N + a).numel()
    pairs_nn = torch.unique((p_node * N + j_node)[cross]).numel()
    nodes = torch.unique(a).numel()
    per_task = 3 + (kw["deadline"] is not None)
    nbytes = (
        A.numel() * 4 + 2 * P * 4 + per_task * T * 4 + preds.numel() * 4
        + pairs_tn * (4 + 1) + pairs_nn * 4 + nodes * (C * 4 + 4)
    )
    ops = P * T * (2 * C + 4) + 3 * n_cross + (n_edges - n_cross)
    return nbytes, ops


def makespan_bound_ms(A: torch.Tensor, kw: dict) -> tuple[float, str, int, int]:
    """Least time an H100 could take for the makespan of ``A [P, T]`` or of
    a family ``A [B, P, T]`` (see :func:`makespan_work`): its bytes at the
    HBM rate against its operations at the f32 rate, the larger."""
    if A.dim() == 2:
        A, kw = A[None], {k: None if v is None else v[None] for k, v in kw.items()}
    nbytes = ops = 0
    for b in range(A.shape[0]):
        nb, op = makespan_work(A[b], {k: None if v is None else v[b] for k, v in kw.items()})
        nbytes, ops = nbytes + nb, ops + op
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations", nbytes, ops


def device_time_breakdown(run) -> dict:
    """Run ``run()`` under ``torch.profiler`` and split its wall time into
    the device's kernel time, by kernel name, and the rest (host work and
    device idle).  Kernels of one stream run one at a time, so their
    durations add up to the device's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if by_name else None,  # None: the profiler saw no kernel
        "device_idle_share": 1 - busy_ms / wall_ms if by_name else None,
        "kernels": [{"name": n[:80], "count": c, "ms": ms} for n, (c, ms) in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    from repro_torch.core import (
        Constraints,
        Workload,
        build_problem,
        evaluate_assignment,
        ga,
        ga_sweep,
        mri_system,
        mri_workload,
        random_layered_workflow,
        synthetic_system,
        synthetic_workload,
        verify_schedule,
    )
    from repro_torch.engine import pack, population_fitness_fn, stack_packed
    from repro_torch.kernels import _build
    from repro_torch.kernels.makespan import population_makespan_cuda, population_makespan_ref

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"build: {sorted(seconds)} in {time.perf_counter() - t0:.2f} s "
          f"(per source: {json.dumps({k: round(v, 2) for k, v in seconds.items()})})", flush=True)
    for name in seconds:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    # 2. kernel against plain version -----------------------------------------
    def table9(seed: int):
        return build_problem(synthetic_system(500, seed=seed), synthetic_workload(500, seed=seed))

    t0 = time.perf_counter()
    table9_main = table9(500)
    constrained = build_problem(
        synthetic_system(20, seed=5),
        synthetic_workload(20, seed=5, num_workflows=2),
        Constraints(deadline={"W0": 9.0}),
    )
    cases = [
        ("mri", build_problem(mri_system(), mri_workload()), 16),
        ("layered_40x8", build_problem(synthetic_system(8, seed=4),
                                       Workload((random_layered_workflow(40, seed=4, max_cores=8),))), 64),
        ("deadline_20x20", constrained, 64),
        ("table9_500x500", table9_main, 64),
    ]
    print(f"problems built in {time.perf_counter() - t0:.2f} s", flush=True)
    max_err = 0.0
    record = None
    for name, problem, pop in cases:
        packed = pack(problem, pad=False)
        arrays = packed.device_arrays(dev)
        kw = {k: arrays[k] for k in KEYS}
        kw["deadline"] = arrays["deadline"] if packed.constrained else None
        A = torch.from_numpy(random_assignments(problem, pop, seed=len(name))).to(dev)
        mk_k, v_k = population_makespan_cuda(A, **kw)
        mk_p, v_p = population_makespan_ref(A, **kw)
        torch.cuda.synchronize()
        check(torch.equal(mk_k, mk_p) and torch.equal(v_k, v_p), f"{name}: kernel == plain version")
        check(bool(torch.isfinite(mk_k).all()), f"{name}: finite makespans")
        if packed.constrained:
            check(bool((v_k > 0).any()), f"{name}: some deadline is missed")
        max_err = max(max_err, float((mk_k - mk_p).abs().max()), float((v_k - v_p).abs().max()))
        ms = cuda_ms(lambda: population_makespan_cuda(A, **kw), reps=20)
        plain_ms = cuda_ms(lambda: population_makespan_ref(A, **kw), reps=3, warmup=1)
        bound_ms, bound_by, nbytes, ops = makespan_bound_ms(A, kw)
        print(f"makespan {name}: P={pop} bucket={packed.bucket} kernel == plain exactly; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
              f"{nbytes} B, {ops} ops)",
              flush=True)
        if name == "table9_500x500":
            record = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}

    sweep_problems = [table9(s) for s in SWEEP_SEEDS]
    stacked, bucket = stack_packed(sweep_problems, device=dev)
    kw = {k: stacked[k] for k in KEYS}
    kw["deadline"] = None
    A = torch.zeros(len(sweep_problems), GA["pop_size"], bucket[0], dtype=torch.int32)
    for b, problem in enumerate(sweep_problems):
        A[b, :, : problem.num_tasks] = torch.from_numpy(random_assignments(problem, GA["pop_size"], b))
    A = A.to(dev)
    mk_k, v_k = population_makespan_cuda(A, **kw)
    mk_p, v_p = population_makespan_ref(A, **kw)
    torch.cuda.synchronize()
    check(torch.equal(mk_k, mk_p) and torch.equal(v_k, v_p), "batched family: kernel == plain version")
    batch_ms = cuda_ms(lambda: population_makespan_cuda(A, **kw), reps=10)
    bound_ms, bound_by, nbytes, ops = makespan_bound_ms(A, kw)
    print(f"makespan batched {len(sweep_problems)}x500x500: bucket={bucket} kernel == plain exactly; "
          f"kernel {batch_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {ops} ops)",
          flush=True)

    # 3. single GA: the main path -----------------------------------------------
    population_makespan_cuda.launches = 0
    t0 = time.perf_counter()
    res = ga(table9_main, backend="auto", device="cuda", seed=0, **GA)
    torch.cuda.synchronize()
    ga_s = time.perf_counter() - t0
    launches = population_makespan_cuda.launches
    check(launches == GA["generations"] + 1, f"GA made {launches} kernel launches, expected 61")
    check(verify_schedule(table9_main, res.schedule) == [], "GA schedule is valid")
    best = res.schedule.assignment
    _, mk_best = population_fitness_fn(table9_main, engine="cuda", device="cuda")(best[None])
    oracle32 = evaluate_assignment(table9_main, best, dtype=np.float32).makespan
    check(float(mk_best[0]) == oracle32, "f32 oracle re-scores the GA's best to the kernel's makespan")
    check(np.isfinite(res.history).all() and (np.diff(res.history) <= 0).all(), "GA history")
    print(f"ga 500x500 pop={GA['pop_size']} gens={GA['generations']}: {ga_s:.3f} s wall, "
          f"makespan {res.schedule.makespan:.4f}, {launches} kernel launches, "
          f"history {res.history[0]:.2f} -> {res.history[-1]:.2f}", flush=True)

    # 4. batched sweep ------------------------------------------------------------
    population_makespan_cuda.launches = 0
    t0 = time.perf_counter()
    results = ga_sweep(sweep_problems, backend="auto", device="cuda", seed=0, **GA)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_launches = population_makespan_cuda.launches
    check(sweep_launches == GA["generations"] + 1, f"ga_sweep made {sweep_launches} launches, expected 61")
    for problem, r in zip(sweep_problems, results):
        check(verify_schedule(problem, r.schedule) == [], "sweep schedule is valid")
        _, mk_best = population_fitness_fn(problem, engine="cuda", device="cuda")(r.schedule.assignment[None])
        oracle32 = evaluate_assignment(problem, r.schedule.assignment, dtype=np.float32).makespan
        check(float(mk_best[0]) == oracle32, "f32 oracle re-scores each sweep best to the kernel's")
    print(f"ga_sweep {len(sweep_problems)}x(500x500) pop={GA['pop_size']} gens={GA['generations']}: "
          f"{sweep_s:.3f} s wall, {sweep_launches} kernel launches, makespans "
          f"{[round(r.schedule.makespan, 2) for r in results]}", flush=True)

    # the same GA through the plain version, as a yardstick of the path
    t0 = time.perf_counter()
    plain_res = ga(table9_main, backend="torch", device="cuda", seed=0, **GA)
    torch.cuda.synchronize()
    print(f"ga 500x500 through the plain version: {time.perf_counter() - t0:.3f} s wall, "
          f"makespan {plain_res.schedule.makespan:.4f}", flush=True)

    # where the GA's time goes: its kernels on the device against the wall
    t0 = time.perf_counter()
    evaluate_assignment(table9_main, res.schedule.assignment)
    oracle_ms = 1e3 * (time.perf_counter() - t0)
    breakdown = device_time_breakdown(
        lambda: ga(table9_main, backend="auto", device="cuda", seed=0, **GA)
    )
    breakdown["oracle_rescore_ms"] = oracle_ms
    print(json.dumps({"ga_profile": breakdown}), flush=True)

    kernels = [{
        "name": "population_makespan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/makespan.cu",
        "replaces": "src/repro/kernels/makespan.py:168",
        "launches": launches,
        "sweep_launches": sweep_launches,
        "max_abs_err": max_err,
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"],
        "bound_by": record["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
