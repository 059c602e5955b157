"""The multi-device instance axis: a stacked family striped over the local
devices of one kind.

The batch paths above the engine (``ga_sweep`` families, admission batch
groups, campaign batch groups) are parallel across *instances*: every
instance's fitness is row-independent.  This module stripes that instance
axis over the local devices of the requested kind, in one process: each
stripe keeps its slice of the stacked arrays on its own device, and one
fitness call copies each stripe's slice of the candidates there, launches
the makespan kernel and the objective on it, and gathers the results onto
the first stripe's device once every stripe has been launched, so that the
cards of a real multi-card host work at the same time.

Semantics are *pad-to-shard-multiple*: ``B`` instances over ``d`` stripes
pad to ``ceil(B/d)*d`` rows by replicating instance 0, and the replicas'
results are sliced off inside the fitness call, before anything observes
them.  :func:`choose_shards` prefers a divisor of ``B``, so the common case
pads nothing.  Every row's arithmetic is independent of the rows beside it
(the kernel runs one warp a candidate; the objective is elementwise; the
per-instance usage sum is reduced one row at a time,
``engine/packed.py::fitness_tensors``), so striped results are
**bit-identical** to the unsharded path, and one stripe is exactly the
unsharded path: both are ``engine/backends.py::_family_fitness``, over one
slice of the family or over one slice a stripe.

Stripes are the real devices of the kind: the cards for ``cuda``, the one
CPU for ``cpu``.  ``REPRO_TORCH_VIRTUAL_DEVICES=k`` makes ``k`` stripes
round-robin over those devices instead, named ``<device>/s<i>`` (``cpu/s3``,
``cuda:0/s1``), so the striped path runs on one device as it would on
``k``; the pack LRU (:func:`repro_torch.engine.packed.pack_cache`) counts
residency per stripe name.  ``REPRO_SHARD_DEVICES`` clamps the count that
``shard="auto"`` uses (``1`` turns striping off everywhere).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.workload_model import ScheduleProblem, problem_fingerprint
from repro_torch.engine.packed import (
    FITNESS_ARRAY_KEYS,
    Bucket,
    common_bucket,
    fitness_tensors,
    pack,
    pack_cache,
)

#: environment variable: stripes made round-robin over the real devices
VIRTUAL_DEVICES_ENV = "REPRO_TORCH_VIRTUAL_DEVICES"


class Stripe(NamedTuple):
    """One slot of the instance axis: its name (the pack LRU's residency
    key) and the device its arrays live on."""

    name: str
    device: torch.device


def _stripes(device) -> tuple[Stripe, ...]:
    """Every stripe of ``device``'s kind, real or virtual."""
    kind = torch.device(device).type
    if kind == "cuda":
        real = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        real = [torch.device("cpu")]
    else:
        raise ValueError(f"no instance stripes for device kind {kind!r} (cuda or cpu)")
    virtual = os.environ.get(VIRTUAL_DEVICES_ENV)
    if virtual is None or not real:
        return tuple(Stripe(str(d), d) for d in real)
    k = int(virtual)
    if k < 1:
        raise ValueError(f"{VIRTUAL_DEVICES_ENV} must be >= 1, got {k}")
    return tuple(Stripe(f"{real[i % len(real)]}/s{i}", real[i % len(real)]) for i in range(k))


def local_device_count(device="cuda") -> int:
    """Stripes available for instance striping on ``device``'s kind
    (clamped by ``REPRO_SHARD_DEVICES``; ``1`` disables sharding
    everywhere)."""
    n = len(_stripes(device))
    clamp = os.environ.get("REPRO_SHARD_DEVICES")
    if clamp is not None:
        n = min(n, max(int(clamp), 1))
    return n


def instance_mesh(devices: int, device="cuda") -> tuple[Stripe, ...]:
    """The first ``devices`` stripes of ``device``'s kind; raises when there
    are fewer."""
    avail = _stripes(device)
    if devices < 1 or devices > len(avail):
        raise ValueError(f"mesh wants {devices} devices, have {len(avail)}")
    return avail[:devices]


def choose_shards(batch: int, devices: int | None = None, *, device="cuda") -> int:
    """How many stripes to spread a ``batch``-instance family over.

    Prefers the largest count that divides ``batch`` (zero padding); falls
    back to all stripes with padding when ``batch`` is indivisible but
    larger than the fleet.  Batches of 0/1 instances and one-stripe hosts
    return 1: the caller then takes the unsharded path unchanged."""
    d = local_device_count(device) if devices is None else devices
    if batch <= 1 or d <= 1:
        return 1
    if batch < d:
        return batch  # one instance per stripe, no padding
    for cand in range(d, 1, -1):
        if batch % cand == 0:
            return cand
    return d


def pad_batch(batch: int, shards: int) -> int:
    """Instances after pad-to-shard-multiple (``ceil(batch/shards)*shards``)."""
    return -(-batch // shards) * shards


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedStack:
    """A stacked instance family resident across the stripes: the pack
    LRU's multi-device entry (each stripe's tensors stay alive as long as
    the entry)."""

    arrays: tuple[dict[str, torch.Tensor], ...]  # one dict per stripe, equal row counts
    stripes: tuple[Stripe, ...]
    bucket: Bucket
    instances: int  # real instances (<= padded)
    shards: int
    device_nbytes: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def padded(self) -> int:
        return sum(int(a["durations"].shape[0]) for a in self.arrays)

    @property
    def nbytes(self) -> int:
        return sum(self.device_nbytes.values())


def _note_device_stats(cache, per_stripe: dict[str, int], *, hit: bool) -> None:
    stats = cache.device_stats
    for stripe, nbytes in per_stripe.items():
        d = stats.setdefault(stripe, {"hits": 0, "misses": 0, "resident_bytes": 0})
        if hit:
            d["hits"] += 1
        else:
            d["misses"] += 1
            d["resident_bytes"] += nbytes


def stack_packed_sharded(
    problems: Sequence[ScheduleProblem],
    bucket: Bucket | None = None,
    *,
    shards: int | None = None,
    device="cuda",
    use_cache: bool = True,
) -> ShardedStack:
    """Stack an instance family and split it over ``shards`` stripes of
    ``device``'s kind, one equal slice of rows each.

    The result is memoised in the pack LRU by ``(member fingerprints,
    bucket, stripes)``: a campaign group or admission window that re-solves
    the same family reuses every stripe's tensors.  Members still go through
    :func:`repro_torch.engine.packed.pack`, so their host arrays are
    fingerprint-cached too."""
    if not problems:
        raise ValueError("cannot stack an empty problem family")
    d = choose_shards(len(problems), device=device) if shards is None else int(shards)
    if d < 1:
        raise ValueError(f"shard count must be >= 1, got {d}")
    stripes = instance_mesh(d, device)
    bucket = common_bucket(problems) if bucket is None else bucket
    B, Bp = len(problems), pad_batch(len(problems), d)
    cache = pack_cache()

    def build() -> ShardedStack:
        packs = [pack(p, bucket) for p in problems]
        packs += [packs[0]] * (Bp - B)  # pad-to-shard-multiple: replicate
        host = {k: np.stack([pp.numpy_arrays()[k] for pp in packs]) for k in FITNESS_ARRAY_KEYS}
        rows = Bp // d
        arrays = tuple(
            fitness_tensors({k: v[s * rows:(s + 1) * rows] for k, v in host.items()}, stripe.device)
            for s, stripe in enumerate(stripes)
        )
        nbytes = {
            stripe.name: sum(t.numel() * t.element_size() for t in arr.values())
            for stripe, arr in zip(stripes, arrays)
        }
        return ShardedStack(arrays=arrays, stripes=stripes, bucket=bucket, instances=B,
                            shards=d, device_nbytes=nbytes)

    with obs.TRACER.span(
        "engine.shard_stack", cat="engine",
        args={"instances": B, "shards": d, "bucket": "x".join(str(x) for x in bucket)},
    ):
        if not use_cache:
            # no residency accounting: this stack never enters the LRU, so
            # its bytes must not show up as (unreleasable) resident state
            return build()
        key = (
            "shard-stack",
            tuple(problem_fingerprint(p) for p in problems),
            bucket,
            tuple(s.name for s in stripes),
        )
        built = False

        def tracked_build() -> ShardedStack:
            nonlocal built
            built = True
            return build()

        stack = cache.get_or_build(key, tracked_build)
        _note_device_stats(cache, stack.device_nbytes, hit=not built)
        obs.METRICS.gauge("engine.shard.devices").set(d)
        obs.METRICS.counter("engine.shard.stacks").inc()
        obs.METRICS.counter("engine.shard.padded_instances").inc(Bp - B)
        return stack


def shard_population(assignments: torch.Tensor, devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """Split a ``[Bp, P, T]`` candidate batch into equal row slices, each
    copied to its device (a slice already there is not copied)."""
    rows = assignments.shape[0] // len(devices)
    return [
        assignments[s * rows:(s + 1) * rows].to(device, non_blocking=True)
        for s, device in enumerate(devices)
    ]


def sharded_batched_fitness(
    problems: Sequence[ScheduleProblem],
    weights=None,
    *,
    shards: int | None = None,
    engine: str = "auto",
    device="cuda",
) -> Callable:
    """Batched fitness striped over ``device``'s stripes:
    ``fitness(assignments [B, P, Tb]) -> (objective [B, P], makespan [B, P])``
    on the first stripe's device.

    Drop-in for the packed engines' ``batched_fitness`` (same ``.bucket`` /
    ``.num_instances`` / ``.shards`` attributes), through ``engine``'s
    makespan implementation, one launch a stripe, bit-identical in f32 to
    the unsharded path."""
    from repro_torch.engine.backends import ENGINES, _family_fitness, _weights

    eng = ENGINES.get(engine)
    if not eng.capabilities.supports_batch:
        raise ValueError(f"engine {eng.name!r} does not support batched families")
    stack = stack_packed_sharded(problems, shards=shards, device=device)
    return _family_fitness(
        [(arr, stripe.device) for arr, stripe in zip(stack.arrays, stack.stripes)],
        stack.instances, stack.bucket, _weights(weights),
        any(p.has_constraints for p in problems), type(eng).makespan_fn,
        f"{eng.name}-shard{stack.shards}",
    )
