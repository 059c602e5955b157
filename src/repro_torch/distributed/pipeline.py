"""GPipe pipeline parallelism: a model's stacked blocks cut into stages, one
stage a device, microbatches passed from stage to stage.

Ported from the reference's ``repro/distributed/pipeline.py``.  Stage s
holds layers ``[s·L/S, (s+1)·L/S)`` (:func:`split_stages`).  The schedule is
GPipe's ``M + S − 1`` ticks over M microbatches: at tick t stage s runs its
blocks on microbatch ``t − s`` and sends the result to stage s + 1.  In the
reference every stage computes at every tick under ``shard_map`` and a
``ppermute`` shifts the activations one stage on; here each process holds
its own stage (a device of the mesh's ``stage_axis``), computes only at the
ticks that carry a microbatch, and the shift is a ``send`` to stage s + 1
and a ``recv`` from stage s − 1 (``distributed/comm.py::DistComm``).  The
last stage's outputs reach every stage through an all-reduce over the
stage axis of the outputs, zero on the other stages: the reference's
masked ``psum``.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping

import torch


def split_stages(stacked: Mapping[str, torch.Tensor] | torch.Tensor, num_stages: int):
    """``[L, ...]`` stacked block parameters (a tensor, or a mapping of
    them) -> ``[num_stages, L/S, ...]``."""

    def reshape(a: torch.Tensor) -> torch.Tensor:
        L = a.shape[0]
        if L % num_stages:
            raise ValueError(f"{L} layers do not split into {num_stages} stages")
        return a.reshape(num_stages, L // num_stages, *a.shape[1:])

    if isinstance(stacked, torch.Tensor):
        return reshape(stacked)
    return {k: reshape(v) for k, v in stacked.items()}


def pipeline_forward(block_fn: Callable, stage_params, x_micro: torch.Tensor, comm, *,
                     stage_axis: str = "stage") -> torch.Tensor:
    """The GPipe schedule; returns the last stage's ``[M, mb, S, d]`` outputs
    on every stage.  ``block_fn(stage_params, x) -> x`` runs this device's
    stage (``stage_params``: its own, e.g. row s of :func:`split_stages`);
    ``x_micro [M, mb, S, d]`` is the microbatch stream, which stage 0
    consumes (the other stages read only its shape and dtype)."""
    S = comm.mesh.shape[stage_axis]
    s = comm.coords[stage_axis]
    M = x_micro.shape[0]
    prev, nxt = comm.peer(stage_axis, -1), comm.peer(stage_axis, 1)
    outs = torch.zeros_like(x_micro)
    for t in range(M + S - 1):
        m = t - s  # the microbatch this stage holds at tick t
        if not 0 <= m < M:
            continue
        h = x_micro[m] if s == 0 else comm.recv(x_micro[0], prev)
        y = block_fn(stage_params, h)
        if nxt is not None:
            comm.send(y, nxt)
        else:
            outs[m] = y
    return comm.all_reduce(outs, (stage_axis,))
