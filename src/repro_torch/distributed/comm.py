"""The exchanges of a sharded step over ``torch.distributed``, and which
slice of a tensor each device holds.

The reference has no counterpart: there XLA's SPMD partitioner inserts the
collectives of a jitted step from the shardings of its arguments.  The
port's sharded program (``distributed/program.py``) calls its backend at
each point where a layout changes.  :class:`DistComm` is the backend of a
run over several processes, one a device of the mesh, as ``CountingComm``
is the backend of the dry-run's plan.  It has the same methods and tells the
counters the same kind and result bytes at each call
(``kernels/work.py::collective``), so an ``OpCounter`` over a real step
counts what the dry-run counts.  The data it moves (the collective itself,
the copies that put the chunks in order, a staged copy through the host)
runs outside the counters.

* **Groups.** One process group for each set of axes: the devices that
  share their coordinates on the other axes.  Rank r sits at
  ``launch/mesh.py::coords(mesh, r)``.
* **Order.** A dimension split over axes ``(a, b)`` holds at device
  ``(i_a, i_b)`` the chunk ``i_a * n_b + i_b``: the spec's order, as JAX
  lays it out.  A group's members are in rank order, so the chunks are put
  back in the spec's order after a gather and before a reduce-scatter.
* **Backend.** The caller names it: ``nccl`` for cards, ``gloo`` for the
  CPU.  ``staged=True`` copies each exchange's tensors through the host
  (gloo over CUDA tensors); nothing switches on failure.
* :meth:`DistComm.reduce_scalars` sums a few scalars (the loss's target
  count, the gradient norm's partial sums) over axes and is not counted:
  the dry-run's plan has no such exchange, and ``CountingComm``'s returns
  its input.

:func:`local_slices` is one device's entry of the reference's
``NamedSharding(mesh, spec).devices_indices_map(shape)``, :func:`take_local`
that slice of a whole tensor, and :class:`NamedSharding` a leaf's layout
for the checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from collections.abc import Iterator, Mapping, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.distributed.sharding import Spec, axes_of, local_shape
from repro_torch.kernels import work
from repro_torch.launch.mesh import Mesh, coords, rank_of

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def shard_index(mesh: Mesh, axes: Sequence[str], at: Mapping[str, int]) -> int:
    """The chunk a device at coordinates ``at`` holds of a dimension split
    over ``axes`` (in the spec's order: the first axis varies slowest)."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + at[a]
    return i


def local_slices(shape, spec: Spec, mesh: Mesh, rank: int) -> tuple[slice, ...]:
    """The slice of a tensor of ``shape`` laid out by ``spec`` that device
    ``rank`` holds (``devices_indices_map`` of that device)."""
    at = dict(zip(mesh.axis_names, coords(mesh, rank)))
    out = []
    for n, entry in zip(local_shape(tuple(shape), tuple(spec), mesh), spec):
        i = shard_index(mesh, axes_of(entry), at)
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


def take_local(t: torch.Tensor, spec: Spec, mesh: Mesh, rank: int) -> torch.Tensor:
    """Device ``rank``'s slice of the whole tensor ``t``, a tensor of its own."""
    return t[local_slices(t.shape, spec, mesh, rank)].clone()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf laid out by ``spec`` on ``comm``'s mesh as ``comm``'s device
    holds it (the reference's ``NamedSharding``, seen from one process);
    ``comm`` gathers the slices whole (a save) and scatters them (a
    restore)."""

    comm: DistComm
    spec: Spec

    @property
    def rank(self) -> int:
        return self.comm.rank


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class _Group:
    group: object  # a torch.distributed ProcessGroup
    ranks: tuple[int, ...]  # the members, in rank order (the group's own)
    entry_of_pos: tuple[int, ...]  # member p holds the spec's chunk entry_of_pos[p]
    pos_of_entry: tuple[int, ...]


class DistComm:
    """The exchanges of device ``rank`` of ``mesh`` over the default process
    group (which ``torch.distributed.init_process_group`` made, with
    ``backend`` and the mesh's size).  Builds every process group of the
    mesh's axes at once: each process must make them, in one order."""

    def __init__(self, mesh: Mesh, rank: int, backend: str, *, staged: bool = False):
        if not dist.is_initialized():
            raise RuntimeError("DistComm needs torch.distributed's default group: call init_process_group first")
        if dist.get_world_size() != mesh.size or dist.get_rank() != rank:
            raise ValueError(f"rank {dist.get_rank()} of {dist.get_world_size()} processes is not device {rank} "
                             f"of a mesh of {mesh.size}")
        if dist.get_backend() != backend:
            raise ValueError(f"the default group's backend is {dist.get_backend()!r}, not {backend!r}")
        self.mesh, self.rank, self.backend, self.staged = mesh, rank, backend, staged
        self.coords: dict[str, int] = dict(zip(mesh.axis_names, coords(mesh, rank)))
        self._groups: dict[tuple[str, ...], tuple[object, tuple[int, ...]]] = {}
        self._orders: dict[tuple[str, ...], _Group] = {}
        names = mesh.axis_names
        live = [a for a in names if mesh.shape[a] > 1]
        for k in range(1, len(live) + 1):
            for axes in itertools.combinations(live, k):
                others = [a for a in names if a not in axes]
                for fixed in itertools.product(*(range(mesh.shape[a]) for a in others)):
                    at = dict(zip(others, fixed))
                    ranks = []
                    for member in itertools.product(*(range(mesh.shape[a]) for a in axes)):
                        at.update(zip(axes, member))
                        ranks.append(rank_of(mesh, [at[a] for a in names]))
                    ranks = tuple(sorted(ranks))
                    group = dist.new_group(list(ranks))
                    if rank in ranks:
                        self._groups[axes] = (group, ranks)

    # -- groups and offsets ------------------------------------------------------
    def size(self, axes: Sequence[str]) -> int:
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n

    def _group(self, axes: Sequence[str]) -> _Group | None:
        """The group over the live ``axes``, with its members' chunks in the
        order ``axes`` gives (None: no axis of more than one device)."""
        live = tuple(a for a in axes if self.mesh.shape[a] > 1)
        if not live:
            return None
        g = self._orders.get(live)
        if g is None:
            if len(set(live)) != len(live):
                raise ValueError(f"axes {axes} name an axis twice")
            group, ranks = self._groups[tuple(a for a in self.mesh.axis_names if a in live)]
            entry = tuple(shard_index(self.mesh, live, dict(zip(self.mesh.axis_names, coords(self.mesh, r))))
                          for r in ranks)
            pos = [0] * len(entry)
            for p, e in enumerate(entry):
                pos[e] = p
            g = self._orders[live] = _Group(group, ranks, entry, tuple(pos))
        return g

    @contextlib.contextmanager
    def _uncounted(self) -> Iterator[None]:
        with _disable_current_modes(), torch.no_grad():
            yield

    def _io(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the backend reads it: the host when staged."""
        x = x.detach()
        return x.cpu() if self.staged and x.device.type != "cpu" else x

    @staticmethod
    def _back(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return out if out.device == like.device else out.to(like.device)

    @staticmethod
    def _reorder(t: torch.Tensor, order: tuple[int, ...]) -> torch.Tensor:
        if list(order) == list(range(len(order))):
            return t
        return t.index_select(0, torch.tensor(order, device=t.device))

    # -- the exchanges (CountingComm's interface) ---------------------------------
    def _all_gather(self, x: torch.Tensor, dim: int, axes: Sequence[str]) -> torch.Tensor:
        g = self._group(axes)
        if g is None:
            return x
        n, src = len(g.ranks), self._io(x).contiguous()
        buf = src.new_empty(n * src.numel())
        dist.all_gather_into_tensor(buf, src.view(-1), group=g.group)
        buf = self._reorder(buf.view(n, *src.shape), g.pos_of_entry)
        shape = (*src.shape[:dim], n * src.shape[dim], *src.shape[dim + 1:])
        return self._back(buf.movedim(0, dim).reshape(shape).contiguous(), x)  # contiguous, as on meta

    def all_gather(self, x: torch.Tensor, dim: int, axes: tuple[str, ...]) -> torch.Tensor:
        with self._uncounted():
            out = self._all_gather(x, dim, axes)
        work.collective("all-gather", _nbytes(out), out)
        return out

    def reduce_scatter(self, x: torch.Tensor, dim: int, axes: tuple[str, ...]) -> torch.Tensor:
        with self._uncounted():
            g = self._group(axes)
            if g is None:
                out = x
            else:
                n, src = len(g.ranks), self._io(x)
                m = src.shape[dim] // n
                chunks = src.reshape(*src.shape[:dim], n, m, *src.shape[dim + 1:]).movedim(dim, 0)
                chunks = self._reorder(chunks, g.entry_of_pos).contiguous()
                res = chunks.new_empty(chunks.shape[1:])
                dist.reduce_scatter_tensor(res.view(-1), chunks.view(-1), op=dist.ReduceOp.SUM, group=g.group)
                out = self._back(res, x)
        work.collective("reduce-scatter", _nbytes(out), out)
        return out

    def _all_reduce(self, x: torch.Tensor, axes: Sequence[str], op: str) -> torch.Tensor:
        g = self._group(axes)
        if g is None:
            return x
        out = self._io(x).clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=_OPS[op], group=g.group)
        return self._back(out, x)

    def all_reduce(self, x: torch.Tensor, axes: tuple[str, ...], op: str = "sum") -> torch.Tensor:
        """``x`` summed (``op="sum"``) or its largest value taken (``"max"``)
        over the devices of ``axes``."""
        with self._uncounted():
            out = self._all_reduce(x, axes, op)
        work.collective("all-reduce", _nbytes(out), out)
        return out

    def gather_to(self, x: torch.Tensor, shape, axes: Mapping[int, tuple[str, ...]] | None = None) -> torch.Tensor:
        """``x`` gathered to ``shape`` over ``axes`` (``{dim: axes}``, each
        dimension that grows); counted as one all-gather, as the dry-run
        counts it."""
        if axes is None:
            raise ValueError("DistComm.gather_to needs the axes each dimension is gathered over")
        with self._uncounted():
            out = x
            for dim, a in sorted(axes.items()):
                if out.shape[dim] < shape[dim]:
                    out = self._all_gather(out, dim, a)
        if tuple(out.shape) != tuple(shape):
            raise ValueError(f"gathering {tuple(x.shape)} over {dict(axes)} gives {tuple(out.shape)}, not {tuple(shape)}")
        work.collective("all-gather", _nbytes(out), out)
        return out

    # -- beyond the plan -------------------------------------------------------------
    def reduce_scalars(self, values: Sequence[torch.Tensor], axes: tuple[str, ...]) -> list[torch.Tensor]:
        """Each scalar of ``values`` summed over ``axes``, in one exchange
        that the counters do not see (module docstring)."""
        if not values or self._group(axes) is None:
            return list(values)
        with self._uncounted():
            summed = self._all_reduce(torch.stack([v.detach().float() for v in values]), axes, "sum")
            return [s.to(v.dtype) for s, v in zip(summed.unbind(0), values)]

    def peer(self, axis: str, step: int) -> int | None:
        """The rank ``step`` devices along ``axis`` from this one (None past
        either end)."""
        at = dict(self.coords)
        at[axis] += step
        if not 0 <= at[axis] < self.mesh.shape[axis]:
            return None
        return rank_of(self.mesh, [at[a] for a in self.mesh.axis_names])

    def send(self, x: torch.Tensor, peer: int) -> None:
        """``x`` to device ``peer`` (one side of the reference's
        ``ppermute``: a ``collective-permute`` of ``x``'s bytes)."""
        with self._uncounted():
            dist.send(self._io(x).contiguous(), dst=peer)
        work.collective("collective-permute", _nbytes(x))

    def recv(self, like: torch.Tensor, peer: int) -> torch.Tensor:
        """A tensor of ``like``'s shape, dtype and device from ``peer``."""
        with self._uncounted():
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if self.staged else like.device)
            dist.recv(buf, src=peer)
            return self._back(buf, like)

    def barrier(self) -> None:
        dist.barrier()

    def gather_whole(self, t: torch.Tensor, spec: Spec, dst: int | None = None) -> torch.Tensor | None:
        """The whole tensor of which ``t`` is this device's slice under
        ``spec``: on every device, or with ``dst`` on device ``dst`` alone
        (None elsewhere), from one gather of every device's slice, on the
        host when staged (a checkpoint's writer wants it there)."""
        if dst is None:
            for dim, entry in enumerate(spec):
                if self._group(axes_of(entry)) is not None:
                    t = self.all_gather(t, dim, axes_of(entry))
            return t
        if all(self._group(axes_of(entry)) is None for entry in spec):
            return t if self.rank == dst else None
        shape = tuple(n * self.size(axes_of(entry)) for n, entry in zip(t.shape, spec))
        with self._uncounted():
            src = self._io(t).contiguous()
            parts = [torch.empty_like(src) for _ in range(self.mesh.size)] if self.rank == dst else None
            dist.gather(src, parts, dst=dst)
            if parts is None:
                out = None
            else:
                out = src.new_empty(shape)
                for r, part in enumerate(parts):
                    out[local_slices(shape, spec, self.mesh, r)] = part
        work.collective("gather", _nbytes(t) * self.mesh.size)
        return out

    def scatter_whole(self, whole: torch.Tensor | None, spec: Spec, like: torch.Tensor, src: int = 0
                      ) -> torch.Tensor:
        """This device's slice under ``spec`` of the tensor ``whole`` that
        device ``src`` holds (the others pass None); in the shape, dtype and
        device of ``like``."""
        with self._uncounted():
            out = torch.empty(like.shape, dtype=like.dtype, device="cpu" if self.staged else like.device)
            parts = None
            if self.rank == src:
                whole = whole.to(out.device)
                parts = [whole[local_slices(whole.shape, spec, self.mesh, r)].contiguous()
                         for r in range(self.mesh.size)]
            dist.scatter(out, parts, src=src)
            return self._back(out, like)

    def sharding(self, spec: Spec) -> NamedSharding:
        return NamedSharding(self, tuple(spec))
