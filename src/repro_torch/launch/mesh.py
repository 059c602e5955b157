"""Device meshes: named axes and their sizes.

The reference builds ``jax.sharding.Mesh`` objects over real (or forced
host) devices.  The port's :class:`Mesh` is a plain value, axis names and
sizes, and touches no device and creates no process group: the dry-run
plans one device's share of a step for 256 or 512 devices in one process.
A process of a sharded run is one device of the mesh: :func:`coords` gives
its coordinates from its rank (row-major, as ``jax.make_mesh`` lays out its
devices) and :func:`rank_of` the rank at given coordinates;
``distributed/comm.py::DistComm`` builds the process groups of the mesh's
axes over ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axis_names`` and their ``sizes``, outermost first."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self) -> None:
        if len(self.sizes) != len(self.axis_names) or len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh {self.sizes} over axes {self.axis_names}")
        if any(n < 1 for n in self.sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 chips.  Multi-pod: (pod=2,
    data=16, model=16) = 512 chips; the pod axis rides the data-centre
    network, data and model the chips' own links."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """Any mesh, for tests and for a few cards."""
    return Mesh(tuple(shape), tuple(axes))


def coords(mesh: Mesh, rank: int) -> tuple[int, ...]:
    """The coordinates of device ``rank``, one an axis: row-major over
    ``mesh.sizes`` (the last axis varies fastest)."""
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} is not a device of a mesh of {mesh.size}")
    out = []
    for n in reversed(mesh.sizes):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def rank_of(mesh: Mesh, at) -> int:
    """The rank of the device at coordinates ``at`` (the inverse of
    :func:`coords`)."""
    if len(at) != len(mesh.sizes) or any(not 0 <= c < n for c, n in zip(at, mesh.sizes)):
        raise ValueError(f"coordinates {tuple(at)} are not on a mesh of {mesh.sizes}")
    rank = 0
    for c, n in zip(at, mesh.sizes):
        rank = rank * n + c
    return rank


def required_devices(multi_pod: bool) -> int:
    return 512 if multi_pod else 256
