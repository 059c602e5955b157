"""Device meshes: named axes and their sizes.

The reference builds ``jax.sharding.Mesh`` objects over real (or forced
host) devices.  The port's :class:`Mesh` is a plain value, axis names and
sizes, and touches no device and creates no process group: the dry-run
plans one device's share of a step for 256 or 512 devices in one process.
Binding a mesh to cards (``torch.distributed.DeviceMesh``) is the sharded
step's business.
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


def required_devices(multi_pod: bool) -> int:
    return 512 if multi_pod else 256
