"""System model for the HPC compute continuum (paper §IV-B1).

The hierarchy D (data center) ⊃ C (cluster) ⊃ N (node) flattens, for the
solvers, into a :class:`System`: the node set ``N = {R, F, P}`` plus a
pairwise data-transfer-rate matrix.

* **R** — resources: cores ``R1``, memory GB ``R2``, storage GB ``R3``;
* **F** — features: infrastructure flags ``F1``..``F8`` (Table III);
* **P** — properties: processing speed ``P2`` and data-transfer rate ``P3``.

JSON I/O follows the paper's Fig. 7 format and reads the reference
package's ``system_to_json`` output unchanged (``+inf`` rates travel as
``-1.0``, since JSON has no Infinity).  Plain numpy: nothing here touches a
device.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Iterable, Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Node:
    """A node ``N = {R, F, P}`` (paper Table I row 3)."""

    name: str
    resources: Mapping[str, float]  # R1 "cores", R2 "memory", R3 "storage"
    features: frozenset[str]
    properties: Mapping[str, float]  # "processing_speed" (P2), "data_transfer_rate" (P3)

    @property
    def cores(self) -> float:
        return float(self.resources.get("cores", 0.0))

    @property
    def memory(self) -> float:
        return float(self.resources.get("memory", 0.0))

    @property
    def storage(self) -> float:
        return float(self.resources.get("storage", 0.0))

    @property
    def processing_speed(self) -> float:
        return float(self.properties.get("processing_speed", 1.0))

    @property
    def data_transfer_rate(self) -> float:
        return float(self.properties.get("data_transfer_rate", math.inf))

    def provides(self, requested: Iterable[str]) -> bool:
        """Feature constraint  F_T^f ⊆ F_N^f  (Eq. 1)."""
        return set(requested) <= set(self.features)


@dataclasses.dataclass(frozen=True)
class System:
    """Flattened solver view of a continuum: the node set plus a pairwise
    data-transfer-rate matrix (P3, Eq. 5 denominator).

    ``dtr[i, i']`` is the rate between nodes ``i`` and ``i'``; the diagonal is
    +inf so that intra-node transfer time is exactly zero (Eq. 5's
    ``i != i'`` condition)."""

    nodes: tuple[Node, ...]
    dtr: np.ndarray  # [N, N], +inf diagonal

    def __post_init__(self) -> None:
        n = len(self.nodes)
        if self.dtr.ndim != 2 or self.dtr.shape[0] != self.dtr.shape[1]:
            raise ValueError(f"dtr matrix must be square, got {self.dtr.shape}")
        if self.dtr.shape != (n, n):
            raise ValueError(f"dtr must be [{n},{n}], got {self.dtr.shape}")
        if np.isnan(self.dtr).any():
            bad = np.argwhere(np.isnan(self.dtr))[0]
            raise ValueError(f"dtr contains NaN (first at {tuple(bad)})")
        if (self.dtr < 0).any():
            bad = np.argwhere(self.dtr < 0)[0]
            raise ValueError(
                f"dtr contains negative transfer rates (first at "
                f"{tuple(bad)}: {self.dtr[tuple(bad)]})"
            )

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    def cores(self) -> np.ndarray:
        return np.array([n.cores for n in self.nodes], dtype=np.float64)

    def speed(self) -> np.ndarray:
        return np.array([n.processing_speed for n in self.nodes], dtype=np.float64)


def make_system(nodes: Sequence[Node], dtr: np.ndarray | None = None) -> System:
    """Build a :class:`System`; the default DTR is ``min(P3_i, P3_i')``
    off-diagonal (a transfer is limited by the slower endpoint), +inf on the
    diagonal."""
    nodes = tuple(nodes)
    if dtr is None:
        p3 = np.array([nd.data_transfer_rate for nd in nodes], dtype=np.float64)
        dtr = np.minimum.outer(p3, p3)
    dtr = np.asarray(dtr, dtype=np.float64).copy()
    np.fill_diagonal(dtr, np.inf)
    return System(nodes=nodes, dtr=dtr)


def _unwrap(v: Any) -> Any:
    if isinstance(v, list) and len(v) == 1:
        return v[0]
    return v


def node_from_json(name: str, spec: Mapping[str, Any]) -> Node:
    resources = {}
    for key in ("cores", "memory", "storage"):
        if key in spec:
            resources[key] = float(_unwrap(spec[key]))
    features = frozenset(spec.get("features", []))
    properties = {}
    for key in ("processing_speed", "data_transfer_rate"):
        if key in spec:
            properties[key] = float(_unwrap(spec[key]))
    return Node(name=name, resources=resources, features=features, properties=properties)


def system_from_json(obj: Mapping[str, Any] | str) -> System:
    """Parse the Fig. 7 system-characteristics JSON."""
    if isinstance(obj, str):
        obj = json.loads(obj)
    nodes = [node_from_json(name, spec) for name, spec in obj["nodes"].items()]
    dtr = None
    if "dtr_matrix" in obj:
        rows = obj["dtr_matrix"]
        if not rows or any(len(r) != len(rows) for r in rows):
            raise ValueError(
                f"dtr_matrix must be square, got "
                f"{len(rows)}x{[len(r) for r in rows]}"
            )
        dtr = np.asarray(rows, dtype=np.float64)
        dtr = np.where(dtr == -1.0, np.inf, dtr)  # JSON's stand-in for +inf
    return make_system(nodes, dtr)


def system_to_json(system: System) -> dict:
    return {
        "nodes": {
            n.name: {
                "cores": [n.cores],
                "memory": [n.memory],
                "storage": [n.storage],
                "features": sorted(n.features),
                "processing_speed": [n.processing_speed],
                "data_transfer_rate": [n.data_transfer_rate],
            }
            for n in system.nodes
        },
        "dtr_matrix": np.where(np.isinf(system.dtr), -1.0, system.dtr).tolist(),
    }


def mri_system() -> System:
    """The paper's Table IV sample nodes (MRI use case): N1 8 cores (edge),
    N2 48 cores (cloud), N3 2572 cores (HPC); DTR 100 GB/s everywhere."""
    nodes = [
        Node("N1", {"cores": 8, "storage": 500}, frozenset({"F1"}),
             {"processing_speed": 1.0, "data_transfer_rate": 100.0}),
        Node("N2", {"cores": 48, "storage": 20000}, frozenset({"F1", "F2"}),
             {"processing_speed": 1.0, "data_transfer_rate": 100.0}),
        Node("N3", {"cores": 2572, "storage": 210000}, frozenset({"F1", "F2", "F3"}),
             {"processing_speed": 1.0, "data_transfer_rate": 100.0}),
    ]
    return make_system(nodes)


def synthetic_system(
    num_nodes: int,
    *,
    seed: int = 0,
    max_cores: int = 64,
    hetero_speed: bool = True,
) -> System:
    """Random heterogeneous system for the paper's scale tests (Table IX).

    Cores are capped (default 64) so that the core-granular evaluator state
    stays bounded; speeds vary 1–4× when ``hetero_speed``.  The draw order
    matches the reference generator, so a seed gives the same system."""
    rng = np.random.default_rng(seed)
    nodes = []
    feature_pool = ["F1", "F2", "F3", "F4", "F5", "F6", "F7", "F8"]
    for i in range(num_nodes):
        cores = int(rng.choice([4, 8, 16, 32, max_cores]))
        feats = {"F1"} | set(rng.choice(feature_pool, size=rng.integers(1, 5), replace=False))
        speed = float(rng.choice([1.0, 2.0, 4.0])) if hetero_speed else 1.0
        dtrate = float(rng.choice([10.0, 50.0, 100.0]))
        nodes.append(
            Node(
                f"n{i}",
                {"cores": cores, "memory": 64.0, "storage": 1000.0},
                frozenset(feats),
                {"processing_speed": speed, "data_transfer_rate": dtrate},
            )
        )
    return make_system(nodes)
