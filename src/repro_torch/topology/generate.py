"""Seeded continuum topology generator.

Generates IoT/edge/cloud/HPC continua at realistic scale following the
tiered resource taxonomy of the SPEC-RG reference architecture (arxiv
2207.04159): a declarative, JSON-round-trippable :class:`TopologySpec`
expands deterministically into a paper
:class:`~repro_torch.core.system_model.System` with a full pairwise
data-transfer-rate matrix.  Plain numpy, the reference's draws in the
reference's order, so a spec expands to the reference's system bit for bit.

Network realism
---------------
Links are described by :class:`LinkProfile` — sustained bandwidth (GB/s),
one-way latency (s) and a lognormal jitter sigma.  The paper's Eq. 5 only
knows a *rate* (``transfer time = data / dtr``), so latency is folded into
an **effective rate** for a reference transfer size ``S``::

    dtr_eff = S / (latency + S / bandwidth)

which recovers ``bandwidth`` for latency-free links and degrades toward
``S / latency`` for chatty high-latency paths.  Inter-tier paths follow the
tier chain (iot → edge → cloud → hpc): bandwidth is the bottleneck uplink
along the path, latency is the sum of hop latencies.  HPC tiers may declare
NUMA-ish **islands**: contiguous node blocks joined by a dense low-latency
fabric (higher effective rate than the tier's own interconnect).

Determinism
-----------
``generate(spec)`` draws everything from one ``numpy`` Generator seeded by
``spec.seed`` in a fixed order, so a spec regenerates **bit-identically**:
``json.dumps(system_to_json(generate(spec)), sort_keys=True)`` is a pure
function of the spec.  :func:`cached_system` memoizes the expansion keyed
by the spec's canonical fingerprint — campaign cells sharing a topology
coordinate expand it once.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from repro_torch.core.api import did_you_mean, reject_unknown_keys
from repro_torch.core.system_model import Node, System, make_system
from repro_torch.core.workload_model import canonical_hash
from repro_torch.obs import TRACER

#: Canonical tier chain, innermost (device) to outermost (supercomputer).
#: Inter-tier routes follow this order for tiers present in a spec.
TIER_ORDER = ("iot", "edge", "cloud", "hpc")


# ---------------------------------------------------------------------------
# Link profiles
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """One link class: bandwidth (GB/s), one-way latency (s), jitter sigma.

    ``jitter`` is the sigma of a mean-preserving lognormal factor applied
    per node pair at expansion time (0 = perfectly stable links)."""

    bandwidth: float
    latency: float = 0.0
    jitter: float = 0.0

    def __post_init__(self) -> None:
        if not self.bandwidth > 0:
            raise ValueError(f"link bandwidth must be > 0, got {self.bandwidth}")
        if self.latency < 0 or self.jitter < 0:
            raise ValueError("link latency/jitter must be >= 0")

    def effective_rate(self, ref_transfer_gb: float) -> float:
        """Latency-adjusted rate for a reference transfer (Eq. 5 units)."""
        return ref_transfer_gb / (self.latency + ref_transfer_gb / self.bandwidth)

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"bandwidth": self.bandwidth}
        if self.latency:
            out["latency"] = self.latency
        if self.jitter:
            out["jitter"] = self.jitter
        return out

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "LinkProfile":
        reject_unknown_keys(
            obj, ("bandwidth", "latency", "jitter"), context="link profile"
        )
        if "bandwidth" not in obj:
            raise ValueError("link profile needs a 'bandwidth' (GB/s)")
        return cls(
            bandwidth=float(obj["bandwidth"]),
            latency=float(obj.get("latency", 0.0)),
            jitter=float(obj.get("jitter", 0.0)),
        )


# ---------------------------------------------------------------------------
# Tier + topology specs
# ---------------------------------------------------------------------------

_TIER_KEYS = (
    "name",
    "count",
    "speed",
    "cores",
    "memory",
    "features",
    "link",
    "uplink",
    "islands",
    "island_link",
)


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One continuum tier: node count, resource/property distributions and
    its link classes.

    * ``speed`` / ``memory`` — uniform ``[lo, hi]`` ranges (P2, R2);
    * ``cores`` — discrete choices (R1);
    * ``link`` — intra-tier interconnect;
    * ``uplink`` — the hop toward the *next* tier in spec order (the last
      tier's uplink is unused);
    * ``islands`` / ``island_link`` — optional NUMA-ish partitions: nodes
      split into ``islands`` contiguous blocks whose intra-block links use
      the denser ``island_link`` profile.
    """

    name: str
    count: int
    speed: tuple[float, float]
    cores: tuple[int, ...]
    memory: tuple[float, float]
    features: tuple[str, ...]
    link: LinkProfile
    uplink: LinkProfile
    islands: int = 1
    island_link: LinkProfile | None = None

    def __post_init__(self) -> None:
        if self.count < 1:
            raise ValueError(f"tier {self.name!r} needs count >= 1")
        if not (0 < self.speed[0] <= self.speed[1]):
            raise ValueError(f"tier {self.name!r} speed range must be 0 < lo <= hi")
        if not self.cores or any(c < 1 for c in self.cores):
            raise ValueError(f"tier {self.name!r} cores choices must be >= 1")
        if self.islands < 1:
            raise ValueError(f"tier {self.name!r} islands must be >= 1")
        if self.islands > 1 and self.island_link is None:
            raise ValueError(
                f"tier {self.name!r} declares {self.islands} islands but no "
                "'island_link' profile"
            )
        if self.islands > self.count:
            raise ValueError(
                f"tier {self.name!r} has more islands ({self.islands}) than "
                f"nodes ({self.count})"
            )

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "name": self.name,
            "count": self.count,
            "speed": list(self.speed),
            "cores": list(self.cores),
            "memory": list(self.memory),
            "features": list(self.features),
            "link": self.link.to_json(),
            "uplink": self.uplink.to_json(),
        }
        if self.islands > 1:
            out["islands"] = self.islands
            out["island_link"] = self.island_link.to_json()
        return out

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "TierSpec":
        reject_unknown_keys(obj, _TIER_KEYS, context="topology tier")
        for req in ("name", "count", "speed", "cores", "memory", "link", "uplink"):
            if req not in obj:
                raise ValueError(f"topology tier is missing {req!r}")
        island_link = obj.get("island_link")
        return cls(
            name=str(obj["name"]),
            count=int(obj["count"]),
            speed=(float(obj["speed"][0]), float(obj["speed"][1])),
            cores=tuple(int(c) for c in obj["cores"]),
            memory=(float(obj["memory"][0]), float(obj["memory"][1])),
            features=tuple(str(f) for f in obj.get("features", ())),
            link=LinkProfile.from_json(obj["link"]),
            uplink=LinkProfile.from_json(obj["uplink"]),
            islands=int(obj.get("islands", 1)),
            island_link=(
                LinkProfile.from_json(island_link) if island_link is not None else None
            ),
        )


_SPEC_KEYS = ("name", "seed", "tiers", "ref_transfer_mb")


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """A declarative continuum: ordered tiers plus the reference transfer
    size that folds latency into Eq. 5 rates.  Round-trips through JSON
    (:meth:`to_json` / :func:`spec_from_json`) and fingerprints canonically
    (:meth:`fingerprint`) for caching."""

    name: str
    tiers: tuple[TierSpec, ...]
    seed: int = 0
    ref_transfer_mb: float = 64.0

    def __post_init__(self) -> None:
        object.__setattr__(
            self,
            "tiers",
            tuple(
                t if isinstance(t, TierSpec) else TierSpec.from_json(t)
                for t in self.tiers
            ),
        )
        if not self.tiers:
            raise ValueError("topology spec needs at least one tier")
        names = [t.name for t in self.tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names in {names}")
        if self.ref_transfer_mb <= 0:
            raise ValueError("ref_transfer_mb must be > 0")

    @property
    def num_nodes(self) -> int:
        return sum(t.count for t in self.tiers)

    @property
    def ref_transfer_gb(self) -> float:
        return self.ref_transfer_mb / 1024.0

    def path_profile(self, a: int, b: int) -> LinkProfile:
        """The link class between tier indices ``a`` and ``b``: the tier's
        own interconnect on the diagonal, else the bottleneck-bandwidth /
        summed-latency chain of uplinks between them."""
        if a == b:
            return self.tiers[a].link
        lo, hi = (a, b) if a < b else (b, a)
        hops = [self.tiers[i].uplink for i in range(lo, hi)]
        return LinkProfile(
            bandwidth=min(h.bandwidth for h in hops),
            latency=sum(h.latency for h in hops),
            jitter=max(h.jitter for h in hops),
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "topology": {
                "name": self.name,
                "seed": self.seed,
                "ref_transfer_mb": self.ref_transfer_mb,
                "tiers": [t.to_json() for t in self.tiers],
            }
        }

    def fingerprint(self) -> str:
        return canonical_hash(self.to_json())

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.to_json(), indent=2) + "\n")
        return path

    def replace(self, **changes: Any) -> "TopologySpec":
        return dataclasses.replace(self, **changes)


def spec_from_json(obj: Mapping[str, Any] | str) -> TopologySpec:
    """Parse a topology spec (the ``{"topology": {...}}`` wrapper or the
    bare header) with strict key checking."""
    if isinstance(obj, str):
        obj = json.loads(obj)
    if "topology" in obj:
        reject_unknown_keys(obj, ("topology",), context="topology file")
        obj = obj["topology"]
    reject_unknown_keys(obj, _SPEC_KEYS, context="topology")
    if "name" not in obj or "tiers" not in obj:
        raise ValueError("topology spec needs 'name' and 'tiers'")
    return TopologySpec(
        name=str(obj["name"]),
        seed=int(obj.get("seed", 0)),
        ref_transfer_mb=float(obj.get("ref_transfer_mb", 64.0)),
        tiers=tuple(TierSpec.from_json(t) for t in obj["tiers"]),
    )


def load_spec(path: str | Path) -> TopologySpec:
    return spec_from_json(Path(path).read_text())


# ---------------------------------------------------------------------------
# Expansion
# ---------------------------------------------------------------------------


def tier_slices(spec: TopologySpec) -> dict[str, slice]:
    """Node-index slice per tier, in spec order (nodes are emitted tier by
    tier, so slices are contiguous)."""
    out: dict[str, slice] = {}
    start = 0
    for tier in spec.tiers:
        out[tier.name] = slice(start, start + tier.count)
        start += tier.count
    return out


def island_ids(spec: TopologySpec) -> np.ndarray:
    """Global island id per node (-1 = not in an island).  Islands are
    contiguous equal-ish blocks within their tier; ids are globally unique
    across tiers."""
    ids = np.full(spec.num_nodes, -1, dtype=np.int64)
    start = 0
    next_id = 0
    for tier in spec.tiers:
        if tier.islands > 1:
            local = (np.arange(tier.count) * tier.islands) // tier.count
            ids[start : start + tier.count] = local + next_id
            next_id += tier.islands
        start += tier.count
    return ids


def _dtr_matrix(spec: TopologySpec, rng: np.random.Generator) -> np.ndarray:
    """Vectorized [N, N] effective-rate matrix: tier-pair path profiles,
    island overrides, then one symmetric mean-preserving lognormal jitter
    draw per pair."""
    ntiers = len(spec.tiers)
    rate = np.empty((ntiers, ntiers), dtype=np.float64)
    sigma = np.empty((ntiers, ntiers), dtype=np.float64)
    for a in range(ntiers):
        for b in range(ntiers):
            prof = spec.path_profile(a, b)
            rate[a, b] = prof.effective_rate(spec.ref_transfer_gb)
            sigma[a, b] = prof.jitter

    tier_of = np.repeat(np.arange(ntiers), [t.count for t in spec.tiers])
    dtr = rate[tier_of[:, None], tier_of[None, :]]
    sig = sigma[tier_of[:, None], tier_of[None, :]]

    isl = island_ids(spec)
    if (isl >= 0).any():
        same = (isl[:, None] == isl[None, :]) & (isl[:, None] >= 0)
        for ti, tier in enumerate(spec.tiers):
            if tier.islands > 1:
                mask = same & (tier_of[:, None] == ti)
                dtr[mask] = tier.island_link.effective_rate(spec.ref_transfer_gb)
                sig[mask] = tier.island_link.jitter

    if (sig > 0).any():
        z = rng.standard_normal((spec.num_nodes, spec.num_nodes))
        z = (z + z.T) / np.sqrt(2.0)  # symmetric: i→j and j→i jitter together
        dtr = dtr * np.exp(sig * z - 0.5 * sig * sig)

    np.fill_diagonal(dtr, np.inf)
    return dtr


def generate(spec: TopologySpec) -> System:
    """Expand a spec into a :class:`System`, bit-identically per seed.

    Draw order is fixed — per tier in spec order: speeds, cores, memory;
    then the link-jitter matrix — so adding a tier at the end never
    reshuffles earlier tiers' draws."""
    with TRACER.span(
        "topology.generate", cat="topology",
        args={"seed": spec.seed, "nodes": sum(t.count for t in spec.tiers)},
    ):
        return _generate(spec)


def _generate(spec: TopologySpec) -> System:
    rng = np.random.default_rng(spec.seed)
    nodes: list[Node] = []
    for tier in spec.tiers:
        speeds = rng.uniform(tier.speed[0], tier.speed[1], tier.count)
        cores = rng.choice(np.asarray(tier.cores, dtype=np.int64), size=tier.count)
        memory = rng.uniform(tier.memory[0], tier.memory[1], tier.count)
        p3 = tier.link.effective_rate(spec.ref_transfer_gb)
        feats = frozenset(tier.features)
        for i in range(tier.count):
            nodes.append(
                Node(
                    name=f"{tier.name}{i:04d}",
                    resources={
                        "cores": int(cores[i]),
                        "memory": float(memory[i]),
                        "storage": 0.0,
                    },
                    features=feats,
                    properties={
                        "processing_speed": float(speeds[i]),
                        "data_transfer_rate": p3,
                    },
                )
            )
    return make_system(nodes, _dtr_matrix(spec, rng))


#: fingerprint → System memo so campaign cells sharing a topology
#: coordinate expand it once (cleared only by process exit; specs are
#: hundreds of nodes, not gigabytes).
_SYSTEM_CACHE: dict[str, System] = {}


def cached_system(spec: TopologySpec) -> System:
    key = spec.fingerprint()
    system = _SYSTEM_CACHE.get(key)
    if system is None:
        system = _SYSTEM_CACHE[key] = generate(spec)
    return system


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------


def tiered_spec(
    scale: int = 1, *, seed: int = 0, name: str | None = None
) -> TopologySpec:
    """The reference 4-tier continuum at ``16 * scale`` nodes.

    Per-tier counts scale linearly (8/4/2/2 × scale); profiles follow
    typical deployments: WiFi-class IoT links, 1 GbE edge, 10 GbE cloud
    with a WAN uplink, 100 Gb-class HPC interconnect with denser
    low-latency islands."""
    if scale < 1:
        raise ValueError("scale must be >= 1")
    hpc_count = 2 * scale
    return TopologySpec(
        name=name or f"tiered-{16 * scale}",
        seed=seed,
        tiers=(
            TierSpec(
                name="iot",
                count=8 * scale,
                speed=(0.1, 0.3),
                cores=(1, 2, 4),
                memory=(0.5, 2.0),
                features=("F1", "F5"),
                link=LinkProfile(bandwidth=0.01, latency=5e-3, jitter=0.05),
                uplink=LinkProfile(bandwidth=0.005, latency=10e-3, jitter=0.05),
            ),
            TierSpec(
                name="edge",
                count=4 * scale,
                speed=(0.5, 1.0),
                cores=(4, 8),
                memory=(4.0, 16.0),
                features=("F1", "F6"),
                link=LinkProfile(bandwidth=0.125, latency=1e-3, jitter=0.05),
                uplink=LinkProfile(bandwidth=0.125, latency=5e-3, jitter=0.05),
            ),
            TierSpec(
                name="cloud",
                count=2 * scale,
                speed=(1.0, 2.0),
                cores=(16, 32, 64),
                memory=(32.0, 128.0),
                features=("F1", "F2", "F4", "F6"),
                link=LinkProfile(bandwidth=1.25, latency=5e-4, jitter=0.05),
                uplink=LinkProfile(bandwidth=1.25, latency=2e-2, jitter=0.05),
            ),
            TierSpec(
                name="hpc",
                count=hpc_count,
                speed=(2.0, 4.0),
                cores=(32, 64),
                memory=(128.0, 512.0),
                features=("F1", "F2", "F3", "F8"),
                link=LinkProfile(bandwidth=12.5, latency=1e-5, jitter=0.02),
                uplink=LinkProfile(bandwidth=1.25, latency=1e-3, jitter=0.05),
                islands=min(2, hpc_count),
                island_link=LinkProfile(bandwidth=25.0, latency=1e-6, jitter=0.02),
            ),
        ),
    )


#: named presets for the campaign `topology` coordinate and the CLI.
PRESETS: dict[str, Any] = {
    "tiny": lambda: tiered_spec(1, name="tiny"),  # 16 nodes
    "small": lambda: tiered_spec(4, name="small"),  # 64 nodes
    "medium": lambda: tiered_spec(16, name="medium"),  # 256 nodes
    "large": lambda: tiered_spec(63, name="large"),  # 1008 nodes
}


def resolve_spec(
    spec: "TopologySpec | Mapping[str, Any] | str",
) -> TopologySpec:
    """Coerce a preset name, spec dict/JSON text, or TopologySpec."""
    if isinstance(spec, TopologySpec):
        return spec
    if isinstance(spec, Mapping):
        return spec_from_json(spec)
    builder = PRESETS.get(spec)
    if builder is not None:
        return builder()
    if spec.lstrip().startswith("{"):
        return spec_from_json(spec)
    raise ValueError(
        f"unknown topology preset {spec!r}; options {sorted(PRESETS)}"
        f"{did_you_mean(spec, PRESETS)} (or pass a spec dict / JSON)"
    )
