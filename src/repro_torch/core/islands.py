"""Frequency islands (paper contribution C2) — design-time partition.

Every tile (and the NoC fabric itself) is assigned to an island; each island
carries an independent *rate* — the normalized form of the paper's
per-island clock.  Rates live on a discrete ladder mirroring the
paper's MHz steps (NoC: 10–100 MHz, tiles: 10–50 MHz, 5 MHz steps).

Resynchronizers: the paper inserts CDC resynchronizers at island
boundaries.  Here a boundary between islands that disagree on sharding
layout / replication K / precision implies a resharding (or dtype cast)
collective; :func:`resync_boundaries` enumerates them so core/noc.py can
charge their bytes and core/monitor.py can count their packets.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.tiles import TilePlan


@dataclass(frozen=True)
class RateLadder:
    """Discrete frequency ladder, verbatim from the paper's DFS actuators."""
    f_min_mhz: int = 10
    f_max_mhz: int = 50
    f_step_mhz: int = 5

    def levels_mhz(self) -> Tuple[int, ...]:
        return tuple(range(self.f_min_mhz, self.f_max_mhz + 1, self.f_step_mhz))

    def levels(self) -> Tuple[float, ...]:
        """Normalized rates f/f_max in (0, 1]."""
        return tuple(m / self.f_max_mhz for m in self.levels_mhz())

    def quantize(self, rate: float) -> float:
        lv = np.asarray(self.levels())
        return float(lv[int(np.argmin(np.abs(lv - rate)))])

    def voltages(self, tech) -> np.ndarray:
        """The coupled voltage ladder under a physical tech model: the
        absolute operating voltage (volts) at each frequency level, one
        step per step (:meth:`repro_torch.core.voltage.TechModel.volt_of_freq`
        over :meth:`levels`)."""
        return tech.ladder_voltages(self)

    def legal_levels(self, tech) -> np.ndarray:
        """Mask of frequency levels inside the tech node's legal DVFS
        ratio range ``[L, U]`` — the steps a clamped commit can land on."""
        return tech.legal_levels(self)


# The paper's two ladders.
TILE_LADDER = RateLadder(10, 50, 5)
NOC_LADDER = RateLadder(10, 100, 5)


@dataclass(frozen=True)
class IslandSpec:
    name: str
    tiles: Tuple[str, ...]                   # tile names from the TilePlan
    ladder: RateLadder = TILE_LADDER
    rate: float = 1.0                        # normalized f/f_max
    fixed: bool = False                      # fixed clock (no DFS actuator)

    def with_rate(self, rate: float) -> "IslandSpec":
        assert not self.fixed, f"island {self.name} has a fixed clock"
        return replace(self, rate=self.ladder.quantize(rate))


@dataclass(frozen=True)
class IslandConfig:
    """A full island partition + rate assignment (one 'SoC configuration')."""
    islands: Tuple[IslandSpec, ...]
    version: int = 0

    def _tile_index(self) -> Dict[str, int]:
        """Memoized tile -> island-position map (the sim hot path calls
        :meth:`island_of` per tile per engine build; the old linear scan
        was O(#islands) per lookup).  The cache is per *instance*, so any
        rate/partition change — ``with_rates``/``replace`` always build a
        new frozen instance and bump ``version`` — starts from a fresh
        map; first-wins on (invalid) duplicate assignments, matching the
        scan."""
        m = self.__dict__.get("_tile_index_cache")
        if m is None:
            m = {}
            for i, isl in enumerate(self.islands):
                for t in isl.tiles:
                    m.setdefault(t, i)
            object.__setattr__(self, "_tile_index_cache", m)
        return m

    def island_of(self, tile_name: str) -> IslandSpec:
        return self.islands[self._tile_index()[tile_name]]

    def rate_of(self, tile_name: str) -> float:
        return self.island_of(tile_name).rate

    def with_rates(self, rates: Dict[str, float]) -> "IslandConfig":
        new = tuple(
            isl.with_rate(rates[isl.name]) if isl.name in rates else isl
            for isl in self.islands)
        return replace(self, islands=new, version=self.version + 1)

    def names(self) -> Tuple[str, ...]:
        return tuple(i.name for i in self.islands)

    def voltage_ladders(self, tech) -> Dict[str, np.ndarray]:
        """Per-island voltage ladders under a physical tech model:
        island name -> operating volts at each of its frequency levels
        (the V/f pairs a DFS commit selects between)."""
        return {i.name: i.ladder.voltages(tech) for i in self.islands}


def default_islands(plan: TilePlan) -> IslandConfig:
    """Paper-faithful island split: each accelerator tile its own island,
    NoC+MEM together (the paper's 10–100 MHz island), IO+host together."""
    islands: List[IslandSpec] = []
    acc = [t for t in plan.tiles if t.kind not in ("noc", "mem", "io")]
    for t in acc:
        islands.append(IslandSpec(t.name, (t.name,), TILE_LADDER, 1.0))
    islands.append(IslandSpec(
        "noc_mem",
        tuple(t.name for t in plan.tiles if t.kind in ("noc", "mem")),
        NOC_LADDER, 1.0))
    io = tuple(t.name for t in plan.tiles if t.kind == "io")
    if io:
        islands.append(IslandSpec("cpu_io", io, TILE_LADDER, 1.0, fixed=True))
    return IslandConfig(tuple(islands))


def validate_islands(cfg: IslandConfig, plan: TilePlan) -> None:
    """Every tile in exactly one island (a partition, as in the paper)."""
    seen: Dict[str, str] = {}
    for isl in cfg.islands:
        for t in isl.tiles:
            assert t not in seen, f"tile {t} in islands {seen[t]} and {isl.name}"
            seen[t] = isl.name
    for t in plan.tiles:
        assert t.name in seen, f"tile {t.name} not assigned to any island"


@dataclass(frozen=True)
class Boundary:
    """A resynchronizer site: directed tile-to-tile stream crossing islands
    (or crossing an MRA bridge / precision change within one island)."""
    src: str
    dst: str
    reason: str          # "island" | "mra" | "precision"


# Dataflow edges between tile kinds in a decoder LM (per layer, static).
_FLOW = [
    ("io", "embed"), ("embed", "attn"), ("embed", "ssm"),
    ("attn", "ffn"), ("attn", "moe"), ("ssm", "shared_attn"),
    ("shared_attn", "ssm"), ("ffn", "attn"), ("moe", "attn"),
    ("ssm", "embed"), ("ffn", "embed"), ("moe", "embed"),
    ("attn", "mem"), ("ffn", "mem"), ("moe", "mem"), ("ssm", "mem"),
]


def resync_boundaries(plan: TilePlan, islands: IslandConfig) -> List[Boundary]:
    kind_to_name = {}
    for t in plan.tiles:
        kind_to_name.setdefault(t.kind, t.name)
    out: List[Boundary] = []
    for src_k, dst_k in _FLOW:
        if src_k not in kind_to_name or dst_k not in kind_to_name:
            continue
        src, dst = kind_to_name[src_k], kind_to_name[dst_k]
        if islands.island_of(src).name != islands.island_of(dst).name:
            out.append(Boundary(src, dst, "island"))
        src_t, dst_t = plan.tile(src), plan.tile(dst)
        if src_t.replication != dst_t.replication:
            out.append(Boundary(src, dst, "mra"))
    return out
