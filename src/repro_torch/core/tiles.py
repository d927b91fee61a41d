"""Tiles — the unit of Vespa's design space.

A :class:`TileSpec` carries the paper's per-tile design-time knobs:

* ``replication``  — the MRA factor K (paper contribution C1),
* ``island``       — frequency-island assignment (C2),
* ``monitors``     — which of the four counters are enabled (C3, ≤4),
* ``placement``    — logical position on the NoC grid (paper Fig. 2: A1 near
                     MEM vs A2 far; placement changes hop counts).

A :class:`TilePlan` assigns every module family of an architecture to a tile
and is consumed by core/islands.py (island partition + resynchronizers).
The architecture-driven ``default_plan`` / ``validate_plan`` of the reference
need the LLM ``ArchConfig`` registry and are ported with it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Tuple

MONITOR_KINDS = ("exec_time", "pkts_in", "pkts_out", "rtt")

# Module families a tile can host (the "accelerator" classes of the model).
TILE_KINDS = (
    "embed",        # embedding + lm_head (vocab tile)
    "attn",         # attention block-group
    "ffn",          # dense MLP block-group
    "moe",          # routed experts
    "ssm",          # mamba mixer block-group
    "shared_attn",  # zamba shared tile (one physical, many logical users)
    "noc",          # the interconnect itself (collectives fabric)
    "mem",          # memory controller
    "io",           # host data-pipeline tile
)


@dataclass(frozen=True)
class TileSpec:
    name: str
    kind: str
    island: str = "default"
    replication: int = 1                 # MRA factor K  (C1)
    placement: Tuple[int, int] = (0, 0)  # NoC grid position
    monitors: Tuple[str, ...] = ("exec_time", "pkts_in", "pkts_out")

    def __post_init__(self):
        assert self.kind in TILE_KINDS, self.kind
        assert len(self.monitors) <= 4, "paper allows up to 4 counters/tile"
        assert all(m in MONITOR_KINDS for m in self.monitors), self.monitors
        assert self.replication >= 1


@dataclass(frozen=True)
class TilePlan:
    """Tile assignment for one architecture instance."""
    arch: str
    tiles: Tuple[TileSpec, ...]

    def tile(self, name: str) -> TileSpec:
        for t in self.tiles:
            if t.name == name:
                return t
        raise KeyError(name)

    def by_kind(self, kind: str) -> List[TileSpec]:
        return [t for t in self.tiles if t.kind == kind]

    def islands(self) -> Dict[str, List[TileSpec]]:
        out: Dict[str, List[TileSpec]] = {}
        for t in self.tiles:
            out.setdefault(t.island, []).append(t)
        return out

    def with_replication(self, tile_name: str, k: int) -> "TilePlan":
        """The paper's K knob: change a tile's replication without touching
        anything else (the module definition and mesh stay fixed)."""
        tiles = tuple(
            replace(t, replication=k) if t.name == tile_name else t
            for t in self.tiles)
        return replace(self, tiles=tiles)
