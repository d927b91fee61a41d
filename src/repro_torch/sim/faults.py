"""Fault injection + SLO semantics for the closed-loop co-sim of the port.

A :class:`FaultSchedule` is a declarative list of run-time events — tile
kills/revives, whole-island kills, NoC link degradation, stuck-frequency
actuator faults — compiled once per run (:func:`compile_faults`) into dense
per-tick masks the tick loop consumes:

* ``tile_alive``  (T, A) float 0/1 — multiplied into the tick capacity (a
  dead tile serves nothing, burns nothing: power-gated);
* ``link_scale``  (T, L) float in (0, 1] — divides the per-link loads of the
  contention model, so a degraded link saturates proportionally earlier;
* ``stuck``/``stuck_rate`` (T, I) — islands whose DFS actuator cannot commit
  during the window; with an explicit ``rate`` the hardware also runs at
  that rate regardless of the software's island config (the software state
  is NOT mutated: the controller keeps requesting, the silicon ignores it,
  and service recovers to the software view when the fault clears);
* ``island_dead`` (T, I) bool — islands whose every sampled tile is dead
  (the controller skips guard latching and commits for these).

The schedule types and the compiled masks are host NumPy, as in the
reference package: they are made once per run, and the engines copy the
masks to their device before the tick loop.  :func:`respill_stranded` runs
inside the tick loop on the engine's tensors.

SLO semantics (:class:`SLOConfig`) ride on top: a per-request deadline turns
unserveable backlog into *explicit* ``dropped_slo`` counts, and ``on_kill``
decides what happens to work stranded in a dead replica's queue — re-spill
to surviving replicas through the LoadBalancer (bounded by
``max_retries``), drop immediately, or wait for a revive.  Work is conserved
every tick: arrivals == completions + explicit drops + queued.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.islands import IslandConfig
from repro_torch.core.noc import NocConfig, routing_tables
from repro_torch.sim.control import group_sums


# ---------------------------------------------------------------------------
# Fault events (declarative; ticks are half-open [start, end) windows)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TileKill:
    """Tile ``tile`` serves nothing during ``[start, end)``; ``end=None``
    means it never revives within the run."""
    tile: str
    start: int
    end: Optional[int] = None


@dataclass(frozen=True)
class IslandKill:
    """Every tile of island ``island`` dies during ``[start, end)`` — the
    PDN/clock-tree failure domain of the paper's island partition."""
    island: str
    start: int
    end: Optional[int] = None


@dataclass(frozen=True)
class LinkDegrade:
    """Both directed NoC links between adjacent nodes ``a`` and ``b`` keep
    only ``scale`` of their bandwidth during ``[start, end)``."""
    a: Tuple[int, int]
    b: Tuple[int, int]
    scale: float
    start: int
    end: Optional[int] = None


@dataclass(frozen=True)
class StuckRate:
    """Island ``island``'s DFS actuator is stuck during ``[start, end)``:
    commits are rejected.  With an explicit ``rate`` the hardware also runs
    at that rate regardless of the software's live config; ``rate=None``
    freezes at whatever rate was committed last."""
    island: str
    start: int
    end: Optional[int] = None
    rate: Optional[float] = None


FaultEventT = (TileKill, IslandKill, LinkDegrade, StuckRate)


@dataclass(frozen=True)
class FaultSchedule:
    """An immutable, order-independent set of fault events.

    Builder style (each helper returns a new schedule)::

        faults = (FaultSchedule()
                  .kill_tile("be1", start=2500)
                  .degrade_link((1, 1), (1, 2), 0.25, start=100, end=900)
                  .stick_island("fe0", start=0, rate=0.4))
    """
    events: Tuple[object, ...] = ()

    def __post_init__(self):
        for ev in self.events:
            assert isinstance(ev, FaultEventT), ev

    def __len__(self) -> int:
        return len(self.events)

    def __bool__(self) -> bool:
        return bool(self.events)

    def add(self, *events) -> "FaultSchedule":
        return FaultSchedule(self.events + tuple(events))

    def kill_tile(self, tile: str, *, start: int,
                  end: Optional[int] = None) -> "FaultSchedule":
        return self.add(TileKill(tile, start, end))

    def kill_island(self, island: str, *, start: int,
                    end: Optional[int] = None) -> "FaultSchedule":
        return self.add(IslandKill(island, start, end))

    def degrade_link(self, a, b, scale: float, *, start: int,
                     end: Optional[int] = None) -> "FaultSchedule":
        return self.add(LinkDegrade(tuple(a), tuple(b), float(scale),
                                    start, end))

    def stick_island(self, island: str, *, start: int,
                     end: Optional[int] = None,
                     rate: Optional[float] = None) -> "FaultSchedule":
        return self.add(StuckRate(island, start, end, rate))


# ---------------------------------------------------------------------------
# SLO knobs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SLOConfig:
    """Service-level semantics layered on the fluid queues.

    ``deadline_s``   — requests whose remaining queueing time (backlog /
                       nominal capacity) exceeds the deadline are dropped
                       *explicitly* (``dropped_slo``).  The nominal
                       (unmasked) capacity is used so a dead tile's backlog
                       is not instantly mass-dropped before the recovery
                       path can re-spill it.
    ``on_kill``      — work stranded in a dead tile's queue: ``"respill"``
                       re-offers it to surviving replicas through the
                       LoadBalancer (default), ``"drop"`` discards it
                       (``dropped_fault``), ``"wait"`` leaves it queued
                       until a revive.
    ``max_retries``  — how many times a stranded request may be re-queued
                       before it is dropped (fluid two-class tracking
                       supports 0 or 1).
    """
    ON_KILL = ("respill", "drop", "wait")

    deadline_s: Optional[float] = None
    on_kill: str = "respill"
    max_retries: int = 1

    def __post_init__(self):
        assert self.on_kill in self.ON_KILL, self.on_kill
        assert self.max_retries in (0, 1), \
            "fluid retry tracking supports max_retries 0 or 1"
        assert self.deadline_s is None or self.deadline_s > 0.0

    @property
    def recovers(self) -> bool:
        """True iff stranded work is re-spilled (needs a LoadBalancer)."""
        return self.on_kill == "respill" and self.max_retries > 0


# ---------------------------------------------------------------------------
# Compilation: events -> per-tick masks
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CompiledFaults:
    """Dense per-tick fault state for one run of ``ticks`` ticks."""
    tile_alive: np.ndarray          # (T, A) float64 0/1
    link_scale: np.ndarray          # (T, L) float64 in (0, 1]
    stuck: np.ndarray               # (T, I) bool — commits rejected
    stuck_rate: np.ndarray          # (T, I) float64, NaN = hold last rate
    island_dead: np.ndarray         # (T, I) bool — all sampled tiles dead
    events: Tuple[Dict[str, object], ...]   # telemetry transitions

    @property
    def has_tile(self) -> bool:
        return bool((self.tile_alive < 1.0).any())

    @property
    def has_link(self) -> bool:
        return bool((self.link_scale < 1.0).any())

    @property
    def has_stuck(self) -> bool:
        return bool(self.stuck.any())

    @property
    def has_stuck_rate(self) -> bool:
        return bool(np.isfinite(self.stuck_rate).any())

    def events_by_tick(self) -> Dict[int, List[Dict[str, object]]]:
        by: Dict[int, List[Dict[str, object]]] = {}
        for ev in self.events:
            by.setdefault(int(ev["tick"]), []).append(ev)
        return by

    def stuck_rate_changes(self) -> List[int]:
        """The ticks at which the stuck-actuator hardware row takes a new
        value (NaN equal to NaN), tick 0 first: the ticks where an engine
        recomputes its service terms — known on the host before the loop,
        so the loop compares nothing on its device."""
        if self.stuck_rate.shape[0] == 0:
            return []
        r = self.stuck_rate
        same = (r[1:] == r[:-1]) | (np.isnan(r[1:]) & np.isnan(r[:-1]))
        return [0] + (np.nonzero(~same.all(axis=-1))[0] + 1).tolist()


def compile_faults(schedule: FaultSchedule, *, ticks: int,
                   names, islands: IslandConfig,
                   noc: NocConfig) -> CompiledFaults:
    """Compile a :class:`FaultSchedule` into per-tick masks.

    ``names`` is the platform's tile order (the mask column order),
    ``islands`` its island structure; link faults resolve against the
    shared mesh's directed link table (``routing_tables``), so they are
    placement-independent — every design of a batched run replaying the
    same schedule degrades the same physical links.
    """
    T = int(ticks)
    names = tuple(names)
    A = len(names)
    name_idx = {n: i for i, n in enumerate(names)}
    isl_names = islands.names()
    I = len(isl_names)
    rt = routing_tables(noc)
    L = len(rt.links)

    tile_alive = np.ones((T, A), dtype=np.float64)
    link_scale = np.ones((T, L), dtype=np.float64)
    stuck = np.zeros((T, I), dtype=bool)
    stuck_rate = np.full((T, I), np.nan)
    events: List[Dict[str, object]] = []

    def window(start, end):
        s = min(max(int(start), 0), T)
        e = T if end is None else min(max(int(end), s), T)
        return s, e

    def mark(tick, kind, **payload):
        if 0 <= tick < T:
            # a stable human-readable subject (tile list / island / link
            # endpoints)
            if "tiles" in payload:
                subject = ",".join(str(t) for t in payload["tiles"])
            elif "island" in payload:
                subject = str(payload["island"])
            elif "a" in payload and "b" in payload:
                subject = f"{payload['a']}-{payload['b']}"
            else:
                subject = ""
            events.append({"tick": int(tick), "kind": kind,
                           "subject": subject, **payload})

    def kill_tiles(tiles, s, e, domain):
        cols = [name_idx[t] for t in tiles]
        tile_alive[s:e, cols] = 0.0
        mark(s, "fault_kill", tiles=list(tiles), domain=domain)
        if e < T:
            mark(e, "fault_revive", tiles=list(tiles), domain=domain)

    for ev in schedule.events:
        if isinstance(ev, TileKill):
            assert ev.tile in name_idx, f"unknown tile {ev.tile!r}"
            s, e = window(ev.start, ev.end)
            kill_tiles((ev.tile,), s, e, "tile")
        elif isinstance(ev, IslandKill):
            assert ev.island in isl_names, f"unknown island {ev.island!r}"
            spec = islands.islands[isl_names.index(ev.island)]
            tiles = tuple(t for t in spec.tiles if t in name_idx)
            assert tiles, f"island {ev.island!r} has no sampled tiles"
            s, e = window(ev.start, ev.end)
            kill_tiles(tiles, s, e, "island")
        elif isinstance(ev, LinkDegrade):
            assert 0.0 < ev.scale <= 1.0, ev.scale
            s, e = window(ev.start, ev.end)
            hit = 0
            for u, v in ((tuple(ev.a), tuple(ev.b)),
                         (tuple(ev.b), tuple(ev.a))):
                li = rt.link_index.get((u, v))
                if li is not None:
                    link_scale[s:e, li] *= ev.scale
                    hit += 1
            assert hit, (f"no NoC link between {ev.a} and {ev.b} "
                         "(nodes must be mesh-adjacent)")
            mark(s, "fault_link_degrade", a=list(ev.a), b=list(ev.b),
                 scale=ev.scale)
            if e < T:
                mark(e, "fault_link_restore", a=list(ev.a), b=list(ev.b))
        elif isinstance(ev, StuckRate):
            assert ev.island in isl_names, f"unknown island {ev.island!r}"
            i = isl_names.index(ev.island)
            s, e = window(ev.start, ev.end)
            stuck[s:e, i] = True
            if ev.rate is not None:
                stuck_rate[s:e, i] = float(ev.rate)
            mark(s, "fault_stuck", island=ev.island, rate=ev.rate)
            if e < T:
                mark(e, "fault_unstuck", island=ev.island)

    # an island is dead iff it has sampled tiles and they are ALL dead
    mem = np.zeros((I, A), dtype=np.float64)
    for i, spec in enumerate(islands.islands):
        for t in spec.tiles:
            if t in name_idx:
                mem[i, name_idx[t]] = 1.0
    counts = mem.sum(axis=1)
    alive_count = tile_alive @ mem.T                        # (T, I)
    island_dead = (counts[None, :] > 0) & (alive_count <= 0.0)

    np.maximum(link_scale, 1e-6, out=link_scale)
    events.sort(key=lambda d: d["tick"])
    return CompiledFaults(tile_alive=tile_alive, link_scale=link_scale,
                          stuck=stuck, stuck_rate=stuck_rate,
                          island_dead=island_dead, events=tuple(events))


# ---------------------------------------------------------------------------
# Recovery: drain work stranded on dead replicas
# ---------------------------------------------------------------------------


def respill_stranded(queue: torch.Tensor, retry_q: torch.Tensor,
                     alive: torch.Tensor, balancer
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor]:
    """Drain queues of dead tiles at the start of a tick.

    Returns ``(queue, retry_q, respill, dropped_fault)`` — all per-tile
    ``(..., A)`` tensors on ``queue``'s device.  Fresh stranded work is
    returned in ``respill`` still sitting at its (dead) source column; the
    caller re-splits it over the group's survivors through the balancer and
    feeds it back as this tick's retry arrivals.  Work that already retried
    once — and any work whose replica group has no survivor, no balancer,
    or no retry budget — is returned in ``dropped_fault``.  Trailing-axis
    expressions only, in the reference's order, so sequential and B = 1
    batch runs compute the same floats; ``alive`` is an ``(A,)`` (or
    ``(..., A)``) 0/1 mask.  No value goes to the host.
    """
    dead = 1.0 - alive
    stranded = queue * dead
    s_retry = retry_q * dead
    queue = queue - stranded
    retry_q = retry_q - s_retry
    if balancer is None:
        return queue, retry_q, torch.zeros_like(stranded), stranded
    # does each replica group keep a survivor?  The reference's
    # einsum("a,ga->g", alive, membership) adds 0/1 values, which every
    # order adds exactly, so the balancer's own group sums (one gather of
    # the members, then their adds) give the same counts
    index, keep, covered, group_of = balancer.layout(queue.device,
                                                     queue.dtype)
    surv = group_sums(alive.to(queue.dtype), index, keep) > 0.0  # (..., G)
    can = covered & surv[..., group_of]                          # (..., A)
    respill = torch.where(can, stranded - s_retry, 0.0)
    return queue, retry_q, respill, stranded - respill
