"""Tile-to-tile flow patterns for the closed-loop simulator.

The original engine hard-coded the paper's monitoring workload: every
accelerator tile streams to the MEM tile.  Real SoC workloads are richer —
ESP-style accelerator-to-accelerator pipelines and DS3-style
domain-specific task chains route traffic between arbitrary tiles, with
one stage's completions feeding the next stage's queue.  A
:class:`FlowPattern` describes that structure *by tile name* (so one
pattern serves every design point of a sweep, whatever its placement),
and :func:`compile_flows` lowers it once per design into the dense array
artifacts the tick loop consumes:

* ``dst_idx``   — the flat NoC node each tile's output stream targets
  (default: MEM, exactly the legacy pattern),
* ``inc``       — route->link incidence of each stream
  (:func:`repro_torch.core.noc.flow_incidence` over the precomputed routing
  tables; shape ``(..., A, L)``, stacking over leading design axes),
* ``hop_counts``— per-stream hop counts (RTT + wire-term hop factor),
* ``demand``    — bytes/cycle each stream offers onto its route while the
  tile is busy (default: the model's ``own_demand``),
* ``forward``   — an ``(A, A)`` coupling matrix: ``forward[i, j]`` is the
  share of tile ``i``'s completions enqueued at tile ``j`` on the *next*
  tick (chain stages split uniformly over the following stage's replicas;
  a run-time :class:`~repro_torch.sim.control.LoadBalancer` may redistribute
  within the receiving group).  ``None`` when the pattern has no chains —
  the engines then skip the contraction entirely, keeping the legacy
  stream workload bit-for-bit unchanged.

The compiled arrays drop into the same einsum contractions
``engine.py:tick_step`` already runs, so the sequential engine, the
batched ``(B, A)`` engine and the fused kernel all consume a pattern
without new per-tick code paths.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.noc import flow_incidence, pos_index

MEM = "MEM"                     # destination sentinel: the memory tile


@dataclass(frozen=True)
class FlowPattern:
    """A named tile-to-tile traffic structure.

    ``stages`` is an optional accelerator chain: a sequence of disjoint
    tile-name groups where stage ``i``'s completions feed stage ``i+1``'s
    queues (the last stage's completions leave the SoC through MEM).
    Replicated stages are plain multi-tile groups.  ``dests`` overrides
    the wire destination of individual tiles (tile name or ``"MEM"``);
    by default a chained tile streams to its assigned next-stage replica
    (member ``j`` of stage ``i`` to member ``j mod len(stage i+1)``) and
    every other tile streams to MEM.  ``demand`` overrides bytes/cycle a
    tile's stream offers onto the NoC (default: the model's
    ``own_demand``).  Mappings may be passed as dicts; they are frozen to
    sorted tuples so patterns compare/hash structurally.
    """
    stages: Tuple[Tuple[str, ...], ...] = ()
    dests: Tuple[Tuple[str, str], ...] = ()
    demand: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        stages = tuple(tuple(str(t) for t in s) for s in self.stages)
        object.__setattr__(self, "stages", stages)
        d = self.dests.items() if isinstance(self.dests, dict) else self.dests
        dests = tuple(sorted((str(a), str(b)) for a, b in d))
        assert len({a for a, _ in dests}) == len(dests), \
            "contradictory dests: a tile appears as source twice"
        object.__setattr__(self, "dests", dests)
        dm = (self.demand.items() if isinstance(self.demand, dict)
              else self.demand)
        demand = tuple(sorted((str(a), float(v)) for a, v in dm))
        assert len({a for a, _ in demand}) == len(demand), \
            "contradictory demand: a tile appears twice"
        object.__setattr__(self, "demand", demand)
        seen: set = set()
        for s in stages:
            assert s, "empty chain stage"
            for t in s:
                assert t not in seen, f"tile {t!r} appears in two stages"
                seen.add(t)

    @classmethod
    def chain(cls, *stages, dests=(), demand=()) -> "FlowPattern":
        """Convenience constructor for a pure pipeline: each positional
        argument is one stage (a tile name or a group of names)."""
        norm = tuple((s,) if isinstance(s, str) else tuple(s)
                     for s in stages)
        return cls(stages=norm, dests=dests, demand=demand)

    # ------------------------------------------------------------ resolve
    def dest_map(self) -> Dict[str, str]:
        """tile -> destination tile name (or ``MEM``), chain defaults
        applied then explicit ``dests`` overrides."""
        out: Dict[str, str] = {}
        for i in range(len(self.stages) - 1):
            nxt = self.stages[i + 1]
            for j, t in enumerate(self.stages[i]):
                out[t] = nxt[j % len(nxt)]
        out.update(dict(self.dests))
        return out

    def demand_map(self) -> Dict[str, float]:
        return dict(self.demand)


@dataclass(frozen=True)
class CompiledFlows:
    """One design's flow pattern lowered to tick-loop arrays.

    Leading axes of ``dst_idx``/``inc``/``hop_counts`` follow the
    ``pos_idx`` the pattern was compiled against: ``(A,)`` rows for the
    sequential engine, ``(B, A)`` stacks for the batched one.  ``demand``
    is a plain float for the legacy MEM-stream pattern (bit-for-bit with
    the scalar ``own_demand`` constant) or an ``(A,)`` vector otherwise.
    ``stage_of`` maps each tile to its chain stage (-1 when unchained).
    """
    dst_idx: np.ndarray                 # (..., A) int64 flat node indices
    inc: np.ndarray                     # (..., A, L) 0/1 float64
    hop_counts: np.ndarray              # (..., A) int
    demand: object                      # float, or (A,) float64
    forward: Optional[np.ndarray]       # (A, A) float64, or None
    stage_of: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.int64))
    # 1.0 where a tile's completions LEAVE the SoC (no outgoing chain
    # coupling) — the engines count only exit services as "completed", so
    # a request traversing an N-stage chain is completed once, not N times
    exit_mask: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.float64))

    @property
    def chained(self) -> bool:
        return self.forward is not None


def compile_flows(model, names, pos_idx,
                  pattern: Optional[FlowPattern] = None) -> CompiledFlows:
    """Lower a :class:`FlowPattern` against one (or B stacked) concrete
    placements.

    ``names`` are the tile names in trace-destination order; ``pos_idx``
    their flat NoC node indices, shaped ``(A,)`` or ``(B, A)``.  With
    ``pattern=None`` this reproduces the legacy accelerator->MEM stream
    workload exactly (same incidence/hop tables, scalar demand, no
    forward coupling).
    """
    names = tuple(names)
    A = len(names)
    cfg = model.noc
    pos_idx = np.asarray(pos_idx, dtype=np.int64)
    assert pos_idx.shape[-1] == A, (pos_idx.shape, A)
    mem_idx = pos_index(cfg, model.mem_pos)
    stage_of = np.full(A, -1, dtype=np.int64)

    if pattern is None:
        dst_idx = np.full(pos_idx.shape, mem_idx, dtype=np.int64)
        inc, hop_counts = flow_incidence(cfg, pos_idx, dst_idx)
        return CompiledFlows(dst_idx=dst_idx, inc=inc,
                             hop_counts=hop_counts,
                             demand=float(model.own_demand), forward=None,
                             stage_of=stage_of, exit_mask=np.ones(A))

    col = {n: i for i, n in enumerate(names)}
    for s in pattern.stages:
        for t in s:
            assert t in col, f"chain stage tile {t!r} not on this platform"
    for i, s in enumerate(pattern.stages):
        for t in s:
            stage_of[col[t]] = i

    # wire destinations: chain defaults + explicit overrides, MEM otherwise
    dst_col = np.full(A, -1, dtype=np.int64)          # -1 -> MEM
    for src, dst in pattern.dest_map().items():
        assert src in col, f"flow source {src!r} not on this platform"
        if dst == MEM:
            continue
        assert dst in col, f"flow destination {dst!r} not on this platform"
        assert dst != src, f"tile {src!r} cannot stream to itself"
        dst_col[col[src]] = col[dst]
    dst_idx = np.where(dst_col >= 0,
                       np.take(pos_idx, np.maximum(dst_col, 0), axis=-1),
                       mem_idx).astype(np.int64)
    inc, hop_counts = flow_incidence(cfg, pos_idx, dst_idx)

    dm = pattern.demand_map()
    for t in dm:
        assert t in col, f"demand override for unknown tile {t!r}"
    demand = np.asarray([dm.get(n, model.own_demand) for n in names],
                        dtype=np.float64)

    forward: Optional[np.ndarray] = None
    exit_mask = np.ones(A)
    if len(pattern.stages) >= 2:
        forward = np.zeros((A, A), dtype=np.float64)
        for i in range(len(pattern.stages) - 1):
            nxt = pattern.stages[i + 1]
            share = 1.0 / len(nxt)
            for t in pattern.stages[i]:
                for u in nxt:
                    forward[col[t], col[u]] = share
        exit_mask = (forward.sum(axis=1) == 0.0).astype(np.float64)
    return CompiledFlows(dst_idx=dst_idx, inc=inc, hop_counts=hop_counts,
                         demand=demand, forward=forward, stage_of=stage_of,
                         exit_mask=exit_mask)
