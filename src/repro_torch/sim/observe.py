"""Run-time monitoring infrastructure for the port's co-sim engines.

The paper's third pillar (next to accelerator replication and per-island
DFS) is a dedicated monitoring subsystem exposing "a variety of statistics
related to the traffic on the interconnect and the accelerators'
performance at run time".  This module is that subsystem for the engines of
``repro_torch.sim`` (the sequential ``SimEngine`` and the batched
``BatchSimEngine``'s ``"torch"`` loop in float64 and float32):

* :class:`CounterPlane` — the hardware-counter plane: per-accelerator
  performance counters (invocations, busy/stall ticks, offered work,
  effective-vs-nominal capacity, hop-weighted traffic, contention
  exposure), per-link NoC counters (flit traffic, utilization integral,
  peak utilization), and the per-island energy integral, as host NumPy
  arrays.  Counters are windowed via :meth:`CounterPlane.reset`, which
  mirrors the ``manual_reset(counters, tiles=, kinds=)`` scoping semantics
  of ``core/monitor.py``.
* :class:`ControlTrace` + :class:`TraceEvent` — structured control-plane
  tracing: schema'd, monotonically tick-stamped events for DFS
  commits/guard discards, load-balancer splits, fault transitions,
  detector belief flips, and SLO-drop spans, in a ring-bounded store with
  JSONL export.
* :class:`Observer` — the engine-facing façade with the ``level=`` knob
  (``"off"`` / ``"counters"`` / ``"full"``) so ``closed_loop_score`` can
  run thousands of designs with counters on and tracing off.
* :class:`Profiler` / :func:`profiled` — phase profiling for sweep chunks
  and counter reconstruction.  A region that ends without a host sync on a
  CUDA device is timed by a pair of CUDA events, read when the phases are.

Zero-perturbation contract: everything here only *reads* the tensors
``tick_step`` already computes, and adds no host sync to a tick loop.  The
float64 loops use the :class:`DeferredCapture`: one slot write of the
contention slowdown per tick into a history preallocated on the engine's
device, plus the service terms in force, kept as device tensors, at each
recompute; the plane is rebuilt on that device after the run, chunk by
chunk over the ticks, and copied to the host once.  The float32 loop keeps
plain accumulators on the device (:class:`IncrementalCapture`) and hands
them over through :meth:`CounterPlane.from_arrays`.  The control-plane
events the loop learns on the device (SLO-drop spans, balancer weights) go
into device rings and are rebuilt into the trace after the loop, in the
order the reference's loop emits them.  Simulated numerics are bit-for-bit
identical with monitoring on or off.
"""

from __future__ import annotations

import json
import time
from collections import deque
from contextlib import ContextDecorator
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.perfmodel import (P_STATIC_W, chip_power,
                                        chip_power_dynamic)
from repro_torch.sim.telemetry import _json_safe

__all__ = [
    "LEVELS",
    "TRACE_KINDS",
    "TraceEvent",
    "ControlTrace",
    "CounterPlane",
    "CaptureContext",
    "DeferredCapture",
    "IncrementalCapture",
    "Observer",
    "Profiler",
    "profiled",
    "get_profiler",
    "reset_profiler",
    "export_metrics",
    "emit_trace",
    "schedule_entries",
]

LEVELS = ("off", "counters", "full")

PKT_BYTES = 512.0   # matches engine.py / core/monitor.py

# ---------------------------------------------------------------------------
# Control-plane trace
# ---------------------------------------------------------------------------

#: The trace schema: every event kind the control plane can emit, with the
#: payload keys it carries.  ``emit`` rejects unknown kinds so the trace
#: stays machine-readable (the whole point over ``Telemetry.event``).
TRACE_KINDS: Dict[str, str] = {
    "run_start": "engine run begins (ticks, dt, level)",
    "run_end": "engine run ends (completed, dropped, swaps)",
    "dfs_commit": "DFS actuator committed new island rates (version, rates)",
    "dfs_guard": "DFS guard discarded a requested move (islands, requested)",
    "dfs_clamp": "DFS request clamped to the tech node's legal DVFS "
                 "range (islands, requested)",
    "lb_split": "LoadBalancer split decision snapshot (mode, weights)",
    "slo_drop_start": "SLO deadline drops began (tiles)",
    "slo_drop_end": "SLO deadline drop span ended (ticks, dropped)",
    "fault_kill": "tile(s) killed (tiles)",
    "fault_revive": "tile(s) revived (tiles)",
    "fault_link_degrade": "link bandwidth degraded (a, b, scale)",
    "fault_link_restore": "link bandwidth restored (a, b)",
    "fault_stuck": "island actuator stuck at a hardware rate (island, rate)",
    "fault_unstuck": "island actuator released (island)",
    "detected_dead": "online detector believes tile(s) dead (tiles)",
    "detected_alive": "online detector believes tile(s) recovered (tiles)",
    "straggler_suspect": "online detector flags straggler tile(s) (tiles)",
}


@dataclass(frozen=True)
class TraceEvent:
    """One schema'd control-plane event: monotonic tick, registered kind,
    a short human subject (tile/island/link names), structured payload."""
    tick: int
    kind: str
    subject: str = ""
    data: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        return {"tick": self.tick, "kind": self.kind,
                "subject": self.subject, "data": _json_safe(self.data)}

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "TraceEvent":
        return cls(tick=int(d["tick"]), kind=str(d["kind"]),
                   subject=str(d.get("subject", "")),
                   data=dict(d.get("data", {})))


def _subject_of(kind: str, payload: Mapping[str, object]) -> str:
    """Derive a stable, human-readable subject from a payload dict."""
    if "tiles" in payload:
        tiles = payload["tiles"]
        if isinstance(tiles, (list, tuple)):
            return ",".join(str(t) for t in tiles)
        return str(tiles)
    if "island" in payload:
        return str(payload["island"])
    if "a" in payload and "b" in payload:
        return f"{payload['a']}-{payload['b']}"
    if "domain" in payload:
        return str(payload["domain"])
    return ""


class ControlTrace:
    """Ring-bounded store of :class:`TraceEvent` with JSONL export.

    Enforces the schema (``kind`` must be registered in :data:`TRACE_KINDS`)
    and monotonic tick stamps; bounded by ``capacity`` like every other
    long-soak store in the repo (oldest events fall off first).
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._events: Deque[TraceEvent] = deque(maxlen=self.capacity)
        self._last_tick = -1
        self.total_emitted = 0

    def __len__(self) -> int:
        return len(self._events)

    def emit(self, tick: int, kind: str, subject: str = "",
             **data: object) -> TraceEvent:
        if kind not in TRACE_KINDS:
            raise ValueError(
                f"unknown trace kind {kind!r}; registered kinds: "
                f"{sorted(TRACE_KINDS)}")
        tick = int(tick)
        if tick < self._last_tick:
            raise ValueError(
                f"non-monotonic trace tick {tick} after {self._last_tick}")
        self._last_tick = tick
        if not subject:
            subject = _subject_of(kind, data)
        ev = TraceEvent(tick=tick, kind=kind, subject=subject,
                        data=_json_safe(data))
        self._events.append(ev)
        self.total_emitted += 1
        return ev

    def events(self, kind: Optional[str] = None) -> List[TraceEvent]:
        if kind is None:
            return list(self._events)
        return [e for e in self._events if e.kind == kind]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self._events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def spans(self, start_kind: str, end_kind: str) -> List[Tuple[int, int]]:
        """(start_tick, end_tick) pairs for edge-triggered span events."""
        out: List[Tuple[int, int]] = []
        open_tick: Optional[int] = None
        for e in self._events:
            if e.kind == start_kind and open_tick is None:
                open_tick = e.tick
            elif e.kind == end_kind and open_tick is not None:
                out.append((open_tick, e.tick))
                open_tick = None
        return out

    # -- JSONL round trip ------------------------------------------------
    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(e.to_dict()) for e in self._events) + (
            "\n" if self._events else "")

    @classmethod
    def from_jsonl(cls, text: str, capacity: int = 4096) -> "ControlTrace":
        tr = cls(capacity=capacity)
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            ev = TraceEvent.from_dict(d)
            tr._events.append(ev)
            tr._last_tick = max(tr._last_tick, ev.tick)
            tr.total_emitted += 1
        return tr


# ---------------------------------------------------------------------------
# Hardware-counter plane
# ---------------------------------------------------------------------------

TILE_KINDS = ("offered", "invocations", "busy_ticks", "stall_ticks",
              "cap_sum", "hop_flits", "slowdown_sum")
LINK_KINDS = ("flits", "util_sum", "peak_util")
ISLAND_KINDS = ("energy_j",)
STALL_EPS = 1e-9    # queue threshold distinguishing exact-0 from cumsum dust


class CounterPlane:
    """The hardware-counter plane: per-tile / per-link / per-island
    accumulators with optional leading batch axes.

    Per-tile (``lead + (A,)``):

    - ``offered``       — Σ admitted requests
    - ``invocations``   — Σ served requests (accelerator invocations)
    - ``busy_ticks``    — Σ busy fraction (tick-integral of utilization)
    - ``stall_ticks``   — Σ 1[queue backlog after the tick > ε]
    - ``cap_sum``       — Σ per-tick capacity (nominal work the tile could
      have served; ``invocations / cap_sum`` is effective vs. nominal rate)
    - ``hop_flits``     — Σ served · pkts/req · hop count (hop-weighted
      traffic the tile's stream put on the fabric)
    - ``slowdown_sum``  — Σ (contention slowdown − 1) (exposure integral)

    Per-link (``lead + (L,)``):

    - ``flits``     — Σ offered link load / flit size
    - ``util_sum``  — Σ per-tick link utilization (load / f_noc-scaled bw)
    - ``peak_util`` — max-latched per-tick link utilization

    Per-island (``lead + (I,)``): ``energy_j`` — the energy integral, NoC
    share booked to the ``noc_mem`` island.

    :meth:`reset` mirrors ``core/monitor.py:manual_reset`` scoping —
    ``kinds=`` selects which counters clear (default: all), ``tiles=``
    restricts tile-kind clears to named/indexed tiles.
    """

    def __init__(self, n_tiles: int, n_links: int, n_islands: int, *,
                 lead: Tuple[int, ...] = (),
                 tile_names: Sequence[str] = (),
                 island_names: Sequence[str] = ()):
        self.n_tiles = int(n_tiles)
        self.n_links = int(n_links)
        self.n_islands = int(n_islands)
        self.lead = tuple(int(x) for x in lead)
        self.tile_names = tuple(tile_names)
        self.island_names = tuple(island_names)
        self.tile = {k: np.zeros(self.lead + (self.n_tiles,))
                     for k in TILE_KINDS}
        self.link = {k: np.zeros(self.lead + (self.n_links,))
                     for k in LINK_KINDS}
        self.island = {k: np.zeros(self.lead + (self.n_islands,))
                       for k in ISLAND_KINDS}
        self.ticks = np.zeros(self.lead)

    # -- construction ----------------------------------------------------
    @classmethod
    def from_arrays(cls, *, tile: Mapping[str, np.ndarray],
                    link: Mapping[str, np.ndarray],
                    island: Mapping[str, np.ndarray],
                    ticks, lead: Tuple[int, ...] = (),
                    tile_names: Sequence[str] = (),
                    island_names: Sequence[str] = ()) -> "CounterPlane":
        """Build a plane from already-accumulated arrays (the float32
        loop hands its accumulators over through this, after one copy)."""
        any_tile = next(iter(tile.values()))
        any_link = next(iter(link.values())) if link else np.zeros(lead + (0,))
        any_isl = next(iter(island.values())) if island else np.zeros(lead + (0,))
        cp = cls(any_tile.shape[-1], any_link.shape[-1], any_isl.shape[-1],
                 lead=lead, tile_names=tile_names, island_names=island_names)
        for k in TILE_KINDS:
            if k in tile:
                cp.tile[k] = np.asarray(tile[k], dtype=np.float64)
        for k in LINK_KINDS:
            if k in link:
                cp.link[k] = np.asarray(link[k], dtype=np.float64)
        for k in ISLAND_KINDS:
            if k in island:
                cp.island[k] = np.asarray(island[k], dtype=np.float64)
        cp.ticks = np.asarray(ticks, dtype=np.float64)
        return cp

    @classmethod
    def concat(cls, planes: Sequence["CounterPlane"],
               n: int) -> "CounterPlane":
        """Batched planes of the shards of a design axis joined in order
        along it, cut to the first ``n`` designs (the shards' pad)."""
        p0 = planes[0]
        cp = cls(p0.n_tiles, p0.n_links, p0.n_islands,
                 lead=(n,) + p0.lead[1:], tile_names=p0.tile_names,
                 island_names=p0.island_names)
        for group in ("tile", "link", "island"):
            for k in getattr(p0, group):
                getattr(cp, group)[k] = np.concatenate(
                    [getattr(p, group)[k] for p in planes])[:n]
        cp.ticks = np.concatenate([np.asarray(p.ticks)
                                   for p in planes])[:n]
        return cp

    # -- windowing -------------------------------------------------------
    def reset(self, kinds: Optional[Sequence[str]] = None,
              tiles: Optional[Sequence] = None) -> None:
        """Clear counters, ``manual_reset``-style.

        ``kinds`` — counter names to clear (default: every counter);
        ``tiles`` — restrict *tile-kind* clears to these tiles (names or
        indices); link/island kinds ignore the tile scope, as the monitor's
        per-tile scoping did for its per-tile counters.
        """
        if kinds is None:
            kinds = TILE_KINDS + LINK_KINDS + ISLAND_KINDS + ("ticks",)
        unknown = [k for k in kinds
                   if k not in TILE_KINDS + LINK_KINDS + ISLAND_KINDS
                   and k != "ticks"]
        if unknown:
            raise ValueError(f"unknown counter kinds {unknown}")
        idx = None
        if tiles is not None:
            idx = [self.tile_names.index(t) if isinstance(t, str) else int(t)
                   for t in tiles]
        for k in kinds:
            if k in TILE_KINDS:
                if idx is None:
                    self.tile[k][...] = 0.0
                else:
                    self.tile[k][..., idx] = 0.0
            elif k in LINK_KINDS:
                self.link[k][...] = 0.0
            elif k in ISLAND_KINDS:
                self.island[k][...] = 0.0
            elif k == "ticks" and idx is None:
                self.ticks = np.zeros(self.lead)

    # -- views -----------------------------------------------------------
    def design(self, b: int) -> "CounterPlane":
        """One design's scalar-lead view of a batched plane (copies)."""
        if not self.lead:
            raise ValueError("design() needs a batched (lead-axis) plane")
        cp = CounterPlane(self.n_tiles, self.n_links, self.n_islands,
                          lead=self.lead[1:], tile_names=self.tile_names,
                          island_names=self.island_names)
        for k in TILE_KINDS:
            cp.tile[k] = self.tile[k][b].copy()
        for k in LINK_KINDS:
            cp.link[k] = self.link[k][b].copy()
        for k in ISLAND_KINDS:
            cp.island[k] = self.island[k][b].copy()
        cp.ticks = np.asarray(self.ticks)[b].copy()
        return cp

    def snapshot(self) -> Dict[str, object]:
        return {
            "ticks": np.asarray(self.ticks).copy(),
            "tile": {k: v.copy() for k, v in self.tile.items()},
            "link": {k: v.copy() for k, v in self.link.items()},
            "island": {k: v.copy() for k, v in self.island.items()},
            "tile_names": self.tile_names,
            "island_names": self.island_names,
        }

    # -- derived rates ---------------------------------------------------
    def _per_tick(self, x: np.ndarray) -> np.ndarray:
        t = np.maximum(np.asarray(self.ticks, dtype=np.float64), 1.0)
        return x / t[..., None] if x.ndim > np.ndim(t) else x / t

    def effective_rate(self) -> np.ndarray:
        """Served / nominal-capacity per tile — the paper's effective vs.
        nominal accelerator rate."""
        cap = self.tile["cap_sum"]
        return np.where(cap > 0.0, self.tile["invocations"]
                        / np.where(cap > 0.0, cap, 1.0), 0.0)

    def mean_busy(self) -> np.ndarray:
        return self._per_tick(self.tile["busy_ticks"])

    def stall_frac(self) -> np.ndarray:
        return self._per_tick(self.tile["stall_ticks"])

    def mean_slowdown(self) -> np.ndarray:
        return 1.0 + self._per_tick(self.tile["slowdown_sum"])

    def link_utilization(self) -> np.ndarray:
        return self._per_tick(self.link["util_sum"])

    def summary(self) -> Dict[str, float]:
        """Scalar roll-up (per-design when lead axes are present this
        reduces over them too) — what ``closed_loop_score`` attaches to
        each survivor."""
        inv = self.tile["invocations"]
        return {
            "ticks": float(np.asarray(self.ticks).max(initial=0.0)),
            "offered": float(self.tile["offered"].sum()),
            "invocations": float(inv.sum()),
            "busy_frac": float(self.mean_busy().mean()) if inv.size else 0.0,
            "stall_frac": float(self.stall_frac().mean()) if inv.size else 0.0,
            "effective_rate": float(self.effective_rate().mean())
            if inv.size else 0.0,
            "hop_flits": float(self.tile["hop_flits"].sum()),
            "mean_slowdown": float(self.mean_slowdown().mean())
            if inv.size else 1.0,
            "link_flits": float(self.link["flits"].sum()),
            "peak_link_util": float(self.link["peak_util"].max(initial=0.0)),
            "mean_link_util": float(self.link_utilization().mean())
            if self.link["util_sum"].size else 0.0,
            "energy_j": float(self.island["energy_j"].sum()),
        }

    def allclose(self, other: "CounterPlane", *, rtol: float = 1e-9,
                 atol: float = 1e-9) -> bool:
        for mine, theirs in ((self.tile, other.tile),
                             (self.link, other.link),
                             (self.island, other.island)):
            for k in mine:
                if not np.allclose(mine[k], theirs[k], rtol=rtol, atol=atol):
                    return False
        return bool(np.allclose(self.ticks, other.ticks,
                                rtol=rtol, atol=atol))


# ---------------------------------------------------------------------------
# Capture strategies
# ---------------------------------------------------------------------------

# element budget of each temporary :meth:`DeferredCapture.finalize` makes
# over a chunk of ticks (its (ticks, B, A) / (ticks, B, L) work tensors)
FINALIZE_CHUNK_ELEMS = 1 << 22


def _running(acc: torch.Tensor, x: torch.Tensor, exact: bool
             ) -> torch.Tensor:
    """``acc`` plus the sum of ``x`` over its first (tick) axis.

    ``exact`` (CPU tensors) adds tick by tick in order, as NumPy adds an
    outer-axis sum: torch's running sum is sequential on the CPU, and the
    running total rides in as its first row so chunks continue one
    sequence.  On the card the sum adds in torch's (parallel) order, within
    n u relative of the sequential one (n ticks, u the unit roundoff)."""
    if exact:
        return torch.cumsum(torch.cat([acc.unsqueeze(0), x]), dim=0)[-1]
    return acc + x.sum(dim=0)


@dataclass(frozen=True)
class CaptureContext:
    """Everything a capture needs from the engine, read-only: the
    ``StepConsts`` digest (``(B, A)`` / ``(B, A, L)`` tensors on the
    engine's device; B = 1 for the sequential engine) plus the host
    tile->island map."""
    base_mbps: torch.Tensor
    req_mb: torch.Tensor
    hop_counts: torch.Tensor
    link_bw: float
    noc_power_share: float
    dt: float
    island_of_tile: np.ndarray      # (A,) -> island index
    noc_island: int
    n_links: int
    n_islands: int
    dynamic_contention: bool = True
    own_demand: object = None       # float, or (A,) flow MB/s tensor
    inc: Optional[torch.Tensor] = None      # (B, A, L) incidence

    @classmethod
    def from_consts(cls, consts, *, island_of_tile: np.ndarray,
                    noc_island: int, n_links: int,
                    n_islands: int) -> "CaptureContext":
        return cls(base_mbps=consts.base_mbps, req_mb=consts.req_mb,
                   hop_counts=consts.hop_counts,
                   link_bw=float(consts.link_bw),
                   noc_power_share=float(consts.noc_power_share),
                   dt=float(consts.dt),
                   island_of_tile=np.asarray(island_of_tile, np.int64),
                   noc_island=int(noc_island), n_links=int(n_links),
                   n_islands=int(n_islands),
                   dynamic_contention=bool(consts.dynamic_contention),
                   own_demand=consts.own_demand, inc=consts.inc)

    def island_onehot(self) -> np.ndarray:
        """(A, I) membership used to scatter per-tile power to islands."""
        A = self.island_of_tile.shape[0]
        oh = np.zeros((A, self.n_islands))
        oh[np.arange(A), self.island_of_tile] = 1.0
        return oh


class DeferredCapture:
    """Deferred capture for the float64 tick loops (the sequential engine,
    ``lead=()``, and the batched ``"torch"`` loop, ``lead=(B,)``): the
    per-tick hot path is ONE slot write of the ``dyn`` row into a ``(T, B,
    A)`` history preallocated on the engine's device, plus the service
    terms in force at each recompute (device tensors; the engine never
    writes a service tensor in place, so they are kept, not copied).
    Everything else, the link loads included, is reconstructed at
    :meth:`finalize` on that device from the histories the engine already
    keeps: the wire load at tick ``t`` is a pure function of the
    *previous* tick's busy fractions (``tick_step`` contracts
    ``own_demand * busy`` over the incidence before updating ``busy``),
    and busy itself replays exactly as ``served / cap``."""

    def __init__(self, ctx: CaptureContext, T: int, *,
                 lead: Tuple[int, ...] = (),
                 tile_alive: Optional[torch.Tensor] = None,
                 link_scale: Optional[torch.Tensor] = None,
                 tile_names: Sequence[str] = (),
                 island_names: Sequence[str] = ()):
        self.ctx = ctx
        self.T = int(T)
        self.lead = tuple(int(x) for x in lead)
        B, A = ctx.base_mbps.shape
        assert self.lead in ((B,), ()) and (self.lead or B == 1), \
            (self.lead, B)
        self._dyn = torch.empty((self.T, B, A), dtype=ctx.base_mbps.dtype,
                                device=ctx.base_mbps.device)
        self._segments: List[Tuple[int, Dict[str, torch.Tensor]]] = []
        self._tile_alive = tile_alive            # (T, A) or None
        self._link_scale = link_scale            # (T, L) or None
        self.tile_names = tuple(tile_names)
        self.island_names = tuple(island_names)
        self.plane: Optional[CounterPlane] = None

    # hot path -----------------------------------------------------------
    def on_service(  # repro: hot
            self, start_tick: int, svc: Mapping[str, object]) -> None:
        """Record a service-term segment starting at ``start_tick``
        (run start, stuck-actuator apply, or the tick after a commit)."""
        self._segments.append((int(start_tick), {
            k: svc[k] for k in ("t_comp", "t_wire", "t_ref", "f_tile",
                                "f_noc")}))

    def on_tick(self, t_i: int, out) -> None:  # repro: hot
        self._dyn[t_i] = out.dyn

    def segment_starts(self) -> List[int]:
        return sorted({s for s, _ in self._segments})

    def split_at(self, ticks) -> None:
        """Add segment boundaries at ``ticks``, each keeping the service
        terms in force there.  The plane's sums over a segment restart at
        every boundary, so a shard of a design batch, split where any design
        of the batch committed, sums its designs' ticks in the groups the
        whole batch's run does."""
        segs = sorted(self._segments, key=lambda s: s[0])
        have = {s for s, _ in segs}
        for t in sorted(set(int(t) for t in ticks) - have):
            if 0 < t < self.T:
                self._segments.append(
                    (t, [svc for s, svc in segs if s <= t][-1]))

    # reconstruction -----------------------------------------------------
    def finalize(self, admitted: torch.Tensor, served: torch.Tensor,
                 queue_drops: Optional[torch.Tensor] = None
                 ) -> CounterPlane:
        """Rebuild the counter plane from the engine's ``(T, B, A)``
        histories and the captured dyn rows, on their device, then copy it
        to the host once.  Capacity is recomputed segment by segment with
        the *identical* float expression ``tick_step`` used, so ``busy =
        served / cap`` reconstructs the exact per-tick busy fractions the
        engine produced.  The ticks go through in chunks of at most
        :data:`FINALIZE_CHUNK_ELEMS` elements per temporary, each sum
        carried across chunks in the reference's order on CPU tensors
        (:func:`_running`)."""
        ctx, T, lead = self.ctx, self.T, self.lead
        A, L = ctx.base_mbps.shape[-1], ctx.n_links
        cp = CounterPlane(A, L, ctx.n_islands, lead=lead,
                          tile_names=self.tile_names,
                          island_names=self.island_names)
        if T == 0:
            self.plane = cp
            return cp
        segs = sorted(self._segments, key=lambda s: s[0])
        assert segs and segs[0][0] == 0, "on_service(0, svc) never recorded"
        bounds = [s[0] for s in segs] + [T]

        dyn_all = self._dyn
        B, dev, f64 = dyn_all.shape[1], dyn_all.device, dyn_all.dtype
        exact = dev.type == "cpu"
        links = (ctx.dynamic_contention and ctx.own_demand is not None
                 and ctx.inc is not None)
        alive, lscale = self._tile_alive, self._link_scale
        pkt = ctx.req_mb * 1e6 / PKT_BYTES

        def zeros(*shape, dtype=f64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        acc = {k: zeros(B, A) for k in ("offered", "invocations",
                                         "busy_ticks", "cap_sum",
                                         "hop_flits", "slowdown_sum",
                                         "power")}
        stall = zeros(B, A, dtype=torch.int64)
        queue = zeros(B, A)          # backlog after the last tick done
        busy_prev = zeros(B, A)      # busy of the tick before (0 at start)
        noc_sum = zeros(B)           # lead=(B,): the NoC power integral
        noc_rows: List[Tuple[torch.Tensor, int]] = []   # lead=(): per seg
        flit_sum, util_sum, peak = zeros(B, L), zeros(B, L), zeros(B, L)
        step = max(1, FINALIZE_CHUNK_ELEMS // (B * max(A, L, 1)))

        for (s, svc), e in zip(segs, bounds[1:]):
            if e <= s:
                continue
            # factors of the seg's expressions that depend on rates alone,
            # each the value the per-tick expression forms elementwise
            cap_num = ctx.base_mbps * svc["t_ref"]
            p_dyn = chip_power_dynamic(svc["f_tile"])
            noc_p = ctx.noc_power_share * chip_power(svc["f_noc"], 1.0)
            seg_sum, seg_max = zeros(B, L), zeros(B, L)
            for a in range(s, e, step):
                b = min(a + step, e)
                dyn = dyn_all[a:b]
                srv = served[a:b]
                # identical op order to tick_step's cap_tick expression
                cap = (cap_num / (svc["t_comp"] + svc["t_wire"] * dyn)
                       / ctx.req_mb) * ctx.dt
                if alive is None:
                    cap_eff = cap
                    busy = srv / cap
                else:
                    live = alive[a:b].unsqueeze(1)
                    cap_eff = cap * live
                    pos = cap_eff > 0.0
                    busy = torch.where(
                        pos, srv / torch.where(pos, cap_eff, 1.0), 0.0)
                # queue after each tick: cumulative admitted - exits
                exits = srv if queue_drops is None else srv + queue_drops[a:b]
                q_after = torch.cumsum(torch.cat(
                    [queue.unsqueeze(0), admitted[a:b] - exits]), dim=0)[1:]
                queue = q_after[-1]
                stall += (q_after > STALL_EPS).sum(dim=0)
                for k, x in (("offered", admitted[a:b]),
                             ("invocations", srv), ("busy_ticks", busy),
                             ("cap_sum", cap_eff),
                             ("hop_flits", srv * pkt * ctx.hop_counts),
                             ("slowdown_sum", dyn - 1.0)):
                    acc[k] = _running(acc[k], x, exact)
                power = P_STATIC_W + p_dyn * busy      # chip_power(f, busy)
                if alive is not None:
                    power = power * live
                acc["power"] = _running(acc["power"], power, exact)
                if lead:
                    noc_sum = _running(noc_sum, noc_p.expand(b - a, B),
                                       exact)
                if links:
                    # tick_step's contraction of own_demand * busy[t-1]
                    # over the incidence, tile by tile in order
                    x = ctx.own_demand * torch.cat(
                        [busy_prev.unsqueeze(0), busy[:-1]])
                    loads = x[..., 0, None] * ctx.inc[:, 0]
                    for t in range(1, A):
                        loads = loads + x[..., t, None] * ctx.inc[:, t]
                    if lscale is not None:
                        loads = loads / lscale[a:b].unsqueeze(1)
                    seg_sum = _running(seg_sum, loads, exact)
                    seg_max = torch.maximum(seg_max, loads.amax(dim=0))
                busy_prev = busy[-1]
            if not lead:
                noc_rows.append((noc_p, e - s))
            if links:
                # the reductions divide by the piecewise-constant NoC
                # frequency AFTER the tickwise sum/max (division by a
                # positive constant is monotonic, so max commutes with it)
                denom = ctx.link_bw * svc["f_noc"].unsqueeze(-1)
                flit_sum = flit_sum + seg_sum
                util_sum = util_sum + seg_sum / denom
                peak = torch.maximum(peak, seg_max / denom)

        # one copy of the whole plane to the host
        parts = [acc[k] for k in ("offered", "invocations", "busy_ticks",
                                  "cap_sum", "hop_flits", "slowdown_sum",
                                  "power")]
        parts += [stall.to(f64), flit_sum, util_sum, peak]
        parts += ([noc_sum] if lead else [p for p, _ in noc_rows])
        host = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        cut = np.cumsum([p.numel() for p in parts])[:-1]
        chunks = np.split(host, cut)
        shaped = [c.reshape(p.shape) for c, p in zip(chunks, parts)]
        (offered, invocations, busy_ticks, cap_sum, hop_flits,
         slowdown_sum, power_sum, stall_h, flits, util, peak_h) = shaped[:11]
        pick = (lambda x: x) if lead else (lambda x: x[0])
        cp.tile["offered"] = pick(offered)
        cp.tile["invocations"] = pick(invocations)
        cp.tile["busy_ticks"] = pick(busy_ticks)
        cp.tile["stall_ticks"] = pick(stall_h)
        cp.tile["cap_sum"] = pick(cap_sum)
        cp.tile["hop_flits"] = pick(hop_flits)
        cp.tile["slowdown_sum"] = pick(slowdown_sum)
        if links:
            cp.link["flits"] = pick(flits) / PKT_BYTES
            cp.link["util_sum"] = pick(util)
            cp.link["peak_util"] = pick(peak_h)

        energy = (pick(power_sum) * ctx.dt) @ ctx.island_onehot()
        if ctx.noc_island >= 0:
            if lead:
                noc_energy = shaped[11] * ctx.dt
            else:
                # the (T,) NoC power row summed as NumPy sums a 1-D array
                per_tick = np.repeat(np.concatenate(shaped[11:]),
                                     [n for _, n in noc_rows])
                noc_energy = per_tick.sum(axis=0) * ctx.dt
            energy[..., ctx.noc_island] += noc_energy
        cp.island["energy_j"] = energy
        cp.ticks = np.full(lead, float(T))
        self.plane = cp
        return cp


class IncrementalCapture:
    """Capture by straight per-tick accumulation, for the float32 loop:
    plain ``(B, ·)`` float64 accumulators on the engine's device, adds of
    the tick's own tensors (no ``(T, ·)`` history, so memory stays bounded
    at large B), and the plane built through
    :meth:`CounterPlane.from_arrays` from one copy at :meth:`finalize`.

    Three sums are formed from accumulated factors rather than per-tick
    products (within float rounding of the per-tick form, the tolerance
    the float32 loop is held to): the tile power adds ``p_dyn * busy`` and
    books the static power per live tick, the slowdown adds ``dyn`` and
    takes the tick count off, and the NoC power adds each tick's value."""

    def __init__(self, ctx: CaptureContext, *, lead: Tuple[int, ...],
                 tile_names: Sequence[str] = (),
                 island_names: Sequence[str] = ()):
        self.ctx = ctx
        self.lead = tuple(int(x) for x in lead)
        B, A = ctx.base_mbps.shape
        dev = ctx.base_mbps.device
        self.tile_names = tuple(tile_names)
        self.island_names = tuple(island_names)

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float64, device=dev)

        self._tile = {k: z(B, A) for k in TILE_KINDS}
        self._link = {k: z(B, ctx.n_links) for k in LINK_KINDS}
        self._power = z(B, A)           # sum of p_dyn * busy
        self._alive = None              # sum of the alive rows, if given
        self._noc = z(B)                # sum of the NoC power
        self._pkt_hop = ctx.req_mb * 1e6 / PKT_BYTES * ctx.hop_counts
        self._svc = None                # the service dict of the factors
        self.ticks = 0
        self.plane: Optional[CounterPlane] = None

    def on_tick(  # repro: hot
            self, out, *, queue: torch.Tensor, busy: torch.Tensor,
            svc: Mapping[str, torch.Tensor],
            alive: Optional[torch.Tensor] = None) -> None:
        ctx, t = self.ctx, self._tile
        if svc is not self._svc:        # the rates changed: new factors
            self._svc = svc
            self._p_dyn = chip_power_dynamic(svc["f_tile"])
            self._noc_p = ctx.noc_power_share * chip_power(svc["f_noc"],
                                                           1.0)
        t["offered"] += out.admitted
        t["invocations"] += out.served
        t["busy_ticks"] += busy
        t["stall_ticks"] += queue > STALL_EPS
        t["cap_sum"] += out.cap_tick
        t["hop_flits"].addcmul_(out.served, self._pkt_hop)
        t["slowdown_sum"] += out.dyn
        if ctx.dynamic_contention and out.link_loads is not None:
            util = out.link_loads / svc["link_cap"]
            ln = self._link
            ln["flits"] += out.link_loads
            ln["util_sum"] += util
            torch.maximum(ln["peak_util"], util, out=ln["peak_util"])
        self._power.addcmul_(self._p_dyn, busy)
        if alive is not None:
            if self._alive is None:
                self._alive = torch.zeros_like(self._power)
            self._alive += alive
        self._noc += self._noc_p
        self.ticks += 1

    def finalize(self) -> CounterPlane:
        """The plane from one copy of the accumulators."""
        ctx, T = self.ctx, float(self.ticks)
        parts = ([self._tile[k] for k in TILE_KINDS]
                 + [self._link[k] for k in LINK_KINDS]
                 + [self._power, self._noc]
                 + ([] if self._alive is None else [self._alive]))
        host = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        cut = np.cumsum([p.numel() for p in parts])[:-1]
        arrs = [c.reshape(p.shape) for c, p in zip(np.split(host, cut),
                                                    parts)]
        nt, nl = len(TILE_KINDS), len(LINK_KINDS)
        tile = dict(zip(TILE_KINDS, arrs[:nt]))
        link = dict(zip(LINK_KINDS, arrs[nt:nt + nl]))
        power, noc = arrs[nt + nl], arrs[nt + nl + 1]
        live = arrs[nt + nl + 2] if self._alive is not None else T
        tile["slowdown_sum"] = tile["slowdown_sum"] - T
        link["flits"] = link["flits"] / PKT_BYTES
        energy = ((P_STATIC_W * live + power) * ctx.dt) @ ctx.island_onehot()
        if ctx.noc_island >= 0:
            energy[..., ctx.noc_island] += noc * ctx.dt
        self.plane = CounterPlane.from_arrays(
            tile=tile, link=link, island={"energy_j": energy},
            ticks=np.full(self.lead, T), lead=self.lead,
            tile_names=self.tile_names, island_names=self.island_names)
        return self.plane


# ---------------------------------------------------------------------------
# Profiler
# ---------------------------------------------------------------------------


class Profiler:
    """Phase accumulator: ``with prof.profile("sweep_chunk"):`` around a
    code region books its elapsed time under that phase name.

    On the host clock by default.  ``device=`` naming a CUDA device times
    the region by a pair of CUDA events on that device's current stream
    instead, so the region adds no host sync of its own; those times are
    read (waiting for the end event) when :attr:`phases` or
    :meth:`summary` is next read — after the run."""

    def __init__(self) -> None:
        self._phases: Dict[str, List[float]] = {}  # name -> [total_s, n]
        self._pending: List[Tuple[str, object, object]] = []

    @property
    def phases(self) -> Dict[str, List[float]]:
        for name, start, end in self._pending:
            end.synchronize()
            self.record(name, start.elapsed_time(end) / 1e3)
        self._pending = []
        return self._phases

    def _defer(self, name: str, start, end) -> None:
        """Keep a CUDA-timed region until it is read; past a few dozen
        pending regions, fold in those the device has finished (a query,
        not a wait), so a long run keeps few events alive."""
        self._pending.append((name, start, end))
        if len(self._pending) > 64:
            waiting = []
            for name_, s, e in self._pending:
                if e.query():
                    self.record(name_, s.elapsed_time(e) / 1e3)
                else:
                    waiting.append((name_, s, e))
            self._pending = waiting

    def record(self, name: str, seconds: float) -> None:
        slot = self._phases.setdefault(name, [0.0, 0])
        slot[0] += float(seconds)
        slot[1] += 1

    def profile(self, name: str, device=None) -> "_PhaseTimer":
        return _PhaseTimer(self, name, device)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": total, "count": count,
                       "mean_s": total / count if count else 0.0}
                for name, (total, count) in sorted(self.phases.items())}

    def reset(self) -> None:
        self._phases.clear()
        self._pending.clear()


class _PhaseTimer(ContextDecorator):
    def __init__(self, profiler: Profiler, name: str, device=None):
        self.profiler = profiler
        self.name = name
        dev = None if device is None else torch.device(device)
        self._cuda = dev if dev is not None and dev.type == "cuda" else None
        self._t0 = 0.0
        self._start = None

    def __enter__(self) -> "_PhaseTimer":
        if self._cuda is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self._cuda))
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._cuda is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self._cuda))
            self.profiler._defer(self.name, self._start, end)
        else:
            self.profiler.record(self.name, time.perf_counter() - self._t0)
        return False


_GLOBAL_PROFILER = Profiler()


def get_profiler() -> Profiler:
    """The process-global phase profiler (what :func:`profiled` books to
    when no explicit profiler is given)."""
    return _GLOBAL_PROFILER


def reset_profiler() -> None:
    _GLOBAL_PROFILER.reset()


def profiled(name: str, profiler: Optional[Profiler] = None, *,
             device=None) -> _PhaseTimer:
    """Context manager / decorator timing a phase into ``profiler`` (the
    global one by default); ``device=`` as in :class:`Profiler`::

        with observe.profiled("sweep_chunk", device=dev):
            evaluate(chunk)
    """
    return _PhaseTimer(profiler or _GLOBAL_PROFILER, name, device)


# ---------------------------------------------------------------------------
# Observer façade
# ---------------------------------------------------------------------------


class Observer:
    """Engine-facing monitoring façade with the ``level=`` knob.

    - ``"off"``       — no counters, no tracing (the engines skip every hook)
    - ``"counters"``  — hardware-counter plane only (the cheap mode the
      DSE loop runs at scale; also all the float32 loop records)
    - ``"full"``      — counters + control-plane tracing (+ SLO spans,
      balancer snapshots)

    One observer instance is bound to one engine; after a run,
    ``observer.counters`` holds the :class:`CounterPlane` and
    ``observer.trace`` the :class:`ControlTrace`.
    """

    def __init__(self, level: str = "counters", *,
                 trace_capacity: int = 4096,
                 profiler: Optional[Profiler] = None):
        if level not in LEVELS:
            raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
        self.level = level
        self.trace = ControlTrace(capacity=trace_capacity)
        self._counters: Optional[CounterPlane] = None
        self._counters_thunk = None
        self.profiler = profiler or get_profiler()

    @property
    def counters(self) -> Optional[CounterPlane]:
        """The last run's :class:`CounterPlane` — materialized lazily on
        first read.  The engines hand over a finalize thunk instead of a
        built plane (:meth:`attach_lazy`), so the tick loop never pays the
        reconstruction; it is booked to the phase profiler here, at read
        time, on the host clock (it ends in the plane's copy to the host,
        which waits for the device)."""
        if self._counters is None and self._counters_thunk is not None:
            thunk, self._counters_thunk = self._counters_thunk, None
            with self.profiler.profile("counters_finalize"):
                self._counters = thunk()
        return self._counters

    # -- coercion --------------------------------------------------------
    @classmethod
    def coerce(cls, observe) -> Optional["Observer"]:
        """Normalize an engine's ``observe=`` argument: ``None``/``"off"``
        -> no observer; a level string -> fresh observer; an
        :class:`Observer` -> itself."""
        if observe is None or observe == "off":
            return None
        if isinstance(observe, Observer):
            return observe if observe.enabled else None
        if isinstance(observe, str):
            return cls(level=observe)
        raise TypeError(f"observe= expects None, a level string in {LEVELS},"
                        f" or an Observer; got {type(observe).__name__}")

    @property
    def enabled(self) -> bool:
        return self.level != "off"

    @property
    def tracing(self) -> bool:
        return self.level == "full"

    def begin_run(self) -> None:
        """Reset per-run state (engines call this at run start): each run
        gets a fresh trace — mirroring :meth:`attach`, which replaces the
        counter plane — so a reused observer never trips the trace's
        monotonic-tick guard on the next run's tick 0."""
        self.trace = ControlTrace(capacity=self.trace.capacity)

    # -- tracing ---------------------------------------------------------
    def emit(self, tick: int, kind: str, subject: str = "",
             **data: object) -> None:
        if self.tracing:
            self.trace.emit(tick, kind, subject, **data)

    def emit_event_dict(self, tick: int, ev: Mapping[str, object]) -> None:
        """Adapter for the compiled-fault / supervisor event dicts: maps
        their ``kind`` + payload onto the trace schema."""
        if not self.tracing:
            return
        kind = str(ev["kind"])
        if kind not in TRACE_KINDS:
            return                      # foreign event kinds stay in telemetry
        payload = {k: v for k, v in ev.items() if k not in ("tick", "kind")}
        self.trace.emit(tick, kind, **payload)

    # -- capture construction -------------------------------------------
    def capture_sequential(self, *, T: int, consts, island_of_tile,
                           noc_island: int, n_links: int, n_islands: int,
                           lead=(), tile_alive=None, link_scale=None,
                           tile_names=(), island_names=()
                           ) -> DeferredCapture:
        """Deferred capture for the float64 tick loops — the sequential
        engine (``lead=()``) and the batched ``"torch"`` loop
        (``lead=(B,)``); both pay one slot write per tick."""
        ctx = CaptureContext.from_consts(
            consts, island_of_tile=island_of_tile, noc_island=noc_island,
            n_links=n_links, n_islands=n_islands)
        return DeferredCapture(ctx, T, lead=tuple(lead),
                               tile_alive=tile_alive,
                               link_scale=link_scale,
                               tile_names=tile_names,
                               island_names=island_names)

    def capture_incremental(self, *, lead, consts, island_of_tile,
                            noc_island: int, n_links: int, n_islands: int,
                            tile_names=(), island_names=()
                            ) -> IncrementalCapture:
        ctx = CaptureContext.from_consts(
            consts, island_of_tile=island_of_tile, noc_island=noc_island,
            n_links=n_links, n_islands=n_islands)
        return IncrementalCapture(ctx, lead=tuple(lead),
                                  tile_names=tile_names,
                                  island_names=island_names)

    def attach(self, plane: CounterPlane) -> CounterPlane:
        """Install a finished counter plane (accumulating across runs is
        the caller's concern; each run replaces the plane)."""
        self._counters = plane
        self._counters_thunk = None
        return plane

    def attach_lazy(self, thunk) -> None:
        """Install a zero-argument callable producing the run's
        :class:`CounterPlane`; it is invoked (once) on the first
        ``observer.counters`` read.  The captured histories are the
        engine's own run buffers — freshly allocated each run — so the
        thunk stays valid until the next run replaces it."""
        self._counters = None
        self._counters_thunk = thunk


# ---------------------------------------------------------------------------
# Trace assembly after a loop
# ---------------------------------------------------------------------------

# Within one tick the reference's loops emit trace events in this order:
# the schedule's transitions, the SLO-drop span edges, the supervisor's
# detections, the balancer's split, the controller's clamp / guard / commit,
# then (at the last tick) what closes the run.  The port learns some of
# them on the device and emits the whole trace after the loop, in that
# order (ControlTrace refuses a tick that goes backwards).
RANK_FAULT, RANK_SLO, RANK_DETECT, RANK_LB, RANK_CONTROL, RANK_END = range(6)


def schedule_entries(ev_by_tick: Mapping[int, Sequence[Mapping]]) -> list:
    """A compiled fault schedule's transitions (``events_by_tick()``) as
    trace entries ``(tick, rank, kind, subject, data)``; subject ``None``
    lets the trace derive it, as :meth:`Observer.emit_event_dict` does for
    the reference's event dicts."""
    return [(t, RANK_FAULT, ev["kind"], None,
             {k: v for k, v in ev.items() if k not in ("tick", "kind")})
            for t, evs in sorted(ev_by_tick.items()) for ev in evs]


def emit_trace(ob: "Observer", entries, subject: str, **start) -> None:
    """A run's trace into ``ob`` (fresh since ``begin_run``): ``run_start``
    at tick 0, then ``entries`` in tick order and, within a tick, by rank
    (a stable sort keeps the order they were made in)."""
    ob.emit(0, "run_start", subject=subject, **start)
    for tick, _, kind, subj, data in sorted(entries, key=lambda e: e[:2]):
        if subj is None:
            ob.emit_event_dict(tick, {"kind": kind, **data})
        else:
            ob.emit(tick, kind, subj, **data)


# ---------------------------------------------------------------------------
# Metrics-export bridge
# ---------------------------------------------------------------------------


def export_metrics(*, telemetry=None, counters: Optional[CounterPlane] = None,
                   trace: Optional[ControlTrace] = None,
                   registry=None, prefix: str = "sim"):
    """Render telemetry + the counter plane + the trace into a
    :class:`~repro_torch.sim.metrics.MetricsRegistry` (Prometheus-ready).

    Counter-plane series carry ``tile=`` / ``link=`` / ``island=`` labels;
    telemetry scalars become gauges of their latest row; trace kinds
    become an event counter.  All three inputs are host objects."""
    from repro_torch.sim.metrics import MetricsRegistry
    reg = registry if registry is not None else MetricsRegistry()

    if counters is not None:
        cp = counters
        tnames = (cp.tile_names if len(cp.tile_names) == cp.n_tiles
                  else tuple(str(i) for i in range(cp.n_tiles)))
        inames = (cp.island_names if len(cp.island_names) == cp.n_islands
                  else tuple(str(i) for i in range(cp.n_islands)))
        for k in TILE_KINDS:
            arr = np.asarray(cp.tile[k], dtype=np.float64)
            flat = arr.reshape(-1, cp.n_tiles).sum(axis=0)
            for a, name in enumerate(tnames):
                reg.counter(f"{prefix}_tile_{k}_total",
                            f"counter plane: per-tile {k}",
                            labels={"tile": name}, value=float(flat[a]))
        link_arr = np.asarray(cp.link["flits"], dtype=np.float64)
        for k in LINK_KINDS:
            arr = np.asarray(cp.link[k], dtype=np.float64)
            flat = (arr.reshape(-1, cp.n_links).max(axis=0)
                    if k == "peak_util"
                    else arr.reshape(-1, cp.n_links).sum(axis=0))
            metric = (reg.gauge if k == "peak_util" else reg.counter)
            for l in range(cp.n_links):
                metric(f"{prefix}_link_{k}" +
                       ("" if k == "peak_util" else "_total"),
                       f"counter plane: per-link {k}",
                       labels={"link": str(l)}, value=float(flat[l]))
        for k in ISLAND_KINDS:
            arr = np.asarray(cp.island[k], dtype=np.float64)
            flat = arr.reshape(-1, cp.n_islands).sum(axis=0)
            for i, name in enumerate(inames):
                reg.counter(f"{prefix}_island_{k}_total",
                            f"counter plane: per-island {k}",
                            labels={"island": name}, value=float(flat[i]))
        reg.gauge(f"{prefix}_observed_ticks",
                  "ticks accumulated into the counter plane",
                  value=float(np.asarray(cp.ticks).max(initial=0.0)))

    if telemetry is not None:
        doc = telemetry.to_dict()
        for name, series in doc.get("scalars", {}).items():
            if series:
                reg.gauge(f"{prefix}_telemetry_{name}",
                          f"latest telemetry {name}",
                          value=float(series[-1]))

    if trace is not None:
        for kind, n in sorted(trace.counts().items()):
            reg.counter(f"{prefix}_trace_events_total",
                        "control-plane trace events by kind",
                        labels={"kind": kind}, value=float(n))

    return reg
