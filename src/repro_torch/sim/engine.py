"""The shared numeric core of the closed-loop SoC simulation, on tensors.

One concrete design in array form (:class:`SimPlatform`, host-side NumPy as
in the reference package), and the per-tick step every engine of the port
runs (:func:`tick_step`): fluid queues advanced one tick at a time over
``(..., A)`` tensors, requests as fluid counts, never Python objects.

* service rates come from the same kernel as the static model
  (:meth:`SoCPerfModel.service_time_terms_batch`, the decomposed form of
  ``accel_throughput_batch``) and are recomputed by the caller only when a
  DFS commit changes island rates;
* NoC contention uses the precomputed routing tables: each tile's route
  link incidence is one static ``(A, L)`` 0/1 matrix, so per-tick link
  loads are one contraction and the worst-link utilization per route one
  masked max.  The resulting M/D/1 slowdown scales the *wire* term of the
  service time only;
* monitor counters follow the reference semantics vectorized: pkts/rtt
  accumulate until the controller's windowed read differences them.

Latency is reconstructed exactly (at tick granularity) after the run from
the cumulative arrival/service curves of each FIFO fluid queue: the
mid-rank of every tick's admitted batch is looked up in the cumulative
service curve with one ``searchsorted`` per tile, giving per-batch sojourn
times whose request-count-weighted percentiles are the reported p50/p99.
:func:`latency_percentiles` is the per-design NumPy form;
:func:`latency_percentiles_batch` does all designs at once with torch on
the device that holds the histories, bit for bit (an integer-delay sort in
place of the float64 latency sort; a design whose result could depend on
the order of its float sums goes to the per-design function).

:class:`SimEngine` replays a trace through ONE design with the scalar DFS
controller harness (and optionally a load balancer) in the loop; it runs the
batched engine's ``"torch"`` loop at B = 1.  Fault schedules, SLO
semantics and online fault detection (``sim/faults.py``,
``runtime/fault.py``) run through the ``None``-gated hooks of
:func:`tick_step`, so a fault-free run is the fault-free loop, op for op.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.islands import (IslandConfig, IslandSpec, NOC_LADDER,
                                      TILE_LADDER)
from repro_torch.core.noc import pos_index
from repro_torch.core.perfmodel import (AccelWorkload, NOC_POWER_SHARE,
                                        SoCPerfModel, chip_power,
                                        chip_power_dynamic,
                                        chip_power_from_dynamic)
from repro_torch.core.voltage import TechModel
from repro_torch.sim.flows import FlowPattern
from repro_torch.sim.telemetry import (Telemetry,  # noqa: F401
                                       weighted_percentiles)

PKT_BYTES = 512.0        # bytes per monitored packet (the C3 counters' unit)


# ---------------------------------------------------------------------------
# Platform: one concrete design, in array form
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimPlatform:
    """A simulatable SoC instance: per-accelerator-tile arrays + islands.

    Tile order is the trace's destination order.  ``islands`` is the
    *initial* island partition/rates; the controller (if any) evolves it at
    run time.  ``flows`` is an optional
    :class:`~repro_torch.sim.flows.FlowPattern` naming tile-to-tile streams
    and accelerator chains; ``None`` keeps the tile->MEM workload.
    """
    model: SoCPerfModel
    islands: IslandConfig
    names: Tuple[str, ...]
    base_mbps: np.ndarray           # (A,)
    wire_share: np.ndarray          # (A,)
    k: np.ndarray                   # (A,)
    pos_idx: np.ndarray             # (A,) flat NoC node indices
    req_mb: np.ndarray              # (A,) MB of stream payload per request
    n_tg: int = 0
    f_tg: float = 1.0
    flows: Optional["FlowPattern"] = None

    @property
    def n_tiles(self) -> int:
        return len(self.names)

    @classmethod
    def build(cls, model: SoCPerfModel,
              workloads: Sequence[AccelWorkload],
              positions: Sequence[Tuple[int, int]],
              *, names: Optional[Sequence[str]] = None,
              island_groups: Optional[Dict[str, Sequence[str]]] = None,
              rates: Optional[Dict[str, float]] = None,
              noc_rate: float = 1.0, req_mb: float = 0.1,
              n_tg: int = 0, f_tg: float = 1.0,
              flows: Optional["FlowPattern"] = None) -> "SimPlatform":
        """Assemble a platform from parallel workload/position lists.

        ``island_groups`` maps island name -> tile names (default: every
        tile is its own island — the paper's finest-grained DFS); a
        ``noc_mem`` island is always appended.  ``rates`` presets island
        rates (default 1.0).
        """
        assert len(workloads) == len(positions)
        if names is None:
            names = []
            for i, wl in enumerate(workloads):
                names.append(f"{wl.name}{i}")
        names = tuple(names)
        assert len(set(names)) == len(names), "duplicate tile names"
        taken = set()
        for p in positions:
            assert tuple(p) != tuple(model.mem_pos), "tile placed on MEM"
            assert tuple(p) not in taken, f"tile collision at {p}"
            taken.add(tuple(p))
        if island_groups is None:
            island_groups = {n: (n,) for n in names}
        rates = dict(rates or {})
        specs = [IslandSpec(iname, tuple(tiles), TILE_LADDER,
                            rate=float(rates.get(iname, 1.0)))
                 for iname, tiles in island_groups.items()]
        specs.append(IslandSpec("noc_mem", ("NOC", "MEM"), NOC_LADDER,
                                rate=float(rates.get("noc_mem", noc_rate))))
        return cls(
            model=model, islands=IslandConfig(tuple(specs)), names=names,
            base_mbps=np.asarray([w.base_mbps for w in workloads], float),
            wire_share=np.asarray([w.wire_share for w in workloads], float),
            k=np.asarray([float(w.replication) for w in workloads]),
            pos_idx=np.asarray([pos_index(model.noc, tuple(p))
                                for p in positions], dtype=np.int64),
            req_mb=np.full(len(names), float(req_mb)),
            n_tg=int(n_tg), f_tg=float(f_tg), flows=flows)

    @classmethod
    def from_design_point(cls, model: SoCPerfModel, dp,
                          workloads: Sequence[AccelWorkload],
                          *, req_mb: float = 0.1, n_tg: int = 0,
                          flows: Optional["FlowPattern"] = None
                          ) -> "SimPlatform":
        """Bridge from the DSE layer: instantiate a ``grid_sweep``
        survivor (a :class:`~repro_torch.core.dse.DesignPoint`) for replay —
        replication/placement from the point, island rates from its rate
        assignment.  Shared-rate points carry one ``acc`` rate; per-island
        points carry one rate per accelerator island keyed by tile name."""
        wls = [AccelWorkload(w.name, w.base_mbps, w.ai,
                             replication=int(dp.replication[w.name]))
               for w in workloads]
        shared = float(dp.rates.get("acc", 1.0))
        return cls.build(
            model, wls, [dp.placement[w.name] for w in workloads],
            names=[w.name for w in workloads],
            rates={**{w.name: float(dp.rates.get(w.name, shared))
                      for w in workloads},
                   "noc_mem": float(dp.rates.get("noc_mem", 1.0))},
            req_mb=req_mb, n_tg=n_tg, f_tg=float(dp.rates.get("tg", 1.0)),
            flows=flows)


# ---------------------------------------------------------------------------
# The per-tick step, factored out so every engine shares ONE numeric core
# ---------------------------------------------------------------------------


@dataclass
class TickState:
    """Mutable fluid-queue + counter state, leading batch axes allowed.

    All per-tile tensors are ``(..., A)``; ``dropped``/``energy`` and the
    fault/SLO ledgers (``dropped_slo``, ``dropped_fault``, ``retried``)
    reduce the tile axis away and are ``(...)``; ``retry_q`` is the
    re-spilled work class inside ``queue``.
    """
    queue: torch.Tensor
    busy: torch.Tensor
    pkts_in: torch.Tensor       # accumulate (monitor semantics)
    pkts_out: torch.Tensor      # accumulate
    rtt_acc: torch.Tensor       # accumulate
    dropped: torch.Tensor
    energy: torch.Tensor
    retry_q: Optional[torch.Tensor] = None
    dropped_slo: Optional[torch.Tensor] = None
    dropped_fault: Optional[torch.Tensor] = None
    retried: Optional[torch.Tensor] = None

    @classmethod
    def zeros(cls, shape: Tuple[int, ...], *, device,
              dtype: torch.dtype = torch.float64) -> "TickState":
        lead = shape[:-1]

        def z(s):
            return torch.zeros(s, dtype=dtype, device=device)

        return cls(queue=z(shape), busy=z(shape), pkts_in=z(shape),
                   pkts_out=z(shape), rtt_acc=z(shape), dropped=z(lead),
                   energy=z(lead), retry_q=z(shape), dropped_slo=z(lead),
                   dropped_fault=z(lead), retried=z(lead))


@dataclass(frozen=True)
class StepConsts:
    """Per-run constants of :func:`tick_step` (platform + config digest),
    tensors already on the engine's device.

    ``own_demand`` is the bytes/cycle each tile's output stream offers
    while busy — a float for the uniform-demand MEM pattern, an ``(A,)``
    tensor under a :class:`~repro_torch.sim.flows.FlowPattern` with per-flow
    demands.  ``forward`` is the optional ``(A, A)`` chain coupling (stage
    completions -> next stage's queue).
    """
    base_mbps: torch.Tensor     # (..., A)
    req_mb: torch.Tensor        # (..., A)
    hop_counts: torch.Tensor    # (..., A)
    inc: torch.Tensor           # (..., A, L) route->link incidence
    own_demand: object          # float or (A,) tensor
    link_bw: float
    max_slow: float
    hop_latency: float
    noc_power_share: float
    dt: float
    max_queue: float
    dynamic_contention: bool
    forward: Optional[torch.Tensor] = None  # (A, A) chain coupling
    deadline_ticks: float = float("inf")    # SLO deadline in ticks
    tech: Optional[TechModel] = None        # physical DVFS model (None =
                                            # linear voltage proxy)


@dataclass(frozen=True)
class TickOut:
    """Per-tick outputs the surrounding loop needs (histories, controller
    inputs); the persistent state lives in :class:`TickState`."""
    admitted: torch.Tensor      # (..., A)
    served: torch.Tensor        # (..., A)
    cap_tick: torch.Tensor      # (..., A) requests servable this tick
    rho: torch.Tensor           # (..., A) worst-link utilization per route
    dyn: torch.Tensor           # (..., A) contention slowdown on the wire
    tile_power: torch.Tensor    # (...)
    noc_power: torch.Tensor     # (...)
    forwarded: Optional[torch.Tensor] = None    # (..., A) chained
                                                # completions for NEXT tick
    slo_drop: Optional[torch.Tensor] = None     # (..., A) deadline drops
    link_loads: Optional[torch.Tensor] = None   # (..., L) offered loads


def sum_tiles(x: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing (tile) axis in the order NumPy's ``sum(axis=-1)``
    adds, so per-tile reductions come out bit for bit as the reference's
    (torch's own last-axis sum adds in another order from 5 terms up).

    NumPy's pairwise summation of up to 128 terms: in order below 8, else
    eight running partial sums combined as a tree, then the remainder in
    order.  A platform has at most 15 tiles (a 4x4 NoC less MEM)."""
    cols = x.unbind(-1)
    n = len(cols)
    assert n <= 128, n
    if n < 8:
        acc, i = cols[0], 1
    else:
        # the eight partial sums as one (..., 8) tensor, then their tree
        # a level at a time: the same additions, three launches
        r = x[..., :8]
        i = 8
        while i < n - n % 8:
            r = r + x[..., i:i + 8]
            i += 8
        r = r[..., 0::2] + r[..., 1::2]
        r = r[..., 0::2] + r[..., 1::2]
        acc = r[..., 0] + r[..., 1]
    for c in cols[i:]:
        acc = acc + c
    return acc


def contention_slowdown(rho: torch.Tensor, max_slowdown: float
                        ) -> torch.Tensor:
    """M/D/1-style service slowdown from utilization (tensor form of
    :func:`repro_torch.core.noc.contention_slowdown`)."""
    r = torch.clamp(rho, max=0.999)
    return torch.clamp(1.0 + r / (2.0 * (1.0 - r)), max=max_slowdown)


def service_terms(svc: Dict[str, torch.Tensor], c: StepConsts
                  ) -> Dict[str, torch.Tensor]:
    """Complete the service terms of one island-rate set for
    :func:`tick_step`: ``t_comp`` / ``t_wire`` / ``t_ref`` and the tile rates
    ``f_tile`` (``(..., A)``) and ``f_noc`` (``(...)``) in; out, beside
    them, the factors of the tick's expressions that depend on the rates
    alone, each formed as the reference forms it inside its expression —
    ``cap_num`` (``base_mbps * t_ref``), ``link_cap`` (``link_bw * f_noc``),
    ``p_dyn`` (the tiles' busy-independent power factor) and ``noc_power``
    (the NoC+MEM island's power)."""
    out = dict(svc)
    out["cap_num"] = c.base_mbps * svc["t_ref"]
    out["link_cap"] = c.link_bw * svc["f_noc"].unsqueeze(-1)
    out["p_dyn"] = chip_power_dynamic(svc["f_tile"], tech=c.tech)
    out["noc_power"] = c.noc_power_share * chip_power(svc["f_noc"], 1.0,
                                                      tech=c.tech)
    return out


def tick_step(st: TickState, arr_t: torch.Tensor,
              svc: Dict[str, torch.Tensor], c: StepConsts, *,
              alive: Optional[torch.Tensor] = None,
              link_scale: Optional[torch.Tensor] = None,
              retry_in: Optional[torch.Tensor] = None) -> TickOut:
    """Advance the fluid queues by one tick (mutates ``st`` in place).

    ``svc`` is the service-term dict of the live island rates, recomputed
    by the caller only when a DFS commit changes them
    (:func:`service_terms`).  The expressions and their order are those of
    the reference ``tick_step``, with the factors that depend on the rates
    alone taken from ``svc``; reductions run over the trailing axes.

    Fault hooks (each ``None``-gated, so a fault-free tick runs none of
    their operations): ``alive`` is this tick's ``(A,)``
    availability row (dead tiles have zero capacity and are power-gated),
    ``link_scale`` the ``(L,)`` link-bandwidth scale row, ``retry_in`` this
    tick's re-spilled arrivals, tracked as a second fluid class inside the
    queue.  The SLO deadline (``c.deadline_ticks``) drops backlog beyond
    ``nominal capacity x deadline`` — nominal, not masked, so a dead tile's
    backlog is re-spilled by the recovery path before the deadline sees it.
    """
    q = st.queue + arr_t
    adm = arr_t
    if retry_in is not None:
        q0 = q                      # retry-class mixing denominator
        st.retry_q = st.retry_q + retry_in
    if c.max_queue != float("inf"):
        over = torch.clamp(q - c.max_queue, min=0.0)
        q = q - over
        adm = adm - over
        st.dropped += sum_tiles(over)
    if c.dynamic_contention:
        # live tile streams onto links: one contraction + masked max; link
        # capacity is f_noc-scaled like the static kernel's saturation term
        loads = ((c.own_demand * st.busy).unsqueeze(-1) * c.inc).sum(dim=-2)
        if link_scale is not None:
            loads = loads / link_scale
        rho = (c.inc * loads.unsqueeze(-2)).amax(dim=-1) / svc["link_cap"]
        dyn = contention_slowdown(rho, c.max_slow)
    else:
        loads = None
        rho = torch.zeros_like(q)
        dyn = torch.ones_like(q)
    cap_tick = (svc["cap_num"] / (svc["t_comp"] + svc["t_wire"] * dyn)
                / c.req_mb) * c.dt
    if alive is None:
        served = torch.minimum(q, cap_tick)
        st.queue = q - served
        st.busy = served / cap_tick
    else:
        cap_nominal = cap_tick
        cap_tick = cap_tick * alive
        served = torch.minimum(q, cap_tick)
        st.queue = q - served
        # a dead tile's busy is 0, not 0/0 (the reference's cap > 0 guard)
        pos = cap_tick > 0.0
        st.busy = torch.where(pos, served / torch.where(pos, cap_tick, 1.0),
                              0.0)
    slo_drop = None
    if c.deadline_ticks != float("inf"):
        horizon = ((cap_tick if alive is None else cap_nominal)
                   * c.deadline_ticks)
        slo_drop = torch.clamp(st.queue - horizon, min=0.0)
        st.queue = st.queue - slo_drop
        st.dropped_slo = st.dropped_slo + sum_tiles(slo_drop)
    if retry_in is not None:
        # proportional class mixing: the retry class shrinks by the same
        # factor the whole queue did (FIFO fluid — classes are blended)
        pos0 = q0 > 0.0
        st.retry_q = st.retry_q * torch.where(
            pos0, st.queue / torch.where(pos0, q0, 1.0), 0.0)

    # counters: pkts accumulate; exec_time (busy) auto-resets
    st.pkts_in += adm * c.req_mb * 1e6 / PKT_BYTES
    st.pkts_out += served * c.req_mb * 1e6 / PKT_BYTES
    st.rtt_acc += c.hop_counts * dyn * c.hop_latency

    tile_power = chip_power_from_dynamic(svc["p_dyn"] * st.busy, tech=c.tech)
    if alive is not None:           # dead tiles are power-gated
        tile_power = tile_power * alive
    tile_power = sum_tiles(tile_power)
    st.energy += (tile_power + svc["noc_power"]) * c.dt
    # chain coupling: a share of each stage's completions becomes next
    # tick's arrivals at the following stage
    forwarded = ((served.unsqueeze(-1) * c.forward).sum(dim=-2)
                 if c.forward is not None else None)
    return TickOut(admitted=adm, served=served, cap_tick=cap_tick, rho=rho,
                   dyn=dyn, tile_power=tile_power, noc_power=svc["noc_power"],
                   forwarded=forwarded, slo_drop=slo_drop, link_loads=loads)


# ---------------------------------------------------------------------------
# Latency reconstruction
# ---------------------------------------------------------------------------


def percentile_samples(admitted: np.ndarray, served: np.ndarray,
                       dt: float, queue_drops: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(latency values, request weights) of one design's run, from the
    cumulative arrival/service curves of its FIFO fluid queues (tick
    granularity): the mid-rank of every tick's admitted batch is looked up
    in the cumulative service curve with one ``searchsorted`` per tile.

    ``queue_drops`` (T, A), when given, holds work that left the queue
    *without* being served (SLO deadline drops, stranded-work drains) — it
    joins the exit curve so later arrivals' ranks still resolve."""
    T, A = admitted.shape
    ticks = np.arange(T, dtype=np.float64)
    vals: List[np.ndarray] = []
    wts: List[np.ndarray] = []
    for a in range(A):
        ca = np.cumsum(admitted[:, a])
        exits = (served[:, a] if queue_drops is None
                 else served[:, a] + queue_drops[:, a])
        cs = np.cumsum(exits)
        n = admitted[:, a]
        mid = ca - 0.5 * n          # mid-rank of each tick's batch
        depart = np.searchsorted(cs, mid, side="left")
        done = (depart < T) & (n > 0)
        lat = (depart - ticks + 0.5) * dt
        vals.append(lat[done])
        wts.append(n[done])
    if not vals:
        return np.empty(0), np.empty(0)
    return np.concatenate(vals), np.concatenate(wts)


def latency_percentiles(admitted: np.ndarray, served: np.ndarray,
                        dt: float, queue_drops: Optional[np.ndarray] = None
                        ) -> Tuple[float, float]:
    """Request-weighted p50/p99 sojourn time for one design's (T, A)
    admitted/served histories (NumPy, float64); ``queue_drops`` as in
    :func:`percentile_samples`."""
    if admitted.shape[0] == 0:
        return float("nan"), float("nan")
    v, w = percentile_samples(admitted, served, dt, queue_drops)
    if v.size == 0 or w.sum() <= 0:
        return float("nan"), float("nan")
    p50, p99 = weighted_percentiles(v, w, (50.0, 99.0))
    return float(p50), float(p99)


_U = 2.0 ** -53              # unit roundoff of float64


def _sum_error(n: int) -> float:
    """Bound, relative to the total, on how far two float64 sums of the same
    ``n`` non-negative terms added in any two orders can differ (twice the
    classical gamma_n = n u / (1 - n u) of each, plus a few roundings)."""
    return 2.0 * n * _U / (1.0 - n * _U) + 4.0 * _U


def _prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """Running sums along the last axis (in parallel on the card)."""
    return torch.cumsum(x, dim=-1)


def latency_percentiles_batch(admitted: torch.Tensor, served: torch.Tensor,
                              dt: float, *,
                              queue_drops: Optional[torch.Tensor] = None,
                              max_elems: int = 1 << 24
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p50/p99 of all B designs from ``(T, B, A)`` histories, on the device
    that holds them — bit for bit :func:`latency_percentiles` of each
    design, with the design axis written out.  ``queue_drops`` (``(T, B,
    A)``, optional) joins the exit curve as there: the exits are ``served +
    queue_drops``, formed in float64 as the reference forms them, and the
    bound and the host redo below cover that sum.

    * Cumulative arrival/service curves per (design, tile), the mid-rank
      ``searchsorted`` (left) of each tick's batch in the service curve.
    * A sample's latency ``(depart - t + 0.5) * dt`` is monotone in the
      integer delay ``d = depart - t``, so a *stable* sort of ``d`` (16-bit
      while T fits) puts the samples in the order of the reference's
      stable float64 sort of latencies; samples the reference filters out
      (batches not departed by the end, empty ticks) take the key ``T``
      and weight zero and sort after every kept one, whose order they
      leave unchanged.  Only the two selected samples' latencies are
      formed, in float64, as the reference forms them.
    * The reference adds every running sum in order; the card adds in a
      parallel order, which can round otherwise.  Where a column's terms
      are whole numbers below 2^52 (request counts) every order gives the
      same sums.  Elsewhere each comparison a result rests on (a mid-rank
      against its two neighbours in the service curve, a target against
      its two neighbours in the cumulative weights) must clear the bound
      of :func:`_sum_error` on how far the two orders can differ; a design
      with a comparison that does not is recomputed on the host by
      :func:`latency_percentiles` itself.  So the result is the
      reference's in every case, and the host sees only such designs
      (none on the main path's histories).

    Designs are processed in blocks of at most ``max_elems`` history
    elements to bound the temporaries.  ``latency_percentiles_batch.
    last_redone`` counts the designs the latest call recomputed.
    """
    T, B, A = admitted.shape
    dev = admitted.device
    f64 = torch.float64
    nan = torch.full((B,), float("nan"), dtype=f64, device=dev)
    if T == 0 or B == 0 or A == 0:
        return nan, nan.clone()
    p50, p99 = nan, nan.clone()
    ticks = torch.arange(T, device=dev)
    qs = torch.tensor([50.0, 99.0], dtype=f64, device=dev) / 100.0
    key_dtype = torch.int16 if T < (1 << 15) - 1 else torch.int32
    e_t, e_w = _sum_error(T), 2.0 * _sum_error(A * T)
    unsure = []
    step = max(1, int(max_elems) // (T * A))
    for b0 in range(0, B, step):
        b1 = min(b0 + step, B)
        nb = b1 - b0
        # (b, A, T): one contiguous curve per (design, tile), transposed
        # in the histories' own dtype, then widened
        n = admitted[:, b0:b1].permute(1, 2, 0).contiguous().to(f64)
        srv = served[:, b0:b1].permute(1, 2, 0).contiguous().to(f64)
        if queue_drops is not None:
            srv = srv + queue_drops[:, b0:b1].permute(1, 2, 0).to(f64)
        ca = _prefix_sums(n)
        cs = _prefix_sums(srv)
        mid = ca - 0.5 * n                      # mid-rank of each batch
        depart = torch.searchsorted(cs, mid, right=False)
        whole_n = ((n == torch.floor(n)).all(dim=-1, keepdim=True)
                   & (ca[..., -1:] < 2.0 ** 52))
        whole_s = ((srv == torch.floor(srv)).all(dim=-1, keepdim=True)
                   & (cs[..., -1:] < 2.0 ** 52))
        err = (torch.where(whole_n, 0.0, e_t * ca[..., -1:])
               + torch.where(whole_s, 0.0, e_t * cs[..., -1:]))
        below = torch.gather(cs, -1, torch.clamp(depart - 1, min=0))
        above = torch.gather(cs, -1, torch.clamp(depart, max=T - 1))
        sure = ((((depart == 0) | (below < mid - err))
                 & ((depart == T) | (above >= mid + err)))
                | (n == 0)).all(dim=-1)         # empty ticks weigh nothing
        done = (depart < T) & (n > 0)
        key = torch.where(done, depart - ticks, T).to(key_dtype)
        key = key.reshape(nb, A * T)            # tile-major, as concatenated
        order = torch.sort(key, dim=-1, stable=True).indices
        w = torch.where(done, n, 0.0).reshape(nb, A * T)
        cum = _prefix_sums(torch.gather(w, -1, order))
        total = cum[:, -1:]                                  # (b, 1)
        targets = qs * total                                 # (b, 2)
        idx = torch.clamp(torch.searchsorted(cum, targets, right=False),
                          max=A * T - 1)
        ew = torch.where(whole_n.all(dim=1), 0.0, e_w * total)
        below = torch.gather(cum, -1, torch.clamp(idx - 1, min=0))
        above = torch.gather(cum, -1, idx)
        sure_w = (((idx == 0) | (below < targets - ew))
                  & (above >= targets + ew)).all(dim=-1)
        unsure.append(torch.nonzero(~(sure.all(dim=-1) & sure_w)).flatten()
                      + b0)
        d = torch.gather(key, -1, torch.gather(order, -1, idx))
        out = (d.to(f64) + 0.5) * dt
        out = torch.where(total > 0, out, torch.full_like(out, float("nan")))
        p50[b0:b1] = out[:, 0]
        p99[b0:b1] = out[:, 1]
    redo = torch.cat(unsure).cpu().numpy()
    latency_percentiles_batch.last_redone = int(redo.size)
    if redo.size:
        adm_h = admitted[:, redo].to(f64).cpu().numpy()
        srv_h = served[:, redo].to(f64).cpu().numpy()
        qd_h = (None if queue_drops is None
                else queue_drops[:, redo].to(f64).cpu().numpy())
        exact = torch.as_tensor(
            [latency_percentiles(adm_h[:, j], srv_h[:, j], dt,
                                 *(() if qd_h is None else (qd_h[:, j],)))
             for j in range(redo.size)], dtype=f64, device=dev)
        where = torch.as_tensor(redo, device=dev)
        p50[where] = exact[:, 0]
        p99[where] = exact[:, 1]
    return p50, p99


latency_percentiles_batch.last_redone = 0


# ---------------------------------------------------------------------------
# Engine configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimConfig:
    control_interval: int = 50          # ticks between controller samples
    telemetry_interval: int = 20        # ticks between telemetry rows
    telemetry_capacity: int = 4096      # ring-buffer rows kept
    dynamic_contention: bool = True     # live NoC queueing on the wire term
    max_queue: float = float("inf")     # requests/tile before drops
    noc_power_share: float = NOC_POWER_SHARE   # the one shared energy model
                                        # constant (core/perfmodel.py)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


def _not_ported(what: str, knob: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: {knob}= not ported yet (ROADMAP queue A item {item})")


@dataclass
class SimResult:
    ticks: int
    dt: float
    offered: float                      # external requests from the trace
    completed: float                    # requests served; under a chained
                                        # FlowPattern only EXIT-stage
                                        # services count (each external
                                        # request completes once, not once
                                        # per stage)
    dropped: float                      # admission drops (max_queue)
    residual: float                     # still queued when the trace ended
    throughput_rps: float               # completed / simulated seconds
    p50_latency_s: float
    p99_latency_s: float
    energy_j: float
    energy_per_request_j: float
    mean_power_w: float
    swaps: int                          # actuator commits during the run
    elapsed_wall_s: float               # the tick loop, device synchronised
    telemetry: Telemetry
    dropped_slo: float = 0.0            # explicit SLO-deadline drops
    dropped_fault: float = 0.0          # stranded on dead replicas
    retried: float = 0.0                # re-spilled to surviving replicas
    # where the wall time of run() went, seconds (host clock, device
    # synchronised at each boundary): "loop", "percentiles", "copies"
    timings: Optional[Dict[str, float]] = None

    @property
    def ticks_per_s_wall(self) -> float:
        return self.ticks / self.elapsed_wall_s if self.elapsed_wall_s else 0.0

    @property
    def requests_per_s_wall(self) -> float:
        return (self.completed / self.elapsed_wall_s
                if self.elapsed_wall_s else 0.0)

    @property
    def dropped_total(self) -> float:
        """All explicit drops: admission + SLO deadline + fault-stranded."""
        return self.dropped + self.dropped_slo + self.dropped_fault

    @property
    def drop_rate(self) -> float:
        """Fraction of offered requests explicitly dropped."""
        return self.dropped_total / self.offered if self.offered > 0 else 0.0

    def summary(self) -> str:
        s = (f"{self.ticks} ticks ({self.ticks * self.dt:.1f}s sim, "
             f"{self.elapsed_wall_s:.2f}s wall, "
             f"{self.requests_per_s_wall:,.0f} req/s wall): "
             f"completed {self.completed:,.0f}/{self.offered:,.0f} "
             f"({self.throughput_rps:,.0f} rps), "
             f"p50 {self.p50_latency_s * 1e3:.2f}ms "
             f"p99 {self.p99_latency_s * 1e3:.2f}ms, "
             f"{self.energy_per_request_j * 1e3:.3f} mJ/req, "
             f"{self.swaps} DFS swaps")
        if self.dropped_total > 0:
            s += (f", dropped {self.dropped_total:,.0f} "
                  f"({self.drop_rate:.2%}: slo {self.dropped_slo:,.0f} "
                  f"fault {self.dropped_fault:,.0f}), "
                  f"retried {self.retried:,.0f}")
        return s


class SimEngine:
    """Ticks a :class:`SimPlatform` through a trace, controller in loop.

    The ``"torch"`` tick loop of ``sim/batch.py`` at B = 1 — the same
    tensors, expressions and order, so a one-design
    :class:`~repro_torch.sim.batch.BatchSimEngine` run equals this one bit
    for bit — with the scalar
    :class:`~repro_torch.sim.control.ControllerHarness` (DFS actuator,
    ``core/dfs.py`` policies) stepping on the host every
    ``control_interval`` ticks and an optional
    :class:`~repro_torch.sim.control.LoadBalancer` splitting arrivals on
    the device.  On the card nothing goes to the host inside the tick loop
    but each control tick's counter window (one copy); telemetry rows are
    written into device rings and copied once at the end; a commit sends
    its island rates up without waiting for the card and recomputes the
    service terms there.

    ``faults`` (a :class:`~repro_torch.sim.faults.FaultSchedule`) replays
    injected failures, ``slo`` (a :class:`~repro_torch.sim.faults.SLOConfig`;
    ``SLOConfig()`` when a schedule comes without one) fixes deadline and
    recovery semantics, and ``supervisor`` (a
    :class:`~repro_torch.runtime.fault.SimFaultSupervisor`) detects dead
    tiles online, on the device, routing recovery on its belief.  The
    schedule's masks go to the device before the loop;
    ``last_fault_histories`` holds the per-tick ledgers and
    ``queue_drops``.

    ``device=None`` means the CUDA card (and raises without one); the tests
    pass ``device="cpu"``.  ``observe`` is refused until ROADMAP queue A
    item 9 lands.
    """

    def __init__(self, platform: SimPlatform, *,
                 config: SimConfig = SimConfig(), controller=None,
                 balancer=None, faults=None, slo=None, supervisor=None,
                 observe=None, tech=None, device=None):
        from repro_torch import device as device_mod
        from repro_torch.sim.batch import BatchSimEngine, BatchSimPlatform
        if observe is not None and observe != "off":
            raise _not_ported("observer plane", "observe", "9")
        self.platform = platform
        self.config = config
        self.controller = controller    # a control.ControllerHarness or None
        self.device = device_mod.resolve(device)
        # physical DVFS model (core/voltage.py): tick energy becomes
        # power_scl * (P_static + P_dyn f V̂(f)^2) and DFS commits are
        # clamped to the node's legal [L, U] ratio range; None keeps the
        # linear voltage proxy bit for bit
        self.tech = TechModel.coerce(tech)
        if self.tech is not None and controller is not None \
                and getattr(controller, "tech", None) is None:
            # single clamping source: the engine's tech model governs the
            # harness unless the harness was built with its own
            controller.tech = self.tech
        self.balancer = balancer        # a control.LoadBalancer or None
        self.faults = faults            # a faults.FaultSchedule or None
        self.slo = slo                  # a faults.SLOConfig or None
        # online detection: a runtime.fault.SimFaultSupervisor, which sees
        # only sim observables (served/queue/capacity) — routing and
        # respill then act on its BELIEVED availability while the true
        # masks gate what the hardware serves
        self.supervisor = supervisor
        self.last_state: Optional[TickState] = None          # set by run()
        self.last_histories = None      # (admitted, served) (T, A) tensors
        self.last_fault_histories = None  # per-tick ledgers, (T,) tensors,
                                          # and queue_drops (T, A)
        self._batch = BatchSimEngine(
            BatchSimPlatform.stack([platform]), config=config,
            balancer=balancer, tech=self.tech, device=self.device)
        # the platform's compiled flows, as the reference engine keeps them
        self._forward = self._batch._forward

    # ------------------------------------------------------------ service
    @staticmethod
    def _rates(cfg: IslandConfig) -> np.ndarray:
        """``(1, I)`` per-island rates of one config — the wrapped B = 1
        engine's rate row."""
        return np.asarray([[i.rate for i in cfg.islands]])

    def capacity_rps(self, cfg: Optional[IslandConfig] = None) -> np.ndarray:
        """Uncontended per-tile service capacity (requests/s) — exactly
        ``accel_throughput_batch / req_mb`` for the given config (host
        NumPy, float64)."""
        return self._batch.capacity_rps(
            self._rates(cfg or self.platform.islands))[0]

    def step_consts(self, dt: float) -> StepConsts:
        """The :func:`tick_step` constants of this platform + config for a
        trace with tick length ``dt`` seconds (``(1, A)`` tensors on the
        engine's device)."""
        self._batch.config = self.config
        return self._batch.step_consts(dt)

    # ---------------------------------------------------------------- run
    def run(self, trace) -> SimResult:
        p, ctl = self.platform, self.controller
        A, T, dt = p.n_tiles, trace.ticks, trace.dt
        assert trace.n_dests == A, (trace.n_dests, A)
        eng = self._batch
        eng.config, eng.balancer = self.config, self.balancer
        eng.faults, eng.slo = self.faults, self.slo
        control = None
        if ctl is not None:
            ctl.begin_run()     # counter baselines reset per run
            live = ctl.live()
            swaps0 = ctl.actuator.swaps

            def control(t_i, window, dead=None, stuck=None):
                busy, bound, pin, pout, rtt, qticks = window[:, 0]
                new_cfg = ctl.step(
                    tick=t_i, names=p.names, busy=busy, boundness=bound,
                    pkts_in=pin, pkts_out=pout, rtt=rtt,
                    queue_ticks=qticks, dead=dead, stuck=stuck)
                if new_cfg is None:
                    return None
                rates = {i.name: i.rate for i in new_cfg.islands}
                return self._rates(new_cfg), {
                    "tick": int(t_i), "kind": "dfs_commit",
                    "version": new_cfg.version, "rates": rates}
        else:
            live = p.islands
        run = eng._loop(trace, self._rates(live), control,
                        supervisor=self.supervisor)
        st = run.state
        t0 = time.perf_counter()
        telem = run.rings.to_telemetry(run.events)
        run.timings["copies"] += time.perf_counter() - t0
        h = {k: float(v[0]) for k, v in eng._host_summary(
            trace, run.admitted, run.served, state=st,
            residual=sum_tiles(st.queue), timings=run.timings,
            queue_drops=run.qdrop).items()}
        completed, energy = h["completed"], h["energy"]
        # kept for post-run analysis and the differential tests: the
        # design axis of the B = 1 loop taken away
        self.last_state = TickState(**{
            f.name: getattr(st, f.name)[0]
            for f in dataclasses.fields(TickState)})
        self.last_histories = (run.admitted[:, 0], run.served[:, 0])
        fh = eng.last_fault_histories
        self.last_fault_histories = (
            None if fh is None else {k: v[:, 0] for k, v in fh.items()})
        offered = float(trace.arrivals.sum())
        sim_seconds = T * dt
        return SimResult(
            ticks=T, dt=dt, offered=offered, completed=completed,
            dropped=h["dropped"], residual=h["residual"],
            throughput_rps=completed / sim_seconds if sim_seconds else 0.0,
            p50_latency_s=h["p50"], p99_latency_s=h["p99"], energy_j=energy,
            # zero-completion (all-dropped) runs have no meaningful energy
            # per request: NaN, which rankers mask
            energy_per_request_j=(energy / completed if completed > 0
                                  else float("nan")),
            mean_power_w=energy / sim_seconds if sim_seconds else 0.0,
            swaps=ctl.actuator.swaps - swaps0 if ctl is not None else 0,
            elapsed_wall_s=run.timings["loop"], telemetry=telem,
            dropped_slo=h["dropped_slo"], dropped_fault=h["dropped_fault"],
            retried=h["retried"], timings=run.timings)
