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
the device that holds the histories, with the same arithmetic.

The sequential ``SimEngine`` and the fault/SLO hooks of ``tick_step`` are
not part of this slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.islands import (IslandConfig, IslandSpec, NOC_LADDER,
                                      TILE_LADDER)
from repro_torch.core.noc import pos_index
from repro_torch.core.perfmodel import (AccelWorkload, NOC_POWER_SHARE,
                                        SoCPerfModel, chip_power)
from repro_torch.core.voltage import TechModel
from repro_torch.sim.flows import FlowPattern

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

    All per-tile tensors are ``(..., A)``; ``dropped``/``energy`` reduce the
    tile axis away and are ``(...)``.  The fault/SLO ledgers of the
    reference are kept (zero) so downstream readers find the same fields.
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
    link_loads: Optional[torch.Tensor] = None   # (..., L) offered loads


def contention_slowdown(rho: torch.Tensor, max_slowdown: float
                        ) -> torch.Tensor:
    """M/D/1-style service slowdown from utilization (tensor form of
    :func:`repro_torch.core.noc.contention_slowdown`)."""
    r = torch.clamp(rho, max=0.999)
    return torch.clamp(1.0 + r / (2.0 * (1.0 - r)), max=max_slowdown)


def tick_step(st: TickState, arr_t: torch.Tensor,
              svc: Dict[str, torch.Tensor], c: StepConsts) -> TickOut:
    """Advance the fluid queues by one tick (mutates ``st`` in place).

    ``svc`` is the cached service-term dict (``t_comp``/``t_wire``/``t_ref``
    and ``f_tile`` shaped ``(..., A)``, ``f_noc`` ``(...)``) — recomputed by
    the caller only when a DFS commit changes island rates.  The
    expressions and their order are those of the reference ``tick_step``
    (fault-free branch); reductions run over the trailing axes.
    """
    q = st.queue + arr_t
    adm = arr_t
    if c.max_queue != float("inf"):
        over = torch.clamp(q - c.max_queue, min=0.0)
        q = q - over
        adm = adm - over
        st.dropped += over.sum(dim=-1)
    f_noc = svc["f_noc"]
    if c.dynamic_contention:
        # live tile streams onto links: one contraction + masked max; link
        # capacity is f_noc-scaled like the static kernel's saturation term
        loads = ((c.own_demand * st.busy).unsqueeze(-1) * c.inc).sum(dim=-2)
        rho = ((c.inc * loads.unsqueeze(-2)).amax(dim=-1)
               / (c.link_bw * f_noc.unsqueeze(-1)))
        dyn = contention_slowdown(rho, c.max_slow)
    else:
        loads = None
        rho = torch.zeros_like(q)
        dyn = torch.ones_like(q)
    cap_tick = (c.base_mbps * svc["t_ref"]
                / (svc["t_comp"] + svc["t_wire"] * dyn)
                / c.req_mb) * c.dt
    served = torch.minimum(q, cap_tick)
    st.queue = q - served
    st.busy = served / cap_tick

    # counters: pkts accumulate; exec_time (busy) auto-resets
    st.pkts_in += adm * c.req_mb * 1e6 / PKT_BYTES
    st.pkts_out += served * c.req_mb * 1e6 / PKT_BYTES
    st.rtt_acc += c.hop_counts * dyn * c.hop_latency

    tile_power = chip_power(svc["f_tile"], st.busy, tech=c.tech).sum(dim=-1)
    noc_power = c.noc_power_share * chip_power(f_noc, 1.0, tech=c.tech)
    st.energy += (tile_power + noc_power) * c.dt
    # chain coupling: a share of each stage's completions becomes next
    # tick's arrivals at the following stage
    forwarded = ((served.unsqueeze(-1) * c.forward).sum(dim=-2)
                 if c.forward is not None else None)
    return TickOut(admitted=adm, served=served, cap_tick=cap_tick, rho=rho,
                   dyn=dyn, tile_power=tile_power, noc_power=noc_power,
                   forwarded=forwarded, link_loads=loads)


# ---------------------------------------------------------------------------
# Latency reconstruction
# ---------------------------------------------------------------------------


def weighted_percentiles(values: np.ndarray, weights: np.ndarray,
                         qs: Sequence[float]) -> np.ndarray:
    """Percentiles of a weighted sample (weights = request counts per
    latency bin) — how per-tick aggregated latencies become request-level
    p50/p99 without expanding to one entry per request."""
    v = np.ravel(np.asarray(values, dtype=np.float64))
    w = np.ravel(np.asarray(weights, dtype=np.float64))
    keep = w > 0
    v, w = v[keep], w[keep]
    if v.size == 0:
        return np.full(len(qs), np.nan)
    order = np.argsort(v, kind="stable")
    v, w = v[order], w[order]
    cum = np.cumsum(w)
    targets = np.asarray(qs, dtype=np.float64) / 100.0 * cum[-1]
    idx = np.searchsorted(cum, targets, side="left")
    return v[np.minimum(idx, v.size - 1)]


def percentile_samples(admitted: np.ndarray, served: np.ndarray,
                       dt: float) -> Tuple[np.ndarray, np.ndarray]:
    """(latency values, request weights) of one design's run, from the
    cumulative arrival/service curves of its FIFO fluid queues (tick
    granularity): the mid-rank of every tick's admitted batch is looked up
    in the cumulative service curve with one ``searchsorted`` per tile."""
    T, A = admitted.shape
    ticks = np.arange(T, dtype=np.float64)
    vals: List[np.ndarray] = []
    wts: List[np.ndarray] = []
    for a in range(A):
        ca = np.cumsum(admitted[:, a])
        cs = np.cumsum(served[:, a])
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
                        dt: float) -> Tuple[float, float]:
    """Request-weighted p50/p99 sojourn time for one design's (T, A)
    admitted/served histories (NumPy, float64)."""
    if admitted.shape[0] == 0:
        return float("nan"), float("nan")
    v, w = percentile_samples(admitted, served, dt)
    if v.size == 0 or w.sum() <= 0:
        return float("nan"), float("nan")
    p50, p99 = weighted_percentiles(v, w, (50.0, 99.0))
    return float(p50), float(p99)


def latency_percentiles_batch(admitted: torch.Tensor, served: torch.Tensor,
                              dt: float, *, max_elems: int = 1 << 24
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p50/p99 of all B designs from ``(T, B, A)`` histories, on the device
    that holds them: :func:`latency_percentiles` with the design axis
    written out.

    Same float64 arithmetic and the same ordering rules as the per-design
    function: per-tile cumulative curves, mid-rank ``searchsorted``
    (left), samples concatenated tile-major, a *stable* sort by latency and
    a cumulative-weight ``searchsorted`` (left) for the two targets.
    Samples the per-design function filters out (batches not departed by
    the end, empty ticks) stay in the rectangular arrays with weight zero:
    adding 0.0 leaves every cumulative weight as it was, so the selected
    sample is the same one.  Designs are processed in blocks of at most
    ``max_elems`` history elements to bound the temporaries.
    """
    T, B, A = admitted.shape
    dev = admitted.device
    nan = torch.full((B,), float("nan"), dtype=torch.float64, device=dev)
    if T == 0 or B == 0 or A == 0:
        return nan, nan.clone()
    p50, p99 = nan, nan.clone()
    ticks = torch.arange(T, dtype=torch.float64, device=dev)
    qs = torch.tensor([50.0, 99.0], dtype=torch.float64, device=dev) / 100.0
    step = max(1, int(max_elems) // (T * A))
    for b0 in range(0, B, step):
        b1 = min(b0 + step, B)
        # (b, A, T): one contiguous curve per (design, tile)
        n = admitted[:, b0:b1].to(torch.float64).permute(1, 2, 0).contiguous()
        s = served[:, b0:b1].to(torch.float64).permute(1, 2, 0).contiguous()
        ca = torch.cumsum(n, dim=-1)
        cs = torch.cumsum(s, dim=-1)
        mid = ca - 0.5 * n
        depart = torch.searchsorted(cs, mid, right=False)
        done = (depart < T) & (n > 0)
        lat = (depart.to(torch.float64) - ticks + 0.5) * dt
        w = torch.where(done, n, torch.zeros_like(n))
        v = lat.reshape(b1 - b0, A * T)
        w = w.reshape(b1 - b0, A * T)
        v, order = torch.sort(v, dim=-1, stable=True)
        cum = torch.cumsum(torch.gather(w, -1, order), dim=-1)
        total = cum[:, -1]
        targets = qs.unsqueeze(0) * total.unsqueeze(-1)
        idx = torch.searchsorted(cum, targets.contiguous(), right=False)
        idx = torch.clamp(idx, max=A * T - 1)
        out = torch.gather(v, -1, idx)
        out = torch.where((total > 0).unsqueeze(-1), out,
                          torch.full_like(out, float("nan")))
        p50[b0:b1] = out[:, 0]
        p99[b0:b1] = out[:, 1]
    return p50, p99


# ---------------------------------------------------------------------------
# Engine configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimConfig:
    control_interval: int = 50          # ticks between controller samples
    telemetry_interval: int = 20        # ticks between telemetry rows
                                        # (telemetry rings are not ported;
                                        # kept so configs carry over)
    telemetry_capacity: int = 4096      # ring-buffer rows kept
    dynamic_contention: bool = True     # live NoC queueing on the wire term
    max_queue: float = float("inf")     # requests/tile before drops
    noc_power_share: float = NOC_POWER_SHARE   # the one shared energy model
                                        # constant (core/perfmodel.py)
