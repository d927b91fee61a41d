"""Batched multi-design closed-loop co-simulation: B SoCs as one tensor
program.

``core/dse.py:grid_sweep`` evaluates millions of *static* design points;
runtime validation (``closed_loop_score``) stacks the survivors (replication
counts, placements, island rates) into one platform whose tick loop advances
``(B, A)`` tensors:

* service rates come from ``service_time_terms_batch`` broadcast over the
  design axis (per-design ``f_acc``/``f_noc``/``f_tg``/K/placement);
* NoC contention uses per-design route->link incidence stacked into one
  dense ``(B, A, L)`` table (:func:`~repro_torch.core.noc.stacked_incidence`);
* DFS controllers run vectorized: policy decisions on ``(B, I)`` counter
  windows, dual-buffer commits as masked swaps
  (:class:`~repro_torch.sim.control.BatchControllerHarness`);
* the workload may be a shared :class:`~repro_torch.sim.traffic.Trace` or a
  per-design ``(T, B, A)`` :class:`~repro_torch.sim.traffic.BatchTrace`,
  shaped by an optional :class:`~repro_torch.sim.flows.FlowPattern`
  (tile-to-tile streams, chained stages).

Two backends:

``"torch"``
    A Python tick loop over tensors through
    :func:`~repro_torch.sim.engine.tick_step`, service terms recomputed only
    on commits, the controller harness stepping on the host every
    ``control_interval`` ticks.  In float64 (the default) it is the port's
    ground truth: it matches the reference package's ``"numpy"`` backend
    and records its :class:`~repro_torch.sim.telemetry.BatchTelemetry`
    (rows written into device rings while it runs, no host sync per row,
    one copy at the end).  ``dtype=torch.float32`` runs the same loop in
    float32, the role of the reference's float32 scan backend (no
    telemetry, as there).  It runs on the CPU or the card and launches one
    kernel per op per tick there, so it is not fast.
``"fused"``
    The whole tick loop and the control step as ONE hand-written CUDA kernel
    (:func:`repro_torch.kernels.tick_sim.fused_tick_sim`), float32; on CPU
    tensors the kernel's plain version runs instead.

Platform description and controller state stay in NumPy on the host; what
the tick loop reads becomes tensors once, at engine construction.  Faults,
SLO semantics, the load balancer and the observer plane are not ported yet
and are refused.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.dfs import (BatchEWMAUtilizationPolicy,
                                  BatchMemoryBoundPolicy, BatchPIDRatePolicy)
from repro_torch.core.islands import (IslandConfig, IslandSpec, NOC_LADDER,
                                      TILE_LADDER)
from repro_torch.core.noc import pos_index, positions_to_indices
from repro_torch.core.perfmodel import SoCPerfModel
from repro_torch.core.voltage import TechModel
from repro_torch.kernels.tick_sim import ControlPlan, fused_tick_sim
from repro_torch.sim.control import BatchControllerHarness
from repro_torch.sim.engine import (PKT_BYTES, SimConfig, SimPlatform,
                                    StepConsts, TickState,
                                    latency_percentiles_batch, sum_tiles,
                                    tick_step)
from repro_torch.sim.flows import FlowPattern, compile_flows
from repro_torch.sim.telemetry import BatchTelemetry, TelemetrySchema
from repro_torch.sim.traffic import BatchTrace

BACKENDS = ("torch", "fused")


# ---------------------------------------------------------------------------
# Platform: B concrete designs, stacked
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BatchSimPlatform:
    """B simulatable SoC instances sharing one NoC/model and one island
    *structure* (names, tile partition, ladders); everything that varies
    across designs — replication, placement, island rates, TG rate — is a
    leading-``B``-axis array.  ``islands`` is the structural template; the
    live per-design rates live in ``rates`` (and evolve through a
    :class:`BatchControllerHarness` at run time).  Host-side NumPy.
    """
    model: SoCPerfModel
    islands: IslandConfig               # structure template (rates ignored)
    names: Tuple[str, ...]
    base_mbps: np.ndarray               # (B, A)
    wire_share: np.ndarray              # (B, A)
    k: np.ndarray                       # (B, A)
    pos_idx: np.ndarray                 # (B, A)
    req_mb: np.ndarray                  # (B, A)
    rates: np.ndarray                   # (B, I) initial island rates
    f_tg: np.ndarray                    # (B,)
    n_tg: int = 0
    flows: Optional[FlowPattern] = None  # shared tile-to-tile pattern

    @property
    def n_designs(self) -> int:
        return int(self.k.shape[0])

    @property
    def n_tiles(self) -> int:
        return len(self.names)

    @classmethod
    def stack(cls, platforms: Sequence[SimPlatform]) -> "BatchSimPlatform":
        """Stack B :class:`SimPlatform` instances (same model, tile names
        and island structure; per-design arrays may differ)."""
        assert platforms, "need at least one platform"
        p0 = platforms[0]
        isl_names = p0.islands.names()
        isl_tiles = tuple(i.tiles for i in p0.islands.islands)
        for p in platforms[1:]:
            assert p.model is p0.model or p.model == p0.model, \
                "platforms must share one SoCPerfModel"
            assert p.names == p0.names, "tile name mismatch"
            assert p.islands.names() == isl_names, "island structure mismatch"
            assert tuple(i.tiles for i in p.islands.islands) == isl_tiles
            assert p.n_tg == p0.n_tg, "n_tg mismatch"
            assert p.flows == p0.flows, "flow-pattern mismatch"
        return cls(
            flows=p0.flows,
            model=p0.model, islands=p0.islands, names=p0.names,
            base_mbps=np.stack([p.base_mbps for p in platforms]),
            wire_share=np.stack([p.wire_share for p in platforms]),
            k=np.stack([p.k for p in platforms]),
            pos_idx=np.stack([p.pos_idx for p in platforms]),
            req_mb=np.stack([p.req_mb for p in platforms]),
            rates=np.asarray([[i.rate for i in p.islands.islands]
                              for p in platforms], dtype=np.float64),
            f_tg=np.asarray([p.f_tg for p in platforms], dtype=np.float64),
            n_tg=p0.n_tg)

    @classmethod
    def from_design_points(cls, model: SoCPerfModel, result, indices,
                           *, req_mb: float = 0.1,
                           n_tg: Optional[int] = None,
                           flows: Optional[FlowPattern] = None
                           ) -> "BatchSimPlatform":
        """Bridge from the DSE layer: stack ``grid_sweep`` survivors (flat
        :class:`~repro_torch.core.dse.SweepResult` indices) for one batched
        replay.

        Vectorized: the per-design ``(B, A)`` replication/placement arrays
        and the ``(B, I)`` per-island rate matrix come straight from one
        ``result.design_arrays`` decode of the flat indices — per-island
        independent rates included — without materializing B DesignPoints
        or SimPlatforms."""
        n_tg = result.n_tg if n_tg is None else n_tg
        idx = np.asarray(indices, dtype=np.int64)
        wls = tuple(result.workloads)
        names = tuple(w.name for w in wls)
        assert len(set(names)) == len(names), "duplicate tile names"
        da = result.design_arrays(idx)
        B, A = da["k"].shape
        pos_idx = positions_to_indices(model.noc, da["pos"])
        mem_idx = pos_index(model.noc, model.mem_pos)
        assert not np.any(pos_idx == mem_idx), "tile placed on MEM"
        for a in range(A):
            for b in range(a + 1, A):
                assert not np.any(pos_idx[:, a] == pos_idx[:, b]), \
                    "tile collision (invalid sweep point selected)"
        specs = tuple(IslandSpec(n, (n,), TILE_LADDER, 1.0)
                      for n in names)
        specs += (IslandSpec("noc_mem", ("NOC", "MEM"), NOC_LADDER, 1.0),)

        def tile_const(vals):
            return np.broadcast_to(
                np.asarray(vals, dtype=np.float64), (B, A)).copy()

        return cls(
            model=model, islands=IslandConfig(specs), names=names,
            base_mbps=tile_const([w.base_mbps for w in wls]),
            wire_share=tile_const([w.wire_share for w in wls]),
            k=da["k"], pos_idx=pos_idx.astype(np.int64),
            req_mb=np.full((B, A), float(req_mb)),
            rates=da["rates"], f_tg=da["f_tg"], n_tg=int(n_tg),
            flows=flows)

    def design(self, b: int) -> SimPlatform:
        """Materialize design ``b`` as a single :class:`SimPlatform`
        (the differential-test / drill-down path)."""
        specs = tuple(dataclasses.replace(spec, rate=float(self.rates[b, i]))
                      for i, spec in enumerate(self.islands.islands))
        return SimPlatform(
            model=self.model,
            islands=dataclasses.replace(self.islands, islands=specs),
            names=self.names, base_mbps=self.base_mbps[b].copy(),
            wire_share=self.wire_share[b].copy(), k=self.k[b].copy(),
            pos_idx=self.pos_idx[b].copy(), req_mb=self.req_mb[b].copy(),
            n_tg=self.n_tg, f_tg=float(self.f_tg[b]), flows=self.flows)


# ---------------------------------------------------------------------------
# Result
# ---------------------------------------------------------------------------


@dataclass
class BatchSimResult:
    """Per-design outcome arrays of one batched replay (all ``(B,)``,
    NumPy on the host)."""
    n_designs: int
    ticks: int
    dt: float
    offered: object                     # float (shared trace) or (B,)
                                        # per-design totals (BatchTrace)
    completed: np.ndarray               # exit-stage services under a
                                        # chained FlowPattern (each
                                        # external request once)
    dropped: np.ndarray
    residual: np.ndarray
    throughput_rps: np.ndarray
    p50_latency_s: np.ndarray
    p99_latency_s: np.ndarray
    energy_j: np.ndarray
    energy_per_request_j: np.ndarray
    mean_power_w: np.ndarray
    swaps: np.ndarray                   # (B,) int64 actuator commits
    elapsed_wall_s: float               # whole batch, one clock (tick loop
                                        # or kernel, device synchronised)
    backend: str = "torch"
    telemetry: Optional[BatchTelemetry] = None   # float64 "torch" only
    # fault/SLO ledgers of the reference, (B,) zeros in this slice
    dropped_slo: Optional[np.ndarray] = None
    dropped_fault: Optional[np.ndarray] = None
    retried: Optional[np.ndarray] = None
    # where the wall time of run() went, seconds (host clock, device
    # synchronised at each boundary): "loop" (tick loop or kernel),
    # "percentiles" (latency reconstruction), "copies" (host<->device)
    timings: Optional[Dict[str, float]] = None

    @property
    def dropped_total(self) -> np.ndarray:
        """(B,) admission + SLO + stranded drops."""
        tot = np.asarray(self.dropped, dtype=np.float64).copy()
        if self.dropped_slo is not None:
            tot = tot + self.dropped_slo
        if self.dropped_fault is not None:
            tot = tot + self.dropped_fault
        return tot

    @property
    def drop_rate(self) -> np.ndarray:
        """(B,) dropped fraction of offered load (0 when nothing offered)."""
        off = np.asarray(self.offered, dtype=np.float64)
        tot = self.dropped_total
        return np.where(off > 0.0, tot / np.where(off > 0.0, off, 1.0), 0.0)

    @property
    def designs_per_s_wall(self) -> float:
        return (self.n_designs / self.elapsed_wall_s
                if self.elapsed_wall_s else 0.0)

    @property
    def requests_per_s_wall(self) -> float:
        return (float(self.completed.sum()) / self.elapsed_wall_s
                if self.elapsed_wall_s else 0.0)

    def summary(self) -> str:
        return (f"{self.n_designs} designs x {self.ticks} ticks "
                f"({self.backend}, {self.elapsed_wall_s:.2f}s wall, "
                f"{self.designs_per_s_wall:,.1f} designs/s): "
                f"p99 [{self.p99_latency_s.min() * 1e3:.2f}, "
                f"{self.p99_latency_s.max() * 1e3:.2f}]ms, "
                f"mJ/req [{self.energy_per_request_j.min() * 1e3:.3f}, "
                f"{self.energy_per_request_j.max() * 1e3:.3f}], "
                f"{int(self.swaps.sum())} DFS swaps")


# ---------------------------------------------------------------------------
# Telemetry rings on the engine's device
# ---------------------------------------------------------------------------


class TelemetryRings:
    """:class:`BatchTelemetry`'s four rings as preallocated tensors on the
    engine's device.

    :meth:`record` writes one row into the slot ``rows % capacity`` (the
    host ring's slot) from tensors already on the device — no host sync per
    row; :meth:`to_host` copies the rings to the host once and fills a
    :class:`BatchTelemetry` with the same contents, ``total_appended`` and
    wrap as the reference's NumPy recording.  The drop/retry channels stay
    zero: faults and SLO semantics are not ported (ROADMAP queue A item 8).
    """

    def __init__(self, schema: TelemetrySchema, n_designs: int, *,
                 capacity: int, n_rows: int, device):
        assert capacity > 0 and n_designs > 0
        self.schema = schema
        self.n_designs = n_designs
        self.capacity = int(capacity)
        self.rows = 0
        slots = max(1, min(self.capacity, int(n_rows)))
        self.widths = (len(BatchTelemetry.SCALARS), len(schema.islands),
                       len(schema.tiles), len(schema.tiles))
        # scalars | island rates | queue depth | busy, side by side
        self.buf = torch.zeros((slots, n_designs, sum(self.widths)),
                               dtype=torch.float64, device=device)

    def record(self, *, tick: int, f_noc, island_rates, queue_depth, busy,
               throughput_rps, power_w, link_util_max, link_util_mean,
               latency_est_s, dropped) -> None:
        row = self.buf[self.rows % self.capacity]
        row[:, 0] = float(tick)
        for i, ch in enumerate((f_noc, throughput_rps, power_w,
                                link_util_max, link_util_mean,
                                latency_est_s, dropped), start=1):
            row[:, i] = ch
        S, I, A, _ = self.widths
        row[:, S:S + I] = island_rates
        row[:, S + I:S + I + A] = queue_depth
        row[:, S + I + A:] = busy
        self.rows += 1

    def to_host(self, events) -> BatchTelemetry:
        tel = BatchTelemetry(self.schema, self.n_designs,
                             capacity=self.capacity)
        host = self.buf.cpu().numpy()
        cuts = np.cumsum(self.widths)[:-1]
        rings = (tel.scalars, tel.island_rates, tel.queue_depth, tel.busy)
        for ring, part in zip(rings, np.split(host, cuts, axis=-1)):
            ring.fill(part[:min(self.rows, self.capacity)], self.rows)
        tel.events = list(events)
        return tel


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} not ported yet (ROADMAP queue A item {item})")


class BatchSimEngine:
    """Ticks B stacked designs through one trace, controllers in loop.

    ``device=None`` means the CUDA card (and raises without one); the tests
    pass ``device="cpu"``.  ``dtype`` is the ``"torch"`` loop's float type:
    ``torch.float64`` (the ground truth, with telemetry) or
    ``torch.float32``; ``"fused"`` is float32 whatever it says.
    ``faults`` / ``slo`` / ``balancer`` / ``observe`` are accepted for
    signature parity with the reference and refused when set; ``devices``
    accepts ``None`` or ``1``.
    """

    def __init__(self, platform: BatchSimPlatform, *,
                 config: SimConfig = SimConfig(),
                 controller: Optional[BatchControllerHarness] = None,
                 balancer=None,
                 backend: str = "torch",
                 faults=None, slo=None, observe=None,
                 devices=None, tech=None, device=None,
                 dtype: torch.dtype = torch.float64):
        if backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {backend!r}")
        if dtype not in (torch.float64, torch.float32):
            raise ValueError(f"dtype must be torch.float64 or torch.float32, "
                             f"got {dtype}")
        device_mod.require_single(devices)
        self.platform = platform
        self.devices = devices
        self.device = device_mod.resolve(device)
        self.dtype = dtype
        self.config = config
        self.controller = controller
        # physical DVFS model (core/voltage.py): tick energy becomes
        # power_scl * (P_static + P_dyn f V̂(f)^2) on every backend, and
        # the harness clamps commits to the node's legal [L, U] range;
        # None keeps the linear voltage proxy bit for bit
        self.tech = TechModel.coerce(tech)
        if self.tech is not None and controller is not None \
                and getattr(controller, "tech", None) is None:
            controller.tech = self.tech
        self.balancer = balancer
        self.backend = backend
        self.faults = faults
        self.slo = slo
        self.observe = observe
        self._refuse_unported()
        self.last_state: Optional[TickState] = None
        self.last_histories = None      # (admitted, served) (T, B, A)
                                        # tensors on the engine's device
        m = platform.model
        # per-design route->link incidence, stacked dense: (B, A, L) —
        # per-design routes of the (shared, name-keyed) flow pattern
        # against each design's own placement (tile->MEM when flows=None)
        cf = compile_flows(m, platform.names, platform.pos_idx,
                           platform.flows)
        self._compiled_flows = cf
        self._inc = cf.inc
        self._hop_counts = cf.hop_counts
        self._flow_demand = cf.demand
        self._forward = cf.forward
        assert np.all((cf.inc == 0.0) | (cf.inc == 1.0)), \
            "route->link incidence rows must be 0/1"
        self._t_comp_ref = (1.0 - platform.wire_share) / platform.k
        isl_names = platform.islands.names()
        self._island_of_tile = np.asarray(
            [isl_names.index(platform.islands.island_of(n).name)
             for n in platform.names], dtype=np.int64)
        try:
            self._noc_island = isl_names.index("noc_mem")
        except ValueError:
            self._noc_island = -1
        self._dev_cache: Dict[torch.dtype, Dict[str, torch.Tensor]] = {}

    # ------------------------------------------------------------ refusals
    def _refuse_unported(self) -> None:
        """Knobs of the reference surface this slice does not honour.  The
        four the reference's own fused kernel refuses keep its wording on
        ``backend="fused"``."""
        fused = self.backend == "fused"
        if self.faults is not None and self.faults:
            raise NotImplementedError(
                ("fused backend does not simulate fault schedules; "
                 if fused else "fault schedules: ")
                + "faults= not ported yet (ROADMAP queue A item 8)")
        if self.slo is not None:
            raise NotImplementedError(
                ("fused backend does not apply SLO semantics; "
                 if fused else "SLO semantics: ")
                + "slo= not ported yet (ROADMAP queue A item 8)")
        if self.balancer is not None:
            raise NotImplementedError(
                ("fused backend does not run the load balancer; "
                 if fused else "load balancer: ")
                + "balancer= not ported yet (ROADMAP queue A item 7)")
        if self.observe is not None and self.observe != "off":
            raise NotImplementedError(
                ("fused backend records no observer plane; "
                 if fused else "observer plane: ")
                + "observe= not ported yet (ROADMAP queue A item 9)")

    # ------------------------------------------------------------ tensors
    def _tensors(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """The platform arrays the tick loop reads, on the engine's device
        in ``dtype`` — made once per dtype."""
        if dtype not in self._dev_cache:
            p = self.platform

            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=self.device)

            self._dev_cache[dtype] = {
                "base": t(p.base_mbps), "req": t(p.req_mb),
                "w": t(p.wire_share), "k": t(p.k),
                "hop": t(self._hop_counts), "tcr": t(self._t_comp_ref),
                "inc": t(self._inc), "ftg": t(p.f_tg[:, None]),
                "iot": torch.as_tensor(self._island_of_tile,
                                       device=self.device),
                "demand": (t(self._flow_demand)
                           if np.ndim(self._flow_demand) > 0 else None),
                "forward": (t(self._forward)
                            if self._forward is not None else None),
                "exit": t(self._compiled_flows.exit_mask),
            }
        return self._dev_cache[dtype]

    # ------------------------------------------------------------ service
    def _service_t(self, rates: torch.Tensor,
                   dtype: torch.dtype = torch.float64
                   ) -> Dict[str, torch.Tensor]:
        """Service-time terms for a (B, I) float64 rate tensor on the
        engine's device (recomputed only on commits), computed in float64
        and handed to the tick loop in ``dtype``."""
        p = self.platform
        B, A = p.n_designs, p.n_tiles
        tn = self._tensors(torch.float64)
        f_tile = rates[:, tn["iot"]]                         # (B, A)
        f_noc = (rates[:, self._noc_island] if self._noc_island >= 0
                 else torch.ones(B, dtype=torch.float64, device=self.device))
        t_comp, t_wire, t_ref = p.model.service_time_terms_batch(
            wire_share=tn["w"], k=tn["k"], f_acc=f_tile,
            f_noc=f_noc[:, None], f_tg=tn["ftg"], n_tg=p.n_tg,
            hop_counts=tn["hop"], backend="torch", device=self.device)
        svc = {"t_comp": t_comp.expand(B, A), "t_wire": t_wire.expand(B, A),
               "t_ref": t_ref.expand(B, A), "f_tile": f_tile,
               "f_noc": f_noc}
        return {k: v.to(dtype) for k, v in svc.items()}

    def _service(self, rates: np.ndarray) -> Dict[str, np.ndarray]:
        """Host NumPy form of :meth:`_service_t` (float64)."""
        p = self.platform
        B, A = p.n_designs, p.n_tiles
        f_tile = rates[:, self._island_of_tile]              # (B, A)
        f_noc = (rates[:, self._noc_island] if self._noc_island >= 0
                 else np.ones(B))
        t_comp, t_wire, t_ref = p.model.service_time_terms_batch(
            wire_share=p.wire_share, k=p.k, f_acc=f_tile,
            f_noc=f_noc[:, None], f_tg=p.f_tg[:, None], n_tg=p.n_tg,
            hop_counts=self._hop_counts)
        return {"t_comp": np.broadcast_to(t_comp, (B, A)),
                "t_wire": np.broadcast_to(t_wire, (B, A)),
                "t_ref": np.broadcast_to(np.asarray(t_ref, float), (B, A)),
                "f_tile": f_tile, "f_noc": f_noc}

    def capacity_rps(self, rates: Optional[np.ndarray] = None) -> np.ndarray:
        """(B, A) uncontended per-tile service capacity (requests/s)."""
        svc = self._service(self.platform.rates if rates is None else rates)
        thr = self.platform.base_mbps * svc["t_ref"] / (
            svc["t_comp"] + svc["t_wire"])
        return thr / self.platform.req_mb

    def step_consts(self, dt: float,
                    dtype: torch.dtype = torch.float64) -> StepConsts:
        p, cfg = self.platform, self.config
        tn = self._tensors(dtype)
        return StepConsts(
            base_mbps=tn["base"], req_mb=tn["req"], hop_counts=tn["hop"],
            inc=tn["inc"],
            own_demand=(tn["demand"] if tn["demand"] is not None
                        else float(self._flow_demand)),
            link_bw=p.model.noc.link_bw,
            max_slow=p.model.noc.max_slowdown,
            hop_latency=p.model.noc.hop_latency,
            noc_power_share=cfg.noc_power_share, dt=dt,
            max_queue=cfg.max_queue,
            dynamic_contention=cfg.dynamic_contention,
            forward=tn["forward"], tech=self.tech)

    def _check_trace(self, trace) -> None:
        p = self.platform
        assert trace.n_dests == p.n_tiles, (trace.n_dests, p.n_tiles)
        if isinstance(trace, BatchTrace):
            assert trace.n_designs == p.n_designs, \
                (trace.n_designs, p.n_designs)

    @staticmethod
    def _offered(trace):
        """External offered load: one float for a shared trace, per-design
        (B,) totals for a :class:`BatchTrace`."""
        if isinstance(trace, BatchTrace):
            return trace.n_requests
        return float(trace.arrivals.sum())

    def _completed(self, served_hist: torch.Tensor) -> torch.Tensor:
        """(B,) float64 external completions.  Chained patterns count only
        exit-stage services (each request once)."""
        if self._forward is None:
            return served_hist.sum(dim=(0, 2), dtype=torch.float64)
        exit_mask = self._tensors(torch.float64)["exit"]
        return (served_hist.sum(dim=0, dtype=torch.float64)
                * exit_mask).sum(dim=-1)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _arrivals_t(self, trace, dtype: torch.dtype) -> torch.Tensor:
        """The trace's arrivals on the engine's device: ``(T, A)`` for a
        shared trace (never expanded to B copies), ``(T, B, A)`` for a
        per-design one."""
        return torch.as_tensor(np.ascontiguousarray(trace.arrivals),
                               dtype=dtype, device=self.device)

    # ---------------------------------------------------------------- run
    def run(self, trace) -> BatchSimResult:
        """Replay a shared :class:`Trace` (every design sees the same
        (T, A) arrivals) or a per-design :class:`BatchTrace` (T, B, A)."""
        if self.backend == "fused":
            return self._run_fused(trace)
        return self._run_torch(trace)

    def _run_torch(self, trace) -> BatchSimResult:
        p, cfg = self.platform, self.config
        B, A, T, dt = p.n_designs, p.n_tiles, trace.ticks, trace.dt
        dev, f64, dtype = self.device, torch.float64, self.dtype
        self._check_trace(trace)
        timings = {"copies": 0.0}
        t0 = time.perf_counter()
        arrivals = self._arrivals_t(trace, dtype)
        self._sync()
        timings["copies"] += time.perf_counter() - t0

        ctl = self.controller
        if ctl is not None:
            assert ctl.n_designs == B
            ctl.begin_run()
            rates_np = ctl.live_rates()
            swaps0 = ctl.swaps.copy()
        else:
            rates_np = p.rates
        rates_t = torch.as_tensor(rates_np, dtype=f64, device=dev)
        svc = self._service_t(rates_t, dtype)

        st = TickState.zeros((B, A), device=dev, dtype=dtype)
        consts = self.step_consts(dt, dtype)
        carry = (torch.zeros((B, A), dtype=dtype, device=dev)
                 if consts.forward is not None else None)
        admitted_hist = torch.zeros((T, B, A), dtype=dtype, device=dev)
        served_hist = torch.zeros((T, B, A), dtype=dtype, device=dev)
        ctl_busy = torch.zeros((B, A), dtype=dtype, device=dev)
        ctl_ticks = 0
        tcr = self._tensors(dtype)["tcr"]
        # telemetry: the float64 loop records, like the reference's NumPy
        # engine; the float32 one does not, like its float32 scan
        rings = events = None
        ti = cfg.telemetry_interval
        if dtype == f64:
            rings = TelemetryRings(
                TelemetrySchema(islands=p.islands.names(), tiles=p.names),
                B, capacity=cfg.telemetry_capacity,
                n_rows=T // ti if ti else 0, device=dev)
            events = []
            win_busy = torch.zeros((B, A), dtype=f64, device=dev)
            win_served = torch.zeros(B, dtype=f64, device=dev)
            win_ticks = 0

        self._sync()
        wall0 = time.perf_counter()
        for t_i in range(T):
            arr = arrivals[t_i]
            if carry is not None:
                arr = arr + carry
            out = tick_step(st, arr, svc, consts)
            if carry is not None:
                carry = out.forwarded
            admitted_hist[t_i] = out.admitted
            served_hist[t_i] = out.served
            ctl_busy += st.busy
            ctl_ticks += 1

            if rings is not None and ti:
                win_busy += st.busy
                win_served += sum_tiles(out.served)
                win_ticks += 1
                if (t_i + 1) % ti == 0:
                    rings.record(
                        tick=t_i, f_noc=svc["f_noc"], island_rates=rates_t,
                        queue_depth=st.queue, busy=win_busy / win_ticks,
                        throughput_rps=win_served / (win_ticks * dt),
                        power_w=out.tile_power + out.noc_power,
                        link_util_max=torch.clamp(out.rho.amax(dim=-1),
                                                  min=0.0),
                        link_util_mean=sum_tiles(out.rho) / A,
                        latency_est_s=(sum_tiles(st.queue) / torch.clamp(
                            sum_tiles(out.cap_tick / dt), min=1e-9)),
                        dropped=st.dropped)
                    win_busy = torch.zeros((B, A), dtype=f64, device=dev)
                    win_served = torch.zeros(B, dtype=f64, device=dev)
                    win_ticks = 0

            if (ctl is not None and cfg.control_interval
                    and (t_i + 1) % cfg.control_interval == 0):
                # the harness lives on the host: one window's counters
                # down, the committed rates (if any) back up
                t_wire_now = svc["t_wire"] * out.dyn
                window = torch.stack([
                    ctl_busy / max(ctl_ticks, 1),
                    t_wire_now / (tcr + t_wire_now),
                    st.pkts_in, st.pkts_out, st.rtt_acc,
                    st.queue / torch.clamp(out.cap_tick, min=1e-12)]
                ).to(f64).cpu()
                busy_w, bound_w, pin, pout, rtt, qticks = window.numpy()
                new_rates = ctl.step(
                    tick=t_i, busy=busy_w, boundness=bound_w, pkts_in=pin,
                    pkts_out=pout, rtt=rtt, queue_ticks=qticks)
                ctl_busy = torch.zeros((B, A), dtype=dtype, device=dev)
                ctl_ticks = 0
                if new_rates is not None:
                    rates_t = torch.as_tensor(new_rates, dtype=f64,
                                              device=dev)
                    svc = self._service_t(rates_t, dtype)
                    if events is not None:
                        events.append({
                            "tick": int(t_i), "kind": "dfs_commit",
                            "designs": np.nonzero(
                                ctl.last_committed)[0].tolist()})
        self._sync()
        timings["loop"] = time.perf_counter() - wall0

        telemetry = None
        if rings is not None:
            t0 = time.perf_counter()
            telemetry = rings.to_host(events)
            timings["copies"] += time.perf_counter() - t0
        self.last_state = st
        self.last_histories = (admitted_hist, served_hist)
        return self._result(
            trace, admitted_hist, served_hist,
            dropped=st.dropped, residual=sum_tiles(st.queue),
            energy=st.energy,
            swaps=(ctl.swaps - swaps0 if ctl is not None
                   else np.zeros(B, dtype=np.int64)),
            backend="torch", timings=timings, telemetry=telemetry)

    def _result(self, trace, admitted_hist, served_hist, *, dropped,
                residual, energy, swaps, backend, timings, telemetry=None
                ) -> BatchSimResult:
        """Assemble the per-design result on the host.  ``dropped`` /
        ``residual`` / ``energy`` are (B,) tensors on the engine's device;
        latency percentiles are reconstructed there for all designs at
        once."""
        B, T, dt = self.platform.n_designs, trace.ticks, trace.dt
        self._sync()
        t0 = time.perf_counter()
        p50_t, p99_t = latency_percentiles_batch(admitted_hist, served_hist,
                                                 dt)
        self._sync()
        timings["percentiles"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        small = torch.stack([
            self._completed(served_hist), dropped.to(torch.float64),
            residual.to(torch.float64), energy.to(torch.float64),
            p50_t, p99_t]).cpu().numpy()
        timings["copies"] += time.perf_counter() - t0
        completed, dropped, residual, energy, p50, p99 = (
            np.ascontiguousarray(r) for r in small)

        sim_seconds = T * dt
        zB = np.zeros(B)
        return BatchSimResult(
            n_designs=B, ticks=T, dt=dt,
            offered=self._offered(trace),
            completed=completed, dropped=dropped, residual=residual,
            throughput_rps=(completed / sim_seconds if sim_seconds
                            else np.zeros(B)),
            p50_latency_s=p50, p99_latency_s=p99, energy_j=energy,
            energy_per_request_j=np.where(
                completed > 0, energy / np.maximum(completed, 1e-9),
                np.nan),
            mean_power_w=(energy / sim_seconds if sim_seconds
                          else np.zeros(B)),
            swaps=np.asarray(swaps, dtype=np.int64),
            elapsed_wall_s=timings["loop"], backend=backend,
            telemetry=telemetry,
            dropped_slo=zB.copy(), dropped_fault=zB.copy(),
            retried=zB.copy(), timings=timings)

    # ------------------------------------------------------ control plan
    def _control_plan(self) -> ControlPlan:
        """Digest the (optional) controller into the record the fused
        kernel is driven by.  Supported: no controller, guard-only, and the
        membound / PID / EWMA batch policies."""
        ctl = self.controller
        if ctl is None:
            return ControlPlan(kind="none")
        topo = ctl.topo
        names = np.asarray(topo.names)
        common = dict(
            membership=np.asarray(topo.membership),
            counts=np.asarray(topo.counts), fixed=np.asarray(topo.fixed),
            levels=np.asarray(topo.ladder_levels),
            guard=ctl.queue_guard_ticks,
            guard_release=ctl.guard_release_ticks,
            guard_rate=ctl.guard_rate)
        # physical DVFS: the harness's tech model supplies the legal
        # [L, U] ratio range and the mask of ladder levels inside it
        # (islands whose ladder lies fully outside fall back to every
        # real level; the +inf padding is illegal by construction)
        tech = getattr(ctl, "tech", None)
        if tech is not None:
            lv = common["levels"]
            legal = (lv >= tech.l_bound) & (lv <= tech.u_bound)
            common.update(
                tech_lo=float(tech.l_bound), tech_hi=float(tech.u_bound),
                tech_legal=np.where(legal.any(axis=-1, keepdims=True),
                                    legal, np.isfinite(lv)))
        pol = ctl.policy
        base_skip = topo.fixed | (topo.counts == 0)
        if pol is None:
            return ControlPlan(kind="guard", **common)
        if isinstance(pol, BatchMemoryBoundPolicy):
            return ControlPlan(
                kind="membound", threshold=pol.threshold,
                low_rate=pol.low_rate,
                skip=base_skip | (names == "noc_mem"), **common)
        if isinstance(pol, BatchPIDRatePolicy):
            return ControlPlan(
                kind="pid", target=pol.target, kp=pol.kp, ki=pol.ki,
                kd=pol.kd, min_rate=pol.min_rate,
                integral_clamp=pol.integral_clamp,
                skip=base_skip | np.isin(names, pol.skip), **common)
        if isinstance(pol, BatchEWMAUtilizationPolicy):
            return ControlPlan(
                kind="ewma", alpha=pol.alpha, target=pol.target,
                min_rate=pol.min_rate,
                skip=np.asarray(pol.skip_islands(topo), dtype=bool),
                **common)
        raise NotImplementedError(
            "fused backend supports controller=None, guard-only, "
            "BatchMemoryBoundPolicy, BatchPIDRatePolicy and "
            "BatchEWMAUtilizationPolicy (kernel kinds none / guard / "
            f"membound / pid / ewma); got {type(pol).__name__}")

    def _control_writeback(self, plan: ControlPlan, ratesF, guardF, swapsF,
                           polF, swaps_before) -> None:
        """Push the kernel's evolved controller state back into the
        host-side harness/policy objects."""
        ctl = self.controller
        if ctl is None:
            return
        ctl.rates = np.asarray(ratesF, dtype=np.float64)
        ctl._guard_active = np.asarray(guardF, dtype=bool)
        ctl.swaps = swaps_before + np.asarray(swapsF).astype(np.int64)
        ctl.versions = ctl.versions + np.asarray(swapsF).astype(np.int64)
        if plan.kind in ("pid", "ewma"):
            ctl.policy.fused_sync(tuple(np.asarray(s) for s in polF))

    # ------------------------------------------------------------- fused
    def fused_inputs(self, trace):
        """``(arrivals, consts, scalars, init, plan, swaps_before)`` — what
        :meth:`run` hands to :func:`fused_tick_sim` for this trace, tensors
        on the engine's device in float32.  Starts a controller run
        (``begin_run``) like :meth:`run` does."""
        p, cfg = self.platform, self.config
        B, dt = p.n_designs, trace.dt
        dev, f32 = self.device, torch.float32
        self._check_trace(trace)
        m = p.model
        plan = self._control_plan()
        ctl = self.controller
        ci = cfg.control_interval if (ctl is not None
                                      and cfg.control_interval) else 0
        I = len(p.islands.names())
        pol0 = ()
        if ctl is not None:
            ctl.begin_run()
            rates0 = ctl.live_rates()
            guard0 = ctl._guard_active
            swaps_before = ctl.swaps.copy()
            if plan.kind in ("pid", "ewma"):
                pol0 = ctl.policy.fused_state(B, I)
        else:
            rates0 = p.rates
            guard0 = np.zeros((B, I), dtype=bool)
            swaps_before = None

        tn = self._tensors(f32)
        consts = {key: tn[key] for key in
                  ("base", "req", "w", "k", "hop", "tcr", "inc", "ftg")}
        arr = self._arrivals_t(trace, f32)      # (T, A) stays shared
        init = {
            "rates": torch.as_tensor(np.ascontiguousarray(rates0),
                                     dtype=f32, device=dev),
            "guard": torch.as_tensor(np.ascontiguousarray(guard0),
                                     dtype=torch.bool, device=dev),
            "pol": tuple(
                torch.as_tensor(
                    np.ascontiguousarray(s),
                    dtype=torch.bool if s.dtype == np.bool_ else f32,
                    device=dev)
                for s in pol0)}
        scalars = {"dt": dt, "own": m.own_demand, "tgd": m.tg_demand,
                   "link_bw": m.noc.link_bw,
                   "max_slow": m.noc.max_slowdown,
                   "hop_lat": m.noc.hop_latency,
                   "hop_share": m.hop_latency_share,
                   "hopf0": 1.0 + m.hop_latency_share * m._ref_hops(),
                   "noc_share": cfg.noc_power_share, "n_tg": p.n_tg,
                   "dyn_on": cfg.dynamic_contention,
                   "max_q": cfg.max_queue, "ci": ci,
                   "noc_idx": self._noc_island,
                   "iot": np.asarray(self._island_of_tile),
                   "demand": np.asarray(self._flow_demand,
                                        dtype=np.float64),
                   "forward": (np.asarray(self._forward)
                               if self._forward is not None else None)}
        if self.tech is not None:
            # physical DVFS: the node's three power coefficients
            scalars["tech_on"] = True
            (scalars["t_ps"], scalars["t_v0"],
             scalars["t_v1"]) = self.tech.power_coeffs
        return arr, consts, scalars, init, plan, swaps_before

    def _run_fused(self, trace) -> BatchSimResult:
        """The fused-kernel backend: the whole queue-update / contention /
        service / forward / control tick loop as ONE kernel launch, float32.
        Open-loop replay + the membound / PID / EWMA / guard-only
        controllers."""
        B, A = self.platform.n_designs, self.platform.n_tiles
        dev = self.device
        timings = {}
        t0 = time.perf_counter()
        arr, consts, scalars, init, plan, swaps_before = \
            self.fused_inputs(trace)
        self._sync()
        timings["copies"] = time.perf_counter() - t0

        wall0 = time.perf_counter()
        out = fused_tick_sim(arr, consts, scalars, init, plan=plan)
        self._sync()
        timings["loop"] = time.perf_counter() - wall0

        t0 = time.perf_counter()
        swapsF = np.rint(out["swaps"].cpu().numpy()).astype(np.int64)
        self._control_writeback(
            plan, out["rates"].cpu().numpy(), out["guard"].cpu().numpy(),
            swapsF, tuple(s.cpu().numpy() for s in out["pol"]),
            swaps_before)
        timings["copies"] += time.perf_counter() - t0

        admitted, served = out["adm"], out["served"]
        f64 = torch.float64
        req64 = self._tensors(f64)["req"]
        zB = torch.zeros(B, dtype=f64, device=dev)
        self.last_state = TickState(
            queue=out["queue"].to(f64), busy=out["busy"].to(f64),
            pkts_in=(admitted.sum(dim=0, dtype=f64) * req64
                     * 1e6 / PKT_BYTES),
            pkts_out=(served.sum(dim=0, dtype=f64) * req64
                      * 1e6 / PKT_BYTES),
            rtt_acc=out["rtt"].to(f64),
            dropped=out["dropped"].to(f64), energy=out["energy"].to(f64),
            retry_q=torch.zeros((B, A), dtype=f64, device=dev),
            dropped_slo=zB.clone(), dropped_fault=zB.clone(),
            retried=zB.clone())
        self.last_histories = (admitted, served)
        return self._result(
            trace, admitted, served, dropped=out["dropped"],
            residual=out["queue"].to(f64).sum(dim=-1),
            energy=out["energy"], swaps=swapsF, backend="fused",
            timings=timings)
