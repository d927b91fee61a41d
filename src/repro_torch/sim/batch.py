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
the tick loop reads becomes tensors once, at engine construction.  A
:class:`~repro_torch.sim.control.LoadBalancer` splits arrivals inside the
``"torch"`` loop (the kernel does not run one).  So do a
:class:`~repro_torch.sim.faults.FaultSchedule` (one shared schedule for all
B designs, its masks copied to the device before the loop) and an
:class:`~repro_torch.sim.faults.SLOConfig`; ``"fused"`` refuses both.  The
observer plane is not ported yet and is refused.  The sequential
``sim/engine.py:SimEngine`` is the ``"torch"`` loop at B = 1 with the scalar
controller harness (and an optional online fault supervisor) in it.
"""
from __future__ import annotations

import dataclasses
import time
import types
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
                                    latency_percentiles_batch,
                                    service_terms, sum_tiles, tick_step)
from repro_torch.sim.faults import (CompiledFaults, SLOConfig,
                                    compile_faults, respill_stranded)
from repro_torch.sim.flows import FlowPattern, compile_flows
from repro_torch.sim.telemetry import (BatchTelemetry, Telemetry,
                                       TelemetrySchema)
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
    # fault/SLO ledgers: SLO-deadline drops, work stranded on dead
    # replicas, work re-spilled to survivors ((B,), zeros fault-free)
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
        """(B,) dropped fraction of offered load (0 when nothing offered).
        Per-design floats match the sequential ``SimResult.drop_rate``."""
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
    wrap as the reference's NumPy recording.  The drop/retry channels
    (``dropped_slo``, ``dropped_fault``, ``retried``) are written from the
    state's ledgers when a run keeps them, and stay zero otherwise, as the
    ledgers do.
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
               latency_est_s, dropped, ledgers=()) -> None:
        """One row.  ``ledgers`` is ``()`` or the cumulative
        ``(dropped_slo, dropped_fault, retried)`` tensors."""
        row = self.buf[self.rows % self.capacity]
        row[:, 0] = float(tick)
        for i, ch in enumerate((f_noc, throughput_rps, power_w,
                                link_util_max, link_util_mean,
                                latency_est_s, dropped, *ledgers), start=1):
            row[:, i] = ch
        S, I, A, _ = self.widths
        row[:, S:S + I] = island_rates
        row[:, S + I:S + I + A] = queue_depth
        row[:, S + I + A:] = busy
        self.rows += 1

    def _fill(self, tel, host: np.ndarray, events):
        """Fill ``tel``'s four rings from the ring slots ``host`` (one copy
        of the device buffer, the design axis sliced as ``tel`` wants)."""
        cuts = np.cumsum(self.widths)[:-1]
        rings = (tel.scalars, tel.island_rates, tel.queue_depth, tel.busy)
        for ring, part in zip(rings, np.split(host, cuts, axis=-1)):
            ring.fill(part[:min(self.rows, self.capacity)], self.rows)
        tel.events = list(events)
        return tel

    def to_host(self, events) -> BatchTelemetry:
        return self._fill(BatchTelemetry(self.schema, self.n_designs,
                                         capacity=self.capacity),
                          self.buf.cpu().numpy(), events)

    def to_telemetry(self, events) -> Telemetry:
        """The one design's recording (B = 1) as the sequential engine's
        :class:`Telemetry`."""
        assert self.n_designs == 1
        return self._fill(Telemetry(self.schema, capacity=self.capacity),
                          self.buf[:, 0].cpu().numpy(), events)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class _Loop(types.SimpleNamespace):
    """The mutable state of one ``"torch"`` tick loop
    (:meth:`BatchSimEngine._loop`)."""


# the per-tick ledgers a fault/SLO run keeps, (T, B) each, as the
# reference's ``last_fault_histories`` names them
FAULT_HISTORIES = ("dropped", "dropped_slo", "dropped_fault", "retried",
                   "queue", "carry")


def _event_order(ev) -> Tuple[int, int]:
    """Sort key of the event log within a tick, as the reference engine
    logs them: the schedule's transitions at the start of the tick, the
    supervisor's detections after the step, the controller's commit at
    the end."""
    kind = ev["kind"]
    return (ev["tick"], 0 if kind.startswith("fault_")
            else 2 if kind == "dfs_commit" else 1)


class BatchSimEngine:
    """Ticks B stacked designs through one trace, controllers in loop.

    ``device=None`` means the CUDA card (and raises without one); the tests
    pass ``device="cpu"``.  ``dtype`` is the ``"torch"`` loop's float type:
    ``torch.float64`` (the ground truth, with telemetry) or
    ``torch.float32``; ``"fused"`` is float32 whatever it says.
    ``balancer`` (a :class:`~repro_torch.sim.control.LoadBalancer`) splits
    each tick's arrivals on ``"torch"`` and is refused on ``"fused"``;
    ``faults`` (a :class:`~repro_torch.sim.faults.FaultSchedule`) and
    ``slo`` (a :class:`~repro_torch.sim.faults.SLOConfig`) run on
    ``"torch"`` in both dtypes and are refused on ``"fused"``; ``observe``
    is accepted for signature parity with the reference and refused when
    set; ``devices`` accepts ``None`` or ``1``.
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
        self.last_fault_histories = None  # per-tick ledgers under faults /
                                          # SLO, tensors on the device
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
        """Knobs the tick kernel does not honour — faults, SLO semantics
        and the balancer, which the reference's own fused kernel refuses as
        well — and the observer plane, which no backend of the port records
        yet."""
        fused = self.backend == "fused"
        if self.faults is not None and self.faults and fused:
            raise NotImplementedError(
                "fused backend does not simulate fault schedules; "
                "faults= not ported yet (ROADMAP queue A item 8)")
        if self.slo is not None and fused:
            raise NotImplementedError(
                "fused backend does not apply SLO semantics; "
                "slo= not ported yet (ROADMAP queue A item 8)")
        if self.balancer is not None and fused:
            raise NotImplementedError(
                "fused backend does not run the load balancer; "
                "use backend='torch'")
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
                "ntg": t(float(p.n_tg)),
                "exit": t(self._compiled_flows.exit_mask),
            }
        return self._dev_cache[dtype]

    # ------------------------------------------------------------ service
    def _service_t(self, rates: torch.Tensor,
                   dtype: torch.dtype = torch.float64,
                   override: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """Service-time terms for a (B, I) float64 rate tensor on the
        engine's device (recomputed only on commits), computed in float64
        and handed to the tick loop in ``dtype``, completed by
        :func:`~repro_torch.sim.engine.service_terms` there.

        ``override`` is the stuck-actuator hardware view: an (I,) float64
        row on the device, NaN = follow the software rate.  It shapes only
        these terms; the caller's ``rates`` (what telemetry records and the
        controller reasons about) stay the software view."""
        p = self.platform
        B, A = p.n_designs, p.n_tiles
        tn = self._tensors(torch.float64)
        if override is not None:
            rates = torch.where(torch.isnan(override), rates, override)
        f_tile = rates[:, tn["iot"]]                         # (B, A)
        f_noc = (rates[:, self._noc_island] if self._noc_island >= 0
                 else torch.ones(B, dtype=torch.float64, device=self.device))
        t_comp, t_wire, t_ref = p.model.service_time_terms_batch(
            wire_share=tn["w"], k=tn["k"], f_acc=f_tile,
            f_noc=f_noc[:, None], f_tg=tn["ftg"], n_tg=tn["ntg"],
            hop_counts=tn["hop"], backend="torch", device=self.device)
        svc = {"t_comp": t_comp.expand(B, A), "t_wire": t_wire.expand(B, A),
               "t_ref": t_ref.expand(B, A), "f_tile": f_tile,
               "f_noc": f_noc}
        return service_terms({k: v.to(dtype) for k, v in svc.items()},
                             self.step_consts(0.0, dtype))

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
        exit-stage services (each request once).

        Added in the reference's order: NumPy sums one design's ``(T, A)``
        history pairwise over all of it (on the host here, from one copy of
        it), and B > 1 designs' ``(T, B, A)`` one tick's tiles at a time
        (pairwise, :func:`sum_tiles`), ticks in sequence — the order of the
        running sum on the CPU; on the card the running sum adds in
        parallel."""
        f64 = torch.float64
        exit_mask = (self._tensors(f64)["exit"]
                     if self._forward is not None else None)
        if served_hist.shape[1] == 1:
            s = served_hist[:, 0].to(f64).cpu().numpy()
            if exit_mask is not None:
                s = s * self._compiled_flows.exit_mask
            return torch.tensor([s.sum()], dtype=f64,
                                device=served_hist.device)
        x = served_hist.to(f64)
        if exit_mask is not None:
            x = x * exit_mask
        return torch.cumsum(sum_tiles(x), dim=0)[-1]

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
        (T, A) arrivals) or a per-design :class:`BatchTrace` (T, B, A).
        The knobs are checked again here, since a caller may set them after
        construction."""
        self._refuse_unported()
        if self.backend == "fused":
            return self._run_fused(trace)
        return self._run_torch(trace)

    def _run_torch(self, trace) -> BatchSimResult:
        p = self.platform
        B = p.n_designs
        ctl = self.controller
        control = None
        if ctl is not None:
            assert ctl.n_designs == B
            ctl.begin_run()
            rates = ctl.live_rates()
            swaps0 = ctl.swaps.copy()

            def control(t_i, window, dead=None, stuck=None):
                busy, bound, pin, pout, rtt, qticks = window
                new_rates = ctl.step(
                    tick=t_i, busy=busy, boundness=bound, pkts_in=pin,
                    pkts_out=pout, rtt=rtt, queue_ticks=qticks, dead=dead,
                    stuck=stuck)
                if new_rates is None:
                    return None
                return new_rates, {
                    "tick": int(t_i), "kind": "dfs_commit",
                    "designs": np.nonzero(ctl.last_committed)[0].tolist()}
        else:
            rates = p.rates
        run = self._loop(trace, rates, control)
        telemetry = None
        if run.rings is not None:
            t0 = time.perf_counter()
            telemetry = run.rings.to_host(run.events)
            run.timings["copies"] += time.perf_counter() - t0
        return self._result(
            trace, run.admitted, run.served, state=run.state,
            residual=sum_tiles(run.state.queue),
            swaps=(ctl.swaps - swaps0 if ctl is not None
                   else np.zeros(B, dtype=np.int64)),
            backend="torch", timings=run.timings, telemetry=telemetry,
            queue_drops=run.qdrop)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host float64 array -> a new tensor on the engine's device,
        without waiting for the card (pinned memory, asynchronous copy)."""
        t = torch.from_numpy(np.array(a, dtype=np.float64))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _capacity_t(self, svc: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, A) uncontended capacity (requests/s) on the device, the
        expression of :meth:`capacity_rps`."""
        tn = self._tensors(svc["t_comp"].dtype)
        thr = tn["base"] * svc["t_ref"] / (svc["t_comp"] + svc["t_wire"])
        return thr / tn["req"]

    def _compile_faults(self, T: int) -> Optional[CompiledFaults]:
        if self.faults is None or not self.faults:
            return None
        p = self.platform
        return compile_faults(self.faults, ticks=T, names=p.names,
                              islands=p.islands, noc=p.model.noc)

    def _fault_setup(self, lp: "_Loop", T: int, dt: float,
                     supervisor) -> None:
        """The run's fault/SLO plan on ``lp``: the compiled schedule (one
        for all B designs), the host flags that gate every hook of the tick
        loop, the masks on the device (``(T, A)``, ``(T, L)``, ``(T, I)``,
        copied once, before the loop) and the ledger histories.  Without a
        schedule, an SLO or a supervisor every flag is off and the loop is
        the fault-free one."""
        B, A = self.platform.n_designs, self.platform.n_tiles
        dev, dtype = self.device, self.dtype
        cf = self._compile_faults(T)
        slo = self.slo
        if slo is None and cf is not None:
            slo = SLOConfig()               # default kill semantics
        lp.slo = slo
        lp.deadline = slo is not None and slo.deadline_s is not None
        lp.has_tile = cf is not None and cf.has_tile
        lp.has_link = cf is not None and cf.has_link
        lp.recover = (lp.has_tile and slo.recovers
                      and self.balancer is not None)
        lp.track = lp.has_tile or lp.deadline
        lp.ev_by_tick = cf.events_by_tick() if cf is not None else {}
        # the ticks where the hardware's stuck-rate row changes, from the
        # host copy; the row in force is kept for commits
        lp.stuck_changes = (set(cf.stuck_rate_changes())
                            if cf is not None and cf.has_stuck_rate
                            else set())
        lp.override = None
        lp.dead = cf.island_dead if lp.has_tile else None
        lp.stuck = cf.stuck if cf is not None and cf.has_stuck else None

        def up(a, as_dtype=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=as_dtype,
                                   device=dev)

        lp.alive_t = up(cf.tile_alive) if lp.has_tile else None
        lp.lscale_t = up(cf.link_scale) if lp.has_link else None
        lp.stuck_t = (up(cf.stuck_rate, torch.float64)
                      if lp.stuck_changes else None)
        if lp.deadline:
            lp.consts = dataclasses.replace(
                lp.consts, deadline_ticks=slo.deadline_s / dt)
        lp.qdrop = (torch.zeros((T, B, A), dtype=dtype, device=dev)
                    if lp.track else None)
        # dropped, dropped_slo, dropped_fault, retried, queue, carry
        lp.fh = (torch.zeros((T, len(FAULT_HISTORIES), B), dtype=dtype,
                             device=dev) if lp.track else None)
        lp.sup = supervisor
        if supervisor is not None:
            assert lp.has_tile, \
                "a fault supervisor needs tile faults to watch"
            assert B == 1 and dtype == torch.float64, \
                "the supervisor watches one float64 design"
            supervisor.begin_device_run(self.platform.names, T, dev)

    def _loop(self, trace, rates0: np.ndarray, control=None,
              supervisor=None) -> "_Loop":
        """The ``"torch"`` tick loop of ``trace`` from the (B, I) island
        rates ``rates0``; the sequential engine runs it at B = 1.

        ``control(tick, window, dead=, stuck=)``, on every control tick,
        gets the window (busy, boundness, pkts_in, pkts_out, rtt,
        queue_ticks) as a ``(6, B, A)`` float64 host array — the loop's one
        copy to the host — and the schedule's ``(I,)`` dead / stuck island
        rows (host arrays, or None), and returns ``None`` or ``(new (B, I)
        rates, telemetry event)``.  ``supervisor`` (a
        :class:`~repro_torch.runtime.fault.SimFaultSupervisor`, B = 1 only)
        watches the run on the device and routes recovery on its belief.
        """
        p, cfg = self.platform, self.config
        B, A, T, dt = p.n_designs, p.n_tiles, trace.ticks, trace.dt
        dev, f64, dtype = self.device, torch.float64, self.dtype
        self._check_trace(trace)
        assert A > 0, "a platform needs at least one tile"
        lp = _Loop(timings={"copies": 0.0}, control=control, ctl_ticks=0,
                   win_ticks=0)
        t0 = time.perf_counter()
        lp.arrivals = self._arrivals_t(trace, dtype)
        lp.rates_t = self._upload(rates0)
        lp.svc = self._service_t(lp.rates_t, dtype)
        if self.balancer is not None:   # its group layout, before the loop
            self.balancer.layout(dev, dtype)
        lp.consts = self.step_consts(dt, dtype)
        self._fault_setup(lp, T, dt, supervisor)
        self._sync()
        lp.timings["copies"] += time.perf_counter() - t0

        lp.state = TickState.zeros((B, A), device=dev, dtype=dtype)
        lp.carry = (torch.zeros((B, A), dtype=dtype, device=dev)
                    if lp.consts.forward is not None else None)
        # the balancer splits on last tick's capacity (initially the
        # uncontended capacity of the starting rates)
        lp.prev_cap = (self._capacity_t(lp.svc) * dt
                       if self.balancer is not None else None)
        lp.admitted = torch.zeros((T, B, A), dtype=dtype, device=dev)
        lp.served = torch.zeros((T, B, A), dtype=dtype, device=dev)
        lp.ctl_busy = torch.zeros((B, A), dtype=dtype, device=dev)
        lp.tcr = self._tensors(dtype)["tcr"]
        # telemetry: the float64 loop records, like the reference's NumPy
        # engines; the float32 one does not, like its float32 scan
        lp.rings = lp.events = None
        ti = cfg.telemetry_interval
        if dtype == f64:
            lp.rings = TelemetryRings(
                TelemetrySchema(islands=p.islands.names(), tiles=p.names),
                B, capacity=cfg.telemetry_capacity,
                n_rows=T // ti if ti else 0, device=dev)
            lp.events = []
            lp.win_busy = torch.zeros((B, A), dtype=f64, device=dev)

        self._sync()
        wall0 = time.perf_counter()
        self._ticks(lp, trace)
        self._sync()
        lp.timings["loop"] = time.perf_counter() - wall0
        if lp.sup is not None:
            t0 = time.perf_counter()
            detected = lp.sup.end_device_run()
            if lp.events is not None:
                # within a tick: the schedule's events, then the
                # supervisor's, then the controller's commit
                lp.events = sorted(lp.events + detected, key=_event_order)
            lp.timings["copies"] += time.perf_counter() - t0
        self.last_state = lp.state
        self.last_histories = (lp.admitted, lp.served)
        self.last_fault_histories = (
            None if lp.fh is None else
            {**dict(zip(FAULT_HISTORIES, lp.fh.unbind(1))),
             "queue_drops": lp.qdrop})
        return lp

    def _ticks(self, lp: "_Loop", trace) -> None:
        """Every tick of the run, from the first to the last: on the card,
        no value goes to the host here except the control window.  Every
        fault/SLO hook is gated by a host flag of :meth:`_fault_setup`, so
        a fault-free run launches none of their operations."""
        cfg, dt = self.config, trace.dt
        B, A = self.platform.n_designs, self.platform.n_tiles
        dev, f64, dtype = self.device, torch.float64, self.dtype
        st, consts, lb = lp.state, lp.consts, self.balancer
        ti, ci = cfg.telemetry_interval, cfg.control_interval
        sup, recover = lp.sup, lp.recover
        spill = lp.has_tile and lp.slo.on_kill != "wait"
        for t_i in range(trace.ticks):
            if lp.events is not None:
                lp.events.extend(dict(ev)
                                 for ev in lp.ev_by_tick.get(t_i, ()))
            alive = lp.alive_t[t_i] if lp.has_tile else None
            lscale = lp.lscale_t[t_i] if lp.has_link else None
            if t_i in lp.stuck_changes:
                # the hardware override (service terms only)
                lp.override = lp.stuck_t[t_i]
                lp.svc = self._service_t(lp.rates_t, dtype, lp.override)
            # routing acts on the BELIEVED availability (the supervisor's
            # detection state when it is in the loop, else the oracle
            # mask); the true mask still gates the hardware
            route_alive = (sup.believed_alive_device if sup is not None
                           else alive)
            respill = stranded_exit = None
            if spill:
                st.queue, st.retry_q, respill, fdrop = respill_stranded(
                    st.queue, st.retry_q, route_alive,
                    lb if recover else None)
                st.dropped_fault = st.dropped_fault + sum_tiles(fdrop)
                if recover:
                    st.retried = st.retried + sum_tiles(respill)
                stranded_exit = respill + fdrop

            arr = lp.arrivals[t_i]
            if lp.carry is not None:
                arr = arr + lp.carry
            retry_arr = None
            if lb is not None:
                arr = lb.split(arr, st.queue, lp.prev_cap,
                               alive=route_alive if recover else None)
                if recover:
                    retry_arr = lb.split(respill, st.queue, lp.prev_cap,
                                         alive=route_alive)
                    arr = arr + retry_arr
            out = tick_step(st, arr, lp.svc, consts, alive=alive,
                            link_scale=lscale, retry_in=retry_arr)
            if lp.carry is not None:
                lp.carry = out.forwarded
            if lb is not None:
                lp.prev_cap = out.cap_tick
            lp.admitted[t_i] = out.admitted
            lp.served[t_i] = out.served
            if lp.track:
                drops = [d for d in (stranded_exit, out.slo_drop)
                         if d is not None]
                if drops:
                    lp.qdrop[t_i] = (drops[0] if len(drops) == 1
                                     else drops[0] + drops[1])
                # the backlog (and the chain's carry) added over the tiles
                # as NumPy adds them; without a chain the carry row stays 0
                backlog = (sum_tiles(st.queue).unsqueeze(0)
                           if lp.carry is None else
                           sum_tiles(torch.stack([st.queue, lp.carry])))
                rows = torch.cat([torch.stack([
                    st.dropped, st.dropped_slo, st.dropped_fault,
                    st.retried]), backlog])
                lp.fh[t_i, :rows.shape[0]] = rows
            if sup is not None:
                sup.observe_device(t_i, served=out.served[0],
                                   queue=st.queue[0], cap=out.cap_tick[0],
                                   busy=st.busy[0])
            if lp.control is not None:
                lp.ctl_busy += st.busy
                lp.ctl_ticks += 1

            if lp.rings is not None and ti:
                lp.win_busy += st.busy
                lp.win_ticks += 1
                if (t_i + 1) % ti == 0:
                    # the window's served totals added tick by tick from
                    # zero, as the reference accumulates them, taken from
                    # the history in one pass over the tiles
                    totals = sum_tiles(
                        lp.served[t_i + 1 - lp.win_ticks:t_i + 1]).unbind(0)
                    win_served = 0.0 + totals[0]
                    for x in totals[1:]:
                        win_served = win_served + x
                    lp.rings.record(
                        tick=t_i, f_noc=lp.svc["f_noc"],
                        island_rates=lp.rates_t, queue_depth=st.queue,
                        busy=lp.win_busy / lp.win_ticks,
                        throughput_rps=win_served / (lp.win_ticks * dt),
                        power_w=out.tile_power + out.noc_power,
                        link_util_max=torch.clamp(out.rho.amax(dim=-1),
                                                  min=0.0),
                        link_util_mean=sum_tiles(out.rho) / A,
                        latency_est_s=(sum_tiles(st.queue) / torch.clamp(
                            sum_tiles(out.cap_tick / dt), min=1e-9)),
                        dropped=st.dropped,
                        ledgers=((st.dropped_slo, st.dropped_fault,
                                  st.retried) if lp.track else ()))
                    lp.win_busy = torch.zeros((B, A), dtype=f64, device=dev)
                    lp.win_ticks = 0

            if lp.control is not None and ci and (t_i + 1) % ci == 0:
                # the harness lives on the host: one window's counters
                # down, the committed rates (if any) back up
                t_wire_now = lp.svc["t_wire"] * out.dyn
                window = torch.stack([
                    lp.ctl_busy / max(lp.ctl_ticks, 1),
                    t_wire_now / (lp.tcr + t_wire_now),
                    st.pkts_in, st.pkts_out, st.rtt_acc,
                    st.queue / torch.clamp(out.cap_tick, min=1e-12)]
                ).to(f64).cpu().numpy()
                commit = lp.control(
                    t_i, window,
                    dead=lp.dead[t_i] if lp.dead is not None else None,
                    stuck=lp.stuck[t_i] if lp.stuck is not None else None)
                lp.ctl_busy = torch.zeros((B, A), dtype=dtype, device=dev)
                lp.ctl_ticks = 0
                if commit is not None:
                    new_rates, event = commit
                    lp.rates_t = self._upload(new_rates)
                    lp.svc = self._service_t(lp.rates_t, dtype, lp.override)
                    if lp.events is not None:
                        lp.events.append(event)

    def _host_summary(self, trace, admitted_hist, served_hist, *,
                      state: TickState, residual, timings,
                      queue_drops=None) -> Dict[str, np.ndarray]:
        """``completed``, ``dropped``, ``residual``, ``energy``, the three
        fault/SLO ledgers and ``p50`` / ``p99`` of every design as (B,) host
        arrays: the latency percentiles reconstructed on the engine's
        device (``queue_drops`` joining the exit curves), then one copy."""
        self._sync()
        t0 = time.perf_counter()
        p50_t, p99_t = latency_percentiles_batch(
            admitted_hist, served_hist, trace.dt, queue_drops=queue_drops)
        self._sync()
        timings["percentiles"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        f64 = torch.float64
        cols = {"completed": self._completed(served_hist),
                "dropped": state.dropped, "residual": residual,
                "energy": state.energy, "dropped_slo": state.dropped_slo,
                "dropped_fault": state.dropped_fault,
                "retried": state.retried, "p50": p50_t, "p99": p99_t}
        small = torch.stack([c.to(f64) for c in cols.values()]
                            ).cpu().numpy()
        timings["copies"] += time.perf_counter() - t0
        return {k: np.ascontiguousarray(r) for k, r in zip(cols, small)}

    def _result(self, trace, admitted_hist, served_hist, *, state,
                residual, swaps, backend, timings, telemetry=None,
                queue_drops=None) -> BatchSimResult:
        """Assemble the per-design result on the host.  ``state`` holds the
        (B,) ledgers and ``residual`` is a (B,) tensor, on the engine's
        device; latency percentiles are reconstructed there for all
        designs at once."""
        B, T, dt = self.platform.n_designs, trace.ticks, trace.dt
        h = self._host_summary(trace, admitted_hist, served_hist,
                               state=state, residual=residual,
                               timings=timings, queue_drops=queue_drops)
        completed, energy = h["completed"], h["energy"]
        sim_seconds = T * dt
        return BatchSimResult(
            n_designs=B, ticks=T, dt=dt,
            offered=self._offered(trace),
            completed=completed, dropped=h["dropped"],
            residual=h["residual"],
            throughput_rps=(completed / sim_seconds if sim_seconds
                            else np.zeros(B)),
            p50_latency_s=h["p50"], p99_latency_s=h["p99"], energy_j=energy,
            energy_per_request_j=np.where(
                completed > 0, energy / np.maximum(completed, 1e-9),
                np.nan),
            mean_power_w=(energy / sim_seconds if sim_seconds
                          else np.zeros(B)),
            swaps=np.asarray(swaps, dtype=np.int64),
            elapsed_wall_s=timings["loop"], backend=backend,
            telemetry=telemetry, dropped_slo=h["dropped_slo"],
            dropped_fault=h["dropped_fault"], retried=h["retried"],
            timings=timings)

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
        self.last_state = state = TickState(
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
        self.last_fault_histories = None
        return self._result(
            trace, admitted, served, state=state,
            residual=out["queue"].to(f64).sum(dim=-1), swaps=swapsF,
            backend="fused", timings=timings)
