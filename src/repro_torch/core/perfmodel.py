"""Frequency-aware performance & energy model of the paper's SoC.

Evaluates the paper's 4x4 SoC (CHStone tiles, five frequency islands) so the
sweep and the co-simulation can reproduce Table I / Fig. 3 / Fig. 4 shapes
analytically.

Frequency semantics: an island's normalized rate f scales the *service
rate* of its components — compute for accelerator islands, link bandwidth +
memory-controller service for the noc_mem island.  Energy:
P(f) = P_static + P_dyn · f · V(f)^2 with V(f) = 0.7 + 0.3 f (classic DVFS
voltage scaling), or the physical curve of a
:class:`~repro_torch.core.voltage.TechModel`.

Every formula is written ONCE over an array namespace ``xp`` — NumPy for the
float64 host path (the bit-for-bit ground truth against the reference
package) or :data:`TORCH_NS` for tensors on the card — so the two paths
cannot drift.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.noc import NocConfig, hops, pos_index, routing_tables
from repro_torch.core.voltage import TechModel

# ---------------------------------------------------------------------------
# THE shared energy-model constants block.  Every layer that charges
# energy — grid_sweep/_eval_grid, the flat-point evaluator, the batched tick
# engines, the fused CUDA tick kernel (which receives them as launch
# parameters) — imports these instead of re-deriving its own literals.
# ---------------------------------------------------------------------------
P_STATIC_W = 60.0            # per chip, modeled
P_DYN_W = 140.0              # at f=1, modeled
V_BASE = 0.7                 # linear voltage proxy: V(f) = V_BASE + V_SLOPE f
V_SLOPE = 0.3
NOC_POWER_SHARE = 0.3        # NoC+MEM power as a share of one tile's


class _TorchNamespace:
    """The few array functions the shared formulas use, over torch tensors.

    ``maximum``/``minimum`` accept a Python scalar on either side (torch's
    own need two tensors); a scalar bound becomes a ``clamp``, which rounds
    exactly like NumPy's elementwise max/min."""

    @staticmethod
    def maximum(a, b):
        if not torch.is_tensor(b):
            return torch.clamp(a, min=b) if torch.is_tensor(a) else max(a, b)
        if not torch.is_tensor(a):
            return torch.clamp(b, min=a)
        return torch.maximum(a, b)

    @staticmethod
    def minimum(a, b):
        if not torch.is_tensor(b):
            return torch.clamp(a, max=b) if torch.is_tensor(a) else min(a, b)
        if not torch.is_tensor(a):
            return torch.clamp(b, max=a)
        return torch.minimum(a, b)

    @staticmethod
    def zeros_like(a):
        return torch.zeros_like(a)


TORCH_NS = _TorchNamespace()


def voltage(f):
    return V_BASE + V_SLOPE * f


def _dynamic_coeffs(f_comp, v0, v1):
    """``P_DYN_W * f * (v0 + v1 f)^2``: the dynamic factor of the physical
    curve, busy not yet applied."""
    v = v0 + v1 * f_comp
    return P_DYN_W * f_comp * v * v


def chip_power_coeffs(f_comp, busy, v0, v1, p_scale):
    """Chip power from explicit voltage-curve coefficients:
    ``p_scale * (P_STATIC_W + P_DYN_W * f * (v0 + v1 f)^2 * busy)``.

    Operators only, so it broadcasts over numpy arrays and torch tensors
    alike — the form the tech-axis sweep evaluates with per-point
    coefficient arrays."""
    return p_scale * (P_STATIC_W + _dynamic_coeffs(f_comp, v0, v1) * busy)


def chip_power_dynamic(f_comp, *, tech: Optional[TechModel] = None):
    """The busy-independent factor of :func:`chip_power`'s dynamic term,
    so a tick loop whose rates change only on commits computes it once per
    commit and finishes each tick with :func:`chip_power_from_dynamic`."""
    if tech is None:
        return P_DYN_W * f_comp * voltage(f_comp) ** 2
    return _dynamic_coeffs(f_comp, tech.v0, tech.v1)


def chip_power_from_dynamic(dyn_busy, *, tech: Optional[TechModel] = None):
    """Chip power from ``chip_power_dynamic(f) * busy``."""
    if tech is None:
        return P_STATIC_W + dyn_busy
    return tech.power_scl * (P_STATIC_W + dyn_busy)


def chip_power(f_comp, busy, *, tech: Optional[TechModel] = None):
    """Modeled chip power at normalized rate f and duty cycle busy.

    ``tech=None`` (default) is the linear voltage proxy and keeps the
    reference expression ``P_STATIC_W + P_DYN_W * f * V(f)**2 * busy``
    (the same products in the same order) — the bit-exact parity
    reference.  With a :class:`~repro_torch.core.voltage.TechModel`, power
    follows the node's physical curve
    ``power_scl * (P_static + P_dyn f V̂(f)^2)``.
    """
    return chip_power_from_dynamic(chip_power_dynamic(f_comp, tech=tech)
                                   * busy, tech=tech)


# ---------------------------------------------------------------------------
# Paper-claims engine: CHStone accelerator tiles on the 4x4 SoC
# ---------------------------------------------------------------------------


# Per-accelerator serialized wire-interface share w, calibrated so that
# gain(K) = 1 / ((1-w)/K + w) reproduces each accelerator's measured
# Table-I throughput gains.  K replicas parallelize compute AND the
# overlappable stream latency (each replica is an independent engine
# behind the AXI bridge); only the tile's shared NoC interface serializes.
WIRE_SHARE = {
    "adpcm": 0.0005,    # strongly compute-bound: gains ~K (1.97x / 3.86x)
    "dfsin": 0.003,     # compute-bound (1.97x / 3.76x)
    "gsm": 0.035,       # mixed (1.93x / 3.62x)
    "dfadd": 0.12,      # memory-bound (1.83x / 2.83x)
    "dfmul": 0.155,     # memory-bound (1.73x / 3.00x)
}


@dataclass(frozen=True)
class AccelWorkload:
    """One CHStone accelerator processing a data stream.

    ``ai`` (arithmetic intensity, ops/byte) separates compute-bound (adpcm,
    dfsin) from memory-bound (dfadd, dfmul) accelerators, as the paper
    observed empirically.  ``base_mbps`` anchors absolute throughput to
    Table I so reproduced numbers are comparable.
    """
    name: str
    base_mbps: float
    ai: float
    replication: int = 1

    @property
    def compute_bound(self) -> bool:
        return self.ai >= 8.0

    @property
    def wire_share(self) -> float:
        if self.name in WIRE_SHARE:
            return WIRE_SHARE[self.name]
        return 0.01 if self.compute_bound else 0.14


def _service_terms_math(xp, wire_share, k, f_acc, f_noc, f_tg, n_tg,
                        hop_counts, *, own_demand, tg_demand, link_bw,
                        hop_latency_share, ref_hops):
    """``(t_comp, t_wire, t_ref)`` of the service-time model as pure array
    math: the compute term ``(1-w)/(K f_acc)``, the serialized wire/NoC term
    ``w·slow·hopf/f_noc`` and the Table-I normalization ``t0``."""
    f_acc = xp.maximum(f_acc, 1e-3)
    f_noc = xp.maximum(f_noc, 1e-3)
    w = wire_share
    # NoC saturation: proportional sharing of the f_noc-scaled capacity
    load = own_demand + tg_demand * f_tg * n_tg
    slow = xp.maximum(1.0, load / (link_bw * f_noc))
    hopf = 1.0 + hop_latency_share * hop_counts
    t_comp = (1.0 - w) / (k * f_acc)
    t_wire = w * slow * hopf / f_noc
    hopf0 = 1.0 + hop_latency_share * ref_hops
    t_ref = (1.0 - w) + w * max(1.0, own_demand) * hopf0
    return t_comp, t_wire, t_ref


def _throughput_math(xp, base_mbps, wire_share, k, f_acc, f_noc, f_tg,
                     n_tg, hop_counts, *, own_demand, tg_demand, link_bw,
                     hop_latency_share, ref_hops):
    """The accelerator service-time model as pure array math.

    ``xp`` is the array namespace (numpy or :data:`TORCH_NS`); every data
    argument broadcasts, so the same expression serves the scalar wrapper,
    the numpy batch path, and the torch path on the card.  Kept in one place
    so the paths can never drift.
    """
    # one op sequence with the decomposed form: t = t_comp + t_wire, and the
    # Table-I normalization (A1, K=1, f=1, no TG) is t_ref
    t_comp, t_wire, t_ref = _service_terms_math(
        xp, wire_share, k, f_acc, f_noc, f_tg, n_tg, hop_counts,
        own_demand=own_demand, tg_demand=tg_demand, link_bw=link_bw,
        hop_latency_share=hop_latency_share, ref_hops=ref_hops)
    return base_mbps * t_ref / (t_comp + t_wire)


def _memory_traffic_math(xp, f_acc, f_noc, f_tg, n_tg, n_accels, *,
                         mem_service, tg_demand_fig4):
    mem_cap = mem_service * f_noc
    tg_offer = tg_demand_fig4 * f_tg * n_tg
    acc_offer = n_accels * xp.minimum(1.0, 5.0 * f_acc) * xp.minimum(1.0, f_noc)
    return xp.minimum(mem_cap, tg_offer + acc_offer)


def _memory_traffic_math_per_accel(xp, f_acc_terms, f_noc, f_tg, n_tg, *,
                                   mem_service, tg_demand_fig4):
    """Per-accelerator-island form of the Fig.-4 model: each accelerator
    offers ``min(1, 5 f_a)`` at its *own* island rate instead of ``n_accels``
    copies of one shared rate.  The offers are summed in list order
    (sequential) — the parity contract the per-island DSE sweep relies on:
    with every ``f_a`` equal, the arithmetic is the exact op sequence the
    shared-rate sweep runs, so the two agree bit for bit.
    """
    mem_cap = mem_service * f_noc
    tg_offer = tg_demand_fig4 * f_tg * n_tg
    if len(f_acc_terms) == 0:
        return xp.minimum(mem_cap, tg_offer + xp.zeros_like(f_noc))
    acc = xp.minimum(1.0, 5.0 * f_acc_terms[0])
    for f in f_acc_terms[1:]:
        acc = acc + xp.minimum(1.0, 5.0 * f)
    acc_offer = acc * xp.minimum(1.0, f_noc)
    return xp.minimum(mem_cap, tg_offer + acc_offer)


def _as_tensors(values, device, dtype):
    return [torch.as_tensor(v, dtype=dtype, device=device) for v in values]


@dataclass
class SoCPerfModel:
    """The paper's SoC: accelerator tiles + TG tiles + MEM on a 4x4 NoC,
    five frequency islands.

    Service-time model per accelerator tile:
        t(K, f) = (1 - w) / (K · f_acc)  +  w · slow · hopf / f_noc
    where ``w`` is the tile's serialized wire share (WIRE_SHARE), ``slow``
    the NoC saturation factor (proportional sharing of the f_noc-scaled
    link capacity with TG flows), and ``hopf`` a per-hop latency factor
    (placement: A1 near MEM vs A2 far, paper Fig. 2).

    The ``*_batch`` methods evaluate stacked arrays of design points in one
    vectorized pass; ``backend="numpy"`` is the float64 host path (returns
    ``np.ndarray``, bit-for-bit the reference package), ``backend="torch"``
    evaluates the same formulas on tensors of ``device``/``dtype`` and
    returns a tensor there.  The scalar methods are thin wrappers over the
    batch kernel, so the paths cannot diverge.
    """
    noc: NocConfig = field(default_factory=lambda: NocConfig(4, 4))
    mem_pos: Tuple[int, int] = (1, 0)
    mem_service: float = 8.0        # units/cycle at f_noc=1 (Fig. 4)
    tg_demand: float = 0.07         # per active TG core at f_tg=1 (Fig. 3)
    tg_demand_fig4: float = 0.5     # Fig. 4 uses heavier TG streams
    own_demand: float = 0.1
    hop_latency_share: float = 0.03

    # ------------------------------------------------------------- helpers
    def _ref_hops(self) -> int:
        """Hops of the Table-I reference placement (A1 = (1, 1))."""
        return hops(self.noc, (1, 1), self.mem_pos)

    def hop_counts(self, pos=None, pos_idx=None) -> np.ndarray:
        """Hop counts from position(s) to the MEM tile via the cached
        routing tables.  ``pos`` is one (r, c) tuple or an (..., 2) array;
        ``pos_idx`` flat node indices."""
        tables = routing_tables(self.noc)
        mem_idx = pos_index(self.noc, self.mem_pos)
        if pos_idx is None:
            a = np.asarray(pos)
            pos_idx = a[..., 0] * self.noc.cols + a[..., 1]
        return tables.hop_matrix[np.asarray(pos_idx), mem_idx]

    def _service_consts(self) -> Dict[str, float]:
        return dict(own_demand=self.own_demand, tg_demand=self.tg_demand,
                    link_bw=self.noc.link_bw,
                    hop_latency_share=self.hop_latency_share,
                    ref_hops=self._ref_hops())

    # -------------------------------------------------------- batched API
    def accel_throughput_batch(self, *, base_mbps, wire_share, k,
                               f_acc, f_noc, f_tg=1.0, n_tg=0,
                               pos=None, pos_idx=None, hop_counts=None,
                               backend: str = "numpy", device=None,
                               dtype: torch.dtype = torch.float64):
        """Throughput (MB/s) for a stacked batch of design points.

        Every argument broadcasts against the others, so a full
        cross-product sweep passes each axis reshaped to its own dimension
        and gets the full grid back in one call.  ``pos`` (one (r, c) or
        (..., 2) array) or ``pos_idx`` (flat node indices) are resolved
        through the precomputed hop matrix; ``hop_counts`` passes the hop
        counts directly (a tensor already on the card, for the torch
        backend).  ``backend="torch"`` needs an explicit ``device``.
        """
        assert backend in ("numpy", "torch"), backend
        if hop_counts is None:
            hop_counts = self.hop_counts(pos=pos, pos_idx=pos_idx)
        consts = self._service_consts()
        data = (base_mbps, wire_share, k, f_acc, f_noc, f_tg, n_tg,
                hop_counts)
        if backend == "torch":
            assert device is not None, "backend='torch' needs device="
            return _throughput_math(
                TORCH_NS, *_as_tensors(data, device, dtype), **consts)
        arrs = [np.asarray(a, dtype=np.float64) for a in data[:-1]]
        return _throughput_math(np, *arrs, hop_counts, **consts)

    def service_time_terms_batch(self, *, wire_share, k,
                                 f_acc, f_noc, f_tg=1.0, n_tg=0,
                                 pos=None, pos_idx=None, hop_counts=None,
                                 backend: str = "numpy", device=None,
                                 dtype: torch.dtype = torch.float64):
        """Decomposed service time of the throughput kernel.

        Returns ``(t_comp, t_wire, t_ref)`` — the compute term
        ``(1-w)/(K f_acc)``, the serialized wire/NoC term
        ``w·slow·hopf/f_noc``, and the Table-I normalization ``t0`` — such
        that ``base_mbps * t_ref / (t_comp + t_wire)`` equals
        :meth:`accel_throughput_batch` exactly (tested).  The simulation
        engine consumes the split form: ``t_wire/(t_comp+t_wire)`` is the
        stream-boundness signal the Fig.-4 DFS policy keys on, and dynamic
        NoC contention (from live per-tick flows) scales ``t_wire`` alone.

        ``hop_counts`` overrides the tile->MEM hop lookup with explicit
        per-stream hop counts — how tile-to-tile flow patterns reuse this
        kernel with each stream's actual route length.
        """
        assert backend in ("numpy", "torch"), backend
        if hop_counts is None:
            hop_counts = self.hop_counts(pos=pos, pos_idx=pos_idx)
        consts = self._service_consts()
        data = (wire_share, k, f_acc, f_noc, f_tg, n_tg)
        if backend == "torch":
            assert device is not None, "backend='torch' needs device="
            return _service_terms_math(
                TORCH_NS, *_as_tensors(data + (hop_counts,), device, dtype),
                **consts)
        arrs = [np.asarray(a, dtype=np.float64) for a in data]
        return _service_terms_math(np, *arrs, hop_counts, **consts)

    def memory_traffic_batch(self, *, f_acc=None, f_noc, f_tg=1.0, n_tg=0,
                             n_accels=1, f_acc_per_accel=None,
                             backend: str = "numpy", device=None,
                             dtype: torch.dtype = torch.float64):
        """Batched Fig.-4 memory-traffic model (broadcasting arguments).

        Two forms: the shared-rate form takes one ``f_acc`` plus
        ``n_accels`` — the number of accelerator tiles streaming to MEM.
        The per-island form takes ``f_acc_per_accel`` — a sequence of rate
        arrays, one per accelerator island, each broadcasting over the
        design axes — and sums each accelerator's offer at its *own* island
        rate (bit-for-bit equal to the shared form when every entry carries
        equal rates)."""
        assert backend in ("numpy", "torch"), backend
        kw = dict(mem_service=self.mem_service,
                  tg_demand_fig4=self.tg_demand_fig4)
        if backend == "torch":
            assert device is not None, "backend='torch' needs device="
            xp = TORCH_NS

            def conv(vals):
                return _as_tensors(vals, device, dtype)
        else:
            xp = np

            def conv(vals):
                return [np.asarray(a, dtype=np.float64) for a in vals]
        if f_acc_per_accel is not None:
            assert f_acc is None, "pass f_acc or f_acc_per_accel, not both"
            return _memory_traffic_math_per_accel(
                xp, conv(f_acc_per_accel), *conv((f_noc, f_tg, n_tg)), **kw)
        return _memory_traffic_math(
            xp, *conv((f_acc, f_noc, f_tg, n_tg, n_accels)), **kw)

    # --------------------------------------------------------- scalar API
    def accel_throughput(self, wl: AccelWorkload, pos: Tuple[int, int],
                         rates: Dict[str, float], n_tg: int) -> float:
        """Throughput (MB/s) of one accelerator tile under contention.

        Thin wrapper over :meth:`accel_throughput_batch` (same kernel)."""
        out = self.accel_throughput_batch(
            base_mbps=wl.base_mbps, wire_share=wl.wire_share,
            k=wl.replication, f_acc=rates.get("acc", 1.0),
            f_noc=rates.get("noc_mem", 1.0), f_tg=rates.get("tg", 1.0),
            n_tg=n_tg, pos=pos)
        return float(out)

    def memory_traffic_mpkts(self, rates: Dict[str, float], n_tg: int,
                             accel_positions: List[Tuple[int, int]],
                             pkt_bytes: float = 64.0) -> float:
        """Incoming memory traffic (Mpkt/s-shaped, normalized) — Fig. 4.

        TG cores offer f_tg-scaled demand; memory-bound accelerators
        saturate their stream path at low f_acc already, so traffic is
        *almost independent of f_acc* — the paper's headline observation.
        Thin wrapper over :meth:`memory_traffic_batch`."""
        out = self.memory_traffic_batch(
            f_acc=rates.get("acc", 1.0), f_noc=rates.get("noc_mem", 1.0),
            f_tg=rates.get("tg", 1.0), n_tg=n_tg,
            n_accels=len(accel_positions))
        return float(out)
