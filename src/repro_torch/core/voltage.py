"""Technology-node voltage/frequency scaling: the physical DVFS model.

The linear proxy ``V(f) = 0.7 + 0.3 f`` in :mod:`repro_torch.core.perfmodel`
treats voltage as a fixed affine function of frequency with no notion of
process node.  This module supplies the physically-grounded alternative:
Lumos-style ITRS/conservative scaling tables (45 -> 8 nm) giving each
node its nominal Vdd, threshold voltage Vth, and frequency/power/area
scaling factors, from which a :class:`TechModel` derives

* the node's **voltage curve** ``V(f) = Vth + f (Vdd - Vth)`` — the
  linear-over-threshold operating map: at the nominal DVFS ratio f=1 the
  island runs at Vdd, and as f drops the voltage falls toward (never
  below) the threshold;
* the node's **legal DVFS ratio range** ``[L, U]``: scaling below
  ``L = Vth / Vdd`` would push the operating point under threshold
  (lumos's ``DVFS_L_BOUND``), and ``U = 1.3`` is the conventional
  overdrive ceiling (``DVFS_U_BOUND``) — DFS commits are clamped to this
  range when a tech model is in the loop;
* the per-island **voltage ladder** coupled to an existing frequency
  :class:`~repro_torch.core.islands.RateLadder` (one voltage step per
  frequency step, plus its legality mask).

Energy sites combine these with the wattage constants that stay in
:mod:`repro_torch.core.perfmodel` (the single shared constants block):

    P(f, busy) = power_scl * (P_STATIC_W + P_DYN_W * f * V̂(f)^2 * busy)

with ``V̂(f) = v0 + v1 f`` the Vdd-normalized voltage curve — the same
functional form as the linear proxy, so every backend (NumPy / torch /
the fused CUDA kernel) threads the physical model as three compile-time
scalars ``(p_scale, v0, v1)`` and the ``tech=None`` default keeps the
legacy expressions bit for bit.

This module is intentionally free of any :mod:`repro_torch.core.perfmodel`
import (perfmodel imports *us*): it is pure scaling theory — ratios,
volts and bounds — with no wattage numbers baked in.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# Lumos scaling tables (hoangt/lumos ``tech.py``): ITRS projections and
# the conservative variant, normalized to the 45 nm node.
# ---------------------------------------------------------------------------

#: Process nodes the tables cover, largest (oldest) first.
TECH_NODES: Tuple[int, ...] = (45, 32, 22, 16, 11, 8)

#: Scaling-table variants: ITRS projections vs conservative scaling.
TECH_VARIANTS: Tuple[str, ...] = ("itrs", "cons")

#: Nominal supply voltage at the 45 nm reference node (volts).
VDD_BASE = 1.0

#: Nominal supply-voltage scale per node (x ``VDD_BASE``).
VDD_SCALE: Dict[str, Dict[int, float]] = {
    "itrs": {45: 1.0, 32: 0.93, 22: 0.84, 16: 0.75, 11: 0.68, 8: 0.62},
    "cons": {45: 1.0, 32: 0.93, 22: 0.88, 16: 0.86, 11: 0.84, 8: 0.84},
}

#: Nominal core frequency scale per node (x the 45 nm frequency).
FREQ_SCALE: Dict[str, Dict[int, float]] = {
    "itrs": {45: 1.0, 32: 1.09, 22: 2.38, 16: 3.21, 11: 4.17, 8: 3.85},
    "cons": {45: 1.0, 32: 1.10, 22: 1.19, 16: 1.25, 11: 1.30, 8: 1.34},
}

#: Nominal dynamic-power scale per node (x the 45 nm power).
POWER_SCALE: Dict[str, Dict[int, float]] = {
    "itrs": {45: 1.0, 32: 0.66, 22: 0.54, 16: 0.38, 11: 0.25, 8: 0.12},
    "cons": {45: 1.0, 32: 0.71, 22: 0.52, 16: 0.39, 11: 0.29, 8: 0.22},
}

#: Area scale per node (ideal 0.5x per full node step; variant-free).
AREA_SCALE: Dict[int, float] = {
    45: 1.0, 32: 0.5, 22: 0.25, 16: 0.125, 11: 0.0625, 8: 0.03125,
}

#: Threshold voltage per node (volts; variant-free in lumos).
VTH: Dict[int, float] = {
    45: 0.3201, 32: 0.297, 22: 0.2673, 16: 0.2409, 11: 0.2178, 8: 0.198,
}

#: DVFS overdrive ceiling on the frequency/voltage ratio (all nodes).
DVFS_U_BOUND = 1.3


def dvfs_bounds(node: int, variant: str = "itrs") -> Tuple[float, float]:
    """``(L, U)`` legal DVFS ratio range of one node/variant.

    ``L = Vth / Vdd_nom`` — the ratio at which the supply hits the
    threshold voltage (lumos ``DVFS_L_BOUND``); ``U`` is the overdrive
    ceiling :data:`DVFS_U_BOUND`.
    """
    vdd_nom = VDD_SCALE[variant][node] * VDD_BASE
    return VTH[node] / vdd_nom, DVFS_U_BOUND


# A tech spec users may pass at API boundaries: an existing model, a bare
# node (45), or a (node, variant) pair.
TechSpec = Union[None, "TechModel", int, Tuple[int, str]]


@dataclass(frozen=True)
class TechModel:
    """One process node + scaling variant, with every derived scalar the
    energy sites and DFS clamps need precomputed.

    Hashable and frozen so it can ride inside ``lru_cache`` keys and the
    batched engines' explicit jit-cache signatures (two models are equal
    iff their ``(node, variant)`` agree — everything else is derived).
    """
    node: int = 45
    variant: str = "itrs"
    # derived scalars (filled in __post_init__; excluded from eq/hash so
    # the (node, variant) identity stays the cache key)
    vdd: float = field(init=False, compare=False)        # nominal volts
    vth: float = field(init=False, compare=False)        # threshold volts
    freq_scl: float = field(init=False, compare=False)
    power_scl: float = field(init=False, compare=False)
    area_scl: float = field(init=False, compare=False)
    l_bound: float = field(init=False, compare=False)    # legal f >= L
    u_bound: float = field(init=False, compare=False)    # legal f <= U
    v0: float = field(init=False, compare=False)         # V̂(0) = Vth/Vdd
    v1: float = field(init=False, compare=False)         # V̂ slope (1-v0)

    def __post_init__(self) -> None:
        if self.node not in TECH_NODES:
            raise ValueError(
                f"unknown tech node {self.node!r}; known: {TECH_NODES}")
        if self.variant not in TECH_VARIANTS:
            raise ValueError(
                f"unknown tech variant {self.variant!r}; "
                f"known: {TECH_VARIANTS}")
        vdd = VDD_SCALE[self.variant][self.node] * VDD_BASE
        vth = VTH[self.node]
        osa = object.__setattr__
        osa(self, "vdd", vdd)
        osa(self, "vth", vth)
        osa(self, "freq_scl", FREQ_SCALE[self.variant][self.node])
        osa(self, "power_scl", POWER_SCALE[self.variant][self.node])
        osa(self, "area_scl", AREA_SCALE[self.node])
        l, u = dvfs_bounds(self.node, self.variant)
        osa(self, "l_bound", l)
        osa(self, "u_bound", u)
        osa(self, "v0", vth / vdd)
        osa(self, "v1", 1.0 - vth / vdd)

    # -------------------------------------------------------- construction
    @classmethod
    def coerce(cls, spec: TechSpec) -> Optional["TechModel"]:
        """Normalize a user-facing tech spec: ``None`` stays ``None``
        (linear proxy), an int is a node at the default ITRS variant, a
        ``(node, variant)`` pair selects both, and an existing model
        passes through."""
        if spec is None or isinstance(spec, cls):
            return spec
        if isinstance(spec, int):
            return cls(node=spec)
        if isinstance(spec, (tuple, list)) and len(spec) == 2:
            return cls(node=int(spec[0]), variant=str(spec[1]))
        raise TypeError(
            f"tech spec must be None, a TechModel, a node int, or a "
            f"(node, variant) pair; got {spec!r}")

    @property
    def key(self) -> Tuple[int, str]:
        """The identity the caches key on."""
        return (self.node, self.variant)

    # ------------------------------------------------------ voltage curves
    def volt_ratio(self, f):
        """Vdd-normalized operating voltage ``V̂(f) = v0 + v1 f``.

        Vectorized and array-namespace agnostic (operators only): works
        on floats, numpy arrays and torch tensors alike.
        """
        return self.v0 + self.v1 * f

    def volt_of_freq(self, f):
        """Absolute operating voltage (volts) at normalized rate ``f``:
        ``Vth + f (Vdd - Vth)`` — the linear-over-threshold map."""
        return self.volt_ratio(f) * self.vdd

    def freq_ratio(self, v_ratio):
        """Inverse of :meth:`volt_ratio`: the normalized frequency a
        Vdd-relative voltage sustains, ``(v_ratio - v0) / v1``.
        Vectorized; exact inverse (``freq_ratio(volt_ratio(f)) == f``)."""
        return (v_ratio - self.v0) / self.v1

    # -------------------------------------------------------- DVFS bounds
    def clamp_ratio(self, f):
        """Clamp requested DVFS ratio(s) into the legal ``[L, U]`` range
        (NaN — the batch controllers' "no request" marker — passes
        through untouched, matching ``np.clip`` semantics)."""
        return np.clip(f, self.l_bound, self.u_bound)

    def legal(self, f):
        """Elementwise legality of DVFS ratio(s) against ``[L, U]``."""
        f = np.asarray(f, dtype=np.float64)
        return (f >= self.l_bound) & (f <= self.u_bound)

    # ----------------------------------------------------- ladder coupling
    def ladder_voltages(self, ladder) -> np.ndarray:
        """The per-island voltage ladder coupled to a frequency
        :class:`~repro_torch.core.islands.RateLadder`: the absolute operating
        voltage (volts) at every quantized frequency level."""
        return self.volt_of_freq(np.asarray(ladder.levels(),
                                            dtype=np.float64))

    def legal_levels(self, ladder) -> np.ndarray:
        """Boolean mask of ladder levels inside the legal DVFS range —
        the levels a clamped DFS commit can actually land on."""
        return self.legal(np.asarray(ladder.levels(), dtype=np.float64))

    # -------------------------------------------------------------- power
    @property
    def power_coeffs(self) -> Tuple[float, float, float]:
        """``(p_scale, v0, v1)`` — the three Python scalars every energy
        backend bakes in: ``P = p_scale * (P_STATIC_W + P_DYN_W * f *
        (v0 + v1 f)^2 * busy)``."""
        return (self.power_scl, self.v0, self.v1)

    def __repr__(self) -> str:  # compact: the identity + the bounds
        return (f"TechModel({self.node}nm/{self.variant}, "
                f"Vdd={self.vdd:.2f}V, Vth={self.vth:.3f}V, "
                f"DVFS=[{self.l_bound:.3f}, {self.u_bound:.1f}])")


def tech_axis_coeffs(techs) -> Dict[str, np.ndarray]:
    """Per-axis coefficient arrays for a sequence of tech models (the
    ``grid_sweep`` tech axis): aligned ``p_scale`` / ``v0`` / ``v1``
    float64 arrays ready for broadcast against the sweep grid."""
    models = [TechModel.coerce(t) for t in techs]
    return {
        "tech_ps": np.asarray([t.power_scl for t in models], np.float64),
        "tech_v0": np.asarray([t.v0 for t in models], np.float64),
        "tech_v1": np.asarray([t.v1 for t in models], np.float64),
    }
