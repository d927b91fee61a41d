"""Design-space exploration — what Vespa exists for.

Sweeps the paper's three design axes and reports Pareto-optimal points:

* replication K per accelerator tile    (C1),
* per-island rate assignment            (C2),
* tile placement on the NoC grid        (Fig. 2's A1-near vs A2-far).

:func:`grid_sweep` is the batched array program.  It materializes the full
cross-product (joint multi-accelerator K ladders x island-rate ladders x all
grid placements), evaluates every point through the :class:`SoCPerfModel`
formulas, and returns a :class:`SweepResult` of flat objective arrays — no
per-point Python objects.  DesignPoints are materialized lazily
(:meth:`SweepResult.design_point`) only for the handful of survivors (Pareto
front / top-k).

Where it runs.  With ``device="cpu"`` the grid is evaluated on the host in
NumPy float64 as broadcast axes (:func:`_eval_grid`) — bit for bit the
reference package's sweep, and the port's ground truth.  On a CUDA device the
flat point axis lives on the card (:func:`_eval_flat_points`): the
coordinate decode (``unravel_index`` with integer ops), the axis gathers, the
throughput / energy / memory-traffic formulas (float64 by default), the area
sum and the placement mask all run there, and only the flat objective arrays
come back for the host-side Pareto / top-k, which stay NumPy float64.

:func:`closed_loop_score` re-ranks survivors by *simulated* runtime behaviour
through the batched co-simulation engine (``sim/batch.py``).

The Pareto front is sort-based O(N log N) (:func:`pareto_front_indices`);
the O(N^2) brute force survives as :func:`pareto_front_bruteforce` for
verification.  The chunked streaming sweep, the per-point sequential scoring
path and the scalar reference sweep of the reference package are not ported
yet.
"""
from __future__ import annotations

import time
from bisect import bisect_right
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.noc import pos_index
from repro_torch.core.perfmodel import (AccelWorkload, NOC_POWER_SHARE,
                                        SoCPerfModel, TORCH_NS, chip_power,
                                        chip_power_coeffs,
                                        _memory_traffic_math_per_accel,
                                        _throughput_math)
from repro_torch.core.replication import replication_area_model
from repro_torch.core.voltage import TechModel, tech_axis_coeffs


@dataclass(frozen=True)
class DesignPoint:
    replication: Dict[str, int]
    rates: Dict[str, float]
    placement: Dict[str, Tuple[int, int]]
    throughput: float
    area: float                    # normalized resource cost
    energy_per_unit: float
    tech: Optional[Tuple[int, str]] = None   # (node, variant) when swept

    def key(self):
        return (tuple(sorted(self.replication.items())),
                tuple(sorted(self.rates.items())),
                tuple(sorted(self.placement.items())),
                self.tech)


# ---------------------------------------------------------------------------
# Pareto fronts
# ---------------------------------------------------------------------------


def pareto_front_indices(throughput, area, energy) -> np.ndarray:
    """Indices of the 3-objective Pareto front in O(N log N).

    Maximize ``throughput``; minimize ``area`` and ``energy``.  Points are
    processed in descending-throughput groups; a (area, energy) staircase
    of the already-accepted, strictly-faster points answers "is this point
    dominated?" in O(log F).  Semantics match the O(N^2) brute force: q
    dominates p iff q is >=/<=/<= on all three objectives and strictly
    better on at least one (exact duplicates do not dominate each other).
    Returns indices in ascending input order.
    """
    thr = np.asarray(throughput, dtype=np.float64)
    area = np.asarray(area, dtype=np.float64)
    energy = np.asarray(energy, dtype=np.float64)
    n = thr.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int64)
    order = np.lexsort((energy, area, -thr))
    # python lists: ~3x faster to index in the scan than numpy scalars
    thr_l = thr[order].tolist()
    area_l = area[order].tolist()
    energy_l = energy[order].tolist()
    order_l = order.tolist()

    keep: List[int] = []
    stair_a: List[float] = []       # staircase areas, ascending
    stair_e: List[float] = []       # matching energies, strictly descending
    INF = float("inf")
    i = 0
    while i < n:
        j = i
        t = thr_l[i]
        while j < n and thr_l[j] == t:
            j += 1
        # 1) cull against strictly-faster accepted points
        survivors = []
        for p in range(i, j):
            a, e = area_l[p], energy_l[p]
            s = bisect_right(stair_a, a)
            if s > 0 and stair_e[s - 1] <= e:
                continue                      # dominated by a faster point
            survivors.append(p)
        # 2) within-group dominance (equal throughput; needs strictness).
        # survivors are sorted by (area, energy) thanks to the lexsort.
        best_e_smaller_area = INF             # min energy over area < cur
        cur_area, cur_min_e = None, INF       # min energy within area == cur
        kept_group: List[Tuple[float, float]] = []
        for p in survivors:
            a, e = area_l[p], energy_l[p]
            if a != cur_area:
                best_e_smaller_area = min(best_e_smaller_area, cur_min_e)
                cur_area, cur_min_e = a, INF
            if not (best_e_smaller_area <= e or cur_min_e < e):
                keep.append(order_l[p])
                kept_group.append((a, e))
            cur_min_e = min(cur_min_e, e)
        # 3) fold the group's minimal (area, energy) pairs into the staircase
        for a, e in kept_group:
            s = bisect_right(stair_a, a)
            if s > 0 and stair_e[s - 1] <= e:
                continue                      # already covered
            stair_a.insert(s, a)
            stair_e.insert(s, e)
            k = s + 1
            while k < len(stair_a) and stair_e[k] >= e:
                k += 1
            del stair_a[s + 1:k]
            del stair_e[s + 1:k]
        i = j
    keep.sort()
    return np.asarray(keep, dtype=np.int64)


def pareto_front_bruteforce(points: Sequence[DesignPoint]) -> List[DesignPoint]:
    """O(N^2) reference implementation (kept for verification/tests)."""
    front: List[DesignPoint] = []
    for p in points:
        dominated = False
        for q in points:
            if q is p:
                continue
            if (q.throughput >= p.throughput and q.area <= p.area
                    and q.energy_per_unit <= p.energy_per_unit
                    and (q.throughput > p.throughput or q.area < p.area
                         or q.energy_per_unit < p.energy_per_unit)):
                dominated = True
                break
        if not dominated:
            front.append(p)
    return front


def pareto_front(points: Sequence[DesignPoint]) -> List[DesignPoint]:
    """Maximize throughput, minimize area & energy — O(N log N)."""
    pts = list(points)
    idx = pareto_front_indices(
        np.asarray([p.throughput for p in pts]),
        np.asarray([p.area for p in pts]),
        np.asarray([p.energy_per_unit for p in pts]))
    return [pts[i] for i in idx]


# ---------------------------------------------------------------------------
# Batched grid sweep
# ---------------------------------------------------------------------------


class _SweepIndexing:
    """Index machinery shared by the one-shot and chunked sweep results.

    Both carry the ordered ``axes`` (name, values) and the grid ``shape``;
    flat point indices are C-ordered over ``shape``, so any flat index —
    whether its objectives are stored densely (:class:`SweepResult`) or
    only for tracked survivors (a chunked sweep, not ported yet) — maps back
    to concrete axis values, per-island rate vectors and
    :class:`DesignPoint` objects the same way.  Subclasses provide
    ``axes``/``shape``/``workloads``/``n_tg`` plus
    :meth:`objective_values`.
    """

    @property
    def independent_islands(self) -> bool:
        """True when each accelerator island swept its own rate axis."""
        return all(name != "f_acc" for name, _ in self.axes)

    def axis_values(self, i: int) -> Dict[str, object]:
        """Swept axis values of flat point ``i`` as {axis_name: value}."""
        coords = np.unravel_index(i, self.shape)
        return {name: values[c]
                for (name, values), c in zip(self.axes, coords)}

    def _accel_rate(self, av: Dict[str, object], wl_name: str) -> float:
        key = f"f_acc:{wl_name}"
        return float(av[key] if key in av else av["f_acc"])

    def island_rates(self, i: int) -> Dict[str, float]:
        """Per-island rate vector of flat point ``i``: one entry per
        accelerator island (keyed by workload/tile name, the island naming
        ``repro_torch.sim.SimPlatform.build`` uses) plus the shared ``noc_mem``
        island.  In shared mode every accelerator entry is the one swept
        ``f_acc``; the TG rate is an axis value (``axis_values``), not an
        island."""
        av = self.axis_values(i)
        out = {wl.name: self._accel_rate(av, wl.name)
               for wl in self.workloads}
        out["noc_mem"] = float(av["f_noc"])
        return out

    def design_point(self, i: int) -> DesignPoint:
        """Materialize one flat index as a :class:`DesignPoint`."""
        av = self.axis_values(i)
        replication = {wl.name: int(av[f"K:{wl.name}"])
                       for wl in self.workloads}
        placement = {wl.name: tuple(av[f"pos:{wl.name}"])
                     for wl in self.workloads}
        if self.independent_islands:
            rates = {wl.name: self._accel_rate(av, wl.name)
                     for wl in self.workloads}
        else:
            rates = {"acc": float(av["f_acc"])}
        rates["noc_mem"] = float(av["f_noc"])
        rates["tg"] = float(av["f_tg"])
        thr, area, energy = self._point_objectives(i)
        tech = av.get("tech")
        return DesignPoint(
            replication=replication, rates=rates, placement=placement,
            throughput=thr, area=area, energy_per_unit=energy,
            tech=None if tech is None else (int(tech[0]), str(tech[1])))

    def _point_objectives(self, i: int) -> Tuple[float, float, float]:
        return tuple(
            float(self.objective_values(name, np.asarray([i]))[0])
            for name in ("throughput", "area", "energy_per_unit"))

    def design_points(self, indices: Iterable[int]) -> List[DesignPoint]:
        return [self.design_point(int(i)) for i in indices]

    def design_arrays(self, indices) -> Dict[str, np.ndarray]:
        """Vectorized design decode for B flat indices — the batched-sim
        bridge (``repro_torch.sim.BatchSimPlatform.from_design_points``).

        Returns ``k`` (B, A) float64 replication, ``pos`` (B, A, 2) int64
        grid coordinates, ``rates`` (B, A+1) float64 per-island rates in
        ``[*workload names, "noc_mem"]`` order, and ``f_tg`` (B,) float64
        — exactly the floats :meth:`design_point` would produce, without
        materializing B DesignPoints.
        """
        idx = np.asarray(indices, dtype=np.int64)
        coords = dict(zip((n for n, _ in self.axes),
                          np.unravel_index(idx, self.shape)))
        vals = {n: np.asarray(v) for n, v in self.axes}

        def axis(name):
            return vals[name][coords[name]]

        k = np.stack([axis(f"K:{wl.name}").astype(np.float64)
                      for wl in self.workloads], axis=-1)
        pos = np.stack([axis(f"pos:{wl.name}") for wl in self.workloads],
                       axis=-2).astype(np.int64)
        fa_cols = [axis(f"f_acc:{wl.name}"
                        if self.independent_islands else "f_acc")
                   for wl in self.workloads]
        rates = np.stack(fa_cols + [axis("f_noc")], axis=-1).astype(
            np.float64)
        return {"k": k, "pos": pos, "rates": rates,
                "f_tg": axis("f_tg").astype(np.float64)}


def _topk_select(key: np.ndarray, indices: np.ndarray, k: int) -> np.ndarray:
    """Positions of the k smallest ``key`` entries, ordered — and, at the
    k-th-value boundary, *selected* — by (key, global index).

    argpartition alone picks arbitrarily among boundary ties, which would
    make one-shot and chunked sweeps disagree on tie-heavy objectives
    (area has a handful of distinct values); widening the partition to
    every entry tied with the k-th value and resolving by flat index makes
    the selection deterministic and chunking-invariant."""
    n = key.shape[0]
    k = min(k, n)
    if k == 0:
        return np.empty(0, dtype=np.int64)
    if k < n:
        part = np.argpartition(key, k - 1)[:k]
        cand = np.nonzero(key <= key[part].max())[0]
    else:
        cand = np.arange(n)
    order = np.lexsort((indices[cand], key[cand]))[:k]
    return cand[order]


@dataclass(eq=False)
class SweepResult(_SweepIndexing):
    """Objective arrays for a full cross-product sweep, plus lazy
    :class:`DesignPoint` materialization.

    ``axes`` is the ordered list of (name, values) swept dimensions; flat
    arrays are C-ordered over ``shape``, so axis values for point ``i`` are
    recovered with ``np.unravel_index`` — no per-point objects exist until
    :meth:`design_point` is called for a survivor.
    """
    axes: Tuple[Tuple[str, Tuple], ...]
    shape: Tuple[int, ...]
    workloads: Tuple[AccelWorkload, ...]
    n_tg: int
    throughput: np.ndarray              # (N,) float64, total across accels
    area: np.ndarray                    # (N,) float64
    energy_per_unit: np.ndarray         # (N,) float64
    valid: np.ndarray                   # (N,) bool (placement collisions out)
    mem_traffic: Optional[np.ndarray] = None   # (N,) float64, Fig.-4 model
    elapsed_s: float = 0.0
    backend: str = "numpy"

    def __len__(self) -> int:
        return int(self.throughput.shape[0])

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())

    @property
    def points_per_second(self) -> float:
        return len(self) / self.elapsed_s if self.elapsed_s > 0 else float("inf")

    def objective_values(self, objective: str, indices) -> np.ndarray:
        """Objective array values at flat ``indices`` (dense lookup)."""
        return getattr(self, objective)[np.asarray(indices, dtype=np.int64)]

    def pareto_indices(self) -> np.ndarray:
        """Flat indices of the (valid-only) Pareto front, O(N log N)."""
        flat = np.nonzero(self.valid)[0]
        sub = pareto_front_indices(self.throughput[flat], self.area[flat],
                                   self.energy_per_unit[flat])
        return flat[sub]

    def topk_indices(self, k: int, objective: str = "throughput",
                     maximize: Optional[bool] = None) -> np.ndarray:
        """Flat indices of the k best valid points on one objective,
        best-first, via argpartition (no full sort, no DesignPoints).
        Exact ties order by ascending flat index (the same deterministic
        tie-break the chunked sweep's running top-k merge uses)."""
        vals = getattr(self, objective)
        if maximize is None:
            maximize = objective == "throughput"
        flat = np.nonzero(self.valid)[0]
        v = vals[flat]
        key = -v if maximize else v
        return flat[_topk_select(key, flat, k)]


def _axis(values, dim: int, ndim: int) -> np.ndarray:
    """Reshape a 1-D axis to broadcast at dimension ``dim`` of ``ndim``."""
    a = np.asarray(values)
    shape = [1] * ndim
    shape[dim] = a.shape[0]
    return a.reshape(shape)


@dataclass(frozen=True)
class _AxisLayout:
    """Dimension layout of one sweep: per-accel K axes, ``f_noc``, the
    shared or per-accel ``f_acc`` axes, ``f_tg``, per-accel pos axes,
    plus an optional trailing combined ``tech`` axis (node, variant)."""
    A: int
    independent: bool
    tech: bool = False

    @property
    def R(self) -> int:
        return self.A if self.independent else 1

    @property
    def ndim(self) -> int:
        return 2 * self.A + self.R + 2 + (1 if self.tech else 0)

    @property
    def tdim(self) -> int:
        assert self.tech, "no tech axis in this sweep"
        return 2 * self.A + self.R + 2

    def k(self, a: int) -> int:
        return a

    @property
    def fnoc(self) -> int:
        return self.A

    def fa(self, a: int) -> int:
        return self.A + 1 + (a if self.independent else 0)

    @property
    def ftg(self) -> int:
        return self.A + 1 + self.R

    def pos(self, a: int) -> int:
        return self.A + 2 + self.R + a


def _eval_grid(model: SoCPerfModel, workloads, n_tg: int,
               lay: _AxisLayout, vals: Dict[str, object], get,
               shape: Tuple[int, ...]) -> Dict[str, np.ndarray]:
    """Evaluate every objective over one (sub-)grid.

    ``get(dim, values)`` returns the broadcastable array of an axis for
    this block; the arithmetic is purely elementwise + fixed-order accel
    loops, so any blocking of the grid produces bit-identical floats —
    the chunked sweep's correctness contract.  The energy model routes the
    shared-rate case through the *same* per-accel op sequence as the
    independent case (sum over accel islands in order, then /A), which is
    what makes all-islands-equal independent points reproduce the shared
    sweep bit for bit.
    """
    A = lay.A
    k_ax = [get(lay.k(a), vals["k"]) for a in range(A)]
    fn_ax = get(lay.fnoc, vals["noc"])
    fa_ax = [get(lay.fa(a), vals["acc"][a]) for a in range(A)]
    ft_ax = get(lay.ftg, vals["tg"])
    pos_ax = [get(lay.pos(a), vals["pos"]) for a in range(A)]

    total_thr = np.zeros(shape, dtype=np.float64)
    for a, wl in enumerate(workloads):
        thr = model.accel_throughput_batch(
            base_mbps=wl.base_mbps, wire_share=wl.wire_share, k=k_ax[a],
            f_acc=fa_ax[a], f_noc=fn_ax, f_tg=ft_ax, n_tg=n_tg,
            pos_idx=pos_ax[a])
        total_thr = total_thr + np.broadcast_to(thr, shape)

    area = np.zeros(shape, dtype=np.float64)
    for a in range(A):
        area = area + get(lay.k(a), vals["area"])

    # mean accelerator-island power (summed in accel order, then /A) +
    # the NoC share — one op sequence for both island_rates modes
    if lay.tech:
        # physical V^2 f model: per-tech-axis (p_scale, v0, v1) coefficients
        ps = get(lay.tdim, vals["tech_ps"])
        v0 = get(lay.tdim, vals["tech_v0"])
        v1 = get(lay.tdim, vals["tech_v1"])
        pw = chip_power_coeffs(fa_ax[0], 1.0, v0, v1, ps)
        for f in fa_ax[1:]:
            pw = pw + chip_power_coeffs(f, 1.0, v0, v1, ps)
        power = pw / float(A) \
            + NOC_POWER_SHARE * chip_power_coeffs(fn_ax, 1.0, v0, v1, ps)
    else:
        pw = chip_power(fa_ax[0], busy=1.0)
        for f in fa_ax[1:]:
            pw = pw + chip_power(f, busy=1.0)
        power = pw / float(A) + NOC_POWER_SHARE * chip_power(fn_ax, busy=1.0)
    energy = np.broadcast_to(power, shape) / np.maximum(total_thr, 1e-9)

    # Fig.-4 memory-pressure objective: offered MEM traffic at each rate
    # point (placement-independent, so it broadcasts over the K/pos axes)
    mem_traffic = np.broadcast_to(
        model.memory_traffic_batch(f_acc_per_accel=fa_ax, f_noc=fn_ax,
                                   f_tg=ft_ax, n_tg=n_tg), shape)

    valid = np.ones(shape, dtype=bool)
    for a in range(A):
        for b in range(a + 1, A):
            valid &= pos_ax[a] != pos_ax[b]

    return {"throughput": total_thr,
            "area": np.ascontiguousarray(np.broadcast_to(area, shape)),
            "energy_per_unit": energy,
            "mem_traffic": np.ascontiguousarray(mem_traffic),
            "valid": valid}


def _eval_flat_points(model: SoCPerfModel, workloads, n_tg: int,
                      lay: _AxisLayout, vals: Dict[str, object],
                      shape: Tuple[int, ...], lo: int, hi: int, *,
                      device, dtype: torch.dtype = torch.float64
                      ) -> Dict[str, np.ndarray]:
    """Evaluate global flat points ``[lo, hi)`` as flat (P,) tensors on
    ``device`` and return the objective arrays on the host.

    Everything per point runs on the device: the C-order coordinate decode
    (integer floor-divide / remainder, last axis fastest — what
    ``np.unravel_index`` computes), the axis-value gathers, the hop-count
    lookup, the float objective math (the same fixed-order accel loop as
    :func:`_eval_grid`, through the shared formulas of ``core/perfmodel.py``),
    the area sum (float64, accel order) and the placement-validity mask.
    With ``dtype=torch.float64`` the floats agree with the host NumPy path to
    the last bits (elementwise IEEE ops in the same order).
    """
    dev = torch.device(device)
    A = lay.A
    i64 = torch.int64

    def table(v, dt=dtype):
        return torch.as_tensor(np.asarray(v), dtype=dt, device=dev)

    # flat index -> per-axis coordinates, last axis fastest
    rem = torch.arange(lo, hi, dtype=i64, device=dev)
    coords: List[Optional[torch.Tensor]] = [None] * len(shape)
    for dim in range(len(shape) - 1, -1, -1):
        n = int(shape[dim])
        coords[dim] = rem % n
        rem = torch.div(rem, n, rounding_mode="floor")

    k_tab = table(vals["k"])
    pos_tab = table(vals["pos"], i64)
    hop_tab = table(model.hop_counts(
        pos_idx=np.arange(model.noc.rows * model.noc.cols)))
    kA = [k_tab[coords[lay.k(a)]] for a in range(A)]
    faA = [table(vals["acc"][a])[coords[lay.fa(a)]] for a in range(A)]
    posA = [pos_tab[coords[lay.pos(a)]] for a in range(A)]
    hopA = [hop_tab[posA[a]] for a in range(A)]
    f_noc = table(vals["noc"])[coords[lay.fnoc]]
    f_tg = table(vals["tg"])[coords[lay.ftg]]

    consts = model._service_consts()
    thr = torch.zeros_like(f_noc)
    for a, wl in enumerate(workloads):
        thr = thr + _throughput_math(
            TORCH_NS, float(wl.base_mbps), float(wl.wire_share), kA[a],
            faA[a], f_noc, f_tg, n_tg, hopA[a], **consts)
    mem = _memory_traffic_math_per_accel(
        TORCH_NS, faA, f_noc, f_tg, n_tg, mem_service=model.mem_service,
        tg_demand_fig4=model.tg_demand_fig4)
    if lay.tech:
        tc = coords[lay.tdim]
        ps, v0, v1 = (table(vals[n])[tc]
                      for n in ("tech_ps", "tech_v0", "tech_v1"))
        pw = chip_power_coeffs(faA[0], 1.0, v0, v1, ps)
        for a in range(1, A):
            pw = pw + chip_power_coeffs(faA[a], 1.0, v0, v1, ps)
        power = pw / float(A) \
            + NOC_POWER_SHARE * chip_power_coeffs(f_noc, 1.0, v0, v1, ps)
    else:
        pw = chip_power(faA[0], busy=1.0)
        for a in range(1, A):
            pw = pw + chip_power(faA[a], busy=1.0)
        power = pw / float(A) + NOC_POWER_SHARE * chip_power(f_noc, busy=1.0)
    energy = power / torch.clamp(thr, min=1e-9)

    area_tab = table(vals["area"], torch.float64)
    area = torch.zeros(hi - lo, dtype=torch.float64, device=dev)
    for a in range(A):
        area = area + area_tab[coords[lay.k(a)]]
    valid = torch.ones(hi - lo, dtype=torch.bool, device=dev)
    for a in range(A):
        for b in range(a + 1, A):
            valid &= posA[a] != posA[b]

    floats = torch.stack([thr.to(torch.float64), energy.to(torch.float64),
                          mem.to(torch.float64), area]).cpu().numpy()
    return {"throughput": np.ascontiguousarray(floats[0]),
            "area": np.ascontiguousarray(floats[3]),
            "energy_per_unit": np.ascontiguousarray(floats[1]),
            "mem_traffic": np.ascontiguousarray(floats[2]),
            "valid": valid.cpu().numpy()}


def _prepare_axes(model, workloads, ks, acc_rates, noc_rates, tg_rates,
                  positions, island_rates, tech_node=None,
                  tech_variant=None):
    """Axis bookkeeping shared by the one-shot and chunked paths."""
    assert island_rates in ("shared", "independent"), island_rates
    independent = island_rates == "independent"

    # tech_node / tech_variant combine into ONE trailing "tech" axis whose
    # values are (node, variant) pairs — the cross product of both inputs —
    # so the 1-D axis broadcast/chunk machinery applies unchanged
    techs: Tuple[Tuple[int, str], ...] = ()
    if tech_node is not None or tech_variant is not None:
        nodes = 45 if tech_node is None else tech_node
        if isinstance(nodes, (int, np.integer)):
            nodes = (nodes,)
        variants = "itrs" if tech_variant is None else tech_variant
        if isinstance(variants, str):
            variants = (variants,)
        techs = tuple((int(n), str(v)) for n in nodes for v in variants)
    if positions is None:
        positions = [(r, c) for r in range(model.noc.rows)
                     for c in range(model.noc.cols)
                     if (r, c) != model.mem_pos]
    positions = [tuple(p) for p in positions]
    pos_idx = np.asarray([pos_index(model.noc, p) for p in positions])

    if isinstance(acc_rates, dict):
        assert independent, "per-accel acc_rates ladders require " \
            "island_rates='independent'"
        acc_by_wl = [tuple(float(f) for f in acc_rates[wl.name])
                     for wl in workloads]
    else:
        acc_by_wl = [tuple(float(f) for f in acc_rates)] * len(workloads)

    A = len(workloads)
    lay = _AxisLayout(A=A, independent=independent, tech=bool(techs))
    axes: List[Tuple[str, Tuple]] = []
    for wl in workloads:
        axes.append((f"K:{wl.name}", tuple(int(k) for k in ks)))
    axes.append(("f_noc", tuple(float(f) for f in noc_rates)))
    if independent:
        for a, wl in enumerate(workloads):
            axes.append((f"f_acc:{wl.name}", acc_by_wl[a]))
    else:
        axes.append(("f_acc", acc_by_wl[0]))
    axes.append(("f_tg", tuple(float(f) for f in tg_rates)))
    for wl in workloads:
        axes.append((f"pos:{wl.name}", tuple(positions)))
    if techs:
        axes.append(("tech", techs))

    area_by_k = {int(k): replication_area_model(
        weight_bytes=1.0, act_bytes=0.5, k=int(k))["total_bytes_per_dev"]
        for k in ks}
    vals = {
        "k": np.asarray([float(k) for k in ks]),
        "area": np.asarray([area_by_k[int(k)] for k in ks]),
        "noc": np.asarray([float(f) for f in noc_rates]),
        "tg": np.asarray([float(f) for f in tg_rates]),
        "acc": [np.asarray(r) for r in acc_by_wl],
        "pos": pos_idx,
    }
    if techs:
        vals.update(tech_axis_coeffs(techs))
    return lay, tuple(axes), vals


def grid_sweep(model: SoCPerfModel,
               workloads,
               *,
               ks: Sequence[int] = (1, 2, 4),
               acc_rates=(0.2, 0.6, 1.0),
               noc_rates: Sequence[float] = (0.1, 0.5, 1.0),
               tg_rates: Sequence[float] = (1.0,),
               positions: Optional[Sequence[Tuple[int, int]]] = None,
               n_tg: int = 0,
               backend: Optional[str] = None,
               island_rates: str = "shared",
               chunk_points: Optional[int] = None,
               topk_track: int = 64,
               devices=None,
               tech_node=None,
               tech_variant=None,
               device=None,
               dtype: torch.dtype = torch.float64):
    """Batched cross-product sweep over the paper's design axes.

    ``workloads`` is one :class:`AccelWorkload` or a sequence for a *joint*
    multi-accelerator sweep (each accelerator gets its own K axis and its
    own placement axis).  The swept dimensions, in axis order, are::

        island_rates="shared":       K:<wl> | f_noc | f_acc        | f_tg | pos:<wl>
        island_rates="independent":  K:<wl> | f_noc | f_acc:<wl>.. | f_tg | pos:<wl>

    **Per-island rates** (the paper's C2): with
    ``island_rates="independent"`` every accelerator island sweeps its own
    rate ladder — one ``f_acc:<wl>`` axis per accelerator — instead of the
    one shared ``f_acc`` axis; ``acc_rates`` may then also be a
    ``{workload name: ladder}`` mapping for heterogeneous ladders.
    Restricted to all-islands-equal rates the independent sweep reproduces
    the shared sweep bit for bit (tested).

    ``positions`` defaults to every grid node except the MEM tile.  Joint
    placements where two accelerators collide are masked invalid (their
    objective entries are still computed — the arrays stay rectangular —
    but :meth:`SweepResult.pareto_indices` / ``topk_indices`` skip them).

    Throughput of a joint point is the sum of the accelerators' modeled
    throughputs; area sums each accelerator's replication cost; energy is
    the mean accelerator-island chip power (each island at its own rate)
    plus the NoC share, per unit of total throughput; ``mem_traffic`` sums
    each accelerator's offered MEM stream at its own island rate.

    **Where it runs**: ``device=None`` is the CUDA card (an error without
    one); ``device="cpu"`` the host.  ``backend=None`` picks ``"numpy"`` on
    the CPU — the float64 broadcast-axes evaluation, bit for bit the
    reference package's sweep — and ``"torch"`` on a CUDA device — the flat
    point axis evaluated on the card in ``dtype`` (float64 by default;
    ``torch.float32`` optional), objectives brought back for the host-side
    float64 Pareto / top-k.  ``backend="torch"`` with ``device="cpu"`` runs
    the flat evaluator on CPU tensors (what the tests compare).

    **Physical DVFS** (``tech_node=`` / ``tech_variant=``): passing a node
    (int or sequence from :data:`repro_torch.core.voltage.TECH_NODES`)
    and/or a scaling variant (``"itrs"``/``"cons"`` or a sequence) appends
    one trailing ``tech`` axis — the (node, variant) cross product — and
    switches the energy objective from the linear voltage proxy to the
    physical ``power_scl * (P_static + P_dyn f V̂(f)^2)`` model.
    ``tech_node=None`` (the default) keeps the linear model bit for bit.

    Not ported yet: ``chunk_points=`` streaming evaluation (refused when the
    grid exceeds it; ``topk_track`` belongs to it) and ``devices=`` beyond
    one device.
    """
    device_mod.require_single(devices)
    dev = device_mod.resolve(device)
    if backend is None:
        backend = "numpy" if dev.type == "cpu" else "torch"
    if backend not in ("numpy", "torch"):
        raise ValueError(f"backend must be 'numpy' or 'torch', got "
                         f"{backend!r}")
    if backend == "numpy" and dev.type != "cpu":
        raise ValueError("backend='numpy' evaluates on the host; pass "
                         "device='cpu' with it")
    if isinstance(workloads, AccelWorkload):
        workloads = (workloads,)
    workloads = tuple(workloads)
    lay, axes, vals = _prepare_axes(model, workloads, ks, acc_rates,
                                    noc_rates, tg_rates, positions,
                                    island_rates, tech_node=tech_node,
                                    tech_variant=tech_variant)
    ndim = lay.ndim
    shape = tuple(len(v) for _, v in axes)
    n_points = int(np.prod([len(v) for _, v in axes], dtype=np.int64))
    if chunk_points is not None and n_points > chunk_points:
        raise NotImplementedError(
            f"chunk_points={chunk_points} < {n_points} grid points: the "
            "chunked streaming sweep is not ported yet (ROADMAP queue A "
            "item 3)")

    t0 = time.perf_counter()
    if backend == "torch":
        out = _eval_flat_points(model, workloads, n_tg, lay, vals, shape,
                                0, n_points, device=dev, dtype=dtype)
    else:
        get = lambda dim, v: _axis(v, dim, ndim)    # noqa: E731
        out = _eval_grid(model, workloads, n_tg, lay, vals, get, shape)
    elapsed = time.perf_counter() - t0
    return SweepResult(
        axes=axes, shape=shape, workloads=workloads, n_tg=n_tg,
        throughput=out["throughput"].ravel(),
        area=out["area"].ravel(),
        energy_per_unit=out["energy_per_unit"].ravel(),
        valid=out["valid"].ravel(),
        mem_traffic=out["mem_traffic"].ravel(),
        elapsed_s=elapsed, backend=backend)


# ---------------------------------------------------------------------------
# Closed-loop re-ranking: the static sweep meets the runtime simulator
# ---------------------------------------------------------------------------


@dataclass
class ClosedLoopScore:
    """Simulated runtime scores for a set of sweep survivors.

    ``indices`` are flat :class:`SweepResult` indices; the parallel arrays
    hold each point's simulated p99 latency, energy per request and
    sustained throughput under the replayed trace.  ``order`` re-ranks
    ``indices`` best-first: points meeting the p99 SLA sorted by energy
    per request, then SLA violators by how badly they miss it.

    ``results`` holds the single ``sim.BatchSimResult`` of the one stacked
    replay (the per-point sequential path of the reference is not ported).

    ``counters`` (only when ``observe=`` enabled the monitoring plane) is
    one ``sim.CounterPlane.summary()`` dict per survivor — utilization,
    stall fraction, NoC flits, per-island energy — aligned with
    ``indices``.
    """
    indices: np.ndarray                 # (M,) int64
    p99_latency_s: np.ndarray           # (M,) float64
    energy_per_request_j: np.ndarray    # (M,) float64
    throughput_rps: np.ndarray          # (M,) float64
    order: np.ndarray                   # (M,) int64 positions into indices
    results: List[object]               # one BatchSimResult
    drop_rate: Optional[np.ndarray] = None   # (M,) under a fault schedule
    counters: Optional[List[Dict[str, float]]] = None   # (M,) summaries

    def ranked_indices(self) -> np.ndarray:
        """Flat SweepResult indices, best-first."""
        return self.indices[self.order]


def _rank_scores(p99: np.ndarray, ept: np.ndarray,
                 p99_sla_s: Optional[float],
                 drop_rate: Optional[np.ndarray] = None,
                 max_drop_rate: Optional[float] = None) -> np.ndarray:
    """Best-first order: SLO-miss severity (p99 miss + drop-budget miss),
    then energy.  Without SLO bounds the legacy (energy, p99) order is
    unchanged; ``drop_rate`` only participates when given (fault-aware
    scoring), so fault-free rankings are untouched.

    Degenerate survivors — zero-completion runs reporting NaN energy per
    request and/or NaN p99 — always rank last via an explicit mask (their
    NaN channels carry no information, and ``np.lexsort``'s NaN placement
    in non-primary keys is not a contract we want to lean on)."""
    p99 = np.asarray(p99, dtype=np.float64)
    ept = np.asarray(ept, dtype=np.float64)
    degenerate = np.isnan(p99) | np.isnan(ept)
    p99 = np.where(degenerate, np.inf, p99)
    ept = np.where(degenerate, np.inf, ept)
    if p99_sla_s is not None or max_drop_rate is not None:
        miss = np.zeros_like(ept)
        if p99_sla_s is not None:
            miss = miss + np.maximum(0.0, p99 / p99_sla_s - 1.0)
        if max_drop_rate is not None and drop_rate is not None:
            miss = miss + np.maximum(0.0, drop_rate / max_drop_rate - 1.0)
        return np.lexsort((ept, miss, degenerate))   # SLO first, then energy
    if drop_rate is not None:
        # fault-aware but unbudgeted: robustness outranks energy
        return np.lexsort((ept, p99, drop_rate, degenerate))
    return np.lexsort((p99, ept, degenerate))  # energy first, p99 tie-break


def closed_loop_score(result: SweepResult, trace, *,
                      model: SoCPerfModel,
                      indices: Optional[Sequence[int]] = None,
                      top: int = 8,
                      p99_sla_s: Optional[float] = None,
                      controller_factory=None,
                      batch_controller_factory=None,
                      req_mb: float = 0.1,
                      sim_config=None,
                      batch: Optional[bool] = None,
                      backend: str = "torch",
                      trace_seed: int = 0,
                      flows=None,
                      balancer_factory=None,
                      fault_schedule=None,
                      slo=None,
                      max_drop_rate: Optional[float] = None,
                      observe=None,
                      devices=None,
                      tech=None,
                      device=None
                      ) -> ClosedLoopScore:
    """Re-rank static-sweep survivors by *simulated* runtime behaviour.

    The static objectives of :func:`grid_sweep` assume steady saturated
    streams; under dynamic traffic two points with equal static throughput
    can have wildly different tail latency and idle-power profiles.  This
    bridge replays ``trace`` (a ``repro_torch.sim.Trace`` whose destinations
    map 1:1 to ``result.workloads``) through each survivor — by default the
    ``top`` throughput points of the Pareto front — with an optional online
    DFS controller in the loop, and ranks by (p99 SLA met, energy per
    request).  The static sweep and the runtime loop become one pipeline::

        res   = grid_sweep(model, wls, ...)
        score = closed_loop_score(res, diurnal_trace(...), model=model,
                                  p99_sla_s=0.05, backend="fused")
        best  = res.design_point(int(score.ranked_indices()[0]))

    The survivors are stacked into one ``repro_torch.sim.BatchSimPlatform``
    and replayed as a single tensor program on ``device`` (``None`` = the
    CUDA card): ``backend="torch"`` (float64 tick loop, the ground truth) or
    ``"fused"`` (the hand-written CUDA tick kernel) — re-ranking thousands
    of survivors is one batched run.  ``batch_controller_factory`` receives
    the stacked platform and must return a
    ``repro_torch.sim.BatchControllerHarness`` (or None).

    Determinism: ``trace`` may be a callable ``trace(seed) -> Trace``; it
    is invoked with the explicit ``trace_seed``.  ``flows`` (a
    ``repro_torch.sim.FlowPattern``) scores the survivors under a
    tile-to-tile / pipeline workload instead of the default
    accelerator->MEM stream; ``trace`` may also be a
    ``repro_torch.sim.BatchTrace`` whose design axis matches the survivor
    count.  ``tech=`` (a ``TechModel``, a node int, or a ``(node,
    variant)`` pair) replays every survivor under the physical ``V^2 f``
    tick-energy model and clamps DFS commits to the node's legal range.

    Not ported yet, accepted for signature parity and refused when set: the
    per-point sequential path (``controller_factory=`` / ``batch=False``),
    ``balancer_factory=``, ``fault_schedule=`` / ``slo=``, ``observe=`` and
    ``devices=`` beyond one device.
    """
    from repro_torch.sim.batch import BatchSimEngine, BatchSimPlatform
    from repro_torch.sim.engine import SimConfig
    from repro_torch.sim.traffic import BatchTrace

    if controller_factory is not None or batch is False:
        raise NotImplementedError(
            "the per-point sequential scoring path (controller_factory= / "
            "batch=False) is not ported yet (ROADMAP queue A item 4)")
    if balancer_factory is not None:
        raise NotImplementedError(
            "load balancer: balancer_factory= not ported yet (ROADMAP "
            "queue A item 7)")
    device_mod.require_single(devices)
    tech = TechModel.coerce(tech)
    if callable(trace):
        trace = trace(trace_seed)

    if indices is None:
        pf = result.pareto_indices()
        thr_pf = result.objective_values("throughput", pf)
        ordr = np.argsort(-thr_pf, kind="stable")
        indices = pf[ordr][:top]
    indices = np.asarray(indices, dtype=np.int64)
    if isinstance(trace, BatchTrace):
        # each survivor replays its own tensor row — a silent mismatch
        # would pair survivor j with the wrong workload
        assert trace.n_designs == indices.shape[0], \
            (trace.n_designs, indices.shape[0])

    platform = BatchSimPlatform.from_design_points(
        model, result, indices, req_mb=req_mb, n_tg=result.n_tg,
        flows=flows)
    controller = (batch_controller_factory(platform)
                  if batch_controller_factory is not None else None)
    engine = BatchSimEngine(platform, config=sim_config or SimConfig(),
                            controller=controller, backend=backend,
                            faults=fault_schedule, slo=slo, observe=observe,
                            devices=devices, tech=tech, device=device)
    r = engine.run(trace)
    order = _rank_scores(r.p99_latency_s, r.energy_per_request_j, p99_sla_s,
                         drop_rate=None, max_drop_rate=max_drop_rate)
    return ClosedLoopScore(indices=indices, p99_latency_s=r.p99_latency_s,
                           energy_per_request_j=r.energy_per_request_j,
                           throughput_rps=r.throughput_rps,
                           order=np.asarray(order, dtype=np.int64),
                           results=[r], drop_rate=None, counters=None)
