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
front / top-k).  With ``chunk_points=`` a grid larger than the chunk streams
through fixed-size blocks with a running Pareto / top-k merge and comes back
as a :class:`ChunkedSweepResult`.

Where it runs.  With ``device="cpu"`` the grid is evaluated on the host in
NumPy float64 as broadcast axes (:func:`_eval_grid`) — bit for bit the
reference package's sweep, and the port's ground truth.  On a CUDA device the
flat point axis lives on the card (:func:`_eval_flat_points_t`): the
coordinate decode (``unravel_index`` with integer ops), the axis gathers, the
throughput / energy / memory-traffic formulas (float64 by default), the area
sum and the placement mask all run there, and so does the Pareto prefilter
(:func:`_front_prefilter`) and, on the chunked path, each block's top-k; only
candidates and survivors come back for the exact front and the merges, which
stay NumPy float64 on the host.

:func:`closed_loop_score` re-ranks survivors by *simulated* runtime behaviour
through the batched co-simulation engine (``sim/batch.py``).

The Pareto front is sort-based O(N log N) (:func:`pareto_front_indices`)
behind a vectorized superset prefilter; the O(N^2) brute force survives as
:func:`pareto_front_bruteforce` for verification, and :func:`sweep_soc` is
the scalar per-point reference sweep.  The per-point sequential scoring path
of the reference package is not ported yet.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from bisect import bisect_right
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.noc import pos_index
from repro_torch.core.perfmodel import (AccelWorkload, NOC_POWER_SHARE,
                                        SoCPerfModel, TORCH_NS, chip_power,
                                        chip_power_coeffs,
                                        _memory_traffic_math_per_accel,
                                        _throughput_math)
from repro_torch.core.replication import (replication_area_model,
                                          replication_throughput_model)
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


# The few array operations the prefilter needs, over NumPy arrays and over
# torch tensors (wherever they live): one formula, two namespaces.
_NP_SORT = SimpleNamespace(
    unique=lambda a: np.unique(a).tolist(),
    arange=lambda n, like: np.arange(n),
    flatnonzero=np.flatnonzero,
    argsort_stable=lambda a: np.argsort(a, kind="stable"),
    cummin=np.minimum.accumulate,
    concatenate=np.concatenate)
_TORCH_SORT = SimpleNamespace(
    unique=lambda a: torch.unique(a).tolist(),
    arange=lambda n, like: torch.arange(n, device=like.device),
    flatnonzero=lambda m: torch.nonzero(m).flatten(),
    argsort_stable=lambda a: torch.sort(a, stable=True).indices,
    cummin=lambda a: torch.cummin(a, 0).values,
    concatenate=torch.cat)


def _front_prefilter(thr, area, energy, max_classes: int = 1024):
    """Positions of a cheap *superset* of the 3-objective Pareto front.

    Per distinct-area class (area takes one value per K combination — a
    handful), the 2-objective (max throughput, min energy) staircase via
    one lexicographic order + cumulative min; any point dominated there is
    dominated in 3D by the same point (equal area), so the exact — but
    per-point Python — :func:`pareto_front_indices` scan afterwards only
    sees the small candidate set.  Every dominated point is dominated by a
    front point, so the exact scan over the candidates returns the front
    of all points.  Falls back to the identity when area is effectively
    continuous.

    Written once over NumPy arrays and torch tensors: on a CUDA tensor it
    runs on the card.  The order ``lexsort((energy, -thr))`` is two stable
    sorts, by energy and then by ``-thr`` (the same permutation)."""
    xp = _TORCH_SORT if torch.is_tensor(thr) else _NP_SORT
    n = thr.shape[0]
    uniq = xp.unique(area)
    if n == 0 or len(uniq) > max_classes:
        return xp.arange(n, like=thr)
    keep = []
    for av in uniq:
        sel = xp.flatnonzero(area == av)
        o = sel[xp.argsort_stable(energy[sel])]
        o = o[xp.argsort_stable(-thr[o])]
        e = energy[o]
        keep.append(o[e <= xp.cummin(e)])   # over-keeps ties; exact scan next
    return xp.concatenate(keep)


# ---------------------------------------------------------------------------
# Batched grid sweep
# ---------------------------------------------------------------------------


class _SweepIndexing:
    """Index machinery shared by the one-shot and chunked sweep results.

    Both carry the ordered ``axes`` (name, values) and the grid ``shape``;
    flat point indices are C-ordered over ``shape``, so any flat index —
    whether its objectives are stored densely (:class:`SweepResult`) or
    only for tracked survivors (:class:`ChunkedSweepResult`) — maps back
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


# Objectives tracked by the chunked streaming sweep: name -> maximize?
_TRACKED_OBJECTIVES = (("throughput", True), ("area", False),
                       ("energy_per_unit", False), ("mem_traffic", False))
_FLOAT_OBJECTIVES = ("throughput", "area", "energy_per_unit", "mem_traffic")


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


def _topk_select_t(key: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`_topk_select` on the device that holds ``key``, for rows in
    ascending global-index order (a block's valid rows): the k-th smallest
    value bounds the candidates (every entry tied with it stays in), and a
    *stable* sort of the candidates by key orders ties by position, which
    is the (key, global index) order — what ``torch.topk`` alone does not
    promise."""
    n = key.shape[0]
    k = min(k, n)
    if k == 0:
        return torch.empty(0, dtype=torch.int64, device=key.device)
    if k < n:
        kth = torch.topk(key, k, largest=False, sorted=False).values.max()
        cand = torch.nonzero(key <= kth).flatten()
    else:
        cand = torch.arange(n, device=key.device)
    return cand[torch.sort(key[cand], stable=True).indices[:k]]


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
    # flat indices (ascending) of the Pareto prefilter's candidates when
    # grid_sweep ran it where the objectives were evaluated (the card);
    # None: pareto_indices() runs it on the host arrays
    front_candidates: Optional[np.ndarray] = None
    prefilter_s: Optional[float] = None   # its time there, device synced

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
        """Flat indices of the (valid-only) Pareto front, ascending: the
        exact O(N log N) scan over the prefilter's candidates (computed by
        :func:`grid_sweep` on the card, else here), which is exactly the
        scan over every valid point."""
        cand = self.front_candidates
        if cand is None:
            flat = np.nonzero(self.valid)[0]
            cand = flat[np.sort(_front_prefilter(
                self.throughput[flat], self.area[flat],
                self.energy_per_unit[flat]))]
        sub = pareto_front_indices(self.throughput[cand], self.area[cand],
                                   self.energy_per_unit[cand])
        return cand[sub]

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


@dataclass(eq=False)
class ChunkedSweepResult(_SweepIndexing):
    """Survivors of a chunked/streaming :func:`grid_sweep`.

    The full grid (``len(self)`` points, possibly >1e8) was evaluated in
    fixed-size axis blocks and never materialized whole; only the running
    Pareto front and the per-objective top-``topk_track`` survivors are
    retained, with **globally addressable** flat indices — the same
    C-order over ``shape`` a one-shot :class:`SweepResult` uses, so
    :meth:`axis_values` / :meth:`design_point` / downstream consumers
    (``closed_loop_score``, ``BatchSimPlatform.from_design_points``) work
    unchanged.  Objective *values* are only retained for tracked
    survivors: :meth:`objective_values` raises ``KeyError`` for other
    indices, and :meth:`design_point` on an untracked index still decodes
    replication/placement/rates exactly but carries NaN objectives.

    ``peak_chunk_bytes`` counts one block's objective arrays and validity
    mask plus one float64 temporary (~41 bytes per point), on the device
    that evaluated the block: host memory for ``backend="numpy"``, device
    memory for ``"torch"`` (there the coordinate decode's integer
    temporaries come on top and are not counted).
    """
    axes: Tuple[Tuple[str, Tuple], ...]
    shape: Tuple[int, ...]
    workloads: Tuple[AccelWorkload, ...]
    n_tg: int
    n_points: int
    n_valid: int
    cand_indices: np.ndarray            # (M,) int64, sorted ascending
    cand_values: Dict[str, np.ndarray]  # objective -> (M,) float64
    pareto: np.ndarray                  # (F,) int64 global, ascending
    topk: Dict[str, np.ndarray]         # objective -> best-first global idx
    topk_track: int
    chunk_points: int
    n_chunks: int
    peak_chunk_bytes: int
    elapsed_s: float = 0.0
    backend: str = "numpy"

    def __len__(self) -> int:
        return self.n_points

    @property
    def points_per_second(self) -> float:
        return len(self) / self.elapsed_s if self.elapsed_s > 0 else float("inf")

    def objective_values(self, objective: str, indices) -> np.ndarray:
        """Objective values at flat ``indices`` — tracked survivors only."""
        idx = np.atleast_1d(np.asarray(indices, dtype=np.int64))
        pos = np.searchsorted(self.cand_indices, idx)
        ok = (pos < self.cand_indices.shape[0]) \
            & (self.cand_indices[np.minimum(
                pos, self.cand_indices.shape[0] - 1)] == idx)
        if not ok.all():
            raise KeyError(
                f"flat indices {idx[~ok][:5].tolist()} are not tracked "
                "survivors of this chunked sweep (only Pareto/top-k points "
                "retain objective values)")
        return self.cand_values[objective][pos]

    def _point_objectives(self, i: int) -> Tuple[float, float, float]:
        """Tracked survivors report their stored objectives; any other
        (still decodable) index degrades to NaN objectives rather than
        refusing to materialize."""
        try:
            return _SweepIndexing._point_objectives(self, i)
        except KeyError:
            return (float("nan"),) * 3

    def pareto_indices(self) -> np.ndarray:
        """Global flat indices of the full-grid Pareto front (the running
        block merge is exact: front(union) == front(union of block
        fronts)), ascending — identical to the one-shot sweep's."""
        return self.pareto

    def topk_indices(self, k: int, objective: str = "throughput",
                     maximize: Optional[bool] = None) -> np.ndarray:
        """Best-first global indices on one objective, ``k <= topk_track``.
        Identical to the one-shot sweep's (ties broken by flat index)."""
        default = dict(_TRACKED_OBJECTIVES)
        if maximize is None:
            maximize = objective == "throughput"
        if objective not in default or maximize != default[objective]:
            raise KeyError(
                f"chunked sweeps track top-k only for {sorted(default)} in "
                "their default directions")
        if k > self.topk_track:
            raise ValueError(
                f"k={k} exceeds topk_track={self.topk_track} retained by "
                "this chunked sweep; re-run grid_sweep with a larger "
                "topk_track")
        return self.topk[objective][:k]


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


def _eval_flat_points_t(model: SoCPerfModel, workloads, n_tg: int,
                        lay: _AxisLayout, vals: Dict[str, object],
                        shape: Tuple[int, ...], lo: int, hi: int, *,
                        device, dtype: torch.dtype = torch.float64
                        ) -> Dict[str, torch.Tensor]:
    """Evaluate global flat points ``[lo, hi)`` as flat (P,) tensors on
    ``device``: the four float objectives in float64 and the validity mask,
    left on the device.

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

    return {"throughput": thr.to(torch.float64), "area": area,
            "energy_per_unit": energy.to(torch.float64),
            "mem_traffic": mem.to(torch.float64), "valid": valid}


def _to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One copy of the four float objectives (stacked) and one of the mask."""
    floats = torch.stack([out[o] for o in _FLOAT_OBJECTIVES]).cpu().numpy()
    host = {o: np.ascontiguousarray(floats[i])
            for i, o in enumerate(_FLOAT_OBJECTIVES)}
    host["valid"] = out["valid"].cpu().numpy()
    return host


def _eval_flat_points(model: SoCPerfModel, workloads, n_tg: int,
                      lay: _AxisLayout, vals: Dict[str, object],
                      shape: Tuple[int, ...], lo: int, hi: int, *,
                      device, dtype: torch.dtype = torch.float64
                      ) -> Dict[str, np.ndarray]:
    """:func:`_eval_flat_points_t`, objective arrays brought to the host."""
    return _to_host(_eval_flat_points_t(model, workloads, n_tg, lay, vals,
                                        shape, lo, hi, device=device,
                                        dtype=dtype))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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

    **Chunked/streaming evaluation**: when ``chunk_points`` is given and
    the cross-product exceeds it, the grid is evaluated in fixed-size
    axis blocks (whole trailing-axis panels, so every block is a
    contiguous range of global flat indices) with a running Pareto/top-k
    merge, and a :class:`ChunkedSweepResult` is returned — indices stay
    globally addressable and the Pareto front / top-k are those of a
    one-shot sweep.  ``backend="numpy"`` follows the reference package's
    block loop bit for bit.  ``backend="torch"`` evaluates each block with
    the flat evaluator and keeps it on the device, which also computes
    the validity mask, the Pareto prefilter and each tracked objective's
    top-``topk_track``; only those rows are copied to the host, where the
    block's exact front and the running merges run in float64 as in the
    reference.

    Not ported yet: ``devices=`` beyond one device (refused).
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

    t0 = time.perf_counter()
    if chunk_points is None or n_points <= chunk_points:
        cand, pre_s = None, None
        if backend == "torch":
            out_t = _eval_flat_points_t(model, workloads, n_tg, lay, vals,
                                        shape, 0, n_points, device=dev,
                                        dtype=dtype)
            _sync(dev)
            t1 = time.perf_counter()
            cand = _valid_front_candidates(out_t)
            pre_s = time.perf_counter() - t1
            out = _to_host(out_t)
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
            elapsed_s=elapsed, backend=backend,
            front_candidates=cand, prefilter_s=pre_s)

    # ---- chunked/streaming path: fixed-size blocks of whole trailing
    # panels; every block covers the contiguous global flat range
    # [o0*inner, o1*inner) so survivors carry global indices for free
    inner = 1
    s = ndim
    while s > 0 and inner * shape[s - 1] <= chunk_points:
        inner *= shape[s - 1]
        s -= 1
    outer_shape = shape[:s]
    outer_n = int(np.prod(outer_shape, dtype=np.int64)) if s else 1
    o_per_block = max(1, chunk_points // max(inner, 1))

    objs = [name for name, _ in _TRACKED_OBJECTIVES]
    empty = {"i": np.empty(0, dtype=np.int64),
             **{o: np.empty(0, dtype=np.float64) for o in objs}}
    front = dict(empty)
    topk = {o: dict(empty) for o in objs}
    n_valid = 0
    n_chunks = 0
    peak_bytes = 0

    for o0 in range(0, outer_n, o_per_block):
        o1 = min(o0 + o_per_block, outer_n)
        lo, hi = o0 * inner, o1 * inner
        if backend == "torch":
            blk = _block_survivors_t(
                _eval_flat_points_t(model, workloads, n_tg, lay, vals,
                                    shape, lo, hi, device=dev, dtype=dtype),
                lo, topk_track)
        else:
            blk = _block_survivors(model, workloads, n_tg, lay, vals, shape,
                                   s, o0, o1, inner, topk_track)
        n_chunks += 1
        peak_bytes = max(peak_bytes, blk["bytes"])
        n_valid += blk["n_valid"]
        if blk["rows"] is None:
            continue
        rows, pre = blk["rows"], blk["pre"]
        bf = pre[pareto_front_indices(rows["throughput"][pre],
                                      rows["area"][pre],
                                      rows["energy_per_unit"][pre])]
        front = _merge_front(front, {k: v[bf] for k, v in rows.items()})
        for o, maximize in _TRACKED_OBJECTIVES:
            sel = blk["sel"][o]
            cat = {k: np.concatenate([topk[o][k], v[sel]])
                   for k, v in rows.items()}
            ckey = -cat[o] if maximize else cat[o]
            keep = _topk_select(ckey, cat["i"], topk_track)
            topk[o] = {k: v[keep] for k, v in cat.items()}

    # assemble the tracked-survivor store: pareto ∪ top-k, deduped
    pools = [front] + [topk[o] for o in objs]
    all_idx = np.concatenate([p["i"] for p in pools])
    uniq, upos = np.unique(all_idx, return_index=True)
    cand_values = {o: np.concatenate([p[o] for p in pools])[upos]
                   for o in objs}
    _sync(dev)
    elapsed = time.perf_counter() - t0
    return ChunkedSweepResult(
        axes=axes, shape=shape, workloads=workloads, n_tg=n_tg,
        n_points=n_points, n_valid=n_valid,
        cand_indices=uniq, cand_values=cand_values,
        pareto=np.sort(front["i"]),
        topk={o: topk[o]["i"] for o in objs},
        topk_track=topk_track, chunk_points=chunk_points,
        n_chunks=n_chunks, peak_chunk_bytes=int(peak_bytes),
        elapsed_s=elapsed, backend=backend)


def _valid_front_candidates(out: Dict[str, torch.Tensor]) -> np.ndarray:
    """Flat indices (ascending, on the host) of the Pareto prefilter's
    candidates among the valid points of a dense flat evaluation, computed
    on the device that holds it."""
    vpos = torch.nonzero(out["valid"]).flatten()
    pre = _front_prefilter(out["throughput"][vpos], out["area"][vpos],
                           out["energy_per_unit"][vpos])
    return np.sort(vpos[pre].cpu().numpy())


def _block_survivors(model, workloads, n_tg, lay, vals, shape, s, o0, o1,
                     inner, topk_track) -> Dict[str, object]:
    """One block of the NumPy chunked sweep (the reference's loop body up
    to the merges): the block's valid rows, the prefilter's positions in
    them and each tracked objective's top-k positions."""
    ndim = lay.ndim
    O = o1 - o0
    coords = np.unravel_index(np.arange(o0, o1), shape[:s])
    blk_ndim = ndim - s + 1

    def get(dim, v):
        v = np.asarray(v)
        if dim < s:
            return v[coords[dim]].reshape((O,) + (1,) * (ndim - s))
        bshape = [1] * blk_ndim
        bshape[dim - s + 1] = v.shape[0]
        return v.reshape(bshape)

    out = _eval_grid(model, workloads, n_tg, lay, vals, get,
                     (O,) + shape[s:])
    flat = {k: v.ravel() for k, v in out.items()}
    nbytes = (sum(v.nbytes for v in flat.values())
              + flat["throughput"].nbytes)          # + kernel temp
    vpos = np.nonzero(flat["valid"])[0]
    if vpos.size == 0:
        return {"bytes": nbytes, "n_valid": 0, "rows": None}
    rows = {"i": o0 * inner + vpos,
            **{o: flat[o][vpos] for o, _ in _TRACKED_OBJECTIVES}}
    pre = _front_prefilter(rows["throughput"], rows["area"],
                           rows["energy_per_unit"])
    sel = {o: _topk_select(-rows[o] if maximize else rows[o], rows["i"],
                           topk_track)
           for o, maximize in _TRACKED_OBJECTIVES}
    return {"bytes": nbytes, "n_valid": int(vpos.size), "rows": rows,
            "pre": pre, "sel": sel}


def _block_survivors_t(out: Dict[str, torch.Tensor], lo: int,
                       topk_track: int) -> Dict[str, object]:
    """:func:`_block_survivors` for a block evaluated on a device: the
    mask, the prefilter and the top-k selections run there, and only the
    rows they name are copied to the host (``pre`` / ``sel`` then index
    those copied rows)."""
    nbytes = (sum(v.element_size() * v.numel() for v in out.values())
              + out["throughput"].element_size() * out["throughput"].numel())
    vpos = torch.nonzero(out["valid"]).flatten()
    nv = int(vpos.numel())
    if nv == 0:
        return {"bytes": nbytes, "n_valid": 0, "rows": None}
    vals = {o: out[o][vpos] for o in _FLOAT_OBJECTIVES}
    parts = [_front_prefilter(vals["throughput"], vals["area"],
                              vals["energy_per_unit"])]
    for o, maximize in _TRACKED_OBJECTIVES:
        parts.append(_topk_select_t(-vals[o] if maximize else vals[o],
                                    topk_track))
    pos = torch.cat(parts)
    floats = torch.stack([vals[o][pos] for o in _FLOAT_OBJECTIVES]
                         ).cpu().numpy()
    rows = {"i": lo + vpos[pos].cpu().numpy(),
            **{o: np.ascontiguousarray(floats[j])
               for j, o in enumerate(_FLOAT_OBJECTIVES)}}
    bounds = np.cumsum([0] + [int(p.numel()) for p in parts])
    ranges = [np.arange(bounds[j], bounds[j + 1]) for j in range(len(parts))]
    return {"bytes": nbytes, "n_valid": nv, "rows": rows, "pre": ranges[0],
            "sel": {o: r for (o, _), r in zip(_TRACKED_OBJECTIVES,
                                               ranges[1:])}}


def _merge_front(cand: Dict[str, np.ndarray],
                 rows: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold one block's Pareto survivors into the running front."""
    merged = {k: np.concatenate([cand[k], rows[k]]) for k in cand}
    keep = pareto_front_indices(merged["throughput"], merged["area"],
                                merged["energy_per_unit"])
    return {k: v[keep] for k, v in merged.items()}


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

    ``results`` holds per-point ``sim.SimResult`` objects on the sequential
    path; on the batched path it holds the single ``sim.BatchSimResult`` of
    the one stacked replay.

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
    results: List[object]               # SimResults, or one BatchSimResult
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
                      device=None,
                      dtype: torch.dtype = torch.float64
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
    of survivors is one batched run.  ``dtype=torch.float32`` runs the
    ``"torch"`` tick loop in float32 (the reference's float32 scan backend;
    no telemetry then).  ``batch_controller_factory`` receives
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

    ``controller_factory`` (platform -> a ``repro_torch.sim.
    ControllerHarness``) or ``batch=False`` takes the per-point sequential
    path instead: one ``repro_torch.sim.SimEngine`` per survivor, the scalar
    policies in the loop (a ``BatchTrace`` gives each survivor its own row).
    ``balancer_factory`` (platform -> a ``repro_torch.sim.LoadBalancer``)
    puts a replica-group admission policy in the loop next to the DFS
    controller, on the sequential path and on ``backend="torch"`` (the
    ``"fused"`` kernel does not run one and refuses it).

    Robustness scoring: ``fault_schedule`` (a ``repro_torch.sim.
    FaultSchedule``) replays every survivor through the same injected
    failures (tile kills, link degradation, stuck actuators) with ``slo`` (a
    ``repro_torch.sim.SLOConfig``) fixing deadline/recovery semantics — the
    ranking then uses p99-*under-failure* and each survivor's drop rate
    (hard budget via ``max_drop_rate``, joining the p99 SLA in the miss
    score; otherwise as the primary sort key ahead of energy), on the
    sequential path and on ``backend="torch"`` (``"fused"`` refuses them).
    Fault-free calls rank exactly as before.

    Not ported yet, accepted for signature parity and refused when set:
    ``observe=`` and ``devices=`` beyond one device.
    """
    from repro_torch.sim.batch import BatchSimEngine, BatchSimPlatform
    from repro_torch.sim.engine import SimConfig, SimEngine, SimPlatform
    from repro_torch.sim.traffic import BatchTrace

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

    if batch is None:
        batch = controller_factory is None
    assert not (batch and controller_factory is not None), \
        "per-point controller_factory requires batch=False"
    if isinstance(trace, BatchTrace):
        # each survivor replays its own tensor row — a silent mismatch
        # would pair survivor j with the wrong workload
        assert trace.n_designs == indices.shape[0], \
            (trace.n_designs, indices.shape[0])

    if batch:
        platform = BatchSimPlatform.from_design_points(
            model, result, indices, req_mb=req_mb, n_tg=result.n_tg,
            flows=flows)
        controller = (batch_controller_factory(platform)
                      if batch_controller_factory is not None else None)
        engine = BatchSimEngine(platform, config=sim_config or SimConfig(),
                                controller=controller,
                                balancer=(balancer_factory(platform)
                                          if balancer_factory is not None
                                          else None),
                                backend=backend, faults=fault_schedule,
                                slo=slo, observe=observe, devices=devices,
                                tech=tech, device=device, dtype=dtype)
        r = engine.run(trace)
        p99, ept = r.p99_latency_s, r.energy_per_request_j
        thr = r.throughput_rps
        drops = (np.asarray(r.drop_rate, dtype=np.float64)
                 if fault_schedule is not None else None)
        results: List[object] = [r]
    else:
        p99 = np.empty(indices.shape[0])
        ept = np.empty(indices.shape[0])
        thr = np.empty(indices.shape[0])
        drops = (np.empty(indices.shape[0])
                 if fault_schedule is not None else None)
        results = []
        for j, i in enumerate(indices):
            dp = result.design_point(int(i))
            platform = SimPlatform.from_design_point(
                model, dp, result.workloads, req_mb=req_mb,
                n_tg=result.n_tg, flows=flows)
            controller = (controller_factory(platform)
                          if controller_factory is not None else None)
            engine = SimEngine(platform, config=sim_config or SimConfig(),
                               controller=controller,
                               balancer=(balancer_factory(platform)
                                         if balancer_factory is not None
                                         else None),
                               faults=fault_schedule, slo=slo,
                               observe=observe, tech=tech, device=device)
            r = engine.run(trace.design(j) if isinstance(trace, BatchTrace)
                           else trace)
            results.append(r)
            p99[j] = r.p99_latency_s
            ept[j] = r.energy_per_request_j
            thr[j] = r.throughput_rps
            if drops is not None:
                drops[j] = r.drop_rate

    order = _rank_scores(p99, ept, p99_sla_s, drop_rate=drops,
                         max_drop_rate=max_drop_rate)
    return ClosedLoopScore(indices=indices, p99_latency_s=p99,
                           energy_per_request_j=ept, throughput_rps=thr,
                           order=np.asarray(order, dtype=np.int64),
                           results=results, drop_rate=drops, counters=None)


# ---------------------------------------------------------------------------
# Scalar reference sweep (original API)
# ---------------------------------------------------------------------------


def sweep_soc(model: SoCPerfModel, wl: AccelWorkload,
              *, ks: Sequence[int] = (1, 2, 4),
              noc_rates: Sequence[float] = (0.1, 0.5, 1.0),
              acc_rates: Sequence[float] = (0.2, 0.6, 1.0),
              positions: Sequence[Tuple[int, int]] = ((1, 1), (3, 3)),
              n_tg: int = 0) -> List[DesignPoint]:
    """Exhaustive scalar sweep over the paper's axes for one accelerator.

    The per-point reference path, host Python; :func:`grid_sweep` is the
    batched equivalent and is tested to match it within fp tolerance."""
    out: List[DesignPoint] = []
    for k, fn, fa, pos in itertools.product(ks, noc_rates, acc_rates,
                                            positions):
        w = dataclasses.replace(wl, replication=k)
        rates = {"acc": fa, "noc_mem": fn, "tg": 1.0}
        thr = model.accel_throughput(w, pos, rates, n_tg)
        area = replication_area_model(
            weight_bytes=1.0, act_bytes=0.5, k=k)["total_bytes_per_dev"]
        power = chip_power(fa, busy=1.0) \
            + NOC_POWER_SHARE * chip_power(fn, busy=1.0)
        out.append(DesignPoint(
            replication={wl.name: k}, rates=rates,
            placement={wl.name: pos}, throughput=thr, area=area,
            energy_per_unit=power / max(thr, 1e-9)))
    return out


def sweep_replication_roofline(eval_cell: Callable[[int], Dict[str, float]],
                               ks: Sequence[int] = (1, 2, 4, 8)
                               ) -> List[Dict[str, float]]:
    """Pod-scale MRA sweep: ``eval_cell(K)`` evaluates the cell on the
    K-factored mesh and returns roofline terms; each row gains ``K`` and
    the modelled ``predicted_gain``."""
    rows = []
    for k in ks:
        r = dict(eval_cell(k))
        r["K"] = k
        r["predicted_gain"] = replication_throughput_model(k)
        rows.append(r)
    return rows


def _point_line(p: DesignPoint) -> str:
    return (f"  K={p.replication}  rates={ {k: round(v, 2) for k, v in p.rates.items()} }"
            f"  pos={p.placement}  thr={p.throughput:.2f}  area={p.area:.2f}"
            f"  E/u={p.energy_per_unit:.1f}")


def summarize(points: Sequence[DesignPoint], top: int = 10) -> str:
    front = pareto_front(points)
    front.sort(key=lambda p: -p.throughput)
    lines = [f"{len(points)} points, {len(front)} on Pareto front"]
    lines += [_point_line(p) for p in front[:top]]
    return "\n".join(lines)


def summarize_result(res, top: int = 10) -> str:
    """Summary of a batched sweep (dense or chunked) without materializing
    all points."""
    front_idx = res.pareto_indices()
    order = np.argsort(-res.objective_values("throughput", front_idx),
                       kind="stable")
    lines = [f"{len(res)} points ({res.n_valid} valid, "
             f"{res.points_per_second:,.0f} pts/s), "
             f"{front_idx.shape[0]} on Pareto front"]
    lines += [_point_line(p)
              for p in res.design_points(front_idx[order][:top])]
    return "\n".join(lines)
