"""Online DFS control harnesses and the load balancer of the co-simulation.

Every ``control_interval`` ticks the engine hands a harness a windowed
counter sample (busy fraction, stream-boundness, accumulated pkts/rtt — the
C3 monitor, vectorized); the harness

1. differences the accumulating counters against its previous sample (the
   host-side *manual reset* of ``core/monitor.py``, without ever zeroing the
   device counters),
2. invokes the policy (``core/dfs.py``),
3. applies the *backpressure guard*: any non-fixed island whose tiles have
   more than ``queue_guard_ticks`` ticks of backlog is forced to
   ``guard_rate`` regardless of what the policy said,
4. clamps requests into the tech node's legal DVFS range (when a
   :class:`~repro_torch.core.voltage.TechModel` is in the loop) and snaps
   them to the nearest legal ladder level,
5. commits the changed rates (no commit — and no config version bump, so
   the engine keeps its cached service rates — when the quantized rates are
   all unchanged).

:class:`ControllerHarness` drives ONE platform (``sim/engine.py:SimEngine``)
through the scalar policies and the dual-buffer
:class:`~repro_torch.core.dfs.DFSActuator`; :class:`BatchControllerHarness`
drives B stacked designs with array state (a commit is one masked swap).
Both live on the host: the ``"torch"`` loops copy one window's counters
down per control interval; ``backend="fused"`` runs the batch pipeline
inside the tick kernel and writes the evolved state back afterwards.

:class:`LoadBalancer` is the admission policy across replicated tiles; it
splits each tick's arrivals on the engine's device, inside the tick loop.
"""
from __future__ import annotations

import copy
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dfs import DFSActuator, TileTelemetry
from repro_torch.core.islands import IslandConfig
from repro_torch.core.voltage import TechModel


Policy = Callable[[IslandConfig, Dict[str, TileTelemetry]], Dict[str, float]]


@dataclass
class ControlAction:
    """One controller decision, for post-run inspection."""
    tick: int
    requested: Dict[str, float]          # raw policy output
    guarded: Tuple[str, ...]             # islands overridden by the guard
    committed: Optional[int]             # new config version, or None
    clamped: Tuple[str, ...] = ()        # islands pushed into the tech
                                         # node's legal DVFS range


class ControllerHarness:
    """Samples counters, runs a DFS policy, commits through the actuator."""

    def __init__(self, initial: IslandConfig, policy: Optional[Policy],
                 *, queue_guard_ticks: Optional[float] = 4.0,
                 guard_release_ticks: Optional[float] = None,
                 guard_rate: float = 1.0, history_maxlen: int = 256,
                 actions_maxlen: int = 1024, tech=None):
        self.actuator = DFSActuator(initial, history_maxlen=history_maxlen)
        self.policy = policy
        # physical DVFS bounds (core/voltage.py): requested rates are
        # clamped into the node's legal [L, U] ratio range before
        # quantization; None = unconstrained (the engine injects its own
        # tech model here when the harness was built without one)
        self.tech = TechModel.coerce(tech)
        self.queue_guard_ticks = queue_guard_ticks
        # hysteresis: an island stays guarded until its backlog drains
        # below the (lower) release threshold — without it the guard and
        # an energy policy flap against each other every interval at peak
        self.guard_release_ticks = (
            guard_release_ticks if guard_release_ticks is not None
            else (queue_guard_ticks / 4.0
                  if queue_guard_ticks is not None else None))
        self.guard_rate = guard_rate
        self._guard_active: set = set()
        # bounded like ActuatorState.history: million-tick soaks commit
        # thousands of intervals, only a recent window is ever inspected
        self.actions: Deque[ControlAction] = deque(maxlen=actions_maxlen)
        self._prev_pkts_in: Optional[np.ndarray] = None
        self._prev_pkts_out: Optional[np.ndarray] = None
        self._prev_rtt: Optional[np.ndarray] = None

    def live(self) -> IslandConfig:
        return self.actuator.live()

    def begin_run(self) -> None:
        """Called by the engine at the start of each run: the engine's
        accumulating counters restart from zero, so the differencing
        baselines must too (policy state — PID integrals, guard latches —
        deliberately survives across runs)."""
        self._prev_pkts_in = None
        self._prev_pkts_out = None
        self._prev_rtt = None

    # ------------------------------------------------------------ sampling
    def _window_sample(self, names, busy, boundness, pkts_in, pkts_out,
                       rtt) -> Dict[str, TileTelemetry]:
        """Accumulating counters are differenced against the previous
        sample; exec_time/boundness are already per-window values."""
        zero = np.zeros_like(pkts_in)
        d_in = pkts_in - (self._prev_pkts_in if self._prev_pkts_in is not None
                          else zero)
        d_out = pkts_out - (self._prev_pkts_out
                            if self._prev_pkts_out is not None else zero)
        d_rtt = rtt - (self._prev_rtt if self._prev_rtt is not None else zero)
        self._prev_pkts_in = np.array(pkts_in)
        self._prev_pkts_out = np.array(pkts_out)
        self._prev_rtt = np.array(rtt)
        return {
            n: TileTelemetry(
                exec_time=float(busy[i]), pkts_in=float(d_in[i]),
                pkts_out=float(d_out[i]), rtt=float(d_rtt[i]),
                boundness=float(boundness[i]))
            for i, n in enumerate(names)}

    # ---------------------------------------------------------------- step
    def step(  # repro: hot
            self, *, tick: int, names, busy, boundness, pkts_in, pkts_out,
            rtt, queue_ticks, dead=None,
            stuck=None) -> Optional[IslandConfig]:
        """One control interval: sample -> policy -> guard -> commit.

        ``dead``/``stuck`` are optional ``(I,)`` boolean masks in island
        order: a dead island has no hardware to actuate (its guard latch
        is cleared so it re-arms cleanly on revival, and any requested
        change is dropped); a stuck island keeps sampling and latching
        but its commit is blocked — the actuator write never lands.

        Returns the new live :class:`IslandConfig` if a swap happened,
        else ``None`` (the engine keeps its cached service rates)."""
        telemetry = self._window_sample(names, busy, boundness,
                                        pkts_in, pkts_out, rtt)
        live = self.actuator.live()
        requested: Dict[str, float] = {}
        if self.policy is not None:
            requested = dict(self.policy(live, telemetry) or {})

        guarded: List[str] = []
        if self.queue_guard_ticks is not None:
            backlog = {n: float(queue_ticks[i]) for i, n in enumerate(names)}
            for ii, isl in enumerate(live.islands):
                if isl.fixed:
                    continue
                if dead is not None and dead[ii]:
                    self._guard_active.discard(isl.name)
                    continue
                worst = max((backlog.get(t, 0.0) for t in isl.tiles),
                            default=0.0)
                if worst > self.queue_guard_ticks:
                    self._guard_active.add(isl.name)
                elif worst < self.guard_release_ticks:
                    self._guard_active.discard(isl.name)
                if isl.name in self._guard_active:
                    requested[isl.name] = self.guard_rate
                    guarded.append(isl.name)

        # DVFS-bound clamp: with a tech model in the loop, requests
        # outside the node's legal [L, U] ratio range are pushed back in
        # before quantization (the ControlAction keeps the raw request so
        # the rejection is traceable)
        clamped: List[str] = []
        applied = requested
        if self.tech is not None:
            lo, hi = self.tech.l_bound, self.tech.u_bound
            ladders = {i.name: i.ladder for i in live.islands}
            applied = {}
            for n, r in requested.items():
                c = min(max(float(r), lo), hi)
                hit = c != r
                lad = ladders.get(n)
                if lad is not None:
                    lv = np.asarray(lad.levels(), dtype=np.float64)
                    legal = lv[self.tech.legal(lv)]
                    if legal.size:
                        # nearest LEGAL ladder level: plain quantization
                        # of a clamped request could snap back below L
                        q = float(legal[int(np.argmin(np.abs(legal - c)))])
                        hit = hit or q != lad.quantize(r)
                        c = q
                if hit:
                    clamped.append(n)
                applied[n] = c

        # drop no-op rate changes so the config version only bumps on a
        # real swap (ladder-quantized comparison, as with_rates would do)
        changes: Dict[str, float] = {}
        for ii, isl in enumerate(live.islands):
            if isl.name not in applied or isl.fixed:
                continue
            if dead is not None and dead[ii]:
                continue
            if stuck is not None and stuck[ii]:
                continue
            if isl.ladder.quantize(applied[isl.name]) != isl.rate:
                changes[isl.name] = applied[isl.name]

        committed = None
        if changes:
            self.actuator.reconfigure(changes)
            committed = self.actuator.commit().version
        self.actions.append(ControlAction(
            tick=tick, requested=requested, guarded=tuple(guarded),
            committed=committed, clamped=tuple(clamped)))
        return self.actuator.live() if committed is not None else None


# ---------------------------------------------------------------------------
# Admission / load balancing across replicated accelerator groups
# ---------------------------------------------------------------------------


def _einsum_lanes(n: int) -> Tuple[List[int], List[int]]:
    """The tiles NumPy's einsum adds into each of its two lanes, in the
    order it adds them, for a contiguous contraction over ``n`` tiles:
    even and odd tiles in two interleaved lanes, whole blocks of eight
    taken back to front, then the rest in pairs; the two lanes are added
    last.  (Not the sequential order the reference's docstring names.)"""
    lanes: Tuple[List[int], List[int]] = ([], [])
    i = 0
    while n - i >= 8:
        for blk in (3, 2, 1, 0):
            for j in (0, 1):
                lanes[j].append(i + 2 * blk + j)
        i += 8
    for t in range(i, n):
        lanes[(t - i) % 2].append(t)
    return lanes


def group_sum_index(membership: np.ndarray
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """``(index, keep)`` for :func:`group_sums`: ``index`` (G, 2, L) holds
    each group's members in the order NumPy's einsum adds them to each
    lane, a lane shorter than ``L`` padded with its group's first member;
    ``keep`` (G, 2, L) is 1.0 on a member and 0.0 on padding, or None when
    no lane is padded."""
    G, A = membership.shape
    seqs = [[[t for t in lane if membership[g, t]]
             for lane in _einsum_lanes(A)] for g in range(G)]
    L = max([1] + [len(q) for gs in seqs for q in gs])
    index = np.zeros((G, 2, L), dtype=np.int64)
    keep = np.zeros((G, 2, L), dtype=np.float64)
    for g, gs in enumerate(seqs):
        index[g] = (gs[0] + gs[1])[0]
        for j, q in enumerate(gs):
            index[g, j, :len(q)] = q
            keep[g, j, :len(q)] = 1.0
    return index, (None if keep.all() else keep)


def group_sums(x: torch.Tensor, index: torch.Tensor,
               keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(..., A)`` finite per-tile values -> ``(..., G)`` per-group sums,
    bit for bit the reference's ``np.einsum("...a,ga->...g", x,
    membership)`` for ``index, keep = group_sum_index(membership)``.

    The einsum adds every tile's product, but a non-member's is a zero,
    which leaves a finite sum unchanged but for the sign of a zero (the
    final ``0.0 +`` makes that positive, as NumPy's zero-started lanes
    do), so only the members' order matters: each lane's members are
    gathered at once (padding zeroed by ``keep``) and added in that order,
    all groups together.  Torch's own contraction adds in another order."""
    terms = x[..., index]                                   # (..., G, 2, L)
    if keep is not None:
        terms = terms * keep
    acc = terms[..., 0]
    for i in range(1, terms.shape[-1]):
        acc = terms[..., i] + acc
    return 0.0 + (acc[..., 0] + acc[..., 1])


class LoadBalancer:
    """Vectorized admission policy: redistribute each tick's incoming
    requests across groups of interchangeable accelerator tiles.

    The trace (and any chained stage's forwarded completions) addresses
    *logical* destinations; when a destination is replicated across an
    island group, a front-end balancer decides which replica actually
    enqueues the request.  Modes:

    * ``"even"``     — uniform split (the static baseline),
    * ``"capacity"`` — proportional to each replica's current service
      capacity, so a DFS-derated island automatically sheds load to its
      faster peers,
    * ``"adaptive"`` — capacity divided by (1 + backlog): capacity-aware
      *and* backlog-draining, the default.

    Shape-agnostic: :meth:`split` takes float64 tensors whose trailing axis
    is the tile axis, with any leading axes, on any device, and adds each
    group's members in the reference's order (:func:`group_sums`), so the
    sequential engine and a B = 1 batch row run the same floats.  Requests
    for tiles outside every group pass through untouched, and each group's
    split sums to its offered load by construction.  The group layout
    (``membership`` (G, A), ``covered`` (A,), ``group_of`` (A,)) is host
    NumPy, moved to a device once.
    """

    MODES = ("even", "capacity", "adaptive")

    def __init__(self, groups, tile_names, *, mode: str = "adaptive"):
        assert mode in self.MODES, f"mode {mode!r} not in {self.MODES}"
        self.mode = mode
        tile_names = tuple(tile_names)
        A = len(tile_names)
        if isinstance(groups, dict):
            groups = list(groups.values())
        idx: List[np.ndarray] = []
        taken: set = set()
        for g in groups:
            g = tuple(g)
            assert g, "empty balancer group"
            for t in g:
                assert t in tile_names, f"unknown tile {t!r} in group"
                assert t not in taken, f"tile {t!r} in two balancer groups"
                taken.add(t)
            idx.append(np.asarray([tile_names.index(t) for t in g],
                                  dtype=np.int64))
        G = len(idx)
        self.membership = np.zeros((G, A), dtype=np.float64)
        for gi, ids in enumerate(idx):
            self.membership[gi, ids] = 1.0
        self.covered = self.membership.sum(axis=0) > 0          # (A,) bool
        # tile -> its group (0 where uncovered; masked by ``covered``)
        self.group_of = np.zeros(A, dtype=np.int64)
        for gi, ids in enumerate(idx):
            self.group_of[ids] = gi
        # (G, 2, L) member order of each group's sum, padding mask
        self.sum_index, self.sum_keep = group_sum_index(self.membership)
        self._dev: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}  # repro: noqa[TPR003] one entry per (device, dtype) a run splits on: the shards' devices times two dtypes

    def layout(self, device: torch.device, dtype: torch.dtype
                ) -> Tuple[Optional[torch.Tensor], ...]:
        """The group layout on ``device`` (``sum_index``, ``sum_keep``,
        ``covered``, ``group_of``), copied there once per dtype — kept
        under the device as named and as its tensors report it (``cuda``
        and ``cuda:0``), so a split finds what an engine made."""
        key = (device, dtype)
        if key not in self._dev:
            out = (
                torch.as_tensor(self.sum_index, device=device),  # repro: noqa[TPR001] the group layout onto the card once a device and dtype (memoised)
                (None if self.sum_keep is None else torch.as_tensor(  # repro: noqa[TPR001] once a device and dtype (memoised)
                    self.sum_keep, dtype=dtype, device=device)),
                torch.as_tensor(self.covered, device=device),  # repro: noqa[TPR001] once a device and dtype (memoised)
                torch.as_tensor(self.group_of, device=device))  # repro: noqa[TPR001] once a device and dtype (memoised)
            self._dev[key] = self._dev[(out[0].device, dtype)] = out
        return self._dev[key]

    def weights(self, queue: torch.Tensor, cap: torch.Tensor,
                dtype: torch.dtype = torch.float64) -> torch.Tensor:
        """Per-tile split weight (strictly positive for live tiles)."""
        if self.mode == "even":
            return torch.ones_like(queue, dtype=dtype)
        if self.mode == "capacity":
            return cap.to(dtype)
        return cap.to(dtype) / (1.0 + queue)

    def split(self, arr: torch.Tensor,  # repro: hot
              queue: torch.Tensor, cap: torch.Tensor,
              alive: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Redistribute one tick's arrivals within each group.

        ``arr``/``queue``/``cap`` are ``(..., A)`` tensors on one device;
        returns a new ``(..., A)`` tensor (float64, or ``arr``'s float32 in
        the float32 loop) whose per-group sums equal ``arr``'s.  ``alive`` (optional ``(..., A)`` 0/1 mask) zeroes dead
        replicas' weights so their share re-spills to surviving peers; a
        group with no survivors still falls back to an even split (work is
        never silently discarded here).  No value goes to the host.
        """
        dtype = (torch.float32 if arr.dtype == torch.float32
                 else torch.float64)
        arr = arr.to(dtype)
        if not self.covered.any():
            return arr
        index, keep, covered, group_of = self.layout(arr.device, dtype)
        w = self.weights(queue, cap, dtype)
        # a NaN or negative weight (0/0 capacity ratios from zero-capacity
        # replicas) must weigh *nothing*, not poison its group's sum
        w = torch.where(torch.isfinite(w) & (w > 0.0), w, 0.0)
        if alive is not None:
            w = w * alive
        tot = group_sums(arr, index, keep)
        wsum = group_sums(w, index, keep)
        # a group whose every replica weighs 0 (e.g. cap forced to 0)
        # falls back to an even split — requests are never discarded
        w = torch.where((wsum <= 0.0)[..., group_of], 1.0, w)
        wsum = group_sums(w, index, keep)
        shared = tot[..., group_of] * (w / wsum[..., group_of])
        return torch.where(covered, shared, arr)


# ---------------------------------------------------------------------------
# Batched (multi-design) harness — sim/batch.py's controller
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class IslandTopology:
    """Array form of one island partition, shared by all B designs.

    ``membership[i, a]`` is 1.0 iff tile ``a`` belongs to island ``i``;
    ``ladder_levels`` stacks each island's quantization ladder, padded
    with +inf (padding can never win the nearest-level argmin, so the
    tie-breaking matches the scalar ``RateLadder.quantize`` exactly).
    """
    names: Tuple[str, ...]
    membership: np.ndarray              # (I, A) float64 0/1
    fixed: np.ndarray                   # (I,) bool
    ladder_levels: np.ndarray           # (I, L_max) float64, +inf padded
    counts: np.ndarray                  # (I,) tiles per island (sampled)

    @classmethod
    def from_config(cls, islands: IslandConfig,
                    tile_names) -> "IslandTopology":
        tile_names = tuple(tile_names)
        I = len(islands.islands)
        A = len(tile_names)
        mem = np.zeros((I, A), dtype=np.float64)
        for i, isl in enumerate(islands.islands):
            for t in isl.tiles:
                if t in tile_names:
                    mem[i, tile_names.index(t)] = 1.0
        ladders = [np.asarray(isl.ladder.levels(), dtype=np.float64)
                   for isl in islands.islands]
        lmax = max(lv.shape[0] for lv in ladders)
        levels = np.full((I, lmax), np.inf)
        for i, lv in enumerate(ladders):
            levels[i, :lv.shape[0]] = lv
        return cls(names=islands.names(), membership=mem,
                   fixed=np.asarray([isl.fixed for isl in islands.islands]),
                   ladder_levels=levels, counts=mem.sum(axis=1))

    def quantize(self, rates: np.ndarray,
                 legal: Optional[np.ndarray] = None) -> np.ndarray:
        """Nearest ladder level per (design, island); NaN passes through.
        ``legal``: optional (I, L_max) mask restricting the candidate
        levels (the physical-DVFS bound — illegal levels can't win)."""
        r = np.asarray(rates, dtype=np.float64)
        d = np.abs(self.ladder_levels[None, :, :] - r[..., None])
        if legal is not None:
            d = np.where(legal[None, :, :], d, np.inf)
        idx = np.argmin(np.where(np.isnan(d), np.inf, d), axis=-1)
        q = self.ladder_levels[np.arange(len(self.names))[None, :], idx]
        return np.where(np.isnan(r), np.nan, q)

    def island_mean(self, x: np.ndarray) -> np.ndarray:
        """(B, A) per-tile values -> (B, I) island means (NaN if empty).

        The contraction is an einsum (sequential accumulation over the
        tile axis), so a one- or two-tile island's mean is bit-identical
        to the scalar harness's ``np.mean([...])`` over the same tiles."""
        s = np.einsum("ba,ia->bi", np.asarray(x, dtype=np.float64),
                      self.membership)
        with np.errstate(invalid="ignore", divide="ignore"):
            return s / np.where(self.counts > 0, self.counts, np.nan)

    def island_max(self, x: np.ndarray, default: float = 0.0) -> np.ndarray:
        """(B, A) -> (B, I) masked max over member tiles (``default`` for
        empty islands, matching the scalar guard's ``max(..., default)``)."""
        masked = np.where(self.membership[None, :, :] > 0,
                          np.asarray(x)[:, None, :], -np.inf)
        out = masked.max(axis=-1)
        return np.where(self.counts[None, :] > 0, out, default)


@dataclass(frozen=True)
class BatchSample:
    """One windowed counter sample across B designs — what batch policies
    consume (``core/dfs.py:BatchMemoryBoundPolicy`` etc.).  Accumulating
    counters arrive already differenced against the previous window."""
    busy: np.ndarray                    # (B, A) window busy fraction
    boundness: np.ndarray               # (B, A)
    pkts_in: np.ndarray                 # (B, A) window delta
    pkts_out: np.ndarray                # (B, A) window delta
    rtt: np.ndarray                     # (B, A) window delta
    queue_ticks: np.ndarray             # (B, A) backlog in ticks
    topo: IslandTopology

    @property
    def island_names(self) -> Tuple[str, ...]:
        return self.topo.names

    @property
    def fixed(self) -> np.ndarray:
        return self.topo.fixed

    @property
    def counts(self) -> np.ndarray:
        return self.topo.counts

    def island_mean(self, x: np.ndarray) -> np.ndarray:
        return self.topo.island_mean(x)


BatchPolicy = Callable[[np.ndarray, BatchSample], np.ndarray]


class BatchControllerHarness:
    """The DFS controller harness for B stacked designs.

    State is arrays instead of actuator objects: live rates are a (B, I)
    matrix, the dual-buffer commit is one masked swap
    (``where(changed, quantized, live)``), config versions and swap
    counts are (B,) integer vectors bumped by a boolean mask — the whole
    sample -> policy -> guard -> quantize -> commit pipeline runs once
    per control interval for every design simultaneously.  Semantics
    mirror the reference package's harness exactly (differential-tested):
    no-op commits are suppressed per design, the backpressure guard
    latches with the same hysteresis, counters difference against the
    previous window without zeroing.
    """

    def __init__(self, islands: IslandConfig, rates0: np.ndarray,
                 policy: Optional[BatchPolicy], *, tile_names,
                 queue_guard_ticks: Optional[float] = 4.0,
                 guard_release_ticks: Optional[float] = None,
                 guard_rate: float = 1.0, tech=None):
        self.topo = IslandTopology.from_config(islands, tile_names)
        rates0 = np.asarray(rates0, dtype=np.float64)
        assert rates0.ndim == 2 and rates0.shape[1] == len(self.topo.names)
        self.rates = rates0.copy()
        B = rates0.shape[0]
        self.versions = np.full(B, islands.version, dtype=np.int64)
        self.swaps = np.zeros(B, dtype=np.int64)
        self.policy = policy
        # physical DVFS bounds, mirroring the scalar harness: requests
        # outside the tech node's legal [L, U] range are clamped before
        # quantization (``last_clamped`` holds the per-(design, island)
        # mask of the most recent step)
        self.tech = TechModel.coerce(tech)
        self.last_clamped = np.zeros((B, len(self.topo.names)), dtype=bool)
        self.queue_guard_ticks = queue_guard_ticks
        self.guard_release_ticks = (
            guard_release_ticks if guard_release_ticks is not None
            else (queue_guard_ticks / 4.0
                  if queue_guard_ticks is not None else None))
        self.guard_rate = guard_rate
        self._guard_active = np.zeros((B, len(self.topo.names)), dtype=bool)
        self._prev_pkts_in: Optional[np.ndarray] = None
        self._prev_pkts_out: Optional[np.ndarray] = None
        self._prev_rtt: Optional[np.ndarray] = None

    @property
    def n_designs(self) -> int:
        return self.rates.shape[0]

    def live_rates(self) -> np.ndarray:
        return self.rates.copy()

    def begin_run(self) -> None:
        """Engine counters restart per run -> differencing baselines too
        (policy state — PID integrals, guard latches — survives)."""
        self._prev_pkts_in = None
        self._prev_pkts_out = None
        self._prev_rtt = None

    # ---------------------------------------------------------------- step
    def step(  # repro: hot
            self, *, tick: int, busy, boundness, pkts_in, pkts_out, rtt,
            queue_ticks, dead=None, stuck=None) -> Optional[np.ndarray]:
        """One control interval over all designs.

        ``dead``/``stuck`` are optional ``(I,)`` boolean masks shared by
        every design (faults are a property of the schedule, not the
        design): dead islands drop out of the guard latch and never
        commit, stuck islands keep latching but their commits are
        blocked — mirroring the scalar harness bit-for-bit at B=1.

        Returns the new (B, I) live-rate matrix if ANY design committed
        (``last_committed`` holds the per-design mask), else ``None`` —
        the engine keeps its cached service terms."""
        zero = np.zeros_like(np.asarray(pkts_in, dtype=np.float64))
        d_in = pkts_in - (self._prev_pkts_in
                          if self._prev_pkts_in is not None else zero)
        d_out = pkts_out - (self._prev_pkts_out
                            if self._prev_pkts_out is not None else zero)
        d_rtt = rtt - (self._prev_rtt
                       if self._prev_rtt is not None else zero)
        self._prev_pkts_in = np.array(pkts_in)
        self._prev_pkts_out = np.array(pkts_out)
        self._prev_rtt = np.array(rtt)

        sample = BatchSample(
            busy=np.asarray(busy, dtype=np.float64),
            boundness=np.asarray(boundness, dtype=np.float64),
            pkts_in=d_in, pkts_out=d_out, rtt=d_rtt,
            queue_ticks=np.asarray(queue_ticks, dtype=np.float64),
            topo=self.topo)

        B, I = self.rates.shape
        requested = np.full((B, I), np.nan)
        if self.policy is not None:
            requested = np.asarray(self.policy(self.rates, sample),
                                   dtype=np.float64)

        if self.queue_guard_ticks is not None:
            worst = self.topo.island_max(sample.queue_ticks)    # (B, I)
            # the scalar harness's if/elif hysteresis, vectorized
            latch = np.where(
                worst > self.queue_guard_ticks, True,
                np.where(worst < self.guard_release_ticks, False,
                         self._guard_active))
            latch &= ~self.topo.fixed[None, :]      # fixed islands excluded
            if dead is not None:
                latch = latch & ~np.asarray(dead, dtype=bool)
            self._guard_active = latch
            requested = np.where(latch, self.guard_rate, requested)

        # DVFS-bound clamp before quantization (NaN "no request" entries
        # pass through np.clip untouched); quantization then snaps to
        # the nearest LEGAL ladder level, so a clamped request cannot
        # quantize back outside [L, U]
        self.last_clamped = np.zeros_like(self._guard_active)
        legal = None
        if self.tech is not None:
            clamped_r = np.clip(requested, self.tech.l_bound,
                                self.tech.u_bound)
            lv = self.topo.ladder_levels
            legal = ((lv >= self.tech.l_bound)
                     & (lv <= self.tech.u_bound))
            legal = np.where(legal.any(axis=-1, keepdims=True),
                             legal, np.isfinite(lv))
            self.last_clamped = (
                ~np.isnan(requested)
                & ((clamped_r != requested)
                   | (self.topo.quantize(clamped_r, legal=legal)
                      != self.topo.quantize(requested))))
            requested = clamped_r

        # drop no-op rate changes so versions only bump on a real swap
        quantized = self.topo.quantize(requested, legal=legal)
        changed = (~np.isnan(requested) & ~self.topo.fixed[None, :]
                   & (quantized != self.rates))
        if dead is not None:
            changed = changed & ~np.asarray(dead, dtype=bool)
        if stuck is not None:
            changed = changed & ~np.asarray(stuck, dtype=bool)
        committed = changed.any(axis=1)                          # (B,)
        self.last_committed = committed
        if not committed.any():
            return None
        self.rates = np.where(changed, quantized, self.rates)
        self.versions = self.versions + committed
        self.swaps = self.swaps + committed
        return self.rates

    # ------------------------------------------------------- design rows
    # the harness's per-design state, each with a leading design axis
    ROW_STATE = ("rates", "versions", "swaps", "last_clamped",
                 "_guard_active", "_prev_pkts_in", "_prev_pkts_out",
                 "_prev_rtt", "last_committed")

    @staticmethod
    def _row_attrs(obj, names, B: int):
        """``obj``'s attributes among ``names`` (or, for ``names=None``,
        its private arrays) that hold one row per design."""
        for k, v in vars(obj).items():
            if names is not None and k not in names:
                continue
            if names is None and not k.startswith("_"):
                continue
            if isinstance(v, np.ndarray) and v.ndim >= 1 \
                    and v.shape[0] == B:
                yield k, v

    def take_rows(self, rows: np.ndarray) -> "BatchControllerHarness":
        """A harness over the designs ``rows`` of this one (a shard of the
        design axis): every per-design array of the harness, and every
        private per-design array of its policy (PID integrals, EWMA state),
        sliced; the rest shared.  :meth:`put_rows` writes a run's evolved
        state back."""
        rows = np.asarray(rows, dtype=np.int64)
        B = self.n_designs
        sub = copy.copy(self)
        for k, v in self._row_attrs(self, self.ROW_STATE, B):
            setattr(sub, k, v[rows].copy())
        if self.policy is not None:
            sub.policy = copy.copy(self.policy)
            for k, v in self._row_attrs(self.policy, None, B):
                setattr(sub.policy, k, v[rows].copy())
        return sub

    def put_rows(self, positions: np.ndarray, sub: "BatchControllerHarness",
                 sub_positions: np.ndarray) -> None:
        """Write rows ``sub_positions`` of ``sub`` (made by
        :meth:`take_rows`) into this harness's rows ``positions``.  A state
        array the sub-harness holds and this one does not yet (``None``
        before a first control step) is created here."""
        Bs = sub.n_designs
        for own, other in ((self, sub), (self.policy, sub.policy)):
            if other is None:
                continue
            names = self.ROW_STATE if own is self else None
            for k, v in list(self._row_attrs(other, names, Bs)):
                cur = getattr(own, k, None)
                if not isinstance(cur, np.ndarray) \
                        or cur.shape[1:] != v.shape[1:]:
                    cur = np.zeros((self.n_designs,) + v.shape[1:],
                                   dtype=v.dtype)
                    setattr(own, k, cur)
                cur[positions] = v[sub_positions]
