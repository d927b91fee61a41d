"""Online DFS control harness for the batched co-simulation loop.

Every ``control_interval`` ticks the engine hands the harness a windowed
counter sample (busy fraction, stream-boundness, accumulated pkts/rtt — the
C3 monitor, vectorized); the harness

1. differences the accumulating counters against its previous sample,
2. invokes the batch policy (``core/dfs.py``),
3. applies the *backpressure guard*: any non-fixed island whose tiles have
   more than ``queue_guard_ticks`` ticks of backlog is forced to
   ``guard_rate`` regardless of what the policy said,
4. clamps requests into the tech node's legal DVFS range (when a
   :class:`~repro_torch.core.voltage.TechModel` is in the loop) and snaps
   them to the nearest legal ladder level,
5. commits the changed rates as one masked array swap (no commit — and no
   version bump, so the engine keeps its cached service rates — when the
   quantized rates are all unchanged).

State lives in NumPy on the host: ``backend="torch"`` steps the harness
there every control interval; ``backend="fused"`` runs the same pipeline
inside the tick kernel and writes the evolved state back afterwards.  The
scalar ``ControllerHarness`` and the ``LoadBalancer`` of the reference are
ported with the sequential engine and the flow/balancer slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.core.islands import IslandConfig
from repro_torch.core.voltage import TechModel


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
    def step(self, *, tick: int, busy, boundness, pkts_in, pkts_out, rtt,
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
