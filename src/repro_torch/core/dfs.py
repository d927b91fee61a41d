"""Vectorized (multi-design) DFS policies for the batched co-simulation.

The batched engine (``sim/batch.py``) runs B design points at once, so its
controller harness hands policies a *sample* object exposing per-tile
``(B, A)`` counter windows plus island aggregation helpers
(``sim/control.py:BatchSample``).  A batch policy returns a ``(B, I)`` array
of requested island rates, with NaN meaning "no request for this island".

Each policy has two faces:

* a NumPy ``__call__`` — what :class:`~repro_torch.sim.control.
  BatchControllerHarness` runs on the host for ``backend="torch"``
  (element for element the reference package's arithmetic);
* for ``backend="fused"`` the policy's arithmetic lives in the tick kernel
  (``kernels/tick_sim.py``, selected by kind), and a stateful policy hands
  its carried state over with ``fused_state(B, I)`` before the launch and
  takes the evolved state back with ``fused_sync(state)`` after it.

The scalar policies and the dual-buffer ``DFSActuator`` of the reference
belong to the sequential engine and are ported with it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class BatchMemoryBoundPolicy:
    """Vectorized :func:`policy_memory_bound`: islands whose mean tile
    stream-boundness exceeds ``threshold`` drop to ``low_rate``, everyone
    else returns to full rate; fixed islands, ``noc_mem`` and islands with
    no sampled tiles are never requested (NaN).  Stateless."""

    def __init__(self, *, threshold: float = 0.7, low_rate: float = 0.2):
        self.threshold = threshold
        self.low_rate = low_rate

    def __call__(self, rates: np.ndarray, sample) -> np.ndarray:
        b = sample.island_mean(sample.boundness)            # (B, I)
        out = np.where(b >= self.threshold, self.low_rate, 1.0)
        skip = (sample.fixed | (sample.counts == 0)
                | (np.asarray(sample.island_names) == "noc_mem"))
        out[:, skip] = np.nan
        return out


class BatchPIDRatePolicy:
    """Vectorized :class:`PIDRatePolicy`: per-(design, island) integral and
    previous-error state as (B, I) arrays, elementwise the scalar PID's
    update.  Stateful — construct one instance per controlled batch."""

    def __init__(self, *, target: float = 0.7, kp: float = 0.8,
                 ki: float = 0.25, kd: float = 0.0, min_rate: float = 0.2,
                 integral_clamp: float = 2.0,
                 skip: Tuple[str, ...] = ("noc_mem",)):
        assert 0.0 < target <= 1.0
        self.target = target
        self.kp, self.ki, self.kd = kp, ki, kd
        self.min_rate = min_rate
        self.integral_clamp = integral_clamp
        self.skip = tuple(skip)
        self._integral: Optional[np.ndarray] = None          # (B, I)
        self._prev_err: Optional[np.ndarray] = None          # (B, I)

    def reset(self) -> None:
        self._integral = None
        self._prev_err = None

    def __call__(self, rates: np.ndarray, sample) -> np.ndarray:
        rates = np.asarray(rates, dtype=np.float64)
        util = sample.island_mean(sample.busy)               # (B, I)
        skip = (sample.fixed | (sample.counts == 0)
                | np.isin(np.asarray(sample.island_names), self.skip))
        err = np.where(skip, 0.0, util - self.target)
        if self._integral is None:
            self._integral = np.zeros_like(err)
        if self._prev_err is None:
            d_term = np.zeros_like(err)        # scalar: first sample d=0
        else:
            d_term = err - self._prev_err
        i_term = np.clip(self._integral + err,
                         -self.integral_clamp, self.integral_clamp)
        self._integral = i_term
        self._prev_err = err
        new = rates + self.kp * err + self.ki * i_term + self.kd * d_term
        out = np.clip(new, self.min_rate, 1.0)
        out[:, skip] = np.nan
        return out

    # ---- fused path (state resident in the tick kernel)
    def fused_state(self, B: int, I: int):
        """``(integral, prev_err, has)``: the carried (B, I) state and the
        (B, 1) flag saying a previous sample exists (``d_term`` is 0 until
        it does)."""
        if self._integral is not None:
            return (np.asarray(self._integral, dtype=np.float64),
                    np.asarray(self._prev_err, dtype=np.float64),
                    np.ones((B, 1), dtype=bool))
        return (np.zeros((B, I)), np.zeros((B, I)),
                np.zeros((B, 1), dtype=bool))

    def fused_sync(self, state) -> None:
        self._integral = np.asarray(state[0], dtype=np.float64)
        self._prev_err = np.asarray(state[1], dtype=np.float64)


class BatchEWMAUtilizationPolicy:
    """Utilization-tracking proportional policy with EWMA smoothing —
    a stateful policy beyond the membound/PID pair.

    Each control tick the island's smoothed utilization ``ewma`` pulls
    the rate toward ``rates * ewma / target`` (busy islands speed up,
    idle islands slow down), clipped to ``[min_rate, 1]``.  State is the
    (B, I) EWMA plus a (B, 1) "seeded" flag (the first sample primes the
    EWMA instead of decaying from zero).  The numpy ``__call__`` and the
    fused kernel's EWMA branch share the same arithmetic, so the fused
    backend reproduces the float64 engine within float32 rounding
    (differential-tested)."""

    def __init__(self, *, alpha: float = 0.3, target: float = 0.7,
                 min_rate: float = 0.2):
        assert 0.0 < alpha <= 1.0 and 0.0 < target <= 1.0
        self.alpha = alpha
        self.target = target
        self.min_rate = min_rate
        self._ewma: Optional[np.ndarray] = None              # (B, I)

    def reset(self) -> None:
        self._ewma = None

    def _skip(self, fixed, counts, names) -> np.ndarray:
        return (np.asarray(fixed) | (np.asarray(counts) == 0)
                | (np.asarray(names) == "noc_mem"))

    # ---- numpy path (BatchControllerHarness)
    def __call__(self, rates: np.ndarray, sample) -> np.ndarray:
        rates = np.asarray(rates, dtype=np.float64)
        skip = self._skip(sample.fixed, sample.counts,
                          sample.island_names)
        util = np.where(skip, 0.0,
                        np.nan_to_num(sample.island_mean(sample.busy)))
        if self._ewma is None:
            ewma = util
        else:
            ewma = self.alpha * util + (1.0 - self.alpha) * self._ewma
        self._ewma = ewma
        out = np.clip(rates * (ewma / self.target), self.min_rate, 1.0)
        out[:, skip] = np.nan
        return out

    # ---- fused path (state resident in the tick kernel)
    def skip_islands(self, topo) -> np.ndarray:
        return self._skip(topo.fixed, topo.counts, topo.names)

    def fused_state(self, B: int, I: int):
        """``(ewma, has)``: the carried (B, I) EWMA and the (B, 1) "seeded"
        flag.  The kernel's update is ``ewma = has ? alpha*util +
        (1-alpha)*ewma : util`` on every control tick."""
        if self._ewma is not None:
            return (np.asarray(self._ewma, dtype=np.float64),
                    np.ones((B, 1), dtype=bool))
        return (np.zeros((B, I)), np.zeros((B, 1), dtype=bool))

    def fused_sync(self, state) -> None:
        ewma, has = state
        if np.any(has):
            self._ewma = np.asarray(ewma, dtype=np.float64)
