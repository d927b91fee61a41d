"""DFS actuators, the dual-buffer hitless reconfiguration protocol (C2), and
the controller policies of the closed-loop co-simulation.

The paper's actuator uses two MMCMs and an FSM: the master holds the output
clock while the slave reconfigures, then roles swap — the platform never
sees a dead clock.  :class:`DFSActuator` keeps two *island-config buffers*:
the live one drives the step function while the shadow one is rewritten;
``commit()`` atomically swaps them between steps.  The sequential engine
(``sim/engine.py``) caches its service terms per island config, so swapping
back to a previously-used config costs nothing — the MMCM role swap.

Scalar policies consume the run-time monitor (C3) for ONE platform
(``{tile: TileTelemetry}`` -> ``{island: rate}``), host Python over
:class:`~repro_torch.core.islands.IslandConfig`, as in the reference package:

* ``policy_memory_bound`` — the paper's Fig. 4 insight: islands whose tiles
  are memory/stream-bound can drop their clock with negligible throughput
  loss, saving energy.
* ``policy_straggler``   — islands detected slow (exec-time counter above
  the fleet median) get work rebalanced away / their admission lowered.
* :class:`PIDRatePolicy` — per-island utilization tracking.
* ``policy_energy_per_token(_sweep)`` — energy/token minimisation over the
  rate ladders through a perf-model callable (``core/perfmodel.py``).

Vectorized (multi-design) policies serve the batched co-simulation
(``sim/batch.py``): its controller harness hands them a *sample* object
exposing per-tile ``(B, A)`` counter windows plus island aggregation
helpers (``sim/control.py:BatchSample``), and a batch policy returns a
``(B, I)`` array of requested island rates, NaN meaning "no request for
this island".  The math is element for element the scalar policies', so a
B = 1 batch run reproduces the scalar controller bit for bit.  Each batch
policy has two faces:

* a NumPy ``__call__`` — what :class:`~repro_torch.sim.control.
  BatchControllerHarness` runs on the host for ``backend="torch"``;
* for ``backend="fused"`` the policy's arithmetic lives in the tick kernel
  (``kernels/tick_sim.py``, selected by kind), and a stateful policy hands
  its carried state over with ``fused_state(B, I)`` before the launch and
  takes the evolved state back with ``fused_sync(state)`` after it.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.islands import IslandConfig
from repro_torch.core.voltage import TechModel, TechSpec


DEFAULT_HISTORY_MAXLEN = 256


@dataclass
class ActuatorState:
    live: IslandConfig
    shadow: Optional[IslandConfig] = None
    swaps: int = 0
    # bounded: long-running controllers commit thousands of swaps; only a
    # recent window is ever inspected, so old entries are evicted FIFO
    history: Deque[Tuple[int, Dict[str, float]]] = field(
        default_factory=lambda: deque(maxlen=DEFAULT_HISTORY_MAXLEN))


class DFSActuator:
    """Dual-buffer, glitch-free island-rate actuator.

    >>> act = DFSActuator(islands)
    >>> act.reconfigure({"noc_mem": 0.5})   # writes the SHADOW buffer
    >>> act.commit()                        # atomic swap between steps
    ``live()`` never observes a half-written config: reconfigure() builds a
    complete new IslandConfig aside, and commit() swaps a single reference
    under a lock (the FSM of the paper, in one CAS).
    """

    def __init__(self, initial: IslandConfig,
                 history_maxlen: int = DEFAULT_HISTORY_MAXLEN):
        self._lock = threading.Lock()
        self._st = ActuatorState(
            live=initial, history=deque(maxlen=history_maxlen))

    @property
    def history_maxlen(self) -> Optional[int]:
        return self._st.history.maxlen

    def live(self) -> IslandConfig:
        with self._lock:
            return self._st.live

    def reconfigure(self, rates: Dict[str, float]) -> IslandConfig:
        """Prepare the shadow buffer; the live config keeps driving."""
        with self._lock:
            base = self._st.live
            self._st.shadow = base.with_rates(rates)
            return self._st.shadow

    def commit(self) -> IslandConfig:
        """Swap shadow -> live (the master/slave MMCM role swap)."""
        with self._lock:
            if self._st.shadow is None:
                return self._st.live
            self._st.live, self._st.shadow = self._st.shadow, None
            self._st.swaps += 1
            self._st.history.append(
                (self._st.live.version,
                 {i.name: i.rate for i in self._st.live.islands}))
            return self._st.live

    def abort(self) -> None:
        """Drop a prepared shadow config without ever exposing it."""
        with self._lock:
            self._st.shadow = None

    @property
    def swaps(self) -> int:
        with self._lock:
            return self._st.swaps

    def history(self) -> List[Tuple[int, Dict[str, float]]]:
        with self._lock:
            return list(self._st.history)


# ---------------------------------------------------------------------------
# Controller policies
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TileTelemetry:
    """Per-tile digest read from the C3 monitor."""
    exec_time: float          # busy seconds (or cycles) in window
    pkts_in: float
    pkts_out: float
    rtt: float
    boundness: float          # T_mem_or_stream / T_total in [0,1]


def policy_memory_bound(islands: IslandConfig,
                        telemetry: Dict[str, TileTelemetry],
                        *, threshold: float = 0.7,
                        low_rate: float = 0.2) -> Dict[str, float]:
    """Fig.-4 policy: drop the clock of islands whose tiles are
    memory/stream-bound past ``threshold`` — their throughput is set by the
    NoC+MEM island, so f_acc barely matters; energy ~ f V(f)^2 drops.
    Never touches the noc_mem island (that's the actual bottleneck)."""
    out: Dict[str, float] = {}
    for isl in islands.islands:
        if isl.fixed or isl.name == "noc_mem":
            continue
        ts = [telemetry[t] for t in isl.tiles if t in telemetry]
        if not ts:
            continue
        b = float(np.mean([t.boundness for t in ts]))
        out[isl.name] = low_rate if b >= threshold else 1.0
    return out


def policy_straggler(islands: IslandConfig,
                     telemetry: Dict[str, TileTelemetry],
                     *, slack: float = 1.3) -> Dict[str, float]:
    """Straggler mitigation: islands whose exec-time exceeds ``slack`` x the
    median run at full rate while everyone else is derated to match — the
    fleet converges to the straggler's pace at minimum energy instead of
    spinning.  (At pod scale the same signal triggers work rebalancing in
    runtime/fault.py; rate-derating is the in-step response.)"""
    med = float(np.median([t.exec_time for t in telemetry.values()])) or 1.0
    out: Dict[str, float] = {}
    for isl in islands.islands:
        if isl.fixed:
            continue
        ts = [telemetry[t] for t in isl.tiles if t in telemetry]
        if not ts:
            continue
        worst = max(t.exec_time for t in ts)
        if worst > slack * med:
            out[isl.name] = 1.0                   # straggler: full speed
        else:
            # derate to just-keep-up: rate ~ own_time / straggler_time
            out[isl.name] = max(0.2, min(1.0, worst / (slack * med)))
    return out


class PIDRatePolicy:
    """PID-style per-island utilization tracking DFS policy.

    Interprets each tile's ``exec_time`` counter as its busy fraction over
    the sample window (what the simulation engine's C3 monitor reports)
    and servos every non-fixed island's rate so the island-mean busy
    fraction tracks ``target``: an underutilized island has headroom, so
    its clock drops (energy ~ f·V(f)^2 falls); a saturated island
    (busy -> 1, queues forming) gets its clock raised back before latency
    escapes.  Unlike :func:`policy_memory_bound` (a model-driven static
    classification) this is a purely measurement-driven feedback loop, so
    it adapts to diurnal/bursty load the model never saw.

    Stateful (per-island integral + previous error) — construct one
    instance per controlled platform.  The returned rates are continuous;
    the actuator's ladder quantization supplies the hysteresis that keeps
    small errors from dithering the clock.
    """

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
        self._integral: Dict[str, float] = {}
        self._prev_err: Dict[str, float] = {}

    def reset(self) -> None:
        self._integral.clear()
        self._prev_err.clear()

    def __call__(self, islands: IslandConfig,
                 telemetry: Dict[str, TileTelemetry]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for isl in islands.islands:
            if isl.fixed or isl.name in self.skip:
                continue
            ts = [telemetry[t] for t in isl.tiles if t in telemetry]
            if not ts:
                continue
            util = float(np.mean([t.exec_time for t in ts]))
            err = util - self.target            # positive => overloaded
            i_term = float(np.clip(self._integral.get(isl.name, 0.0) + err,
                                   -self.integral_clamp, self.integral_clamp))
            d_term = err - self._prev_err.get(isl.name, err)
            self._integral[isl.name] = i_term
            self._prev_err[isl.name] = err
            new = isl.rate + self.kp * err + self.ki * i_term + self.kd * d_term
            out[isl.name] = float(np.clip(new, self.min_rate, 1.0))
        return out


# ---------------------------------------------------------------------------
# Vectorized (multi-design) policies — the batched co-sim counterparts
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Energy-per-token policies over the perf model
# ---------------------------------------------------------------------------


def policy_energy_per_token_sweep(
        islands: IslandConfig,
        perf_eval_batch: Callable[[Dict[str, np.ndarray]],
                                  Tuple[np.ndarray, np.ndarray]],
        *, max_loss: float = 0.02,
        tech: TechSpec = None) -> Dict[str, float]:
    """Exhaustive batched rate search minimizing energy/token.

    The batched counterpart of :func:`policy_energy_per_token`: instead of
    greedy coordinate descent with one scalar ``perf_eval`` call per probe,
    it materializes the full cross-product of every non-fixed island's rate
    ladder as stacked arrays and evaluates all configurations in ONE
    ``perf_eval_batch`` call — ``perf_eval_batch({island: rates_array})
    -> (tokens_per_s_array, watts_array)`` (built on
    ``SoCPerfModel.accel_throughput_batch`` in practice).  Ladders are
    small (9–19 levels), so the exhaustive grid is ~1e4–1e6 points, well
    inside the batched engine's budget, and — unlike coordinate descent —
    it cannot get stuck in a local minimum.

    Returns the rate assignment with the lowest watts/token among points
    whose throughput is within ``max_loss`` of the all-max-rates config.

    ``tech``: optional physical DVFS model (see
    :mod:`repro_torch.core.voltage`); when set, the search grid is restricted
    to each ladder's levels inside the node's legal ``[L, U]`` ratio
    range, so the policy can only propose commits the harness clamp
    would accept.
    """
    tech = TechModel.coerce(tech)
    free = [isl for isl in islands.islands if not isl.fixed]
    if not free:
        return {}
    ladders = [np.asarray(isl.ladder.levels(), dtype=np.float64)
               for isl in free]
    if tech is not None:
        ladders = [lv[tech.legal(lv)] if tech.legal(lv).any() else lv
                   for lv in ladders]
    grids = np.meshgrid(*ladders, indexing="ij")
    flat = {isl.name: g.ravel() for isl, g in zip(free, grids)}
    tps, watts = perf_eval_batch(flat)
    tps = np.asarray(tps, dtype=np.float64)
    watts = np.asarray(watts, dtype=np.float64)
    # baseline = every island at its max ladder level (flat index computed
    # explicitly: a ladder whose step doesn't divide its range never
    # contains f/f_max == 1.0 as its last level)
    base_idx = np.ravel_multi_index(
        tuple(int(np.argmax(lv)) for lv in ladders),
        tuple(lv.shape[0] for lv in ladders))
    base_tps = tps[base_idx]
    feasible = tps >= (1.0 - max_loss) * base_tps
    ept = np.where(feasible, watts / np.maximum(tps, 1e-9), np.inf)
    best = int(np.argmin(ept))
    return {isl.name: float(flat[isl.name][best]) for isl in free}


def policy_energy_per_token(islands: IslandConfig,
                            telemetry: Dict[str, TileTelemetry],
                            perf_eval: Callable[[Dict[str, float]], Tuple[float, float]],
                            *, steps: int = 25,
                            tech: TechSpec = None) -> Dict[str, float]:
    """Greedy coordinate-descent over the discrete rate ladders minimizing
    energy/token subject to <2% throughput loss vs all-max rates.
    ``perf_eval(rates) -> (tokens_per_s, watts)`` comes from core/perfmodel.
    ``tech``: optional physical DVFS model — probe levels outside the
    node's legal ``[L, U]`` ratio range are skipped (the harness clamp
    would reject them anyway).
    """
    tech = TechModel.coerce(tech)
    rates = {i.name: i.rate for i in islands.islands if not i.fixed}
    base_tps, _ = perf_eval({**rates, **{k: 1.0 for k in rates}})
    best = dict(rates)
    best_tps, best_w = perf_eval(best)
    for _ in range(steps):
        improved = False
        for isl in islands.islands:
            if isl.fixed:
                continue
            for lv in isl.ladder.levels():
                if tech is not None and not tech.legal(lv):
                    continue
                cand = dict(best)
                cand[isl.name] = lv
                tps, w = perf_eval(cand)
                if tps >= 0.98 * base_tps and (w / max(tps, 1e-9)) < (
                        best_w / max(best_tps, 1e-9)) * 0.999:
                    best, best_tps, best_w = cand, tps, w
                    improved = True
        if not improved:
            break
    return best
