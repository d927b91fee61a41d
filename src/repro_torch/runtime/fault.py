"""Online fault detection for the closed-loop co-sim of the port.

:class:`SimFaultSupervisor` watches the simulator's per-tick observables
(served work, backlog, masked capacity) through an
:class:`OnlineFaultDetector` and maintains a **believed** availability mask:
the sequential ``SimEngine`` routes recovery traffic on the supervisor's
*detected* state rather than the injected oracle mask, so detection latency
(a few ticks of mis-routed work) is part of what the scenario gates measure.

The detector and the supervisor's :meth:`~SimFaultSupervisor.observe` are
host NumPy, as in the reference package.  Inside the engine's tick loop the
same state machine runs on the engine's tensors instead
(:meth:`~SimFaultSupervisor.begin_device_run` /
:meth:`~SimFaultSupervisor.observe_device` /
:meth:`~SimFaultSupervisor.end_device_run`): streaks, the believed-dead mask
and the straggler streaks stay on the device, each tick's believed-dead and
straggler-persist masks go into ``(T, A)`` histories, and the event list is
rebuilt from them after the loop — no value goes to the host per tick.

The trainer half (``FaultConfig`` / ``FaultSupervisor``, the reference's
first half) wraps a ``runtime.train.Trainer``: a NaN loss in the logged
metrics restarts it from the latest complete checkpoint, whose
counter-based data stream makes the replay exact; a straggler in the C3
telemetry derates the other islands through the DFS actuator's hitless
commit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dfs import DFSActuator, TileTelemetry, \
    policy_straggler
from repro_torch.core.islands import IslandConfig


@dataclass
class FaultConfig:
    step_timeout_s: float = 300.0
    nan_tolerance: int = 0           # consecutive NaN losses allowed
    straggler_slack: float = 1.3
    max_restarts: int = 5


@dataclass
class FaultEvent:
    step: int
    kind: str                        # timeout | nan | node_loss | straggler
    detail: str = ""


class FaultSupervisor:
    """Wraps a Trainer-like object with detection + recovery."""

    def __init__(self, trainer, fc: Optional[FaultConfig] = None):
        self.trainer = trainer
        self.fc = fc or FaultConfig()
        self.events: List[FaultEvent] = []
        self._nan_streak = 0
        self.restarts = 0

    # -------------------------------------------------------------- detect
    def check_metrics(self, step: int, metrics: Dict[str, float]
                      ) -> Optional[str]:
        loss = metrics.get("loss", 0.0)
        if not math.isfinite(loss):
            self._nan_streak += 1
            if self._nan_streak > self.fc.nan_tolerance:
                return "nan"
        else:
            self._nan_streak = 0
        return None

    def check_stragglers(self, telemetry: Dict[str, TileTelemetry],
                         islands: IslandConfig, actuator: DFSActuator
                         ) -> Optional[Dict[str, float]]:
        """Derate-to-match policy; returns the applied rates (or None)."""
        if not telemetry:
            return None
        times = [t.exec_time for t in telemetry.values()]
        med = float(np.median(times))
        if med <= 0 or max(times) <= self.fc.straggler_slack * med:
            return None
        rates = policy_straggler(islands, telemetry,
                                 slack=self.fc.straggler_slack)
        actuator.reconfigure(rates)          # shadow buffer
        actuator.commit()                    # hitless swap between steps
        self.events.append(FaultEvent(
            getattr(self.trainer, "step", -1), "straggler", str(rates)))
        return rates

    # -------------------------------------------------------------- recover
    def recover(self) -> int:
        """Restore the latest complete checkpoint; returns the resume step."""
        if self.restarts >= self.fc.max_restarts:
            raise RuntimeError("restart budget exhausted")
        self.restarts += 1
        self.trainer.restore()
        self.events.append(FaultEvent(self.trainer.step, "restart"))
        return self.trainer.step

    def run_supervised(self, steps: int
                       ) -> List[Tuple[int, Dict[str, float]]]:
        """Training loop with NaN detection and auto-restart."""
        done = 0
        history: List[Tuple[int, Dict[str, float]]] = []
        while done < steps:
            try:
                hist = self.trainer.run(1)
            except FloatingPointError as e:   # pragma: no cover
                self.events.append(FaultEvent(self.trainer.step, "nan",
                                              str(e)))
                self.recover()
                continue
            done += 1
            for s, m in hist:
                history.append((s, m))
                kind = self.check_metrics(s, m)
                if kind:
                    self.events.append(FaultEvent(s, kind))
                    self.recover()
        return history


@dataclass(frozen=True)
class SimFaultConfig:
    """Detector thresholds for :class:`OnlineFaultDetector`.

    ``dead_ticks`` consecutive ticks of (zero capacity + standing backlog +
    nothing served) declare a tile dead; recovery (capacity observed again)
    clears the belief immediately.  ``min_backlog`` filters idle tiles — a
    healthy tile with no work also serves nothing, and must not be declared
    dead.  ``straggler_slack`` flags busy skew (advisory events, no mask
    change); a tile must hold the skew for ``straggler_ticks`` consecutive
    ticks before it is flagged, so per-tick Poisson flicker never reaches
    the event log."""
    dead_ticks: int = 3
    min_backlog: float = 1e-9
    straggler_slack: float = 1.3
    straggler_ticks: int = 25


class OnlineFaultDetector:
    """Vectorized dead-tile detection from per-tick sim observables.

    Pure observation: never sees the injected schedule.  A tile is
    *suspected* while ``cap <= 0`` and ``queue > min_backlog`` and
    ``served <= 0``; ``dead_ticks`` consecutive suspect ticks latch the dead
    belief, and any tick with observable capacity clears it (the revive
    probe — a revived tile's nominal capacity is visible even before traffic
    is routed back to it)."""

    def __init__(self, n_tiles: int, config: Optional[SimFaultConfig] = None):
        self.config = config or SimFaultConfig()
        self._streak = np.zeros(n_tiles, dtype=np.int64)
        self._dead = np.zeros(n_tiles, dtype=bool)

    @property
    def believed_dead(self) -> np.ndarray:
        return self._dead.copy()

    def observe(self, served: np.ndarray, queue: np.ndarray,
                cap: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One tick's observables -> (newly_dead, newly_alive) masks."""
        c = self.config
        suspect = (np.asarray(cap) <= 0.0) & \
                  (np.asarray(queue) > c.min_backlog) & \
                  (np.asarray(served) <= 0.0)
        self._streak = np.where(suspect, self._streak + 1, 0)
        has_cap = np.asarray(cap) > 0.0
        dead_now = (self._dead | (self._streak >= c.dead_ticks)) & ~has_cap
        newly_dead = dead_now & ~self._dead
        newly_alive = self._dead & ~dead_now
        self._dead = dead_now
        return newly_dead, newly_alive


class _DeviceRun:
    """The detector and straggler state of one engine run, on the device,
    and the per-tick histories the events are rebuilt from."""

    def __init__(self, n_tiles: int, ticks: int, device):
        A, T = n_tiles, ticks
        self.streak = torch.zeros(A, dtype=torch.int64, device=device)
        self.dead = torch.zeros(A, dtype=torch.bool, device=device)
        self.skew = torch.zeros(A, dtype=torch.int64, device=device)
        self.alive = torch.ones(A, dtype=torch.float64, device=device)
        self.dead_hist = torch.zeros((T, A), dtype=torch.bool, device=device)
        self.persist_hist = torch.zeros((T, A), dtype=torch.bool,
                                        device=device)
        self.updated_hist = torch.zeros(T, dtype=torch.bool, device=device)
        self.ticks = 0


class SimFaultSupervisor:
    """Online detection/recovery harness for the sequential sim engine.

    Pass as ``SimEngine(..., supervisor=...)``: each tick the engine feeds
    the detector and routes re-spill/splits on ``believed_alive`` instead of
    the oracle mask — stranded work keeps flowing to a dead replica for the
    detector's latency window and is only then re-spilled.  Also flags
    busy-skew stragglers (advisory telemetry events)."""

    def __init__(self, config: Optional[SimFaultConfig] = None):
        self.config = config or SimFaultConfig()
        self.detector: Optional[OnlineFaultDetector] = None
        self.events: List[Dict[str, object]] = []
        self._names: Tuple[str, ...] = ()
        self._last_skew: frozenset = frozenset()
        self._skew_streak: Optional[np.ndarray] = None
        self._run: Optional[_DeviceRun] = None

    def begin_run(self, names) -> None:
        self._names = tuple(names)
        self.detector = OnlineFaultDetector(len(self._names), self.config)
        self.events = []
        self._last_skew = frozenset()
        self._skew_streak = np.zeros(len(self._names), dtype=np.int64)
        self._run = None

    @property
    def believed_alive(self) -> np.ndarray:
        assert self.detector is not None, "begin_run not called"
        return 1.0 - self.detector.believed_dead.astype(np.float64)

    def _tile_event(self, tick: int, kind: str, mask) -> Dict[str, object]:
        tiles = [self._names[i] for i in np.nonzero(mask)[0]]
        return {"tick": int(tick), "kind": kind,
                "subject": ",".join(tiles), "tiles": tiles}

    def observe(self, tick: int, *, served, queue, cap,
                busy=None) -> List[Dict[str, object]]:
        """One tick's observables (host arrays); returns event dicts (also
        retained on ``self.events``)."""
        assert self.detector is not None, "begin_run not called"
        newly_dead, newly_alive = self.detector.observe(served, queue, cap)
        out: List[Dict[str, object]] = []
        for mask, kind in ((newly_dead, "detected_dead"),
                           (newly_alive, "detected_alive")):
            if mask.any():
                out.append(self._tile_event(tick, kind, mask))
        if busy is not None:
            b = np.asarray(busy, dtype=np.float64)
            live = ~self.detector.believed_dead
            if live.sum() >= 2:
                med = float(np.median(b[live]))
                raw = (med > 0) & live & (b > self.config.straggler_slack
                                          * max(med, 1e-9))
                self._skew_streak = np.where(raw, self._skew_streak + 1, 0)
                persist = self._skew_streak >= self.config.straggler_ticks
                cur = frozenset(np.nonzero(persist)[0].tolist())
                # emit only persistent skew, and only on set changes —
                # per-tick Poisson flicker would flood a long soak's log
                if cur and cur != self._last_skew:
                    out.append(self._tile_event(tick, "straggler_suspect",
                                                persist))
                self._last_skew = cur
        self.events.extend(out)
        return out

    # ------------------------------------------------- inside the tick loop
    def begin_device_run(self, names, ticks: int, device) -> None:
        """Start a run whose observations arrive as tensors on ``device``
        (:meth:`observe_device`), for ``ticks`` ticks at most."""
        self.begin_run(names)
        self._run = _DeviceRun(len(self._names), ticks, device)

    @property
    def believed_alive_device(self) -> torch.Tensor:
        """``(A,)`` float64 believed availability on the run's device, the
        mask routing reads at the start of the next tick."""
        assert self._run is not None, "begin_device_run not called"
        return self._run.alive

    def observe_device(  # repro: hot
            self, tick: int, *, served: torch.Tensor, queue: torch.Tensor,
            cap: torch.Tensor, busy: torch.Tensor) -> None:
        """:meth:`observe` on ``(A,)`` float64 tensors, without a value
        going to the host: the detector and straggler state update on the
        device and the tick's masks are recorded for
        :meth:`end_device_run`."""
        r, c = self._run, self.config
        suspect = (cap <= 0.0) & (queue > c.min_backlog) & (served <= 0.0)
        r.streak = torch.where(suspect, r.streak + 1, 0)
        r.dead = (r.dead | (r.streak >= c.dead_ticks)) & ~(cap > 0.0)
        live = ~r.dead
        r.alive = 1.0 - r.dead.to(torch.float64)
        # NumPy's median of the live tiles: dead tiles sorted after every
        # live one (to +inf), then the mean of the two middle values of
        # the live count (one value twice for an odd count); torch.median
        # would take the lower middle value of an even count
        n = live.sum()
        srt = torch.sort(torch.where(live, busy, torch.inf)).values
        lo = torch.clamp((n - 1) // 2, min=0)
        mid = torch.stack([lo, n // 2])
        pair = srt[mid]
        med = (pair[0] + pair[1]) / 2.0
        raw = (med > 0) & live & (busy > c.straggler_slack
                                  * torch.clamp(med, min=1e-9))
        ok = n >= 2
        r.skew = torch.where(ok, torch.where(raw, r.skew + 1, 0), r.skew)
        r.dead_hist[tick] = r.dead
        r.persist_hist[tick] = r.skew >= c.straggler_ticks
        r.updated_hist[tick] = ok
        r.ticks = tick + 1

    def end_device_run(self) -> List[Dict[str, object]]:
        """Finish a device run: one copy of its histories, the events the
        host :meth:`observe` would have returned tick by tick (kept on
        ``self.events``, tick order), and the final detector state on the
        host.  Returns the events."""
        r = self._run
        T = r.ticks
        dead = r.dead_hist[:T].cpu().numpy()
        persist = r.persist_hist[:T].cpu().numpy()
        updated = r.updated_hist[:T].cpu().numpy()
        before = np.concatenate([np.zeros((1, dead.shape[1]), dtype=bool),
                                 dead[:-1]])
        newly_dead, newly_alive = dead & ~before, before & ~dead
        # the persist set of every tick whose straggler state updated,
        # against the previous such tick's (the empty set first)
        upd = np.nonzero(updated)[0]
        prev = np.concatenate([np.zeros((1, dead.shape[1]), dtype=bool),
                               persist[upd][:-1]])
        emit = np.zeros(T, dtype=bool)
        emit[upd] = (persist[upd].any(axis=-1)
                     & (persist[upd] != prev).any(axis=-1))
        events = []
        for t in np.nonzero(newly_dead.any(axis=-1) | newly_alive.any(axis=-1)
                            | emit)[0]:
            for mask, kind in ((newly_dead[t], "detected_dead"),
                               (newly_alive[t], "detected_alive")):
                if mask.any():
                    events.append(self._tile_event(t, kind, mask))
            if emit[t]:
                events.append(self._tile_event(t, "straggler_suspect",
                                               persist[t]))
        self.events = events
        # the host state as the tick-by-tick observe would leave it
        self.detector._dead = r.dead.cpu().numpy().copy()
        self.detector._streak = r.streak.cpu().numpy().copy()
        self._skew_streak = r.skew.cpu().numpy().copy()
        if upd.size:
            self._last_skew = frozenset(
                np.nonzero(persist[upd[-1]])[0].tolist())
        self._run = None
        return events
