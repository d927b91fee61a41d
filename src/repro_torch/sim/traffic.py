"""Arrival-trace generators for the closed-loop SoC simulation.

A :class:`Trace` is the whole workload of a simulation run as one dense
``(ticks, n_dests)`` array of request arrivals per tick per destination
accelerator tile — the tick-aggregated form the vectorized engine consumes
directly (no per-request Python objects, so a million-request trace is a
few MB of float64).  Counts are *fluid* (fractional requests are fine);
generators that sample a point process produce integer counts.

Generators compose: every one returns a :class:`Trace`, and
:func:`superpose` / :meth:`Trace.scaled` / :func:`with_total` combine or
rescale them, so "diurnal baseline + bursty hotspot on tile 3, normalized
to exactly 1M requests" is three calls.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class Trace:
    """Tick-aggregated arrivals: ``arrivals[t, a]`` requests arrive at
    destination tile ``a`` during tick ``t``; one tick is ``dt`` seconds."""
    arrivals: np.ndarray            # (ticks, n_dests) float64, >= 0
    dt: float                       # seconds per tick

    def __post_init__(self):
        a = np.asarray(self.arrivals, dtype=np.float64)
        assert a.ndim == 2, "arrivals must be (ticks, n_dests)"
        object.__setattr__(self, "arrivals", a)

    @property
    def ticks(self) -> int:
        return int(self.arrivals.shape[0])

    @property
    def n_dests(self) -> int:
        return int(self.arrivals.shape[1])

    @property
    def n_requests(self) -> float:
        return float(self.arrivals.sum())

    @property
    def duration_s(self) -> float:
        return self.ticks * self.dt

    @property
    def offered_rps(self) -> float:
        """Mean offered load over the whole trace, requests/second."""
        return self.n_requests / self.duration_s if self.ticks else 0.0

    def scaled(self, factor: float) -> "Trace":
        return replace(self, arrivals=self.arrivals * float(factor))

    def window(self, start: int, stop: int) -> "Trace":
        return replace(self, arrivals=self.arrivals[start:stop])


@dataclass(frozen=True)
class BatchTrace:
    """Per-design arrival tensor for the batched co-sim engine.

    ``arrivals[t, b, a]`` requests arrive at tile ``a`` of design ``b``
    during tick ``t`` — every stacked design can replay its *own*
    workload in the one batched run (heterogeneous trace seeds, per-design
    rate scaling, recorded logs per candidate).  :meth:`broadcast` lifts a
    shared :class:`Trace` to the batch shape as a zero-copy view; the
    engine's elementwise tick math makes the broadcast replay bit-for-bit
    identical to passing the shared trace directly (tested).
    """
    arrivals: np.ndarray            # (ticks, n_designs, n_dests) >= 0
    dt: float

    def __post_init__(self):
        a = np.asarray(self.arrivals, dtype=np.float64)
        assert a.ndim == 3, "arrivals must be (ticks, n_designs, n_dests)"
        object.__setattr__(self, "arrivals", a)

    @property
    def ticks(self) -> int:
        return int(self.arrivals.shape[0])

    @property
    def n_designs(self) -> int:
        return int(self.arrivals.shape[1])

    @property
    def n_dests(self) -> int:
        return int(self.arrivals.shape[2])

    @property
    def duration_s(self) -> float:
        return self.ticks * self.dt

    @property
    def n_requests(self) -> np.ndarray:
        """Per-design offered totals, shape ``(n_designs,)``."""
        return self.arrivals.sum(axis=(0, 2))

    @classmethod
    def broadcast(cls, trace: Trace, n_designs: int) -> "BatchTrace":
        """Share one (T, A) trace across B designs (no copy)."""
        a = np.broadcast_to(trace.arrivals[:, None, :],
                            (trace.ticks, int(n_designs), trace.n_dests))
        return cls(a, trace.dt)

    @classmethod
    def stack(cls, traces: Sequence[Trace]) -> "BatchTrace":
        """One per-design trace each (same dt/ticks/destinations)."""
        assert traces, "need at least one trace"
        t0 = traces[0]
        for t in traces[1:]:
            assert abs(t.dt - t0.dt) < 1e-12, "dt mismatch"
            assert t.arrivals.shape == t0.arrivals.shape, "shape mismatch"
        return cls(np.stack([t.arrivals for t in traces], axis=1), t0.dt)

    def design(self, b: int) -> Trace:
        """Design ``b``'s own (T, A) trace (the differential-test path)."""
        return Trace(self.arrivals[:, b, :].copy(), self.dt)

    def scaled(self, factor) -> "BatchTrace":
        """Scale by a scalar or per-design ``(n_designs,)`` factor."""
        f = np.asarray(factor, dtype=np.float64)
        if f.ndim == 1:
            f = f[None, :, None]
        return replace(self, arrivals=self.arrivals * f)


def _per_dest_rate(rate_rps, n_dests: int) -> np.ndarray:
    """Broadcast a scalar (total, split evenly) or per-dest rate vector."""
    r = np.asarray(rate_rps, dtype=np.float64)
    if r.ndim == 0:
        return np.full(n_dests, float(r) / n_dests)
    assert r.shape == (n_dests,), (r.shape, n_dests)
    return r


def constant_trace(rate_rps, ticks: int, n_dests: int,
                   *, dt: float = 1e-3) -> Trace:
    """Deterministic constant-rate fluid arrivals (the parity workload:
    no sampling noise, so steady-state throughput is exactly comparable
    to the static perf-model prediction)."""
    per = _per_dest_rate(rate_rps, n_dests) * dt
    return Trace(np.broadcast_to(per, (ticks, n_dests)).copy(), dt)


def poisson_trace(rate_rps, ticks: int, n_dests: int, *, dt: float = 1e-3,
                  seed: int = 0) -> Trace:
    """Homogeneous Poisson arrivals, sampled per (tick, dest)."""
    rng = np.random.default_rng(seed)
    lam = np.broadcast_to(_per_dest_rate(rate_rps, n_dests) * dt,
                          (ticks, n_dests))
    return Trace(rng.poisson(lam).astype(np.float64), dt)


def diurnal_trace(mean_rps, ticks: int, n_dests: int, *, dt: float = 1e-3,
                  period_ticks: Optional[int] = None, depth: float = 0.6,
                  phase: float = 0.0, seed: int = 0) -> Trace:
    """Sinusoid-modulated Poisson arrivals — the "millions of users" daily
    load curve.  Rate swings between ``mean*(1-depth)`` and
    ``mean*(1+depth)`` over ``period_ticks`` (default: the whole trace is
    one day)."""
    assert 0.0 <= depth < 1.0
    rng = np.random.default_rng(seed)
    period = period_ticks or ticks
    t = np.arange(ticks, dtype=np.float64)
    mod = 1.0 + depth * np.sin(2.0 * np.pi * t / period + phase)
    lam = mod[:, None] * _per_dest_rate(mean_rps, n_dests)[None, :] * dt
    return Trace(rng.poisson(lam).astype(np.float64), dt)


def mmpp_trace(low_rps, high_rps, ticks: int, n_dests: int, *,
               dt: float = 1e-3, p_low_to_high: float = 0.01,
               p_high_to_low: float = 0.05, seed: int = 0) -> Trace:
    """Bursty arrivals: a two-state Markov-modulated Poisson process.

    The modulating chain flips between a low-rate and a high-rate state
    with per-tick switch probabilities; dwell times are geometric, so the
    trace alternates quiet stretches with request storms — the tail-latency
    stress test a sinusoid can't provide."""
    rng = np.random.default_rng(seed)
    # sample alternating geometric run lengths until the horizon is covered
    state = np.empty(ticks, dtype=bool)          # True = high
    pos, cur = 0, False
    while pos < ticks:
        p = p_low_to_high if not cur else p_high_to_low
        run = int(rng.geometric(min(max(p, 1e-9), 1.0)))
        state[pos:pos + run] = cur
        pos += run
        cur = not cur
    lo = _per_dest_rate(low_rps, n_dests)
    hi = _per_dest_rate(high_rps, n_dests)
    lam = np.where(state[:, None], hi[None, :], lo[None, :]) * dt
    return Trace(rng.poisson(lam).astype(np.float64), dt)


def replay_trace(arrival_times_s: Sequence[float], dest_ids: Sequence[int],
                 n_dests: int, *, dt: float = 1e-3,
                 ticks: Optional[int] = None) -> Trace:
    """Bin a recorded request log (per-request timestamps + destination
    ids) into the tick grid: one ``bincount`` — millions of log lines
    collapse to the dense (ticks, n_dests) form with no Python loop."""
    t = np.asarray(arrival_times_s, dtype=np.float64)
    d = np.asarray(dest_ids, dtype=np.int64)
    assert t.shape == d.shape
    tick = np.floor(t / dt).astype(np.int64)
    T = int(ticks if ticks is not None else (tick.max() + 1 if t.size else 0))
    keep = (tick >= 0) & (tick < T) & (d >= 0) & (d < n_dests)
    flat = tick[keep] * n_dests + d[keep]
    counts = np.bincount(flat, minlength=T * n_dests).astype(np.float64)
    return Trace(counts.reshape(T, n_dests), dt)


def superpose(*traces: Trace) -> Trace:
    """Sum several traces (same dt; shorter ones are zero-padded)."""
    assert traces
    dt = traces[0].dt
    assert all(abs(tr.dt - dt) < 1e-12 for tr in traces), "dt mismatch"
    n_dests = max(tr.n_dests for tr in traces)
    ticks = max(tr.ticks for tr in traces)
    out = np.zeros((ticks, n_dests))
    for tr in traces:
        out[:tr.ticks, :tr.n_dests] += tr.arrivals
    return Trace(out, dt)


def with_total(trace: Trace, n_requests: float) -> Trace:
    """Rescale a trace so its total request count is exactly
    ``n_requests`` (fluid counts; shape of the load curve is preserved)."""
    total = trace.n_requests
    assert total > 0, "cannot rescale an empty trace"
    return trace.scaled(float(n_requests) / total)
