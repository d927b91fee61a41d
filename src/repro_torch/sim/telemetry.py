"""Ring-buffer time series for the closed-loop simulation (host NumPy).

The engine records one row per telemetry interval into fixed-capacity
numpy ring buffers (no unbounded growth on million-tick soaks): per-island
frequency, per-tile queue depth, busy fraction, worst/mean link
utilization, completion throughput, instantaneous power and a windowed
latency estimate.  The whole recording can be exported as JSON for offline
plotting/CI diffing.  The batched engine's ``"torch"`` backend records into
device rings while it runs and fills a :class:`BatchTelemetry` with one
copy at the end (``sim/batch.py``).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _json_safe(obj):
    """Recursively convert NumPy scalars/arrays (and tuples/sets) into
    plain JSON-serializable Python values.  Event payloads routinely carry
    ``np.float64``/``np.int64`` leaves (island rates, drop totals), which
    ``json.dumps`` rejects — every export path routes through this."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _json_safe(obj.tolist())
    if isinstance(obj, np.generic):        # np.float64, np.int64, np.bool_
        return obj.item()
    return obj


class RingBuffer:
    """Fixed-capacity append-only buffer of fixed-shape float rows.

    ``width`` is an int for the classic ``(width,)`` rows, or a shape
    tuple — the batched telemetry stores ``(B, width)`` rows, one slice
    per design point.  ``array()`` returns rows in chronological order;
    once more than ``capacity`` rows have been appended the oldest are
    overwritten.
    """

    def __init__(self, capacity: int, width=1):
        row_shape = (int(width),) if np.isscalar(width) else tuple(
            int(w) for w in width)
        assert capacity > 0 and all(w > 0 for w in row_shape)
        self._buf = np.zeros((capacity, *row_shape), dtype=np.float64)
        self._n = 0                     # total rows ever appended

    @property
    def capacity(self) -> int:
        return self._buf.shape[0]

    @property
    def width(self) -> int:
        return self._buf.shape[-1]

    @property
    def row_shape(self) -> Tuple[int, ...]:
        return self._buf.shape[1:]

    @property
    def total_appended(self) -> int:
        return self._n

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def append(self, row) -> None:
        self._buf[self._n % self.capacity] = row
        self._n += 1

    def array(self) -> np.ndarray:
        """(len, width) rows, oldest first (copies out of the ring)."""
        cap = self.capacity
        if self._n <= cap:
            return self._buf[:self._n].copy()
        cut = self._n % cap
        return np.concatenate([self._buf[cut:], self._buf[:cut]], axis=0)

    def last(self) -> np.ndarray:
        assert self._n > 0, "empty ring buffer"
        return self._buf[(self._n - 1) % self.capacity].copy()

    def fill(self, slots: np.ndarray, total_appended: int) -> None:
        """Take over a recording made elsewhere (the engine's device
        rings): ``slots`` are the ring's first ``min(total_appended,
        capacity)`` slots as that recorder left them."""
        n = slots.shape[0]
        assert n == min(int(total_appended), self.capacity)
        self._buf[:n] = slots
        self._n = int(total_appended)


@dataclass(frozen=True)
class TelemetrySchema:
    """Names giving meaning to the vector channels."""
    islands: Tuple[str, ...]
    tiles: Tuple[str, ...]


class Telemetry:
    """The engine's flight recorder: one row per telemetry interval."""

    SCALARS = ("tick", "f_noc", "throughput_rps", "power_w",
               "link_util_max", "link_util_mean", "latency_est_s",
               "dropped", "dropped_slo", "dropped_fault", "retried")

    def __init__(self, schema: TelemetrySchema, *, capacity: int = 4096):
        self.schema = schema
        self.scalars = RingBuffer(capacity, len(self.SCALARS))
        self.island_rates = RingBuffer(capacity, len(schema.islands))
        self.queue_depth = RingBuffer(capacity, len(schema.tiles))
        self.busy = RingBuffer(capacity, len(schema.tiles))
        self.events: List[Dict[str, object]] = []   # controller commits etc.

    def record(self, *, tick: int, f_noc: float, island_rates,
               queue_depth, busy, throughput_rps: float, power_w: float,
               link_util_max: float, link_util_mean: float,
               latency_est_s: float, dropped: float = 0.0,
               dropped_slo: float = 0.0, dropped_fault: float = 0.0,
               retried: float = 0.0) -> None:
        """One interval's row; the drop/retry channels are *cumulative*
        run totals at recording time (fault-free runs record zeros)."""
        self.scalars.append([tick, f_noc, throughput_rps, power_w,
                             link_util_max, link_util_mean, latency_est_s,
                             dropped, dropped_slo, dropped_fault, retried])
        self.island_rates.append(island_rates)
        self.queue_depth.append(queue_depth)
        self.busy.append(busy)

    def event(self, tick: int, kind: str, **payload) -> None:
        self.events.append({"tick": int(tick), "kind": kind, **payload})

    # ---------------------------------------------------------- accessors
    def series(self, name: str) -> np.ndarray:
        """One scalar channel as a 1-D chronological array."""
        return self.scalars.array()[:, self.SCALARS.index(name)]

    def island_rate_series(self, island: str) -> np.ndarray:
        return self.island_rates.array()[:, self.schema.islands.index(island)]

    def queue_series(self, tile: str) -> np.ndarray:
        return self.queue_depth.array()[:, self.schema.tiles.index(tile)]

    # ------------------------------------------------------------- export
    def to_dict(self) -> Dict[str, object]:
        sc = self.scalars.array()
        return {
            "schema": {"islands": list(self.schema.islands),
                       "tiles": list(self.schema.tiles)},
            "scalars": {n: sc[:, i].tolist()
                        for i, n in enumerate(self.SCALARS)},
            "island_rates": self.island_rates.array().tolist(),
            "queue_depth": self.queue_depth.array().tolist(),
            "busy": self.busy.array().tolist(),
            "events": _json_safe(self.events),
            "rows_recorded": self.scalars.total_appended,
        }

    def to_json(self, path: Optional[str] = None, *, indent: int = 2) -> str:
        doc = json.dumps(self.to_dict(), indent=indent)
        if path is not None:
            with open(path, "w") as f:
                f.write(doc + "\n")
        return doc

    def summary(self) -> str:
        if len(self.scalars) == 0:
            return "(no telemetry)"
        sc = self.scalars.array()
        thr = sc[:, self.SCALARS.index("throughput_rps")]
        pw = sc[:, self.SCALARS.index("power_w")]
        lu = sc[:, self.SCALARS.index("link_util_max")]
        return (f"{len(self.scalars)} samples "
                f"(of {self.scalars.total_appended} recorded): "
                f"thr mean {thr.mean():,.0f} rps, power mean {pw.mean():.0f} W, "
                f"worst link util p99 {np.percentile(lu, 99):.2f}, "
                f"{len(self.events)} events")


class BatchTelemetry:
    """Per-design flight recorder for the batched co-sim engine.

    Mirrors :class:`Telemetry`, but every channel carries a leading
    design axis: one ``record()`` appends a ``(B, ...)`` row per ring, so
    B design points share one set of fixed-capacity buffers instead of B
    Python-object recorders.  ``design(b)`` slices out one design's view
    with the same array layout the sequential :class:`Telemetry` exposes
    (the B=1 differential tests compare them elementwise).
    """

    SCALARS = Telemetry.SCALARS

    def __init__(self, schema: TelemetrySchema, n_designs: int, *,
                 capacity: int = 4096):
        assert n_designs > 0
        self.schema = schema
        self.n_designs = int(n_designs)
        self.scalars = RingBuffer(capacity, (n_designs, len(self.SCALARS)))
        self.island_rates = RingBuffer(capacity,
                                       (n_designs, len(schema.islands)))
        self.queue_depth = RingBuffer(capacity, (n_designs, len(schema.tiles)))
        self.busy = RingBuffer(capacity, (n_designs, len(schema.tiles)))
        self.events: List[Dict[str, object]] = []

    def record(self, *, tick: int, f_noc, island_rates, queue_depth, busy,
               throughput_rps, power_w, link_util_max, link_util_mean,
               latency_est_s, dropped=0.0, dropped_slo=0.0,
               dropped_fault=0.0, retried=0.0) -> None:
        """One telemetry interval: scalar channels are (B,) arrays (or
        scalars, broadcast), vector channels (B, I)/(B, A).  Drop/retry
        channels are cumulative per-design run totals, as sequential."""
        B = self.n_designs
        row = np.empty((B, len(self.SCALARS)))
        for i, ch in enumerate((tick, f_noc, throughput_rps, power_w,
                                link_util_max, link_util_mean,
                                latency_est_s, dropped, dropped_slo,
                                dropped_fault, retried)):
            row[:, i] = ch
        self.scalars.append(row)
        self.island_rates.append(np.broadcast_to(
            island_rates, self.island_rates.row_shape))
        self.queue_depth.append(np.broadcast_to(
            queue_depth, self.queue_depth.row_shape))
        self.busy.append(np.broadcast_to(busy, self.busy.row_shape))

    def event(self, tick: int, kind: str, **payload) -> None:
        self.events.append({"tick": int(tick), "kind": kind, **payload})

    @classmethod
    def concat(cls, parts: Sequence["BatchTelemetry"], n_designs: int,
               events=()) -> "BatchTelemetry":
        """The recordings of the shards of a design axis (same rows, same
        capacity) joined in order along it, cut to the first ``n_designs``
        (the shards' pad dropped), with the event log ``events``."""
        p0 = parts[0]
        out = cls(p0.schema, n_designs, capacity=p0.scalars.capacity)
        for name in ("scalars", "island_rates", "queue_depth", "busy"):
            rings = [getattr(p, name) for p in parts]
            n = len(rings[0])
            slots = np.concatenate([r._buf[:n] for r in rings], axis=1)
            getattr(out, name).fill(slots[:, :n_designs],
                                    rings[0].total_appended)
        out.events = list(events)
        return out

    # ---------------------------------------------------------- accessors
    def series(self, name: str) -> np.ndarray:
        """One scalar channel as a (rows, B) chronological array."""
        return self.scalars.array()[..., self.SCALARS.index(name)]

    def design(self, b: int) -> Dict[str, np.ndarray]:
        """One design's recording, keyed like :meth:`Telemetry.to_dict`'s
        array channels (chronological, design axis sliced away)."""
        sc = self.scalars.array()[:, b, :]
        return {
            "scalars": {n: sc[:, i] for i, n in enumerate(self.SCALARS)},
            "island_rates": self.island_rates.array()[:, b, :],
            "queue_depth": self.queue_depth.array()[:, b, :],
            "busy": self.busy.array()[:, b, :],
        }

    # ------------------------------------------------------------- export
    def to_dict(self) -> Dict[str, object]:
        sc = self.scalars.array()
        return {
            "schema": {"islands": list(self.schema.islands),
                       "tiles": list(self.schema.tiles),
                       "n_designs": self.n_designs},
            "scalars": {n: sc[..., i].tolist()
                        for i, n in enumerate(self.SCALARS)},
            "island_rates": self.island_rates.array().tolist(),
            "queue_depth": self.queue_depth.array().tolist(),
            "busy": self.busy.array().tolist(),
            "events": _json_safe(self.events),
            "rows_recorded": self.scalars.total_appended,
        }

    def to_json(self, path: Optional[str] = None, *, indent: int = 2) -> str:
        doc = json.dumps(self.to_dict(), indent=indent)
        if path is not None:
            with open(path, "w") as f:
                f.write(doc + "\n")
        return doc

    def summary(self) -> str:
        if len(self.scalars) == 0:
            return "(no telemetry)"
        thr = self.series("throughput_rps")
        pw = self.series("power_w")
        return (f"{len(self.scalars)} samples x {self.n_designs} designs "
                f"(of {self.scalars.total_appended} recorded): "
                f"thr mean {thr.mean():,.0f} rps, "
                f"power mean {pw.mean():.0f} W, "
                f"{len(self.events)} events")


def weighted_percentiles(values: np.ndarray, weights: np.ndarray,
                         qs: Sequence[float]) -> np.ndarray:
    """Percentiles of a weighted sample (weights = request counts per
    latency bin) — how per-tick aggregated latencies become request-level
    p50/p99 without expanding to one entry per request."""
    v = np.ravel(np.asarray(values, dtype=np.float64))
    w = np.ravel(np.asarray(weights, dtype=np.float64))
    keep = w > 0
    v, w = v[keep], w[keep]
    if v.size == 0:
        return np.full(len(qs), np.nan)
    order = np.argsort(v, kind="stable")
    v, w = v[order], w[order]
    cum = np.cumsum(w)
    targets = np.asarray(qs, dtype=np.float64) / 100.0 * cum[-1]
    idx = np.searchsorted(cum, targets, side="left")
    return v[np.minimum(idx, v.size - 1)]
