"""Run-time monitoring infrastructure (paper contribution C3).

The paper exposes up to four memory-mapped counters per accelerator tile:
execution time, packets in, packets out, round-trip time.  The port keeps a
**counter tree of float32 scalar tensors on the engine's device** — updating
a counter is a device add, and reading it is one device->host transfer, the
analogue of an MMIO read over the paper's USB-to-serial link.

Semantics match the reference (``repro/core/monitor.py``):
* ``exec_time`` auto-resets when the tile starts and stops at completion —
  i.e. it holds the *latest* per-step busy value, not an accumulation;
* ``pkts_in`` / ``pkts_out`` / ``rtt`` accumulate until *manually* reset;
* only the (<=4) counters enabled in the TileSpec exist at all.

Packets are ``bytes / PKT_BYTES`` with PKT_BYTES = 512.  The update
functions return a new tree and leave the one they were given as it was.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.core.tiles import TilePlan
from repro_torch.device import DeviceSpec, resolve

PKT_BYTES = 512

Counters = Dict[str, Dict[str, torch.Tensor]]   # {tile: {kind: f32 scalar}}

ACCUMULATING = ("pkts_in", "pkts_out", "rtt")


def init_counters(plan: TilePlan, device: DeviceSpec = None) -> Counters:
    dev = resolve(device)
    return {t.name: {m: torch.zeros((), dtype=torch.float32, device=dev)
                     for m in t.monitors}
            for t in plan.tiles}


def _leaves(x: Any):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif x is not None:
        yield x


def bytes_of(x: Any) -> float:
    """Byte count of a tensor or a nested dict / list / tuple of tensors
    (shape and dtype only; the data is not read)."""
    return float(sum(t.numel() * t.element_size() for t in _leaves(x)
                     if torch.is_tensor(t)))


def pkts(nbytes) -> torch.Tensor:
    return torch.as_tensor(nbytes, dtype=torch.float32) / PKT_BYTES


def charge(counters: Counters, tile: str, *, exec_time=None, pkts_in=None,
           pkts_out=None, rtt=None) -> Counters:
    """Counter update.  Disabled counters are silently skipped (the hardware
    without the counter instantiated simply has no register).

    exec_time REPLACES (auto-reset per start/stop); the others ACCUMULATE.
    Values may be Python numbers or tensors.
    """
    if tile not in counters:
        return counters
    row = dict(counters[tile])

    def f32(val, like):
        return torch.as_tensor(val, dtype=torch.float32, device=like.device)

    if exec_time is not None and "exec_time" in row:
        row["exec_time"] = f32(exec_time, row["exec_time"])
    for name, val in (("pkts_in", pkts_in), ("pkts_out", pkts_out),
                      ("rtt", rtt)):
        if val is not None and name in row:
            row[name] = row[name] + f32(val, row[name])
    out = dict(counters)
    out[tile] = row
    return out


def charge_boundary(counters: Counters, src: str, dst: str, payload) -> Counters:
    """Charge one tile-boundary stream crossing: bytes leave ``src`` and
    enter ``dst``."""
    n = pkts(bytes_of(payload))
    counters = charge(counters, src, pkts_out=n)
    return charge(counters, dst, pkts_in=n)


def manual_reset(counters: Counters, tiles: Optional[Iterable[str]] = None,
                 kinds: Iterable[str] = ACCUMULATING) -> Counters:
    """Host-initiated reset of the accumulating counters (the paper's
    manually-reset semantics).  exec_time is excluded by default."""
    kinds = tuple(kinds)
    out = {}
    for t, row in counters.items():
        if tiles is not None and t not in tiles:
            out[t] = row
            continue
        out[t] = {k: (torch.zeros_like(v) if k in kinds else v)
                  for k, v in row.items()}
    return out


@dataclass
class MonitorSample:
    step: int
    wall_time: float
    counters: Dict[str, Dict[str, float]]


class MonitorClient:
    """Host-side monitor — the USB-to-serial path of the paper.

    ``read()`` pulls the counter tree to the host and stamps it with the
    wall clock; ``rates()`` differentiates consecutive samples into pkt/s.
    The sample history is bounded (``max_samples``, a deque).
    """

    def __init__(self, max_samples: int = 4096):
        self.samples: Deque[MonitorSample] = deque(maxlen=int(max_samples))
        self._layout_key: Optional[Tuple[Tuple[str, ...], ...]] = None
        self._layout: List[Tuple[str, Tuple[str, ...]]] = []

    def read(self, counters: Counters, step: int) -> MonitorSample:
        names = [(t, k) for t, row in counters.items() for k in row]
        vals = (torch.stack([counters[t][k] for t, k in names]).tolist()
                if names else [])
        flat: Dict[str, Dict[str, float]] = {t: {} for t in counters}
        for (t, k), v in zip(names, vals):
            flat[t][k] = float(v)
        s = MonitorSample(step=step, wall_time=time.monotonic(), counters=flat)
        self.samples.append(s)
        return s

    def rates(self, tile: str, kind: str = "pkts_in") -> List[Tuple[int, float]]:
        samples = list(self.samples)
        out = []
        for a, b in zip(samples, samples[1:]):
            dt = b.wall_time - a.wall_time
            if dt <= 0:
                continue
            da = b.counters[tile].get(kind, 0.0) - a.counters[tile].get(kind, 0.0)
            out.append((b.step, da / dt))
        return out

    def _columns(self, counters: Dict[str, Dict[str, float]]
                 ) -> List[Tuple[str, Tuple[str, ...]]]:
        key = tuple((t, tuple(row)) for t, row in counters.items())
        if key != self._layout_key:
            self._layout_key = key
            self._layout = [(t, tuple(sorted(counters[t])))
                            for t in sorted(counters)]
        return self._layout

    def table(self) -> str:
        if not self.samples:
            return "(no samples)"
        last = self.samples[-1]
        lines = [f"step {last.step}  t={last.wall_time:.3f}"]
        for t, kinds in self._columns(last.counters):
            row = last.counters[t]
            cols = "  ".join(f"{k}={row[k]:.3g}" for k in kinds)
            lines.append(f"  {t:12s} {cols}")
        return "\n".join(lines)
