"""Metrics export for the co-sim observability plane (host Python).

A small, dependency-free metrics facility in the Prometheus data model:

- :class:`MetricsRegistry` holds named counter / gauge / histogram series,
  each keyed by a frozen label set.
- :func:`MetricsRegistry.render_prometheus` emits the Prometheus text
  exposition format (``# HELP`` / ``# TYPE`` / ``name{label="x"} value``).
- :func:`parse_prometheus_text` parses that format back into plain dicts —
  used by the round-trip tests, and handy for scraping exported artifacts
  without a Prometheus server.
- :func:`telemetry_timeseries` converts a
  :class:`repro_torch.sim.telemetry.Telemetry` (or a ``BatchTelemetry``
  design view) into a JSON-safe timeseries doc.  The engines record those
  rings on their device and copy them to the host once, at the end of a
  run; this module reads only the host copy.

Everything here only *reads* simulation state; nothing in this module is
allowed to touch engine numerics.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Metric",
    "MetricsRegistry",
    "parse_prometheus_text",
    "telemetry_timeseries",
]

_VALID_TYPES = ("counter", "gauge", "histogram")

# Default histogram buckets: log-spaced, generic for latencies in seconds
# and utilizations alike.  Callers can pass their own.
DEFAULT_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

LabelSet = Tuple[Tuple[str, str], ...]


def _labelset(labels: Optional[Mapping[str, str]]) -> LabelSet:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_labels(ls: LabelSet, extra: Optional[Sequence[Tuple[str, str]]] = None) -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in ls]
    if extra:
        parts += [f'{k}="{_escape_label(v)}"' for k, v in extra]
    if not parts:
        return ""
    return "{" + ",".join(parts) + "}"


@dataclass
class _Histogram:
    buckets: Tuple[float, ...]
    counts: List[int] = field(default_factory=list)
    total: float = 0.0
    n: int = 0

    def __post_init__(self) -> None:
        if not self.counts:
            self.counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.total += v
        self.n += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        out: List[Tuple[float, int]] = []
        running = 0
        for b, c in zip(self.buckets, self.counts[:-1]):
            running += c
            out.append((b, running))
        running += self.counts[-1]
        out.append((math.inf, running))
        return out


@dataclass
class Metric:
    """One metric family: a name, type, help string, and labeled series."""

    name: str
    kind: str
    help: str = ""
    series: Dict[LabelSet, object] = field(default_factory=dict)
    buckets: Tuple[float, ...] = DEFAULT_BUCKETS

    def _get_scalar(self, ls: LabelSet) -> float:
        return float(self.series.get(ls, 0.0))  # type: ignore[arg-type]


class MetricsRegistry:
    """A registry of counter/gauge/histogram metrics with label support.

    Write API::

        reg = MetricsRegistry()
        reg.counter("sim_invocations_total", "Total served invocations",
                    labels={"tile": "acc0"}, value=123.0)
        reg.gauge("sim_link_util", "Instantaneous link utilization",
                  labels={"link": "3"}, value=0.41)
        reg.histogram("sim_latency_seconds", "Request latency",
                      labels={"stage": "fe"}, value=0.0031)

    ``counter`` adds (monotonic increments); ``gauge`` sets; ``histogram``
    observes one sample per call.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}

    # -- registration / write -------------------------------------------
    def _family(self, name: str, kind: str, help: str, buckets: Optional[Sequence[float]]) -> Metric:
        if kind not in _VALID_TYPES:
            raise ValueError(f"unknown metric type {kind!r}; expected one of {_VALID_TYPES}")
        m = self._metrics.get(name)
        if m is None:
            m = Metric(name=name, kind=kind, help=help,
                       buckets=tuple(buckets) if buckets else DEFAULT_BUCKETS)
            self._metrics[name] = m  # repro: noqa[TPR002] a registry by family name, as Prometheus keeps one: the kind is checked on every call, the first registration's buckets stand
        elif m.kind != kind:
            raise ValueError(f"metric {name!r} already registered as {m.kind}, not {kind}")
        if help and not m.help:
            m.help = help
        return m

    def counter(self, name: str, help: str = "", *,
                labels: Optional[Mapping[str, str]] = None, value: float = 1.0) -> None:
        m = self._family(name, "counter", help, None)
        ls = _labelset(labels)
        m.series[ls] = float(m.series.get(ls, 0.0)) + float(value)  # type: ignore[arg-type]

    def gauge(self, name: str, help: str = "", *,
              labels: Optional[Mapping[str, str]] = None, value: float = 0.0) -> None:
        m = self._family(name, "gauge", help, None)
        m.series[_labelset(labels)] = float(value)

    def histogram(self, name: str, help: str = "", *,
                  labels: Optional[Mapping[str, str]] = None, value: float = 0.0,
                  buckets: Optional[Sequence[float]] = None) -> None:
        m = self._family(name, "histogram", help, buckets)
        ls = _labelset(labels)
        h = m.series.get(ls)
        if h is None:
            h = _Histogram(buckets=m.buckets)
            m.series[ls] = h
        h.observe(value)  # type: ignore[union-attr]

    # -- read ------------------------------------------------------------
    def get(self, name: str, labels: Optional[Mapping[str, str]] = None) -> Optional[float]:
        m = self._metrics.get(name)
        if m is None:
            return None
        ls = _labelset(labels)
        v = m.series.get(ls)
        if v is None:
            return None
        if isinstance(v, _Histogram):
            return v.total
        return float(v)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # -- render ----------------------------------------------------------
    def render_prometheus(self) -> str:
        """Render the Prometheus text exposition format (v0.0.4)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for ls in sorted(m.series):
                v = m.series[ls]
                if m.kind == "histogram":
                    h = v  # type: _Histogram
                    for bound, cum in h.cumulative():  # type: ignore[union-attr]
                        le = "+Inf" if math.isinf(bound) else _fmt_value(bound)
                        lines.append(
                            f"{name}_bucket{_render_labels(ls, [('le', le)])} {cum}")
                    lines.append(f"{name}_sum{_render_labels(ls)} {_fmt_value(h.total)}")  # type: ignore[union-attr]
                    lines.append(f"{name}_count{_render_labels(ls)} {h.n}")  # type: ignore[union-attr]
                else:
                    lines.append(f"{name}{_render_labels(ls)} {_fmt_value(float(v))}")  # type: ignore[arg-type]
        return "\n".join(lines) + ("\n" if lines else "")

    def to_dict(self) -> Dict[str, object]:
        """JSON-safe dump: {name: {type, help, series: [{labels, value}...]}}."""
        out: Dict[str, object] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            series = []
            for ls in sorted(m.series):
                v = m.series[ls]
                if isinstance(v, _Histogram):
                    series.append({
                        "labels": dict(ls),
                        "sum": v.total,
                        "count": v.n,
                        "buckets": [[("+Inf" if math.isinf(b) else b), c]
                                    for b, c in v.cumulative()],
                    })
                else:
                    series.append({"labels": dict(ls), "value": float(v)})  # type: ignore[arg-type]
            out[name] = {"type": m.kind, "help": m.help, "series": series}
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, object]]:
    """Parse Prometheus text format into ``{name: {type, help, samples}}``.

    ``samples`` is a list of ``(labels_dict, value)`` tuples, with the raw
    sample name (e.g. ``foo_bucket``) folded back under its family when a
    ``# TYPE`` line announced a histogram.  Sufficient for round-trip tests
    and CI gates; not a general Prometheus client.
    """
    out: Dict[str, Dict[str, object]] = {}
    current_family: Optional[str] = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            fam = out.setdefault(name, {"type": None, "help": "", "samples": []})
            fam["help"] = help_text
            current_family = name
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):]
            name, _, kind = rest.partition(" ")
            fam = out.setdefault(name, {"type": None, "help": "", "samples": []})
            fam["type"] = kind.strip()
            current_family = name
            continue
        if line.startswith("#"):
            continue
        # sample line: name{labels} value  |  name value
        if "{" in line:
            name, _, rest = line.partition("{")
            labels_raw, _, val_raw = rest.rpartition("} ")
            labels: Dict[str, str] = {}
            if labels_raw:
                for item in _split_labels(labels_raw):
                    k, _, v = item.partition("=")
                    labels[k] = v.strip('"').replace('\\"', '"').replace("\\\\", "\\")
        else:
            name, _, val_raw = line.partition(" ")
            labels = {}
        val_raw = val_raw.strip()
        if val_raw == "+Inf":
            value = math.inf
        elif val_raw == "-Inf":
            value = -math.inf
        else:
            value = float(val_raw)
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[: -len(suffix)] if name.endswith(suffix) else None
            if base and base in out and out[base].get("type") == "histogram":
                family = base
                labels["__sample__"] = name[len(base) + 1:]
                break
        fam = out.setdefault(family, {"type": None, "help": "", "samples": []})
        fam["samples"].append((labels, value))  # type: ignore[union-attr]
        current_family = family
    return out


def _split_labels(raw: str) -> List[str]:
    """Split ``a="x",b="y"`` on commas outside quotes."""
    items: List[str] = []
    buf: List[str] = []
    in_quote = False
    escape = False
    for ch in raw:
        if escape:
            buf.append(ch)
            escape = False
            continue
        if ch == "\\":
            buf.append(ch)
            escape = True
            continue
        if ch == '"':
            in_quote = not in_quote
            buf.append(ch)
            continue
        if ch == "," and not in_quote:
            items.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        items.append("".join(buf))
    return items


def telemetry_timeseries(telemetry, *, design: Optional[int] = None) -> Dict[str, object]:
    """Convert a Telemetry/BatchTelemetry ring into a JSON-safe timeseries doc.

    Returns ``{"scalars": {name: [..]}, "islands": [...], "tiles": [...],
    "island_rates": [[..]], "queue_depth": [[..]], "events": [...]}``.
    For a ``BatchTelemetry`` pass ``design=`` to select one design's view.
    """
    t = telemetry.design(design) if design is not None else telemetry
    doc = t.to_dict()
    doc["kind"] = "telemetry_timeseries"
    return doc
