"""NoC model: topology, XY routing, link-level contention.

The paper's SoC is a 4x4 mesh NoC: a grid with per-link bandwidth and hop
latency (an optional torus wrap serves larger fabrics).  Host-side NumPy,
as in the reference ``repro.core.noc``; the batched engine turns the
tables it needs into tensors once, at construction.

Contention: per-link utilization rho from summed flows; the service
slowdown uses an M/D/1-style factor 1 + rho/(2(1-rho)) capped at
``max_slowdown`` — an analytic stand-in for the RTL backpressure the paper
measures.  This reproduces the paper's Fig. 3
shape: compute-bound tiles are flat under background traffic until the NoC
saturates; memory-bound tiles collapse as rho -> 1.

Batched evaluation (the DSE hot path): :func:`routing_tables` precomputes,
once per :class:`NocConfig`, the all-pairs hop matrix and a ragged
route->link incidence table.  Hop counts for B (src, dst) pairs become one
gather (:func:`hops_batch`); accumulating B flows onto links becomes one
``bincount`` (:func:`link_loads_batch`); the worst-link utilization along B
routes becomes one segmented reduction (:func:`route_max_utilization`).
Scalar ``xy_route``/``hops`` are memoized per ``(cfg, src, dst)`` so the
remaining scalar callers stop re-walking routes on every query.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Iterable, List, Tuple

import numpy as np

Pos = Tuple[int, int]
Link = Tuple[Pos, Pos]


@dataclass(frozen=True)
class NocConfig:
    rows: int = 4
    cols: int = 4
    torus: bool = False               # paper NoC: mesh
    link_bw: float = 1.0              # bytes/cycle per link (normalized)
    hop_latency: float = 1.0          # cycles per hop
    max_slowdown: float = 50.0


# Cache bounds: chunked many-config sweeps touch an unbounded stream of
# NocConfigs (every distinct link_bw/size/torus is a fresh key), so the
# route/hop/table caches carry explicit maxsize instead of growing for the
# life of the process.  Sizing: a pod-scale 16x16 grid has 256^2 = 65536
# (src, dst) pairs, so 1<<17 route/hop entries hold two pod-size configs
# (or ~500 SoC-size ones) before eviction; routing tables are the big rows
# (hop matrix + ragged incidence), so only a handful stay resident.
_ROUTE_CACHE_SIZE = 1 << 17
_TABLE_CACHE_SIZE = 16


@lru_cache(maxsize=_ROUTE_CACHE_SIZE)
def _xy_route_cached(cfg: NocConfig, src: Pos, dst: Pos) -> Tuple[Link, ...]:
    """Dimension-ordered (X then Y) route; shortest-wrap when torus.

    Memoized per ``(cfg, src, dst)`` — NocConfig is a frozen dataclass, so
    the triple is hashable and each route is walked at most once per
    cache residency.  The cached tuple is immutable; :func:`xy_route`
    copies it."""
    links: List[Link] = []
    r, c = src

    def step_toward(cur: int, tgt: int, size: int) -> int:
        if cur == tgt:
            return cur
        if not cfg.torus:
            return cur + (1 if tgt > cur else -1)
        fwd = (tgt - cur) % size
        bwd = (cur - tgt) % size
        return (cur + 1) % size if fwd <= bwd else (cur - 1) % size

    while c != dst[1]:
        nc = step_toward(c, dst[1], cfg.cols)
        links.append(((r, c), (r, nc)))
        c = nc
    while r != dst[0]:
        nr = step_toward(r, dst[0], cfg.rows)
        links.append(((r, c), (nr, c)))
        r = nr
    return tuple(links)


def xy_route(cfg: NocConfig, src: Pos, dst: Pos) -> List[Link]:
    """Dimension-ordered (X then Y) route; shortest-wrap when torus."""
    return list(_xy_route_cached(cfg, src, dst))


@lru_cache(maxsize=_ROUTE_CACHE_SIZE)
def hops(cfg: NocConfig, src: Pos, dst: Pos) -> int:
    return len(_xy_route_cached(cfg, src, dst))


# ---------------------------------------------------------------------------
# Precomputed routing tables: the batched fast path
# ---------------------------------------------------------------------------


def pos_index(cfg: NocConfig, pos: Pos) -> int:
    """Flat node index of a grid position (row-major)."""
    return pos[0] * cfg.cols + pos[1]


def index_pos(cfg: NocConfig, idx: int) -> Pos:
    return (idx // cfg.cols, idx % cfg.cols)


@dataclass(frozen=True, eq=False)
class RoutingTables:
    """All-pairs routing of one :class:`NocConfig`, as arrays.

    ``hop_matrix[s, d]`` is the XY hop count from node ``s`` to node ``d``
    (flat row-major indices).  The route of pair ``p = s * n_nodes + d``
    occupies ``link_ids[route_offsets[p] : route_offsets[p + 1]]`` — a
    ragged route->link incidence table that scales to pod-size grids
    (a dense (N^2, L) matrix is available via :meth:`dense_incidence` for
    small fabrics).
    """
    cfg: NocConfig
    links: Tuple[Link, ...]                 # directed links, table order
    link_index: Dict[Link, int]             # inverse of ``links``
    hop_matrix: np.ndarray                  # (N, N) int32
    link_ids: np.ndarray                    # (sum hops,) int32
    route_offsets: np.ndarray               # (N*N + 1,) int64

    @property
    def n_nodes(self) -> int:
        return self.cfg.rows * self.cfg.cols

    @property
    def n_links(self) -> int:
        return len(self.links)

    def dense_incidence(self) -> np.ndarray:
        """(N*N, L) boolean route->link incidence (small fabrics only)."""
        n2 = self.n_nodes * self.n_nodes
        inc = np.zeros((n2, self.n_links), dtype=bool)
        rows = np.repeat(np.arange(n2), np.diff(self.route_offsets))
        inc[rows, self.link_ids] = True
        return inc


@lru_cache(maxsize=_TABLE_CACHE_SIZE)
def routing_tables(cfg: NocConfig) -> RoutingTables:
    """Build (once per resident config) the hop matrix + link incidence
    tables.  Bounded: a many-config sweep evicts the least-recently-used
    tables instead of retaining one incidence table per config forever
    (tested)."""
    n = cfg.rows * cfg.cols
    link_index: Dict[Link, int] = {}
    links: List[Link] = []
    hop = np.zeros((n, n), dtype=np.int32)
    ids: List[int] = []
    offsets = np.zeros(n * n + 1, dtype=np.int64)
    p = 0
    for s in range(n):
        src = index_pos(cfg, s)
        for d in range(n):
            route = _xy_route_cached(cfg, src, index_pos(cfg, d))
            hop[s, d] = len(route)
            for link in route:
                if link not in link_index:
                    link_index[link] = len(links)
                    links.append(link)
                ids.append(link_index[link])
            p += 1
            offsets[p] = len(ids)
    return RoutingTables(cfg=cfg, links=tuple(links), link_index=link_index,
                         hop_matrix=hop,
                         link_ids=np.asarray(ids, dtype=np.int32),
                         route_offsets=offsets)


def positions_to_indices(cfg: NocConfig, positions) -> np.ndarray:
    """(..., 2) (row, col) array -> flat node indices (row-major)."""
    a = np.asarray(positions)
    return a[..., 0] * cfg.cols + a[..., 1]


def _as_indices(cfg: NocConfig, pos) -> np.ndarray:
    """Coerce to flat node indices.

    A single ``(r, c)`` tuple is converted; any other input is already
    flat indices (use :func:`positions_to_indices` for (..., 2) arrays —
    a length-2 index array is ambiguous otherwise).
    """
    if isinstance(pos, tuple) and len(pos) == 2 and all(
            isinstance(x, (int, np.integer)) for x in pos):
        return np.asarray(pos_index(cfg, pos))
    return np.asarray(pos)


def hops_batch(cfg: NocConfig, src, dst) -> np.ndarray:
    """Hop counts for B (src, dst) pairs: one gather from the hop matrix.

    ``src``/``dst`` broadcast against each other; each is either flat node
    indices (see :func:`positions_to_indices`) or a single (r, c) tuple.
    """
    t = routing_tables(cfg)
    return t.hop_matrix[_as_indices(cfg, src), _as_indices(cfg, dst)]


def _route_segments(t: RoutingTables, src, dst):
    """Gathered link ids + segment bounds for a batch of routes."""
    cfg = t.cfg
    s = np.ravel(_as_indices(cfg, src))
    d = np.ravel(_as_indices(cfg, dst))
    s, d = np.broadcast_arrays(s, d)
    pair = s * t.n_nodes + d
    starts = t.route_offsets[pair]
    counts = (t.route_offsets[pair + 1] - starts).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int32), counts
    # ragged gather: route i contributes link_ids[starts[i] : starts[i]+counts[i]]
    cum = np.concatenate(([0], np.cumsum(counts)))[:-1]
    flat = np.repeat(starts, counts) + (np.arange(total) - np.repeat(cum, counts))
    return t.link_ids[flat], counts


def stacked_incidence(cfg: NocConfig, src, dst) -> np.ndarray:
    """Dense route->link incidence for a batch of (src, dst) pairs.

    Returns a ``(..., n_links)`` float64 0/1 array where entry
    ``[..., l]`` is 1 iff the XY route of the corresponding (src, dst)
    pair traverses link ``l`` (RoutingTables link order).  ``src``/``dst``
    broadcast like :func:`hops_batch`.

    This is the *stacked/padded* export the batched co-simulation engine
    consumes: every route, whatever its hop count, is padded out to the
    full ``n_links``-wide row (zeros on unused links), so per-design
    per-tile routes stack into one rectangular ``(B, A, L)`` table and
    per-tick link loads become a single einsum instead of B ragged
    gathers.  Dense rows cost ``n_links`` floats each — fine for SoC-size
    fabrics (a 4x4 mesh has 48 directed links); pod-size grids should
    keep using the ragged ``link_ids``/``route_offsets`` tables.
    """
    t = routing_tables(cfg)
    s = _as_indices(cfg, src)
    d = _as_indices(cfg, dst)
    s, d = np.broadcast_arrays(s, d)
    shape = s.shape
    sflat = s.ravel()
    ids, counts = _route_segments(t, sflat, d.ravel())
    inc = np.zeros((sflat.shape[0], t.n_links), dtype=np.float64)
    if ids.size:
        rows = np.repeat(np.arange(counts.shape[0]), counts)
        inc[rows, ids] = 1.0
    return inc.reshape(shape + (t.n_links,))


def flow_incidence(cfg: NocConfig, src, dst) -> Tuple[np.ndarray, np.ndarray]:
    """(dense incidence, hop counts) for a batch of (src, dst) flows.

    The one-call export the simulator's flow compiler consumes: one
    broadcast of the (src, dst) pair arrays yields both the padded
    ``(..., n_links)`` route->link incidence (:func:`stacked_incidence`
    layout) and the matching ``(...,)`` hop counts gathered from the
    precomputed hop matrix — so arbitrary tile-to-tile patterns pay the
    same single table lookup the legacy tile->MEM pattern does.
    """
    t = routing_tables(cfg)
    s = _as_indices(cfg, src)
    d = _as_indices(cfg, dst)
    s, d = np.broadcast_arrays(s, d)
    return (stacked_incidence(cfg, s, d), t.hop_matrix[s, d])


def link_loads_batch(cfg: NocConfig, src, dst, demand) -> np.ndarray:
    """Per-link offered load (bytes/cycle) of B flows: one bincount.

    Equivalent to calling :meth:`NocModel.add_flow` B times, but O(total
    hops) array work instead of per-flow Python route walks.  Returns a
    dense (n_links,) vector in :class:`RoutingTables` link order.
    """
    t = routing_tables(cfg)
    ids, counts = _route_segments(t, src, dst)
    w = np.repeat(np.broadcast_to(np.asarray(demand, dtype=np.float64),
                                  counts.shape), counts)
    return np.bincount(ids, weights=w, minlength=t.n_links)


def route_max_utilization(cfg: NocConfig, link_loads: np.ndarray,
                          src, dst) -> np.ndarray:
    """Worst-link utilization rho along each of B routes (segmented max)."""
    t = routing_tables(cfg)
    ids, counts = _route_segments(t, src, dst)
    rho = np.asarray(link_loads, dtype=np.float64) / cfg.link_bw
    out = np.zeros(counts.shape, dtype=np.float64)
    nz = counts > 0
    if ids.size:
        seg_starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
        out[nz] = np.maximum.reduceat(rho[ids], seg_starts[nz])
    return out


def contention_slowdown(rho, max_slowdown: float):
    """M/D/1-style service slowdown from utilization (vectorized)."""
    r = np.minimum(rho, 0.999)
    return np.minimum(1.0 + r / (2.0 * (1.0 - r)), max_slowdown)


@dataclass
class Flow:
    src: Pos
    dst: Pos
    bytes_per_cycle: float          # offered load at the flow's island rate


class NocModel:
    """Accumulates flows onto links and answers contention queries."""

    def __init__(self, cfg: NocConfig):
        self.cfg = cfg
        self.link_load: Dict[Link, float] = {}
        self.flows: List[Flow] = []

    def add_flow(self, f: Flow) -> None:
        self.flows.append(f)
        for link in _xy_route_cached(self.cfg, f.src, f.dst):
            self.link_load[link] = self.link_load.get(link, 0.0) + f.bytes_per_cycle

    def add_flows(self, flows: Iterable[Flow]) -> None:
        """Batched add: route all flows via the incidence tables at once."""
        flows = list(flows)
        if not flows:
            return
        self.flows.extend(flows)
        t = routing_tables(self.cfg)
        loads = link_loads_batch(
            self.cfg,
            positions_to_indices(self.cfg, [f.src for f in flows]),
            positions_to_indices(self.cfg, [f.dst for f in flows]),
            np.asarray([f.bytes_per_cycle for f in flows]))
        for i in np.nonzero(loads)[0]:
            link = t.links[int(i)]
            self.link_load[link] = self.link_load.get(link, 0.0) + float(loads[i])

    def _load_vector(self) -> np.ndarray:
        t = routing_tables(self.cfg)
        v = np.zeros(t.n_links)
        for link, load in self.link_load.items():
            v[t.link_index[link]] = load
        return v

    def utilization(self, link: Link) -> float:
        return self.link_load.get(link, 0.0) / self.cfg.link_bw

    def max_utilization(self) -> float:
        if not self.link_load:
            return 0.0
        return max(self.utilization(l) for l in self.link_load)

    def slowdown(self, src: Pos, dst: Pos) -> float:
        """M/D/1-style service slowdown along a route (worst link)."""
        rho = 0.0
        for link in _xy_route_cached(self.cfg, src, dst):
            rho = max(rho, min(self.utilization(link), 0.999))
        s = 1.0 + rho / (2.0 * (1.0 - rho))
        return float(min(s, self.cfg.max_slowdown))

    def slowdown_batch(self, src, dst) -> np.ndarray:
        """Slowdowns for B (src, dst) routes in one segmented reduction."""
        rho = route_max_utilization(self.cfg, self._load_vector(), src, dst)
        return contention_slowdown(rho, self.cfg.max_slowdown)

    def route_latency(self, src: Pos, dst: Pos) -> float:
        """Cycles for a packet header to traverse, incl. queueing."""
        base = hops(self.cfg, src, dst) * self.cfg.hop_latency
        return base * self.slowdown(src, dst)
