"""The fused batched co-simulation tick: wrapper, control plan, plain version.

``fused_tick_sim`` runs all ``T`` simulator ticks of ``B`` stacked designs in
ONE kernel launch — queue admit (with optional overflow drops), static and
dynamic NoC contention, service, rtt, chain forwarding, the energy integral
(linear voltage proxy or the physical three-scalar model) and, on control
ticks, the DFS control step (island aggregation, membound / PID / EWMA /
guard-only policy, guard latch with hysteresis, tech clamp, nearest legal
ladder level, masked commit, swap count).  The kernel is hand-written CUDA
C++ for sm_90a (``csrc/tick_sim.cu``; see its source note for the design);
it replaces the Pallas kernel ``repro/kernels/tick_sim.py`` plus the control
closure ``repro/sim/batch.py:_jax_control`` the reference hands to it.

* On CUDA tensors the wrapper launches the kernel or raises.
* On CPU tensors it runs :func:`fused_tick_sim_plain`, the same function as a
  Python loop of float32 torch ops — what the CPU tests exercise and what the
  kernel is compared with on the card.  The plain version evaluates every
  expression in the kernel's order (sums over tiles run in tile order), so
  on one device the two round alike.

A CUDA kernel cannot take a Python closure, so the controller is described by
a :class:`ControlPlan` record: a policy *kind*, its scalars, and the island
topology tables.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.perfmodel import P_DYN_W, P_STATIC_W, V_BASE, V_SLOPE

KINDS = ("none", "guard", "membound", "pid", "ewma")

# shape bounds compiled into csrc/tick_sim.cu
MAX_TILES = 16
MAX_ISLANDS = 24
MAX_LINKS = 64


@dataclass(frozen=True)
class ControlPlan:
    """Everything the control step needs, as plain values and NumPy tables.

    ``kind`` selects the policy: ``"none"`` (open loop), ``"guard"`` (no
    policy, guard latch only), ``"membound"`` (``threshold``/``low_rate``),
    ``"pid"`` (``target/kp/ki/kd/min_rate/integral_clamp``) or ``"ewma"``
    (``alpha/target/min_rate``).  ``guard=None`` switches the guard latch
    off; ``tech_lo=None`` the legal-range clamp.  Tables: ``membership``
    ``(I, A)`` 0/1, ``counts`` ``(I,)`` tiles per island, ``fixed`` /
    ``skip`` ``(I,)`` bool, ``levels`` ``(I, Lmax)`` ladder levels padded
    with ``+inf``, ``tech_legal`` ``(I, Lmax)`` bool (with a tech clamp).
    """
    kind: str = "none"
    membership: Optional[np.ndarray] = None
    counts: Optional[np.ndarray] = None
    fixed: Optional[np.ndarray] = None
    skip: Optional[np.ndarray] = None
    levels: Optional[np.ndarray] = None
    guard: Optional[float] = None
    guard_release: Optional[float] = None
    guard_rate: float = 1.0
    tech_lo: Optional[float] = None
    tech_hi: Optional[float] = None
    tech_legal: Optional[np.ndarray] = None
    threshold: float = 0.7
    low_rate: float = 0.2
    target: float = 0.7
    kp: float = 0.0
    ki: float = 0.0
    kd: float = 0.0
    min_rate: float = 0.2
    integral_clamp: float = 2.0
    alpha: float = 0.3

    def __post_init__(self):
        if self.kind not in KINDS:
            raise NotImplementedError(
                f"control kind {self.kind!r} is not implemented in the "
                f"fused tick kernel; supported kinds: {KINDS}")

    @property
    def n_state(self) -> int:
        """Number of (B, I) policy-state arrays (plus one (B, 1) flag)."""
        return {"pid": 2, "ewma": 1}.get(self.kind, 0)

    def tables(self, n_tiles: int) -> Dict[str, np.ndarray]:
        """float32 tables in the layout both versions read."""
        mem = np.asarray(self.membership, dtype=np.float32)
        I = mem.shape[0]
        assert mem.shape == (I, n_tiles), (mem.shape, n_tiles)
        counts = np.asarray(self.counts, dtype=np.float64)
        lv = np.asarray(self.levels, dtype=np.float32)
        legal = (np.asarray(self.tech_legal, dtype=np.float32)
                 if self.tech_legal is not None else np.ones_like(lv))
        return {
            "membership": mem,
            "counts_safe": np.where(counts > 0, counts, 1.0).astype(
                np.float32),
            "counts_pos": (counts > 0).astype(np.float32),
            "fixed": np.asarray(self.fixed, dtype=np.float32),
            "skip": np.asarray(
                self.skip if self.skip is not None
                else np.ones(I, dtype=bool), dtype=np.float32),
            "levels": lv,
            "tech_legal": legal,
        }


_TABLE_ORDER = ("membership", "counts_safe", "counts_pos", "fixed", "skip",
                "levels", "tech_legal")


class _TickParams(ctypes.Structure):
    """Field for field the ``TickParams`` struct of ``csrc/tick_sim.cu``."""
    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "T", "B", "A", "I", "Lmax", "noc_idx", "ci", "kind",
            "dyn_on", "maxq_on", "has_fwd", "tech_on", "guard_on",
            "clamp_on", "arr_shared")]
        + [(n, ctypes.c_float) for n in (
            "dt", "own", "tgd", "link_bw", "max_slow", "hop_lat",
            "hop_share", "hopf0",
            "noc_share", "n_tg", "max_q", "t_ps", "t_v0", "t_v1", "m1own",
            "util_div",
            "p_static", "p_dyn", "v_base", "v_slope",
            "threshold", "low_rate",
            "target", "kp", "ki", "kd", "min_rate", "integral_clamp",
            "alpha", "one_m_alpha",
            "guard", "guard_release", "guard_rate",
            "tech_lo", "tech_hi")])


def _scalar_params(scalars, plan: ControlPlan) -> Dict[str, float]:
    """The float parameters both versions use, from the ``scalars`` dict and
    the plan.  Compound constants are formed here, in float64, once — the
    kernel and the plain version then round the same values to float32."""
    max_q = float(scalars["max_q"])
    ci = int(scalars["ci"])
    guard_on = plan.kind != "none" and plan.guard is not None
    clamp_on = plan.kind != "none" and plan.tech_lo is not None
    return dict(
        dt=float(scalars["dt"]), own=float(scalars["own"]),
        tgd=float(scalars["tgd"]), link_bw=float(scalars["link_bw"]),
        max_slow=float(scalars["max_slow"]),
        hop_lat=float(scalars["hop_lat"]),
        hop_share=float(scalars["hop_share"]),
        hopf0=float(scalars["hopf0"]),
        noc_share=float(scalars["noc_share"]), n_tg=float(scalars["n_tg"]),
        max_q=max_q if max_q != float("inf") else 0.0,
        t_ps=float(scalars.get("t_ps", 1.0)),
        t_v0=float(scalars.get("t_v0", V_BASE)),
        t_v1=float(scalars.get("t_v1", V_SLOPE)),
        m1own=max(1.0, float(scalars["own"])),
        util_div=float(max(ci, 1)),
        p_static=P_STATIC_W, p_dyn=P_DYN_W, v_base=V_BASE, v_slope=V_SLOPE,
        threshold=float(plan.threshold), low_rate=float(plan.low_rate),
        target=float(plan.target), kp=float(plan.kp), ki=float(plan.ki),
        kd=float(plan.kd), min_rate=float(plan.min_rate),
        integral_clamp=float(plan.integral_clamp),
        alpha=float(plan.alpha), one_m_alpha=1.0 - float(plan.alpha),
        guard=float(plan.guard) if guard_on else 0.0,
        guard_release=float(plan.guard_release) if guard_on else 0.0,
        guard_rate=float(plan.guard_rate),
        tech_lo=float(plan.tech_lo) if clamp_on else 0.0,
        tech_hi=float(plan.tech_hi) if clamp_on else 0.0)


def _check_inputs(arrivals, consts, scalars, init, plan: ControlPlan):
    """Device / dtype / shape / contiguity checks shared by both versions.
    Returns ``(T, B, A, I, L, shared)``."""
    if not torch.is_tensor(arrivals):
        raise TypeError("arrivals must be a torch tensor")
    dev = arrivals.device
    if arrivals.dtype != torch.float32:
        raise TypeError(f"arrivals must be float32, got {arrivals.dtype}")
    if arrivals.dim() not in (2, 3):
        raise ValueError("arrivals must be (T, B, A) or a shared (T, A)")
    B, A = consts["base"].shape
    T = int(arrivals.shape[0])
    if B < 1 or A < 1:
        raise ValueError(f"need at least one design and one tile, got "
                         f"B={B} A={A}")
    shared = arrivals.dim() == 2
    want = (T, A) if shared else (T, B, A)
    if tuple(arrivals.shape) != want:
        raise ValueError(f"arrivals shape {tuple(arrivals.shape)} != {want}")
    I = int(init["rates"].shape[1])
    L = int(consts["inc"].shape[-1])

    def chk(name, t, shape, dtype=torch.float32):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a torch tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, arrivals on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    chk("arrivals", arrivals, want)
    for key in ("base", "req", "w", "k", "hop", "tcr"):
        chk(f"consts[{key!r}]", consts[key], (B, A))
    chk("consts['inc']", consts["inc"], (B, A, L))
    chk("consts['ftg']", consts["ftg"], (B, 1))
    chk("init['rates']", init["rates"], (B, I))
    chk("init['guard']", init["guard"], (B, I), torch.bool)
    pol = tuple(init.get("pol", ()))
    if len(pol) != (plan.n_state + 1 if plan.n_state else 0):
        raise ValueError(
            f"control kind {plan.kind!r} carries {plan.n_state} state "
            f"arrays and a flag; got {len(pol)} arrays")
    for j, s in enumerate(pol[:-1]):
        chk(f"init['pol'][{j}]", s, (B, I))
    if pol:
        chk("init['pol'][-1]", pol[-1], (B, 1), torch.bool)
    if A > MAX_TILES or I > MAX_ISLANDS or L > MAX_LINKS:
        raise ValueError(
            f"shape outside the kernel's bounds: A={A} (<= {MAX_TILES}), "
            f"I={I} (<= {MAX_ISLANDS}), L={L} (<= {MAX_LINKS})")
    iot = np.asarray(scalars["iot"])
    if iot.shape != (A,) or iot.min() < 0 or iot.max() >= I:
        raise ValueError("scalars['iot'] must map each of A tiles to an "
                         "island index in [0, I)")
    if not -1 <= int(scalars["noc_idx"]) < I:
        raise ValueError("scalars['noc_idx'] out of range")
    if plan.kind != "none":
        lv = np.asarray(plan.levels)
        if np.asarray(plan.membership).shape != (I, A) or lv.shape[0] != I:
            raise ValueError("control tables do not match (I, A)")
    return T, B, A, I, L, shared


def _out_dict(adm, served, queue, busy, rtt, rates, guard, dropped, energy,
              swaps, pol) -> Dict[str, object]:
    return {"adm": adm, "served": served, "queue": queue, "busy": busy,
            "rtt": rtt, "rates": rates, "guard": guard, "dropped": dropped,
            "energy": energy, "swaps": swaps, "pol": pol}


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order (the kernel's order)."""
    s = x[..., 0]
    for a in range(1, x.shape[-1]):
        s = s + x[..., a]
    return s


def fused_tick_sim_plain(arrivals, consts, scalars, init, *,
                         plan: Optional[ControlPlan] = None):
    """Plain PyTorch version of :func:`fused_tick_sim`: same signature, same
    outputs, a Python loop over ``T`` of float32 ops on ``(B, A)`` /
    ``(B, I)`` tensors on the inputs' device."""
    plan = plan if plan is not None else ControlPlan()
    T, B, A, I, L, shared = _check_inputs(arrivals, consts, scalars, init,
                                          plan)
    dev = arrivals.device
    f32 = torch.float32
    P = _scalar_params(scalars, plan)
    ci = int(scalars["ci"])
    dyn_on = bool(scalars["dyn_on"])
    maxq_on = float(scalars["max_q"]) != float("inf")
    tech_on = bool(scalars.get("tech_on", False))
    noc_idx = int(scalars["noc_idx"])
    iot = torch.as_tensor(np.asarray(scalars["iot"]), dtype=torch.long,
                          device=dev)
    demand = torch.as_tensor(
        np.broadcast_to(np.asarray(scalars["demand"], dtype=np.float32),
                        (A,)).copy(), device=dev)
    fwd_np = scalars.get("forward")
    fwd = (torch.as_tensor(np.asarray(fwd_np, dtype=np.float32), device=dev)
           if fwd_np is not None else None)

    base, req, w, k = (consts[n] for n in ("base", "req", "w", "k"))
    hop, tcr, inc = consts["hop"], consts["tcr"], consts["inc"]
    ftg = consts["ftg"]                                        # (B, 1)

    control = plan.kind != "none"
    if control:
        tb = {n: torch.as_tensor(v, device=dev)
              for n, v in plan.tables(A).items()}
        memb = tb["membership"]                                # (I, A)
        counts_safe = tb["counts_safe"]
        counts_pos = tb["counts_pos"] > 0.5
        fixed = tb["fixed"] > 0.5
        skip = tb["skip"] > 0.5
        levels = tb["levels"]                                  # (I, Lmax)
        legal = tb["tech_legal"] > 0.5
    guard_on = control and plan.guard is not None
    clamp_on = control and plan.tech_lo is not None

    rates = init["rates"].clone()
    guard = init["guard"].clone()
    pol = tuple(init.get("pol", ()))
    pol0 = pol[0].clone() if plan.n_state >= 1 else None
    pol1 = pol[1].clone() if plan.n_state >= 2 else None
    has = pol[-1].clone() if pol else None                     # (B, 1) bool

    t_ref = (1.0 - w) + (w * P["m1own"]) * P["hopf0"]
    bt = base * t_ref

    def service(rates):
        f_tile = rates[:, iot]                                 # (B, A)
        f_noc = (rates[:, noc_idx:noc_idx + 1] if noc_idx >= 0
                 else torch.ones((B, 1), dtype=f32, device=dev))
        fa = torch.clamp(f_tile, min=1e-3)
        fn = torch.clamp(f_noc, min=1e-3)
        lbf = P["link_bw"] * fn
        load = P["own"] + (P["tgd"] * ftg) * P["n_tg"]
        slow = torch.clamp(load / lbf, min=1.0)
        hopf = 1.0 + P["hop_share"] * hop
        t_comp = (1.0 - w) / (k * fa)
        t_wire = ((w * slow) * hopf) / fn
        if tech_on:
            vt = P["t_v0"] + P["t_v1"] * f_tile
            pf = ((P["p_dyn"] * f_tile) * vt) * vt
            vn = P["t_v0"] + P["t_v1"] * f_noc
            noc_p = P["noc_share"] * (
                P["t_ps"] * (P["p_static"] + ((P["p_dyn"] * f_noc) * vn)
                             * vn))
        else:
            v = P["v_base"] + P["v_slope"] * f_tile
            pf = (P["p_dyn"] * f_tile) * (v * v)
            vn = P["v_base"] + P["v_slope"] * f_noc
            noc_p = P["noc_share"] * (P["p_static"] + (P["p_dyn"] * f_noc)
                                      * (vn * vn))
        return t_comp, t_wire, pf, noc_p[:, 0], lbf

    t_comp, t_wire, pf, noc_p, lbf = service(rates)

    def z(*shape):
        return torch.zeros(shape, dtype=f32, device=dev)

    queue, busy, rtt, cbusy, fw = z(B, A), z(B, A), z(B, A), z(B, A), z(B, A)
    dropped, energy, swaps = z(B), z(B), z(B)
    adm_hist = torch.empty((T, B, A), dtype=f32, device=dev)
    srv_hist = torch.empty((T, B, A), dtype=f32, device=dev)

    for t in range(T):
        ae = arrivals[t]
        if shared:
            ae = ae.unsqueeze(0).expand(B, A)
        if fwd is not None:
            ae = ae + fw
        q = queue + ae
        adm = ae
        if maxq_on:
            over = torch.clamp(q - P["max_q"], min=0.0)
            q = q - over
            adm = adm - over
            dropped = dropped + _seq_sum(over)

        if dyn_on:
            d = demand * busy                                  # prev. busy
            loads = z(B, L)
            for a in range(A):
                loads = loads + d[:, a:a + 1] * inc[:, a, :]
            rmax = (inc * loads.unsqueeze(1)).amax(dim=-1)
            r = torch.clamp(rmax / lbf, max=0.999)
            dyn = torch.clamp(1.0 + r / (2.0 * (1.0 - r)),
                              max=P["max_slow"])
        else:
            dyn = torch.ones_like(q)

        cap = ((bt / (t_comp + t_wire * dyn)) / req) * P["dt"]
        served = torch.minimum(q, cap)
        queue = q - served
        busy = served / cap
        rtt = rtt + (hop * dyn) * P["hop_lat"]
        tile_p = P["p_static"] + pf * busy
        if tech_on:
            tile_p = P["t_ps"] * tile_p
        energy = energy + (_seq_sum(tile_p) + noc_p) * P["dt"]
        cbusy = cbusy + busy
        if fwd is not None:
            fw = z(B, A)
            for a in range(A):
                fw = fw + served[:, a:a + 1] * fwd[a]
        adm_hist[t] = adm
        srv_hist[t] = served

        if control and ci > 0 and (t + 1) % ci == 0:
            util = cbusy / P["util_div"]
            twn = t_wire * dyn
            bound = twn / (tcr + twn)
            qt = queue / torch.clamp(cap, min=1e-12)
            su, sb = z(B, I), z(B, I)
            for a in range(A):
                su = su + util[:, a:a + 1] * memb[:, a]
                sb = sb + bound[:, a:a + 1] * memb[:, a]
            util_i = su / counts_safe
            bound_i = sb / counts_safe
            neg_inf = torch.full((), float("-inf"), dtype=f32, device=dev)
            qt_i = torch.where(memb.unsqueeze(0) > 0, qt.unsqueeze(1),
                               neg_inf).amax(dim=-1)
            qt_i = torch.where(counts_pos, qt_i, torch.zeros_like(qt_i))

            rq = rates
            valid = torch.zeros((B, I), dtype=torch.bool, device=dev)
            if plan.kind == "membound":
                rq = torch.where(bound_i >= P["threshold"],
                                 torch.full_like(rates, P["low_rate"]),
                                 torch.ones_like(rates))
                valid = (~skip).unsqueeze(0).expand(B, I)
            elif plan.kind == "pid":
                err = torch.where(skip, torch.zeros_like(util_i),
                                  util_i - P["target"])
                i_term = torch.clamp(pol0 + err, -P["integral_clamp"],
                                     P["integral_clamp"])
                d_term = torch.where(has, err - pol1, torch.zeros_like(err))
                new = ((rates + P["kp"] * err) + P["ki"] * i_term) \
                    + P["kd"] * d_term
                rq = torch.clamp(new, P["min_rate"], 1.0)
                valid = (~skip).unsqueeze(0).expand(B, I)
                pol0, pol1 = i_term, err
                has = torch.ones_like(has)
            elif plan.kind == "ewma":
                ew = torch.where(
                    has, P["alpha"] * util_i + P["one_m_alpha"] * pol0,
                    util_i)
                raw = torch.clamp(rates * (ew / P["target"]),
                                  P["min_rate"], 1.0)
                valid = (~skip).unsqueeze(0) & ~torch.isnan(raw)
                rq = torch.where(valid, raw, rates)
                pol0 = ew
                has = torch.ones_like(has)

            if guard_on:
                latch = torch.where(
                    qt_i > P["guard"], torch.ones_like(guard),
                    torch.where(qt_i < P["guard_release"],
                                torch.zeros_like(guard), guard))
                latch = latch & ~fixed
                rq = torch.where(latch,
                                 torch.full_like(rq, P["guard_rate"]), rq)
                valid = valid | latch
                guard = latch
            if clamp_on:
                rq = torch.clamp(rq, P["tech_lo"], P["tech_hi"])

            dist = torch.abs(levels.unsqueeze(0) - rq.unsqueeze(-1))
            if clamp_on:
                dist = torch.where(legal.unsqueeze(0), dist,
                                   torch.full_like(dist, float("inf")))
            # first minimum, as argmin: scan levels in order, strict "<"
            best = dist[..., 0]
            qz = levels[:, 0].unsqueeze(0).expand(B, I)
            for j in range(1, levels.shape[1]):
                better = dist[..., j] < best
                best = torch.where(better, dist[..., j], best)
                qz = torch.where(better, levels[:, j].unsqueeze(0), qz)
            changed = valid & ~fixed & (qz != rates)
            rates = torch.where(changed, qz, rates)
            committed = changed.any(dim=-1)
            swaps = swaps + committed.to(f32)
            t_comp, t_wire, pf, noc_p, lbf = service(rates)
            cbusy = z(B, A)

    polF: Tuple[torch.Tensor, ...] = ()
    if plan.n_state == 2:
        polF = (pol0, pol1, has)
    elif plan.n_state == 1:
        polF = (pol0, has)
    return _out_dict(adm_hist, srv_hist, queue, busy, rtt, rates, guard,
                     dropped, energy, swaps, polF)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_ARGTYPES_SET = False


def _kernel_fn():
    global _ARGTYPES_SET
    from repro_torch.kernels import build
    fn = build.library("tick_sim").tick_sim_launch
    if not _ARGTYPES_SET:
        fn.argtypes = ([ctypes.POINTER(_TickParams)]
                       + [ctypes.c_void_p] * 27)
        fn.restype = ctypes.c_int
        _ARGTYPES_SET = True
    return fn


def link_masks(inc: torch.Tensor) -> torch.Tensor:
    """``(B, A, L)`` 0/1 incidence rows -> ``(B, A)`` int64 link bit masks
    (bit ``l`` set iff the tile's route crosses link ``l``; ``L <= 64``)."""
    L = inc.shape[-1]
    bits = torch.bitwise_left_shift(
        torch.ones(L, dtype=torch.int64, device=inc.device),
        torch.arange(L, dtype=torch.int64, device=inc.device))
    return ((inc > 0.5).to(torch.int64) * bits).sum(dim=-1)


def _launch_kernel(arrivals, consts, scalars, init, plan: ControlPlan):
    T, B, A, I, L, shared = _check_inputs(arrivals, consts, scalars, init,
                                          plan)
    dev = arrivals.device
    f32 = torch.float32
    fn = _kernel_fn()
    control = plan.kind != "none"

    P = _TickParams()
    for name, val in _scalar_params(scalars, plan).items():
        setattr(P, name, val)
    fwd_np = scalars.get("forward")
    P.T, P.B, P.A, P.I = T, B, A, I
    P.noc_idx, P.ci = int(scalars["noc_idx"]), int(scalars["ci"])
    P.kind = KINDS.index(plan.kind)
    P.dyn_on = int(bool(scalars["dyn_on"]))
    P.maxq_on = int(float(scalars["max_q"]) != float("inf"))
    P.has_fwd = int(fwd_np is not None)
    P.tech_on = int(bool(scalars.get("tech_on", False)))
    P.guard_on = int(control and plan.guard is not None)
    P.clamp_on = int(control and plan.tech_lo is not None)
    P.arr_shared = int(shared)

    def dev_t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    cA = torch.stack([consts[n] for n in
                      ("base", "req", "w", "k", "hop", "tcr")]).contiguous()
    lmask = link_masks(consts["inc"]).contiguous()
    ftg = consts["ftg"].reshape(B).contiguous()
    iot = dev_t(np.asarray(scalars["iot"]), torch.int32)
    demand = dev_t(np.broadcast_to(
        np.asarray(scalars["demand"], dtype=np.float32), (A,)), f32)
    fwd = dev_t(np.asarray(fwd_np, dtype=np.float32), f32) \
        if fwd_np is not None else None
    if control:
        tb = plan.tables(A)
        P.Lmax = int(tb["levels"].shape[1])
        ctab = dev_t(np.concatenate([tb[n].ravel() for n in _TABLE_ORDER]),
                     f32)
    else:
        P.Lmax = 0
        ctab = torch.zeros(1, dtype=f32, device=dev)

    pol = tuple(init.get("pol", ()))
    guard0 = init["guard"].to(torch.uint8)
    p0_in = pol[0] if plan.n_state >= 1 else None
    p1_in = pol[1] if plan.n_state >= 2 else None
    has_in = pol[-1].reshape(B).to(torch.uint8) if pol else None

    def e(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    adm, served = e(T, B, A), e(T, B, A)
    queue, busy, rtt = e(B, A), e(B, A), e(B, A)
    ratesF, guardF = e(B, I), e(B, I, dtype=torch.uint8)
    dropped, energy, swaps = e(B), e(B), e(B)
    p0_out = e(B, I) if plan.n_state >= 1 else None
    p1_out = e(B, I) if plan.n_state >= 2 else None
    has_out = e(B, dtype=torch.uint8) if pol else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    # The launch is asynchronous and the temporaries above are dropped when
    # this function returns; that is safe because they were allocated on the
    # stream the kernel runs on, and the caching allocator hands their memory
    # out again only to work queued behind the kernel on that stream.
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(ctypes.byref(P), ptr(arrivals), ptr(cA), ptr(lmask),
                ptr(ftg), ptr(iot), ptr(demand), ptr(fwd),
                ptr(init["rates"]), ptr(guard0), ptr(p0_in), ptr(p1_in),
                ptr(has_in), ptr(ctab), ptr(adm), ptr(served), ptr(queue),
                ptr(busy), ptr(rtt), ptr(ratesF), ptr(guardF), ptr(dropped),
                ptr(energy), ptr(swaps), ptr(p0_out), ptr(p1_out),
                ptr(has_out), stream)
    if rc != 0:
        raise RuntimeError(
            f"tick_sim kernel launch failed (code {rc}) for T={T} B={B} "
            f"A={A} I={I} L={L}")
    fused_tick_sim.launches += 1

    polF: Tuple[torch.Tensor, ...] = ()
    if plan.n_state == 2:
        polF = (p0_out, p1_out, has_out.to(torch.bool).reshape(B, 1))
    elif plan.n_state == 1:
        polF = (p0_out, has_out.to(torch.bool).reshape(B, 1))
    return _out_dict(adm, served, queue, busy, rtt, ratesF,
                     guardF.to(torch.bool), dropped, energy, swaps, polF)


def fused_tick_sim(arrivals, consts, scalars, init, *,
                   plan: Optional[ControlPlan] = None):
    """Run ``T`` fused simulator ticks over a ``(T, B, A)`` arrival tensor
    (or a shared ``(T, A)`` one, read with a zero batch stride).

    ``consts``: per-design float32 tensors — ``base``/``req``/``w``/``k``/
    ``hop``/``tcr`` ``(B, A)``, ``inc`` ``(B, A, L)`` with 0/1 rows, ``ftg``
    ``(B, 1)``.  ``scalars``: Python-level model/config constants —
    ``dt/own/tgd/link_bw/max_slow/hop_lat/hop_share/hopf0/noc_share/n_tg/
    dyn_on/max_q/ci/noc_idx``, ``iot`` (tile -> island index), ``demand``
    (float or ``(A,)``), ``forward`` (``(A, A)`` or ``None``) and optionally
    ``tech_on/t_ps/t_v0/t_v1``.  ``init``: ``rates`` ``(B, I)`` float32,
    ``guard`` ``(B, I)`` bool and ``pol``, the policy state the plan's kind
    carries (PID: integral, previous error, flag ``(B, 1)``; EWMA: ewma,
    flag).  ``plan``: the :class:`ControlPlan` (``None`` = open loop); a
    control tick is every ``ci``-th tick.

    Returns a dict of tensors on the inputs' device: ``adm``/``served``
    ``(T, B, A)`` histories, final ``queue``/``busy``/``rtt`` ``(B, A)``,
    ``rates`` ``(B, I)``, ``guard`` ``(B, I)`` bool, ``dropped``/``energy``/
    ``swaps`` ``(B,)`` float32 and the evolved ``pol`` tuple.

    CUDA tensors: launches the kernel on the current stream (no
    synchronisation) or raises.  CPU tensors: runs the plain version.
    ``fused_tick_sim.launches`` counts kernel launches.
    """
    plan = plan if plan is not None else ControlPlan()
    if torch.is_tensor(arrivals) and arrivals.device.type == "cuda":
        return _launch_kernel(arrivals, consts, scalars, init, plan)
    return fused_tick_sim_plain(arrivals, consts, scalars, init, plan=plan)


fused_tick_sim.launches = 0
