"""Port vs reference: the load balancer, the replicated pipeline (a
two-stage chain) and the LB+DFS scenario.

The same seeded NumPy inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``).  Tolerances:

* ``LoadBalancer.split`` (tensors in the port, arrays in the reference):
  **bit-equal**, any mode, leading axes, alive mask, zero-weight groups —
  the port adds each group's members in NumPy einsum's order;
* inside the port, ``BatchSimEngine("torch")`` at B = 1 equals
  ``SimEngine`` **bit for bit** on the chain with every combination of DFS
  controller and balancer (histories, state, energy, completed, p50/p99),
  as the reference's ``tests/test_sim_flows.py`` demands of itself;
* port vs reference: p50/p99, swaps and live rates exact; energy, residual
  and the histories bit-equal; ``completed`` <= 1e-12 relative (on CPU
  tensors the port adds it in NumPy's order, so it is equal here too);
* ``closed_loop_score`` under a pipeline with the balancer: the sequential
  and batched paths give identical scores, as the reference's do, and the
  reference's ranking;
* the float32 ``"torch"`` loop with the balancer against the float64 loop:
  rtol 2e-3 / atol 1e-2 (the float32 bar of ROADMAP's ground rules), swaps
  exact.
"""
from functools import partial

import numpy as np
import pytest
import torch

from _torch_port_helpers import PORT, REF, rel_err

STAGE0 = ("fe0", "fe1", "fe2")
STAGE1 = ("be0", "be1", "be2")
GROUPS = (STAGE0, STAGE1)
DT = 1e-3


# --------------------------------------------------------------- fixtures
def pipeline_platform(pkg, *, noc_rate=1.0, chained=True):
    """3 front-end + 3 back-end stream-bound tiles chained front->back."""
    m = pkg.pm.SoCPerfModel()
    pos = [(r, c) for r in range(4) for c in range(4)
           if (r, c) not in {(1, 0), (0, 0), (0, 3)}][:6]
    wls = [pkg.pm.AccelWorkload("dfmul", 8.70, 1.1, replication=8)
           for _ in pos]
    return pkg.sim.SimPlatform.build(
        m, wls, pos, names=STAGE0 + STAGE1, noc_rate=noc_rate, n_tg=2,
        req_mb=0.005,
        flows=pkg.sim.FlowPattern.chain(STAGE0, STAGE1) if chained else None)


def hotspot_arrivals(rate_per_tick, ticks=900, *, seed=3, spread=False):
    """External arrivals on the front-end stage only — all on fe0 (the
    hotspot) or evenly over the stage."""
    rng = np.random.default_rng(seed)
    arr = np.zeros((ticks, 6))
    lam = np.full(3, rate_per_tick / 3.0) if spread else \
        np.asarray([rate_per_tick, 0.0, 0.0])
    arr[:, :3] = rng.poisson(np.broadcast_to(lam, (ticks, 3)))
    return arr


def seq_engine(pkg, plat, **kw):
    if pkg is PORT:
        kw.setdefault("device", "cpu")
    return pkg.sim.SimEngine(plat, **kw)


def membound(pkg, plat):
    return pkg.sim.ControllerHarness(
        plat.islands, partial(pkg.dfs.policy_memory_bound, threshold=0.55,
                              low_rate=0.5), queue_guard_ticks=3.0)


def batch_controller(pkg, bplat, policy, **kw):
    return pkg.sim.BatchControllerHarness(bplat.islands, bplat.rates, policy,
                                          tile_names=bplat.names, **kw)


def assert_seq_matches_reference(port, ref, port_eng, ref_eng):
    for f in ("energy_j", "residual", "dropped", "p50_latency_s",
              "p99_latency_s", "swaps", "offered"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("completed", "throughput_rps", "energy_per_request_j"):
        assert rel_err(getattr(port, f), getattr(ref, f)) <= 1e-12, f
    for a, b in zip(port_eng.last_histories, ref_eng.last_histories):
        np.testing.assert_array_equal(a.numpy(), b)
    for f in ("queue", "busy", "pkts_in", "pkts_out", "rtt_acc"):
        np.testing.assert_array_equal(
            getattr(port_eng.last_state, f).numpy(),
            getattr(ref_eng.last_state, f), err_msg=f)


# ------------------------------------------------------------ the balancer
def split_both(groups, names, mode, arr, queue, cap, alive=None):
    """(reference, port) splits of the same inputs; the port's as NumPy."""
    ref = REF.sim.LoadBalancer(groups, names, mode=mode).split(
        arr, queue, cap, alive=alive)
    t = [None if a is None else torch.as_tensor(np.asarray(a, np.float64))
         for a in (arr, queue, cap, alive)]
    port = PORT.sim.LoadBalancer(groups, names, mode=mode).split(
        t[0], t[1], t[2], alive=t[3])
    assert port.dtype == torch.float64
    return ref, port.numpy()


def check_balancer_split(arr, queue, cap, groups, names, mode):
    ref, out = split_both(groups, names, mode, arr, queue, cap)
    np.testing.assert_array_equal(out, ref)
    assert out.shape == np.asarray(arr).shape
    assert np.all(out >= -1e-12)
    for g in groups:
        ids = [names.index(t) for t in g]
        np.testing.assert_allclose(out[..., ids].sum(axis=-1),
                                   np.asarray(arr)[..., ids].sum(axis=-1),
                                   rtol=1e-9, atol=1e-9)
    ungrouped = [i for i, n in enumerate(names)
                 if not any(n in g for g in groups)]
    if ungrouped:
        np.testing.assert_array_equal(out[..., ungrouped],
                                      np.asarray(arr)[..., ungrouped])


BAL_SEEDS = [(s, m) for s in range(3)
             for m in ("even", "capacity", "adaptive")]


@pytest.mark.parametrize("seed,mode", BAL_SEEDS)
def test_balancer_split_sums_seeded(seed, mode):
    rng = np.random.default_rng(seed)
    names = tuple(f"t{i}" for i in range(7))
    groups = (("t0", "t1", "t2"), ("t4", "t5"))
    lead = () if seed == 0 else (4,)
    check_balancer_split(rng.gamma(1.0, 20.0, lead + (7,)),
                         rng.gamma(1.0, 5.0, lead + (7,)),
                         rng.random(lead + (7,)) * 10 + 0.1,
                         groups, names, mode)


@pytest.mark.parametrize("seed", range(6))
def test_balancer_split_random_layouts_bit_equal(seed):
    """Random group layouts over 1-15 tiles (groups of up to 15 members,
    so the eight-member blocks of the reference's sum are crossed), zero
    and NaN-producing capacities, one- and two-axis operands, an alive
    mask: bit-equal to the reference."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(40):
        A = int(rng.integers(1, 16))
        names = tuple(f"t{i}" for i in range(A))
        perm = rng.permutation(A)[:int(rng.integers(1, A + 1))]
        parts = np.array_split(perm, int(rng.integers(1, len(perm) + 1)))
        groups = [tuple(names[j] for j in p) for p in parts if len(p)]
        lead = [(), (3,), (1,)][int(rng.integers(3))]
        arr = rng.gamma(1.0, 20.0, lead + (A,)) * np.exp(
            rng.uniform(-8, 8, lead + (A,)))
        queue = rng.gamma(1.0, 5.0, lead + (A,))
        cap = rng.random(lead + (A,)) * 10
        cap[..., rng.random(A) < 0.25] = 0.0
        if rng.random() < 0.2:
            queue[..., 0] = -1.0                # cap / 0 -> inf / nan
        alive = (rng.random(lead + (A,)) < 0.8).astype(np.float64) \
            if rng.random() < 0.5 else None
        for mode in REF.sim.LoadBalancer.MODES:
            ref, port = split_both(groups, names, mode, arr, queue, cap,
                                   alive)
            np.testing.assert_array_equal(port, ref)


def test_balancer_zero_weight_group_falls_back_to_even_split():
    names = ("a", "b", "c", "d")
    groups = (("a", "b"), ("c", "d"))
    arr = np.asarray([10.0, 2.0, 8.0, 0.0])
    queue = np.zeros(4)
    cap = np.asarray([0.0, 0.0, 3.0, 1.0])     # group 0 fully gated
    for mode in ("capacity", "adaptive"):
        _, out = split_both(groups, names, mode, arr, queue, cap)
        np.testing.assert_allclose(out[:2], [6.0, 6.0], err_msg=mode)
        np.testing.assert_allclose(out[2:].sum(), 8.0, err_msg=mode)
    check_balancer_split(arr, queue, cap, groups, names, "capacity")


def test_balancer_group_validation():
    names = ("a", "b", "c")
    LB = PORT.sim.LoadBalancer
    with pytest.raises(AssertionError):
        LB([("a", "zz")], names)
    with pytest.raises(AssertionError):
        LB([("a",), ("a", "b")], names)      # overlapping
    with pytest.raises(AssertionError):
        LB([("a", "b")], names, mode="nope")
    with pytest.raises(AssertionError):
        LB([()], names)                       # empty group
    lb, ref = LB({"g": ("c", "a")}, names), REF.sim.LoadBalancer(
        {"g": ("c", "a")}, names)
    np.testing.assert_array_equal(lb.membership, ref.membership)
    np.testing.assert_array_equal(lb.covered, ref.covered)
    np.testing.assert_array_equal(lb.group_of, ref.group_of)
    # no group at all: arrivals pass through
    x = torch.arange(3.0, dtype=torch.float64)
    assert torch.equal(LB([], names).split(x, x, x), x)


# ------------------------------------------------------ differential: B=1
@pytest.mark.parametrize("kind", ["hotspot", "spread", "mmpp"])
@pytest.mark.parametrize("ctl,lb", [(False, False), (True, False),
                                    (False, True), (True, True)])
def test_pipeline_b1_matches_sequential_bitforbit(kind, ctl, lb):
    """In the port, the B = 1 batched chain replay == the sequential
    engine bit for bit, with every combination of DFS controller and
    balancer; the sequential run also equals the reference's."""
    plat = pipeline_platform(PORT)
    bplat = PORT.sim.BatchSimPlatform.stack([plat])
    if kind == "mmpp":
        cap = seq_engine(PORT, plat).capacity_rps()
        tr = PORT.sim.mmpp_trace(cap * 0.1, cap * 1.2, 700, 6, dt=DT, seed=4)
        arrivals = tr.arrivals
    else:
        arrivals = hotspot_arrivals(14.0, 700, spread=(kind == "spread"))
        tr = PORT.sim.Trace(arrivals, DT)
    cfg = PORT.sim.SimConfig(control_interval=25)
    s_ctl = membound(PORT, plat) if ctl else None
    b_ctl = (batch_controller(
        PORT, bplat, PORT.dfs.BatchMemoryBoundPolicy(threshold=0.55,
                                                     low_rate=0.5),
        queue_guard_ticks=3.0) if ctl else None)

    def mk_lb(pkg, names):
        return pkg.sim.LoadBalancer(GROUPS, names) if lb else None

    seq_eng = seq_engine(PORT, plat, config=cfg, controller=s_ctl,
                         balancer=mk_lb(PORT, plat.names))
    seq = seq_eng.run(tr)
    bat_eng = PORT.sim.BatchSimEngine(bplat, config=cfg, controller=b_ctl,
                                      balancer=mk_lb(PORT, bplat.names),
                                      device="cpu")
    bat = bat_eng.run(tr)
    for f in ("completed", "residual", "energy_j", "p50_latency_s",
              "p99_latency_s"):
        assert getattr(bat, f)[0] == getattr(seq, f), f
    for f in ("queue", "busy", "pkts_in", "pkts_out", "rtt_acc"):
        assert torch.equal(getattr(bat_eng.last_state, f)[0],
                           getattr(seq_eng.last_state, f)), f
    for a, b in zip(bat_eng.last_histories, seq_eng.last_histories):
        assert torch.equal(a[:, 0], b)
    if ctl:
        assert int(bat.swaps[0]) == seq.swaps
        seq_rates = np.asarray([i.rate for i in s_ctl.live().islands])
        np.testing.assert_array_equal(b_ctl.rates[0], seq_rates)

    rplat = pipeline_platform(REF)
    r_ctl = membound(REF, rplat) if ctl else None
    ref_eng = seq_engine(REF, rplat, config=REF.sim.SimConfig(
        control_interval=25), controller=r_ctl,
        balancer=mk_lb(REF, rplat.names))
    ref = ref_eng.run(REF.sim.Trace(arrivals, DT))
    assert_seq_matches_reference(seq, ref, seq_eng, ref_eng)


# ------------------------------------------ per-design arrival tensors
@pytest.mark.parametrize("controlled", [False, True])
def test_broadcast_batch_trace_reproduces_shared_trace_exactly(controlled):
    """(T, A) broadcast to (T, B, A) == the shared-trace replay, bit for
    bit, flows + balancer + controller in the loop."""
    plats = [pipeline_platform(PORT, noc_rate=r) for r in (1.0, 0.8, 0.6)]
    bplat = PORT.sim.BatchSimPlatform.stack(plats)
    tr = PORT.sim.Trace(hotspot_arrivals(12.0, 600), DT)
    cfg = PORT.sim.SimConfig(control_interval=25)

    def mk():
        ctl = (batch_controller(PORT, bplat,
                                PORT.dfs.BatchPIDRatePolicy(target=0.7),
                                queue_guard_ticks=3.0)
               if controlled else None)
        return PORT.sim.BatchSimEngine(
            bplat, config=cfg, controller=ctl,
            balancer=PORT.sim.LoadBalancer(GROUPS, bplat.names),
            device="cpu")

    e_shared = mk()
    r_shared = e_shared.run(tr)
    e_bcast = mk()
    r_bcast = e_bcast.run(PORT.sim.BatchTrace.broadcast(tr, 3))
    for f in ("completed", "residual", "energy_j", "p50_latency_s",
              "p99_latency_s", "dropped", "swaps"):
        np.testing.assert_array_equal(getattr(r_bcast, f),
                                      getattr(r_shared, f), err_msg=f)
    assert torch.equal(e_bcast.last_histories[1], e_shared.last_histories[1])


def test_stacked_batch_trace_rows_match_per_design_sequential():
    """Each design of a (T, B, A) tensor replays its own trace: batch rows
    are bit for bit the sequential runs on the per-design slices."""
    plat = pipeline_platform(PORT)
    B = 3
    traces = [PORT.sim.Trace(hotspot_arrivals(10.0 + 3 * b, 500, seed=b,
                                              spread=(b == 1)), DT)
              for b in range(B)]
    bt = PORT.sim.BatchTrace.stack(traces)
    bplat = PORT.sim.BatchSimPlatform.stack([plat] * B)
    bat_eng = PORT.sim.BatchSimEngine(
        bplat, balancer=PORT.sim.LoadBalancer(GROUPS, plat.names),
        device="cpu")
    bat = bat_eng.run(bt)
    for b in range(B):
        seq_eng = seq_engine(PORT, plat, balancer=PORT.sim.LoadBalancer(
            GROUPS, plat.names))
        seq = seq_eng.run(bt.design(b))
        assert torch.equal(bat_eng.last_histories[0][:, b],
                           seq_eng.last_histories[0])
        assert torch.equal(bat_eng.last_histories[1][:, b],
                           seq_eng.last_histories[1])
        assert bat.energy_j[b] == seq.energy_j, b
        assert bat.p99_latency_s[b] == seq.p99_latency_s, b
        assert bat.residual[b] == seq.residual, b
        np.testing.assert_allclose(bat.completed[b], seq.completed,
                                   rtol=1e-12)


# ------------------------------------------------------------- invariants
def check_pipeline_invariants(ext_arrivals, *, lb_mode=None, control=False,
                              max_queue=float("inf")) -> None:
    """Replay a random external trace through the chained platform (port,
    sequential engine) and assert the fluid/chain invariants at every
    tick; the run equals the reference's."""
    ext_arrivals = np.asarray(ext_arrivals, dtype=np.float64)
    runs = {}
    for pkg in (REF, PORT):
        plat = pipeline_platform(pkg)
        ctl = (pkg.sim.ControllerHarness(
            plat.islands, pkg.dfs.PIDRatePolicy(target=0.6),
            queue_guard_ticks=2.0) if control else None)
        lb = (pkg.sim.LoadBalancer(GROUPS, plat.names, mode=lb_mode)
              if lb_mode else None)
        eng = seq_engine(pkg, plat, config=pkg.sim.SimConfig(
            control_interval=10, max_queue=max_queue), controller=ctl,
            balancer=lb)
        runs[pkg.name] = (eng, eng.run(pkg.sim.Trace(ext_arrivals, DT)))
    (e0, r0), (eng, r) = runs["repro"], runs["repro_torch"]
    assert_seq_matches_reference(r, r0, eng, e0)
    admitted, served = (h.numpy() for h in eng.last_histories)
    ca = np.cumsum(admitted, axis=0)
    cs = np.cumsum(served, axis=0)
    backlog = ca - cs
    assert np.all(backlog >= -1e-9)
    assert np.all(served >= -1e-12)
    np.testing.assert_allclose(backlog[-1].sum(), r.residual,
                               rtol=1e-9, atol=1e-9)
    assert np.all(np.diff(cs, axis=0) >= -1e-12)
    np.testing.assert_array_less(cs[:, 3:].sum(axis=1),
                                 cs[:, :3].sum(axis=1) + 1e-9)
    if max_queue == float("inf"):
        fwd = np.einsum("ta,aj->tj", served, eng._forward)
        np.testing.assert_allclose(
            admitted.sum(), ext_arrivals.sum() + fwd[:-1].sum(), rtol=1e-9)
        np.testing.assert_allclose(
            r.completed + backlog[-1].sum() + fwd[-1].sum(),
            ext_arrivals.sum(), rtol=1e-9, atol=1e-9)
        assert r.completed <= ext_arrivals.sum() + 1e-9


PIPE_SEEDS = [
    (0, None, False, float("inf")), (1, "adaptive", False, float("inf")),
    (2, "capacity", True, float("inf")), (3, "even", True, 25.0),
    (4, "adaptive", True, 10.0),
]


@pytest.mark.parametrize("seed,lb_mode,control,max_queue", PIPE_SEEDS)
def test_pipeline_invariants_seeded(seed, lb_mode, control, max_queue):
    rng = np.random.default_rng(seed)
    T = int(rng.integers(30, 90))
    ext = np.zeros((T, 6))
    ext[:, :3] = rng.gamma(1.5, 6.0, size=(T, 3)) * rng.random((T, 1))
    check_pipeline_invariants(ext, lb_mode=lb_mode, control=control,
                              max_queue=max_queue)


# ----------------------------------------------- DSE bridge: flows in loop
_SWEEPS = {}


def _pipeline_sweep(pkg):
    if pkg.name not in _SWEEPS:
        m = pkg.pm.SoCPerfModel()
        wls = [pkg.pm.AccelWorkload("dfadd", 9.22, 0.9),
               pkg.pm.AccelWorkload("dfmul", 8.70, 1.1)]
        kw = {"device": "cpu"} if pkg is PORT else {}
        _SWEEPS[pkg.name] = (m, pkg.dse.grid_sweep(
            m, wls, ks=(1, 2, 4, 8), acc_rates=(0.2, 0.6, 1.0),
            noc_rates=(0.5, 1.0), n_tg=2, **kw))
    return _SWEEPS[pkg.name]


def test_closed_loop_score_pipeline_batch_matches_sequential():
    """Scoring survivors under a pipeline workload (flows= + balancer in
    the loop): the batched replay == the sequential path, scores and
    ranking identical, in the port as in the reference; and the port's
    ranking is the reference's."""
    ext = np.zeros((400, 2))
    ext[:, 0] = np.random.default_rng(5).poisson(3.0, 400)
    out = {}
    for pkg in (REF, PORT):
        m, res = _pipeline_sweep(pkg)
        kw = dict(model=m, indices=res.topk_indices(12), req_mb=0.002,
                  flows=pkg.sim.FlowPattern.chain(("dfadd",), ("dfmul",)),
                  sim_config=pkg.sim.SimConfig(control_interval=25),
                  balancer_factory=lambda p, pkg=pkg: pkg.sim.LoadBalancer(
                      [("dfadd",), ("dfmul",)], p.names))
        if pkg is PORT:
            kw["device"] = "cpu"
        tr = pkg.sim.Trace(ext, DT)
        seq = pkg.dse.closed_loop_score(
            res, tr, batch=False,
            controller_factory=lambda p, pkg=pkg: pkg.sim.ControllerHarness(
                p.islands, pkg.dfs.PIDRatePolicy(target=0.7),
                queue_guard_ticks=3.0), **kw)
        bat = pkg.dse.closed_loop_score(
            res, tr,
            batch_controller_factory=lambda bp, pkg=pkg: batch_controller(
                pkg, bp, pkg.dfs.BatchPIDRatePolicy(target=0.7),
                queue_guard_ticks=3.0), **kw)
        np.testing.assert_array_equal(bat.p99_latency_s, seq.p99_latency_s)
        np.testing.assert_array_equal(bat.energy_per_request_j,
                                      seq.energy_per_request_j)
        np.testing.assert_array_equal(bat.ranked_indices(),
                                      seq.ranked_indices())
        out[pkg.name] = seq
    a, b = out["repro"], out["repro_torch"]
    np.testing.assert_array_equal(b.ranked_indices(), a.ranked_indices())
    np.testing.assert_array_equal(b.p99_latency_s, a.p99_latency_s)
    assert rel_err(b.energy_per_request_j, a.energy_per_request_j) <= 1e-12
    assert [r.swaps for r in b.results] == [r.swaps for r in a.results]


def test_closed_loop_score_accepts_batch_trace_both_paths():
    """A per-design (T, B, A) tensor scores each survivor on its own
    trace; the sequential path slices the same tensor per design and gives
    identical scores; a design-axis mismatch is refused on both paths."""
    m, res = _pipeline_sweep(PORT)
    idx = res.topk_indices(6)
    rng = np.random.default_rng(9)
    bt = PORT.sim.BatchTrace(rng.poisson(2.0, (300, 6, 2)).astype(float),
                             DT)
    a = PORT.dse.closed_loop_score(res, bt, model=m, indices=idx,
                                   req_mb=0.002, device="cpu")
    b = PORT.dse.closed_loop_score(res, bt, model=m, indices=idx,
                                   req_mb=0.002, batch=False, device="cpu")
    np.testing.assert_array_equal(a.p99_latency_s, b.p99_latency_s)
    np.testing.assert_array_equal(a.energy_per_request_j,
                                  b.energy_per_request_j)
    np.testing.assert_array_equal(a.ranked_indices(), b.ranked_indices())
    assert len(np.unique(a.p99_latency_s)) > 1 or \
        len(np.unique(a.energy_per_request_j)) > 1
    for batch in (True, False):
        with pytest.raises(AssertionError):
            PORT.dse.closed_loop_score(res, bt, model=m, indices=idx[:4],
                                       req_mb=0.002, batch=batch,
                                       device="cpu")


def test_float32_torch_loop_runs_the_balancer():
    """The float32 ``"torch"`` loop splits in float32 and stays within the
    float32 bar of the float64 loop (swaps exact)."""
    plats = [pipeline_platform(PORT, noc_rate=r) for r in (1.0, 0.8)]
    bplat = PORT.sim.BatchSimPlatform.stack(plats)
    tr = PORT.sim.Trace(hotspot_arrivals(12.0, 500, seed=1), DT)
    runs = {}
    for dtype in (torch.float64, torch.float32):
        ctl = batch_controller(
            PORT, bplat, PORT.dfs.BatchMemoryBoundPolicy(threshold=0.55,
                                                         low_rate=0.5),
            queue_guard_ticks=3.0)
        eng = PORT.sim.BatchSimEngine(
            bplat, config=PORT.sim.SimConfig(control_interval=25),
            controller=ctl, balancer=PORT.sim.LoadBalancer(GROUPS,
                                                           bplat.names),
            device="cpu", dtype=dtype)
        runs[dtype] = eng.run(tr)
        assert eng.last_histories[0].dtype == dtype
    a, b = runs[torch.float32], runs[torch.float64]
    for f in ("completed", "energy_j", "residual"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=2e-3,
                                   atol=1e-2, err_msg=f)
    np.testing.assert_allclose(a.p99_latency_s, b.p99_latency_s,
                               atol=2 * DT, rtol=0.05)
    np.testing.assert_array_equal(a.swaps, b.swaps)


# ------------------------------------------------------- the scenario gate
def scenario_runs(pkg, ticks=2500, seed=11):
    """LB+DFS vs DFS-only vs LB-only on the replicated pipeline SoC under
    a hotspot diurnal workload (all external load on fe0)."""
    plat = pipeline_platform(pkg)
    rng = np.random.default_rng(seed)
    t = np.arange(ticks)
    lam = 13.0 * (1.0 + 0.4 * np.sin(2 * np.pi * t / ticks))
    ext = np.zeros((ticks, 6))
    ext[:, 0] = rng.poisson(lam)
    tr = pkg.sim.Trace(ext, DT)
    cfg = pkg.sim.SimConfig(control_interval=25)

    def run(dfs, lb):
        return seq_engine(
            pkg, plat, config=cfg,
            controller=membound(pkg, plat) if dfs else None,
            balancer=(pkg.sim.LoadBalancer(GROUPS, plat.names) if lb
                      else None)).run(tr)

    return {"dfs_only": run(True, False), "lb_only": run(False, True),
            "lb_dfs": run(True, True)}


def test_scenario_lb_plus_dfs_beats_either_alone():
    """The acceptance gate through the port: LB+DFS achieves lower
    energy/request than DFS-only and than LB-only at matched p99, and each
    run equals the reference's."""
    ref, runs = scenario_runs(REF), scenario_runs(PORT)
    both, dfs, lb = runs["lb_dfs"], runs["dfs_only"], runs["lb_only"]
    assert both.energy_per_request_j < 0.97 * dfs.energy_per_request_j
    assert both.energy_per_request_j < 0.97 * lb.energy_per_request_j
    assert both.p99_latency_s <= dfs.p99_latency_s
    assert both.p99_latency_s <= max(2.0 * lb.p99_latency_s, 5e-3)
    assert both.completed >= 0.99 * lb.completed
    assert both.completed >= dfs.completed
    for name, r in runs.items():
        for f in ("p99_latency_s", "p50_latency_s", "swaps", "energy_j"):
            assert getattr(r, f) == getattr(ref[name], f), (name, f)
        assert rel_err(r.energy_per_request_j,
                       ref[name].energy_per_request_j) <= 1e-12, name
