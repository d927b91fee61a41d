"""Port vs reference: fault injection, SLO semantics, online fault detection
and fault-aware scoring (``repro_torch.sim.faults``,
``repro_torch.runtime.fault``, the fault hooks of the ``"torch"`` engines,
``closed_loop_score(fault_schedule=, slo=, max_drop_rate=)``).

Every case of ``tests/test_sim_faults.py`` is ported: the same seeded
inputs go through the reference package and the port (``device="cpu"``).
Tolerances:

* the float64 port against the reference NumPy engines: states, ledgers
  (``dropped_slo``, ``dropped_fault``, ``retried``), histories
  (``last_histories``, ``last_fault_histories`` incl. ``queue_drops``),
  p50 / p99, energy, telemetry rows and events — **array-equal**, and so
  is ``completed``, which the port adds in NumPy's order on CPU tensors
  (``BatchSimEngine._completed``; the reference's sequential and batched
  paths add it in two orders, so each is held to its own counterpart);
* the float32 ``"torch"`` loop against the reference: the reference's own
  float32-vs-NumPy limits (rtol 1e-3; ledgers atol 1e-2; drop rate atol
  1e-4; p99 atol dt);
* compiled masks, event lists, rankings and index sets: **exact**.

B = 1 equals the sequential engine bit for bit inside the port, including
``retry_q`` and ``queue_drops``.  The online detector runs on the device
inside the tick loop; its event list is rebuilt after the loop and must
equal the reference's tick-by-tick one.
"""
import json
from functools import partial

import numpy as np
import pytest
import torch

import repro.runtime.fault as ref_rt
import repro.sim.faults as ref_faults
import repro_torch.runtime.fault as port_rt
import repro_torch.sim.faults as port_faults
from repro.configs.vespa_soc import CHSTONE
from repro_torch.core.noc import routing_tables

from _torch_port_helpers import PORT, REF, chip_smoke

RT = {"repro": ref_rt, "repro_torch": port_rt}
STAGE0 = ("fe0", "fe1", "fe2")
STAGE1 = ("be0", "be1", "be2")
NAMES6 = ("a0", "a1", "a2", "b0", "b1", "b2")
EXACT = ("energy_j", "residual", "dropped", "p50_latency_s",
         "p99_latency_s", "mean_power_w", "offered", "swaps", "dropped_slo",
         "dropped_fault", "retried")
STATE = ("queue", "retry_q", "busy", "pkts_in", "pkts_out", "rtt_acc",
         "dropped", "energy", "dropped_slo", "dropped_fault", "retried")


# --------------------------------------------------------------- fixtures
def kw(pkg, **extra):
    if pkg is PORT:
        extra.setdefault("device", "cpu")
    return extra


def make_platform(pkg, n_tiles=6, *, req_mb=0.005, k=8, names=None,
                  flows=None, island_groups=None):
    m = pkg.pm.SoCPerfModel()
    pos = [(r, c) for r in range(4) for c in range(4)
           if (r, c) not in {(1, 0), (0, 0), (0, 3)}][:n_tiles]
    wls = [pkg.pm.AccelWorkload("dfmul", 8.70, 1.1, replication=k)
           for _ in pos]
    return pkg.sim.SimPlatform.build(m, wls, pos, names=names, n_tg=2,
                                     req_mb=req_mb, flows=flows,
                                     island_groups=island_groups)


def pipeline_platform(pkg):
    return make_platform(pkg, 6, names=STAGE0 + STAGE1,
                         flows=pkg.sim.FlowPattern.chain(STAGE0, STAGE1))


def capacity(pkg, plat):
    return pkg.sim.SimEngine(plat, **kw(pkg)).capacity_rps()


def faulted_setup(pkg, ticks=600, seed=4):
    plat = make_platform(pkg, 6, names=NAMES6)
    sched = (pkg.sim.FaultSchedule()
             .kill_tile("a1", start=150, end=380)
             .kill_tile("b2", start=300)
             .degrade_link((1, 1), (1, 2), 0.3, start=100, end=500))
    slo = pkg.sim.SLOConfig(deadline_s=0.03, on_kill="respill",
                            max_retries=1)
    tr = pkg.sim.diurnal_trace(capacity(pkg, plat) * 0.85, ticks, 6,
                               dt=1e-3, depth=0.5, seed=seed)
    return plat, sched, slo, tr, (NAMES6[:3], NAMES6[3:])


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_seq_equal(p_eng, p, r_eng, r):
    """A port sequential run against the reference's, at the module's
    tolerances: results, state, histories, fault histories, telemetry."""
    for f in EXACT:
        assert getattr(p, f) == getattr(r, f), f
    assert p.drop_rate == r.drop_rate
    assert p.completed == r.completed
    for f in STATE:
        np.testing.assert_array_equal(np_(getattr(p_eng.last_state, f)),
                                      getattr(r_eng.last_state, f), f)
    for a, b in zip(p_eng.last_histories, r_eng.last_histories):
        np.testing.assert_array_equal(np_(a), b)
    pf, rf = p_eng.last_fault_histories, r_eng.last_fault_histories
    assert (pf is None) == (rf is None)
    if rf is not None:
        assert set(pf) == set(rf)
        for k in rf:
            np.testing.assert_array_equal(np_(pf[k]), rf[k], k)
    assert p.telemetry.events == r.telemetry.events
    for ring in ("scalars", "island_rates", "queue_depth", "busy"):
        np.testing.assert_array_equal(
            getattr(p.telemetry, ring).array(),
            getattr(r.telemetry, ring).array(), ring)


# ------------------------------------------------------------ compilation
def _compile(pkg, sched_fn, plat_fn=partial(make_platform, n_tiles=4),
             ticks=50):
    plat = plat_fn(pkg)
    return plat, pkg.sim.compile_faults(
        sched_fn(pkg, plat), ticks=ticks, names=plat.names,
        islands=plat.islands, noc=plat.model.noc)


def _mixed_schedule(pkg, plat):
    names, isl = plat.names, plat.islands
    return (pkg.sim.FaultSchedule()
            .kill_tile(names[1], start=10, end=20)
            .kill_island(isl.names()[0], start=15, end=25)
            .degrade_link((1, 1), (1, 2), 0.25, start=5, end=30)
            .stick_island(isl.names()[-1], start=40, rate=0.3))


def test_compile_faults_windows_and_island_masks():
    """The compiled masks and events equal the reference's, and keep its
    semantics: half-open windows, island kills expand to sampled tiles,
    both directed links degrade, ``island_dead`` = all sampled tiles
    dead, tick-sorted transition events."""
    plat, cf = _compile(PORT, _mixed_schedule)
    _, ref = _compile(REF, _mixed_schedule)
    for f in ("tile_alive", "link_scale", "stuck", "stuck_rate",
              "island_dead"):
        np.testing.assert_array_equal(getattr(cf, f), getattr(ref, f), f)
    assert cf.events == ref.events
    assert cf.events_by_tick() == ref.events_by_tick()
    for f in ("has_tile", "has_link", "has_stuck", "has_stuck_rate"):
        assert getattr(cf, f) == getattr(ref, f) is True, f
    A = len(plat.names)
    assert cf.tile_alive.shape == (50, A)
    assert (cf.tile_alive[10:20, 1] == 0.0).all()
    tiles0 = [i for i, n in enumerate(plat.names)
              if n in plat.islands.islands[0].tiles]
    assert (cf.tile_alive[np.ix_(range(15, 25), tiles0)] == 0.0).all()
    assert cf.island_dead[16, 0] and not cf.island_dead[0].any()
    assert (cf.link_scale[5:30] < 1.0).sum(axis=1).max() == 2
    assert (cf.link_scale[0:5] == 1.0).all()
    assert (cf.link_scale[30:] == 1.0).all()
    assert cf.stuck[40:, -1].all() and not cf.stuck[:40, -1].any()
    assert np.isfinite(cf.stuck_rate[45, -1])
    ticks = [e["tick"] for e in cf.events]
    assert ticks == sorted(ticks)
    assert {"fault_kill", "fault_revive", "fault_link_degrade",
            "fault_stuck"} <= {e["kind"] for e in cf.events}
    # the ticks an engine recomputes its service terms at
    assert cf.stuck_rate_changes() == [0, 40]


@pytest.mark.parametrize("bad", ["tile", "island", "link", "scale",
                                 "empty_island"])
def test_compile_faults_rejects_unknown_names(bad):
    """Unknown names (and a non-adjacent link, a bad scale) are refused
    with the reference's messages."""
    def sched(pkg, plat):
        f = pkg.sim.FaultSchedule()
        return {"tile": lambda: f.kill_tile("nope", start=0),
                "island": lambda: f.kill_island("nope", start=0),
                "link": lambda: f.degrade_link((0, 0), (3, 3), 0.5,
                                               start=0),
                "scale": lambda: f.degrade_link((1, 1), (1, 2), 0.0,
                                                start=0),
                "empty_island": lambda: f.kill_island("noc_mem",
                                                      start=0)}[bad]()

    msgs = []
    for pkg in (REF, PORT):
        with pytest.raises(AssertionError) as err:
            _compile(pkg, sched, partial(make_platform, n_tiles=3),
                     ticks=10)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_slo_config_validation():
    for pkg in (REF, PORT):
        S = pkg.sim.SLOConfig
        for bad in (dict(on_kill="explode"), dict(max_retries=2),
                    dict(deadline_s=0.0)):
            with pytest.raises(AssertionError) as err:
                S(**bad)
            with pytest.raises(AssertionError) as ref_err:
                REF.sim.SLOConfig(**bad)
            assert str(err.value) == str(ref_err.value)
        assert S().recovers
        assert not S(on_kill="drop").recovers
        assert not S(max_retries=0).recovers
    assert PORT.sim.SLOConfig.ON_KILL == REF.sim.SLOConfig.ON_KILL


def test_respill_stranded_semantics():
    """Tensors through the port, arrays through the reference: the same
    floats, and the reference's semantics."""
    names = ("a", "b", "c", "d")
    q = np.array([2.0, 3.0, 1.0, 5.0])
    rq = np.array([0.5, 1.0, 0.0, 0.0])
    cases = [np.array([1.0, 0.0, 1.0, 1.0]), np.array([0.0, 0.0, 0.0, 1.0]),
             np.ones(4)]
    for alive in cases:
        for with_bal in (True, False):
            got = port_faults.respill_stranded(
                torch.as_tensor(q), torch.as_tensor(rq),
                torch.as_tensor(alive),
                PORT.sim.LoadBalancer([names[:3]], names, mode="even")
                if with_bal else None)
            want = ref_faults.respill_stranded(
                q, rq, alive,
                REF.sim.LoadBalancer([names[:3]], names, mode="even")
                if with_bal else None)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w)
    bal = PORT.sim.LoadBalancer([names[:3]], names, mode="even")
    t = torch.as_tensor
    q2, rq2, spill, dropped = port_faults.respill_stranded(
        t(q), t(rq), t(cases[0]), bal)
    np.testing.assert_array_equal(q2.numpy(), [2.0, 0.0, 1.0, 5.0])
    np.testing.assert_array_equal(rq2.numpy(), [0.5, 0.0, 0.0, 0.0])
    np.testing.assert_array_equal(spill.numpy(), [0.0, 2.0, 0.0, 0.0])
    np.testing.assert_array_equal(dropped.numpy(), [0.0, 1.0, 0.0, 0.0])
    # a (B, A) queue with one shared (A,) mask, and float32 tensors
    qb = t(np.stack([q, 2 * q]))
    out = port_faults.respill_stranded(qb, t(np.stack([rq, rq])),
                                       t(cases[0]), bal)
    want = ref_faults.respill_stranded(
        np.stack([q, 2 * q]), np.stack([rq, rq]), cases[0],
        REF.sim.LoadBalancer([names[:3]], names, mode="even"))
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g.numpy(), w)
    out32 = port_faults.respill_stranded(
        qb.float(), t(np.stack([rq, rq])).float(), t(cases[0]).float(), bal)
    for g, w in zip(out32, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)


def test_load_balancer_zero_capacity_and_nan_guard():
    """All-dead / zero-capacity groups emit no NaN, and alive masks steer a
    group's requests to its survivors — the port's split on tensors equals
    the reference's."""
    cases = [
        (("a", "b"), ("c", "d"), "capacity", [4.0, 0.0, 2.0, 2.0],
         [0.0] * 4, [0.0, 0.0, np.nan, -1.0], None),
        (("a", "b"), ("c", "d"), "capacity", [4.0, 0.0, 0.0, 0.0],
         [0.0] * 4, [1.0] * 4, [0.0, 1.0, 1.0, 1.0]),
        (("a", "b"), None, "adaptive", [2.0, 0.0], [1e308, 0.0],
         [0.0, 0.0], None),
    ]
    for g0, g1, mode, arr, q, cap, alive in cases:
        groups = [g0] + ([g1] if g1 else [])
        names = tuple(x for g in groups for x in g)
        outs = []
        for pkg, conv in ((REF, np.asarray), (PORT, torch.as_tensor)):
            bal = pkg.sim.LoadBalancer(groups, names, mode=mode)
            a = [conv(np.asarray(v, dtype=np.float64)) for v in (arr, q, cap)]
            out = bal.split(*a, alive=None if alive is None else conv(
                np.asarray(alive, dtype=np.float64)))
            outs.append(np_(out))
        np.testing.assert_array_equal(outs[1], outs[0])
        assert np.isfinite(outs[1]).all()
        assert outs[1].sum() == pytest.approx(sum(arr))
    assert outs[1].sum() == pytest.approx(2.0)


# ------------------------------------------------- differential: B=1 bits
def _faulted_seq(pkg, ticks=600):
    plat, sched, slo, tr, groups = faulted_setup(pkg, ticks)
    cfg = pkg.sim.SimConfig(telemetry_interval=20, telemetry_capacity=64)
    eng = pkg.sim.SimEngine(plat, config=cfg, faults=sched, slo=slo,
                            balancer=pkg.sim.LoadBalancer(
                                groups, plat.names, mode="even"),
                            **kw(pkg))
    return eng, eng.run(tr)


def test_batch_b1_matches_sequential_bitforbit_under_faults():
    """The port's B = 1 batched run equals its sequential run bit for bit
    (results, state incl. ``retry_q``, histories, ``queue_drops``), and
    both equal the reference's."""
    seq_eng, seq = _faulted_seq(PORT)
    plat, sched, slo, tr, groups = faulted_setup(PORT)
    cfg = PORT.sim.SimConfig(telemetry_interval=20, telemetry_capacity=64)
    bat_eng = PORT.sim.BatchSimEngine(
        PORT.sim.BatchSimPlatform.stack([plat]), config=cfg, faults=sched,
        slo=slo, balancer=PORT.sim.LoadBalancer(groups, plat.names,
                                                mode="even"), device="cpu")
    bat = bat_eng.run(tr)
    for f in ("completed", "residual", "energy_j", "p50_latency_s",
              "p99_latency_s", "dropped_slo", "dropped_fault", "retried",
              "drop_rate"):
        assert getattr(bat, f)[0] == getattr(seq, f), f
    assert seq.dropped_fault > 0.0 or seq.retried > 0.0
    assert seq.dropped_slo > 0.0
    for f in STATE:
        assert torch.equal(getattr(bat_eng.last_state, f)[0],
                           getattr(seq_eng.last_state, f)), f
    for sh, bh in zip(seq_eng.last_histories, bat_eng.last_histories):
        assert torch.equal(bh[:, 0], sh)
    for k, v in seq_eng.last_fault_histories.items():
        assert torch.equal(bat_eng.last_fault_histories[k][:, 0], v), k
    assert bat.telemetry.events == seq.telemetry.events
    ref_eng, ref = _faulted_seq(REF)
    assert_seq_equal(seq_eng, seq, ref_eng, ref)


def _batched_pair(pkg, dtype=None):
    plat, sched, slo, tr, groups = faulted_setup(pkg, ticks=500)
    # a stuck-rate fault, so the actuator-override path runs too
    sched = sched.stick_island(plat.islands.names()[0], start=50, end=250,
                               rate=0.4)
    bplat = pkg.sim.BatchSimPlatform.stack([plat, plat])
    extra = kw(pkg, **({"dtype": dtype} if dtype is not None else {}))
    eng = pkg.sim.BatchSimEngine(
        bplat, faults=sched, slo=slo,
        balancer=pkg.sim.LoadBalancer(groups, plat.names, mode="even"),
        **extra)
    return eng, eng.run(tr), tr


def test_batched_float64_equals_reference_under_faults():
    """Two designs, kills + link degrade + stuck rate + deadline + retry:
    the float64 ``"torch"`` loop equals the reference's ``"numpy"`` loop
    (results, state, fault histories, telemetry rows and events)."""
    pe, p, _ = _batched_pair(PORT)
    re_, r, _ = _batched_pair(REF)
    for f in ("energy_j", "residual", "dropped", "p50_latency_s",
              "p99_latency_s", "dropped_slo", "dropped_fault", "retried"):
        np.testing.assert_array_equal(getattr(p, f), getattr(r, f), f)
    np.testing.assert_array_equal(p.completed, r.completed)
    np.testing.assert_array_equal(p.drop_rate, r.drop_rate)
    for f in STATE:
        np.testing.assert_array_equal(np_(getattr(pe.last_state, f)),
                                      getattr(re_.last_state, f), f)
    for k, v in re_.last_fault_histories.items():
        np.testing.assert_array_equal(np_(pe.last_fault_histories[k]), v, k)
    assert p.telemetry.events == r.telemetry.events
    for ring in ("scalars", "island_rates", "queue_depth", "busy"):
        np.testing.assert_array_equal(getattr(p.telemetry, ring).array(),
                                      getattr(r.telemetry, ring).array())


def test_float32_loop_matches_numpy_under_faults():
    """The float32 ``"torch"`` loop against the reference's NumPy loop, at
    the reference's own float32-vs-NumPy limits."""
    _, p, tr = _batched_pair(PORT, torch.float32)
    _, r, _ = _batched_pair(REF)
    assert p.telemetry is None
    np.testing.assert_allclose(p.completed, r.completed, rtol=1e-3)
    np.testing.assert_allclose(p.energy_j, r.energy_j, rtol=1e-3)
    for f in ("dropped_slo", "dropped_fault", "retried"):
        np.testing.assert_allclose(getattr(p, f), getattr(r, f), rtol=1e-3,
                                   atol=1e-2, err_msg=f)
    np.testing.assert_allclose(p.drop_rate, r.drop_rate, rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(p.p99_latency_s, r.p99_latency_s, rtol=1e-3,
                               atol=tr.dt)


def test_fused_still_refuses_faults_and_slo():
    """The tick kernel keeps refusing the fault schedule and the SLO, at
    construction and when set afterwards, in its wording."""
    plat, sched, slo, tr, _ = faulted_setup(PORT, ticks=20)
    bplat = PORT.sim.BatchSimPlatform.stack([plat])
    for knob, value, text in (
            ("faults", sched, "fused backend does not simulate fault "
             "schedules; use backend='torch'"),
            ("slo", slo, "fused backend does not apply SLO semantics; "
             "use backend='torch'")):
        with pytest.raises(NotImplementedError) as err:
            PORT.sim.BatchSimEngine(bplat, backend="fused", device="cpu",
                                    **{knob: value})
        assert str(err.value) == text
        eng = PORT.sim.BatchSimEngine(bplat, backend="fused", device="cpu")
        setattr(eng, knob, value)
        with pytest.raises(NotImplementedError) as err:
            eng.run(tr)
        assert str(err.value) == text
        assert eng.last_histories is None


def test_fault_free_run_unchanged_by_empty_schedule():
    """An empty schedule is no schedule: the same floats, no ledger
    histories, as in the reference."""
    plat, _, _, tr, groups = faulted_setup(PORT, ticks=200)
    outs = []
    for faults in (None, PORT.sim.FaultSchedule()):
        eng = PORT.sim.SimEngine(plat, faults=faults, device="cpu",
                                 balancer=PORT.sim.LoadBalancer(
                                     groups, plat.names))
        outs.append((eng, eng.run(tr)))
    (e0, r0), (e1, r1) = outs
    assert e0.last_fault_histories is None and e1.last_fault_histories is None
    for f in EXACT + ("completed",):
        assert getattr(r0, f) == getattr(r1, f), f


# ----------------------------------------------------------- invariants
def check_conservation(eng, r, tr, *, in_flight=0.0):
    qd = np_(eng.last_fault_histories["queue_drops"])
    assert r.dropped_slo >= 0 and r.dropped_fault >= 0 and r.retried >= 0
    assert (qd >= -1e-9).all()
    total_q = float(eng.last_state.queue.sum())
    rhs = r.completed + r.dropped_slo + r.dropped_fault + total_q + in_flight
    np.testing.assert_allclose(float(np.asarray(tr.arrivals).sum()), rhs,
                               rtol=1e-9, atol=1e-6)
    assert (np_(eng.last_state.queue) >= 0.0).all()
    assert (np_(eng.last_state.retry_q) >= -1e-12).all()
    assert float(eng.last_state.retry_q.sum()) <= total_q + 1e-9
    # cumulative ledgers never decrease
    for k in ("dropped_slo", "dropped_fault", "retried"):
        assert (np.diff(np_(eng.last_fault_histories[k])) >= 0.0).all(), k


def _conservation_run(pkg, seed, kill_start, kill_len, on_kill, deadline):
    plat = make_platform(pkg, 6, names=NAMES6)
    tr = pkg.sim.poisson_trace(float(capacity(pkg, plat).sum()) * 0.6, 400,
                               6, dt=1e-3, seed=seed)
    sched = (pkg.sim.FaultSchedule()
             .kill_tile("a1", start=kill_start, end=kill_start + kill_len)
             .kill_tile("b0", start=kill_start + 50))
    slo = pkg.sim.SLOConfig(deadline_s=deadline, on_kill=on_kill,
                            max_retries=1 if on_kill == "respill" else 0)
    eng = pkg.sim.SimEngine(plat, faults=sched, slo=slo,
                            balancer=pkg.sim.LoadBalancer(
                                (NAMES6[:3], NAMES6[3:]), plat.names,
                                mode="even"), **kw(pkg))
    return eng, eng.run(tr), tr


@pytest.mark.parametrize("on_kill", ["respill", "drop", "wait"])
def test_conservation_under_faults_seeded(on_kill):
    """Work conserved, queues and ledgers sane — and every run equal to
    the reference's."""
    for seed, start, ln, dl in [(0, 50, 100, 0.02), (1, 120, 200, None),
                                (2, 10, 380, 0.05)]:
        pe, p, tr = _conservation_run(PORT, seed, start, ln, on_kill, dl)
        re_, r, _ = _conservation_run(REF, seed, start, ln, on_kill, dl)
        check_conservation(pe, p, tr)
        assert_seq_equal(pe, p, re_, r)


def _random_schedule(pkg, rng, plat, T):
    """A random mix of kills (some revived), island kills, link degrades
    and stuck actuators (with and without a rate) over ``T`` ticks."""
    sched = pkg.sim.FaultSchedule()
    links = routing_tables(PORT.pm.SoCPerfModel().noc).links
    isl = [n for n in plat.islands.names() if n != "noc_mem"]
    for _ in range(int(rng.integers(1, 6))):
        kind = rng.choice(["tile", "island", "link", "stuck"])
        s = int(rng.integers(-10, T))
        e = None if rng.uniform() < 0.3 else s + int(rng.integers(1, T))
        if kind == "tile":
            sched = sched.kill_tile(str(rng.choice(plat.names)), start=s,
                                    end=e)
        elif kind == "island":
            sched = sched.kill_island(str(rng.choice(isl)), start=s, end=e)
        elif kind == "link":
            a, b = links[int(rng.integers(len(links)))]
            sched = sched.degrade_link(a, b, float(rng.uniform(0.05, 1.0)),
                                       start=s, end=e)
        else:
            rate = (None if rng.uniform() < 0.4
                    else float(rng.choice([0.2, 0.4, 0.6, 1.0])))
            sched = sched.stick_island(
                str(rng.choice(plat.islands.names())), start=s, end=e,
                rate=rate)
    return sched


def _fuzz_run(pkg, seed, batched):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 7))
    names = tuple(f"t{i}" for i in range(n))
    groups = {"g0": names[:n // 2 + 1], "g1": names[n // 2 + 1:]}
    plat = make_platform(pkg, n, names=names,
                         island_groups=groups if seed % 2 else None)
    T = 300
    cap = capacity(pkg, plat)
    tr = pkg.sim.mmpp_trace(cap * 0.2, cap * float(rng.uniform(0.8, 1.6)),
                            T, n, dt=1e-3, seed=seed)
    sched = _random_schedule(pkg, rng, plat, T)
    on_kill = str(rng.choice(["respill", "drop", "wait"]))
    slo = pkg.sim.SLOConfig(
        deadline_s=[None, 0.01, 0.05][int(rng.integers(3))],
        on_kill=on_kill, max_retries=int(on_kill == "respill"
                                         and rng.uniform() < 0.8))
    bal = (pkg.sim.LoadBalancer([g for g in (names[:2], names[2:]) if g],
                                names, mode=str(rng.choice(
                                    ["even", "capacity", "adaptive"])))
           if seed % 3 else None)
    cfg = pkg.sim.SimConfig(control_interval=20, telemetry_interval=13)
    if batched:
        bplat = pkg.sim.BatchSimPlatform.stack([plat, plat])
        ctl = pkg.sim.BatchControllerHarness(
            bplat.islands, bplat.rates,
            pkg.dfs.BatchMemoryBoundPolicy(threshold=0.5, low_rate=0.4),
            tile_names=bplat.names, queue_guard_ticks=3.0)
        eng = pkg.sim.BatchSimEngine(bplat, config=cfg, controller=ctl,
                                     balancer=bal, faults=sched, slo=slo,
                                     **kw(pkg))
    else:
        ctl = pkg.sim.ControllerHarness(
            plat.islands, partial(pkg.dfs.policy_memory_bound,
                                  threshold=0.5, low_rate=0.4),
            queue_guard_ticks=3.0)
        eng = pkg.sim.SimEngine(plat, config=cfg, controller=ctl,
                                balancer=bal, faults=sched, slo=slo,
                                **kw(pkg))
    return eng, eng.run(tr), tr


@pytest.mark.parametrize("seed", range(12))
def test_random_schedules_match_reference(seed):
    """Seeded fuzz over random schedules (kills, revives, island kills, link
    degrades, stuck actuators with and without a rate), SLO settings and
    balancer modes, a DFS controller in the loop: the sequential engine
    (even seeds) or a two-design batched run (odd seeds) equals the
    reference's, and conserves work where no chain is in flight."""
    batched = bool(seed % 2)
    pe, p, tr = _fuzz_run(PORT, seed, batched)
    re_, r, _ = _fuzz_run(REF, seed, batched)
    if not batched:
        assert_seq_equal(pe, p, re_, r)
        if pe.last_fault_histories is not None:
            check_conservation(pe, p, tr)
        return
    for f in ("energy_j", "residual", "dropped", "p50_latency_s",
              "p99_latency_s", "dropped_slo", "dropped_fault", "retried",
              "swaps"):
        np.testing.assert_array_equal(getattr(p, f), getattr(r, f), f)
    np.testing.assert_array_equal(p.completed, r.completed)
    for f in STATE:
        np.testing.assert_array_equal(np_(getattr(pe.last_state, f)),
                                      getattr(re_.last_state, f), f)
    assert p.telemetry.events == r.telemetry.events
    if re_.last_fault_histories is not None:
        for k, v in re_.last_fault_histories.items():
            np.testing.assert_array_equal(np_(pe.last_fault_histories[k]),
                                          v, k)


def test_kill_revive_queue_drains_and_power_gates():
    """A killed tile serves nothing and burns nothing; after revive its
    waited backlog drains — as the reference, float for float."""
    def run(pkg, faults):
        plat = make_platform(pkg, 3)
        tr = pkg.sim.poisson_trace(float(capacity(pkg, plat).sum()) * 0.5,
                                   300, 3, dt=1e-3, seed=7)
        sched = (pkg.sim.FaultSchedule().kill_tile(plat.names[0], start=50,
                                                   end=150)
                 if faults else None)
        eng = pkg.sim.SimEngine(
            plat, faults=sched,
            slo=pkg.sim.SLOConfig(on_kill="wait") if faults else None,
            **kw(pkg))
        return eng, eng.run(tr), tr

    pe, p, tr = run(PORT, True)
    re_, r, _ = run(REF, True)
    assert_seq_equal(pe, p, re_, r)
    served = np_(pe.last_histories[1])
    assert served[50:150, 0].sum() == 0.0
    assert served[150:, 0].sum() > 0.0
    assert p.dropped_fault == 0.0
    _, free, _ = run(PORT, False)
    assert p.energy_j < free.energy_j
    np.testing.assert_allclose(
        float(tr.arrivals.sum()),
        p.completed + p.dropped_slo + float(pe.last_state.queue.sum()),
        rtol=1e-9, atol=1e-6)


def test_stuck_rate_overrides_hardware_not_software():
    """A stuck actuator pins the silicon rate; service recovers to the
    software view when the fault clears — as the reference."""
    def run(pkg, faults):
        plat = make_platform(pkg, 3)
        tr = pkg.sim.poisson_trace(float(capacity(pkg, plat).sum()) * 0.9,
                                   300, 3, dt=1e-3, seed=3)
        isl = plat.islands.names()[0]
        sched = (pkg.sim.FaultSchedule().stick_island(isl, start=0, end=200,
                                                      rate=0.05)
                 if faults else None)
        eng = pkg.sim.SimEngine(plat, faults=sched, **kw(pkg))
        return eng, eng.run(tr)

    pe, p = run(PORT, True)
    re_, r = run(REF, True)
    assert_seq_equal(pe, p, re_, r)
    fe, free = run(PORT, False)
    served, served_free = np_(pe.last_histories[1]), np_(fe.last_histories[1])
    assert served[:200].sum() < served_free[:200].sum()
    assert served[200:].sum() > served_free[200:].sum()
    assert p.p99_latency_s > free.p99_latency_s
    assert p.completed <= free.completed + 1e-9
    # the software view: telemetry's island rates stay the committed ones
    np.testing.assert_array_equal(p.telemetry.island_rates.array(),
                                  free.telemetry.island_rates.array())


# --------------------------------------------------------- online detect
def test_online_fault_detector_latch_and_revive_probe():
    dets = [pkg.OnlineFaultDetector(3, pkg.SimFaultConfig(dead_ticks=3))
            for pkg in (ref_rt, port_rt)]
    cap = np.array([1.0, 0.0, 1.0])
    served = np.array([1.0, 0.0, 1.0])
    queue = np.array([0.0, 5.0, 0.0])
    for step in range(4):
        c = cap if step < 3 else np.ones(3)
        outs = [d.observe(served, queue, c) for d in dets]
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(dets[0].believed_dead,
                                      dets[1].believed_dead)
        nd, na = outs[1]
        if step < 2:
            assert not nd.any()
        elif step == 2:
            assert nd[1] and dets[1].believed_dead[1]
            assert not dets[1].believed_dead[0]
        else:
            assert na[1] and not dets[1].believed_dead[1]


def test_sim_fault_supervisor_events_and_straggler_gating():
    """The host supervisor's event lists equal the reference's."""
    sups = [pkg.SimFaultSupervisor(pkg.SimFaultConfig(dead_ticks=2,
                                                      straggler_ticks=5))
            for pkg in (ref_rt, port_rt)]
    for s in sups:
        s.begin_run(("x", "y", "z"))
    served = np.array([1.0, 0.0, 1.0])
    queue = np.array([0.0, 1.0, 0.0])
    cap = np.array([1.0, 0.0, 1.0])
    busy_skew = np.array([0.9, 0.2, 0.2])
    evs = [[], []]
    for t in range(17):
        for i, s in enumerate(sups):
            if t < 3:
                evs[i] += s.observe(t, served=served, queue=queue, cap=cap)
            else:
                evs[i] += s.observe(t, served=np.ones(3), queue=np.zeros(3),
                                    cap=np.ones(3), busy=busy_skew)
    assert evs[0] == evs[1] and sups[0].events == sups[1].events
    kinds = [e["kind"] for e in sups[1].events]
    assert kinds[0] == "detected_dead" and sups[1].events[0]["tiles"] == ["y"]
    stragglers = [e for e in sups[1].events
                  if e["kind"] == "straggler_suspect"]
    assert len(stragglers) == 1 and stragglers[0]["tiles"] == ["x"]
    np.testing.assert_array_equal(sups[0].believed_alive,
                                  sups[1].believed_alive)


@pytest.mark.parametrize("seed", range(6))
def test_device_supervisor_equals_host_observe(seed):
    """The supervisor's state machine on tensors (as the tick loop runs
    it, with the events rebuilt after the run) against the reference's
    tick-by-tick ``observe`` on random observables: dead latches, revives,
    ties and even live counts in the straggler median, live counts under
    two — the same event list and final state."""
    rng = np.random.default_rng(seed)
    A, T = int(rng.integers(2, 7)), 300
    cfg = dict(dead_ticks=int(rng.integers(1, 4)),
               straggler_ticks=int(rng.integers(1, 8)),
               straggler_slack=float(rng.choice([1.0, 1.3, 2.0])))
    names = tuple(f"t{i}" for i in range(A))
    ref = ref_rt.SimFaultSupervisor(ref_rt.SimFaultConfig(**cfg))
    port = port_rt.SimFaultSupervisor(port_rt.SimFaultConfig(**cfg))
    ref.begin_run(names)
    port.begin_device_run(names, T, torch.device("cpu"))
    dead = np.zeros(A, dtype=bool)
    for t in range(T):
        if rng.uniform() < 0.05:
            dead = rng.uniform(size=A) < 0.4
        cap = np.where(dead, 0.0, rng.uniform(0.5, 2.0, A))
        queue = np.where(rng.uniform(size=A) < 0.7,
                         rng.uniform(0.0, 3.0, A), 0.0)
        served = np.minimum(queue, cap) * (rng.uniform(size=A) < 0.9)
        busy = np.round(rng.choice([0.1, 0.3, 0.9], A)
                        * rng.uniform(0.9, 1.1, A), 1)
        ref.observe(t, served=served, queue=queue, cap=cap, busy=busy)
        port.observe_device(t, served=torch.as_tensor(served),
                            queue=torch.as_tensor(queue),
                            cap=torch.as_tensor(cap),
                            busy=torch.as_tensor(busy))
        np.testing.assert_array_equal(
            port.believed_alive_device.numpy(), ref.believed_alive)
    events = port.end_device_run()
    assert events == ref.events == port.events
    assert any(e["kind"] == "detected_dead" for e in events)
    np.testing.assert_array_equal(port.believed_alive, ref.believed_alive)
    np.testing.assert_array_equal(port._skew_streak, ref._skew_streak)
    assert port._last_skew == ref._last_skew


def _detect_run(pkg, ticks=1200, dfs=False):
    plat = pipeline_platform(pkg)
    cap = capacity(pkg, plat)
    mean = np.zeros(6)
    mean[:3] = 0.45 * float(cap[:3].sum()) / 3.0
    tr = pkg.sim.diurnal_trace(mean, ticks, 6, dt=1e-3, depth=1.0 / 3.0,
                               seed=11, phase=-np.pi / 2.0)
    sched = pkg.sim.FaultSchedule().kill_tile("be1", start=400, end=900)
    sup = RT[pkg.name].SimFaultSupervisor(
        RT[pkg.name].SimFaultConfig(dead_ticks=3))
    ctl = (pkg.sim.ControllerHarness(
        plat.islands, partial(pkg.dfs.policy_memory_bound, threshold=0.55,
                              low_rate=0.5), queue_guard_ticks=3.0)
        if dfs else None)
    eng = pkg.sim.SimEngine(
        plat, config=pkg.sim.SimConfig(telemetry_interval=50,
                                       control_interval=25),
        controller=ctl, faults=sched, slo=pkg.sim.SLOConfig(deadline_s=0.05),
        balancer=pkg.sim.LoadBalancer((STAGE0, STAGE1), plat.names,
                                      mode="even"),
        supervisor=sup, **kw(pkg))
    return eng, eng.run(tr), sup


@pytest.mark.parametrize("dfs", [False, True])
def test_supervisor_in_the_loop_detection_latency(dfs):
    """The engine routes on BELIEVED availability: detection fires a few
    ticks after the kill, telemetry carries the events in the reference's
    order within a tick, and recovery keeps the run essentially drop-free
    — every number and event equal to the reference's."""
    pe, p, psup = _detect_run(PORT, dfs=dfs)
    re_, r, rsup = _detect_run(REF, dfs=dfs)
    assert_seq_equal(pe, p, re_, r)
    assert psup.events == rsup.events
    np.testing.assert_array_equal(psup.believed_alive, rsup.believed_alive)
    dead_evs = [e for e in psup.events if e["kind"] == "detected_dead"]
    alive_evs = [e for e in psup.events if e["kind"] == "detected_alive"]
    assert dead_evs and dead_evs[0]["tiles"] == ["be1"]
    assert 400 + 2 <= dead_evs[0]["tick"] <= 400 + 30
    assert alive_evs and alive_evs[0]["tick"] >= 900
    kinds = [e["kind"] for e in p.telemetry.events]
    assert "detected_dead" in kinds and "fault_kill" in kinds
    assert ("dfs_commit" in kinds) == dfs
    assert p.drop_rate < 0.01


def test_supervisor_needs_tile_faults():
    plat = pipeline_platform(PORT)
    tr = PORT.sim.constant_trace(np.ones(6), 10, 6, dt=1e-3)
    for faults in (None, PORT.sim.FaultSchedule().degrade_link(
            (1, 1), (1, 2), 0.5, start=0)):
        eng = PORT.sim.SimEngine(plat, faults=faults, device="cpu",
                                 supervisor=port_rt.SimFaultSupervisor())
        with pytest.raises(AssertionError, match="tile faults"):
            eng.run(tr)


# ---------------------------------------------------------- scenario gate
def test_scenario_gate_replica_kill_mid_surge():
    """The reference's scenario gate through the port's example
    (``examples/torch_closed_loop.py --faults``): the five runs equal the
    reference's, the gate holds, the detector's latency is the
    reference's, and work is conserved in the runs without DFS."""
    ex = _example()
    plat = ex.pipeline_platform()
    tr = ex.surge_trace(plat, device="cpu")
    runs = {name: ex.fault_run(plat, tr, recover=rec, dfs=dfs, detect=det,
                               device="cpu")
            for name, (rec, dfs, det) in ex.FAULT_RUNS.items()}
    ex.fault_gate(runs, tr)
    ref = _reference_surge_runs()
    for name, (eng, r, sup) in runs.items():
        re_, rr, rsup = ref[name]
        assert_seq_equal(eng, r, re_, rr)
        if sup is not None:
            assert sup.events == rsup.events
    assert ex.detection_tick(runs["dfs,rec+detect"][2]) == \
        [e for e in ref["dfs,rec+detect"][2].events
         if e["kind"] == "detected_dead"][0]["tick"]
    assert runs["fixed,recovery"][1].retried >= 0.0
    assert runs["fixed,recovery"][1].completed > \
        runs["fixed,no-rec"][1].completed
    for name in ("fixed,no-rec", "fixed,recovery"):
        eng, r, _ = runs[name]
        # the chain forwards stage-0 completions with one tick of latency
        check_conservation(eng, r, tr,
                           in_flight=float(eng.last_histories[1][-1, :3]
                                           .sum()))


def _example():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "torch_closed_loop.py")
    spec = importlib.util.spec_from_file_location("torch_closed_loop", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_surge_runs(ticks=4000):
    """``examples/closed_loop.py:run_faults``'s five runs in the reference
    package: name -> (engine, result, supervisor)."""
    plat = pipeline_platform(REF)
    cap = capacity(REF, plat)
    mean = np.zeros(6)
    mean[:3] = 0.45 * float(cap[:3].sum()) / 3.0
    tr = REF.sim.diurnal_trace(mean, ticks, 6, dt=1e-3, depth=1.0 / 3.0,
                               seed=11, phase=-np.pi / 2.0)
    ks, ke = int(0.45 * ticks), int(0.65 * ticks)
    sched = REF.sim.FaultSchedule().kill_tile("be1", start=ks, end=ke)
    out = {}
    for name, (recover, dfs, detect) in _example().FAULT_RUNS.items():
        slo = (REF.sim.SLOConfig(deadline_s=0.05, on_kill="respill",
                                 max_retries=1) if recover else
               REF.sim.SLOConfig(deadline_s=0.05, on_kill="drop",
                                 max_retries=0))
        ctl = (REF.sim.ControllerHarness(
            plat.islands, partial(REF.dfs.policy_memory_bound,
                                  threshold=0.55, low_rate=0.5),
            queue_guard_ticks=3.0) if dfs else None)
        sup = (ref_rt.SimFaultSupervisor(ref_rt.SimFaultConfig(dead_ticks=3))
               if detect else None)
        eng = REF.sim.SimEngine(
            plat, config=REF.sim.SimConfig(control_interval=25),
            controller=ctl, faults=sched, slo=slo, supervisor=sup,
            balancer=REF.sim.LoadBalancer((STAGE0, STAGE1), plat.names,
                                          mode="even"))
        out[name] = (eng, eng.run(tr), sup)
    return out


# ------------------------------------------------------ DSE under failure
def _rerank(pkg, **extra):
    m = pkg.pm.SoCPerfModel()
    wls = [pkg.pm.AccelWorkload("dfadd", *CHSTONE["dfadd"]),
           pkg.pm.AccelWorkload("dfmul", *CHSTONE["dfmul"])]
    res = pkg.dse.grid_sweep(m, wls, ks=(1, 2, 4, 8),
                             acc_rates=(0.2, 0.6, 1.0),
                             noc_rates=(0.5, 1.0), n_tg=2, **kw(pkg))
    thr = res.throughput.ravel()
    seen, idx = set(), []
    for j in sorted(res.pareto_indices(), key=lambda j: -thr[j]):
        dp = res.design_point(int(j))
        key = (dp.replication["dfmul"], dp.rates["acc"],
               dp.rates["noc_mem"])
        if key not in seen:
            seen.add(key)
            idx.append(int(j))
        if len(idx) == 4:
            break
    tr = pkg.sim.diurnal_trace(np.array([3000.0, 9000.0]), 1500, 2,
                               dt=1e-3, depth=0.5, seed=9)
    base = dict(model=m, indices=idx, req_mb=0.002, p99_sla_s=0.02,
                **kw(pkg))
    s_free = pkg.dse.closed_loop_score(res, tr, **base)
    fs = pkg.sim.FaultSchedule().stick_island("dfmul", start=300, end=1200,
                                              rate=0.2)
    k = dict(**base, fault_schedule=fs,
             slo=pkg.sim.SLOConfig(deadline_s=0.02), max_drop_rate=0.02)
    return (s_free, pkg.dse.closed_loop_score(res, tr, **k, **extra),
            pkg.dse.closed_loop_score(res, tr, **k, batch=False))


def test_closed_loop_score_reranks_under_faults():
    """A stuck-at-low-rate actuator re-orders the survivors: the port's
    batched and sequential scores equal each other and the reference's
    (drop rates, p99, order), and the ranking differs from the
    fault-free one."""
    p_free, p_b, p_s = _rerank(PORT)
    r_free, r_b, r_s = _rerank(REF)
    assert p_free.drop_rate is None
    np.testing.assert_array_equal(p_free.order, r_free.order)
    for a, r in ((p_b, r_b), (p_s, r_s)):
        np.testing.assert_array_equal(a.drop_rate, r_b.drop_rate)
        np.testing.assert_array_equal(a.p99_latency_s, r_b.p99_latency_s)
        np.testing.assert_array_equal(a.order, r_b.order)
        # each path's energy per request as its reference counterpart's
        # (the reference's two paths add ``completed`` in two orders)
        np.testing.assert_array_equal(a.energy_per_request_j,
                                      r.energy_per_request_j)
    assert (p_b.drop_rate > 0.0).all()
    assert len(set(np.round(p_b.drop_rate, 6))) > 1
    assert not np.array_equal(p_free.order, p_b.order)
    assert len(p_s.results) == 4 and len(p_b.results) == 1


def test_closed_loop_score_float32_under_faults():
    """The float32 ``"torch"`` loop scores the same survivors within the
    reference's float32 limits, in the same order."""
    _, p32, _ = _rerank(PORT, dtype=torch.float32)
    _, r, _ = _rerank(REF)
    np.testing.assert_allclose(p32.drop_rate, r.drop_rate, rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(p32.p99_latency_s, r.p99_latency_s,
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(p32.order, r.order)


@pytest.mark.parametrize("drop_rate,max_drop,sla", [
    (None, None, None), (None, None, 0.02), ([0.1, 0.0, 0.3, 0.0], None,
                                             None),
    ([0.1, 0.0, 0.3, 0.0], 0.05, None), ([0.1, 0.0, 0.3, 0.0], 0.05, 0.02),
    ([0.01, 0.01, 0.3, 0.0], 0.02, 0.02)])
def test_rank_scores_equal_reference(drop_rate, max_drop, sla):
    """``_rank_scores`` with and without the drop-rate keys orders as the
    reference (NaN survivors last)."""
    p99 = np.array([0.01, 0.03, np.nan, 0.01])
    ept = np.array([2.0, 1.0, 1.5, 3.0])
    dr = None if drop_rate is None else np.asarray(drop_rate)
    np.testing.assert_array_equal(
        PORT.dse._rank_scores(p99, ept, sla, drop_rate=dr,
                              max_drop_rate=max_drop),
        REF.dse._rank_scores(p99, ept, sla, drop_rate=dr,
                             max_drop_rate=max_drop))


# ------------------------------------------------ percentiles under drops
def _drop_histories(seed, T=60, B=12, A=3):
    """FIFO fluid queues with explicit drops: whole and tenth batches,
    capacities in tenths (sums that round otherwise in other orders), a
    share of each backlog leaving unserved each tick (``queue_drops``), an
    idle design and a design that drops everything."""
    rng = np.random.default_rng(seed)
    adm = rng.integers(0, 5, size=(T, B, A)) * np.where(
        rng.uniform(size=(1, B, 1)) < 0.5, 1.0, 0.1)
    adm[:, 0] = 0.0
    cap = rng.integers(1, 6, size=(B, A)) * 0.1
    cap[1] = 0.0
    share = rng.choice([0.0, 0.1, 0.5], size=(T, B, A))
    srv, qd = np.zeros_like(adm), np.zeros_like(adm)
    q = np.zeros((B, A))
    for t in range(T):
        q = q + adm[t]
        srv[t] = np.minimum(q, cap)
        q = q - srv[t]
        qd[t] = q * share[t]
        q = q - qd[t]
    return adm, srv, qd


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("scan", ["in_turn", "blocked"])
def test_batched_percentiles_with_queue_drops_bit_equal(monkeypatch, seed,
                                                         scan):
    """``latency_percentiles_batch(queue_drops=)`` against the reference's
    per-design ``latency_percentiles(queue_drops=)``, bit for bit — with
    running sums in turn (the CPU's) and in blocks (as a parallel scan on
    the card rounds), where designs whose result could move go to the
    per-design function with their drop curve."""
    import repro.sim.engine as ref_eng
    import repro_torch.sim.engine as eng_mod
    if scan == "blocked":
        def blocked(x, block=7):
            L = x.shape[-1]
            xp = torch.nn.functional.pad(x, (0, (-L) % block)).reshape(
                *x.shape[:-1], -1, block)
            inner = torch.cumsum(xp, dim=-1)
            carry = torch.cumsum(inner[..., -1], dim=-1)
            carry = torch.cat([torch.zeros_like(carry[..., :1]),
                               carry[..., :-1]], dim=-1)
            return (inner + carry.unsqueeze(-1)).reshape(
                *x.shape[:-1], -1)[..., :L].contiguous()
        monkeypatch.setattr(eng_mod, "_prefix_sums", blocked)
    adm, srv, qd = _drop_histories(seed)
    want = np.asarray([ref_eng.latency_percentiles(
        adm[:, b], srv[:, b], 1e-3, queue_drops=qd[:, b])
        for b in range(adm.shape[1])])
    p50, p99 = eng_mod.latency_percentiles_batch(
        torch.as_tensor(adm), torch.as_tensor(srv), 1e-3,
        queue_drops=torch.as_tensor(qd), max_elems=60 * 3 * 5)
    got = np.stack([p50.numpy(), p99.numpy()], axis=-1)
    assert np.array_equal(got, want, equal_nan=True)
    # the blocked sums leave some designs unsure: they went to the host
    if scan == "blocked":
        assert eng_mod.latency_percentiles_batch.last_redone > 0
    per = np.asarray([eng_mod.latency_percentiles(
        adm[:, b], srv[:, b], 1e-3, qd[:, b]) for b in range(adm.shape[1])])
    assert np.array_equal(per, want, equal_nan=True)
    # the drops matter: without them the results differ
    p50n, p99n = eng_mod.latency_percentiles_batch(
        torch.as_tensor(adm), torch.as_tensor(srv), 1e-3)
    assert not np.array_equal(np.stack([p50n.numpy(), p99n.numpy()], -1),
                              want, equal_nan=True)


# ------------------------------------------------ satellite: telemetry IO
def test_fault_counters_round_trip_through_telemetry_json(tmp_path):
    docs = []
    for pkg in (PORT, REF):
        plat, sched, slo, tr, groups = faulted_setup(pkg, ticks=300)
        eng = pkg.sim.SimEngine(plat,
                                config=pkg.sim.SimConfig(
                                    telemetry_interval=25),
                                faults=sched, slo=slo,
                                balancer=pkg.sim.LoadBalancer(
                                    groups, plat.names, mode="even"),
                                **kw(pkg))
        r = eng.run(tr)
        path = tmp_path / f"{pkg.name}.json"
        r.telemetry.to_json(str(path))
        docs.append((json.loads(path.read_text()), r))
    (doc, r), (ref_doc, _) = docs
    assert doc == ref_doc
    for ch in ("dropped_slo", "dropped_fault", "retried", "dropped"):
        vals = doc["scalars"][ch]
        assert vals and all(b >= a - 1e-9 for a, b in zip(vals, vals[1:]))
    assert doc["scalars"]["dropped_slo"][-1] == pytest.approx(
        r.dropped_slo, rel=1e-9)
    assert doc["scalars"]["dropped_fault"][-1] == pytest.approx(
        r.dropped_fault, rel=1e-9)
    assert doc["scalars"]["retried"][-1] == pytest.approx(r.retried,
                                                          rel=1e-9)
    assert "fault_kill" in {e["kind"] for e in doc["events"]}


# ------------------------------------------------------------- slow soak
@pytest.mark.slow
def test_fleet_kill_soak_long_run():
    """Half the back-end stage dies and revives twice over a long soak;
    conservation and bounded drops hold, and the run equals the
    reference's."""
    def run(pkg):
        plat = pipeline_platform(pkg)
        cap = capacity(pkg, plat)
        mean = np.zeros(6)
        mean[:3] = 0.4 * float(cap[:3].sum()) / 3.0
        tr = pkg.sim.diurnal_trace(mean, 20_000, 6, dt=1e-3, depth=0.4,
                                   seed=5)
        sched = (pkg.sim.FaultSchedule()
                 .kill_tile("be0", start=3000, end=6000)
                 .kill_tile("be1", start=5000, end=9000)
                 .kill_tile("be0", start=12_000, end=15_000)
                 .kill_tile("be2", start=13_000, end=14_000))
        eng = pkg.sim.SimEngine(
            plat, config=pkg.sim.SimConfig(control_interval=25),
            faults=sched, slo=pkg.sim.SLOConfig(deadline_s=0.05),
            balancer=pkg.sim.LoadBalancer((STAGE0, STAGE1), plat.names,
                                          mode="even"), **kw(pkg))
        return eng, eng.run(tr), tr

    pe, p, tr = run(PORT)
    re_, r, _ = run(REF)
    assert p.drop_rate < 0.04
    check_conservation(pe, p, tr, in_flight=float(
        pe.last_histories[1][-1, :3].sum()))
    assert_seq_equal(pe, p, re_, r)


# -------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the fault paths on the card are held "
                    "against the CPU there (chip_smoke.py runs these cases "
                    "on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("on_kill", ["respill", "drop", "wait"])
def test_cuda_fault_run_matches_cpu(on_kill, cuda_device):
    """A fault run (kills, a link degrade, a stuck rate, a deadline, the
    balancer) on the card against the same run on the CPU: sequential
    ledgers within 1e-15, p99 and events exact, B = 1 on the card bit for
    bit the sequential run, two designs in float64 against the CPU and in
    float32 within the reference's float32 limits, and no host sync in the
    open-loop tick loop.  The case runs in ``chip_smoke.py``
    (``card_fault_run``)."""
    chip_smoke().card_case("test_cuda_fault_run_matches_cpu", on_kill)


@pytest.mark.gpu
@pytest.mark.parametrize("dfs", [False, True])
def test_cuda_supervisor_run_matches_cpu(dfs, cuda_device):
    """The online detector in the loop on the card against the CPU: the
    same events, detection tick and ledgers (1e-15); no sync in the tick
    loop without a controller, one per control tick with one.  The case
    runs in ``chip_smoke.py`` (``card_supervisor_run``)."""
    chip_smoke().card_case("test_cuda_supervisor_run_matches_cpu", dfs)
