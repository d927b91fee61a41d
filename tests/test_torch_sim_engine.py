"""Port vs reference: the sequential closed-loop engine, its scalar DFS
control and the dual-buffer actuator.

The same seeded NumPy traces go through ``repro.sim.SimEngine`` and the
port's ``repro_torch.sim.SimEngine`` (``device="cpu"``).  Tolerances:

* p50 / p99, swaps, the commit history, versions and every other integer:
  **exact**;
* ``energy_j``, ``residual``, ``dropped``, queues, monitor counters and the
  telemetry rings: **bit-equal** on these inputs (the port runs the
  reference's expressions in its order; per-tile sums add as NumPy does);
* ``completed`` (and what derives from it): <= 1e-12 relative, the limit
  for the card; on CPU tensors the port adds the served history in NumPy's
  pairwise order over ticks x tiles, as the reference does.

The B = 1 contract of the reference (``tests/test_sim_batch.py``) holds
inside the port **bit for bit**: ``BatchSimEngine("torch")`` with one design
equals ``SimEngine`` on every output, open loop and controlled, and so does
the telemetry export.  The cases follow ``tests/test_sim.py``,
``tests/test_monitor_actuator.py``, ``tests/test_sim_batch.py`` and
``tests/test_telemetry.py``.
"""
import dataclasses
import json
import threading
from functools import partial

import numpy as np
import pytest
import torch

import repro.core.islands as ref_islands
import repro_torch.core.islands as port_islands
from repro.configs import get_config as ref_get_config
from repro.core import default_islands as ref_default_islands
from repro.core import default_plan as ref_default_plan
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import default_islands, default_plan

from _torch_port_helpers import PORT, REF, chip_smoke, rel_err

DT = 1e-3
RESULT_EXACT = ("energy_j", "residual", "dropped", "p50_latency_s",
                "p99_latency_s", "mean_power_w", "offered", "swaps",
                "ticks", "dt")
RESULT_1E12 = ("completed", "throughput_rps", "energy_per_request_j")
STATE = ("queue", "busy", "pkts_in", "pkts_out", "rtt_acc", "dropped",
         "energy")


# --------------------------------------------------------------- fixtures
def platform(pkg, n_tiles=6, *, k=8, req_mb=0.005, noc_rate=1.0, n_tg=2,
             island_groups=None, flows=None, names=None):
    """The dfmul platform of the reference's simulation tests."""
    m = pkg.pm.SoCPerfModel()
    pos = [(r, c) for r in range(4) for c in range(4)
           if (r, c) not in {(1, 0), (0, 0), (0, 3)}][:n_tiles]
    wls = [pkg.pm.AccelWorkload("dfmul", 8.70, 1.1, replication=k)
           for _ in pos]
    return pkg.sim.SimPlatform.build(m, wls, pos, noc_rate=noc_rate,
                                     n_tg=n_tg, req_mb=req_mb, names=names,
                                     island_groups=island_groups, flows=flows)


def engine(pkg, plat, **kw):
    if pkg is PORT:
        kw.setdefault("device", "cpu")
    return pkg.sim.SimEngine(plat, **kw)


def trace(pkg, kind, cap, ticks=900, seed=3):
    n = cap.shape[0]
    s = pkg.sim
    if kind == "constant":
        return s.constant_trace(cap * 0.6, ticks, n, dt=DT)
    if kind == "poisson":
        return s.poisson_trace(float(cap.sum()) * 0.5, ticks, n, dt=DT,
                               seed=seed)
    if kind == "diurnal":
        return s.diurnal_trace(cap * 0.4, ticks, n, dt=DT, depth=0.5,
                               seed=seed)
    if kind == "mmpp":
        return s.mmpp_trace(cap * 0.1, cap * 1.3, ticks, n, dt=DT,
                            seed=seed)
    raise ValueError(kind)


def scalar_policy(pkg, key):
    if key == "membound":
        return partial(pkg.dfs.policy_memory_bound, threshold=0.55,
                       low_rate=0.5)
    if key == "pid":
        return pkg.dfs.PIDRatePolicy(target=0.7)
    raise ValueError(key)


def batch_policy(pkg, key):
    if key == "membound":
        return pkg.dfs.BatchMemoryBoundPolicy(threshold=0.55, low_rate=0.5)
    return pkg.dfs.BatchPIDRatePolicy(target=0.7)


def harness(pkg, plat, policy, **kw):
    kw.setdefault("queue_guard_ticks", 3.0)
    return pkg.sim.ControllerHarness(plat.islands, policy, **kw)


def assert_results_match(port, ref):
    """Port result vs reference result at the module's tolerances."""
    for f in RESULT_EXACT:
        assert getattr(port, f) == getattr(ref, f), f
    for f in RESULT_1E12:
        assert rel_err(getattr(port, f), getattr(ref, f)) <= 1e-12, f
    assert port.telemetry.events == ref.telemetry.events
    for ring in ("scalars", "island_rates", "queue_depth", "busy"):
        a, b = getattr(port.telemetry, ring), getattr(ref.telemetry, ring)
        np.testing.assert_array_equal(a.array(), b.array(), err_msg=ring)
        assert a.total_appended == b.total_appended


def assert_state_matches(port_eng, ref_eng):
    for f in STATE:
        np.testing.assert_array_equal(
            getattr(port_eng.last_state, f).numpy(),
            getattr(ref_eng.last_state, f), err_msg=f)
    for a, b in zip(port_eng.last_histories, ref_eng.last_histories):
        np.testing.assert_array_equal(a.numpy(), b)


def assert_live_equal(port_ctl, ref_ctl):
    a, b = port_ctl.live(), ref_ctl.live()
    assert a.version == b.version
    assert [(i.name, i.rate) for i in a.islands] == \
        [(i.name, i.rate) for i in b.islands]
    assert port_ctl.actuator.history() == ref_ctl.actuator.history()
    assert port_ctl.actuator.swaps == ref_ctl.actuator.swaps


def actions(ctl):
    """A harness's recorded decisions as plain tuples."""
    return [dataclasses.astuple(a) for a in ctl.actions]


def both(fn):
    """``fn(pkg)`` for the reference and the port."""
    return fn(REF), fn(PORT)


# --------------------------------------------- engine: parity conservation
def test_capacity_matches_reference_and_scalar_perfmodel_exactly():
    rp, pp = both(lambda pkg: platform(pkg, 5))
    cap_r = engine(REF, rp).capacity_rps()
    cap = engine(PORT, pp).capacity_rps()
    np.testing.assert_array_equal(cap, cap_r)
    m = pp.model
    for i in range(pp.n_tiles):
        wl = PORT.pm.AccelWorkload("dfmul", 8.70, 1.1, replication=8)
        r, c = divmod(int(pp.pos_idx[i]), m.noc.cols)
        s = m.accel_throughput(wl, (r, c),
                               {"acc": 1.0, "noc_mem": 1.0, "tg": 1.0}, 2)
        assert cap[i] == pytest.approx(s / pp.req_mb[i], rel=1e-12)


def test_saturated_throughput_matches_static_prediction():
    def run(pkg):
        plat = platform(pkg, 6)
        eng = engine(pkg, plat, config=pkg.sim.SimConfig(
            dynamic_contention=False))
        cap = eng.capacity_rps()
        return cap, eng.run(pkg.sim.constant_trace(cap * 1.7, 2000, 6,
                                                   dt=DT))
    (_, r0), (cap, r) = both(run)
    assert r.throughput_rps == pytest.approx(cap.sum(), rel=1e-9)
    assert r.swaps == 0
    assert (r.completed + r.residual + r.dropped
            == pytest.approx(r.offered, rel=1e-9))
    assert_results_match(r, r0)


def test_saturated_throughput_matches_grid_sweep_design_point():
    def run(pkg):
        m = pkg.pm.SoCPerfModel()
        wls = [pkg.pm.AccelWorkload("dfsin", 0.33, 60.0),
               pkg.pm.AccelWorkload("gsm", 4.61, 12.0)]
        kw = {"device": "cpu"} if pkg is PORT else {}
        res = pkg.dse.grid_sweep(m, wls, ks=(1, 2, 4), acc_rates=(0.6, 1.0),
                                 noc_rates=(0.5, 1.0), n_tg=4, **kw)
        dp = res.design_point(int(res.topk_indices(1)[0]))
        plat = pkg.sim.SimPlatform.from_design_point(m, dp, wls, req_mb=0.01,
                                                     n_tg=res.n_tg)
        eng = engine(pkg, plat, config=pkg.sim.SimConfig(
            dynamic_contention=False))
        cap = eng.capacity_rps()
        return dp, cap, eng.run(pkg.sim.constant_trace(cap * 2.0, 1500, 2,
                                                       dt=DT))
    (_, _, r0), (dp, cap, r) = both(run)
    assert cap.sum() * 0.01 == pytest.approx(dp.throughput, rel=1e-9)
    assert r.throughput_rps * 0.01 == pytest.approx(dp.throughput, rel=0.05)
    assert_results_match(r, r0)


def test_light_load_serves_everything_with_low_latency():
    def run(pkg):
        plat = platform(pkg, 6)
        eng = engine(pkg, plat)
        cap = eng.capacity_rps()
        return eng, eng.run(pkg.sim.constant_trace(cap * 0.2, 1000, 6,
                                                   dt=DT))
    (e0, r0), (e1, r) = both(run)
    assert r.completed == pytest.approx(r.offered, rel=1e-9)
    assert r.residual == pytest.approx(0.0, abs=1e-6)
    assert r.p99_latency_s <= 2e-3
    assert r.energy_j > 0 and r.mean_power_w > 0
    assert_results_match(r, r0)
    assert_state_matches(e1, e0)


def test_max_queue_drops_overflow():
    def run(pkg):
        plat = platform(pkg, 3)
        eng = engine(pkg, plat, config=pkg.sim.SimConfig(
            max_queue=5.0, dynamic_contention=False))
        cap = eng.capacity_rps()
        return eng.run(pkg.sim.constant_trace(cap * 3.0, 800, 3, dt=DT))
    r0, r = both(run)
    assert r.dropped > 0
    assert r.residual <= 5.0 * 3 + 1e-9
    assert (r.completed + r.residual + r.dropped
            == pytest.approx(r.offered, rel=1e-9))
    assert_results_match(r, r0)


def test_telemetry_records_and_exports_json(tmp_path):
    def run(pkg):
        plat = platform(pkg, 4)
        eng = engine(pkg, plat, config=pkg.sim.SimConfig(
            telemetry_interval=10, telemetry_capacity=16))
        cap = eng.capacity_rps()
        return plat, eng.run(pkg.sim.constant_trace(cap * 0.5, 400, 4,
                                                    dt=DT))
    (_, r0), (plat, r) = both(run)
    telem = r.telemetry
    assert len(telem.scalars) == 16
    assert telem.scalars.total_appended == 40
    thr = telem.series("throughput_rps")
    assert thr.shape == (16,) and np.all(thr > 0)
    path = tmp_path / "telemetry.json"
    telem.to_json(str(path))
    doc = json.loads(path.read_text())
    assert doc["schema"]["tiles"] == list(plat.names)
    assert len(doc["scalars"]["throughput_rps"]) == 16
    assert doc == json.loads(r0.telemetry.to_json())


# ------------------------------------------------------------ controllers
def test_pid_policy_derates_idle_and_restores_overload():
    def run(pkg):
        plat = platform(pkg, 6)
        ctl = harness(pkg, plat, pkg.dfs.PIDRatePolicy(target=0.7))
        eng = engine(pkg, plat, config=pkg.sim.SimConfig(control_interval=25),
                     controller=ctl)
        cap = eng.capacity_rps()
        r = eng.run(pkg.sim.constant_trace(cap * 0.05, 1500, 6, dt=DT))
        live = [i.rate for i in ctl.live().islands if i.name != "noc_mem"]
        r2 = eng.run(pkg.sim.constant_trace(cap * 1.2, 1500, 6, dt=DT))
        live2 = [i.rate for i in ctl.live().islands if i.name != "noc_mem"]
        return ctl, r, r2, live, live2
    (c0, a0, b0, _, _), (c1, a1, b1, live, live2) = both(run)
    assert a1.swaps >= 1
    assert np.mean(live) < 0.6
    assert np.mean(live2) > np.mean(live)
    assert_results_match(a1, a0)
    assert_results_match(b1, b0)
    assert_live_equal(c1, c0)
    assert c1.policy._integral == c0.policy._integral
    assert c1.policy._prev_err == c0.policy._prev_err


def test_queue_guard_overrides_energy_policy():
    def run(pkg):
        plat = platform(pkg, 4)

        def floor(islands, telemetry):
            return {i.name: 0.2 for i in islands.islands if not i.fixed}

        ctl = harness(pkg, plat, floor, queue_guard_ticks=2.0)
        eng = engine(pkg, plat, config=pkg.sim.SimConfig(control_interval=20),
                     controller=ctl)
        cap = eng.capacity_rps()
        return ctl, eng.run(pkg.sim.constant_trace(cap * 1.5, 1200, 4,
                                                   dt=DT))
    (c0, r0), (ctl, r) = both(run)
    assert any(a.guarded for a in ctl.actions)
    guarded_now = [i.rate for i in ctl.live().islands if i.name != "noc_mem"]
    assert max(guarded_now) == 1.0
    assert actions(ctl) == actions(c0)
    assert_results_match(r, r0)
    assert_live_equal(ctl, c0)


def test_controller_noop_does_not_bump_version():
    def run(pkg):
        plat = platform(pkg, 3)
        ctl = harness(pkg, plat, lambda isl, t: {}, queue_guard_ticks=None)
        eng = engine(pkg, plat, config=pkg.sim.SimConfig(control_interval=10),
                     controller=ctl)
        cap = eng.capacity_rps()
        return plat, ctl, eng.run(pkg.sim.constant_trace(cap * 0.3, 300, 3,
                                                         dt=DT))
    (_, _, r0), (plat, ctl, r) = both(run)
    assert r.swaps == 0
    assert ctl.live().version == plat.islands.version
    assert len(ctl.actions) == 30
    assert_results_match(r, r0)


def test_closed_loop_memory_bound_saves_energy_at_bounded_p99():
    """The headline claim at a tier-1 size: Fig.-4 DFS under diurnal
    traffic cuts energy/request >= 10 % against fixed max frequency, p99
    within the same envelope — through the port, equal to the reference."""
    def run(pkg):
        plat = platform(pkg, 12)
        cap = engine(pkg, plat).capacity_rps()
        tr = pkg.sim.diurnal_trace(cap * 0.3, 2000, 12, dt=DT, depth=0.5,
                                   seed=1)
        base = engine(pkg, plat).run(tr)
        ctl = harness(pkg, plat, scalar_policy(pkg, "membound"))
        dfs = engine(pkg, plat, config=pkg.sim.SimConfig(control_interval=25),
                     controller=ctl).run(tr)
        return base, dfs, ctl
    (b0, d0, c0), (base, dfs, ctl) = both(run)
    saving = 1.0 - dfs.energy_per_request_j / base.energy_per_request_j
    assert saving >= 0.10
    assert dfs.p99_latency_s <= max(2.0 * base.p99_latency_s, 5e-3)
    assert dfs.completed == pytest.approx(base.completed, rel=0.01)
    assert dfs.swaps >= 1
    assert_results_match(base, b0)
    assert_results_match(dfs, d0)
    assert_live_equal(ctl, c0)


def test_tech_model_run_matches_reference():
    """Under the 45 nm tech model (V^2 f energy, commits clamped into the
    node's legal range; the engine hands its model to the harness)."""
    def run(pkg):
        plat = platform(pkg, 4)
        ctl = harness(pkg, plat, scalar_policy(pkg, "pid"))
        eng = engine(pkg, plat, config=pkg.sim.SimConfig(control_interval=20),
                     controller=ctl, tech=45)
        cap = eng.capacity_rps()
        return ctl, eng.run(trace(pkg, "mmpp", cap, ticks=600))
    (c0, r0), (ctl, r) = both(run)
    assert ctl.tech is not None and repr(ctl.tech) == repr(c0.tech)
    assert any(a.clamped for a in ctl.actions)
    assert actions(ctl) == actions(c0)
    assert_results_match(r, r0)
    assert_live_equal(ctl, c0)


# -------------------------------------------------------------- DSE bridge
def test_closed_loop_score_reranks_survivors():
    def run(pkg):
        m = pkg.pm.SoCPerfModel()
        wls = [pkg.pm.AccelWorkload("dfadd", 9.22, 0.9),
               pkg.pm.AccelWorkload("dfmul", 8.70, 1.1)]
        kw = {"device": "cpu"} if pkg is PORT else {}
        res = pkg.dse.grid_sweep(m, wls, ks=(1, 2, 4),
                                 acc_rates=(0.2, 0.6, 1.0),
                                 noc_rates=(0.5, 1.0), n_tg=2, **kw)
        tr = pkg.sim.diurnal_trace(2000.0, 800, 2, dt=DT, depth=0.4, seed=5)
        score = pkg.dse.closed_loop_score(
            res, tr, model=m, top=4, p99_sla_s=0.05, req_mb=0.002,
            controller_factory=lambda p: harness(pkg, p,
                                                 pkg.dfs.PIDRatePolicy()),
            **kw)
        return res, score
    (_, s0), (res, score) = both(run)
    assert score.indices.shape[0] == 4
    assert sorted(score.order.tolist()) == [0, 1, 2, 3]
    assert len(score.results) == 4
    assert np.all(score.energy_per_request_j > 0)
    feas = score.p99_latency_s[score.order] <= 0.05
    if feas.any():
        e = score.energy_per_request_j[score.order][feas]
        assert np.all(np.diff(e) >= -1e-12)
    assert np.all(res.valid[score.indices])
    np.testing.assert_array_equal(score.indices, s0.indices)
    np.testing.assert_array_equal(score.order, s0.order)
    np.testing.assert_array_equal(score.p99_latency_s, s0.p99_latency_s)
    assert rel_err(score.energy_per_request_j, s0.energy_per_request_j) \
        <= 1e-12
    assert [r.swaps for r in score.results] == [r.swaps for r in s0.results]


# --------------------------------------------------------- B = 1 contract
@pytest.mark.parametrize("kind", ["constant", "poisson", "diurnal", "mmpp"])
def test_batch_b1_matches_sequential_bitforbit_open_loop(kind):
    """Port ``BatchSimEngine("torch")`` at B = 1 == port ``SimEngine``, bit
    for bit (queues, counters, energy, completed, p50/p99, histories,
    telemetry rows); the sequential run also equals the reference's."""
    plat = platform(PORT, 6)
    bplat = PORT.sim.BatchSimPlatform.stack([plat])
    cap = engine(PORT, plat).capacity_rps()
    tr = trace(PORT, kind, cap)
    cfg = PORT.sim.SimConfig(telemetry_interval=20, telemetry_capacity=64)
    seq_eng = engine(PORT, plat, config=cfg)
    seq = seq_eng.run(tr)
    bat_eng = PORT.sim.BatchSimEngine(bplat, config=cfg, device="cpu")
    bat = bat_eng.run(tr)
    for f in ("completed", "residual", "energy_j", "p50_latency_s",
              "p99_latency_s", "throughput_rps", "dropped",
              "energy_per_request_j", "mean_power_w"):
        assert getattr(bat, f)[0] == getattr(seq, f), f
    for f in STATE:
        assert torch.equal(getattr(bat_eng.last_state, f)[0],
                           getattr(seq_eng.last_state, f)), f
    for a, b in zip(bat_eng.last_histories, seq_eng.last_histories):
        assert torch.equal(a[:, 0], b)
    d0 = bat.telemetry.design(0)
    np.testing.assert_array_equal(d0["queue_depth"],
                                  seq.telemetry.queue_depth.array())
    np.testing.assert_array_equal(d0["busy"], seq.telemetry.busy.array())
    for ch in seq.telemetry.SCALARS:
        np.testing.assert_array_equal(d0["scalars"][ch],
                                      seq.telemetry.series(ch), err_msg=ch)

    ref_eng = engine(REF, platform(REF, 6), config=REF.sim.SimConfig(
        telemetry_interval=20, telemetry_capacity=64))
    ref = ref_eng.run(REF.sim.Trace(tr.arrivals, tr.dt))
    assert_results_match(seq, ref)
    assert_state_matches(seq_eng, ref_eng)


@pytest.mark.parametrize("kind", ["constant", "diurnal", "mmpp"])
@pytest.mark.parametrize("policy", ["membound", "pid"])
def test_batch_b1_matches_sequential_bitforbit_controlled(kind, policy):
    plat = platform(PORT, 6)
    bplat = PORT.sim.BatchSimPlatform.stack([plat])
    cap = engine(PORT, plat).capacity_rps()
    tr = trace(PORT, kind, cap)
    cfg = PORT.sim.SimConfig(control_interval=25)
    s_ctl = harness(PORT, plat, scalar_policy(PORT, policy))
    b_ctl = PORT.sim.BatchControllerHarness(
        bplat.islands, bplat.rates, batch_policy(PORT, policy),
        tile_names=bplat.names, queue_guard_ticks=3.0)
    seq_eng = engine(PORT, plat, config=cfg, controller=s_ctl)
    seq = seq_eng.run(tr)
    bat = PORT.sim.BatchSimEngine(bplat, config=cfg, controller=b_ctl,
                                  device="cpu").run(tr)
    for f in ("completed", "energy_j", "p50_latency_s", "p99_latency_s",
              "residual"):
        assert getattr(bat, f)[0] == getattr(seq, f), f
    assert int(bat.swaps[0]) == seq.swaps
    seq_rates = np.asarray([i.rate for i in s_ctl.live().islands])
    np.testing.assert_array_equal(b_ctl.rates[0], seq_rates)
    assert int(b_ctl.versions[0]) == s_ctl.live().version
    assert [e["tick"] for e in bat.telemetry.events] == \
        [e["tick"] for e in seq.telemetry.events]

    rplat = platform(REF, 6)
    r_ctl = harness(REF, rplat, scalar_policy(REF, policy))
    ref = engine(REF, rplat, config=REF.sim.SimConfig(control_interval=25),
                 controller=r_ctl).run(REF.sim.Trace(tr.arrivals, tr.dt))
    assert_results_match(seq, ref)
    assert_live_equal(s_ctl, r_ctl)


def test_batch_b1_parity_multi_tile_islands_and_drops():
    """Multi-tile islands (island means over > 1 tile) and admission drops:
    B = 1 == sequential in the port, and the sequential run == the
    reference's."""
    groups = {"left": ("dfmul0", "dfmul1"), "right": ("dfmul2", "dfmul3")}

    def seq_run(pkg):
        plat = platform(pkg, 4, island_groups=groups)
        cap = engine(pkg, plat).capacity_rps()
        tr = trace(pkg, "mmpp", cap)
        cfg = pkg.sim.SimConfig(control_interval=20, max_queue=40.0)
        ctl = harness(pkg, plat, pkg.dfs.PIDRatePolicy(target=0.6),
                      queue_guard_ticks=2.0)
        return plat, tr, cfg, ctl, engine(pkg, plat, config=cfg,
                                          controller=ctl).run(tr)
    (_, _, _, c0, r0), (plat, tr, cfg, s_ctl, seq) = both(seq_run)
    bplat = PORT.sim.BatchSimPlatform.stack([plat])
    b_ctl = PORT.sim.BatchControllerHarness(
        bplat.islands, bplat.rates, PORT.dfs.BatchPIDRatePolicy(target=0.6),
        tile_names=bplat.names, queue_guard_ticks=2.0)
    bat = PORT.sim.BatchSimEngine(bplat, config=cfg, controller=b_ctl,
                                  device="cpu").run(tr)
    assert seq.dropped > 0
    for f in ("dropped", "completed", "energy_j", "p99_latency_s"):
        assert getattr(bat, f)[0] == getattr(seq, f), f
    assert int(bat.swaps[0]) == seq.swaps
    assert_results_match(seq, r0)
    assert_live_equal(s_ctl, c0)


def test_batch_b1_export_matches_sequential_export():
    """The B = 1 batched telemetry dump is, channel for channel, the
    sequential dump (``tests/test_telemetry.py``), and that dump is the
    reference's."""
    plat = platform(PORT, 4, k=2)
    cfg = PORT.sim.SimConfig(telemetry_interval=10, telemetry_capacity=64)
    cap = engine(PORT, plat).capacity_rps()
    tr = PORT.sim.diurnal_trace(cap * 0.5, 300, 4, dt=DT, depth=0.5, seed=2)
    seq = engine(PORT, plat, config=cfg).run(tr)
    bat = PORT.sim.BatchSimEngine(PORT.sim.BatchSimPlatform.stack([plat]),
                                  config=cfg, device="cpu").run(tr)
    sdoc = json.loads(seq.telemetry.to_json())
    bdoc = json.loads(bat.telemetry.to_json())
    for ch in ("island_rates", "queue_depth", "busy"):
        np.testing.assert_array_equal(np.asarray(bdoc[ch])[:, 0, :],
                                      np.asarray(sdoc[ch]), err_msg=ch)
    for name in seq.telemetry.SCALARS:
        np.testing.assert_array_equal(
            np.asarray(bdoc["scalars"][name])[:, 0],
            np.asarray(sdoc["scalars"][name]), err_msg=name)
    assert bdoc["rows_recorded"] == sdoc["rows_recorded"]
    ref = engine(REF, platform(REF, 4, k=2), config=REF.sim.SimConfig(
        telemetry_interval=10, telemetry_capacity=64)).run(
            REF.sim.Trace(tr.arrivals, tr.dt))
    assert sdoc == json.loads(ref.telemetry.to_json())


# ------------------------------------------------------- scalar policies
def _telemetry(pkg, plat, rng_seed):
    rng = np.random.default_rng(rng_seed)
    return {n: pkg.dfs.TileTelemetry(
        exec_time=float(rng.random()), pkts_in=float(rng.random() * 100),
        pkts_out=float(rng.random() * 100), rtt=float(rng.random()),
        boundness=float(rng.random())) for n in plat.names}


@pytest.mark.parametrize("seed", range(4))
def test_scalar_policies_equal_reference(seed):
    groups = {"left": ("dfmul0", "dfmul1"), "mid": ("dfmul2",),
              "right": ("dfmul3", "dfmul4")}
    rp, pp = both(lambda pkg: platform(pkg, 5, island_groups=groups))
    for key in ("membound", "straggler"):
        fn = {"membound": "policy_memory_bound",
              "straggler": "policy_straggler"}[key]
        a = getattr(REF.dfs, fn)(rp.islands, _telemetry(REF, rp, seed))
        b = getattr(PORT.dfs, fn)(pp.islands, _telemetry(PORT, pp, seed))
        assert a == b, key
    pr, pt = REF.dfs.PIDRatePolicy(kd=0.1), PORT.dfs.PIDRatePolicy(kd=0.1)
    for step in range(5):
        assert pr(rp.islands, _telemetry(REF, rp, seed * 10 + step)) == \
            pt(pp.islands, _telemetry(PORT, pp, seed * 10 + step))
    pr.reset(), pt.reset()
    assert pt._integral == pr._integral == {}


@pytest.mark.parametrize("tech", [None, 16])
def test_energy_per_token_policies_equal_reference(tech):
    """The sweep and the coordinate descent over the rate ladders, through
    each package's perf model, give the same rates."""
    def run(pkg):
        m = pkg.pm.SoCPerfModel()
        il = ref_islands if pkg is REF else port_islands
        isl = il.IslandConfig((
            il.IslandSpec("acc", ("dfadd",), il.TILE_LADDER, 1.0),
            il.IslandSpec("noc_mem", ("NOC", "MEM"), il.NOC_LADDER, 1.0)))

        def batch(rates):
            fa, fn = rates["acc"], rates["noc_mem"]
            tps = m.accel_throughput_batch(base_mbps=9.22, wire_share=0.12,
                                           k=4, f_acc=fa, f_noc=fn, f_tg=1.0,
                                           n_tg=4, pos=(1, 1))
            watts = pkg.pm.chip_power(fa, 1.0) \
                + pkg.pm.NOC_POWER_SHARE * pkg.pm.chip_power(fn, 1.0)
            return tps, np.broadcast_to(watts, np.shape(tps))

        def scalar(rates):
            tps, w = batch({k: np.asarray(v) for k, v in rates.items()})
            return float(tps), float(w)

        return (pkg.dfs.policy_energy_per_token_sweep(isl, batch, tech=tech),
                pkg.dfs.policy_energy_per_token(isl, {}, scalar, tech=tech))
    assert run(REF) == run(PORT)


# ------------------------------------------------------- C2 actuator swap
def _islands(pkg):
    if pkg is REF:
        return ref_default_islands(ref_default_plan(
            ref_get_config("granite-8b")))
    return default_islands(default_plan(get_config("granite-8b")))


def test_actuator_islands_equal_reference():
    a, b = _islands(REF), _islands(PORT)
    assert [(i.name, i.tiles, i.rate, i.fixed) for i in a.islands] == \
        [(i.name, i.tiles, i.rate, i.fixed) for i in b.islands]


def test_commit_without_reconfigure_is_noop():
    act = PORT.dfs.DFSActuator(_islands(PORT))
    v0 = act.live().version
    assert act.commit().version == v0
    assert act.swaps == 0


def test_abort_drops_shadow_without_exposure():
    act = PORT.dfs.DFSActuator(_islands(PORT))
    v0 = act.live().version
    act.reconfigure({"noc_mem": 0.5})
    act.abort()
    assert act.commit().version == v0
    assert act.live().rate_of("mem") == 1.0


def test_history_is_bounded_with_custom_maxlen():
    acts = [pkg.dfs.DFSActuator(_islands(pkg), history_maxlen=5)
            for pkg in (REF, PORT)]
    for act in acts:
        assert act.history_maxlen == 5
        for i in range(50):
            act.reconfigure({"noc_mem": 0.5 if i % 2 else 1.0})
            act.commit()
    act = acts[1]
    h = act.history()
    assert act.swaps == 50 and len(h) == 5
    versions = [v for v, _ in h]
    assert versions == sorted(versions)
    assert versions[-1] == act.live().version
    assert h == acts[0].history()


def test_history_default_maxlen_bounds_growth():
    act = PORT.dfs.DFSActuator(_islands(PORT))
    for i in range(PORT.dfs.DEFAULT_HISTORY_MAXLEN + 37):
        act.reconfigure({"noc_mem": 0.5 if i % 2 else 1.0})
        act.commit()
    assert len(act.history()) == PORT.dfs.DEFAULT_HISTORY_MAXLEN
    assert PORT.dfs.DEFAULT_HISTORY_MAXLEN == REF.dfs.DEFAULT_HISTORY_MAXLEN


def test_concurrent_commit_swap_atomicity():
    """Readers racing a reconfigure/commit storm only ever observe fully
    formed configs: every island present, versions monotonic per reader,
    rates on the ladder."""
    act = PORT.dfs.DFSActuator(_islands(PORT))
    names = set(act.live().names())
    stop = threading.Event()
    errors = []

    def reader():
        last_version = -1
        while not stop.is_set():
            cfg = act.live()
            try:
                assert set(cfg.names()) == names
                assert cfg.version >= last_version
                for isl in cfg.islands:
                    if not isl.fixed:
                        assert isl.rate in isl.ladder.levels()
                last_version = cfg.version
            except AssertionError as e:        # pragma: no cover
                errors.append(e)
                return

    def writer(seed):
        rng = np.random.default_rng(seed)
        for _ in range(300):
            act.reconfigure({"noc_mem": float(rng.uniform(0.1, 1.0))})
            if rng.random() < 0.1:
                act.abort()
            else:
                act.commit()

    readers = [threading.Thread(target=reader) for _ in range(3)]
    writers = [threading.Thread(target=writer, args=(s,)) for s in range(3)]
    for t in readers + writers:
        t.start()
    for t in writers:
        t.join()
    stop.set()
    for t in readers:
        t.join()
    assert not errors
    assert act.swaps <= 900
    assert len(act.history()) <= PORT.dfs.DEFAULT_HISTORY_MAXLEN


# ---------------------------------------------------- carried state across
def _harness_dict(ctl):
    live = ctl.live()
    pol = ctl.policy
    return {"live": {"islands": [
                {"name": i.name, "tiles": i.tiles,
                 "ladder": (i.ladder.f_min_mhz, i.ladder.f_max_mhz,
                            i.ladder.f_step_mhz),
                 "rate": i.rate, "fixed": i.fixed} for i in live.islands],
                     "version": live.version},
            "swaps": ctl.actuator.swaps, "history": ctl.actuator.history(),
            "guard_active": sorted(ctl._guard_active),
            "integral": getattr(pol, "_integral", None),
            "prev_err": getattr(pol, "_prev_err", None)}


def _platform_dict(p):
    from _torch_port_helpers import model_dict
    return {"model": model_dict(p.model), "names": p.names,
            "islands": [{"name": i.name, "tiles": i.tiles,
                         "ladder": (i.ladder.f_min_mhz, i.ladder.f_max_mhz,
                                    i.ladder.f_step_mhz),
                         "rate": i.rate, "fixed": i.fixed}
                        for i in p.islands.islands],
            "version": p.islands.version, "n_tg": p.n_tg, "f_tg": p.f_tg,
            **{k: np.array(getattr(p, k)) for k in
               ("base_mbps", "wire_share", "k", "pos_idx", "req_mb")}}


def test_carried_platform_and_harness_state_continue_the_reference_run():
    """A reference run is stopped half way; its platform and controller
    state (actuator version, history, swaps, guard latches, the PID
    integrator) are carried into the port, and the second half runs the
    same in both."""
    rplat = platform(REF, 4)
    cap = engine(REF, rplat).capacity_rps()
    first = trace(REF, "diurnal", cap, ticks=600, seed=4)
    second = trace(REF, "mmpp", cap, ticks=600, seed=5)
    cfg = REF.sim.SimConfig(control_interval=20)
    r_ctl = harness(REF, rplat, REF.dfs.PIDRatePolicy(target=0.6))
    REF.sim.SimEngine(rplat, config=cfg, controller=r_ctl).run(first)
    assert r_ctl.actuator.swaps > 0

    pplat = convert.sim_platform_from_numpy(_platform_dict(rplat))
    np.testing.assert_array_equal(
        engine(PORT, pplat).capacity_rps(), cap)
    p_ctl = harness(PORT, pplat, PORT.dfs.PIDRatePolicy(target=0.6))
    convert.harness_state_from_numpy(p_ctl, _harness_dict(r_ctl))
    assert_live_equal(p_ctl, r_ctl)

    r = REF.sim.SimEngine(rplat, config=cfg, controller=r_ctl).run(second)
    p = engine(PORT, pplat, config=PORT.sim.SimConfig(control_interval=20),
               controller=p_ctl).run(PORT.sim.Trace(second.arrivals,
                                                    second.dt))
    assert_results_match(p, r)
    assert_live_equal(p_ctl, r_ctl)
    assert p_ctl.policy._integral == r_ctl.policy._integral
    with pytest.raises(ValueError, match="islands"):
        other = platform(PORT, 3)
        convert.harness_state_from_numpy(
            harness(PORT, other, None), _harness_dict(r_ctl))


# ---------------------------------------------------------------- refusals
def _knob_run(pkg, knob):
    """A four-tile run with ``knob`` set (queue A item 8's knobs), its
    tiles offered 1.2x their capacity so queues stand: a kill of one
    replica of a balanced pair for ``faults`` / ``supervisor``, a deadline
    for ``slo``."""
    import repro.runtime.fault as ref_rt
    import repro_torch.runtime.fault as port_rt
    plat = platform(pkg, 4)
    cap = engine(pkg, plat).capacity_rps()
    tr = pkg.sim.constant_trace(cap * 1.2, 300, 4, dt=DT)
    kill = pkg.sim.FaultSchedule().kill_tile(plat.names[1], start=100,
                                             end=200)
    rt = port_rt if pkg is PORT else ref_rt
    knobs = {"faults": dict(faults=kill),
             "slo": dict(slo=pkg.sim.SLOConfig(deadline_s=0.004)),
             "supervisor": dict(faults=kill, supervisor=rt.
                                SimFaultSupervisor())}[knob]
    eng = engine(pkg, plat, config=pkg.sim.SimConfig(telemetry_interval=7),
                 balancer=pkg.sim.LoadBalancer([plat.names[:2]], plat.names),
                 **knobs)
    return eng, eng.run(tr)


@pytest.mark.parametrize("knob,item", [("faults", "8"), ("slo", "8"),
                                       ("supervisor", "8"),
                                       ("observe", "9")])
def test_unported_knobs_are_refused(knob, item):
    """Every knob of queue A items 8 and 9 is ported now: faults, SLO
    semantics and the online supervisor each run with the knob set and
    equal the reference's run (the module's tolerances, the fault/SLO
    ledgers and histories exact); the observer plane (item 9) leaves the
    run bit for bit as it was and records the reference's counters."""
    plat = platform(PORT, 4)
    if knob != "observe":
        (pe, p), (re_, r) = _knob_run(PORT, knob), _knob_run(REF, knob)
        assert_results_match(p, r)
        assert_state_matches(pe, re_)
        for f in ("dropped_slo", "dropped_fault", "retried", "drop_rate"):
            assert getattr(p, f) == getattr(r, f), f
        assert p.dropped_slo + p.dropped_fault + p.retried > 0.0
        for k, v in re_.last_fault_histories.items():
            np.testing.assert_array_equal(
                pe.last_fault_histories[k].numpy(), v, err_msg=k)
        if knob == "supervisor":
            assert pe.supervisor.events == re_.supervisor.events
            assert pe.supervisor.events
        return
    cap = engine(PORT, plat).capacity_rps()
    runs = {}
    for level in (None, "off", "counters"):
        pe = engine(PORT, plat, observe=level, faults=None)
        runs[level] = (pe, pe.run(trace(PORT, "poisson", cap, ticks=300)))
        assert_results_match(runs[level][1], runs[None][1])
    assert runs["off"][0].observer is None
    re_ = engine(REF, platform(REF, 4), observe="counters")
    re_.run(trace(REF, "poisson", cap, ticks=300))
    mine, theirs = runs["counters"][0].observer.counters, \
        re_.observer.counters
    for group in ("tile", "link", "island"):
        for k, v in getattr(theirs, group).items():
            np.testing.assert_array_equal(getattr(mine, group)[k], v)


def test_zero_tiles_refused_like_the_reference():
    """No tile: the reference's telemetry refuses a zero-width ring, and
    so does the port's."""
    for pkg in (REF, PORT):
        plat = pkg.sim.SimPlatform.build(pkg.pm.SoCPerfModel(), [], [])
        with pytest.raises(AssertionError):
            engine(pkg, plat).run(pkg.sim.Trace(np.zeros((20, 0)), DT))


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    with pytest.raises(RuntimeError, match="CUDA"):
        PORT.sim.SimEngine(platform(PORT, 2))


# -------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the sequential engine on the card is "
                    "held against the CPU there (chip_smoke.py runs this "
                    "case on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["open", "membound", "pid"])
def test_cuda_sequential_engine_matches_cpu(policy, cuda_device):
    """The sequential engine on the card against the same run on the CPU
    (energy, completed, dropped <= 1e-12; p50/p99, swaps and commit history
    exact) and against the B = 1 batched run on the card, bit for bit.
    The case runs in ``chip_smoke.py`` (``card_sim_engine``)."""
    chip_smoke().card_case("test_cuda_sequential_engine_matches_cpu", policy)
