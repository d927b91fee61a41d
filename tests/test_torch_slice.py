"""Port vs reference: the slice as a whole — sweep -> closed-loop re-rank ->
batched co-simulation.

A small joint sweep (two accelerators), ``closed_loop_score`` with a seeded
diurnal trace, survivors = the top 16 / 64 throughput points, open-loop and
with a PID harness, linear voltage proxy and the 45 nm tech model; through
``repro`` (``"numpy"`` and ``"pallas"``) and through the port (``"torch"``
and ``"fused"``, CPU tensors).

* ``"torch"`` vs ``"numpy"``: same ``indices``, scores within 1e-12
  relative, **identical ranking**.
* ``"fused"`` vs ``"pallas"`` (both float32, different op order): scores
  rtol 1e-4 and the same ranking on this configuration.
* a reference platform / sweep / controller carried across with
  ``repro_torch.convert`` gives the same result as one built natively.
* the per-point sequential path (``controller_factory=`` / ``batch=False``)
  and ``balancer_factory=``: the reference's indices and ranking, scores
  within 1e-12; what is still not ported is refused, naming its ROADMAP
  item, and ``"fused"`` refuses the balancer in the reference's words.
"""
import numpy as np
import pytest

from repro_torch import convert

from _torch_port_helpers import (PORT, REF, controller_dict, make_engine,
                                 make_trace, capacity, platform_dict,
                                 rel_err, sweep_dict)

T, DT, REQ_MB = 400, 1e-3, 0.002
GRID = dict(ks=(1, 2, 4, 8), acc_rates=(0.2, 0.6, 1.0),
            noc_rates=(0.5, 1.0), n_tg=2)
_CACHE = {}


def _sweep(pkg):
    if pkg.name not in _CACHE:
        m = pkg.pm.SoCPerfModel()
        wls = [pkg.pm.AccelWorkload("dfadd", 9.22, 0.9),
               pkg.pm.AccelWorkload("dfmul", 8.70, 1.1)]
        kw = dict(device="cpu") if pkg is PORT else {}
        _CACHE[pkg.name] = (m, pkg.dse.grid_sweep(m, wls, **GRID, **kw))
    return _CACHE[pkg.name]


def _pid_factory(pkg):
    def factory(platform):
        return pkg.sim.BatchControllerHarness(
            platform.islands, platform.rates,
            pkg.dfs.BatchPIDRatePolicy(target=0.7),
            tile_names=platform.names, queue_guard_ticks=3.0)
    return factory


def _score(pkg, backend, top, pid, tech):
    m, res = _sweep(pkg)
    idx = np.resize(res.topk_indices(top), top)
    trace = pkg.sim.diurnal_trace(2000.0, T, 2, dt=DT, depth=0.4, seed=5)
    kw = dict(device="cpu") if pkg is PORT else {}
    return pkg.dse.closed_loop_score(
        res, trace, model=m, indices=idx, req_mb=REQ_MB,
        sim_config=pkg.sim.SimConfig(control_interval=25),
        batch_controller_factory=_pid_factory(pkg) if pid else None,
        backend=backend, tech=tech, p99_sla_s=0.02, **kw)


CONFIGS = [(top, pid, tech) for top in (16, 64) for pid in (False, True)
           for tech in (None, 45)]
IDS = ["top%d-%s-%s" % (t, "pid" if p else "open",
                        "lin" if k is None else "45nm")
       for t, p, k in CONFIGS]


@pytest.mark.parametrize("top,pid,tech", CONFIGS, ids=IDS)
def test_torch_backend_ranks_like_numpy_reference(top, pid, tech):
    a = _score(REF, "numpy", top, pid, tech)
    b = _score(PORT, "torch", top, pid, tech)
    np.testing.assert_array_equal(b.indices, a.indices)
    for f in ("p99_latency_s", "energy_per_request_j", "throughput_rps"):
        assert rel_err(getattr(b, f), getattr(a, f)) <= 1e-12, f
    np.testing.assert_array_equal(b.order, a.order)
    np.testing.assert_array_equal(b.ranked_indices(), a.ranked_indices())
    np.testing.assert_array_equal(b.results[0].swaps, a.results[0].swaps)


@pytest.mark.parametrize("top,pid,tech", CONFIGS, ids=IDS)
def test_fused_backend_ranks_like_pallas_reference(top, pid, tech):
    a = _score(REF, "pallas", top, pid, tech)
    b = _score(PORT, "fused", top, pid, tech)
    np.testing.assert_array_equal(b.indices, a.indices)
    for f in ("p99_latency_s", "energy_per_request_j", "throughput_rps"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=1e-4,
                                   err_msg=f)
    np.testing.assert_array_equal(b.ranked_indices(), a.ranked_indices())
    np.testing.assert_array_equal(b.results[0].swaps, a.results[0].swaps)


def test_default_survivors_are_the_pareto_top():
    ma, ra = _sweep(REF)
    mb, rb = _sweep(PORT)
    ta = REF.sim.diurnal_trace(2000.0, 150, 2, dt=DT, depth=0.4, seed=5)
    tb = PORT.sim.diurnal_trace(2000.0, 150, 2, dt=DT, depth=0.4, seed=5)
    a = REF.dse.closed_loop_score(ra, lambda s: ta, model=ma, top=6,
                                  req_mb=REQ_MB)
    b = PORT.dse.closed_loop_score(rb, lambda s: tb, model=mb, top=6,
                                   req_mb=REQ_MB, device="cpu")
    np.testing.assert_array_equal(b.indices, a.indices)
    np.testing.assert_array_equal(b.ranked_indices(), a.ranked_indices())
    assert b.counters is None and b.drop_rate is None


REFUSED = [
    ("fault_schedule", "fault"),
    ("slo", "SLO"),
    ("balancer_factory", "balancer"),
    (dict(observe="counters"), "observer"),
    ("controller_factory", "sequential"),
    (dict(batch=False), "sequential"),
    (dict(devices=2), "multi-device"),
]
# the knobs of REFUSED that are ported now: each case runs through both
# packages and must give the reference's indices and ranking, scores within
# 1e-12, and the reference's counter summaries (the "fused" batched path
# still refuses the balancer, the fault schedule, the SLO and the observer)
PORTED = ("balancer", "sequential", "fault", "SLO", "observer",
          "multi-device")
FUSED_REFUSES = ("balancer", "fault", "SLO", "observer")
# what "fused" says for each knob it refuses, where its words are fixed
FUSED_WORDS = {
    "balancer": "fused backend does not run the load balancer; use "
                "backend='torch'",
    "observer": "fused backend records no observer plane; use "
                "backend='torch'",
    "fault": "fused backend does not simulate fault schedules; use "
             "backend='torch'",
    "SLO": "fused backend does not apply SLO semantics; use "
           "backend='torch'"}


def _knob(pkg, kw):
    """The keyword arguments one REFUSED entry stands for, in ``pkg``."""
    if kw == "balancer_factory":
        return {"balancer_factory": lambda p: pkg.sim.LoadBalancer(
            [("dfadd",), ("dfmul",)], p.names)}
    if kw == "fault_schedule":
        return {"fault_schedule": pkg.sim.FaultSchedule().stick_island(
            "dfmul", start=5, end=15, rate=0.2),
            "slo": pkg.sim.SLOConfig(deadline_s=0.003), "max_drop_rate": 0.02}
    if kw == "slo":
        return {"slo": pkg.sim.SLOConfig(deadline_s=0.003)}
    if kw == "controller_factory":
        return {"controller_factory": lambda p: pkg.sim.ControllerHarness(
            p.islands, pkg.dfs.PIDRatePolicy(target=0.7),
            queue_guard_ticks=3.0)}
    return kw


@pytest.mark.parametrize("kw,word", REFUSED,
                         ids=[w + str(i) for i, (_, w) in enumerate(REFUSED)])
@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_closed_loop_score_refuses_unported_knobs(kw, word, backend,
                                                  monkeypatch):
    """What is not ported is refused, naming its ROADMAP item; the
    balancer, the per-point sequential path, fault-aware scoring and the
    observer (queue A items 7, 4, 8 and 9) run and are held to the
    reference (drop rates exact, counter summaries equal), but for the
    balancer, the fault schedule, the SLO and the observer on ``"fused"``,
    which refuses them."""
    tr = {pkg.name: pkg.sim.diurnal_trace(2000.0, 20, 2, dt=DT, seed=5)
          for pkg in (REF, PORT)}
    if word == "multi-device":
        # ported (queue A item 12a): two shards give the one-device scores
        # bit for bit on both backends (tests/test_torch_shard.py holds the
        # shards against the reference)
        monkeypatch.setenv("REPRO_TORCH_FORCE_DEVICE_COUNT", "2")
        m, res = _sweep(PORT)
        one, two = (PORT.dse.closed_loop_score(
            res, tr["repro_torch"], model=m, top=3, req_mb=REQ_MB,
            sim_config=PORT.sim.SimConfig(control_interval=5),
            device="cpu", backend=backend, devices=d) for d in (None, 2))
        np.testing.assert_array_equal(two.ranked_indices(),
                                      one.ranked_indices())
        for f in ("p99_latency_s", "energy_per_request_j", "throughput_rps"):
            np.testing.assert_array_equal(getattr(two, f), getattr(one, f))
        return
    if word in PORTED and not (word in FUSED_REFUSES and backend == "fused"):
        got = {}
        for pkg in (REF, PORT):
            m, res = _sweep(pkg)
            extra = ({"device": "cpu", "backend": backend} if pkg is PORT
                     else {})
            got[pkg.name] = pkg.dse.closed_loop_score(
                res, tr[pkg.name], model=m, top=4, req_mb=REQ_MB,
                sim_config=pkg.sim.SimConfig(control_interval=5),
                **_knob(pkg, kw), **extra)
        a, b = got["repro"], got["repro_torch"]
        np.testing.assert_array_equal(b.indices, a.indices)
        np.testing.assert_array_equal(b.ranked_indices(), a.ranked_indices())
        assert rel_err(b.energy_per_request_j, a.energy_per_request_j) \
            <= 1e-12
        np.testing.assert_array_equal(b.p99_latency_s, a.p99_latency_s)
        assert (a.drop_rate is None) == (b.drop_rate is None)
        if a.drop_rate is not None:
            np.testing.assert_array_equal(b.drop_rate, a.drop_rate)
        assert (a.counters is None) == (b.counters is None)
        assert b.counters == a.counters
        assert len(b.results) == len(a.results)
        return
    m, res = _sweep(PORT)
    with pytest.raises(NotImplementedError) as err:
        PORT.dse.closed_loop_score(res, tr["repro_torch"], model=m, top=4,
                                   device="cpu", backend=backend,
                                   **_knob(PORT, kw))
    assert word in str(err.value)
    if word in FUSED_WORDS:
        assert str(err.value) == FUSED_WORDS[word]
    else:
        assert "not ported yet (ROADMAP queue A item" in str(err.value)


# ------------------------------------------------------------- converter
def test_converted_sweep_and_platform_equal_native():
    ma, ra = _sweep(REF)
    mb, rb = _sweep(PORT)
    carried = convert.sweep_result_from_numpy(sweep_dict(ra))
    assert carried.axes == rb.axes and carried.shape == rb.shape
    for f in ("throughput", "area", "energy_per_unit", "mem_traffic",
              "valid"):
        assert np.array_equal(getattr(carried, f), getattr(rb, f))
    assert np.array_equal(carried.pareto_indices(), rb.pareto_indices())

    idx = ra.topk_indices(12)
    plat_ref = REF.sim.BatchSimPlatform.from_design_points(
        ma, ra, idx, req_mb=REQ_MB)
    plat_native = PORT.sim.BatchSimPlatform.from_design_points(
        mb, rb, idx, req_mb=REQ_MB)
    plat_carried = convert.platform_from_numpy(platform_dict(plat_ref))
    assert plat_carried.model == plat_native.model
    assert plat_carried.islands == plat_native.islands
    assert plat_carried.names == plat_native.names
    for f in ("base_mbps", "wire_share", "k", "pos_idx", "req_mb", "rates",
              "f_tg"):
        assert np.array_equal(getattr(plat_carried, f),
                              getattr(plat_native, f)), f
    tr = PORT.sim.diurnal_trace(2000.0, 150, 2, dt=DT, depth=0.4, seed=5)
    for backend in ("torch", "fused"):
        r1 = PORT.sim.BatchSimEngine(plat_carried, backend=backend,
                                     device="cpu").run(tr)
        r2 = PORT.sim.BatchSimEngine(plat_native, backend=backend,
                                     device="cpu").run(tr)
        for f in ("completed", "energy_j", "p99_latency_s", "residual"):
            assert np.array_equal(getattr(r1, f), getattr(r2, f)), f


@pytest.mark.parametrize("policy", ["pid", "ewma", "membound"])
def test_converted_controller_state_continues_the_run(policy):
    """Run the reference for a while, carry platform + controller state
    across, and continue in the port: the continuation equals the
    reference's own second run (float64 backend, <= 1e-12 relative)."""
    cap = capacity(4, k=2)
    e0 = make_engine(REF, "numpy", policy, chain=True)
    e0.run(make_trace(REF, "diurnal", cap, ticks=150))
    state = controller_dict(e0.controller)
    plat = convert.platform_from_numpy(platform_dict(e0.platform))

    fresh = make_engine(PORT, "torch", policy, chain=True)
    ctl = convert.controller_state_from_numpy(fresh.controller, state)
    e1 = PORT.sim.BatchSimEngine(plat, config=fresh.config, controller=ctl,
                                 backend="torch", device="cpu")
    r0 = e0.run(make_trace(REF, "mmpp", cap, ticks=150))
    r1 = e1.run(make_trace(PORT, "mmpp", cap, ticks=150))
    for f in ("completed", "energy_j", "residual", "p99_latency_s"):
        assert rel_err(getattr(r1, f), getattr(r0, f)) <= 1e-12, f
    np.testing.assert_array_equal(e1.controller.swaps, e0.controller.swaps)
    np.testing.assert_array_equal(e1.controller.rates, e0.controller.rates)
