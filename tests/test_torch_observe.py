"""Port vs reference: the run-time monitoring plane (``sim/observe.py``,
``sim/metrics.py``).

Every case of ``tests/test_observe.py``, each run through both packages on
the same seeded inputs (``device="cpu"`` for the port), plus the port's own
contracts:

* **zero perturbation** — the port's simulated outputs are bit for bit the
  same with monitoring on or off, on ``SimEngine`` and on the ``"torch"``
  backend in float64 and float32;
* **the counter plane** — every counter of the port's float64 plane is
  **array-equal** to the reference's NumPy plane (sequential, and batched
  against the reference's ``"numpy"`` backend, whose B = 1 plane equals the
  sequential one); the float32 loop's counters lie within
  ``2e-4 * max(|v|, 1) + 1e-6`` of the float64 run's with ``stall_ticks``
  exact, the bar the reference sets its float32 scan;
* **the trace** — the ``"full"`` trace's JSONL equals the reference's, event
  for event (run bracket, fault transitions, detections, SLO-drop spans,
  balancer splits, DFS clamps / guards / commits), although the port learns
  some of them on the device and emits them after the loop; the batched
  trace names the port's backend (``batch-torch``) where the reference
  names its own (``batch-numpy``);
* trace ring, spans, reset scoping, the Prometheus round trip,
  ``export_metrics``, lazy materialization, observer reuse, the profiler,
  ``closed_loop_score(observe=)`` summaries; ``"fused"`` refuses
  ``observe=`` in the reference's words.

The card runs the gpu-marked case in ``chip_smoke.py`` (``card_observe``).
"""
from functools import partial

import numpy as np
import pytest
import torch

import repro.runtime.fault as ref_rt
import repro_torch.runtime.fault as port_rt
import repro_torch.sim.observe as port_observe

from _torch_port_helpers import PORT, REF, chip_smoke

T = 300
DT = 1e-3
GROUPS = ("tile", "link", "island")


# --------------------------------------------------------------- fixtures
def make_platform(pkg, n_tiles=6, k=8):
    m = pkg.pm.SoCPerfModel()
    pos = [(r, c) for r in range(4) for c in range(4)
           if (r, c) not in {(1, 0), (0, 0), (0, 3)}][:n_tiles]
    wls = [pkg.pm.AccelWorkload("dfmul", 8.70, 1.1, replication=k)
           for _ in pos]
    return pkg.sim.SimPlatform.build(m, wls, pos, n_tg=2, req_mb=0.005)


def trace_(pkg):
    return pkg.sim.poisson_trace(4000.0, T, 6, dt=DT, seed=11)


def on_cpu(pkg, kw):
    return {**kw, "device": "cpu"} if pkg is PORT else kw


def seq_kwargs(pkg, plat, policy):
    if policy is None:
        return {}
    pol = (partial(pkg.dfs.policy_memory_bound, threshold=0.55,
                   low_rate=0.5)
           if policy == "membound" else pkg.dfs.PIDRatePolicy(target=0.7))
    return dict(controller=pkg.sim.ControllerHarness(
        plat.islands, pol, queue_guard_ticks=3.0))


def bat_kwargs(pkg, bplat, policy):
    if policy is None:
        return {}
    pol = (pkg.dfs.BatchMemoryBoundPolicy(threshold=0.55, low_rate=0.5)
           if policy == "membound"
           else pkg.dfs.BatchPIDRatePolicy(target=0.7))
    return dict(controller=pkg.sim.BatchControllerHarness(
        bplat.islands, bplat.rates, pol, tile_names=bplat.names,
        queue_guard_ticks=3.0))


def fault_kwargs(pkg, plat, use_faults):
    if not use_faults:
        return {}
    return dict(faults=pkg.sim.FaultSchedule().kill_tile(plat.names[2],
                                                         start=80, end=200),
                slo=pkg.sim.SLOConfig(deadline_s=0.05, on_kill="respill",
                                      max_retries=1))


def seq_run(pkg, policy=None, use_faults=False, observe="full", **kw):
    plat = make_platform(pkg)
    cfg = pkg.sim.SimConfig(control_interval=25)
    eng = pkg.sim.SimEngine(plat, config=cfg, observe=observe,
                            **seq_kwargs(pkg, plat, policy),
                            **fault_kwargs(pkg, plat, use_faults),
                            **on_cpu(pkg, kw))
    return eng, eng.run(trace_(pkg))


def bat_run(pkg, backend, n=1, policy=None, use_faults=False,
            observe="counters", **kw):
    plat = make_platform(pkg)
    bplat = pkg.sim.BatchSimPlatform.stack([plat] * n)
    eng = pkg.sim.BatchSimEngine(
        bplat, config=pkg.sim.SimConfig(control_interval=25),
        backend=backend, observe=observe, **bat_kwargs(pkg, bplat, policy),
        **fault_kwargs(pkg, plat, use_faults), **on_cpu(pkg, kw))
    return eng, eng.run(trace_(pkg))


def assert_planes_equal(port, ref):
    """Every counter array-equal (shapes included), and the tick count."""
    for group in GROUPS:
        mine, theirs = getattr(port, group), getattr(ref, group)
        assert set(mine) == set(theirs), group
        for k in theirs:
            assert mine[k].shape == np.shape(theirs[k]), (group, k)
            np.testing.assert_array_equal(mine[k], theirs[k],
                                          err_msg=f"{group}.{k}")
    np.testing.assert_array_equal(port.ticks, ref.ticks)
    assert port.tile_names == ref.tile_names
    assert port.island_names == ref.island_names


def assert_results_equal(a, b, fields=("p99_latency_s", "p50_latency_s",
                                       "energy_j", "completed", "dropped",
                                       "residual")):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


# ----------------------------------------------------------- perturbation
@pytest.mark.parametrize("policy", [None, "membound", "pid"])
@pytest.mark.parametrize("use_faults", [False, True])
def test_sequential_monitoring_is_zero_perturbation(policy, use_faults):
    """Bit for bit: full monitoring changes no simulated number of the
    port's sequential engine; its plane equals the reference's array for
    array and its trace the reference's JSONL."""
    _, r_off = seq_run(PORT, policy, use_faults, observe=None)
    eng, r_on = seq_run(PORT, policy, use_faults)
    assert_results_equal(r_on, r_off)
    assert r_on.swaps == r_off.swaps
    assert r_on.telemetry.to_dict() == r_off.telemetry.to_dict()
    ref, _ = seq_run(REF, policy, use_faults)
    assert_planes_equal(eng.observer.counters, ref.observer.counters)
    assert eng.observer.trace.to_jsonl() == ref.observer.trace.to_jsonl()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_batched_monitoring_is_zero_perturbation(dtype):
    """Same contract on the ``"torch"`` backend in both dtypes, under the
    PID controller with a mid-run tile kill (the hardest numeric path)."""
    _, r_off = bat_run(PORT, "torch", 2, "pid", True, observe=None,
                       dtype=dtype)
    eng, r_on = bat_run(PORT, "torch", 2, "pid", True, dtype=dtype)
    assert_results_equal(r_on, r_off)
    np.testing.assert_array_equal(r_on.swaps, r_off.swaps)
    assert eng.observer.counters is not None
    if dtype == torch.float64:
        ref, _ = bat_run(REF, "numpy", 2, "pid", True)
        assert_planes_equal(eng.observer.counters, ref.observer.counters)


# ------------------------------------------------------- engine agreement
@pytest.mark.parametrize("policy,use_faults",
                         [(None, False), ("pid", False), ("pid", True),
                          ("membound", True)])
def test_batch_b1_counters_match_sequential_exactly(policy, use_faults):
    """The B = 1 float64 plane equals the sequential one, and both equal
    the reference's."""
    seq, _ = seq_run(PORT, policy, use_faults, observe="counters")
    bat, _ = bat_run(PORT, "torch", 1, policy, use_faults)
    one = bat.observer.counters.design(0)
    assert_planes_equal(one, seq.observer.counters)
    assert float(one.ticks) == float(seq.observer.counters.ticks) == T
    ref, _ = bat_run(REF, "numpy", 1, policy, use_faults)
    assert_planes_equal(bat.observer.counters, ref.observer.counters)


@pytest.mark.parametrize("policy,use_faults", [("pid", True), (None, False)])
def test_float32_counters_match_float64_within_f32_tolerance(policy,
                                                             use_faults):
    """The float32 loop's accumulators land within float32 rounding of the
    float64 sequential plane — the integer-valued stall counts exactly."""
    seq, _ = seq_run(PORT, policy, use_faults, observe="counters")
    sp = seq.observer.counters
    f32, _ = bat_run(PORT, "torch", 1, policy, use_faults,
                     dtype=torch.float32)
    jp = f32.observer.counters.design(0)
    for group in GROUPS:
        mine, theirs = getattr(sp, group), getattr(jp, group)
        for k in mine:
            v, jv = np.asarray(mine[k]), np.asarray(theirs[k])
            tol = 2e-4 * np.maximum(np.abs(v), 1.0) + 1e-6
            assert (np.abs(jv - v) <= tol).all(), (group, k, v, jv)
    np.testing.assert_array_equal(sp.tile["stall_ticks"],
                                  jp.tile["stall_ticks"])
    assert float(jp.ticks) == T


def test_counters_tie_back_to_engine_histories():
    """offered/invocations are exactly the admitted/served column sums the
    engine itself kept; energy sums (within reassociation) to the result's
    energy integral."""
    plat = make_platform(PORT)
    eng = PORT.sim.SimEngine(plat, observe="counters", device="cpu")
    res = eng.run(trace_(PORT))
    cp = eng.observer.counters
    admitted, served = (h.numpy() for h in eng.last_histories)
    np.testing.assert_array_equal(cp.tile["offered"], admitted.sum(axis=0))
    np.testing.assert_array_equal(cp.tile["invocations"],
                                  served.sum(axis=0))
    assert cp.island["energy_j"].sum() == pytest.approx(res.energy_j,
                                                        rel=1e-9)
    s = cp.summary()
    assert s["ticks"] == T
    assert s["invocations"] == pytest.approx(served.sum())
    assert 0.0 < s["busy_frac"] <= 1.0
    assert s["peak_link_util"] > 0.0
    ref = REF.sim.SimEngine(make_platform(REF), observe="counters")
    ref.run(trace_(REF))
    assert s == ref.observer.counters.summary()


# ---------------------------------------------------------- control trace
@pytest.mark.parametrize("pkg", [REF, PORT], ids=lambda p: p.name)
def test_trace_rejects_unknown_kind_and_backward_tick(pkg):
    tr = pkg.sim.ControlTrace()
    tr.emit(5, "run_start", ticks=10)
    with pytest.raises(ValueError, match="unknown trace kind"):
        tr.emit(6, "made_up_kind")
    with pytest.raises(ValueError, match="non-monotonic"):
        tr.emit(4, "run_end")
    # equal ticks are fine (several events can share a tick)
    tr.emit(5, "dfs_commit", version=1)
    assert [e.kind for e in tr.events()] == ["run_start", "dfs_commit"]
    assert pkg.sim.TRACE_KINDS == REF.sim.TRACE_KINDS


def _ring(pkg):
    tr = pkg.sim.ControlTrace(capacity=8)
    for t in range(20):
        tr.emit(t, "dfs_commit", version=t,
                rates=np.asarray([0.5, 1.0]))       # np payloads allowed
    return tr


def test_trace_ring_bound_and_jsonl_roundtrip():
    tr = _ring(PORT)
    assert len(tr) == 8 and tr.total_emitted == 20
    assert tr.events()[0].tick == 12                # oldest fell off
    back = PORT.sim.ControlTrace.from_jsonl(tr.to_jsonl())
    assert [e.to_dict() for e in back.events()] == \
        [e.to_dict() for e in tr.events()]
    assert back.events()[-1].data["rates"] == [0.5, 1.0]
    assert tr.to_jsonl() == _ring(REF).to_jsonl()


def test_trace_spans_and_counts():
    tr = PORT.sim.ControlTrace()
    tr.emit(3, "slo_drop_start", tiles=["a"])
    tr.emit(9, "slo_drop_end", ticks=6)
    tr.emit(12, "slo_drop_start", tiles=["a"])
    tr.emit(15, "slo_drop_end", ticks=3)
    assert tr.spans("slo_drop_start", "slo_drop_end") == [(3, 9), (12, 15)]
    assert tr.counts() == {"slo_drop_start": 2, "slo_drop_end": 2}
    assert tr.events()[0].subject == "a"


def test_full_level_traces_control_and_fault_events():
    """A PID + fault run at level=full leaves the reference's story: the
    run_start/run_end bracket, DFS commits, the kill/revive pair — with
    monotonic ticks and registered kinds throughout, JSONL for JSONL."""
    eng, _ = seq_run(PORT, "pid", True)
    tr = eng.observer.trace
    kinds = tr.counts()
    assert kinds.get("run_start") == 1 and kinds.get("run_end") == 1
    assert kinds.get("dfs_commit", 0) > 0
    assert kinds.get("fault_kill") == 1 and kinds.get("fault_revive") == 1
    ticks = [e.tick for e in tr.events()]
    assert ticks == sorted(ticks)
    assert all(e.kind in PORT.sim.TRACE_KINDS for e in tr.events())
    kill = tr.events("fault_kill")[0]
    assert eng.platform.names[2] in kill.subject
    assert len(PORT.sim.ControlTrace.from_jsonl(tr.to_jsonl())) == len(tr)
    ref, _ = seq_run(REF, "pid", True)
    assert tr.to_jsonl() == ref.observer.trace.to_jsonl()


def _scenario(pkg, scen, observe="full"):
    """A four-tile run at 1.2x capacity (queues stand) with a balancer over
    the first pair and telemetry every 7 ticks, plus:
    ``detect`` — a kill of a balanced replica, a degraded link and a stuck
    island, a 4 ms deadline, the online supervisor; ``pid`` — the same with
    PID + guard; ``clamp`` — membound DFS under the 45 nm node, whose legal
    range clamps the low rate; ``slo`` — PID + a deadline alone."""
    plat = make_platform(pkg, 4, k=2)
    cap = pkg.sim.SimEngine(plat, **on_cpu(pkg, {})).capacity_rps()
    tr = pkg.sim.constant_trace(cap * 1.2, T, 4, dt=DT)
    faults = (pkg.sim.FaultSchedule()
              .kill_tile(plat.names[1], start=100, end=200)
              .degrade_link((1, 1), (1, 2), 0.4, start=50)
              .stick_island(plat.names[3], start=30, end=150, rate=0.4))
    rt = port_rt if pkg is PORT else ref_rt
    kw = dict(balancer=pkg.sim.LoadBalancer([plat.names[:2]], plat.names))
    if scen in ("detect", "pid"):
        kw.update(faults=faults, supervisor=rt.SimFaultSupervisor(),
                  slo=pkg.sim.SLOConfig(deadline_s=0.004))
    if scen == "slo":
        kw["slo"] = pkg.sim.SLOConfig(deadline_s=0.004)
    if scen in ("pid", "slo"):
        kw["controller"] = pkg.sim.ControllerHarness(
            plat.islands, pkg.dfs.PIDRatePolicy(target=0.7),
            queue_guard_ticks=3.0)
    if scen == "clamp":
        tr = pkg.sim.constant_trace(cap * 0.3, T, 4, dt=DT)
        kw.update(tech=45, controller=pkg.sim.ControllerHarness(
            plat.islands, partial(pkg.dfs.policy_memory_bound,
                                  threshold=0.0, low_rate=0.05),
            queue_guard_ticks=3.0))
    cfg = pkg.sim.SimConfig(telemetry_interval=7, control_interval=10)
    eng = pkg.sim.SimEngine(plat, config=cfg, observe=observe, **kw,
                            **on_cpu(pkg, {}))
    return eng, eng.run(tr)


SCENARIO_KINDS = {
    "detect": {"lb_split", "slo_drop_start", "slo_drop_end", "fault_kill",
               "fault_revive", "fault_link_degrade", "fault_stuck",
               "fault_unstuck", "detected_dead", "detected_alive"},
    "pid": {"dfs_guard", "detected_dead", "slo_drop_start"},
    "clamp": {"dfs_clamp", "dfs_commit"},
    "slo": {"slo_drop_start", "slo_drop_end", "dfs_guard"},
}


@pytest.mark.parametrize("scen", sorted(SCENARIO_KINDS))
def test_full_trace_equals_reference_event_for_event(scen):
    """Every kind the sequential loop can emit — the ones the port learns
    on the device (SLO spans, split weights, detections) rebuilt after the
    loop — in the reference's order within a tick and across ticks; the
    counters array-equal and the outputs unperturbed."""
    eng, res = _scenario(PORT, scen)
    ref, _ = _scenario(REF, scen)
    counts = eng.observer.trace.counts()
    assert SCENARIO_KINDS[scen] <= set(counts), counts
    assert eng.observer.trace.to_jsonl() == ref.observer.trace.to_jsonl()
    assert_planes_equal(eng.observer.counters, ref.observer.counters)
    _, blind = _scenario(PORT, scen, observe=None)
    assert_results_equal(res, blind, fields=(
        "p99_latency_s", "energy_j", "completed", "dropped_slo",
        "dropped_fault", "retried"))


@pytest.mark.parametrize("case", ["pid-faults", "membound-chain-lb"])
def test_batched_plane_and_trace_equal_reference(case):
    """Three designs on the float64 ``"torch"`` loop against the
    reference's ``"numpy"`` backend: the plane array for array, the trace
    event for event (the backend's name aside).  The chained case runs a
    balancer per stage and a degraded link with membound DFS."""
    out = {}
    for pkg, backend in ((REF, "numpy"), (PORT, "torch")):
        plat = make_platform(pkg, 4, k=2)
        ks = (2, 4, 8)
        if case == "membound-chain-lb":
            names = tuple(f"dfmul{i}" for i in range(4))
            flows = pkg.sim.FlowPattern.chain(names[:2], names[2:],
                                              demand={names[0]: 0.3})
            plats = []
            for k in ks:
                m = pkg.pm.SoCPerfModel()
                pos = [(r, c) for r in range(4) for c in range(4)
                       if (r, c) not in {(1, 0), (0, 0), (0, 3)}][:4]
                wls = [pkg.pm.AccelWorkload("dfmul", 8.70, 1.1,
                                            replication=k) for _ in pos]
                plats.append(pkg.sim.SimPlatform.build(
                    m, wls, pos, n_tg=2, req_mb=0.005, flows=flows))
            bplat = pkg.sim.BatchSimPlatform.stack(plats)
            kw = dict(balancer=pkg.sim.LoadBalancer(
                (names[:2], names[2:]), names),
                faults=pkg.sim.FaultSchedule().degrade_link(
                    (1, 1), (1, 2), 0.5, start=40, end=220),
                **bat_kwargs(pkg, bplat, "membound"))
        else:
            bplat = pkg.sim.BatchSimPlatform.stack([plat] * 3)
            kw = dict(**bat_kwargs(pkg, bplat, "pid"),
                      **fault_kwargs(pkg, plat, True))
        cap = pkg.sim.SimEngine(plat, **on_cpu(pkg, {})).capacity_rps()
        tr = pkg.sim.constant_trace(cap * 0.9, T, 4, dt=DT)
        eng = pkg.sim.BatchSimEngine(
            bplat, config=pkg.sim.SimConfig(control_interval=25),
            backend=backend, observe="full", **kw, **on_cpu(pkg, {}))
        eng.run(tr)
        out[pkg.name] = eng.observer
    ref, port = out["repro"], out["repro_torch"]
    assert_planes_equal(port.counters, ref.counters)
    assert port.trace.to_jsonl() == ref.trace.to_jsonl().replace(
        "batch-numpy", "batch-torch")
    assert port.trace.counts().get("dfs_commit", 0) > 0


def test_finalize_carries_its_sums_across_chunks(monkeypatch):
    """The plane is rebuilt in chunks of ticks; with chunks of one to a few
    ticks (every segment split, sums and the backlog carried across) the
    plane is still the reference's, array for array."""
    ref, _ = seq_run(REF, "pid", True, observe="counters")
    for elems in (6, 6 * 7, 6 * 48 * 5):
        monkeypatch.setattr(port_observe, "FINALIZE_CHUNK_ELEMS", elems)
        eng, _ = seq_run(PORT, "pid", True, observe="counters")
        assert_planes_equal(eng.observer.counters, ref.observer.counters)
    bref, _ = bat_run(REF, "numpy", 3, "membound", True)
    monkeypatch.setattr(port_observe, "FINALIZE_CHUNK_ELEMS", 3 * 48 * 2)
    bat, _ = bat_run(PORT, "torch", 3, "membound", True)
    assert_planes_equal(bat.observer.counters, bref.observer.counters)


def test_counters_level_skips_tracing():
    eng, _ = seq_run(PORT, "pid", observe="counters")
    assert len(eng.observer.trace) == 0
    assert eng.observer.counters is not None


def test_fused_refuses_observe_in_the_reference_words():
    """The kernel backend records no observer plane, as the reference's
    Pallas backend does not: at construction, and when an observer is set
    before a run; ``"off"`` and a disabled observer are accepted."""
    bplat = PORT.sim.BatchSimPlatform.stack([make_platform(PORT)])
    text = "fused backend records no observer plane; use backend='torch'"
    with pytest.raises(NotImplementedError) as err:
        PORT.sim.BatchSimEngine(bplat, backend="fused", observe="counters",
                                device="cpu")
    assert str(err.value) == text
    eng = PORT.sim.BatchSimEngine(bplat, backend="fused", device="cpu")
    eng.observer = PORT.sim.Observer("full")
    with pytest.raises(NotImplementedError, match="records no observer"):
        eng.run(trace_(PORT))
    assert eng.last_histories is None
    for off in ("off", PORT.sim.Observer("off")):
        PORT.sim.BatchSimEngine(bplat, backend="fused", observe=off,
                                device="cpu")
    with pytest.raises(NotImplementedError,
                       match="pallas backend records no observer plane"):
        REF.sim.BatchSimEngine(REF.sim.BatchSimPlatform.stack(
            [make_platform(REF)]), backend="pallas",
            observe="counters").run(trace_(REF))


# -------------------------------------------------------- observer facade
def test_observer_coercion_and_level_knob():
    Observer = PORT.sim.Observer
    assert Observer.coerce(None) is None
    assert Observer.coerce("off") is None
    ob = Observer.coerce("counters")
    assert ob.enabled and not ob.tracing
    assert Observer.coerce("full").tracing
    assert Observer.coerce(ob) is ob
    with pytest.raises(ValueError, match="level"):
        Observer(level="verbose")
    with pytest.raises(TypeError):
        Observer.coerce(3)
    assert PORT.sim.LEVELS == REF.sim.LEVELS == ("off", "counters", "full")


def test_observer_reuse_across_runs_resets_trace():
    """One observer driven through two runs: begin_run() resets the
    monotonic-tick guard and each run's counters replace the last (second
    run == fresh-observer run, not an accumulation)."""
    plat = make_platform(PORT)
    ob = PORT.sim.Observer("full")
    eng = PORT.sim.SimEngine(plat, observe=ob, device="cpu")
    eng.run(trace_(PORT))
    first = ob.counters.snapshot()
    eng.run(trace_(PORT))                # would raise if the guard leaked
    again = ob.counters
    assert ob.trace.counts().get("run_start") == 1
    assert float(again.ticks) == T
    fresh = PORT.sim.SimEngine(plat, observe="counters", device="cpu")
    fresh.run(trace_(PORT))
    assert again.allclose(fresh.observer.counters)
    np.testing.assert_array_equal(first["tile"]["invocations"],
                                  again.tile["invocations"])


def test_lazy_counters_materialize_on_first_read():
    prof = PORT.sim.Profiler()
    ob = PORT.sim.Observer("counters", profiler=prof)
    eng = PORT.sim.SimEngine(make_platform(PORT), observe=ob, device="cpu")
    eng.run(trace_(PORT))
    assert ob._counters is None and ob._counters_thunk is not None
    assert "counters_finalize" not in prof.phases
    cp = ob.counters
    assert isinstance(cp, PORT.sim.CounterPlane)
    assert prof.phases["counters_finalize"][1] == 1
    assert ob.counters is cp            # second read: cached, not re-built
    assert prof.phases["counters_finalize"][1] == 1


# -------------------------------------------------------------- profiling
def test_profiler_phases_accumulate():
    prof = PORT.sim.Profiler()
    with PORT.sim.profiled("phase_a", prof):
        pass
    with PORT.sim.profiled("phase_a", prof):
        pass
    with PORT.sim.profiled("phase_b", prof, device="cpu"):
        pass
    s = prof.summary()
    assert s["phase_a"]["count"] == 2
    assert s["phase_b"]["count"] == 1
    assert s["phase_a"]["total_s"] >= 0.0
    prof.reset()
    assert prof.summary() == {}


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_sweep_chunks_are_profiled(backend):
    """The chunked sweep books one ``sweep_chunk`` phase per block to the
    global profiler, as the reference's does (on the card a CUDA event
    pair times each block's evaluation)."""
    PORT.sim.reset_profiler()
    m = PORT.pm.SoCPerfModel()
    wls = [PORT.pm.AccelWorkload("dfmul", 8.70, 1.1),
           PORT.pm.AccelWorkload("dfadd", 7.5, 1.0)]
    res = PORT.dse.grid_sweep(m, wls, ks=(1, 2, 4), acc_rates=(0.5, 1.0),
                              noc_rates=(0.5, 1.0), tg_rates=(1.0,),
                              positions=((1, 1), (2, 2), (3, 3)), n_tg=2,
                              chunk_points=16, backend=backend,
                              device="cpu")
    s = PORT.sim.get_profiler().summary()
    assert res.n_chunks > 1
    assert s["sweep_chunk"]["count"] == res.n_chunks
    PORT.sim.reset_profiler()


# -------------------------------------------------------- counter scoping
def _scoped(pkg):
    cp = pkg.sim.CounterPlane(3, 2, 2, tile_names=("a", "b", "c"))
    for k in cp.tile:
        cp.tile[k][:] = 7.0
    cp.link["flits"][:] = 5.0
    cp.island["energy_j"][:] = 2.0
    cp.ticks = np.asarray(9.0)
    return cp


def test_counterplane_reset_scopes_like_manual_reset():
    cp = _scoped(PORT)
    cp.reset(kinds=["busy_ticks"], tiles=["b", 2])
    assert list(cp.tile["busy_ticks"]) == [7.0, 0.0, 0.0]
    assert (cp.tile["invocations"] == 7.0).all()    # untouched kind
    cp.reset(kinds=["flits"])
    assert (cp.link["flits"] == 0.0).all()
    assert (cp.island["energy_j"] == 2.0).all()
    ref = _scoped(REF)
    ref.reset(kinds=["busy_ticks"], tiles=["b", 2])
    ref.reset(kinds=["flits"])
    assert_planes_equal(cp, ref)
    with pytest.raises(ValueError, match="unknown counter kinds"):
        cp.reset(kinds=["made_up"])
    cp.reset()
    assert float(cp.ticks) == 0.0
    assert all((v == 0.0).all() for v in cp.tile.values())


# --------------------------------------------------------- metrics export
def _registry(pkg):
    reg = pkg.sim.MetricsRegistry()
    reg.counter("x_total", "adds", labels={"t": "a"}, value=2.0)
    reg.counter("x_total", labels={"t": "a"}, value=3.0)
    reg.gauge("g", "sets", value=1.5)
    reg.gauge("g", value=2.5)
    reg.histogram("h_seconds", "obs", value=0.003)
    reg.histogram("h_seconds", "obs", value=4.2)
    return reg


def test_metrics_registry_semantics_and_prometheus_roundtrip():
    reg = _registry(PORT)
    assert reg.get("x_total", {"t": "a"}) == 5.0    # counter accumulates
    assert reg.get("g") == 2.5                      # gauge overwrites
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total")
    parsed = PORT.sim.parse_prometheus_text(reg.render_prometheus())
    assert set(parsed) == {"x_total", "g", "h_seconds"}
    assert parsed["x_total"]["type"] == "counter"
    assert parsed["x_total"]["samples"] == [({"t": "a"}, 5.0)]
    assert parsed["g"]["samples"] == [({}, 2.5)]
    hist = parsed["h_seconds"]
    assert hist["type"] == "histogram"
    counts = [v for lb, v in hist["samples"]
              if lb.get("__sample__") == "count"]
    sums = [v for lb, v in hist["samples"] if lb.get("__sample__") == "sum"]
    assert counts == [2] and sums == [pytest.approx(4.203)]
    ref = _registry(REF)
    assert reg.render_prometheus() == ref.render_prometheus()
    assert reg.to_json() == ref.to_json()


def test_export_metrics_roundtrips_engine_counters():
    eng, res = seq_run(PORT, "pid")
    ob = eng.observer
    reg = PORT.sim.export_metrics(counters=ob.counters, trace=ob.trace,
                                  telemetry=res.telemetry)
    text = reg.render_prometheus()
    parsed = PORT.sim.parse_prometheus_text(text)
    assert set(parsed) == set(reg.names()) and parsed
    # a per-tile counter round-trips to the exact engine-side value
    name = eng.platform.names[0]
    served0 = float(eng.last_histories[1].numpy().sum(axis=0)[0])
    assert reg.get("sim_tile_invocations_total",
                   {"tile": name}) == pytest.approx(served0)
    got = [v for lb, v in parsed["sim_tile_invocations_total"]["samples"]
           if lb == {"tile": name}]
    assert got == [pytest.approx(served0)]
    kinds = {lb["kind"] for lb, _ in
             parsed["sim_trace_events_total"]["samples"]}
    assert {"run_start", "run_end"} <= kinds
    assert reg.get("sim_telemetry_tick") is not None
    # the whole export is the reference's, line for line
    rref, rres = seq_run(REF, "pid")
    ref = REF.sim.export_metrics(counters=rref.observer.counters,
                                 trace=rref.observer.trace,
                                 telemetry=rres.telemetry)
    assert text == ref.render_prometheus()


def test_telemetry_timeseries_matches_reference():
    _, res = seq_run(PORT, "pid")
    _, rres = seq_run(REF, "pid")
    doc = PORT.sim.telemetry_timeseries(res.telemetry)
    assert doc["kind"] == "telemetry_timeseries"
    assert doc == REF.sim.telemetry_timeseries(rres.telemetry)


# ------------------------------------------------- closed_loop_score hook
def _sweep(pkg):
    m = pkg.pm.SoCPerfModel()
    wls = [pkg.pm.AccelWorkload("dfmul", 8.70, 1.1),
           pkg.pm.AccelWorkload("fft2d", 145.0, 20.8)]
    res = pkg.dse.grid_sweep(m, wls, ks=(1, 2), acc_rates=(0.5, 1.0),
                             noc_rates=(1.0,), tg_rates=(1.0,),
                             positions=((1, 1), (3, 3)), n_tg=2,
                             **on_cpu(pkg, {}))
    return m, res


def test_closed_loop_score_observe_attaches_counters():
    """One summary per survivor on both paths, equal to the reference's
    (batched: each survivor's slice of the stacked plane; sequential: a
    shared Observer summarized per survivor); monitoring moves no score."""
    scores = {}
    for pkg in (REF, PORT):
        m, res = _sweep(pkg)
        trace = (lambda seed, pkg=pkg: pkg.sim.diurnal_trace(  # noqa: E731
            3000.0, 250, 2, dt=1e-3, seed=seed))
        base = pkg.dse.closed_loop_score(res, trace, model=m, top=2,
                                         **on_cpu(pkg, {}))
        assert base.counters is None
        for name, kwargs in (("batch", {}), ("seq", dict(batch=False)),
                             ("shared", dict(batch=False,
                                             observe=pkg.sim.Observer(
                                                 "counters")))):
            kwargs.setdefault("observe", "counters")
            sc = pkg.dse.closed_loop_score(res, trace, model=m, top=2,
                                           **on_cpu(pkg, kwargs))
            assert sc.counters is not None and len(sc.counters) == 2
            for s in sc.counters:
                assert s["ticks"] == 250
                assert s["invocations"] > 0 and s["energy_j"] > 0
            # monitoring must not move the ranking
            assert np.array_equal(sc.ranked_indices(),
                                  base.ranked_indices())
            assert np.array_equal(sc.p99_latency_s, base.p99_latency_s)
            scores[pkg.name, name] = sc.counters
    for name in ("batch", "seq", "shared"):
        assert scores["repro_torch", name] == scores["repro", name], name


# ------------------------------------------------- the card-side checks
def test_plane_check_rejects_planted_faults():
    """``chip_smoke.py`` holds the card's plane to the CPU's within
    ``PLANE_RTOL`` (stall counts exact); the check passes the CPU plane
    against itself and against the reference package's plane, and rejects
    each planted fault: one counter element off by 1e-9 relative, a stall
    tick more, a link peak off, an island's energy off."""
    cs = chip_smoke()
    eng, _ = seq_run(PORT, "pid", True, observe="counters")
    host = eng.observer.counters
    assert cs.plane_ok(cs.plane_gap(host, host))
    faults = cs.plane_planted_faults(host)
    assert len(faults) >= 4
    for label, bad in faults:
        assert not cs.plane_ok(cs.plane_gap(bad, host)), label
    ref, _ = seq_run(REF, "pid", True, observe="counters")
    assert cs.plane_ok(cs.plane_gap(ref.observer.counters, host))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the observed runs on the card are held "
                    "against the CPU there (chip_smoke.py runs this case on "
                    "the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["sequential", "faults", "batch64",
                                  "batch32"])
def test_cuda_observed_run_matches_cpu(case, cuda_device):
    """An observed run on the card: its outputs bit for bit the unobserved
    card run's, no host sync in an open-loop tick loop (sync-debug
    "error"), its plane within ``PLANE_RTOL`` of the same run's on the CPU
    (stall counts exact; float32 within the float32 tolerance) and its
    trace the CPU's JSONL.  The case runs in ``chip_smoke.py``
    (``card_observe``)."""
    chip_smoke().card_case("test_cuda_observed_run_matches_cpu", case)
