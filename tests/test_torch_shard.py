"""Port vs reference: ``devices=`` on the paper's main path (sweep ->
re-rank -> batched co-sim), ``repro_torch.shard``.

The shard count is forced in-process with ``REPRO_TORCH_FORCE_DEVICE_COUNT``
(``monkeypatch.setenv``): N shards then run on the CPU one after another.
Tolerances:

* ``grid_sweep``, ``BatchSimEngine`` and ``closed_loop_score`` with
  ``devices=N`` against the same call with ``devices=None`` (the port's
  unsharded ground truth) for N = 1-4, with a point count and a design
  count that do not split evenly (padding): **bit-equal** — objectives,
  Pareto sets, top-k, every result array, the controller's evolved state,
  the telemetry rings and events, the counter plane and the trace;
* ``devices=4`` against the reference's ``devices=None`` ground truth
  (NumPy float64): index sets, top-k and ranking order **exact**, floats
  within 1e-12 relative (they come out equal on CPU tensors).

The helpers equal ``repro.shard``'s (``tests/test_shard_pallas.py``).
"""
import numpy as np
import pytest
import torch

import repro.shard as ref_shard
import repro_torch.shard as shard
from repro.configs.vespa_soc import CHSTONE

from _torch_port_helpers import PORT, REF, rel_err

FORCE = shard.FORCE_ENV
SHARDS = (1, 2, 3, 4)
NAMES6 = ("a0", "a1", "a2", "b0", "b1", "b2")
SWEEP_KW = dict(ks=(1, 2, 4), acc_rates=(0.2, 0.6, 1.0),
                noc_rates=(0.1, 0.5, 1.0), tg_rates=(0.5, 1.0), n_tg=2,
                island_rates="independent")


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setenv(FORCE, "4")
    assert shard.device_count() == 4


def _wls(pkg):
    return (pkg.pm.AccelWorkload("gsm", 4.61, 12.0),
            pkg.pm.AccelWorkload("dfmul", 8.70, 1.1))


# ------------------------------------------------------------- helpers
def test_shard_helpers_equal_the_reference(monkeypatch):
    monkeypatch.delenv(FORCE, raising=False)
    assert shard.resolve_devices(None) == ref_shard.resolve_devices(None)
    assert shard.resolve_devices("auto") == shard.device_count()
    assert shard.resolve_devices(64) <= shard.device_count()
    for bad in (0, -2):
        for mod in (shard, ref_shard):
            with pytest.raises(AssertionError):
                mod.resolve_devices(bad)
    for n, d in ((5, 4), (8, 4), (1, 3), (0, 2), (7, 1)):
        assert shard.shard_len(n, d) == ref_shard.shard_len(n, d)
    a = np.arange(12, dtype=np.float64).reshape(3, 4)
    for d, axis in ((4, 0), (3, 0), (3, 1), (2, 1)):
        want = ref_shard.pad_axis(a, d, axis=axis)
        np.testing.assert_array_equal(shard.pad_axis(a, d, axis=axis), want)
        got = shard.pad_axis(torch.from_numpy(a), d, axis=axis)
        np.testing.assert_array_equal(got.numpy(), want)
    assert shard.pad_axis(a, 3, axis=0) is a


def test_forced_count_and_bounded_device_cache(monkeypatch):
    monkeypatch.setenv(FORCE, "64")
    assert shard.device_count() == 64
    assert shard.resolve_devices("auto") == 64
    assert shard.resolve_devices(5) == 5
    devs = shard.shard_devices(5, "cpu")
    assert devs == (torch.device("cpu"),) * 5
    for n in range(1, 65):
        shard.shard_devices(n, "cpu")
    assert shard.mesh_cache_size() <= shard._DEVICE_CACHE_MAX
    monkeypatch.setenv(FORCE, "0")
    with pytest.raises(ValueError, match=FORCE):
        shard.device_count()


# --------------------------------------------------------------- sweep
@pytest.mark.parametrize("tech", [None, (45, 32)])
@pytest.mark.parametrize("chunk", [None, 700])
def test_grid_sweep_shard_invariance(forced, chunk, tech):
    """grid_sweep(devices=N) == devices=None on the flat evaluator, dense
    and chunked (700 points: neither the grid nor a block splits evenly)."""
    model, wls = PORT.pm.SoCPerfModel(), _wls(PORT)
    kw = dict(SWEEP_KW, chunk_points=chunk, tech_node=tech, device="cpu")
    base = PORT.dse.grid_sweep(model, wls, backend="torch", **kw)
    for n in SHARDS:
        r = PORT.dse.grid_sweep(model, wls, devices=n, **kw)
        assert r.backend == "torch"
        if chunk is None:
            for f in ("throughput", "area", "energy_per_unit",
                      "mem_traffic", "valid"):
                assert np.array_equal(getattr(r, f), getattr(base, f)), f
            assert np.array_equal(r.front_candidates, base.front_candidates)
            assert np.array_equal(r.pareto_indices(), base.pareto_indices())
            assert np.array_equal(r.topk_indices(10), base.topk_indices(10))
        else:
            assert np.array_equal(r.pareto, base.pareto)
            assert np.array_equal(r.cand_indices, base.cand_indices)
            for o in base.topk:
                assert np.array_equal(r.topk[o], base.topk[o]), o
            for o, v in base.cand_values.items():
                assert np.array_equal(r.cand_values[o], v), o
            assert (r.n_valid, r.n_chunks, r.peak_chunk_bytes) == \
                (base.n_valid, base.n_chunks, base.peak_chunk_bytes)


@pytest.mark.parametrize("chunk", [None, 700])
def test_grid_sweep_four_shards_equal_the_reference(forced, chunk):
    """devices=4 against the reference's devices=None NumPy float64 sweep."""
    kw = dict(SWEEP_KW, chunk_points=chunk)
    ref = REF.dse.grid_sweep(REF.pm.SoCPerfModel(), _wls(REF), **kw)
    got = PORT.dse.grid_sweep(PORT.pm.SoCPerfModel(), _wls(PORT), devices=4,
                              device="cpu", **kw)
    if chunk is None:
        for f in ("throughput", "area", "energy_per_unit", "mem_traffic"):
            assert rel_err(getattr(got, f), getattr(ref, f)) <= 1e-12, f
        assert np.array_equal(got.valid, ref.valid)
        assert np.array_equal(got.pareto_indices(), ref.pareto_indices())
        for o in ("throughput", "energy_per_unit", "area"):
            assert np.array_equal(got.topk_indices(10, o),
                                  ref.topk_indices(10, o)), o
    else:
        assert np.array_equal(got.pareto, ref.pareto)
        for o in ref.topk:
            assert np.array_equal(got.topk[o], ref.topk[o]), o
        for o, v in ref.cand_values.items():
            assert rel_err(got.cand_values[o], v) <= 1e-12, o


def test_grid_sweep_rejects_a_bad_devices_knob():
    with pytest.raises(AssertionError):
        PORT.dse.grid_sweep(PORT.pm.SoCPerfModel(), _wls(PORT), devices=0,
                            device="cpu", **SWEEP_KW)


# -------------------------------------------------------------- co-sim
def _platform(pkg, k):
    m = pkg.pm.SoCPerfModel()
    pos = [(r, c) for r in range(4) for c in range(4)
           if (r, c) not in {(1, 0), (0, 0), (0, 3)}][:6]
    wls = [pkg.pm.AccelWorkload("dfmul", 8.70, 1.1, replication=k)
           for _ in pos]
    flows = pkg.sim.FlowPattern.chain(NAMES6[:3], NAMES6[3:])
    return pkg.sim.SimPlatform.build(m, wls, pos, names=NAMES6, n_tg=2,
                                     req_mb=0.005, flows=flows)


KS = (2, 4, 8, 8, 4)            # B = 5: pads at N = 2, 3 and 4


def _engine(pkg, *, backend="torch", policy="pid", faults=True,
            balancer=True, observe=None, dtype=None, devices=None,
            ticks=400, per_design=False):
    """A fresh five-design run: a two-stage chain, DFS in the loop, the
    balancer, tile kills, a degraded link, a stuck actuator and a deadline
    with re-spill (each optional)."""
    plats = [_platform(pkg, k) for k in KS]
    bplat = pkg.sim.BatchSimPlatform.stack(plats)
    cap = pkg.sim.SimEngine(plats[0], **({"device": "cpu"} if pkg is PORT
                                         else {})).capacity_rps()
    tr = pkg.sim.diurnal_trace(cap * 0.8, ticks, 6, dt=1e-3, depth=0.5,
                               seed=4)
    if per_design:
        rng = np.random.default_rng(7)
        tr = pkg.sim.BatchTrace(
            tr.arrivals[:, None, :] * rng.uniform(0.6, 1.2, (1, len(KS), 1)),
            tr.dt)
    pol = {"pid": lambda: pkg.dfs.BatchPIDRatePolicy(target=0.7),
           "ewma": lambda: pkg.dfs.BatchEWMAUtilizationPolicy(alpha=0.4),
           "membound": lambda: pkg.dfs.BatchMemoryBoundPolicy(threshold=0.5),
           "open": None}[policy]
    ctl = None if pol is None else pkg.sim.BatchControllerHarness(
        bplat.islands, bplat.rates, pol(), tile_names=bplat.names,
        queue_guard_ticks=3.0)
    kw = {}
    if faults:
        kw["faults"] = (pkg.sim.FaultSchedule()
                        .kill_tile("a1", start=100, end=250)
                        .kill_tile("b2", start=200)
                        .degrade_link((1, 1), (1, 2), 0.3, start=50, end=300)
                        .stick_island(bplat.islands.names()[0], start=30,
                                      end=150, rate=0.4))
        kw["slo"] = pkg.sim.SLOConfig(deadline_s=0.03, on_kill="respill",
                                      max_retries=1)
    if balancer:
        kw["balancer"] = pkg.sim.LoadBalancer((NAMES6[:3], NAMES6[3:]),
                                              bplat.names)
    if observe is not None:
        kw["observe"] = observe
    if pkg is PORT:
        kw.update(device="cpu", devices=devices)
        if dtype is not None:
            kw["dtype"] = dtype
    eng = pkg.sim.BatchSimEngine(
        bplat, config=pkg.sim.SimConfig(control_interval=20),
        controller=ctl, backend=backend if pkg is PORT else "numpy", **kw)
    return eng, eng.run(tr)


RESULT_FIELDS = ("completed", "dropped", "residual", "throughput_rps",
                 "p50_latency_s", "p99_latency_s", "energy_j",
                 "energy_per_request_j", "mean_power_w", "swaps",
                 "dropped_slo", "dropped_fault", "retried", "drop_rate")


def _t(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_runs_equal(ea, a, eb, b):
    """Two port runs, bit for bit: results, state, histories, controller,
    telemetry, counter plane and trace."""
    for f in RESULT_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(_t(x), _t(y), f)
    np.testing.assert_array_equal(np.asarray(a.offered),
                                  np.asarray(b.offered))
    for f in ("queue", "busy", "pkts_in", "pkts_out", "rtt_acc", "dropped",
              "energy", "retry_q", "dropped_slo", "dropped_fault",
              "retried"):
        x, y = getattr(ea.last_state, f), getattr(eb.last_state, f)
        np.testing.assert_array_equal(_t(x), _t(y), f)
    for x, y in zip(ea.last_histories, eb.last_histories):
        np.testing.assert_array_equal(_t(x), _t(y))
    fa, fb = ea.last_fault_histories, eb.last_fault_histories
    assert (fa is None) == (fb is None)
    if fa is not None:
        assert list(fa) == list(fb)
        for k in fa:
            np.testing.assert_array_equal(_t(fa[k]), _t(fb[k]), k)
    ca, cb = ea.controller, eb.controller
    assert (ca is None) == (cb is None)
    if ca is not None:
        for f in ("rates", "_guard_active", "swaps", "versions",
                  "last_clamped", "last_committed", "_prev_pkts_in",
                  "_prev_pkts_out", "_prev_rtt"):
            x, y = getattr(ca, f, None), getattr(cb, f, None)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y, f)
        for f in ("_integral", "_prev_err", "_ewma"):
            x, y = getattr(ca.policy, f, None), getattr(cb.policy, f, None)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y, f)
    assert (a.telemetry is None) == (b.telemetry is None)
    if a.telemetry is not None:
        assert a.telemetry.events == b.telemetry.events
        for ring in ("scalars", "island_rates", "queue_depth", "busy"):
            ra, rb = getattr(a.telemetry, ring), getattr(b.telemetry, ring)
            assert ra.total_appended == rb.total_appended
            np.testing.assert_array_equal(ra.array(), rb.array(), ring)
    oa, ob = ea.observer, eb.observer
    assert (oa is None) == (ob is None)
    if oa is not None:
        pa, pb = oa.counters, ob.counters
        assert pa.lead == pb.lead
        for group in ("tile", "link", "island"):
            for k, v in getattr(pa, group).items():
                np.testing.assert_array_equal(getattr(pb, group)[k], v, k)
        np.testing.assert_array_equal(pa.ticks, pb.ticks)
        assert oa.trace.to_jsonl() == ob.trace.to_jsonl()


COSIM_CASES = {
    "f64_full": dict(observe="full"),
    "f64_ewma_per_design": dict(policy="ewma", per_design=True,
                                observe="counters"),
    "f64_open_no_faults": dict(policy="open", faults=False),
    "f32_counters": dict(dtype=torch.float32, observe="counters"),
    "fused_pid": dict(backend="fused", faults=False, balancer=False),
    "fused_membound": dict(backend="fused", policy="membound", faults=False,
                           balancer=False, per_design=True),
}


@pytest.mark.parametrize("case", list(COSIM_CASES))
def test_batch_engine_shard_invariance(forced, case):
    """BatchSimEngine(devices=N) == devices=None for N = 1-4 at B = 5 on
    both backends (``"fused"`` through the kernel's plain version here),
    with the chain, the balancer, faults, an SLO and the observer."""
    kw = COSIM_CASES[case]
    ea, a = _engine(PORT, **kw)
    for n in SHARDS:
        eb, b = _engine(PORT, devices=n, **kw)
        _assert_runs_equal(ea, a, eb, b)


def test_batch_engine_four_shards_equal_the_reference(forced):
    """devices=4 against the reference's NumPy engine (its ground truth):
    the faults, SLO, balancer, chain and PID case, observed."""
    ep, p = _engine(PORT, devices=4, observe="full")
    er, r = _engine(REF, observe="full")
    for f in RESULT_FIELDS:
        assert rel_err(getattr(p, f), getattr(r, f)) <= 1e-12, f
    np.testing.assert_array_equal(p.swaps, r.swaps)
    np.testing.assert_array_equal(ep.controller.rates, er.controller.rates)
    assert p.telemetry.events == r.telemetry.events
    # the trace names its backend (ROADMAP queue C: a recorded difference)
    assert ep.observer.trace.to_jsonl().replace(
        '"batch-torch"', '"batch-numpy"') == er.observer.trace.to_jsonl()
    pc, rc = ep.observer.counters, er.observer.counters
    for group in ("tile", "link", "island"):
        for k, v in getattr(rc, group).items():
            assert rel_err(getattr(pc, group)[k], v) <= 1e-12, k


def test_batch_engine_rejects_a_bad_devices_knob():
    plat = PORT.sim.BatchSimPlatform.stack([_platform(PORT, 2)])
    with pytest.raises(AssertionError):
        PORT.sim.BatchSimEngine(plat, devices=0, device="cpu")


def test_each_shard_runs_its_own_rows_once(forced, monkeypatch):
    """Each shard runs its own loop once: N tick loops for N shards, and
    the design rows each one sees are its own, padded with design 0."""
    from repro_torch.sim.batch import BatchSimEngine
    seen = []
    orig = BatchSimEngine._ticks

    def ticks(engine, lp, trace):
        seen.append(engine.platform.k[:, 0].tolist())
        return orig(engine, lp, trace)

    monkeypatch.setattr(BatchSimEngine, "_ticks", ticks)
    _engine(PORT, devices=3, faults=False, balancer=False)
    assert seen == [[2.0, 4.0], [8.0, 8.0], [4.0, 2.0]]


# --------------------------------------------------- closed_loop_score
def _rerank(pkg, **extra):
    m = pkg.pm.SoCPerfModel()
    wls = [pkg.pm.AccelWorkload("dfadd", *CHSTONE["dfadd"]),
           pkg.pm.AccelWorkload("dfmul", *CHSTONE["dfmul"])]
    kw = {"device": "cpu"} if pkg is PORT else {}
    res = pkg.dse.grid_sweep(m, wls, ks=(1, 2, 4), acc_rates=(0.2, 0.6, 1.0),
                             noc_rates=(0.5, 1.0), n_tg=2, **kw)
    idx = res.topk_indices(7)
    tr = pkg.sim.diurnal_trace(2000.0, 250, 2, dt=1e-3, seed=5)
    ctl = (lambda p: pkg.sim.BatchControllerHarness(
        p.islands, p.rates, pkg.dfs.BatchPIDRatePolicy(target=0.7),
        tile_names=p.names, queue_guard_ticks=3.0))
    return pkg.dse.closed_loop_score(
        res, tr, model=m, indices=idx, req_mb=0.002,
        sim_config=pkg.sim.SimConfig(control_interval=25),
        batch_controller_factory=ctl, **kw, **extra)


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_closed_loop_score_forwards_devices(forced, backend):
    """closed_loop_score(devices=N) == devices=None bitwise (seven
    survivors: pads at N = 2, 3 and 4), and devices=4 ranks as the
    reference does."""
    base = _rerank(PORT, backend=backend)
    for n in SHARDS:
        s = _rerank(PORT, backend=backend, devices=n)
        np.testing.assert_array_equal(s.indices, base.indices)
        np.testing.assert_array_equal(s.ranked_indices(),
                                      base.ranked_indices())
        for f in ("p99_latency_s", "energy_per_request_j", "throughput_rps"):
            np.testing.assert_array_equal(getattr(s, f), getattr(base, f))
        np.testing.assert_array_equal(s.results[0].swaps,
                                      base.results[0].swaps)
    if backend == "torch":
        ref = _rerank(REF)
        got = _rerank(PORT, devices=4)
        np.testing.assert_array_equal(got.ranked_indices(),
                                      ref.ranked_indices())
        assert rel_err(got.energy_per_request_j,
                       ref.energy_per_request_j) <= 1e-12
        np.testing.assert_array_equal(got.p99_latency_s, ref.p99_latency_s)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the sharded tick kernel runs on the "
                    "card (chip_smoke.py runs this case there)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["pid", "membound"])
def test_cuda_fused_devices_match_unsharded(policy, cuda_device):
    """On the card, ``"fused"`` with ``devices=4`` (forced count 4 on one
    card: four launches of the tick kernel) equals the unsharded launch bit
    for bit at a ragged B.  The case runs in ``chip_smoke.py``
    (``card_shard_fused``)."""
    from _torch_port_helpers import chip_smoke
    chip_smoke().card_case("test_cuda_fused_devices_match_unsharded", policy)
