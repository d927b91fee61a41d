"""Port vs reference: the batched co-simulation engine.

* ``backend="torch"`` (float64 tick loop, CPU tensors here) vs the reference
  ``backend="numpy"``: ``completed / energy_j / residual / dropped / p50 /
  p99 / throughput_rps`` within 1e-12 relative.  On CPU tensors every one of
  them comes out **bit-equal** (``completed`` too, chained or not: the
  port adds the served history in NumPy's order there; on the card the
  sum over ticks adds in parallel).  The tests assert the
  tolerance, and exact equality for ``swaps`` and the final controller
  state.
* ``backend="fused"`` (float32; the kernel's plain version on the CPU) vs
  the reference ``"numpy"``: rtol 2e-3 / atol 1e-2, ``swaps`` exact — the
  bar the reference sets for its own fused kernel.
* ``backend="torch", dtype=torch.float32`` (the role of the reference's
  float32 scan backend) vs the reference ``"numpy"``: rtol 2e-3 / atol 1e-2,
  ``swaps`` exact; no telemetry.  The float64 loop's telemetry is held to
  the reference's recording in ``tests/test_torch_telemetry.py``.
* knobs that are not ported raise ``NotImplementedError``; the load
  balancer runs on ``"torch"`` (held to the reference) and ``"fused"``
  refuses it in the reference's words.
* the batched latency-percentile reconstruction equals the per-design
  reference function exactly (ties, fractional and zero weights, T = 1,
  designs with no completion), on float64 and float32 histories.
"""
import numpy as np
import pytest
import torch

from repro.sim.engine import latency_percentiles as ref_percentiles
from repro.sim.telemetry import weighted_percentiles as ref_wp
from repro_torch.sim.engine import (latency_percentiles,
                                    latency_percentiles_batch,
                                    weighted_percentiles)

from _torch_port_helpers import (PORT, REF, capacity, chain_flows,
                                 chip_smoke, make_engine, make_platform,
                                 make_trace, rel_err)

F64_FIELDS = ("completed", "energy_j", "residual", "dropped",
              "p50_latency_s", "p99_latency_s", "throughput_rps",
              "energy_per_request_j", "mean_power_w")
CONTROLLERS = ("open", "membound", "pid", "ewma")
TRACES = ("constant", "poisson", "diurnal", "mmpp")


def _run(pkg, backend, policy, kind, **kw):
    eng = make_engine(pkg, backend, policy, **kw)
    cap = capacity(4, k=2)
    return eng, eng.run(make_trace(pkg, kind, cap, ticks=300))


def _controller_state_equal(c0, c1):
    np.testing.assert_array_equal(c1.rates, c0.rates)
    np.testing.assert_array_equal(c1._guard_active, c0._guard_active)
    np.testing.assert_array_equal(c1.swaps, c0.swaps)
    np.testing.assert_array_equal(c1.versions, c0.versions)
    np.testing.assert_array_equal(c1.last_clamped, c0.last_clamped)
    for attr in ("_integral", "_prev_err", "_ewma"):
        if hasattr(c0.policy, attr):
            np.testing.assert_array_equal(getattr(c1.policy, attr),
                                          getattr(c0.policy, attr))


# --------------------------------------------------- "torch" vs "numpy"
@pytest.mark.parametrize("kind", TRACES)
@pytest.mark.parametrize("policy", CONTROLLERS)
def test_torch_backend_matches_numpy_reference(policy, kind):
    e0, r0 = _run(REF, "numpy", policy, kind)
    e1, r1 = _run(PORT, "torch", policy, kind)
    for f in F64_FIELDS:
        assert rel_err(getattr(r1, f), getattr(r0, f)) <= 1e-12, f
    np.testing.assert_array_equal(r1.swaps, r0.swaps)
    assert r1.offered == r0.offered and r1.backend == "torch"
    # the float64 loop records the reference's telemetry, array for array
    for ring in ("scalars", "island_rates", "queue_depth", "busy"):
        np.testing.assert_array_equal(getattr(r1.telemetry, ring).array(),
                                      getattr(r0.telemetry, ring).array())
    assert r1.telemetry.scalars.total_appended == \
        r0.telemetry.scalars.total_appended
    assert r1.telemetry.events == r0.telemetry.events
    if policy != "open":
        _controller_state_equal(e0.controller, e1.controller)
    for i in range(2):
        assert rel_err(e1.last_histories[i].numpy(),
                       e0.last_histories[i]) <= 1e-12
    for f in ("queue", "busy", "pkts_in", "pkts_out", "rtt_acc"):
        assert rel_err(getattr(e1.last_state, f).numpy(),
                       getattr(e0.last_state, f)) <= 1e-12, f


@pytest.mark.parametrize("policy", ["guard", "pid"])
@pytest.mark.parametrize("opts", [
    dict(tech=45), dict(tech=(16, "cons"), max_queue=3.0),
    dict(chain=True), dict(chain=True, max_queue=3.0, tech=45)],
    ids=["tech45", "tech16cons-maxq", "chain", "chain-maxq-tech45"])
def test_torch_backend_options(policy, opts):
    e0, r0 = _run(REF, "numpy", policy, "mmpp", **opts)
    e1, r1 = _run(PORT, "torch", policy, "mmpp", **opts)
    for f in F64_FIELDS:
        assert rel_err(getattr(r1, f), getattr(r0, f)) <= 1e-12, f
    np.testing.assert_array_equal(r1.swaps, r0.swaps)
    _controller_state_equal(e0.controller, e1.controller)


def test_torch_backend_per_design_trace():
    cap = capacity(4, k=2)
    scale = np.asarray([0.5, 1.0, 1.6])
    res = {}
    for pkg, backend in ((REF, "numpy"), (PORT, "torch")):
        tr = pkg.sim.BatchTrace.broadcast(
            make_trace(pkg, "diurnal", cap, ticks=200), 3).scaled(scale)
        res[pkg.name] = make_engine(pkg, backend, "membound").run(tr)
    r0, r1 = res["repro"], res["repro_torch"]
    for f in F64_FIELDS:
        assert rel_err(getattr(r1, f), getattr(r0, f)) <= 1e-12, f
    np.testing.assert_array_equal(r1.offered, r0.offered)
    np.testing.assert_array_equal(r1.drop_rate, r0.drop_rate)


def test_capacity_and_platform_design_equal():
    e0 = make_engine(REF, "numpy", "open")
    e1 = make_engine(PORT, "torch", "open")
    assert np.array_equal(e0.capacity_rps(), e1.capacity_rps())
    d0, d1 = e0.platform.design(1), e1.platform.design(1)
    for f in ("base_mbps", "wire_share", "k", "pos_idx", "req_mb"):
        assert np.array_equal(getattr(d0, f), getattr(d1, f))
    assert d0.islands.names() == d1.islands.names()
    assert [i.rate for i in d0.islands.islands] == \
        [i.rate for i in d1.islands.islands]


# --------------------------------------------------- "fused" vs "numpy"
@pytest.mark.parametrize("policy", ["open", "guard", "membound", "pid",
                                    "ewma"])
def test_fused_backend_matches_numpy_reference(policy):
    """float32 against the float64 ground truth: rtol 2e-3 / atol 1e-2."""
    _, r0 = _run(REF, "numpy", policy, "diurnal")
    _, r1 = _run(PORT, "fused", policy, "diurnal")
    for f in ("completed", "energy_j", "p99_latency_s", "throughput_rps",
              "residual"):
        np.testing.assert_allclose(getattr(r1, f), getattr(r0, f),
                                   rtol=2e-3, atol=1e-2, err_msg=f)
    np.testing.assert_array_equal(r1.swaps, r0.swaps)
    assert r1.backend == "fused"


@pytest.mark.parametrize("policy", ["membound", "pid"])
def test_fused_backend_matches_torch_backend_of_the_port(policy):
    _, r0 = _run(PORT, "torch", policy, "mmpp", tech=45, chain=True)
    _, r1 = _run(PORT, "fused", policy, "mmpp", tech=45, chain=True)
    for f in ("completed", "energy_j", "p99_latency_s", "residual"):
        np.testing.assert_allclose(getattr(r1, f), getattr(r0, f),
                                   rtol=2e-3, atol=1e-2, err_msg=f)
    np.testing.assert_array_equal(r1.swaps, r0.swaps)


# ------------------------------------------- float32 "torch" vs "numpy"
@pytest.mark.parametrize("kind", ["diurnal", "mmpp"])
@pytest.mark.parametrize("policy", ["open", "guard", "membound", "pid",
                                    "ewma"])
def test_float32_torch_matches_numpy_reference(policy, kind):
    """float32 against the float64 ground truth at the reference scan
    backend's tolerances: rtol 2e-3 / atol 1e-2, swaps exact."""
    _, r0 = _run(REF, "numpy", policy, kind)
    e1, r1 = _run(PORT, "torch", policy, kind, dtype=torch.float32)
    for f in ("completed", "energy_j", "p99_latency_s", "p50_latency_s",
              "throughput_rps", "residual", "energy_per_request_j"):
        np.testing.assert_allclose(getattr(r1, f), getattr(r0, f),
                                   rtol=2e-3, atol=1e-2, err_msg=f)
    np.testing.assert_array_equal(r1.swaps, r0.swaps)
    assert r1.backend == "torch" and r1.telemetry is None
    assert e1.last_histories[0].dtype == torch.float32
    assert e1.last_state.energy.dtype == torch.float32


@pytest.mark.parametrize("opts", [dict(tech=45, chain=True),
                                  dict(max_queue=3.0)],
                         ids=["tech45-chain", "maxq"])
def test_float32_torch_matches_fused(opts):
    """The two float32 programs of the port agree (rtol 2e-3 / atol 1e-2,
    swaps exact)."""
    _, r0 = _run(PORT, "fused", "pid", "mmpp", **opts)
    _, r1 = _run(PORT, "torch", "pid", "mmpp", dtype=torch.float32, **opts)
    for f in ("completed", "energy_j", "p99_latency_s", "residual"):
        np.testing.assert_allclose(getattr(r1, f), getattr(r0, f),
                                   rtol=2e-3, atol=1e-2, err_msg=f)
    np.testing.assert_array_equal(r1.swaps, r0.swaps)


def test_closed_loop_score_float32():
    """``closed_loop_score(dtype=torch.float32)`` ranks the reference's
    survivors as the reference does."""
    kw = dict(ks=(1, 2), acc_rates=(0.2, 0.6, 1.0), noc_rates=(0.5, 1.0),
              tg_rates=(1.0,), positions=((1, 1), (3, 3), (0, 2)), n_tg=4)
    from repro.configs.vespa_soc import CHSTONE
    scores = {}
    for pkg in (REF, PORT):
        m = pkg.pm.SoCPerfModel()
        wls = [pkg.pm.AccelWorkload(n, *CHSTONE[n]) for n in ("dfsin", "gsm")]
        extra = ({"device": "cpu"} if pkg is PORT else {})
        res = pkg.dse.grid_sweep(m, wls, **kw, **extra)
        tr = pkg.sim.diurnal_trace(5000.0, 400, 2, dt=1e-3, seed=1)
        scores[pkg.name] = pkg.dse.closed_loop_score(
            res, tr, model=m, top=6,
            **({"dtype": torch.float32, "backend": "torch"}
               if pkg is PORT else {}), **extra)
    a, b = scores["repro_torch"], scores["repro"]
    assert np.array_equal(a.ranked_indices(), b.ranked_indices())
    np.testing.assert_allclose(a.energy_per_request_j,
                               b.energy_per_request_j, rtol=2e-3, atol=1e-2)
    assert a.results[0].telemetry is None


def test_bad_dtype_refused():
    plat = PORT.sim.BatchSimPlatform.stack([make_platform(PORT, 4)])
    with pytest.raises(ValueError, match="dtype"):
        PORT.sim.BatchSimEngine(plat, device="cpu", dtype=torch.float16)


# ------------------------------------------------------------- refusals
REFUSED = [("faults", "fault"), ("slo", "SLO"), ("balancer", "balancer"),
           ("observe", "observer")]


def _balanced_chain_runs():
    """A chained 4-tile stack of three designs with a load balancer over
    each stage, PID in the loop: reference ``"numpy"`` and port
    ``"torch"``."""
    out = []
    for pkg, backend in ((REF, "numpy"), (PORT, "torch")):
        eng = make_engine(pkg, backend, "pid", chain=True)
        eng.balancer = pkg.sim.LoadBalancer(
            (("dfmul0", "dfmul1"), ("dfmul2", "dfmul3")),
            eng.platform.names)
        out.append(eng.run(make_trace(pkg, "mmpp", capacity(4, k=2),
                                      ticks=300)))
    return out


def _faulted_runs(knob):
    """Three designs, PID in the loop, ``knob`` set — a replica kill behind
    a balancer and a degraded link (``faults``) or a deadline (``slo``) —
    reference ``"numpy"`` and port ``"torch"``, under a trace at 1.2x
    the first design's capacity so its queues stand."""
    out = []
    for pkg, backend in ((REF, "numpy"), (PORT, "torch")):
        eng = make_engine(pkg, backend, "pid")
        names = eng.platform.names
        if knob == "faults":
            eng.faults = (pkg.sim.FaultSchedule()
                          .kill_tile(names[0], start=80, end=200)
                          .degrade_link((1, 1), (1, 2), 0.4, start=50))
            eng.balancer = pkg.sim.LoadBalancer([names[:2]], names)
        else:
            eng.slo = pkg.sim.SLOConfig(deadline_s=0.004)
        out.append((eng, eng.run(pkg.sim.constant_trace(
            capacity(4, k=2) * 1.2, 300, 4, dt=1e-3))))
    return out


@pytest.mark.parametrize("backend", ["torch", "fused"])
@pytest.mark.parametrize("knob,word", REFUSED)
def test_unported_knobs_are_refused(knob, word, backend):
    """The observer is refused on both backends, naming its ROADMAP item.
    The balancer, faults and SLO are ported: ``"torch"`` runs them (held to
    the reference's ``"numpy"`` run — every field within 1e-12 relative,
    bit-equal but for the chain's ``completed``, swaps exact; under faults
    and SLO the ledgers and fault histories exact too) and ``"fused"``
    refuses them in its own words."""
    plat = PORT.sim.BatchSimPlatform.stack([make_platform(PORT, 4)])
    value = "counters" if knob == "observe" else object()
    if knob in ("faults", "slo") and backend == "torch":
        (e0, r0), (e1, r1) = _faulted_runs(knob)
        for f in F64_FIELDS + ("dropped_slo", "dropped_fault", "retried",
                               "drop_rate"):
            np.testing.assert_array_equal(getattr(r1, f), getattr(r0, f), f)
        np.testing.assert_array_equal(r1.swaps, r0.swaps)
        assert (r1.dropped_slo + r1.dropped_fault + r1.retried > 0).any()
        for k, v in e0.last_fault_histories.items():
            np.testing.assert_array_equal(
                e1.last_fault_histories[k].numpy(), v, err_msg=k)
        assert r1.telemetry.events == r0.telemetry.events
        return
    if knob == "balancer" and backend == "torch":
        r0, r1 = _balanced_chain_runs()
        for f in F64_FIELDS:
            assert rel_err(getattr(r1, f), getattr(r0, f)) <= 1e-12, f
        for f in ("energy_j", "p50_latency_s", "p99_latency_s", "residual"):
            np.testing.assert_array_equal(getattr(r1, f), getattr(r0, f))
        np.testing.assert_array_equal(r1.swaps, r0.swaps)
        return
    if knob == "balancer":
        value = PORT.sim.LoadBalancer([plat.names[:2]], plat.names)
    with pytest.raises(NotImplementedError) as err:
        PORT.sim.BatchSimEngine(plat, backend=backend, device="cpu",
                                **{knob: value})
    assert word in str(err.value)
    if knob == "balancer":
        assert str(err.value) == ("fused backend does not run the load "
                                  "balancer; use backend='torch'")
    else:
        assert "not ported yet (ROADMAP queue A item" in str(err.value)


def test_fused_refuses_a_balancer_set_after_construction():
    """The reference's kernel backend refuses the balancer when it runs,
    so one assigned after construction is refused too, in the same
    words, and nothing is replayed."""
    plat = PORT.sim.BatchSimPlatform.stack([make_platform(PORT, 4)])
    eng = PORT.sim.BatchSimEngine(plat, backend="fused", device="cpu")
    eng.balancer = PORT.sim.LoadBalancer([plat.names[:2]], plat.names)
    tr = make_trace(PORT, "constant", capacity(4, k=2), ticks=20)
    with pytest.raises(NotImplementedError) as err:
        eng.run(tr)
    assert str(err.value) == ("fused backend does not run the load "
                              "balancer; use backend='torch'")
    assert eng.last_histories is None


def test_unsupported_policy_type_is_refused_on_fused():
    class Custom:
        def __call__(self, rates, sample):
            return np.full_like(rates, np.nan)

    plat = PORT.sim.BatchSimPlatform.stack([make_platform(PORT, 4)])
    ctl = PORT.sim.BatchControllerHarness(plat.islands, plat.rates, Custom(),
                                          tile_names=plat.names)
    eng = PORT.sim.BatchSimEngine(plat, controller=ctl, backend="fused",
                                  device="cpu")
    tr = make_trace(PORT, "constant", capacity(4, k=2), ticks=20)
    with pytest.raises(NotImplementedError, match="membound / pid / ewma"):
        eng.run(tr)
    # the float64 backend runs any host-side batch policy
    PORT.sim.BatchSimEngine(plat, controller=ctl, backend="torch",
                            device="cpu").run(tr)


def test_bad_backend_devices_and_default_device():
    plat = PORT.sim.BatchSimPlatform.stack([make_platform(PORT, 4)])
    with pytest.raises(ValueError, match="backend"):
        PORT.sim.BatchSimEngine(plat, backend="numpy", device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        PORT.sim.BatchSimEngine(plat, devices=4, device="cpu")
    PORT.sim.BatchSimEngine(plat, devices=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PORT.sim.BatchSimEngine(plat)


# ---------------------------------------------------------- percentiles
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_batched_percentiles_equal_per_design_reference(seed):
    """Exact equality with ``repro.sim.engine.latency_percentiles``."""
    rng = np.random.default_rng(seed)
    T, B, A = 180, 7, 3
    adm = rng.poisson(3.0, size=(T, B, A)).astype(np.float64)
    adm *= rng.uniform(0.0, 1.0, size=(T, B, A)) < 0.8     # empty ticks
    cap = rng.uniform(1.5, 4.5, size=(1, B, A))
    served = np.zeros_like(adm)
    q = np.zeros((B, A))
    for t in range(T):                                     # FIFO fluid queue
        q = q + adm[t]
        served[t] = np.minimum(q, cap[0])
        q = q - served[t]
    adm[:, 2] = 0.0                                        # an idle design
    served[:, 2] = 0.0
    p50, p99 = latency_percentiles_batch(torch.as_tensor(adm),
                                         torch.as_tensor(served), 1e-3,
                                         max_elems=T * A * 3)
    for b in range(B):
        want = ref_percentiles(adm[:, b], served[:, b], 1e-3)
        mine = latency_percentiles(adm[:, b], served[:, b], 1e-3)
        got = (float(p50[b]), float(p99[b]))
        assert np.array_equal(np.asarray(got), np.asarray(want),
                              equal_nan=True), (b, got, want)
        assert np.array_equal(np.asarray(mine), np.asarray(want),
                              equal_nan=True)
    assert np.isnan(float(p50[2]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("seed,T", [(0, 300), (1, 300), (2, 1), (3, 57),
                                    (4, 2), (5, 120)])
def test_batched_percentiles_bit_equal_edge_cases(seed, T, dtype):
    """Integer and fractional batches (ties in the delays), empty ticks, a
    design with nothing admitted, T = 1 and 2, design blocks of every
    size: bit for bit the reference's per-design function."""
    adm, srv = chip_smoke().percentile_histories(seed, T)
    a = torch.as_tensor(adm).to(dtype)
    s_ = torch.as_tensor(srv).to(dtype)
    ah, sh = a.double().numpy(), s_.double().numpy()
    want = np.asarray([ref_percentiles(ah[:, b], sh[:, b], 1e-3)
                       for b in range(adm.shape[1])])
    assert np.isnan(want[2]).all()                  # the idle design
    for block in (1, 4, 1 << 24):
        p50, p99 = latency_percentiles_batch(a, s_, 1e-3,
                                             max_elems=T * 3 * block)
        got = np.stack([p50.numpy(), p99.numpy()], axis=-1)
        assert np.array_equal(got, want, equal_nan=True), block


def test_batched_percentiles_order_by_delay_not_position():
    """Two tiles whose samples interleave in delay: the reference's stable
    latency sort and the integer-delay sort select the same sample even
    when a target lands exactly on a cumulative weight."""
    T = 6
    adm = np.zeros((T, 1, 2))
    srv = np.zeros((T, 1, 2))
    adm[:, 0, 0] = [2.0, 0.0, 2.0, 0.0, 0.0, 0.0]
    srv[:, 0, 0] = [0.0, 2.0, 0.0, 0.0, 2.0, 0.0]     # delays 1, 2
    adm[:, 0, 1] = [1.0, 1.0, 0.0, 0.0, 0.0, 0.0]
    srv[:, 0, 1] = [1.0, 0.0, 0.0, 1.0, 0.0, 0.0]     # delays 0, 2
    want = ref_percentiles(adm[:, 0], srv[:, 0], 1e-3)
    p50, p99 = latency_percentiles_batch(torch.as_tensor(adm),
                                         torch.as_tensor(srv), 1e-3)
    assert (float(p50[0]), float(p99[0])) == want


def _blocked_prefix_sums(x, block=5):
    """Running sums along the last axis in another order than in turn (in
    blocks, then the blocks' totals): how a parallel scan on the card
    rounds."""
    L = x.shape[-1]
    pad = (-L) % block
    xp = torch.nn.functional.pad(x, (0, pad)).reshape(*x.shape[:-1], -1,
                                                      block)
    inner = torch.cumsum(xp, dim=-1)
    carry = torch.cumsum(inner[..., -1], dim=-1)
    carry = torch.cat([torch.zeros_like(carry[..., :1]), carry[..., :-1]],
                      dim=-1)
    return (inner + carry.unsqueeze(-1)).reshape(*x.shape[:-1], -1)[..., :L]


def _tenths_histories(seed, T=40, B=16, A=2):
    """Batches and service capacities in tenths: running sums of such
    terms round differently in different orders, and targets land on
    cumulative weights often."""
    rng = np.random.default_rng(seed)
    adm = rng.integers(0, 4, size=(T, B, A)) * 0.1
    adm[:, :3] = np.round(adm[:, :3] * 10.0)                # whole counts
    cap = rng.integers(1, 6, size=(B, A)) * 0.1
    cap[:3] = np.round(cap[:3] * 10.0)
    srv = np.zeros_like(adm)
    q = np.zeros((B, A))
    for t in range(T):
        q = q + adm[t]
        srv[t] = np.minimum(q, cap)
        q = q - srv[t]
    return adm, srv


@pytest.mark.parametrize("seed", [0, 2, 3, 4, 6])
def test_batched_percentiles_exact_when_sums_round_otherwise(monkeypatch,
                                                             seed):
    """With running sums that round differently from NumPy's in-order sums
    (as on the card), every design whose result could move is recomputed
    by the per-design function, so the output stays bit for bit; designs
    of whole-number counts never need it.  The same inputs without the
    bound on the sums' difference give wrong designs, so the check has
    something to catch."""
    import repro_torch.sim.engine as eng_mod
    monkeypatch.setattr(eng_mod, "_prefix_sums", _blocked_prefix_sums)
    redone = []
    orig = eng_mod.latency_percentiles

    def counted(a, s_, dt):
        redone.append(1)
        return orig(a, s_, dt)

    monkeypatch.setattr(eng_mod, "latency_percentiles", counted)
    adm, srv = _tenths_histories(seed)
    B = adm.shape[1]
    want = np.asarray([ref_percentiles(adm[:, b], srv[:, b], 1e-3)
                       for b in range(B)])

    def batch():
        p50, p99 = eng_mod.latency_percentiles_batch(
            torch.as_tensor(adm), torch.as_tensor(srv), 1e-3)
        return np.stack([p50.numpy(), p99.numpy()], axis=-1)

    assert np.array_equal(batch(), want, equal_nan=True)
    assert 0 < len(redone) <= B - 3
    redone.clear()
    monkeypatch.setattr(eng_mod, "_sum_error", lambda n: 0.0)
    monkeypatch.setattr(eng_mod, "latency_percentiles",
                        lambda a, s_, dt: (np.nan, np.nan))
    unguarded = batch()
    wrong = [b for b in range(B)
             if not np.array_equal(unguarded[b], want[b], equal_nan=True)
             and not np.isnan(unguarded[b]).all()]
    assert wrong and min(wrong) >= 3


def test_batched_percentiles_on_float32_histories():
    """float32 histories (the fused backend's) are widened exactly."""
    _, r = _run(PORT, "fused", "pid", "diurnal")
    e, _ = _run(PORT, "fused", "pid", "diurnal")
    adm, srv = (h.double().numpy() for h in e.last_histories)
    for b in range(3):
        want = ref_percentiles(adm[:, b], srv[:, b], 1e-3)
        assert (r.p50_latency_s[b], r.p99_latency_s[b]) == want


def test_weighted_percentiles_equal():
    rng = np.random.default_rng(9)
    v, w = rng.uniform(0, 1, 200), rng.integers(0, 4, 200).astype(float)
    assert np.array_equal(ref_wp(v, w, (50.0, 90.0, 99.0)),
                          weighted_percentiles(v, w, (50.0, 90.0, 99.0)))
    assert np.isnan(weighted_percentiles([], [], (50.0,))).all()


def test_chain_counts_exit_stage_once():
    e0, r0 = _run(REF, "numpy", "open", "constant", chain=True)
    e1, r1 = _run(PORT, "torch", "open", "constant", chain=True)
    assert chain_flows(PORT).stages == chain_flows(REF).stages
    assert rel_err(r1.completed, r0.completed) <= 1e-12
    assert np.all(r1.completed < e1.last_histories[1].sum(dim=(0, 2))
                  .numpy())


# --------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the batched percentiles are held "
                    "bit for bit against NumPy there (chip_smoke.py runs "
                    "this case on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed,T", [(0, 300), (1, 300), (2, 1), (3, 57)])
def test_cuda_percentiles_bit_equal(seed, T, cuda_device):
    """``latency_percentiles_batch`` on the card against the NumPy
    per-design function, bit for bit; the case runs in ``chip_smoke.py``
    (``card_percentiles``)."""
    chip_smoke().card_case("test_cuda_percentiles_bit_equal", seed, T)


@pytest.mark.parametrize("A", [1, 2, 4, 5, 7, 8, 12, 15, 17, 33])
def test_sum_tiles_adds_in_numpys_order(A):
    """Per-tile sums of the torch loop come out bit for bit as NumPy's
    ``sum(axis=-1)`` (whose order torch's own sum leaves from 5 terms up)."""
    from repro_torch.sim.engine import sum_tiles
    rng = np.random.default_rng(A)
    x = rng.uniform(0, 1, (400, A)) * 10.0 ** rng.integers(-8, 8, (400, A))
    assert np.array_equal(sum_tiles(torch.as_tensor(x)).numpy(), x.sum(-1))
