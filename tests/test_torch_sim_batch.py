"""Port vs reference: the batched co-simulation engine.

* ``backend="torch"`` (float64 tick loop, CPU tensors here) vs the reference
  ``backend="numpy"``: ``completed / energy_j / residual / dropped / p50 /
  p99 / throughput_rps`` within 1e-12 relative.  On CPU tensors every one of
  them comes out **bit-equal**, with one exception: under a chained flow
  pattern ``completed`` (and what is derived from it) differs in the last
  bits, ~2e-15 relative, because the port sums the served history over time
  before masking the exit stage and the reference masks first.  The tests
  assert the tolerance, and exact equality for ``swaps`` and the final
  controller state.
* ``backend="fused"`` (float32; the kernel's plain version on the CPU) vs
  the reference ``"numpy"``: rtol 2e-3 / atol 1e-2, ``swaps`` exact — the
  bar the reference sets for its own fused kernel.
* knobs that are not ported raise ``NotImplementedError``.
* the batched latency-percentile reconstruction equals the per-design
  reference function exactly.
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
                                 make_engine, make_platform, make_trace,
                                 rel_err)

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
    assert r1.telemetry is None
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


# ------------------------------------------------------------- refusals
REFUSED = [("faults", "fault"), ("slo", "SLO"), ("balancer", "balancer"),
           ("observe", "observer")]


@pytest.mark.parametrize("backend", ["torch", "fused"])
@pytest.mark.parametrize("knob,word", REFUSED)
def test_unported_knobs_are_refused(knob, word, backend):
    plat = PORT.sim.BatchSimPlatform.stack([make_platform(PORT, 4)])
    value = "counters" if knob == "observe" else object()
    with pytest.raises(NotImplementedError) as err:
        PORT.sim.BatchSimEngine(plat, backend=backend, device="cpu",
                                **{knob: value})
    assert word in str(err.value)
    assert "not ported yet (ROADMAP queue A item" in str(err.value)


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
