"""Port vs reference: the module that holds the fused tick kernel.

The same platforms, controllers and arrivals go through the reference's
Pallas kernel — ``repro.kernels.tick_sim.fused_tick_sim`` in interpret mode,
driven through ``BatchSimEngine(backend="pallas")`` as the reference's own
tests drive it — and through the port's ``fused_tick_sim`` (on CPU tensors:
the plain version, the arithmetic the CUDA kernel repeats op for op).

Tolerance: both sides compute in float32 with the same formulas but a
different op order (one-hot matmuls and einsums there, gathers and ordered
sums here), so float outputs agree to rtol 1e-4 / atol 1e-4; ``swaps`` and
the guard latch are integers/bools and must be **exact**.  The CUDA kernel
itself runs only on a card: ``chip_smoke.py`` holds it against the plain
version there, and the ``gpu``-marked test below does the same under pytest.
"""
import functools

import numpy as np
import pytest
import torch

import repro.kernels.tick_sim as ref_kernel
from repro_torch.kernels import tick_sim as port_kernel
from repro_torch.kernels.tick_sim import (ControlPlan, fused_tick_sim,
                                          fused_tick_sim_plain, link_masks)

from _torch_port_helpers import (PORT, POLICIES, REF, capacity, make_engine,
                                 make_trace)

RTOL = ATOL = 1e-4
T = 300

# policy x {max_q} x {flows} x {tech}: every policy meets every option, and
# every pair of options meets at least once
CASES = []
for _pol in POLICIES:
    CASES += [
        (_pol, float("inf"), False, None),
        (_pol, 3.0, True, 45),
        (_pol, float("inf"), True, (16, "cons")),
        (_pol, 3.0, False, (16, "cons")),
    ]
CASES += [("pid", 3.0, False, 45), ("ewma", float("inf"), False, 45),
          ("membound", 3.0, True, None), ("guard", float("inf"), True, None)]


def _id(case):
    pol, mq, chain, tech = case
    return "-".join([pol, "q%g" % mq, "chain" if chain else "mem",
                     "lin" if tech is None else str(tech[0] if
                                                    isinstance(tech, tuple)
                                                    else tech)])


def _run_pair(policy, max_queue, chain, tech, *, ks=(2, 4, 8), trace="diurnal"):
    cap = capacity(4, k=2)
    out = {}
    for pkg, backend in ((REF, "pallas"), (PORT, "fused")):
        eng = make_engine(pkg, backend, policy, ks=ks, tech=tech,
                          max_queue=max_queue, chain=chain)
        res = eng.run(make_trace(pkg, trace, cap, ticks=T))
        out[pkg.name] = (eng, res)
    return out["repro"], out["repro_torch"]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_kernel_outputs_match(ref, got):
    (e0, r0), (e1, r1) = ref, got
    for i, name in enumerate(("admitted", "served")):
        np.testing.assert_allclose(_np(e1.last_histories[i]),
                                   e0.last_histories[i], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for f in ("queue", "busy", "rtt_acc", "energy", "dropped"):
        np.testing.assert_allclose(_np(getattr(e1.last_state, f)),
                                   getattr(e0.last_state, f), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(r1.swaps, r0.swaps)
    if e0.controller is not None:
        np.testing.assert_allclose(e1.controller.rates, e0.controller.rates,
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(e1.controller._guard_active,
                                      e0.controller._guard_active)
        np.testing.assert_array_equal(e1.controller.swaps,
                                      e0.controller.swaps)
        np.testing.assert_array_equal(e1.controller.versions,
                                      e0.controller.versions)
        for attr in ("_integral", "_prev_err", "_ewma"):
            if hasattr(e0.controller.policy, attr):
                np.testing.assert_allclose(
                    getattr(e1.controller.policy, attr),
                    getattr(e0.controller.policy, attr), rtol=RTOL,
                    atol=ATOL, err_msg=attr)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plain_version_matches_pallas_kernel(case):
    ref, got = _run_pair(*case)
    _assert_kernel_outputs_match(ref, got)


@pytest.mark.parametrize("policy", ["open", "pid"])
def test_single_design(policy):
    ref, got = _run_pair(policy, float("inf"), False, None, ks=(4,))
    _assert_kernel_outputs_match(ref, got)


@pytest.mark.parametrize("policy", ["membound", "ewma"])
def test_ragged_batch_against_padded_reference(policy, monkeypatch):
    """B=5 with the reference forced to blocks of 2 designs: it pads the
    batch to 6 by replicating design 0; the port masks the ragged tail.  The
    padding must not perturb the five real designs."""
    monkeypatch.setattr(
        ref_kernel, "fused_tick_sim",
        functools.partial(ref_kernel.fused_tick_sim, block_b=2))
    ref, got = _run_pair(policy, 3.0, False, 45, ks=(1, 2, 4, 8, 2),
                         trace="mmpp")
    _assert_kernel_outputs_match(ref, got)


def test_per_design_arrivals_equal_shared_broadcast():
    """A (T, B, A) tensor that repeats one (T, A) trace gives the same
    outputs as the shared trace read with a zero batch stride."""
    cap = capacity(4, k=2)
    tr = make_trace(PORT, "diurnal", cap, ticks=120)
    a = make_engine(PORT, "fused", "pid").run(tr)
    b = make_engine(PORT, "fused", "pid").run(
        PORT.sim.BatchTrace.broadcast(tr, 3))
    for f in ("completed", "energy_j", "residual", "p99_latency_s"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(a.swaps, b.swaps)


def test_policy_state_carries_over_runs():
    """An engine re-run starts from the policy object's carried state, as in
    the reference (PID integral / previous error, EWMA)."""
    cap = capacity(4, k=2)
    for policy in ("pid", "ewma"):
        engines = {}
        for pkg, backend in ((REF, "pallas"), (PORT, "fused")):
            eng = make_engine(pkg, backend, policy)
            tr = make_trace(pkg, "diurnal", cap, ticks=100)
            eng.run(tr)
            engines[pkg.name] = (eng, eng.run(tr))
        _assert_kernel_outputs_match(engines["repro"],
                                     engines["repro_torch"])


# ------------------------------------------------------------ wrapper rules
def _inputs(policy="pid"):
    eng = make_engine(PORT, "fused", policy)
    tr = make_trace(PORT, "diurnal", capacity(4, k=2), ticks=40)
    return eng.fused_inputs(tr)[:5]


def test_cpu_tensor_runs_plain_version_without_build(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CPU path must not touch the CUDA build")
    monkeypatch.setattr(port_kernel, "_kernel_fn", boom)
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "build_all", boom)
    arr, consts, scalars, init, plan = _inputs()
    before = fused_tick_sim.launches
    out = fused_tick_sim(arr, consts, scalars, init, plan=plan)
    ref = fused_tick_sim_plain(arr, consts, scalars, init, plan=plan)
    assert fused_tick_sim.launches == before        # counts launches only
    for k in ("adm", "served", "queue", "energy", "swaps", "rates"):
        assert torch.equal(out[k], ref[k]), k
    assert out["adm"].dtype == torch.float32
    assert out["guard"].dtype == torch.bool
    assert out["swaps"].shape == (3,) and out["adm"].shape == (40, 3, 4)
    assert len(out["pol"]) == 3 and out["pol"][2].shape == (3, 1)


def test_wrapper_refuses_bad_inputs():
    arr, consts, scalars, init, plan = _inputs()
    with pytest.raises(TypeError, match="float32"):
        fused_tick_sim(arr.double(), consts, scalars, init, plan=plan)
    with pytest.raises(ValueError, match="contiguous"):
        bad = dict(consts, base=consts["base"].t().contiguous().t())
        fused_tick_sim(arr, bad, scalars, init, plan=plan)
    with pytest.raises(ValueError, match="shape"):
        fused_tick_sim(arr[:, :3], consts, scalars, init, plan=plan)
    with pytest.raises(ValueError, match="state"):
        fused_tick_sim(arr, consts, scalars, dict(init, pol=()), plan=plan)
    wide = dict(consts, inc=torch.zeros(3, 4, 65))
    with pytest.raises(ValueError, match="bounds"):
        fused_tick_sim(arr, wide, scalars, init, plan=plan)
    with pytest.raises(NotImplementedError, match="supported kinds"):
        ControlPlan(kind="lqr")


def test_wrapper_refuses_an_empty_batch():
    arr, consts, scalars, init, plan = _inputs()
    none = {k: v[:0] for k, v in consts.items()}
    init0 = {"rates": init["rates"][:0], "guard": init["guard"][:0],
             "pol": tuple(s[:0] for s in init["pol"])}
    before = fused_tick_sim.launches
    with pytest.raises(ValueError, match="at least one design"):
        fused_tick_sim(arr, none, scalars, init0, plan=plan)
    assert fused_tick_sim.launches == before


def test_link_masks_hold_whole_incidence_rows():
    rng = np.random.default_rng(0)
    inc = torch.as_tensor((rng.uniform(size=(3, 5, 64)) < 0.3)
                          .astype(np.float32))
    masks = link_masks(inc).numpy().astype(np.uint64)
    for l in range(64):
        bit = (masks >> np.uint64(l)) & np.uint64(1)
        assert np.array_equal(bit.astype(np.float32), inc[..., l].numpy())


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no "
                    "CPU mode (chip_smoke.py runs this comparison on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_kernel_matches_plain_version(policy, cuda_device):
    eng = make_engine(PORT, "fused", policy, tech=45, max_queue=3.0,
                      chain=True, device=cuda_device)
    tr = make_trace(PORT, "mmpp", capacity(4, k=2), ticks=T)
    arr, consts, scalars, init, plan = eng.fused_inputs(tr)[:5]
    before = fused_tick_sim.launches
    out = fused_tick_sim(arr, consts, scalars, init, plan=plan)
    torch.cuda.synchronize()
    assert fused_tick_sim.launches == before + 1
    ref = fused_tick_sim_plain(arr, consts, scalars, init, plan=plan)
    for k in ("adm", "served", "queue", "busy", "rtt", "rates", "energy",
              "dropped"):
        torch.testing.assert_close(out[k], ref[k], rtol=RTOL, atol=ATOL)
    assert torch.equal(out["swaps"], ref["swaps"])
    assert torch.equal(out["guard"], ref["guard"])
