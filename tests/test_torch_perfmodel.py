"""Port vs reference: the analytic performance / energy model.

* NumPy float64 path of the port: **bit-equal** to ``repro`` (same formulas,
  same op order).
* torch float64 path (CPU tensors): <= 1e-12 relative (elementwise IEEE ops;
  in practice 0 or one ulp where torch orders a scalar product differently).
* torch float32 path: <= 2e-6 relative (float32 rounding of a handful of
  operations).
"""
import numpy as np
import pytest
import torch

from repro.core import perfmodel as r_pm
from repro.core.voltage import TechModel as RTech
from repro_torch.core import perfmodel as p_pm
from repro_torch.core.voltage import TechModel as PTech

from _torch_port_helpers import rel_err


def _grid(seed=0, n=64):
    rng = np.random.default_rng(seed)
    return dict(
        base_mbps=rng.uniform(0.3, 9.5, n), wire_share=rng.uniform(5e-4, .16, n),
        k=rng.choice([1.0, 2.0, 4.0, 8.0], n), f_acc=rng.uniform(0.0, 1.0, n),
        f_noc=rng.uniform(0.0, 1.0, n), f_tg=rng.uniform(0.2, 1.0, n),
        n_tg=rng.integers(0, 12, n).astype(float),
        pos_idx=rng.choice([i for i in range(16) if i != 4], n))


MODELS = [dict(), dict(own_demand=1.7, tg_demand=0.2, hop_latency_share=.1)]


@pytest.mark.parametrize("mkw", MODELS, ids=["default", "retuned"])
def test_accel_throughput_batch(mkw):
    a, b = r_pm.SoCPerfModel(**mkw), p_pm.SoCPerfModel(**mkw)
    g = _grid(1)
    ref = a.accel_throughput_batch(**g)
    assert np.array_equal(ref, b.accel_throughput_batch(**g))      # bits
    t64 = b.accel_throughput_batch(**g, backend="torch", device="cpu")
    assert t64.dtype == torch.float64
    assert rel_err(t64.numpy(), ref) <= 1e-12
    t32 = b.accel_throughput_batch(**g, backend="torch", device="cpu",
                                   dtype=torch.float32)
    assert t32.dtype == torch.float32
    assert rel_err(t32.double().numpy(), ref) <= 2e-6


@pytest.mark.parametrize("mkw", MODELS, ids=["default", "retuned"])
def test_service_time_terms_batch(mkw):
    a, b = r_pm.SoCPerfModel(**mkw), p_pm.SoCPerfModel(**mkw)
    g = _grid(2)
    g.pop("base_mbps")
    ref = a.service_time_terms_batch(**g)
    got = b.service_time_terms_batch(**g)
    for x, y in zip(ref, got):
        assert np.array_equal(x, y)                                 # bits
    hops = a.hop_counts(pos_idx=g["pos_idx"]) + 2
    g2 = {k: v for k, v in g.items() if k != "pos_idx"}
    for x, y in zip(a.service_time_terms_batch(**g2, hop_counts=hops),
                    b.service_time_terms_batch(**g2, hop_counts=hops)):
        assert np.array_equal(x, y)
    t64 = b.service_time_terms_batch(**g, backend="torch", device="cpu")
    for x, y in zip(ref, t64):
        assert rel_err(np.broadcast_to(y.numpy(), np.shape(x)), x) <= 1e-12
    t32 = b.service_time_terms_batch(**g, backend="torch", device="cpu",
                                     dtype=torch.float32)
    for x, y in zip(ref, t32):
        assert rel_err(np.broadcast_to(y.double().numpy(), np.shape(x)),
                       x) <= 2e-6


def test_service_terms_recompose_to_throughput():
    b = p_pm.SoCPerfModel()
    g = _grid(3)
    base = g.pop("base_mbps")
    t_comp, t_wire, t_ref = b.service_time_terms_batch(**g)
    thr = b.accel_throughput_batch(base_mbps=base, **g)
    assert np.array_equal(base * t_ref / (t_comp + t_wire), thr)


def test_memory_traffic_batch():
    a, b = r_pm.SoCPerfModel(), p_pm.SoCPerfModel()
    g = _grid(4)
    kw = dict(f_noc=g["f_noc"], f_tg=g["f_tg"], n_tg=g["n_tg"])
    ref = a.memory_traffic_batch(f_acc=g["f_acc"], n_accels=2, **kw)
    assert np.array_equal(
        ref, b.memory_traffic_batch(f_acc=g["f_acc"], n_accels=2, **kw))
    per = [g["f_acc"], g["f_acc"][::-1].copy()]
    ref2 = a.memory_traffic_batch(f_acc_per_accel=per, **kw)
    assert np.array_equal(ref2,
                          b.memory_traffic_batch(f_acc_per_accel=per, **kw))
    t64 = b.memory_traffic_batch(f_acc_per_accel=per, backend="torch",
                                 device="cpu", **kw)
    assert rel_err(t64.numpy(), ref2) <= 1e-12
    t32 = b.memory_traffic_batch(f_acc=g["f_acc"], n_accels=2,
                                 backend="torch", device="cpu",
                                 dtype=torch.float32, **kw)
    assert rel_err(t32.double().numpy(), ref) <= 2e-6


@pytest.mark.parametrize("tech", [None, 45, (16, "cons")],
                         ids=["linear", "45nm", "16cons"])
def test_chip_power(tech):
    rng = np.random.default_rng(6)
    f, busy = rng.uniform(0, 1.3, 50), rng.uniform(0, 1, 50)
    ref = r_pm.chip_power(f, busy, tech=RTech.coerce(tech))
    tm = PTech.coerce(tech)
    assert np.array_equal(ref, p_pm.chip_power(f, busy, tech=tm))   # bits
    t64 = p_pm.chip_power(torch.as_tensor(f), torch.as_tensor(busy), tech=tm)
    assert rel_err(t64.numpy(), ref) <= 1e-12
    t32 = p_pm.chip_power(torch.as_tensor(f, dtype=torch.float32),
                          torch.as_tensor(busy, dtype=torch.float32), tech=tm)
    assert rel_err(t32.double().numpy(), ref) <= 2e-6
    assert r_pm.chip_power(0.6, 1.0) == p_pm.chip_power(0.6, 1.0)


def test_constants_and_scalar_wrappers():
    for c in ("P_STATIC_W", "P_DYN_W", "V_BASE", "V_SLOPE",
              "NOC_POWER_SHARE", "WIRE_SHARE"):
        assert getattr(r_pm, c) == getattr(p_pm, c)
    a, b = r_pm.SoCPerfModel(), p_pm.SoCPerfModel()
    rates = {"acc": 0.6, "noc_mem": 0.5, "tg": 0.8}
    for name in ("adpcm", "dfadd", "other"):
        wa = r_pm.AccelWorkload(name, 2.0, 9.0, replication=2)
        wb = p_pm.AccelWorkload(name, 2.0, 9.0, replication=2)
        assert wa.wire_share == wb.wire_share
        assert a.accel_throughput(wa, (3, 3), rates, 5) == \
            b.accel_throughput(wb, (3, 3), rates, 5)
    assert a.memory_traffic_mpkts(rates, 5, [(1, 1), (3, 3)]) == \
        b.memory_traffic_mpkts(rates, 5, [(1, 1), (3, 3)])
