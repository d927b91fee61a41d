"""Port vs reference: the telemetry rings of the batched co-simulation.

* ``repro_torch.sim.telemetry`` (host NumPy) against ``repro.sim.telemetry``:
  ``RingBuffer`` wrap, ``_json_safe``, ``weighted_percentiles`` and the
  export cases of the reference's ``tests/test_telemetry.py``, each run
  through both packages.
* the ``"torch"`` backend's float64 recording (device rings, one copy at the
  end) against the reference's ``BatchSimEngine(backend="numpy")``:
  **array-equal** — scalars, island rates, queue depth, busy, events and
  ``rows_recorded`` — with every controller, a wrapped ring (capacity 64
  below the rows recorded), a chain, ``max_queue``, the 45 nm tech model and
  twelve tiles; and ``to_json`` documents equal.
* no host sync inside a row: while a row is recorded, every tensor method
  that brings a value to the host raises.
* ``"fused"`` and the float32 ``"torch"`` loop record none (as the
  reference's Pallas and float32 scan backends).
"""
import json

import numpy as np
import pytest
import torch

import repro.sim.telemetry as ref_tel
import repro_torch.sim.telemetry as port_tel
from repro.sim import SimConfig as RefSimConfig

from _torch_port_helpers import (PORT, REF, POLICIES, capacity, chip_smoke,
                                 make_engine, make_trace)

RINGS = ("scalars", "island_rates", "queue_depth", "busy")


def _recordings(policy, *, ticks=300, interval=7, cap_rows=64, **kw):
    """(reference, port) BatchTelemetry of the same run."""
    out = []
    for pkg, backend in ((REF, "numpy"), (PORT, "torch")):
        eng = make_engine(pkg, backend, policy, **kw)
        rows = ticks // interval if interval else 0
        cfg = pkg.sim.SimConfig(
            control_interval=eng.config.control_interval,
            max_queue=eng.config.max_queue, telemetry_interval=interval,
            telemetry_capacity=max(1, rows - cap_rows) if cap_rows
            else 4096)
        eng.config = cfg
        n = kw.get("n_tiles", 4)
        tr = make_trace(pkg, "mmpp", capacity(n, k=2), ticks=ticks)
        out.append(eng.run(tr).telemetry)
    return out


def _assert_equal(ref, got):
    for ring in RINGS:
        a, b = getattr(ref, ring), getattr(got, ring)
        np.testing.assert_array_equal(b.array(), a.array(), err_msg=ring)
        assert b.total_appended == a.total_appended
        assert b.capacity == a.capacity and b.row_shape == a.row_shape
    assert got.events == ref.events
    assert got.n_designs == ref.n_designs
    assert got.schema.islands == ref.schema.islands
    assert got.schema.tiles == ref.schema.tiles
    assert got.to_dict() == ref.to_dict()


# ------------------------------------------------ the engine's recording
@pytest.mark.parametrize("policy", POLICIES)
def test_torch_recording_equals_numpy_reference_wrapped(policy):
    """Every controller, 2,000 ticks, a row every 7: 285 rows into a ring
    of 285 - 64 = 221 slots, so the oldest 64 rows are overwritten."""
    ref, got = _recordings(policy, ticks=2000)
    assert ref.scalars.total_appended == 285
    assert ref.scalars.capacity == 285 - 64
    _assert_equal(ref, got)
    if policy in ("pid", "ewma", "membound"):
        assert ref.events and all(e["kind"] == "dfs_commit"
                                  for e in ref.events)


@pytest.mark.parametrize("opts", [
    dict(chain=True, max_queue=3.0, tech=45), dict(n_tiles=12, ks=(2, 4)),
    dict(tech=(16, "cons"))], ids=["chain-maxq-tech45", "twelve-tiles",
                                   "tech16cons"])
@pytest.mark.parametrize("policy", ["pid", "membound"])
def test_torch_recording_options(policy, opts):
    ref, got = _recordings(policy, **opts)
    _assert_equal(ref, got)


def test_torch_recording_unwrapped_and_interval_zero():
    ref, got = _recordings("pid", cap_rows=0)
    assert ref.scalars.total_appended == len(ref.scalars) == 42
    _assert_equal(ref, got)
    ref0, got0 = _recordings("pid", interval=0, cap_rows=0)
    assert ref0.scalars.total_appended == got0.scalars.total_appended == 0
    assert got0.events == ref0.events
    assert got0.summary() == ref0.summary() == "(no telemetry)"


def test_torch_recording_json_round_trip():
    ref, got = _recordings("pid")
    doc_r, doc_g = json.loads(ref.to_json()), json.loads(got.to_json())
    assert doc_g == doc_r
    for ring in ("island_rates", "queue_depth", "busy"):
        np.testing.assert_array_equal(np.asarray(doc_g[ring]),
                                      getattr(got, ring).array())
    for name, col in doc_g["scalars"].items():
        np.testing.assert_array_equal(np.asarray(col), got.series(name))
    for b in range(got.n_designs):
        d = got.design(b)
        np.testing.assert_array_equal(np.asarray(doc_g["busy"])[:, b, :],
                                      d["busy"])
    assert doc_g["rows_recorded"] == got.scalars.total_appended
    assert got.summary() == ref.summary()


def test_no_host_sync_inside_a_row(monkeypatch):
    """Every row is written from tensors already on the engine's device:
    while one is recorded, any method that would bring a value to the
    host raises."""
    rings_cls = PORT.sim.batch.TelemetryRings
    orig = rings_cls.record
    rows = []

    def guarded(self, **kw):
        def refuse(*a, **k):
            raise AssertionError("host sync inside a telemetry row")
        with monkeypatch.context() as m:
            for name in ("item", "cpu", "numpy", "tolist", "__bool__",
                         "__float__", "__int__"):
                m.setattr(torch.Tensor, name, refuse)
            orig(self, **kw)
        rows.append(kw["tick"])

    monkeypatch.setattr(rings_cls, "record", guarded)
    eng = make_engine(PORT, "torch", "pid")
    r = eng.run(make_trace(PORT, "diurnal", capacity(4, k=2), ticks=200))
    assert len(rows) == r.telemetry.scalars.total_appended == 10


@pytest.mark.parametrize("backend,dtype", [("fused", torch.float32),
                                           ("torch", torch.float32)])
def test_fused_and_float32_record_no_telemetry(backend, dtype):
    eng = make_engine(PORT, backend, "pid", dtype=dtype)
    r = eng.run(make_trace(PORT, "diurnal", capacity(4, k=2), ticks=60))
    assert r.telemetry is None


# ------------------------------------------------ host module, both packages
@pytest.mark.parametrize("pkg", [ref_tel, port_tel],
                         ids=["repro", "repro_torch"])
def test_ringbuffer_wraparound_and_boundaries(pkg):
    rb = pkg.RingBuffer(5, (3, 2))
    rows = [np.full((3, 2), float(i)) for i in range(12)]
    for r in rows:
        rb.append(r)
    assert len(rb) == 5 and rb.total_appended == 12
    np.testing.assert_array_equal(rb.array(), np.stack(rows[7:]))
    np.testing.assert_array_equal(rb.last(), rows[-1])
    rb = pkg.RingBuffer(4, (2, 3))
    for i in range(5):
        rb.append(np.full((2, 3), float(i)))
    np.testing.assert_array_equal(rb.array()[:, 0, 0], [1.0, 2.0, 3.0, 4.0])
    with pytest.raises(AssertionError):
        pkg.RingBuffer(0, 3)
    with pytest.raises(AssertionError):
        pkg.RingBuffer(4, (2, 0))


@pytest.mark.parametrize("n", [0, 3, 5, 12])
def test_ringbuffer_fill_equals_appends(n):
    """``fill`` (how the engine hands over its device rings) leaves the ring
    as the same rows appended one by one would."""
    rows = [np.full((2, 3), float(i)) for i in range(n)]
    a = port_tel.RingBuffer(5, (2, 3))
    for r in rows:
        a.append(r)
    b = port_tel.RingBuffer(5, (2, 3))
    slots = a._buf[:min(n, 5)].copy()
    b.fill(slots, n)
    assert b.total_appended == a.total_appended and len(b) == len(a)
    np.testing.assert_array_equal(b.array(), a.array())


def test_json_safe_equal():
    payload = {"rate": np.float64(0.75), "count": np.int64(3),
               "flag": np.bool_(True), "rates": np.asarray([0.5, 1.0]),
               "grid": np.arange(4).reshape(2, 2),
               "mixed": (np.float32(1.5), [np.int32(2),
                                           {"k": np.float64(0.1)}]),
               "names": {"a"}, 1: "int key"}
    got, want = port_tel._json_safe(payload), ref_tel._json_safe(payload)
    assert got == want
    assert json.dumps(got) == json.dumps(want)
    assert type(got["rate"]) is float and type(got["count"]) is int


@pytest.mark.parametrize("qs", [(50.0, 99.0), (0.0, 50.0, 100.0),
                                (90.0,)])
def test_weighted_percentiles_equal(qs):
    rng = np.random.default_rng(3)
    v = rng.uniform(0.001, 0.1, size=40)
    w = rng.integers(0, 20, size=40).astype(float)
    for args in ((v, w), ([], []), ([1.0, 2.0], [0.0, 0.0]), ([3.5], [10.0])):
        np.testing.assert_array_equal(
            port_tel.weighted_percentiles(*args, qs),
            ref_tel.weighted_percentiles(*args, qs))
    from repro_torch.sim.engine import weighted_percentiles
    assert weighted_percentiles is port_tel.weighted_percentiles


def test_schema_and_telemetry_equal():
    schema = dict(islands=("a", "noc_mem"), tiles=("a",))
    t_r = ref_tel.Telemetry(ref_tel.TelemetrySchema(**schema), capacity=3)
    t_p = port_tel.Telemetry(port_tel.TelemetrySchema(**schema), capacity=3)
    for t in (t_r, t_p):
        for i in range(5):
            t.record(tick=i, f_noc=1.0, island_rates=[0.5, 1.0],
                     queue_depth=[float(i)], busy=[0.25],
                     throughput_rps=10.0 * i, power_w=100.0,
                     link_util_max=0.5, link_util_mean=0.25,
                     latency_est_s=1e-3)
        t.event(2, "commit", rates=np.asarray([0.5, 1.0]))
    assert t_p.to_dict() == t_r.to_dict()
    assert t_p.to_json() == t_r.to_json()
    assert t_p.summary() == t_r.summary()
    assert port_tel.BatchTelemetry.SCALARS == ref_tel.BatchTelemetry.SCALARS


def test_reference_config_defaults_carry_over():
    cfg_r, cfg_p = RefSimConfig(), PORT.sim.SimConfig()
    assert cfg_p.telemetry_interval == cfg_r.telemetry_interval
    assert cfg_p.telemetry_capacity == cfg_r.telemetry_capacity


# --------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device rings are held "
                    "against the CPU there (chip_smoke.py runs this case "
                    "on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_telemetry_matches_cpu(policy, cuda_device):
    """The float64 loop's telemetry on the card against the same run on
    the CPU: rel <= 1e-12, rows and events equal, no host sync inside a
    row.  The case runs in ``chip_smoke.py`` (``card_telemetry``)."""
    chip_smoke().card_case("test_cuda_telemetry_matches_cpu", policy)
