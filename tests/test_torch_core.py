"""Port vs reference: the SoC description layer and the trace generators.

Host-side NumPy / stdlib code on both sides, so every comparison here is
**exact equality** (tolerance 0): ladders, island lookup, tech tables,
routing tables, incidence, the replication area model and the seeded traces.
"""
import numpy as np
import pytest

import repro.core.islands as r_isl
import repro.core.noc as r_noc
import repro.core.voltage as r_volt
import repro.sim.traffic as r_tr
from repro.configs import vespa_soc as r_soc
from repro.core.replication import (replication_area_model as r_area,
                                    replication_throughput_model as r_gain)
from repro.sim.flows import FlowPattern as RFlow, compile_flows as r_compile
import repro_torch.core.islands as p_isl
import repro_torch.core.noc as p_noc
import repro_torch.core.voltage as p_volt
import repro_torch.sim.traffic as p_tr
from repro_torch.configs import vespa_soc as p_soc
from repro_torch.core.replication import (replication_area_model as p_area,
                                          replication_throughput_model
                                          as p_gain)
from repro_torch.core.tiles import MONITOR_KINDS, TilePlan, TileSpec
from repro_torch.sim.flows import FlowPattern as PFlow, compile_flows \
    as p_compile

from _torch_port_helpers import PORT, REF


# ------------------------------------------------------------------ ladders
@pytest.mark.parametrize("name", ["TILE_LADDER", "NOC_LADDER"])
def test_ladders_equal(name):
    a, b = getattr(r_isl, name), getattr(p_isl, name)
    assert a.levels_mhz() == b.levels_mhz()
    assert a.levels() == b.levels()
    for rate in np.linspace(0.0, 1.3, 53):
        assert a.quantize(rate) == b.quantize(rate)


def _islands(mod):
    return mod.IslandConfig((
        mod.IslandSpec("a", ("t0", "t1"), mod.TILE_LADDER, 0.6),
        mod.IslandSpec("b", ("t2",), mod.TILE_LADDER, 1.0, fixed=True),
        mod.IslandSpec("noc_mem", ("NOC", "MEM"), mod.NOC_LADDER, 0.5)))


def test_island_of_and_with_rates_equal():
    a, b = _islands(r_isl), _islands(p_isl)
    for t in ("t0", "t1", "t2", "NOC", "MEM"):
        assert a.island_of(t).name == b.island_of(t).name
        assert a.rate_of(t) == b.rate_of(t)
    a2 = a.with_rates({"a": 0.33, "noc_mem": 0.72})
    b2 = b.with_rates({"a": 0.33, "noc_mem": 0.72})
    assert [i.rate for i in a2.islands] == [i.rate for i in b2.islands]
    assert a2.version == b2.version == 1
    assert a.names() == b.names()


def test_paper_soc_and_chstone_equal():
    assert r_soc.CHSTONE == p_soc.CHSTONE
    assert r_soc.TABLE_I == p_soc.TABLE_I
    (rt, ri), (pt, pi) = r_soc.paper_soc(4), p_soc.paper_soc(4)
    assert [(t.name, t.kind, t.pos, t.workload, t.replication) for t in rt] \
        == [(t.name, t.kind, t.pos, t.workload, t.replication) for t in pt]
    assert [(i.name, i.tiles, i.f_min_mhz, i.f_max_mhz, i.f_step_mhz)
            for i in ri] == \
        [(i.name, i.tiles, i.f_min_mhz, i.f_max_mhz, i.f_step_mhz)
         for i in pi]


def test_tile_plan_with_replication():
    plan = TilePlan("soc", (TileSpec("acc", "ffn"), TileSpec("mem", "mem")))
    p2 = plan.with_replication("acc", 4)
    assert p2.tile("acc").replication == 4 and p2.tile("mem").replication == 1
    assert MONITOR_KINDS == ("exec_time", "pkts_in", "pkts_out", "rtt")
    assert set(plan.islands()) == {"default"}


# --------------------------------------------------------------------- tech
@pytest.mark.parametrize("variant", r_volt.TECH_VARIANTS)
@pytest.mark.parametrize("node", r_volt.TECH_NODES)
def test_tech_model_equal(node, variant):
    a, b = r_volt.TechModel(node, variant), p_volt.TechModel(node, variant)
    for f in ("vdd", "vth", "freq_scl", "power_scl", "area_scl", "l_bound",
              "u_bound", "v0", "v1"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.power_coeffs == b.power_coeffs and a.key == b.key
    for lad_a, lad_b in ((r_isl.TILE_LADDER, p_isl.TILE_LADDER),
                         (r_isl.NOC_LADDER, p_isl.NOC_LADDER)):
        assert np.array_equal(a.legal_levels(lad_a), b.legal_levels(lad_b))
        assert np.array_equal(a.ladder_voltages(lad_a),
                              b.ladder_voltages(lad_b))
    x = np.linspace(0.0, 1.5, 31)
    assert np.array_equal(a.clamp_ratio(x), b.clamp_ratio(x))
    assert np.array_equal(a.volt_ratio(x), b.volt_ratio(x))


def test_tech_tables_and_axis_coeffs_equal():
    for tab in ("VDD_SCALE", "FREQ_SCALE", "POWER_SCALE", "AREA_SCALE",
                "VTH"):
        assert getattr(r_volt, tab) == getattr(p_volt, tab)
    techs = [(45, "itrs"), (16, "cons"), 22]
    a, b = r_volt.tech_axis_coeffs(techs), p_volt.tech_axis_coeffs(techs)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert p_volt.TechModel.coerce(None) is None
    with pytest.raises(ValueError):
        p_volt.TechModel(7)


# ---------------------------------------------------------------------- noc
NOCS = [dict(rows=4, cols=4), dict(rows=4, cols=4, torus=True),
        dict(rows=3, cols=5, link_bw=2.0)]


@pytest.mark.parametrize("kw", NOCS, ids=["mesh4", "torus4", "mesh3x5"])
def test_routing_tables_equal(kw):
    a = r_noc.routing_tables(r_noc.NocConfig(**kw))
    b = p_noc.routing_tables(p_noc.NocConfig(**kw))
    assert a.links == b.links
    for f in ("hop_matrix", "link_ids", "route_offsets"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(a.dense_incidence(), b.dense_incidence())


@pytest.mark.parametrize("kw", NOCS, ids=["mesh4", "torus4", "mesh3x5"])
def test_batched_routing_queries_equal(kw):
    ca, cb = r_noc.NocConfig(**kw), p_noc.NocConfig(**kw)
    rng = np.random.default_rng(5)
    n = ca.rows * ca.cols
    src = rng.integers(0, n, size=(7, 5))
    dst = rng.integers(0, n, size=(7, 5))
    demand = rng.uniform(0.0, 1.0, size=35)
    assert np.array_equal(r_noc.hops_batch(ca, src, dst),
                          p_noc.hops_batch(cb, src, dst))
    assert np.array_equal(r_noc.hops_batch(ca, src, (1, 0)),
                          p_noc.hops_batch(cb, src, (1, 0)))
    inc_a = r_noc.stacked_incidence(ca, src, dst)
    inc_b = p_noc.stacked_incidence(cb, src, dst)
    assert np.array_equal(inc_a, inc_b)
    assert set(np.unique(inc_b)) <= {0.0, 1.0}      # rows are strictly 0/1
    fa, fb = r_noc.flow_incidence(ca, src, dst), \
        p_noc.flow_incidence(cb, src, dst)
    assert np.array_equal(fa[0], fb[0]) and np.array_equal(fa[1], fb[1])
    la = r_noc.link_loads_batch(ca, src, dst, demand)
    lb = p_noc.link_loads_batch(cb, src, dst, demand)
    assert np.array_equal(la, lb)
    assert np.array_equal(r_noc.route_max_utilization(ca, la, src, dst),
                          p_noc.route_max_utilization(cb, lb, src, dst))
    rho = rng.uniform(0, 1.2, size=20)
    assert np.array_equal(r_noc.contention_slowdown(rho, 50.0),
                          p_noc.contention_slowdown(rho, 50.0))


def test_noc_model_equal():
    a, b = r_noc.NocModel(r_noc.NocConfig()), p_noc.NocModel(p_noc.NocConfig())
    flows = [((0, 1), (1, 0), 0.4), ((3, 3), (1, 0), 0.5),
             ((2, 2), (0, 0), 0.3)]
    a.add_flows(r_noc.Flow(*f) for f in flows)
    b.add_flows(p_noc.Flow(*f) for f in flows)
    assert a.link_load == b.link_load
    assert a.max_utilization() == b.max_utilization()
    assert a.slowdown((3, 3), (1, 0)) == b.slowdown((3, 3), (1, 0))
    assert a.route_latency((3, 3), (1, 0)) == b.route_latency((3, 3), (1, 0))


# -------------------------------------------------------------- replication
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_replication_models_equal(k):
    assert r_area(1.0, 0.5, k) == p_area(1.0, 0.5, k)
    assert r_area(3e9, 2e8, k, model=8) == p_area(3e9, 2e8, k, model=8)
    assert r_gain(k) == p_gain(k)


# -------------------------------------------------------------------- flows
def test_compile_flows_equal():
    pos = np.asarray([[1, 5, 6, 7], [2, 3, 9, 14]])
    names = ("a", "b", "c", "d")
    for pattern in (None, dict(stages=(("a", "b"), ("c", "d")),
                               dests={"d": "a"}, demand={"a": 0.25})):
        fa = r_compile(REF.pm.SoCPerfModel(), names, pos,
                       None if pattern is None else RFlow(**pattern))
        fb = p_compile(PORT.pm.SoCPerfModel(), names, pos,
                       None if pattern is None else PFlow(**pattern))
        for f in ("dst_idx", "inc", "hop_counts", "stage_of", "exit_mask"):
            assert np.array_equal(getattr(fa, f), getattr(fb, f)), f
        assert np.array_equal(np.asarray(fa.demand), np.asarray(fb.demand))
        assert (fa.forward is None) == (fb.forward is None)
        if fa.forward is not None:
            assert np.array_equal(fa.forward, fb.forward)


# ------------------------------------------------------------------- traces
TRACES = {
    "constant": lambda m: m.constant_trace([100.0, 250.0, 40.0], 200, 3,
                                           dt=2e-3),
    "poisson": lambda m: m.poisson_trace(3000.0, 300, 3, dt=1e-3, seed=11),
    "diurnal": lambda m: m.diurnal_trace([900.0, 400.0, 100.0], 400, 3,
                                         dt=1e-3, depth=0.6, seed=12),
    "mmpp": lambda m: m.mmpp_trace(200.0, 2600.0, 350, 3, dt=1e-3, seed=13),
}


@pytest.mark.parametrize("kind", list(TRACES))
def test_seeded_traces_equal(kind):
    a, b = TRACES[kind](r_tr), TRACES[kind](p_tr)
    assert a.dt == b.dt
    assert np.array_equal(a.arrivals, b.arrivals)
    assert a.n_requests == b.n_requests and a.offered_rps == b.offered_rps


def test_batch_trace_equal():
    a, b = TRACES["diurnal"](r_tr), TRACES["diurnal"](p_tr)
    scale = np.asarray([0.5, 1.0, 1.5, 2.0])
    ba = r_tr.BatchTrace.broadcast(a, 4).scaled(scale)
    bb = p_tr.BatchTrace.broadcast(b, 4).scaled(scale)
    assert np.array_equal(ba.arrivals, bb.arrivals)
    assert np.array_equal(ba.n_requests, bb.n_requests)
    sa = r_tr.BatchTrace.stack([a, a.scaled(2.0)])
    sb = p_tr.BatchTrace.stack([b, b.scaled(2.0)])
    assert np.array_equal(sa.design(1).arrivals, sb.design(1).arrivals)
    assert np.array_equal(r_tr.superpose(a, a).arrivals,
                          p_tr.superpose(b, b).arrivals)
    assert np.array_equal(r_tr.with_total(a, 1e5).arrivals,
                          p_tr.with_total(b, 1e5).arrivals)
