"""Shared helpers of the ``test_torch_*`` differential tests.

Every test hands the SAME inputs (made with NumPy from a seed) to the
reference package ``repro`` and to the port ``repro_torch`` and compares
outputs.  ``REF`` and ``PORT`` bundle the two packages' counterparts so a
helper written once serves both sides.
"""
import importlib.util
import os
from types import SimpleNamespace

import numpy as np

import repro.core.dfs as ref_dfs
import repro.core.dse as ref_dse
import repro.core.perfmodel as ref_pm
import repro.sim as ref_sim
import repro_torch.core.dfs as port_dfs
import repro_torch.core.dse as port_dse
import repro_torch.core.perfmodel as port_pm
import repro_torch.sim as port_sim

REF = SimpleNamespace(name="repro", sim=ref_sim, dfs=ref_dfs, pm=ref_pm,
                      dse=ref_dse)
PORT = SimpleNamespace(name="repro_torch", sim=port_sim, dfs=port_dfs,
                       pm=port_pm, dse=port_dse)

POLICIES = ("open", "guard", "membound", "pid", "ewma")


def chip_smoke():
    """``chip_smoke.py`` (the repository root's) as a module: its checks,
    planted faults and the card cases of the gpu-marked tests."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_policy(pkg, key):
    """A fresh policy object (stateful policies must not be shared between
    runs: their state would leak from one backend's run into the next)."""
    if key in ("open", "guard"):
        return None
    if key == "membound":
        return pkg.dfs.BatchMemoryBoundPolicy(threshold=0.5, low_rate=0.3)
    if key == "pid":
        return pkg.dfs.BatchPIDRatePolicy(target=0.7)
    if key == "ewma":
        return pkg.dfs.BatchEWMAUtilizationPolicy(alpha=0.4, target=0.65)
    raise ValueError(key)


def make_platform(pkg, n_tiles=4, *, k=8, req_mb=0.005, noc_rate=1.0,
                  n_tg=2, flows=None):
    """The dfmul platform of the reference's batched-simulation tests."""
    m = pkg.pm.SoCPerfModel()
    pos = [(r, c) for r in range(4) for c in range(4)
           if (r, c) not in {(1, 0), (0, 0), (0, 3)}][:n_tiles]
    wls = [pkg.pm.AccelWorkload("dfmul", 8.70, 1.1, replication=k)
           for _ in pos]
    return pkg.sim.SimPlatform.build(m, wls, pos, noc_rate=noc_rate,
                                     n_tg=n_tg, req_mb=req_mb, flows=flows)


def chain_flows(pkg, n_tiles=4):
    half = n_tiles // 2
    names = [f"dfmul{i}" for i in range(n_tiles)]
    return pkg.sim.FlowPattern.chain(tuple(names[:half]),
                                     tuple(names[half:]),
                                     demand={names[0]: 0.3})


def make_engine(pkg, backend, policy, *, ks=(2, 4, 8), n_tiles=4, ci=25,
                tech=None, max_queue=float("inf"), chain=False, **kw):
    """Fresh platform + controller + engine (rates and policy state mutate in
    place during a run).  ``policy`` is a key of :data:`POLICIES`."""
    flows = chain_flows(pkg, n_tiles) if chain else None
    bplat = pkg.sim.BatchSimPlatform.stack(
        [make_platform(pkg, n_tiles, k=k, flows=flows) for k in ks])
    ctl = None
    if policy != "open":
        ctl = pkg.sim.BatchControllerHarness(
            bplat.islands, bplat.rates, make_policy(pkg, policy),
            tile_names=bplat.names, queue_guard_ticks=3.0)
    if pkg is PORT:
        kw.setdefault("device", "cpu")
    cfg = pkg.sim.SimConfig(control_interval=ci, max_queue=max_queue)
    return pkg.sim.BatchSimEngine(bplat, config=cfg, controller=ctl,
                                  backend=backend, tech=tech, **kw)


def capacity(n_tiles=4, k=2):
    """(A,) capacity of the k=2 platform, from the reference package."""
    return ref_sim.SimEngine(make_platform(REF, n_tiles, k=k)).capacity_rps()


def make_trace(pkg, kind, cap, ticks=300, seed=3):
    n = cap.shape[0]
    s = pkg.sim
    if kind == "constant":
        return s.constant_trace(cap * 0.6, ticks, n, dt=1e-3)
    if kind == "poisson":
        return s.poisson_trace(float(cap.sum()) * 0.5, ticks, n, dt=1e-3,
                               seed=seed)
    if kind == "diurnal":
        return s.diurnal_trace(cap * 0.4, ticks, n, dt=1e-3, depth=0.5,
                               seed=seed)
    if kind == "mmpp":
        return s.mmpp_trace(cap * 0.1, cap * 1.3, ticks, n, dt=1e-3,
                            seed=seed)
    raise ValueError(kind)


def rel_err(a, b):
    """Max relative error of ``a`` against ``b`` (NaNs must coincide)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(b)
    if not ok.any():
        return 0.0
    return float(np.max(np.abs(a[ok] - b[ok])
                        / np.maximum(np.abs(b[ok]), 1e-300)))


# ---- reading reference objects into the plain dicts convert.py takes ------

def model_dict(m):
    noc = m.noc
    return {"noc": {"rows": noc.rows, "cols": noc.cols, "torus": noc.torus,
                    "link_bw": noc.link_bw, "hop_latency": noc.hop_latency,
                    "max_slowdown": noc.max_slowdown},
            "mem_pos": tuple(m.mem_pos), "mem_service": m.mem_service,
            "tg_demand": m.tg_demand, "tg_demand_fig4": m.tg_demand_fig4,
            "own_demand": m.own_demand,
            "hop_latency_share": m.hop_latency_share}


def platform_dict(bp):
    """A reference ``BatchSimPlatform`` as NumPy arrays and plain values."""
    d = {"model": model_dict(bp.model), "names": tuple(bp.names),
         "islands": [{"name": i.name, "tiles": tuple(i.tiles),
                      "ladder": (i.ladder.f_min_mhz, i.ladder.f_max_mhz,
                                 i.ladder.f_step_mhz),
                      "rate": i.rate, "fixed": i.fixed}
                     for i in bp.islands.islands],
         "version": bp.islands.version, "n_tg": bp.n_tg,
         "flows": None}
    for key in ("base_mbps", "wire_share", "k", "pos_idx", "req_mb",
                "rates", "f_tg"):
        d[key] = np.array(getattr(bp, key))
    if bp.flows is not None:
        d["flows"] = {"stages": bp.flows.stages, "dests": bp.flows.dests,
                      "demand": bp.flows.demand}
    return d


def sweep_dict(res):
    d = {"axes": [(n, v) for n, v in res.axes], "shape": res.shape,
         "workloads": [(w.name, w.base_mbps, w.ai) for w in res.workloads],
         "n_tg": res.n_tg, "elapsed_s": res.elapsed_s,
         "backend": res.backend}
    for key in ("throughput", "area", "energy_per_unit", "mem_traffic",
                "valid"):
        d[key] = np.array(getattr(res, key))
    return d


def controller_dict(ctl):
    pol = ctl.policy
    return {"rates": np.array(ctl.rates),
            "guard_active": np.array(ctl._guard_active),
            "swaps": np.array(ctl.swaps), "versions": np.array(ctl.versions),
            "integral": getattr(pol, "_integral", None),
            "prev_err": getattr(pol, "_prev_err", None),
            "ewma": getattr(pol, "_ewma", None)}
