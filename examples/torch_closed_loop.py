"""Closed-loop SoC simulation on the port: online DFS under a
million-request day (PyTorch, on the CUDA card by default).

The run-time half of the Vespa workflow, through ``repro_torch``.  A 16-tile
4x4 SoC (12 dfmul accelerator tiles with K=8, each its own frequency
island, + MEM/CPU/IO) serves a ~1M-request diurnal trace three ways:

1. fixed max frequency (the baseline every DFS paper compares against),
2. the Fig.-4 memory-bound policy: stream-bound islands drop their clock,
   a backpressure guard restores them if queues ever build,
3. the PID utilization tracker: rates servo the measured busy fraction.

Expected outcome (asserted): DFS cuts energy/request by >= 10% at matched
p99 latency.  ``--dse`` then re-ranks static Pareto survivors by simulated
runtime scores through the per-point sequential path.

With ``--pipeline`` the example instead builds a replicated-accelerator
pipeline SoC (3 front-end tiles chained into 3 back-end tiles via a
FlowPattern) and serves a hotspot diurnal trace (all external load on one
front-end replica) four ways — fixed, DFS-only, load-balancer-only, and
LB+DFS — asserting the scenario gate: LB+DFS achieves lower
energy/request than either policy alone at matched p99.

With ``--faults`` the pipeline platform loses a back-end replica for 800
ticks of a 2x diurnal surge under a 50 ms deadline, five ways — fixed and
DFS, each without and with recovery (respill through alive-masked splits),
and DFS with recovery routed by an online detector that never sees the
injected schedule — asserting the scenario gate: without recovery over 5 %
of requests drop, with it under 1 % at a bounded p99, and DFS still saves
energy.  ``--observe`` (the monitoring plane) is not ported yet and exits
with that refusal.

    python examples/torch_closed_loop.py                 # on the card
    python examples/torch_closed_loop.py --dse
    python examples/torch_closed_loop.py --pipeline
    python examples/torch_closed_loop.py --faults
    python examples/torch_closed_loop.py --device cpu    # the CPU instead
"""
import argparse
import os
import sys
from functools import partial

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.configs.vespa_soc import CHSTONE  # noqa: E402
from repro_torch.core.dfs import (PIDRatePolicy,  # noqa: E402
                                  policy_memory_bound)
from repro_torch.core.dse import closed_loop_score, grid_sweep  # noqa: E402
from repro_torch.core.perfmodel import (AccelWorkload,  # noqa: E402
                                        SoCPerfModel)
from repro_torch.runtime.fault import (SimFaultConfig,  # noqa: E402
                                       SimFaultSupervisor)
from repro_torch.sim import (ControllerHarness, FaultSchedule,  # noqa: E402
                             FlowPattern, LoadBalancer, SimConfig, SimEngine,
                             SimPlatform, SLOConfig, Trace, diurnal_trace,
                             with_total)

STAGE0 = ("fe0", "fe1", "fe2")
STAGE1 = ("be0", "be1", "be2")
NOT_PORTED = {
    "observe": "observer plane: observe= not ported yet (ROADMAP queue A "
               "item 9)"}


def build_platform() -> SimPlatform:
    """12 memory-bound dfmul tiles (K=8) fill the 4x4 grid around
    MEM(1,0)/CPU(0,0)/IO(0,3).  At K=8 the compute term is parallelized
    away, so every tile's service time is dominated by its serialized
    NoC/MEM stream path — the Fig.-4 stream-bound regime DFS exploits."""
    m = SoCPerfModel()
    pos = [(r, c) for r in range(4) for c in range(4)
           if (r, c) not in {(1, 0), (0, 0), (0, 3)}][:12]
    wls = [AccelWorkload("dfmul", 8.70, 1.1, replication=8) for _ in pos]
    return SimPlatform.build(m, wls, pos, noc_rate=1.0, n_tg=2,
                             req_mb=0.005)


def default_trace(plat, *, requests=1_000_000, ticks=8_700, dt=5e-3,
                  device=None) -> Trace:
    cap = SimEngine(plat, device=device).capacity_rps()
    return with_total(
        diurnal_trace(cap * 0.35, ticks, plat.n_tiles, dt=dt, depth=0.5,
                      seed=7),
        requests)


def controllers(plat):
    """name -> a fresh controller harness (None: fixed max frequency)."""
    return {
        "fixed-max": None,
        "dfs-membound": ControllerHarness(
            plat.islands,
            partial(policy_memory_bound, threshold=0.55, low_rate=0.5),
            queue_guard_ticks=3.0),
        "dfs-pid": ControllerHarness(
            plat.islands, PIDRatePolicy(target=0.7), queue_guard_ticks=3.0)}


def default_gate(runs) -> float:
    """The acceptance claim: >= 10% energy/request saving at matched p99
    (the memory-bound policy against fixed max frequency)."""
    base, mb = runs["fixed-max"], runs["dfs-membound"]
    saving = 1.0 - mb.energy_per_request_j / base.energy_per_request_j
    assert saving >= 0.10, f"energy saving {saving:.1%} < 10%"
    assert mb.p99_latency_s <= max(2.0 * base.p99_latency_s, 5e-3), (
        mb.p99_latency_s, base.p99_latency_s)
    assert mb.completed >= 0.99 * base.completed
    return saving


def pipeline_platform() -> SimPlatform:
    m = SoCPerfModel()
    pos = [(r, c) for r in range(4) for c in range(4)
           if (r, c) not in {(1, 0), (0, 0), (0, 3)}][:6]
    wls = [AccelWorkload("dfmul", 8.70, 1.1, replication=8) for _ in pos]
    return SimPlatform.build(
        m, wls, pos, names=STAGE0 + STAGE1, n_tg=2, req_mb=0.005,
        flows=FlowPattern.chain(STAGE0, STAGE1))


def hotspot_trace(ticks: int = 5000, seed: int = 11) -> Trace:
    """ALL external load lands on fe0 — the pathological skew a static
    placement cannot fix and a balancer trivially can."""
    rng = np.random.default_rng(seed)
    t = np.arange(ticks)
    lam = 13.0 * (1.0 + 0.4 * np.sin(2 * np.pi * t / ticks))
    ext = np.zeros((ticks, 6))
    ext[:, 0] = rng.poisson(lam)
    return Trace(ext, 1e-3)


def pipeline_runs(plat, tr, *, device=None):
    """fixed / DFS-only / LB-only / LB+DFS on the pipeline platform."""
    cfg = SimConfig(control_interval=25)

    def run(dfs: bool, lb: bool):
        ctl = (ControllerHarness(
            plat.islands, partial(policy_memory_bound, threshold=0.55,
                                  low_rate=0.5), queue_guard_ticks=3.0)
            if dfs else None)
        bal = LoadBalancer((STAGE0, STAGE1), plat.names) if lb else None
        return SimEngine(plat, config=cfg, controller=ctl, balancer=bal,
                         device=device).run(tr)

    return {"fixed": run(False, False), "dfs-only": run(True, False),
            "lb-only": run(False, True), "lb+dfs": run(True, True)}


def pipeline_gate(runs):
    """The scenario gate: jointly better than either policy alone."""
    both, dfs, lb = runs["lb+dfs"], runs["dfs-only"], runs["lb-only"]
    assert both.energy_per_request_j < 0.97 * dfs.energy_per_request_j
    assert both.energy_per_request_j < 0.97 * lb.energy_per_request_j
    assert both.p99_latency_s <= dfs.p99_latency_s
    assert both.p99_latency_s <= max(2.0 * lb.p99_latency_s, 5e-3)
    assert both.completed >= 0.99 * lb.completed
    return (1.0 - both.energy_per_request_j / dfs.energy_per_request_j,
            1.0 - both.energy_per_request_j / lb.energy_per_request_j)


def run_pipeline(device=None) -> None:
    plat = pipeline_platform()
    print(f"pipeline platform: {'+'.join(STAGE0)} -> {'+'.join(STAGE1)} "
          f"-> MEM on 4x4 (completions of a front-end tile feed the "
          f"back-end stage)")
    tr = hotspot_trace()
    print(f"trace: {tr.n_requests:,.0f} external requests over "
          f"{tr.duration_s:.1f}s sim, every one addressed to fe0\n")
    runs = pipeline_runs(plat, tr, device=device)
    for name, r in runs.items():
        print(f"{name:9s} {r.summary()}")
    sv_dfs, sv_lb = pipeline_gate(runs)
    print(f"\nlb+dfs energy/request: {sv_dfs:.1%} below dfs-only "
          f"(hotspot queueing collapse at p99 "
          f"{runs['dfs-only'].p99_latency_s * 1e3:.0f}ms), {sv_lb:.1%} "
          f"below lb-only (full-rate replicas)")
    print("acceptance: lb+dfs < dfs-only and < lb-only energy/request "
          "at matched p99 ✓")


def surge_trace(plat, ticks: int = 4000, *, device=None) -> Trace:
    """The front-end stage at 0.45 of its capacity on average, a diurnal
    day starting in the trough, so the 2x surge peaks mid-run."""
    cap = SimEngine(plat, device=device).capacity_rps()
    mean = np.zeros(6)
    mean[:3] = 0.45 * float(cap[:3].sum()) / 3.0
    return diurnal_trace(mean, ticks, 6, dt=1e-3, depth=1.0 / 3.0, seed=11,
                         phase=-np.pi / 2.0)


def kill_window(ticks: int):
    """be1 dies on [0.45 T, 0.65 T): the surge peak."""
    return int(0.45 * ticks), int(0.65 * ticks)


# name -> (recover, dfs, detect)
FAULT_RUNS = {"fixed,no-rec": (False, False, False),
              "fixed,recovery": (True, False, False),
              "dfs,no-rec": (False, True, False),
              "dfs,recovery": (True, True, False),
              "dfs,rec+detect": (True, True, True)}


def fault_run(plat, tr, *, recover: bool, dfs: bool = False,
              detect: bool = False, device=None):
    """One replay of the replica kill: ``(engine, result, supervisor)``.
    Without recovery stranded work is dropped; with it, respilled to the
    surviving replicas through the balancer (alive-masked splits)."""
    ks, ke = kill_window(tr.ticks)
    sched = FaultSchedule().kill_tile("be1", start=ks, end=ke)
    slo = (SLOConfig(deadline_s=0.05, on_kill="respill", max_retries=1)
           if recover else
           SLOConfig(deadline_s=0.05, on_kill="drop", max_retries=0))
    ctl = (ControllerHarness(
        plat.islands, partial(policy_memory_bound, threshold=0.55,
                              low_rate=0.5), queue_guard_ticks=3.0)
        if dfs else None)
    sup = (SimFaultSupervisor(SimFaultConfig(dead_ticks=3))
           if detect else None)
    eng = SimEngine(
        plat, config=SimConfig(control_interval=25), controller=ctl,
        faults=sched, slo=slo, supervisor=sup,
        balancer=LoadBalancer((STAGE0, STAGE1), plat.names, mode="even"),
        device=device)
    return eng, eng.run(tr), sup


def detection_tick(sup) -> int:
    """The tick of the supervisor's first ``detected_dead`` event."""
    return [e for e in sup.events if e["kind"] == "detected_dead"][0]["tick"]


def fault_gate(runs, tr) -> None:
    """The scenario gate: recovery turns a >5% outage into <1% drops at a
    bounded p99, with and without DFS in the loop (and with the detector
    routing it), and DFS with recovery still saves energy."""
    rate = {name: r.drop_rate for name, (_, r, _) in runs.items()}
    assert rate["fixed,no-rec"] > 0.05 and rate["dfs,no-rec"] > 0.05, rate
    assert rate["fixed,recovery"] < 0.01 and rate["dfs,recovery"] < 0.01, \
        rate
    assert rate["dfs,rec+detect"] < 0.01, rate
    assert runs["fixed,recovery"][1].p99_latency_s <= 0.05 + tr.dt
    assert runs["dfs,recovery"][1].energy_j < \
        runs["fixed,recovery"][1].energy_j


def run_faults(ticks: int = 4000, device=None) -> None:
    """Scenario gate: a back-end replica dies for 800 ticks of a 2x
    diurnal surge.  Without recovery the stranded share is dropped;
    respill + alive-masked splits absorb the failure, with or without DFS
    in the loop — and an online detector (never shown the injected
    schedule) finds the kill within a few ticks."""
    plat = pipeline_platform()
    tr = surge_trace(plat, ticks, device=device)
    ks, ke = kill_window(ticks)
    print(f"pipeline platform: {'+'.join(STAGE0)} -> {'+'.join(STAGE1)}; "
          f"be1 killed on ticks [{ks}, {ke}) — the 2x surge peak")
    print(f"trace: {tr.n_requests:,.0f} requests over {tr.duration_s:.1f}s "
          f"sim, 50ms deadline SLO\n")
    runs = {}
    for name, (recover, dfs, detect) in FAULT_RUNS.items():
        runs[name] = fault_run(plat, tr, recover=recover, dfs=dfs,
                               detect=detect, device=device)
        r = runs[name][1]
        print(f"{name:16s} drop={r.drop_rate:6.2%} "
              f"(slo={r.dropped_slo:,.0f} fault={r.dropped_fault:,.0f}) "
              f"retried={r.retried:,.0f} p99={r.p99_latency_s * 1e3:.1f}ms "
              f"E/req={r.energy_per_request_j * 1e3:.2f}mJ")
    tick = detection_tick(runs["dfs,rec+detect"][2])
    print(f"\nonline detector: kill at tick {ks}, detected at tick "
          f"{tick} (latency {tick - ks} ticks)")
    fault_gate(runs, tr)
    print("acceptance: replica kill mid-surge survives with <1% drops at "
          "bounded p99, DFS still saving energy ✓")


def dse_score(plat_model, *, device=None, top: int = 6, ticks: int = 2000):
    """Re-rank the ``top`` static survivors over a ``ticks``-tick diurnal
    trace through the per-point sequential path (one SimEngine per
    survivor, a PID harness each)."""
    wls = [AccelWorkload("dfadd", *CHSTONE["dfadd"]),
           AccelWorkload("dfmul", *CHSTONE["dfmul"])]
    res = grid_sweep(plat_model, wls, ks=(1, 2, 4, 8),
                     acc_rates=(0.2, 0.6, 1.0), noc_rates=(0.5, 1.0),
                     n_tg=2, device=device)
    tr = diurnal_trace(3000.0, ticks, 2, dt=1e-3, depth=0.5, seed=9)
    score = closed_loop_score(
        res, tr, model=plat_model, top=top, p99_sla_s=0.02, req_mb=0.002,
        controller_factory=lambda p: ControllerHarness(
            p.islands, PIDRatePolicy(), queue_guard_ticks=3.0),
        device=device)
    return res, score


def run_dse(plat_model, device=None) -> None:
    print("\n--- DSE bridge: re-rank static survivors by simulation ---")
    res, score = dse_score(plat_model, device=device)
    print(f"swept {len(res):,} static points; simulated top "
          f"{score.indices.shape[0]} Pareto survivors:")
    for rank, j in enumerate(score.order):
        dp = res.design_point(int(score.indices[j]))
        print(f"  #{rank + 1} K={dp.replication} "
              f"pos={dp.placement} rates={dp.rates} "
              f"p99={score.p99_latency_s[j] * 1e3:.1f}ms "
              f"E/req={score.energy_per_request_j[j] * 1e3:.2f}mJ")
    best = res.design_point(int(score.ranked_indices()[0]))
    print(f"closed-loop winner: K={best.replication} "
          f"pos={best.placement} (static thr {best.throughput:.2f})")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=1_000_000)
    ap.add_argument("--ticks", type=int, default=8_700)
    ap.add_argument("--dt", type=float, default=5e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--dse", action="store_true",
                    help="also re-rank grid_sweep survivors by simulation")
    ap.add_argument("--pipeline", action="store_true",
                    help="run the replicated-accelerator pipeline scenario "
                         "(FlowPattern chain + LoadBalancer + DFS)")
    ap.add_argument("--faults", action="store_true",
                    help="run the fault-injection scenario (replica kill "
                         "mid-surge + SLO deadline + respill recovery)")
    ap.add_argument("--observe", action="store_true",
                    help="the monitoring plane (not ported yet: refused)")
    args = ap.parse_args()

    if args.observe:
        raise SystemExit(NOT_PORTED["observe"])
    if args.faults:
        run_faults(device=args.device)
        return
    if args.pipeline:
        run_pipeline(args.device)
        return

    plat = build_platform()
    cap = SimEngine(plat, device=args.device).capacity_rps()
    print(f"platform: {plat.n_tiles} accel tiles on 4x4, "
          f"{cap.sum():,.0f} req/s capacity at max rates")
    trace = default_trace(plat, requests=args.requests, ticks=args.ticks,
                          dt=args.dt, device=args.device)
    print(f"trace: {trace.n_requests:,.0f} requests over "
          f"{trace.duration_s:.0f}s sim (diurnal, mean util "
          f"{trace.offered_rps / cap.sum():.2f})\n")

    cfg = SimConfig(control_interval=25)
    runs = {}
    for name, ctl in controllers(plat).items():
        r = SimEngine(plat, config=cfg, controller=ctl,
                      device=args.device).run(trace)
        runs[name] = r
        print(f"{name:14s} {r.summary()}")
        print(f"{'':14s} telemetry: {r.telemetry.summary()}")

    base = runs["fixed-max"]
    print()
    for name in ("dfs-membound", "dfs-pid"):
        r = runs[name]
        saving = 1.0 - r.energy_per_request_j / base.energy_per_request_j
        print(f"{name}: {saving:.1%} energy/request saving, "
              f"p99 {r.p99_latency_s * 1e3:.1f}ms "
              f"vs fixed {base.p99_latency_s * 1e3:.1f}ms, "
              f"{r.swaps} hitless swaps")
    default_gate(runs)
    print("\nacceptance: >=10% energy/request saving at matched p99 ✓")

    if args.dse:
        run_dse(plat.model, args.device)


if __name__ == "__main__":
    main()
