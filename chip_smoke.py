#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --quick    # device, build, kernel parity only

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, and drives the port's
main path through its public entry points at the size its users run:

1. ``device``    — the card (``nvidia-smi``), torch / CUDA versions.
2. ``build``     — compiles ``src/repro_torch/kernels/csrc/*.cu`` into
                   ``build/``; seconds.
3. ``kernels``   — ``fused_tick_sim`` (kernel) vs ``fused_tick_sim_plain``
                   over the control kinds and options at small shapes with
                   ragged batch sizes; floats rtol/atol 1e-4, swaps and guard
                   exact.
4. ``sweep``     — the dense 1.73 M-point joint sweep on the card, checked
                   against the host NumPy float64 evaluation of the same grid
                   (objectives <= 1e-9 rel, same Pareto set).
5. ``main_path`` — ``closed_loop_score`` on the sweep's top 4,096 survivors,
                   an 8,700-tick diurnal trace, PID controllers in the loop,
                   ``backend="fused"``; again under the 45 nm tech model; a
                   64-design cross-check against the float64 ``"torch"``
                   backend; the kernel against its plain version at exactly
                   these shapes, with times.
6. ``main_path_a12`` — 1,024 stacked twelve-tile platforms with a two-stage
                   chain and memory-bound DFS, 5,000 ticks, ``"fused"``; the
                   kernel against its plain version at these shapes.

Each phase prints one JSON line.  The line before the last but one is
``{"kernels": [...]}`` with, per kernel, its launches on the main path, its
error against the plain version, its time, the plain version's time and the
least time the card could take for the same work (larger of bytes over
3.35 TB/s and float32 operations over 67 TFLOP/s, published H100 SXM peaks).
The last line is ``{"ok": true, "device": {...}}``.  Any failure exits with
a non-zero code; without a CUDA device the script stops at once.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

H100_BYTES_PER_S = 3.35e12      # HBM3, published (H100 SXM)
H100_FP32_PER_S = 67e12         # float32 outside the tensor cores, published
RTOL = ATOL = 1e-4              # kernel vs plain version (same float32 math)
SEED = 1234

SIZES = {"kernel_T": 500, "kernel_big_B": 1000,
         "main_B": 4096, "main_T": 8700, "check_T": 2000,
         "a12_B": 1024, "a12_T": 5000, "reps": 5}


def sync() -> None:
    torch.cuda.synchronize()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return out.splitlines()[0] if out else "unknown, unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown, unknown"


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------------

FLOAT_KEYS = ("adm", "served", "queue", "busy", "rtt", "rates", "dropped",
              "energy")


def compare_outputs(out_k, out_p):
    """Max abs / rel error over the float outputs, count of designs whose
    integer outputs (swaps, guard) differ, and whether floats are within
    tolerance."""
    max_abs = max_rel = 0.0
    ok = True
    pairs = [(out_k[n], out_p[n]) for n in FLOAT_KEYS]
    pairs += [(a, b) for a, b in zip(out_k["pol"], out_p["pol"])
              if a.dtype.is_floating_point]
    for a, b in pairs:
        a64, b64 = a.double(), b.double()
        if not bool(torch.isfinite(a64).all()):
            ok = False
        diff = (a64 - b64).abs()
        if diff.numel():
            max_abs = max(max_abs, float(diff.max()))
            max_rel = max(max_rel, float(
                (diff / b64.abs().clamp(min=1e-30))[b64.abs() > ATOL]
                .max()) if bool((b64.abs() > ATOL).any()) else 0.0)
            ok = ok and bool((diff <= ATOL + RTOL * b64.abs()).all())
    swaps_bad = int((out_k["swaps"] != out_p["swaps"]).sum())
    guard_bad = int((out_k["guard"] != out_p["guard"]).any(dim=-1).sum())
    flags_bad = sum(int((a != b).sum())
                    for a, b in zip(out_k["pol"], out_p["pol"])
                    if a.dtype == torch.bool)
    return {"max_abs_err": max_abs, "max_rel_err": max_rel,
            "floats_ok": ok, "swaps_mismatch": swaps_bad,
            "guard_mismatch": guard_bad, "flag_mismatch": flags_bad}


def twelve_tile_platforms(n, *, rng, flows=None):
    """``n`` twelve-tile platforms: fixed placement, K in {1,2,4,8}, mixed
    NoC rates (the layout of the reference's batched-simulation tests)."""
    from repro_torch.core.perfmodel import AccelWorkload, SoCPerfModel
    from repro_torch.sim.engine import SimPlatform
    model = SoCPerfModel()
    pos = [(r, c) for r in range(4) for c in range(4)
           if (r, c) not in {(1, 0), (0, 0), (0, 3)}][:12]
    plats = []
    for _ in range(n):
        k = int(rng.choice([1, 2, 4, 8]))
        wls = [AccelWorkload("dfmul", 8.70, 1.1, replication=k) for _ in pos]
        plats.append(SimPlatform.build(
            model, wls, pos, noc_rate=float(rng.choice([0.5, 0.75, 1.0])),
            n_tg=2, req_mb=0.005, flows=flows))
    return plats


def two_tile_platforms(n, *, rng):
    from repro_torch.core.perfmodel import AccelWorkload, SoCPerfModel
    from repro_torch.sim.engine import SimPlatform
    model = SoCPerfModel()
    spots = [(r, c) for r in range(4) for c in range(4) if (r, c) != (1, 0)]
    plats = []
    for _ in range(n):
        i, j = rng.choice(len(spots), size=2, replace=False)
        wls = [AccelWorkload("dfsin", 0.33, 60.0,
                             replication=int(rng.choice([1, 2, 4]))),
               AccelWorkload("gsm", 4.61, 12.0,
                             replication=int(rng.choice([1, 2, 4])))]
        plats.append(SimPlatform.build(
            model, wls, [spots[i], spots[j]], names=["dfsin", "gsm"],
            rates={"dfsin": float(rng.choice([0.4, 0.8, 1.0])),
                   "gsm": float(rng.choice([0.4, 0.8, 1.0]))},
            noc_rate=float(rng.choice([0.5, 1.0])), n_tg=4, req_mb=0.002))
    return plats


def make_policy(kind):
    from repro_torch.core.dfs import (BatchEWMAUtilizationPolicy,
                                      BatchMemoryBoundPolicy,
                                      BatchPIDRatePolicy)
    return {"none": None, "guard": None,
            "membound": BatchMemoryBoundPolicy(threshold=0.5, low_rate=0.3),
            "pid": BatchPIDRatePolicy(target=0.7),
            "ewma": BatchEWMAUtilizationPolicy(alpha=0.4, target=0.65),
            }[kind]


def make_engine(plats, kind, *, tech=None, max_queue=float("inf"), ci=25,
                backend="fused", guard=3.0):
    from repro_torch.sim.batch import BatchSimEngine, BatchSimPlatform
    from repro_torch.sim.control import BatchControllerHarness
    from repro_torch.sim.engine import SimConfig
    bp = BatchSimPlatform.stack(plats)
    ctl = None
    if kind != "none":
        ctl = BatchControllerHarness(bp.islands, bp.rates, make_policy(kind),
                                     tile_names=bp.names,
                                     queue_guard_ticks=guard)
    return BatchSimEngine(
        bp, config=SimConfig(control_interval=ci, max_queue=max_queue),
        controller=ctl, backend=backend, tech=tech)


def kernel_vs_plain(engine, trace):
    """Run the kernel and its plain version on the inputs the engine packs
    for this trace; returns (comparison, inputs)."""
    from repro_torch.kernels.tick_sim import (fused_tick_sim,
                                              fused_tick_sim_plain)
    arr, consts, scalars, init, plan, _ = engine.fused_inputs(trace)
    out_k = fused_tick_sim(arr, consts, scalars, init, plan=plan)
    sync()
    out_p = fused_tick_sim_plain(arr, consts, scalars, init, plan=plan)
    sync()
    return compare_outputs(out_k, out_p), (arr, consts, scalars, init, plan)


def phase_kernels():
    from repro_torch.sim.flows import FlowPattern
    from repro_torch.sim.traffic import BatchTrace, diurnal_trace, mmpp_trace
    rng = np.random.default_rng(SEED)
    chain = FlowPattern.chain(("dfmul0", "dfmul1", "dfmul2"),
                              ("dfmul3", "dfmul4", "dfmul5"),
                              demand={"dfmul0": 0.3, "dfmul7": 0.05})
    cases = []
    T = SIZES["kernel_T"]
    big = SIZES["kernel_big_B"]
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    bad = []
    for A, B in ((2, 1), (2, 67), (12, 67), (12, big), (2, big)):
        for kind in ("none", "guard", "membound", "pid", "ewma"):
            for variant in ("base", "maxq", "tech", "flows"):
                if variant == "flows" and A != 12:
                    continue
                if B == big and variant not in ("base", "flows"):
                    continue
                flows = chain if variant == "flows" else None
                plats = (twelve_tile_platforms(B, rng=rng, flows=flows)
                         if A == 12 else two_tile_platforms(B, rng=rng))
                eng = make_engine(
                    plats, kind,
                    tech=(16, "cons") if variant == "tech" else None,
                    max_queue=4.0 if variant == "maxq" else float("inf"))
                cap = eng.capacity_rps().mean(axis=0)
                if variant == "maxq":
                    tr = mmpp_trace(cap * 0.2, cap * 1.5, T, A, dt=1e-3,
                                    seed=SEED)
                else:
                    tr = diurnal_trace(cap * 0.6, T, A, dt=1e-3, depth=0.6,
                                       seed=SEED)
                if B == 67 and variant == "base":
                    # per-design (T, B, A) arrivals: the non-shared read path
                    scale = rng.uniform(0.5, 1.5, size=B)
                    tr = BatchTrace.broadcast(tr, B).scaled(scale)
                cmp, _ = kernel_vs_plain(eng, tr)
                case = dict(A=A, B=B, kind=kind, variant=variant, **cmp)
                cases.append(case)
                for key in worst:
                    worst[key] = max(worst[key], cmp[key])
                if (not cmp["floats_ok"] or cmp["swaps_mismatch"]
                        or cmp["guard_mismatch"] or cmp["flag_mismatch"]):
                    bad.append(case)
    emit({"phase": "kernels", "cases": len(cases), "failed": len(bad),
          "T": T, "rtol": RTOL, "atol": ATOL, **worst,
          "first_failures": bad[:5]})
    if bad:
        raise SystemExit("kernel disagrees with its plain version")
    return worst


# ---------------------------------------------------------------------------
# bound
# ---------------------------------------------------------------------------


def tick_sim_bound(arr, consts, scalars, init, plan):
    """Least milliseconds an H100 could take for one ``fused_tick_sim`` call
    on these inputs: bytes (every input read once, every output written
    once) over the memory rate, and float32 operations over the float32
    peak; returns (ms, "bytes" | "operations", bytes, operations)."""
    T = arr.shape[0]
    B, A = consts["base"].shape
    L = consts["inc"].shape[-1]
    I = init["rates"].shape[1]
    n_in = arr.numel() + sum(v.numel() for v in consts.values()) \
        + init["rates"].numel() + sum(p.numel() for p in init["pol"])
    byts = 4 * n_in + init["guard"].numel()
    byts += 4 * (2 * T * B * A + 3 * B * A + B * I + 3 * B) + B * I
    byts += 4 * sum(p.numel() for p in init["pol"])
    # per tile per tick: admit (3), capacity (7), serve (4), rtt (2), energy
    # (4), window (1) ~ 21, drops (3) when bounded, forwarding (2 A) when
    # chained
    per_tile = 21.0
    if float(scalars["max_q"]) != float("inf"):
        per_tile += 3
    if scalars.get("forward") is not None:
        per_tile += 2 * A
    ops = T * B * A * per_tile
    if scalars["dyn_on"]:
        # contention, from this run's incidence: per tile the demand product
        # and the slowdown (7), and for each link of its own route one add
        # per tile whose route shares the link plus one max
        on = (consts["inc"] > 0.5).double()                    # (B, A, L)
        sharers = on.sum(dim=1, keepdim=True)                  # (B, 1, L)
        walk = float((on * (sharers + 1.0)).sum())
        ops += T * (7.0 * B * A + walk)
    ci = int(scalars["ci"])
    if plan.kind != "none" and ci:
        lmax = np.asarray(plan.levels).shape[1]
        ops += (T // ci) * B * (I * (5 * A + 3 * lmax + 16) + 6 * A)
    t_bytes = byts / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", byts, ops)


def time_kernel_and_plain(inputs):
    from repro_torch.kernels.tick_sim import (fused_tick_sim,
                                              fused_tick_sim_plain)
    arr, consts, scalars, init, plan = inputs
    fused_tick_sim(arr, consts, scalars, init, plan=plan)      # warm
    ms = cuda_ms(lambda: fused_tick_sim(arr, consts, scalars, init,
                                        plan=plan), SIZES["reps"])
    plain_ms = cuda_ms(lambda: fused_tick_sim_plain(arr, consts, scalars,
                                                    init, plan=plan), 1)
    bound_ms, bound_by, byts, ops = tick_sim_bound(arr, consts, scalars,
                                                   init, plan)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": byts, "operations": ops}


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------


def phase_sweep():
    from repro_torch.configs.vespa_soc import CHSTONE
    from repro_torch.core.dse import grid_sweep
    from repro_torch.core.islands import NOC_LADDER, TILE_LADDER
    from repro_torch.core.perfmodel import AccelWorkload, SoCPerfModel
    model = SoCPerfModel()
    wls = [AccelWorkload("dfsin", *CHSTONE["dfsin"]),
           AccelWorkload("gsm", *CHSTONE["gsm"])]
    axes = dict(ks=(1, 2, 4), acc_rates=TILE_LADDER.levels(),
                noc_rates=NOC_LADDER.levels(),
                tg_rates=TILE_LADDER.levels()[::2], n_tg=4)
    on_card = dict(device=None, backend="torch")        # device=None: card
    grid_sweep(model, wls, **axes, **on_card)           # warm the card
    sync()
    t0 = time.perf_counter()
    res = grid_sweep(model, wls, **axes, **on_card)
    sync()
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = grid_sweep(model, wls, device="cpu", **axes)  # host NumPy f64
    host_s = time.perf_counter() - t0

    worst = 0.0
    for name in ("throughput", "area", "energy_per_unit", "mem_traffic"):
        a, b = getattr(res, name), getattr(ref, name)
        worst = max(worst, float(np.max(np.abs(a - b)
                                        / np.maximum(np.abs(b), 1e-300))))
    valid_same = bool(np.array_equal(res.valid, ref.valid))
    t0 = time.perf_counter()
    pf_dev = res.pareto_indices()
    pareto_s = time.perf_counter() - t0
    pf_ref = ref.pareto_indices()
    sym = np.setxor1d(pf_dev, pf_ref)
    gap = 0.0
    if sym.size:
        # a last-ulp tie may fall differently; it is a fault only when the
        # objectives of an offending point differ by more than the tolerance
        for name in ("throughput", "energy_per_unit"):
            a, b = getattr(res, name)[sym], getattr(ref, name)[sym]
            gap = max(gap, float(np.max(np.abs(a - b)
                                        / np.maximum(np.abs(b), 1e-300))))
    out = {"phase": "sweep", "points": len(res), "valid": res.n_valid,
           "device_s": dev_s, "points_per_s": len(res) / dev_s,
           "host_numpy_s": host_s, "max_rel_err": worst,
           "valid_equal": valid_same, "pareto_size": int(pf_dev.size),
           "pareto_symdiff": int(sym.size), "pareto_gap": gap,
           "pareto_host_s": pareto_s, "backend": res.backend}
    emit(out)
    if worst > 1e-9 or not valid_same or (sym.size and gap > 1e-9):
        raise SystemExit("sweep on the card disagrees with the host")
    return model, res, out


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def pid_factory(guard=3.0):
    from repro_torch.core.dfs import BatchPIDRatePolicy
    from repro_torch.sim.control import BatchControllerHarness

    def factory(platform):
        return BatchControllerHarness(
            platform.islands, platform.rates, BatchPIDRatePolicy(),
            tile_names=platform.names, queue_guard_ticks=guard)
    return factory


def check_result(r, label, *, chained=False):
    """Finite, and work conserved: offered = completed + dropped + residual
    (under a chain the forward carry in flight is not in any queue, so the
    chained check only reports the gap)."""
    for name in ("completed", "dropped", "residual", "energy_j",
                 "throughput_rps"):
        if not np.all(np.isfinite(getattr(r, name))):
            raise SystemExit(f"{label}: non-finite {name}")
    if not np.all(np.isfinite(r.p99_latency_s[r.completed > 0])):
        raise SystemExit(f"{label}: non-finite p99")
    total = r.completed + r.dropped + r.residual
    off = np.asarray(r.offered, dtype=np.float64)
    err = float(np.max(np.abs(total - off) / np.maximum(off, 1e-9)))
    if not chained and err > 1e-3:
        raise SystemExit(f"{label}: work not conserved (rel {err:.3e})")
    return err


def kernel_failed(cmp) -> bool:
    return bool(not cmp["floats_ok"] or cmp["swaps_mismatch"]
                or cmp["guard_mismatch"] or cmp["flag_mismatch"])


def drive_main_path(model, res):
    """The port's main path through its public entry point:
    ``closed_loop_score`` on the sweep's survivors, linear then 45 nm."""
    from repro_torch.core.dse import closed_loop_score
    from repro_torch.kernels.tick_sim import fused_tick_sim
    from repro_torch.sim.batch import BatchSimEngine, BatchSimPlatform
    from repro_torch.sim.engine import SimConfig
    from repro_torch.sim.traffic import diurnal_trace

    B, T, dt, req_mb = SIZES["main_B"], SIZES["main_T"], 1e-3, 0.002
    survivors = np.resize(res.topk_indices(B), B)
    cfg = SimConfig(control_interval=50)
    plat = BatchSimPlatform.from_design_points(model, res, survivors,
                                               req_mb=req_mb)
    cap = BatchSimEngine(plat, config=cfg,
                         ).capacity_rps().mean(axis=0)
    trace = diurnal_trace(cap * 0.35, T, 2, dt=dt, depth=0.5, seed=SEED)

    report = {"phase": "main_path", "B": B, "T": T, "A": 2}
    for label, tech in (("linear", None), ("tech45", 45)):
        before = fused_tick_sim.launches
        t0 = time.perf_counter()
        score = closed_loop_score(
            res, trace, model=model, indices=survivors, req_mb=req_mb,
            sim_config=cfg, batch_controller_factory=pid_factory(),
            backend="fused", tech=tech)
        sync()
        wall = time.perf_counter() - t0
        if fused_tick_sim.launches != before + 1:
            raise SystemExit("closed_loop_score did not launch the kernel "
                             "exactly once")
        r = score.results[0]
        cons = check_result(r, f"main_path[{label}]")
        report[label] = {
            "wall_s": wall, "survivors_per_s": B / wall,
            "kernel_ms": r.timings["loop"] * 1e3,
            "percentiles_ms": r.timings["percentiles"] * 1e3,
            "copies_ms": r.timings["copies"] * 1e3,
            "conservation_rel_err": cons,
            "swaps_total": int(r.swaps.sum()),
            "p99_ms_range": [float(np.nanmin(r.p99_latency_s)) * 1e3,
                             float(np.nanmax(r.p99_latency_s)) * 1e3],
            "best_index": int(score.ranked_indices()[0])}
    ctx = dict(model=model, res=res, survivors=survivors, cfg=cfg, plat=plat,
               cap=cap, trace=trace, dt=dt, req_mb=req_mb)
    return report, ctx


def verify_main_path(report, ctx):
    """After the drive: the 64-design cross-check against the float64 tick
    loop, and the kernel against its plain version at the drive's shapes."""
    from repro_torch.core.dse import closed_loop_score
    from repro_torch.sim.batch import BatchSimEngine
    from repro_torch.sim.traffic import diurnal_trace
    model, res, cfg, plat = ctx["model"], ctx["res"], ctx["cfg"], ctx["plat"]
    survivors, dt, req_mb = ctx["survivors"], ctx["dt"], ctx["req_mb"]

    # shortened trace: the float64 loop launches ~100 kernels per tick
    sub = survivors[:: max(1, len(survivors) // 64)][:64]
    short = diurnal_trace(ctx["cap"] * 0.35, SIZES["check_T"], 2, dt=dt,
                          depth=0.5, seed=SEED)
    pair = {}
    for backend in ("fused", "torch"):
        t0 = time.perf_counter()
        pair[backend] = closed_loop_score(
            res, short, model=model, indices=sub, req_mb=req_mb,
            sim_config=cfg, batch_controller_factory=pid_factory(),
            backend=backend)
        sync()
        report[f"check64_{backend}_s"] = time.perf_counter() - t0
    f, t = pair["fused"], pair["torch"]
    rel = 0.0
    for name in ("energy_per_request_j", "throughput_rps"):
        a, b = getattr(f, name), getattr(t, name)
        rel = max(rel, float(np.max(np.abs(a - b)
                                    / np.maximum(np.abs(b), 1e-300))))
    p99_abs = float(np.max(np.abs(f.p99_latency_s - t.p99_latency_s)))
    same_rank = bool(np.array_equal(f.ranked_indices(), t.ranked_indices()))
    # where the orders differ, the float64 scores taken in the fused order
    # must still be sorted within the tolerance (near-ties may swap)
    e_in_f_order = t.energy_per_request_j[f.order]
    tie_ok = bool(np.all(np.diff(e_in_f_order)
                         >= -2e-3 * np.abs(e_in_f_order[:-1])))
    swaps_same = bool(np.array_equal(f.results[0].swaps, t.results[0].swaps))
    report.update(check64_T=SIZES["check_T"], check64_max_rel=rel,
                  check64_p99_abs_s=p99_abs, check64_same_ranking=same_rank,
                  check64_ranking_within_ties=tie_ok,
                  check64_swaps_equal=swaps_same)
    if rel > 2e-3 or p99_abs > 2 * dt or not (same_rank or tie_ok):
        emit(report)
        raise SystemExit("fused and float64 backends disagree on the "
                         "64-design subset")

    shapes = {}
    for label, tech in (("linear", None), ("tech45", 45)):
        eng = BatchSimEngine(plat, config=cfg,
                             controller=pid_factory()(plat),
                             backend="fused", tech=tech)
        cmp, inputs = kernel_vs_plain(eng, ctx["trace"])
        shapes[label] = {**cmp, **(time_kernel_and_plain(inputs)
                                   if label == "linear" else {})}
        if kernel_failed(cmp):
            emit({**report, "kernel_vs_plain": shapes})
            raise SystemExit("kernel disagrees with its plain version at "
                             "the main path's shapes")
    report["kernel_vs_plain"] = shapes
    emit(report)
    return report


def a12_engine(plat, cfg):
    from repro_torch.core.dfs import BatchMemoryBoundPolicy
    from repro_torch.sim.batch import BatchSimEngine
    from repro_torch.sim.control import BatchControllerHarness
    ctl = BatchControllerHarness(
        plat.islands, plat.rates,
        BatchMemoryBoundPolicy(threshold=0.5, low_rate=0.3),
        tile_names=plat.names, queue_guard_ticks=3.0)
    return BatchSimEngine(plat, config=cfg, controller=ctl, backend="fused")


def drive_main_path_a12():
    """The second main-path shape: stacked twelve-tile platforms with a
    two-stage chain over 3-replica stages and memory-bound DFS."""
    from repro_torch.kernels.tick_sim import fused_tick_sim
    from repro_torch.sim.batch import BatchSimPlatform
    from repro_torch.sim.engine import SimConfig
    from repro_torch.sim.flows import FlowPattern
    from repro_torch.sim.traffic import diurnal_trace

    B, T, dt = SIZES["a12_B"], SIZES["a12_T"], 1e-3
    rng = np.random.default_rng(SEED + 1)
    chain = FlowPattern.chain(("dfmul0", "dfmul1", "dfmul2"),
                              ("dfmul3", "dfmul4", "dfmul5"))
    plat = BatchSimPlatform.stack(
        twelve_tile_platforms(B, rng=rng, flows=chain))
    cfg = SimConfig(control_interval=50)
    cap = a12_engine(plat, cfg).capacity_rps().mean(axis=0)
    trace = diurnal_trace(cap * 0.35, T, 12, dt=dt, depth=0.5, seed=SEED)
    before = fused_tick_sim.launches
    t0 = time.perf_counter()
    r = a12_engine(plat, cfg).run(trace)
    sync()
    wall = time.perf_counter() - t0
    if fused_tick_sim.launches != before + 1:
        raise SystemExit("the A=12 run did not launch the kernel once")
    gap = check_result(r, "main_path_a12", chained=True)
    report = {"phase": "main_path_a12", "B": B, "T": T, "A": 12,
              "wall_s": wall, "designs_per_s": B / wall,
              "kernel_ms": r.timings["loop"] * 1e3,
              "percentiles_ms": r.timings["percentiles"] * 1e3,
              "copies_ms": r.timings["copies"] * 1e3,
              "offered_minus_accounted_rel": gap,
              "swaps_total": int(r.swaps.sum())}
    return report, dict(plat=plat, cfg=cfg, trace=trace)


def verify_main_path_a12(report, ctx):
    cmp, inputs = kernel_vs_plain(a12_engine(ctx["plat"], ctx["cfg"]),
                                  ctx["trace"])
    report["L"] = int(inputs[1]["inc"].shape[-1])
    report["kernel_vs_plain"] = {**cmp, **time_kernel_and_plain(inputs)}
    emit(report)
    if kernel_failed(cmp):
        raise SystemExit("kernel disagrees with its plain version at the "
                         "A=12 shapes")
    return report


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="device, build and kernel parity only")
    ap.add_argument("--ptxas", action="store_true",
                    help="print the compiler's register/spill report")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures on the card "
              "and does not fall back to the CPU", file=sys.stderr)
        return 2

    from repro_torch.kernels import build
    from repro_torch.kernels.tick_sim import fused_tick_sim

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    build.build_all(verbose=args.ptxas)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.last_build_seconds,
          "sources": [os.path.relpath(s, ROOT) for s in build.sources()],
          "flags": " ".join(build.NVCC_FLAGS)})
    if args.ptxas:
        for src, log in build.last_build_log.items():
            print(f"--- nvcc {src} ---\n{log}", flush=True)

    parity = phase_kernels()
    device = {"platform": "gpu", "kind": name,
              "count": torch.cuda.device_count()}
    if args.quick:
        print(smi, flush=True)
        emit({"ok": True, "quick": True, "device": device})
        return 0

    model, res, _ = phase_sweep()

    # the main path, counted: every count to 0 just before, read just after
    fused_tick_sim.launches = 0
    main_report, main_ctx = drive_main_path(model, res)
    a12_report, a12_ctx = drive_main_path_a12()
    launches = fused_tick_sim.launches
    if launches < 1:
        raise SystemExit("the main path never launched the tick_sim kernel")

    # comparisons and timings (their launches are not the main path's)
    main_report = verify_main_path(main_report, main_ctx)
    a12_report = verify_main_path_a12(a12_report, a12_ctx)

    lin = main_report["kernel_vs_plain"]["linear"]
    a12k = a12_report["kernel_vs_plain"]
    emit({"kernels": [{
        "name": "tick_sim", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tick_sim.cu",
        "replaces": "src/repro/kernels/tick_sim.py:205",
        "launches": launches,
        "max_abs_err": max(lin["max_abs_err"], a12k["max_abs_err"],
                           parity["max_abs_err"]),
        "max_rel_err": max(lin["max_rel_err"], a12k["max_rel_err"],
                           parity["max_rel_err"]),
        "tolerance": {"rtol": RTOL, "atol": ATOL, "swaps": "exact"},
        "shape": "T=%d B=%d A=2 L=48 pid+guard" % (SIZES["main_T"],
                                                   SIZES["main_B"]),
        "ms": lin["ms"], "plain_ms": lin["plain_ms"],
        "bound_ms": lin["bound_ms"], "bound_by": lin["bound_by"],
        "library_ms": None,
        "also": {"shape": "T=%d B=%d A=12 L=48 chain membound+guard"
                 % (SIZES["a12_T"], SIZES["a12_B"]),
                 "ms": a12k["ms"], "plain_ms": a12k["plain_ms"],
                 "bound_ms": a12k["bound_ms"],
                 "bound_by": a12k["bound_by"]}}]})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
