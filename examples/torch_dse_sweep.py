"""Design-space exploration on the port: the Vespa workflow end to end
(PyTorch, on the CUDA card by default).

Runs the port's batched DSE engine over the full design space for a CHStone
accelerator on the paper's 4x4 SoC — replication K x the complete
island-rate ladders x every grid placement — prints the Pareto front and
points/second, cross-checks a few points against the scalar path, then
applies the batched DFS energy policy to the chosen design.

    python examples/torch_dse_sweep.py --accel dfadd
    python examples/torch_dse_sweep.py --device cpu      # the host instead

Per-island mode (paper C2 — one independent rate axis per accelerator
island, evaluated chunked/streaming, with the heterogeneous-rate Pareto
point that strictly dominates the best shared-rate point):

    python examples/torch_dse_sweep.py --independent-islands

Physical-DVFS mode (the V^2 f tech-node model vs the linear proxy —
the two energy landscapes pick different frequencies):

    python examples/torch_dse_sweep.py --tech-node 16 \\
        --tech-variant cons
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.configs.vespa_soc import CHSTONE  # noqa: E402
from repro_torch.core.dfs import policy_energy_per_token_sweep  # noqa: E402
from repro_torch.core.dse import grid_sweep, summarize_result  # noqa: E402
from repro_torch.core.islands import (IslandConfig,  # noqa: E402
                                      IslandSpec, NOC_LADDER, TILE_LADDER)
from repro_torch.core.perfmodel import (NOC_POWER_SHARE,  # noqa: E402
                                        AccelWorkload, SoCPerfModel,
                                        chip_power)
from repro_torch.core.voltage import (TECH_NODES,  # noqa: E402
                                      TECH_VARIANTS, TechModel)


def independent_islands_demo(n_tg: int, backend, device) -> None:
    """Joint 3-accelerator sweep, shared vs per-island rate axes.

    The shared sweep only explores the diagonal of the rate space; the
    per-island sweep (chunked — the cross-product is ~1e6 points even on
    this small grid) finds off-diagonal points that strictly dominate the
    shared sweep's best energy point: derate the tiny compute-bound
    island, keep the memory-bound streams fast.
    """
    m = SoCPerfModel()
    wls = [AccelWorkload(n, *CHSTONE[n])
           for n in ("dfadd", "dfmul", "dfsin")]
    kw = dict(ks=(1, 2, 4), acc_rates=TILE_LADDER.levels(),
              noc_rates=(0.5, 1.0), tg_rates=(1.0,),
              positions=((1, 1), (3, 3), (0, 2)), n_tg=n_tg,
              backend=backend, device=device)
    shared = grid_sweep(m, wls, **kw)
    indep = grid_sweep(m, wls, **kw, island_rates="independent",
                       chunk_points=200_000)
    print(f"shared sweep: {len(shared):,} points "
          f"({shared.points_per_second:,.0f} pts/s)")
    print(f"per-island sweep: {len(indep):,} points in "
          f"{indep.n_chunks} chunks "
          f"({indep.points_per_second:,.0f} pts/s, "
          f"peak chunk {indep.peak_chunk_bytes / 1e6:.0f} MB)")

    spf = shared.pareto_indices()
    best = int(spf[np.argmin(
        shared.objective_values("energy_per_unit", spf))])
    bt, ba, be = (float(shared.objective_values(o, [best])[0])
                  for o in ("throughput", "area", "energy_per_unit"))
    print(f"\nbest shared-rate point: rates={shared.island_rates(best)} "
          f"thr={bt:.2f} area={ba:.3f} E/u={be:.3f}")

    ipf = indep.pareto_indices()
    it, ia, ie = (indep.objective_values(o, ipf)
                  for o in ("throughput", "area", "energy_per_unit"))
    dom = (it >= bt) & (ia <= ba) & (ie <= be) & \
          ((it > bt) | (ia < ba) | (ie < be))
    assert dom.any(), "expected a dominating heterogeneous point"
    j = int(ipf[dom][np.argmin(ie[dom])])
    jt, je = (float(indep.objective_values(o, [j])[0])
              for o in ("throughput", "energy_per_unit"))
    print(f"dominating heterogeneous point: "
          f"rates={indep.island_rates(j)} thr={jt:.2f} "
          f"(+{(jt / bt - 1) * 100:.1f}%) E/u={je:.3f} "
          f"({(je / be - 1) * 100:.1f}%)")
    print(f"\n{int(dom.sum())} per-island Pareto points strictly dominate "
          "the best shared-rate point — the design space the shared-axis "
          "sweep cannot see.")


def tech_demo(node: int, variant: str, n_tg: int, backend,
              device) -> None:
    """The V^2 f front diverges from the linear proxy's front.

    Sweeps the paper's 3-accelerator 4x4 SoC twice over the same
    frequency grid — once under the legacy linear voltage proxy, once
    under the tech node's physical ``V(f) = Vth + f (Vdd - Vth)`` curve
    — then re-evaluates the linear front under V^2 f.  The physical
    model punishes high frequencies quadratically in voltage, so its
    best point runs some islands slower and strictly beats the linear
    pick once both are priced physically.
    """
    tm = TechModel(node, variant)
    print(f"tech model: {tm}")
    m = SoCPerfModel()
    wls = [AccelWorkload(n, *CHSTONE[n])
           for n in ("dfadd", "dfmul", "dfsin")]
    kw = dict(ks=(2, 4), acc_rates=(0.4, 0.7, 1.0, 1.3),
              noc_rates=(0.5, 1.0), tg_rates=(1.0,),
              positions=((1, 1), (3, 3), (0, 2)), n_tg=n_tg,
              backend=backend, device=device, island_rates="independent")
    lin = grid_sweep(m, wls, **kw)
    phys = grid_sweep(m, wls, **kw, tech_node=node, tech_variant=variant)
    # the trailing tech axis has size 1: flat indices line up
    e_phys = phys.energy_per_unit.ravel()

    def front(res):
        pf = res.pareto_indices()
        e = res.objective_values("energy_per_unit", pf)
        return pf[np.argsort(e, kind="stable")]

    f_lin, f_phys = front(lin), front(phys)
    print(f"\n{'':>10} {'linear front':>34} {'V^2f front':>34}")
    for r in range(5):
        li, pi = int(f_lin[r]), int(f_phys[r])
        lr = {k: round(v, 2) for k, v in lin.island_rates(li).items()}
        pr = {k: round(v, 2) for k, v in phys.island_rates(pi).items()}
        print(f"  #{r}  lin:{lr} E_lin={lin.energy_per_unit.ravel()[li]:.3f}"
              f" E_phys={e_phys[li]:.3f} | phys:{pr} E={e_phys[pi]:.3f}")
    best_lin, best_phys = int(f_lin[0]), int(f_phys[0])
    gain = (1 - e_phys[best_phys] / e_phys[best_lin]) * 100
    print(f"\nlinear pick re-scored under V^2 f: {e_phys[best_lin]:.4f} "
          f"W/(MB/s); the physical sweep's pick: "
          f"{e_phys[best_phys]:.4f} W/(MB/s) ({gain:+.1f}% better)")
    assert e_phys[best_phys] <= e_phys[best_lin]
    dl = lin.design_point(best_lin).rates
    dp = phys.design_point(best_phys).rates
    moved = {k: (dl[k], dp[k]) for k in dl if dl[k] != dp[k]}
    print(f"islands the physical model re-frequencies: {moved} — the "
          "linear proxy cannot see the node's voltage curve, so it "
          "overclocks islands the V^2 term says to slow down.")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--accel", default="dfadd", choices=sorted(CHSTONE))
    ap.add_argument("--tg", type=int, default=4,
                    help="active traffic generators")
    ap.add_argument("--backend", default=None, choices=("numpy", "torch"),
                    help="default: torch on the card, numpy on the CPU")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--independent-islands", action="store_true",
                    help="per-island rate axes (chunked sweep) + the "
                         "heterogeneous-dominance demo")
    ap.add_argument("--tech-node", type=int, default=None,
                    choices=TECH_NODES,
                    help="physical-DVFS demo: V^2 f front vs linear front"
                         " at this process node")
    ap.add_argument("--tech-variant", default="itrs",
                    choices=TECH_VARIANTS)
    args = ap.parse_args()

    if args.tech_node is not None:
        tech_demo(args.tech_node, args.tech_variant, args.tg, args.backend,
                  args.device)
        return
    if args.independent_islands:
        independent_islands_demo(args.tg, args.backend, args.device)
        return

    base, ai = CHSTONE[args.accel]
    wl = AccelWorkload(args.accel, base, ai)
    model = SoCPerfModel()

    # Full ladders, all placements, K up to 8 — one vectorized sweep.
    res = grid_sweep(
        model, wl, ks=(1, 2, 4, 8),
        acc_rates=TILE_LADDER.levels(), noc_rates=NOC_LADDER.levels(),
        tg_rates=TILE_LADDER.levels(), n_tg=args.tg, backend=args.backend,
        device=args.device)
    print(f"swept {len(res):,} design points for {args.accel} "
          f"(ai={ai}, {'compute' if wl.compute_bound else 'memory'}-bound) "
          f"in {res.elapsed_s:.3f}s [{res.backend}]")
    print(summarize_result(res))

    # Spot-check the batched engine against the scalar reference path.
    spots = res.topk_indices(3)
    worst = 0.0
    for i in spots:
        dp = res.design_point(int(i))
        k = dp.replication[wl.name]
        s = model.accel_throughput(
            AccelWorkload(wl.name, base, ai, replication=k),
            dp.placement[wl.name], dp.rates, args.tg)
        worst = max(worst, abs(s - dp.throughput) / max(s, 1e-12))
    print(f"\nscalar-path spot check on top-3: max rel err {worst:.2e}")

    best = res.design_point(int(res.topk_indices(1)[0]))
    print(f"chosen design: K={best.replication} rates={best.rates} "
          f"placement={best.placement}")
    print(f"throughput {best.throughput:.2f} MB/s at "
          f"{best.energy_per_unit:.1f} W/(MB/s)")

    # Batched DFS energy policy on the chosen design: all acc x noc rate
    # combinations are evaluated in one vectorized call.
    k = best.replication[wl.name]
    pos = best.placement[wl.name]
    islands = IslandConfig((
        IslandSpec("acc", (wl.name,), TILE_LADDER, 1.0),
        IslandSpec("noc_mem", ("NOC", "MEM"), NOC_LADDER, 1.0)))

    def eval_batch(rates):
        fa, fn = rates["acc"], rates["noc_mem"]
        tps = model.accel_throughput_batch(
            base_mbps=base, wire_share=wl.wire_share, k=k,
            f_acc=fa, f_noc=fn, f_tg=1.0, n_tg=args.tg, pos=pos)
        watts = chip_power(fa, 1.0) + NOC_POWER_SHARE * chip_power(fn, 1.0)
        return tps, np.broadcast_to(watts, np.shape(tps))

    rates = policy_energy_per_token_sweep(islands, eval_batch)
    print(f"DFS energy policy (batched ladder sweep): {rates}")


if __name__ == "__main__":
    main()
