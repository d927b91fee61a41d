"""The first-step check of ``chip_smoke.py``'s training phases
(``fit_one_batch``), studied on the card: each phase runs as
``chip_smoke.py`` runs it, ``--runs`` times (each run's end state differs
from the others' on the card), and from each end state the trainer's first
AdamW step from zero moments on the run's first microbatch is taken and
read: the directional derivative g.u leaf by leaf (float64), the NLL along
theta + s u for each of ``--scales`` with the displacement's g.delta and
the Armijo target ``ARMIJO_C |g.delta|`` and the NLL along theta - s u
(the other side of the line), the NLL at theta read twice (the loss's own
noise), and whether each planted fault (zero, reversed,
misdirected) fails the check.  Prints one ``STEP {json}`` line an end state.

    python3 examples/torch_fit_study.py --phase train_moe --runs 6

Needs a CUDA card; builds the kernels from the checkout first.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402

PHASES = {"train": C.phase_train, "train_moe": C.phase_train_moe,
          "train_ssm": C.phase_train_ssm}
STUDY_SCALES = (1.0, 1 / 4, 1 / 16, 1 / 64, 1 / 256, 1 / 1024, 1 / 4096,
                1 / 16384, 1 / 65536)


def study(tr, spec, phase, run, scales) -> dict:
    """One end state's record (the module's notes)."""
    from repro_torch.checkpoint.store import _flatten_with_paths
    st = C.first_step(tr, spec)
    with torch.no_grad():
        again = float(tr.lm.loss_fn(tr.params, st["batch"])[1]["nll"])
    v = C.step_verdict(tr, st, st["u"], scales, every=True)
    paths = [p for p, _ in _flatten_with_paths(tr.params)]
    plants = C.planted_steps(st)
    rejected = {k: not C.step_verdict(tr, st, plants[k])["ok"]
                for k in ("zero", "reversed", "misdirected")}
    check = C.step_verdict(tr, st, st["u"])
    # the line on the other side: theta - s u (its rise against the drop
    # on this side shows the curvature and the bf16 rounding's noise)
    from repro_torch.models.params import tree_unflatten
    leaves = C._leaves(tr.params)
    minus = []
    for sc in scales:
        moved = [(p.float() - sc * d).to(p.dtype)
                 for p, d in zip(leaves, st["u"])]
        with torch.no_grad():
            minus.append(float(tr.lm.loss_fn(tree_unflatten(
                tr.params, moved), st["batch"])[1]["nll"]))
        del moved
    return {"phase": phase, "arch": spec.get("arch"), "run": run,
            "lr": spec["lr"], "nll": st["nll"], "nll_again": again,
            "gu": v["gu"], "leaf_max_ratio": v["leaf_max_ratio"],
            "leaves": {p: r for p, r in zip(paths, v["leaves"])},
            "line": v["line"], "nll_minus": minus, "check_ok": check["ok"],
            "faults_rejected": rejected, "misdirected_pair": plants["pair"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", default="train_moe", choices=sorted(PHASES))
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--scales", default=",".join(
        repr(s) for s in STUDY_SCALES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fit_study: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.build_all()
    C.profile_train_step = lambda tr: {}
    scales = tuple(float(s) for s in args.scales.split(","))
    t0 = time.perf_counter()
    for run in range(args.runs):
        def hook(tr, spec, run=run):
            rec = study(tr, spec, args.phase, run, scales)
            print("STEP " + json.dumps(rec), flush=True)
            # the phase's own gate is not this study's: let it pass
            return {"ok": True, "why": "", "faults_rejected": {}}
        C.fit_one_batch = hook
        try:
            PHASES[args.phase]()
        except SystemExit as e:
            print(f"PHASE FAIL {args.phase}: {e}", flush=True)
        torch.cuda.empty_cache()
        print(f"T {args.phase} run {run} {time.perf_counter() - t0:.1f}",
              flush=True)
    print(C.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
