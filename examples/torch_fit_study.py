"""The one-batch fit of ``chip_smoke.py``'s training phases, studied on the
card: each phase runs as ``chip_smoke.py`` runs it, and from the weights and
AdamW moments its run ended with, the fit is repeated under several
variants: the run's moments carried or zero ("fresh"), at a given learning
rate, ``--steps`` steps.  Each fit starts from copies of the end state, so
repeats of one variant show the fit's own noise and repeated phases show the
spread across end states.  Prints one ``FIT {json}`` line a fit.

    python3 examples/torch_fit_study.py --steps 12 \\
        --plan "train_moe=carried:6e-4:1,fresh:6e-4:1,carried:3e-4:1" \\
        --plan "train=carried:6e-4:1"

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


def fit(tr, spec, moments: str, lr: float, steps: int) -> list:
    """``steps`` AdamW steps at ``lr`` (constant) on the run's first
    microbatch from copies of its end weights, with its moments
    (``"carried"``) or zero ones (``"fresh"``); the NLL before each step
    and after the last."""
    from repro_torch.models.params import tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import step_grads
    opt = adamw.AdamWConfig(lr=lr, warmup_steps=0, schedule="constant")
    mb = spec["global_batch"] // spec["accum"]
    batch = {k: v[:mb] for k, v in
             tr.place_batch(tr.data.batch_at(0)).items()}
    params = tree_map(lambda a: a.clone(), tr.params, torch.is_tensor)
    state = (adamw.init(params) if moments == "fresh" else
             tree_map(lambda a: a.clone(), tr.opt_state, torch.is_tensor))
    losses = []
    for _ in range(steps):
        _, parts, grads = step_grads(tr.lm, params, batch)
        params, state, _ = adamw.update(opt, grads, state, params)
        losses.append(float(parts["nll"]))
        del grads
    with torch.no_grad():
        losses.append(float(tr.lm.loss_fn(params, batch)[1]["nll"]))
    del params, state
    torch.cuda.empty_cache()
    return losses


def parse_plan(text: str):
    """``"phase=moments:lr:reps,..."`` -> (phase, [(moments, lr, reps)])."""
    phase, variants = text.split("=")
    out = []
    for v in variants.split(","):
        moments, lr, reps = v.split(":")
        assert moments in ("carried", "fresh"), moments
        out.append((moments, float(lr), int(reps)))
    assert phase in PHASES, phase
    return phase, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=C.FIT_STEPS)
    ap.add_argument("--plan", action="append", required=True,
                    help="phase=moments:lr:reps,... (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fit_study: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.build_all()
    C.profile_train_step = lambda tr: {}
    t0 = time.perf_counter()
    for phase, variants in map(parse_plan, args.plan):
        def study(tr, spec, variants=variants):
            for moments, lr, reps in variants:
                for r in range(reps):
                    losses = fit(tr, spec, moments, lr, args.steps)
                    print("FIT " + json.dumps(
                        {"phase": phase, "arch": spec["arch"],
                         "moments": moments, "lr": lr, "rep": r,
                         "drop": losses[0] - losses[-1],
                         "losses": losses}), flush=True)
            # the phase's own gate is not this study's: let it pass
            return {"steps": args.steps, "losses": [], "drop": C.FIT_MARGIN,
                    "margin": C.FIT_MARGIN}
        C.fit_one_batch = study
        try:
            PHASES[phase]()
        except SystemExit as e:
            print(f"PHASE FAIL {phase}: {e}", flush=True)
        print(f"T {phase} {time.perf_counter() - t0:.1f}", flush=True)
    print(C.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
