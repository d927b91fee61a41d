"""``chip_smoke.py``'s phase ``mesh_families`` rehearsed on the CPU: the
one-device numbers (``families_one_device``) and the rank code
(``mesh_families_rank``) on four gloo ranks at reduced size, and the
phase's checks (``mesh_families_failures``) against the reports.

On the CPU the kernels do not launch, so the checks must name exactly the
card's own conditions (launches, the lse launches, host syncs, the plain
versions on CUDA tensors, ``gloo/cuda``) and nothing else: the training
losses, grad norms and step 1's gradient leaves, the serving logits and
greedy agreement and the placed cache's specs pass as they are.  A loss,
grad norm, gradient, logit error, agreement or cache spec off by more than
its gate is rejected, and so is a run whose planted decode fault (the
merge dropping model rank 1's partial output) passes the serving gates.
"""
import copy
import json
import os
import subprocess
import sys

import pytest

from _torch_port_helpers import chip_smoke

CS = chip_smoke()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD = 4
LIMIT_S = 120
RUNNER = ("import sys; sys.path.insert(0, sys.argv[4]); import chip_smoke; "
          "sys.exit(chip_smoke.mesh_families_rank(int(sys.argv[1]), "
          "int(sys.argv[2]), sys.argv[3], device='cpu', reduced=True))")
# what a CPU rank cannot show: per rank, each training case's launches,
# host syncs, plain versions on CUDA tensors and gloo/cuda; each serving
# case's launches, lse launches where its decode has attention, gloo/cuda
CARD_ONLY = 2 * 4 + sum(2 + (t in ("dense", "moe", "hybrid"))
                        for t, _, _, _ in CS.MESH_SERVE_CASES)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("families4"))
    single = CS.families_one_device(wd, device="cpu", reduced=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, "-c", RUNNER, str(r),
                               str(WORLD), wd, ROOT],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=LIMIT_S) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the rehearsal did not finish in {LIMIT_S} s")
    bad = [(r, p.returncode, e[-3000:]) for r, (p, (_, e))
           in enumerate(zip(procs, outs)) if p.returncode]
    assert not bad, bad
    reps = []
    for r in range(WORLD):
        with open(os.path.join(wd, f"rank{r}.json")) as f:
            reps.append(json.load(f))
    return reps, single


def test_the_phase_checks_name_only_the_cards_conditions_on_the_cpu(reports):
    reps, single = reports
    bad = CS.mesh_families_failures(reps, single)
    assert len(bad) == WORLD * CARD_ONLY, bad
    card = ("launches", "host syncs", "plain versions", "gloo/cuda")
    assert all(any(c in b for c in card) for b in bad), bad
    for r in reps:
        for arch, _, leaves in CS.MESH_TRAIN_CASES:
            t = r["train"][arch]
            assert sorted(t["step1_grad"]["per_leaf"]) == sorted(leaves)
            assert t["used"] and all(k.endswith("/gloo/cpu")
                                     for k in t["used"])
        for tag, _, _, _ in CS.MESH_SERVE_CASES:
            s = r["serve"][tag]
            assert s["cache_specs_ok"] and s["finite"]
            # the window split over the model axis (the ssm cache: the
            # state's heads and the conv channels over it)
            assert any("'model'" in v for v in s["cache_specs"].values())


@pytest.mark.parametrize("fault", ["loss", "grad_norm", "grad", "logits",
                                   "agreement", "peer", "cache", "finite",
                                   "decode_fault_passes"])
def test_the_phase_checks_reject_planted_faults(reports, fault):
    reps, single = copy.deepcopy(reports[0]), copy.deepcopy(reports[1])
    base = len(CS.mesh_families_failures(reps, single))
    more = 1
    arch = CS.MESH_TRAIN_CASES[0][0]
    tag = CS.MESH_SERVE_CASES[-1][0]
    if fault == "loss":
        single["train"][arch]["losses"][1] += 1.5 * CS.TRAIN_MESH_LOSS_ATOL
    elif fault == "grad_norm":
        single["train"][arch]["grad_norms"][0] *= \
            1 + 2 * CS.TRAIN_MESH_GNORM_RTOL
    elif fault == "grad":           # one leaf: the gate is the worst's
        g = reps[1]["train"][arch]["step1_grad"]
        g["per_leaf"][sorted(g["per_leaf"])[-1]] = 2 * CS.TRAIN_MESH_GRAD_RTOL
    elif fault == "logits":         # both model ranks of data 1's rows
        for r in reps[2:]:
            r["serve"][tag]["max_rel_logit_err"] = 2 * CS.LOGIT_REL_TOL
        more = 2
    elif fault == "agreement":      # the run's rows, on every rank
        for r in reps:
            s = r["serve"][tag]
            s["agreed"] = int((CS.AGREE_MIN - 0.05) * s["positions"])
    elif fault == "peer":           # a model rank's rows off its peer's
        reps[3]["serve"][tag]["max_rel_logit_err"] *= 1.5
    elif fault == "cache":
        reps[0]["serve"][tag]["cache_specs_ok"] = False
    elif fault == "decode_fault_passes":   # the planted decode fault unseen
        for r in reps:
            f = r["fault"][CS.MESH_FAULT_CASES[0]]
            f["max_rel_logit_err"], f["agreed"] = 0.0, f["positions"]
    else:
        reps[1]["serve"][tag]["finite"] = False
    assert len(CS.mesh_families_failures(reps, single)) == base + more
