"""``chip_smoke.py``'s phase ``train_mesh`` rehearsed on the CPU: its rank
code (``train_mesh_rank``) on four gloo ranks at reduced size, and its
checks (``train_mesh_failures``) against the reports.

On the CPU the kernels do not launch, so the checks must name exactly the
card's own conditions (launches, ``wgmma_tma``, ``gloo/cuda``, the MLP
backward's oracle on CUDA tensors) and nothing else; the planted faults (a
rank keeping its own gradient, a rank holding its neighbour's block of a
weight) must be caught by the checks the real run passes, the neighbour's
block by step 1's gradient against one device's as well, and a loss, grad
norm or gradient off the one-device run by more than its gate rejected.
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
          "sys.exit(chip_smoke.train_mesh_rank(int(sys.argv[1]), "
          "int(sys.argv[2]), sys.argv[3], device='cpu', reduced=True))")


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("mesh4"))
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
    return reps


def _single(reps):
    """A one-device report that agrees with the mesh run."""
    return {"losses": list(reps[0]["losses"]),
            "grad_norms": list(reps[0]["grad_norms"])}


def test_the_rank_checks_pass_and_the_planted_faults_are_caught(reports):
    for r in reports:
        assert r["placement_failures"] == [] and r["peer_gap"] == 0.0
        assert r["used"] and all(k.endswith("/gloo/cpu") for k in r["used"])
        el = r["elastic"]
        assert el["model4_mismatch"] == [] == el["one_rank_mismatch"]
        assert el["model4_split_leaves"] > 0
        assert r["planted"]["control_peer_gap"] == 0.0
        assert r["step1_grad"]["rel_l2"] <= CS.TRAIN_MESH_GRAD_RTOL
        assert r["planted"]["control_grad_rel_l2"] <= CS.TRAIN_MESH_GRAD_RTOL
        assert r["planted"]["neighbour_slice_grad_rel_l2"] > \
            CS.TRAIN_MESH_GRAD_RTOL
        assert sorted(r["step1_grad"]["per_leaf"]) == sorted(
            CS.TRAIN_MESH_GRAD_LEAVES)
        assert r["losses"] == reports[0]["losses"]
        assert r["collective_stats_step2"]["op_counts"]["all-reduce"] > 0
    pl = {r["rank"]: r["planted"] for r in reports}
    # rank 0 kept its gradient: it and its data peer (rank 2) diverge
    assert pl[0]["skipped_reduce_peer_gap"] > 0
    assert pl[2]["skipped_reduce_peer_gap"] > 0
    assert pl[1]["skipped_reduce_peer_gap"] == 0 == \
        pl[3]["skipped_reduce_peer_gap"]
    assert pl[1]["neighbour_slice_failures"] == ["blocks/mlp/wi_gate"]
    assert all(not pl[k]["neighbour_slice_failures"] for k in (0, 2, 3))
    assert reports[0]["elastic"]["one_rank_checked"]


def test_the_phase_checks_name_only_the_cards_conditions_on_the_cpu(reports):
    bad = CS.train_mesh_failures(reports, _single(reports))
    assert len(bad) == 4 * WORLD, bad
    for k in range(WORLD):
        assert any(f"rank {k} launches" in b for b in bad)
        assert any(f"rank {k} variants" in b for b in bad)
        assert any(f"rank {k} collectives off gloo/cuda" in b for b in bad)
        assert any(f"rank {k} backward oracle calls" in b for b in bad)


@pytest.mark.parametrize("fault", ["loss", "grad_norm", "grad", "oracle",
                                   "placement", "peer", "elastic",
                                   "skip_caught", "slice_caught",
                                   "slice_grad_caught"])
def test_the_phase_checks_reject_planted_faults(reports, fault):
    reps = copy.deepcopy(reports)
    single = _single(reports)
    for r in reps:      # the MLP backward's oracle calls as the card counts
        r["backward_oracle_on_cuda"]["fused_mlp"] = r["mlp_backward_calls"]
    base = len(CS.train_mesh_failures(reps, single))
    if fault == "loss":
        single["losses"][1] += 1.5 * CS.TRAIN_MESH_LOSS_ATOL
    elif fault == "grad_norm":
        single["grad_norms"][0] *= 1 + 2 * CS.TRAIN_MESH_GNORM_RTOL
    elif fault == "grad":
        reps[2]["step1_grad"]["rel_l2"] = 2 * CS.TRAIN_MESH_GRAD_RTOL
    elif fault == "oracle":
        reps[1]["backward_oracle_on_cuda"]["flash_attention"] = 1
    elif fault == "placement":
        reps[3]["placement_failures"] = ["embed"]
    elif fault == "peer":
        reps[2]["peer_gap"] = 1e-3
    elif fault == "elastic":
        reps[1]["elastic"]["model4_mismatch"] = ["params/embed"]
    elif fault == "skip_caught":
        for r in reps:
            r["planted"]["skipped_reduce_peer_gap"] = 0.0
    elif fault == "slice_caught":
        for r in reps:
            r["planted"]["neighbour_slice_failures"] = []
    else:
        reps[3]["planted"]["neighbour_slice_grad_rel_l2"] = 0.0
    assert len(CS.train_mesh_failures(reps, single)) == base + 1
