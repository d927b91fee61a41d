"""``chip_smoke.py``'s phases ``train_mesh`` and ``mesh_mra`` rehearsed on
the CPU: their rank code (``train_mesh_rank``, then ``mesh_mra_rank`` in the
same four gloo processes) at reduced size, and their checks
(``train_mesh_failures``, ``mesh_mra_failures``) against the reports.

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
LIMIT_S = 180
RUNNER = ("import sys; sys.path.insert(0, sys.argv[4]); import chip_smoke; "
          "r, w = int(sys.argv[1]), int(sys.argv[2]); "
          "chip_smoke.train_mesh_rank(r, w, sys.argv[3], device='cpu', "
          "reduced=True); "
          "sys.exit(chip_smoke.mesh_mra_rank(r, w, sys.argv[5], "
          "device='cpu', reduced=True))")
# the fake mesh's count of mesh_mra's step 1, in a process of its own
FAKE = ("import sys, json; sys.path.insert(0, sys.argv[1]); "
        "import chip_smoke; "
        "print('FAKE ' + json.dumps(chip_smoke.mra_fake_count(reduced=True)))")


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("mesh4"))
    wd_mra = str(tmp_path_factory.mktemp("mra4"))
    CS.mra_one_device_serve(wd_mra, device="cpu", reduced=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, "-c", RUNNER, str(r),
                               str(WORLD), wd, ROOT, wd_mra],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(WORLD)]
    procs.append(subprocess.Popen([sys.executable, "-c", FAKE, ROOT],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env))
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
    out = {}
    for name, d in (("mesh", wd), ("mra", wd_mra)):
        out[name] = []
        for r in range(WORLD):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                out[name].append(json.load(f))
    out["fake"] = json.loads(next(x for x in outs[-1][0].splitlines()
                                  if x.startswith("FAKE "))[5:])
    return out


@pytest.fixture(scope="module")
def reports(rehearsal):
    return rehearsal["mesh"]


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


# ------------------------------------------------------------- mesh_mra
def _mra_single(reps):
    return {"losses": list(reps[0]["losses"]),
            "grad_norms": list(reps[0]["grad_norms"])}


def test_the_mra_rank_checks_pass_and_the_planted_faults_are_caught(
        rehearsal):
    """The stream split on (data 1, replica 2, shard 2), reduced: each
    rank's step 1 gradient against one device's, its replicated blocks
    equal to its replica peer's, the attention on half of its group's
    rows (disjoint across the replicas) and the MLP on all of them, step
    1's collectives the fake mesh's op by op; both planted faults caught
    (the same rows by the rows check, the skipped replica reduce by the
    gradient and by the replicas' blocks)."""
    reps, fake = rehearsal["mra"], rehearsal["fake"]
    assert CS.mra_rows_failures(reps) == []
    assert CS.mra_rows_failures(reps, "planted/control/rows") == []
    assert CS.mra_rows_failures(reps, "planted/same_rows/rows")
    for r in reps:
        assert r["mra_split"] == ["attn"]
        assert r["rows_axes"] == ["data", "replica"]
        assert r["step1_grad"]["rel_l2"] <= CS.TRAIN_MESH_GRAD_RTOL
        assert r["replica_gap"] == 0.0
        assert {k: len(v) for k, v in r["rows"].items()} == {
            "embed": 2, "attn": 1, "ffn": 2}
        st = r["collective_stats_step1"]
        assert st["per_op_bytes"] == fake["per_op_bytes"]
        assert st["op_counts"] == fake["op_counts"]
        assert r["serve"]["max_rel_logit_err"] <= CS.mesh_logit_tol("dense")
        pl = r["planted"]
        assert pl["control"]["grad_rel_l2"] <= CS.TRAIN_MESH_GRAD_RTOL
        assert pl["control"]["replica_gap"] == 0.0
        assert pl["no_replica_reduce"]["grad_rel_l2"] > \
            CS.TRAIN_MESH_GRAD_RTOL
        assert pl["no_replica_reduce"]["replica_gap"] > 0.0


def _card_like(reps):
    """The reports with the card's own conditions met (the kernels'
    launches, the backward oracle on CUDA tensors, gloo on CUDA)."""
    reps = copy.deepcopy(reps)
    cfg = CS._cut(CS.MESH_MRA["arch"], CS.MESH_MRA["n_layers"], True)
    want = CS._want_mra_launches(cfg, reps[0]["serve"]["decode_steps"])
    for r in reps:
        r["launches"] = dict(want["train"])
        r["serve"]["launches"] = dict(want["serve"])
        r["serve"]["lse_launches"] = want["serve"]["flash_decode"]
        r["plain_on_cuda"] = dict(r["oracle_calls"])
        r["used"] = {k.replace("/cpu", "/cuda"): v
                     for k, v in r["used"].items()}
        r["serve"]["used"] = {k.replace("/cpu", "/cuda"): v
                              for k, v in r["serve"]["used"].items()}
    return reps


def test_the_mra_phase_checks_name_only_the_cards_conditions_on_the_cpu(
        rehearsal):
    reps, fake = rehearsal["mra"], rehearsal["fake"]
    bad = CS.mesh_mra_failures(reps, _mra_single(reps), fake)
    assert len(bad) == 5 * WORLD, bad
    for k in range(WORLD):
        assert any(f"rank {k} training launches" in b for b in bad)
        assert any(f"rank {k} serving launches" in b for b in bad)
        assert any(f"rank {k} plain versions" in b for b in bad)
        assert any(f"rank {k} training collectives off" in b for b in bad)
        assert any(f"rank {k} serving collectives off" in b for b in bad)
    assert CS.mesh_mra_failures(_card_like(reps), _mra_single(reps),
                                fake) == []


@pytest.mark.parametrize("fault", ["same_rows_caught",
                                   "replica_reduce_caught", "rows_overlap",
                                   "grad", "replica_gap", "fake_count",
                                   "cache", "logits"])
def test_the_mra_phase_checks_reject_planted_faults(rehearsal, fault):
    """Each gate of ``mesh_mra`` on the saved rank outputs: a planted fault
    that passed (the same rows, the skipped replica reduce), two replica
    ranks' attention on the same rows, a gradient off one device's, the
    replicas' blocks apart, step 1's collectives off the fake mesh's count,
    the cache's batch not over (data, replica), the logits off one
    device's."""
    reps, fake = _card_like(rehearsal["mra"]), dict(rehearsal["fake"])
    single = _mra_single(reps)
    assert CS.mesh_mra_failures(reps, single, fake) == []
    if fault == "same_rows_caught":
        for r in reps:
            r["planted"]["same_rows"]["rows"] = \
                r["planted"]["control"]["rows"]
    elif fault == "replica_reduce_caught":
        for r in reps:
            r["planted"]["no_replica_reduce"]["grad_rel_l2"] = 0.0
    elif fault == "rows_overlap":
        peer = next(r for r in reps if r["coords"]["replica"] == 0
                    and r["coords"]["shard"] == 0)
        for r in reps:
            if r["coords"]["replica"] == 1 and r["coords"]["shard"] == 0:
                r["rows"]["attn"] = peer["rows"]["attn"]
    elif fault == "grad":
        reps[1]["step1_grad"]["rel_l2"] = 2 * CS.TRAIN_MESH_GRAD_RTOL
    elif fault == "replica_gap":
        reps[2]["replica_gap"] = 1e-3
    elif fault == "fake_count":
        fake["op_counts"] = {**fake["op_counts"], "all-reduce": 0.0}
    elif fault == "cache":
        reps[3]["serve"]["cache_spec"] = \
            "PartitionSpec(None, 'data', 'shard', None, None)"
    else:
        reps[0]["serve"]["max_rel_logit_err"] = 1.0
    assert CS.mesh_mra_failures(reps, single, fake)
