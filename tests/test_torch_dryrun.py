"""The port's dry run (``repro_torch.launch.dryrun``): every cell counted
abstractly on a logical mesh, with the reference's keys where the meaning
is the same, and the collective term: one rank's placed step on a fake
process group of the cell's mesh.  That group is the process's default one,
so every cell whose collectives are counted runs in a subprocess (one for
the module, :func:`cells`), never in the pytest worker; the counts alone
(``lower_cell``) run here."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest

from repro.configs import get_config as ref_config
from repro.configs import shapes_for as ref_shapes_for
from repro.launch import costing as RC
from repro.launch import specs as RSP
from repro.models.layers import AttnOptions as RAttn
from repro.models.params import abstract_params as ref_abstract
from repro.models.transformer import LM as RLM
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.perfmodel import H100_SXM, roofline_from_counts
from repro_torch.core.replication import replication_area_model
from repro_torch.launch import dryrun as D

from test_torch_costing import ref_flops

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
KEYS = {"arch", "shape", "kind", "mesh", "chips", "n_params",
        "n_active_params", "strategy", "tokens", "hbm_bytes_total", "mra_k",
        "multi_pod", "folded", "lower_seconds", "flops_total",
        "dot_flops_total", "argument_size_in_bytes", "collective_bytes",
        "per_op_bytes", "op_counts", "count_seconds",
        "param_bytes_per_device", "roofline"}
FAMILIES = ["h2o-danube-1.8b", "granite-moe-1b-a400m",
            "deepseek-v2-lite-16b", "mamba2-370m", "zamba2-7b"]
KINDS = ["train", "prefill", "decode"]

# the cells the subprocess runs: (tag, arch, kind, seq, batch, multi_pod,
# CellOptions kwargs), each at its reduced config, or with seq None the
# registered config at its registered shape ``kind`` (granite-moe's 32
# experts split over a model axis of 16, and over shard at mra2)
CELLS = ([(f"{a}/{k}", a, k, 64, 4, False, {"q_block": 16})
          for a in FAMILIES for k in KINDS]
         + [(f"moe/{st}", "granite-moe-1b-a400m", "train_4k", None, None,
             False, {"strategy": st})
            for st in ("tp", "tp-ep", "mra2-ep", "mra2-attn")]
         + [(f"dense/{st}", "granite-8b", "decode", 64, 16, False,
             {"strategy": st}) for st in ("tp", "mra4")]
         + [("fsdp", "gemma-2b", "train", 64, 4, False,
             {"q_block": 16, "strategy": "fsdp"})]
         + [(f"pod2/{tag}", "gemma-2b", "prefill", 128, 2, True,
             {"q_block": 16, "folded": f}) for tag, f in (("full", False),
                                                           ("folded", True))]
         + [("danube/decode_32k", "h2o-danube-1.8b", "decode_32k", None,
             None, False, {})])

_SCRIPT = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
out = {}
for tag, arch, kind, seq, batch, mp, kw in json.load(open(sys.argv[1])):
    if seq is None:
        out[tag] = D.run_cell(arch, kind, multi_pod=mp,
                              co=D.CellOptions(**kw), save=False)
        continue
    shape = ShapeConfig(kind + "_" + str(seq), seq, batch, kind)
    out[tag] = D.run_cell(arch, shape.name, multi_pod=mp,
                          co=D.CellOptions(**kw),
                          cfg=get_config(arch).reduced(), shape=shape,
                          out_dir=sys.argv[2])
print("CELLS " + json.dumps(out))
"""


def _subprocess(args, tmp, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=str(tmp))


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Every cell of ``CELLS`` run by ``run_cell`` (collectives counted) in
    one subprocess; (results by tag, the JSONs' directory)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    spec = tmp / "cells.json"
    spec.write_text(json.dumps(CELLS))
    res = _subprocess(["-c", _SCRIPT, str(spec), str(tmp / "out")], tmp)
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(x for x in res.stdout.splitlines() if x.startswith("CELLS "))
    return json.loads(line[6:]), tmp / "out"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_cell(cells, arch, kind):
    got, out = cells
    r = got[f"{arch}/{kind}"]
    name = f"{kind}_64"
    assert set(r) == KEYS
    assert r["chips"] == 256 and r["mesh"] == {"data": 16, "model": 16}
    assert r["tokens"] == 4 * (64 if kind != "decode" else 1)
    assert 0 < r["dot_flops_total"] <= r["flops_total"]
    # the collective term: one rank's placed step on the 256-rank mesh
    assert r["collective_bytes"] > 0 and r["collective_bytes"] == \
        pytest.approx(sum(r["per_op_bytes"].values()), rel=1e-12)
    assert set(r["op_counts"]) == set(r["per_op_bytes"])
    assert "all-reduce" in r["op_counts"]
    assert not any(k in r for k in ("compile_seconds", "temp_size_in_bytes",
                                    "hlo_flops_per_device_bodyonce",
                                    "collective_note"))
    terms = roofline_from_counts(r["flops_total"], r["hbm_bytes_total"],
                                 r["collective_bytes"], 256)
    assert r["roofline"]["t_compute"] == terms.t_compute
    assert r["roofline"]["t_memory"] == terms.t_memory
    assert r["roofline"]["t_collective"] == terms.t_collective == \
        r["collective_bytes"] / H100_SXM.link_bw
    assert r["roofline"]["dominant"] == terms.dominant
    assert r["roofline"]["device"] == H100_SXM.name
    assert r["argument_size_in_bytes"] >= r["param_bytes_per_device"] > 0
    saved = json.load(open(out / f"{arch}__{name}__pod1.json"))
    assert saved == json.loads(json.dumps(r))


def test_mra_cell_holds_more_weights_per_device(cells):
    """Paper C1 in the dry run: mra4 replicates every tile four ways, so a
    device holds ~4x the weight bytes of the 16-way TP baseline."""
    tp, mra = cells[0]["dense/tp"], cells[0]["dense/mra4"]
    assert mra["mesh"] == {"data": 16, "replica": 4, "shard": 4}
    assert mra["mra_k"] == 4 and mra["strategy"] == "mra4"
    assert mra["hbm_bytes_total"] > tp["hbm_bytes_total"]
    assert mra["argument_size_in_bytes"] > tp["argument_size_in_bytes"]
    assert mra["param_bytes_per_device"] > tp["param_bytes_per_device"]
    assert mra["flops_total"] == tp["flops_total"]
    assert mra["collective_bytes"] > 0 and tp["collective_bytes"] > 0


def test_folded_option_halves_attention(cells):
    """gemma-2b prefill on two pods, folded and not: the folded cell's
    products are fewer, and both count the collectives of one rank's step
    on the 512-rank mesh, its batch over ``pod`` too."""
    full, half = cells[0]["pod2/full"], cells[0]["pod2/folded"]
    assert half["folded"] and half["strategy"] == "tp-folded"
    assert half["dot_flops_total"] < full["dot_flops_total"]
    assert full["chips"] == 512 and full["multi_pod"]
    assert full["mesh"] == {"pod": 2, "data": 16, "model": 16}
    for r in (full, half):
        assert r["collective_bytes"] > 0
        assert r["roofline"]["t_collective"] == \
            r["collective_bytes"] / H100_SXM.link_bw


@pytest.mark.parametrize("co", [
    D.CellOptions(onehot_loss=True), D.CellOptions(grad_rs=True),
    D.CellOptions(strategy="tp-ep")])
def test_device_knobs_raise_naming_item_12(co):
    """Every knob is counted: the iota-compare loss adds work to the plain
    cell's, the bf16 gradient cast of bf16 gradients none, and an ``ep``
    strategy (expert parallelism: the same products, moved by all-to-alls;
    its collectives in :func:`test_ep_and_mra_cells`) the plain cell's."""
    arch = "granite-moe-1b-a400m" if co.ep else "granite-8b"
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("t", 64, 4, "train")
    mesh = D.make_cell_mesh(co, False)
    kw = dict(cfg=cfg, shape=shape)
    base = D.lower_cell(arch, "t", mesh, co=D.CellOptions(q_block=16), **kw)
    got = D.lower_cell(arch, "t", mesh,
                       co=dataclasses.replace(co, q_block=16), **kw)
    assert got["strategy"] == "tp-" + ("vploss" if co.onehot_loss else
                                       "gradrs" if co.grad_rs else "ep")
    if co.onehot_loss:          # the compare, select and sum over V
        assert got["flops_total"] > base["flops_total"]
    else:                       # bf16 gradients already: the cast is no op
        assert got["flops_total"] == base["flops_total"]
    assert got["dot_flops_total"] == base["dot_flops_total"]


def test_ep_and_mra_cells(cells):
    """The expert-parallel and MRA strategies on granite-moe's train step
    at full width (its 32 experts split 16 ways, and 8 ways at mra2): each
    has the tp cell's FLOPs (the reference's ``_jaxpr_flops_for`` counts
    them with no mesh); expert parallelism moves the tokens by
    all-to-alls, which the tp cell has none of; ``mra2-attn`` keeps the
    experts over the whole fabric (the reference's ``moe_axes``)."""
    got = cells[0]
    tp = got["moe/tp"]
    for st in ("tp-ep", "mra2-ep", "mra2-attn"):
        r = got[f"moe/{st}"]
        assert r["strategy"] == st and r["collective_bytes"] > 0
        assert r["flops_total"] == tp["flops_total"], st
        assert r["dot_flops_total"] == tp["dot_flops_total"], st
    assert "all-to-all" not in tp["per_op_bytes"]
    for st in ("tp-ep", "mra2-ep"):
        assert got[f"moe/{st}"]["per_op_bytes"]["all-to-all"] > 0, st
    assert got["moe/mra2-ep"]["mesh"] == {"data": 16, "replica": 2,
                                          "shard": 8}
    # the experts over shard: each device holds 1/8 of them
    assert got["moe/mra2-ep"]["param_bytes_per_device"] > \
        tp["param_bytes_per_device"]
    assert "all-to-all" not in got["moe/mra2-attn"]["per_op_bytes"]


def test_fsdp_cells_carry_no_collective_term(cells):
    r = cells[0]["fsdp"]
    assert r["collective_bytes"] is None and r["per_op_bytes"] is None
    assert "item 12f" in r["collective_note"]
    assert r["roofline"]["t_collective"] is None
    assert r["flops_total"] > 0 and r["hbm_bytes_total"] > 0


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_mra_weight_bytes_per_device_follow_the_area_model(k):
    """The reference's ``pod_domain`` rows: deepseek-v2-lite decode_32k at
    mra<K>; what a device holds of the parameters is what
    ``replication_area_model`` says of the whole weight set, within 6 %
    (the vocab tile stays K = 1, and the norms and the latent
    down-projection, on no axis, are held whole), and it grows with K."""
    from repro_torch.launch import specs as SP
    cfg = get_config("deepseek-v2-lite-16b")

    def held(k):
        """A device's parameter bytes at mra<k>, as ``lower_cell`` counts
        them (``param_bytes_per_device``)."""
        co = D.CellOptions(strategy=f"mra{k}")
        mesh, plan = D.make_cell_mesh(co, False), D.cell_plan(cfg, co)
        lm = D.build_lm(cfg, co, mesh=mesh, plan=plan)
        return SP.per_device_bytes(lm.abstract(), SP.param_shardings(
            lm, mesh, plan, D.rules_override(co, mesh)))
    want = replication_area_model(cfg.n_params() * 2, 0, k)
    got = held(k)
    assert abs(got / want["weight_bytes_per_dev"] - 1) < 0.06, (k, got)
    if k > 1:
        assert got > held(k // 2)


@pytest.mark.parametrize("flag", [["--onehot-loss"], ["--grad-rs"],
                                  ["--strategy", "mra2-ep"]])
def test_cli_refuses_device_knobs(flag, tmp_path):
    """The CLI counts every knob, ``ep`` strategies included, with the
    collective term (in a process of its own, as the CLI runs)."""
    res = _subprocess(["-m", "repro_torch.launch.dryrun", "--arch",
                       "mamba2-370m", "--shape", "long_500k", "--single-pod",
                       "--out-dir", str(tmp_path)] + flag, tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ALL CELLS PASSED" in res.stdout
    (name,) = os.listdir(tmp_path)
    r = json.load(open(tmp_path / name))
    assert r["collective_bytes"] > 0


def test_cli_one_cell(tmp_path):
    res = _subprocess(["-m", "repro_torch.launch.dryrun", "--arch",
                       "mamba2-370m", "--shape", "long_500k", "--single-pod",
                       "--out-dir", str(tmp_path)], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "OK   mamba2-370m x long_500k x 1-pod(256)" in res.stdout
    assert "ALL CELLS PASSED" in res.stdout
    assert os.listdir(tmp_path) == ["mamba2-370m__long_500k__pod1.json"]


def test_every_assigned_cell_is_listed():
    from repro.configs import ASSIGNED_ARCHS
    cells = list(D.iter_cells())
    assert cells == [(a, s) for a in ASSIGNED_ARCHS
                     for s in ref_shapes_for(ref_config(a))]


def test_full_width_decode_cell_matches_the_reference(cells):
    """danube decode_32k at full width (batch 128 over a 4,096 window),
    run by ``run_cell`` with its collectives counted: the dot FLOPs equal
    the reference's jaxpr count; the HBM bytes and the parameter counts are
    the reference's."""
    r = cells[0]["danube/decode_32k"]
    rcfg = ref_config("h2o-danube-1.8b")
    shape = ref_shapes_for(rcfg)["decode_32k"]
    lm = RLM(rcfg, opts=RAttn(backend="chunked"), remat=True)
    cache, tok = RSP.abstract_decode_inputs(lm, shape)
    jx = jax.make_jaxpr(lambda p, c, t: lm.decode_step(p, c, tokens=t))(
        ref_abstract(lm.param_specs()), cache, tok)
    assert r["dot_flops_total"] == ref_flops(jx.jaxpr)[1]
    assert r["hbm_bytes_total"] == RC.hbm_bytes(rcfg, shape)
    assert (r["n_params"], r["n_active_params"]) == (rcfg.n_params(),
                                                    rcfg.n_active_params())
    # the memory term over the compute one, as in the reference; the
    # collective term (the window split over model) is the largest of all
    roof = r["roofline"]
    assert roof["t_memory"] > roof["t_compute"]
    assert roof["dominant"] == "collective"
    assert roof["t_collective"] == max(roof["t_compute"], roof["t_memory"],
                                       roof["t_collective"])
    assert r["lower_seconds"] < 30


# ------------------------------------- chip_smoke.py's costing, on the CPU
def _smoke():
    from _torch_port_helpers import chip_smoke
    return chip_smoke()


@pytest.mark.parametrize("phase", ["train", "train_moe", "train_ssm"])
def test_chip_smoke_costs_each_training_step(phase):
    """The card's ``costing`` rows of a training path at its full width and
    shapes, given a stand-in for the phase's report: the MFU is the
    phase's own formula's (``mfu`` there) to 1e-9, and the counted
    products hold the remat recompute (more than 6 N D with N the active
    parameters; the phase's MFU counts every expert of the moe model)."""
    cs = _smoke()
    spec = cs.COST_TRAIN[phase]
    cfg = get_config(spec["arch"])
    n = cfg.n_params()
    tokens = spec["global_batch"] * spec["seq_len"]
    report = {"n_params": n, "tokens_per_step": tokens,
              "mean_step_s_after_first": 5.55,
              "mfu": 6 * n * tokens / (5.55 * cs.H100_BF16_PER_S)}
    row = cs.cost_train(phase, report)
    assert row["mfu_rel_gap"] <= cs.MFU_RTOL
    assert row["model_flops"] == 6.0 * n * tokens
    assert row["dot_flops"] > 6.0 * cfg.n_active_params() * tokens
    assert row["dominant"] == "compute"
    assert 0 < row["bound_over_measured"] < 1


@pytest.mark.parametrize("phase", sorted(
    ["serve", "serve_ssm", "serve_hybrid", "serve_moe", "serve_mla"]))
def test_chip_smoke_costs_each_serving_path(phase):
    cs = _smoke()
    spec = cs.COST_SERVE[phase]
    report = {"prefill_s_by_request": [0.5] * len(spec["prompts"]),
              "decode_step_ms": 20.0}
    pre, dec = cs.cost_serve(phase, report)
    cfg = get_config(spec["arch"])
    n = max(spec["prompts"])
    assert pre["kind"] == f"prefill_{n}" and pre["tokens"] == n
    assert pre["dot_flops"] >= 2 * cfg.n_active_params() * n * 0.5
    assert dec["tokens"] == spec["slots"] and dec["measured_s"] == 0.02
    assert 0 < dec["dot_flops"] <= dec["flops_total"]


def test_chip_smoke_backward_bounds_at_the_path_shapes():
    """Each Function's backward bound at the training path's shapes counts
    the work its gradients need, over the live pairs only; the oracle
    backward's counted FLOPs stand beside it (it recomputes the forward
    over the full S x S rectangle, so about three times the forward's
    products)."""
    cs = _smoke()
    cases = cs.train_path_cases()
    assert [c[0] for c in cases] == ["flash_attention", "flash_attention",
                                     "fused_rmsnorm_mlp", "ssd_scan"]
    assert len(cases) == len(cs.TRAIN_PATH_RUNS)
    B, S, KV, G, hd, window = cases[0][2]
    assert window >= S                               # causal at the path
    b = cs.backward_bound(*cases[0])
    rect = 2.0 * B * KV * G * S * S * hd
    assert b["oracle_backward_dot_flops"] == 3 * 2 * rect
    # five products (scores, dP, dV, dQ, dK) over the causal half
    assert b["backward_dot_flops"] == 5 * 2.0 * B * KV * G * hd \
        * S * (S + 1) / 2
    assert b["backward_bound_by"] == "operations"
    assert b["backward_bound_ms"] == pytest.approx(
        b["backward_dot_flops"] / cs.H100_BF16_PER_S * 1e3, rel=1e-12)
    mlp = cs.backward_bound(*cases[2])
    # six products, as many as the oracle runs
    assert mlp["backward_dot_flops"] == mlp["oracle_backward_dot_flops"]
    ssd = cs.backward_bound(*cases[3])
    # the float32 scan: the lesser of the tensor-core and CUDA-core bounds
    assert ssd["backward_bound_ms"] == min(ssd["backward_bound_tc_ms"],
                                           ssd["backward_bound_f32_ms"])
    assert ssd["backward_bound_tc_ms"] < ssd["backward_bound_f32_ms"]
    assert 0 < ssd["backward_dot_flops"] < ssd["oracle_backward_dot_flops"]


def test_chip_smoke_backward_work_counts_the_window_pairs():
    """The attention backward's pairs are those ``_window_mask`` keeps."""
    import torch
    from repro_torch.models.layers import _window_mask
    cs = _smoke()
    for S, window in ((8, 3), (8, 0), (8, 8), (8, 20), (5, 1)):
        pos = torch.arange(S)
        pairs = float(_window_mask(pos, pos, window).sum())
        prod, other = cs.backward_work("flash_attention",
                                       (2, S, 3, 2, 16, window))
        assert prod == 5 * 2.0 * 2 * 3 * 2 * 16 * pairs, (S, window)
        assert other == 0.0
