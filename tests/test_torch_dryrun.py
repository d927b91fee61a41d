"""The port's dry run (``repro_torch.launch.dryrun``): every cell counted
abstractly on a logical mesh, with the reference's keys where the meaning
is the same, and the refusals of the knobs that need the device side of
the mesh (ROADMAP queue A item 12)."""
import dataclasses
import json
import os

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
from repro_torch.launch import dryrun as D

from test_torch_costing import ref_flops

KEYS = {"arch", "shape", "kind", "mesh", "chips", "n_params",
        "n_active_params", "strategy", "tokens", "hbm_bytes_total", "mra_k",
        "multi_pod", "folded", "lower_seconds", "flops_total",
        "dot_flops_total", "argument_size_in_bytes", "collective_bytes",
        "collective_note", "roofline"}
FAMILIES = ["h2o-danube-1.8b", "granite-moe-1b-a400m",
            "deepseek-v2-lite-16b", "mamba2-370m", "zamba2-7b"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_cell(arch, kind, tmp_path):
    cfg = get_config(arch).reduced()
    shape = ShapeConfig(f"{kind}_64", 64, 4, kind)
    co = D.CellOptions(q_block=16)
    r = D.run_cell(arch, shape.name, multi_pod=False, co=co, cfg=cfg,
                   shape=shape, out_dir=str(tmp_path))
    assert set(r) == KEYS
    assert r["chips"] == 256 and r["mesh"] == {"data": 16, "model": 16}
    assert r["tokens"] == 4 * (64 if kind != "decode" else 1)
    assert 0 < r["dot_flops_total"] <= r["flops_total"]
    assert r["collective_bytes"] is None and "item 12" in r["collective_note"]
    assert not any(k in r for k in ("compile_seconds", "temp_size_in_bytes",
                                    "hlo_flops_per_device_bodyonce"))
    terms = roofline_from_counts(r["flops_total"], r["hbm_bytes_total"], 0.0,
                                 256)
    assert r["roofline"]["t_compute"] == terms.t_compute
    assert r["roofline"]["t_memory"] == terms.t_memory
    assert r["roofline"]["device"] == H100_SXM.name
    assert r["argument_size_in_bytes"] > 0
    saved = json.load(open(tmp_path / f"{arch}__{shape.name}__pod1.json"))
    assert saved == json.loads(json.dumps(r))


def test_mra_cell_holds_more_weights_per_device():
    """Paper C1 in the dry run: mra4 replicates every tile four ways, so a
    device holds ~4x the weight bytes of the 16-way TP baseline."""
    cfg = get_config("granite-8b").reduced()
    shape = ShapeConfig("decode_64", 64, 16, "decode")
    tp = D.run_cell("granite-8b", "d", multi_pod=False, cfg=cfg, shape=shape,
                    save=False)
    mra = D.run_cell("granite-8b", "d", multi_pod=False, cfg=cfg,
                     shape=shape, co=D.CellOptions(strategy="mra4"),
                     save=False)
    assert mra["mesh"] == {"data": 16, "replica": 4, "shard": 4}
    assert mra["mra_k"] == 4 and mra["strategy"] == "mra4"
    assert mra["hbm_bytes_total"] > tp["hbm_bytes_total"]
    assert mra["argument_size_in_bytes"] > tp["argument_size_in_bytes"]
    assert mra["flops_total"] == tp["flops_total"]


def test_folded_option_halves_attention():
    cfg = get_config("gemma-2b").reduced()
    shape = ShapeConfig("p", 128, 2, "prefill")
    kw = dict(multi_pod=True, cfg=cfg, shape=shape, save=False)
    full = D.run_cell("gemma-2b", "p", co=D.CellOptions(q_block=16), **kw)
    half = D.run_cell("gemma-2b", "p",
                      co=D.CellOptions(q_block=16, folded=True), **kw)
    assert half["folded"] and half["strategy"] == "tp-folded"
    assert half["dot_flops_total"] < full["dot_flops_total"]
    assert full["chips"] == 512 and full["multi_pod"]


@pytest.mark.parametrize("co", [
    D.CellOptions(onehot_loss=True), D.CellOptions(grad_rs=True),
    D.CellOptions(strategy="tp-ep")])
def test_device_knobs_raise_naming_item_12(co):
    """``onehot_loss`` and ``grad_rs`` are counted (item 12c): the
    iota-compare loss adds work to the plain cell's, the bf16 gradient cast
    of bf16 gradients none; an ``ep`` strategy still names its item."""
    if co.ep:
        with pytest.raises(NotImplementedError, match="item 12c"):
            D.run_cell("granite-8b", "train_4k", multi_pod=False, co=co,
                       save=False)
        return
    cfg = get_config("granite-8b").reduced()
    shape = ShapeConfig("t", 64, 4, "train")
    kw = dict(multi_pod=False, save=False, cfg=cfg, shape=shape)
    base = D.run_cell("granite-8b", "t", co=D.CellOptions(q_block=16), **kw)
    got = D.run_cell("granite-8b", "t",
                     co=dataclasses.replace(co, q_block=16), **kw)
    assert got["strategy"] == "tp-" + ("vploss" if co.onehot_loss
                                       else "gradrs")
    if co.onehot_loss:          # the compare, select and sum over V
        assert got["flops_total"] > base["flops_total"]
    else:                       # bf16 gradients already: the cast is no op
        assert got["flops_total"] == base["flops_total"]
    assert got["dot_flops_total"] == base["dot_flops_total"]
    assert got["collective_bytes"] is None


@pytest.mark.parametrize("flag", [["--onehot-loss"], ["--grad-rs"],
                                  ["--strategy", "mra2-ep"]])
def test_cli_refuses_device_knobs(flag, tmp_path, capsys):
    """The CLI counts ``--onehot-loss`` and ``--grad-rs`` cells (item 12c);
    an ``ep`` strategy still names its item."""
    argv = ["--arch", "mamba2-370m", "--shape", "long_500k", "--single-pod",
            "--out-dir", str(tmp_path)] + flag
    if "mra2-ep" in flag:
        with pytest.raises(NotImplementedError, match="item 12c"):
            D.main(argv)
        return
    D.main(argv)
    assert "ALL CELLS PASSED" in capsys.readouterr().out


def test_cli_one_cell(tmp_path, capsys):
    D.main(["--arch", "mamba2-370m", "--shape", "long_500k", "--single-pod",
            "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "OK   mamba2-370m x long_500k x 1-pod(256)" in out
    assert "ALL CELLS PASSED" in out
    assert os.listdir(tmp_path) == ["mamba2-370m__long_500k__pod1.json"]


def test_every_assigned_cell_is_listed():
    from repro.configs import ASSIGNED_ARCHS
    cells = list(D.iter_cells())
    assert cells == [(a, s) for a in ASSIGNED_ARCHS
                     for s in ref_shapes_for(ref_config(a))]


def test_full_width_decode_cell_matches_the_reference():
    """danube decode_32k at full width (batch 128 over a 4,096 window):
    the dot FLOPs equal the reference's jaxpr count; the HBM bytes and the
    parameter counts are the reference's."""
    r = D.run_cell("h2o-danube-1.8b", "decode_32k", multi_pod=False,
                   save=False)
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
    assert r["roofline"]["dominant"] == "memory"
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
