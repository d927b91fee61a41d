"""Dry run: every (arch x shape x mesh) cell, counted abstractly.

The counterpart of the reference's ``launch/dryrun.py``, with its CLI
flags and ``CellOptions`` knobs.  The reference lowers and compiles each
cell for 512 host placeholder devices and reads XLA's cost and memory
analyses; the port has no SPMD partitioner, so each cell is worked out on a
:class:`~repro_torch.launch.mesh.LogicalMesh` with nothing allocated and
nothing launched:

* ``flops_total`` / ``dot_flops_total`` — the step's FLOPs counted by
  ``launch.costing.flops_of_fn`` on meta inputs (the reference's
  ``jaxpr_flops_total``; layer, rectangle and SSD-chunk loops counted once
  and multiplied, as the reference's scans);
* ``hbm_bytes_total`` — ``launch.costing.hbm_bytes``, the reference's
  formula;
* ``argument_size_in_bytes`` — what one device holds of the step's
  arguments (parameters, optimizer state, batch or cache, counters) under
  the cell's shardings (``launch.specs.per_device_bytes``);
* ``roofline`` — ``core.perfmodel.roofline_from_counts`` on ``H100_SXM``
  at the cell's chip count, what the reference's ``benchmarks/roofline.py``
  derives from its JSON, its collective term on ``H100_SXM.link_bw``;
* ``collective_bytes`` / ``per_op_bytes`` / ``op_counts`` — the
  collectives of one rank's placed step (``make_train_step``'s,
  ``LM.prefill`` or ``LM.decode_step``, parameters placed by the cell's
  rules, the cache by ``launch.specs.place_cache``) on the cell's mesh of
  256 or 512 ranks, run in this process on fake tensors over a fake process
  group (``launch.mesh.counting_mesh``, ``launch.costing.
  placed_step_count``): per-device ring wire bytes, as the reference reads
  them from the partitioned HLO, and equal op by op to what the same step
  dispatches on real ranks;
* ``param_bytes_per_device`` — what one device holds of the parameters.

The keys that name XLA artefacts (``compile_seconds``, ``hlo_*_bodyonce``,
``temp_size_in_bytes``) have no counterpart.  ``--onehot-loss`` counts the
iota-compare loss; ``--grad-rs`` counts the bf16 gradient cast, with the
per-layer ``block_pspecs`` and the gradients' specs from ``pspecs_for`` on
the cell's mesh, as the reference builds them.  The strategies: ``tp``;
``ep`` / ``tp-ep`` (``LM(moe_ep=True)``, the experts over the model axis:
the reference's ``rules_override``); ``mra<K>`` (every compute tile
replicated K times on the K-factored mesh, its stream split over
``replica``: ``LM(mra_split=)``), ``mra<K>-attn`` (the attention tiles
only, the MoE experts over ``(replica, shard)``: the reference's
``moe_axes``) and ``mra<K>-ep``; ``fsdp``, whose batch is split over
``model`` too, has no placed step in the port (no module gathers a layer's
weights over ``model``), so its cells carry ``collective_bytes: null``
with ``collective_note`` naming ROADMAP queue A item 12f, their FLOPs and
bytes counted as every cell's.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod|--single-pod]
  python -m repro_torch.launch.dryrun --all --single-pod --strategy ep
  python -m repro_torch.launch.dryrun --all --single-pod --strategy mra4-attn
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config, shapes_for
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.perfmodel import H100_SXM, roofline_from_counts
from repro_torch.core.replication import (make_mra_mesh, merged_rules,
                                          split_kinds)
from repro_torch.core.tiles import default_plan
from repro_torch.launch import specs as SP
from repro_torch.launch.costing import (flops_of_fn, hbm_bytes,
                                       placed_step_count)
from repro_torch.launch.mesh import (LogicalMesh, PartitionSpec,
                                     counting_mesh, make_production_mesh)
from repro_torch.models.layers import AttnOptions
from repro_torch.models.params import (get_batch_axes, mesh_axis_size,
                                       pspecs_for, set_batch_axes, tree_map)
from repro_torch.parallel import collectives as C
from repro_torch.models.transformer import LM
from repro_torch.runtime.train import TrainConfig, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

FSDP_NOTE = (
    "not counted: fsdp splits the batch over model too, and no module of "
    "the port has that placed step (per-layer weight gathers over model); "
    "ROADMAP queue A item 12f")


@dataclass(frozen=True)
class CellOptions:
    """One design point for a cell.

    strategy: 'tp' (paper-faithful baseline: 16-way tensor parallel over
    the model axis), 'fsdp' (batch also sharded over the model axis),
    'mra<K>' (Vespa C1: K-factored mesh, replicated tiles, stream split
    over the replica axis; 'mra<K>-attn' replicates the attention tiles
    only).
    """
    strategy: str = "tp"
    folded: bool = False           # folded-triangle causal schedule
    onehot_loss: bool = False      # vocab-parallel gold extraction
    grad_rs: bool = False          # bf16 grads + reduce-scatter to shards
    kv_int8: bool = False          # quantized decode cache (MLA)
    remat: bool = True
    accum: int = 1
    q_block: int = 512

    @property
    def ep(self) -> bool:
        return "ep" in re.split(r"[-_]", self.strategy)

    @property
    def mra_k(self) -> int:
        m = re.search(r"mra(\d+)", self.strategy)
        return int(m.group(1)) if m else 0

    @property
    def mra_attn_only(self) -> bool:
        return "attn" in self.strategy

    def tag(self) -> str:
        parts = [self.strategy]
        if self.folded:
            parts.append("folded")
        if self.onehot_loss:
            parts.append("vploss")
        if self.grad_rs:
            parts.append("gradrs")
        if self.kv_int8:
            parts.append("kvint8")
        if not self.remat:
            parts.append("noremat")
        if self.accum > 1:
            parts.append(f"acc{self.accum}")
        return "-".join(parts)


def _grad_pspecs(lm: LM, plan, mesh):
    return pspecs_for(lm.param_specs(), merged_rules(plan, mesh), mesh)


def build_lm(cfg: ArchConfig, co: CellOptions, mesh=None, plan=None) -> LM:
    """The cell's model, with the reference's dry-run attention schedule
    (``chunked`` at ``q_block``, every rectangle unless ``folded``), its
    ``onehot_loss``, ``moe_ep`` under an ``ep`` strategy, the reference's
    ``moe_axes`` under ``mra<K>-attn`` (the experts keep the whole fabric)
    and, on a mesh, the plan's stream split (``mra_split``) and under
    ``grad_rs`` its per-layer ``block_pspecs`` (the stacked specs less the
    layer dim)."""
    opts = AttnOptions(backend="chunked", q_block=co.q_block,
                       kv_block=co.q_block, folded=co.folded)
    plan = plan or default_plan(cfg)
    block_pspecs = None
    if co.grad_rs and mesh is not None:
        lm0 = LM(cfg, opts=opts, remat=co.remat)
        stacked = _grad_pspecs(lm0, plan, mesh)["blocks"]
        block_pspecs = tree_map(lambda ps: PartitionSpec(*tuple(ps)[1:]),
                                stacked,
                                lambda x: isinstance(x, PartitionSpec))
    moe_axes = ("replica", "shard") if co.mra_k and co.mra_attn_only \
        else None
    kv_dtype = torch.int8 if co.kv_int8 else None
    return LM(cfg, opts=opts, remat=co.remat, kv_cache_dtype=kv_dtype,
              onehot_loss=co.onehot_loss, moe_ep=co.ep, moe_axes=moe_axes,
              block_pspecs=block_pspecs,
              mra_split=split_kinds(plan, mesh) if mesh is not None else ())


def rules_override(co: CellOptions, mesh) -> Optional[Dict[str, Any]]:
    """The reference's expert-parallel rules (the experts over the model
    axis: ``shard`` on a K-factored mesh) under an ``ep`` strategy."""
    if not co.ep:
        return None
    return {"experts": "shard" if "shard" in mesh.axis_names else "model",
            "expert_ff": None}


def cell_plan(cfg: ArchConfig, co: CellOptions):
    """The default plan, its compute tiles (the attention ones under
    ``-attn``) replicated ``mra_k`` times."""
    plan = default_plan(cfg)
    if co.mra_k:
        kinds = (("attn", "shared_attn") if co.mra_attn_only
                 else ("attn", "ffn", "moe", "ssm", "shared_attn"))
        for t in plan.tiles:
            if t.kind in kinds:
                plan = plan.with_replication(t.name, co.mra_k)
    return plan


def make_cell_mesh(co: CellOptions, multi_pod: bool) -> LogicalMesh:
    if co.mra_k:
        return make_mra_mesh(co.mra_k, multi_pod=multi_pod)
    return make_production_mesh(multi_pod=multi_pod)


def lower_cell(arch: str, shape_name: str, mesh: LogicalMesh, *,
               co: CellOptions = CellOptions(),
               cfg: Optional[ArchConfig] = None,
               shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
    """One cell's meta: the reference's keys, counted abstractly.  ``cfg``
    and ``shape`` stand in for the registered config and its shape (a
    reduced cell)."""
    cfg = cfg or get_config(arch)
    shape = shape or shapes_for(cfg)[shape_name]
    plan = cell_plan(cfg, co)
    lm = build_lm(cfg, co, mesh=mesh, plan=plan)
    param_sh = SP.param_shardings(lm, mesh, plan, rules_override(co, mesh))
    params_abs = lm.abstract()

    extra = ("model",) if "fsdp" in re.split(r"[-_]", co.strategy) else ()
    prev_axes = get_batch_axes()
    set_batch_axes(tuple(a for a in ("pod", "data", "replica") + extra
                         if a in mesh.axis_names))
    try:
        param_bytes = arg_bytes = SP.per_device_bytes(params_abs, param_sh)
        if shape.kind == "train":
            opt_abs = SP.abstract_opt_state(params_abs)
            batch_abs = SP.abstract_batch(cfg, shape)
            ctr_abs = SP.abstract_counters(plan)
            arg_bytes += SP.per_device_bytes(
                opt_abs, SP.opt_shardings(param_sh, mesh))
            arg_bytes += SP.per_device_bytes(
                batch_abs, SP.batch_shardings(batch_abs, mesh, extra))
            arg_bytes += SP.per_device_bytes(
                ctr_abs, SP.counter_shardings(ctr_abs, mesh))
        elif shape.kind == "prefill":
            tok_abs = SP.abstract_prefill_tokens(shape)
            arg_bytes += SP.per_device_bytes(
                tok_abs, SP.batch_shardings(tok_abs, mesh, extra))
        else:
            cache_abs, tok_abs = SP.abstract_decode_inputs(lm, shape)
            arg_bytes += SP.per_device_bytes(
                cache_abs, SP.cache_shardings(lm, cache_abs, mesh))
            arg_bytes += SP.per_device_bytes(
                tok_abs, SP.batch_shardings(tok_abs, mesh))

        meta: Dict[str, Any] = {
            "arch": arch, "shape": shape_name, "kind": shape.kind,
            "mesh": dict(mesh.shape), "n_params": cfg.n_params(),
            "n_active_params": cfg.n_active_params(),
            "strategy": co.tag(),
            "tokens": shape.global_batch * (shape.seq_len
                                            if shape.kind != "decode"
                                            else 1)}
        count = _flops_for(lm, plan, cfg, shape, accum=co.accum,
                           grad_rs=co.grad_rs, mesh=mesh)
        meta["flops_total"] = count.total
        meta["dot_flops_total"] = count.dot
        meta["hbm_bytes_total"] = hbm_bytes(cfg, shape,
                                            mra_k=max(co.mra_k, 1),
                                            kv_int8=co.kv_int8)
        meta["mra_k"] = max(co.mra_k, 1)
        meta["argument_size_in_bytes"] = int(arg_bytes)
        meta["param_bytes_per_device"] = int(param_bytes)
    finally:
        set_batch_axes(prev_axes)
    return meta


def _flops_for(lm: LM, plan, cfg, shape, *, accum: int = 1,
               grad_rs: bool = False, mesh=None):
    """Count the same step abstractly (a logical mesh moves no data)."""
    params_abs = lm.abstract()
    if shape.kind == "train":
        tc = TrainConfig(accum=accum,
                         grad_reduce_dtype="bf16" if grad_rs else "")
        gps = _grad_pspecs(lm, plan, mesh) if grad_rs and mesh else None
        step = make_train_step(lm, plan, None, tc, grad_pspecs=gps)
        return flops_of_fn(step, params_abs,
                           SP.abstract_opt_state(params_abs),
                           SP.abstract_batch(cfg, shape),
                           SP.abstract_counters(default_plan(cfg)))
    if shape.kind == "prefill":
        return flops_of_fn(lambda p, t: lm.prefill(p, t), params_abs,
                           SP.abstract_prefill_tokens(shape))
    cache_abs, tok_abs = SP.abstract_decode_inputs(lm, shape)
    return flops_of_fn(lambda p, c, t: lm.decode_step(p, c, t), params_abs,
                       cache_abs, tok_abs)


def count_collectives(arch: str, shape_name: str, mesh: LogicalMesh, *,
                      co: CellOptions = CellOptions(),
                      cfg: Optional[ArchConfig] = None,
                      shape: Optional[ShapeConfig] = None
                      ) -> Dict[str, Any]:
    """The collectives of one rank's placed step of the cell on a fake
    process group of ``mesh``'s shape (``launch.costing.
    placed_step_count``): ``collective_bytes``, ``per_op_bytes`` and
    ``op_counts``.  The batch is split over (pod, data) less the trailing
    axes it does not divide (the reference's ``batch_shardings``: a
    one-row batch on every rank), and over ``replica`` where it divides
    that too (else the replicated tiles take their replica group's rows
    whole on ``shard``, ``LM(mra_rows=False)``, as GSPMD computes a
    replicated batch).  Sets up and tears down the
    process's default group, so it runs where there is none (the module's
    notes)."""
    cfg = cfg or get_config(arch)
    shape = shape or shapes_for(cfg)[shape_name]
    plan = cell_plan(cfg, co)
    tc = TrainConfig(accum=co.accum,
                     grad_reduce_dtype="bf16" if co.grad_rs else "")
    B = shape.global_batch
    group = [a for a in ("pod", "data") if a in mesh.axis_names]
    while group and B % mesh_axis_size(mesh, tuple(group)):
        group.pop()
    prev = get_batch_axes()
    set_batch_axes(tuple(group))
    try:
        with counting_mesh(mesh.axis_shapes, mesh.axis_names) as pm:
            lm = build_lm(cfg, co, mesh=pm, plan=plan)
            if B % C.axis_size(lm.rows_axes(pm), pm):
                lm = dataclasses.replace(lm, mra_rows=False)
            count = placed_step_count(lm, shape.kind, B, shape.seq_len, pm,
                                      plan, tc=tc,
                                      rules_override=rules_override(co, pm))
    finally:
        set_batch_axes(prev)
    return {"collective_bytes": count.collective_bytes,
            "per_op_bytes": dict(count.per_op_bytes),
            "op_counts": dict(count.op_counts)}


def roofline_of(meta: Dict[str, Any]) -> Dict[str, Any]:
    """The cell's roofline on ``H100_SXM`` at its chip count: the compute,
    memory and collective terms (the last ``None`` where the collectives
    are not counted, and left out of the bound)."""
    coll = meta.get("collective_bytes")
    terms = roofline_from_counts(meta["flops_total"], meta["hbm_bytes_total"],
                                 coll or 0.0, meta["chips"])
    return {"device": H100_SXM.name, "t_compute": terms.t_compute,
            "t_memory": terms.t_memory,
            "t_collective": None if coll is None else terms.t_collective,
            "dominant": terms.dominant, "t_bound": terms.t_bound,
            "roofline_fraction": terms.roofline_fraction}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             co: CellOptions = CellOptions(), save: bool = True,
             out_dir: Optional[str] = None,
             cfg: Optional[ArchConfig] = None,
             shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
    mesh = make_cell_mesh(co, multi_pod)
    t0 = time.monotonic()
    res = lower_cell(arch, shape_name, mesh, co=co, cfg=cfg, shape=shape)
    res["lower_seconds"] = round(time.monotonic() - t0, 2)
    res["multi_pod"] = multi_pod
    res["folded"] = co.folded
    res["chips"] = mesh.size
    t0 = time.monotonic()
    if "fsdp" in re.split(r"[-_]", co.strategy):
        res.update(collective_bytes=None, per_op_bytes=None, op_counts=None,
                   collective_note=FSDP_NOTE)
    else:
        res.update(count_collectives(arch, shape_name, mesh, co=co, cfg=cfg,
                                     shape=shape))
    res["count_seconds"] = round(time.monotonic() - t0, 2)
    res["roofline"] = roofline_of(res)
    if save:
        out_dir = out_dir or OUT_DIR
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
        if co.tag() != "tp":
            tag += "__" + co.tag()
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1, sort_keys=True)
    return res


def iter_cells():
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape_name in shapes_for(cfg):
            yield arch, shape_name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--folded", action="store_true")
    ap.add_argument("--onehot-loss", action="store_true")
    ap.add_argument("--strategy", default="tp")
    ap.add_argument("--grad-rs", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--out-dir", default=None,
                    help=f"where the JSONs go (default {OUT_DIR})")
    args = ap.parse_args(argv)
    co = CellOptions(strategy=args.strategy, folded=args.folded,
                     onehot_loss=args.onehot_loss, grad_rs=args.grad_rs,
                     kv_int8=args.kv_int8,
                     remat=not args.no_remat, accum=args.accum)

    pods = []
    if args.multi_pod or not args.single_pod:
        pods.append(True)
    if args.single_pod or not args.multi_pod:
        pods.append(False)
    pods = sorted(set(pods))       # False (single) first

    cells = list(iter_cells()) if args.all else [(args.arch, args.shape)]
    failures = []
    for arch, shape_name in cells:
        for mp in pods:
            tag = (f"{arch} x {shape_name} x "
                   f"{'2-pod(512)' if mp else '1-pod(256)'}")
            try:
                r = run_cell(arch, shape_name, multi_pod=mp, co=co,
                             out_dir=args.out_dir)
                coll = r["collective_bytes"]
                print(f"OK   {tag}: count={r['lower_seconds']}s "
                      f"+{r['count_seconds']}s "
                      f"flops={r['flops_total']:.3e} "
                      f"coll={'null' if coll is None else f'{coll:.3e}B'} "
                      f"dot={r['dot_flops_total']:.3e} "
                      f"hbm={r['hbm_bytes_total']:.3e}B "
                      f"args/dev={r['argument_size_in_bytes']:.3e}B "
                      f"bound={r['roofline']['dominant']}", flush=True)
            except Exception as e:
                failures.append((tag, repr(e)))
                print(f"FAIL {tag}: {e!r}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print("\nALL CELLS PASSED")


if __name__ == "__main__":
    main()
