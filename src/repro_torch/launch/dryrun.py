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
  derives from its JSON.  Its collective term is not measured:
  ``collective_bytes`` is ``null`` and ``collective_note`` says why.

The keys that name XLA artefacts (``compile_seconds``, ``hlo_*_bodyonce``,
``temp_size_in_bytes``) have no counterpart.  ``--onehot-loss`` counts the
iota-compare loss; ``--grad-rs`` counts the bf16 gradient cast, with the
per-layer ``block_pspecs`` and the gradients' specs from ``pspecs_for`` on
the cell's mesh, as the reference builds them (on a logical mesh they
move no data).  An ``ep`` strategy raises ``NotImplementedError``: the
expert-parallel cells, the collective term (the step of one rank of the
256- or 512-rank mesh run in one process) and the MRA stream split over
``replica`` wait for ROADMAP queue A item 12d, the rest of item 12c.  Every
family's train step, ``prefill`` and ``decode_step`` run from placed
parameters (a ``ProcessMesh``), so that step can be counted.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod|--single-pod]
"""
from __future__ import annotations

import argparse
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
from repro_torch.core.replication import make_mra_mesh, merged_rules
from repro_torch.core.tiles import default_plan
from repro_torch.launch import specs as SP
from repro_torch.launch.costing import flops_of_fn, hbm_bytes
from repro_torch.launch.mesh import (LogicalMesh, PartitionSpec,
                                     make_production_mesh)
from repro_torch.models.layers import AttnOptions
from repro_torch.models.params import (get_batch_axes, pspecs_for,
                                       set_batch_axes, tree_map)
from repro_torch.models.transformer import LM
from repro_torch.runtime.train import TrainConfig, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

COLLECTIVE_NOTE = (
    "not measured: the reference reads collective bytes from XLA's "
    "partitioned HLO; the port counts the collectives a step dispatches on "
    "a ProcessMesh (launch.costing.collective_stats), and the step of one "
    "rank of a 256- or 512-rank mesh run in one process waits for ROADMAP "
    "queue A item 12d, the rest of item 12c")

_ITEM_12 = ("the expert-parallel dry run is not ported yet (ROADMAP queue A "
            "item 12d, the rest of item 12c, with the collective term and "
            "the MRA stream split)")


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


def _refuse_device_knobs(co: CellOptions) -> None:
    if co.ep:
        raise NotImplementedError(f"ep={co.ep!r} ({co.strategy}): {_ITEM_12}")


def _grad_pspecs(lm: LM, plan, mesh):
    return pspecs_for(lm.param_specs(), merged_rules(plan, mesh), mesh)


def build_lm(cfg: ArchConfig, co: CellOptions, mesh=None, plan=None) -> LM:
    """The cell's model, with the reference's dry-run attention schedule
    (``chunked`` at ``q_block``, every rectangle unless ``folded``), its
    ``onehot_loss`` and, under ``grad_rs`` on a mesh, its per-layer
    ``block_pspecs`` (the stacked specs less the layer dim).  The MRA
    attention-only strategy's expert sharding (the reference's
    ``moe_axes``) acts only on devices and is not taken."""
    _refuse_device_knobs(co)
    opts = AttnOptions(backend="chunked", q_block=co.q_block,
                       kv_block=co.q_block, folded=co.folded)
    block_pspecs = None
    if co.grad_rs and mesh is not None:
        lm0 = LM(cfg, opts=opts, remat=co.remat)
        stacked = _grad_pspecs(lm0, plan or default_plan(cfg), mesh)[
            "blocks"]
        block_pspecs = tree_map(lambda ps: PartitionSpec(*tuple(ps)[1:]),
                                stacked,
                                lambda x: isinstance(x, PartitionSpec))
    kv_dtype = torch.int8 if co.kv_int8 else None
    return LM(cfg, opts=opts, remat=co.remat, kv_cache_dtype=kv_dtype,
              onehot_loss=co.onehot_loss, block_pspecs=block_pspecs)


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
    _refuse_device_knobs(co)
    cfg = cfg or get_config(arch)
    shape = shape or shapes_for(cfg)[shape_name]
    plan = default_plan(cfg)
    if co.mra_k:
        kinds = (("attn", "shared_attn") if co.mra_attn_only
                 else ("attn", "ffn", "moe", "ssm", "shared_attn"))
        for t in plan.tiles:
            if t.kind in kinds:
                plan = plan.with_replication(t.name, co.mra_k)
    lm = build_lm(cfg, co, mesh=mesh, plan=plan)
    param_sh = SP.param_shardings(lm, mesh, plan)
    params_abs = lm.abstract()

    extra = ("model",) if "fsdp" in re.split(r"[-_]", co.strategy) else ()
    prev_axes = get_batch_axes()
    set_batch_axes(tuple(a for a in ("pod", "data", "replica") + extra
                         if a in mesh.axis_names))
    try:
        arg_bytes = SP.per_device_bytes(params_abs, param_sh)
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


def roofline_of(meta: Dict[str, Any]) -> Dict[str, Any]:
    """The cell's roofline on ``H100_SXM`` at its chip count, compute and
    memory terms (the collective term is not measured)."""
    terms = roofline_from_counts(meta["flops_total"], meta["hbm_bytes_total"],
                                 0.0, meta["chips"])
    return {"device": H100_SXM.name, "t_compute": terms.t_compute,
            "t_memory": terms.t_memory, "t_collective": None,
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
    res["collective_bytes"] = None
    res["collective_note"] = COLLECTIVE_NOTE
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
    _refuse_device_knobs(co)

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
                print(f"OK   {tag}: count={r['lower_seconds']}s "
                      f"flops={r['flops_total']:.3e} "
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
