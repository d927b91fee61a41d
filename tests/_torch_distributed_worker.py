"""One rank of the ``tests/test_torch_distributed.py`` process group.

    python _torch_distributed_worker.py RANK WORLD WORKDIR [SUITE]

joins a gloo group of WORLD ranks through a file store in WORKDIR, runs
every case of SUITE (``main``, the default: 8 ranks on (data 2, model 4);
``families``: 4 ranks on (data 2, model 2), every model family trained and
served from placed parameters, and the dry run's reduced steps' collectives
counted) on the CPU and writes each case's outputs
to ``WORKDIR/<case>_rank<RANK>.npz`` (inputs from ``WORKDIR/inputs.npz``,
written by the test).  It imports torch and ``repro_torch`` only.
"""
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import parallel as P
from repro_torch.parallel import collectives as C
from repro_torch.parallel import placement as PL

DEV = "cpu"


def _save(workdir, case, rank, **arrays):
    np.savez(os.path.join(workdir, f"{case}_rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def _np(t):
    return t.detach().float().cpu().numpy()


def _unflat(inputs, prefix):
    """``prefix/a/b`` keys of the inputs file -> a nested dict of tensors
    (``prefix/0/..`` keys become a list)."""
    out = {}
    for k in inputs.files:
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(inputs[k]))

    def lists(n):
        if isinstance(n, dict):
            if n and all(k.isdigit() for k in n):
                return [lists(n[k]) for k in sorted(n, key=int)]
            return {k: lists(v) for k, v in n.items()}
        return n
    return lists(out)


def _cast(tree, dtype_tree):
    """Float leaves to the dtypes the reference's init gave them."""
    from repro_torch.models.params import tree_leaves, tree_unflatten
    got = [t.to(d.dtype) for t, d in zip(
        tree_leaves(tree, torch.is_tensor),
        tree_leaves(dtype_tree, torch.is_tensor))]
    return tree_unflatten(dtype_tree, got)


def _trainer(arch, mesh, inputs, *, dtype=None, remat=False, plan=None,
             **tkw):
    """granite-8b (or ``arch``) reduced, the reference test's setup, on
    ``mesh`` (under ``plan``), with the reference's initial weights
    carried."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.layers import AttnOptions
    from repro_torch.models.params import place_params, tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import TrainConfig, Trainer
    cfg = get_config(arch).reduced()
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=50)
    opt.update(tkw.pop("opt", {}))
    tc = TrainConfig(log_every=1, ckpt_dir=tkw.pop("ckpt_dir", "/nonexist"),
                     opt=adamw.AdamWConfig(**opt), **tkw)
    tr = Trainer(cfg, ShapeConfig("tiny", 32, 4, "train"), mesh=mesh, tc=tc,
                 plan=plan, lm_kwargs=dict(opts=AttnOptions(backend="naive"),
                                           remat=remat), device=DEV)
    full = _cast(_unflat(inputs, f"init/{arch}"), tr.lm.abstract())
    if dtype is not None:
        full = tree_map(lambda a: a.to(dtype), full, torch.is_tensor)
    tr.params = place_params(full, tr.param_sh) if mesh is not None \
        else full
    tr.opt_state = adamw.init(tr.params)
    return tr


def _full_flat(tree):
    from repro_torch.checkpoint.store import _flatten_with_paths
    return {p: _np(PL.full_tensor(t)) for p, t in _flatten_with_paths(tree)}


def _hist(h):
    return {k: np.asarray([m[k] for _, m in h]) for k in
            ("loss", "nll", "grad_norm", "lr")}


# ------------------------------------------------------------------ cases
def case_steps(rank, inputs, workdir, mesh):
    """3 steps of granite-8b reduced on (data 2, model 4): bf16 (the
    reference's dtypes), float32, float32 with a small clip, and float32
    with grad_reduce_dtype="bf16"; the losses, norms and final params."""
    out = {}
    for tag, dtype, kw, steps in (
            ("bf16", None, {}, 3), ("f32", torch.float32, {}, 3),
            ("clip", torch.float32, {"opt": {"grad_clip": 1e-3}}, 2),
            ("rd16", torch.float32, {"grad_reduce_dtype": "bf16"}, 2)):
        tr = _trainer("granite-8b", mesh, inputs, dtype=dtype, **kw)
        h = _hist(tr.run(steps))
        out.update({f"{tag}_{k}": v for k, v in h.items()})
        if tag != "bf16":
            out.update({f"{tag}_p/{p}": v
                        for p, v in _full_flat(tr.params).items()})
    _save(workdir, "steps", rank, **out)


def case_ssm_steps(rank, inputs, workdir, mesh):
    """2 float32 steps of mamba2-370m reduced on (data 2, model 4)."""
    tr = _trainer("mamba2-370m", mesh, inputs, dtype=torch.float32)
    h = _hist(tr.run(2))
    _save(workdir, "ssm_steps", rank, **h,
          **{f"p/{p}": v for p, v in _full_flat(tr.params).items()})


def case_moe_steps(rank, inputs, workdir, mesh):
    """2 float32 steps of granite-moe reduced on (data 2, model 4) and on
    (model 8); then
    ``moe_apply``'s mesh path on this rank's blocks of the expert weights
    (``blocks=True``, ``moe.expert_specs``) against the same path on the
    whole weights, expert-TP and expert-parallel: the output, the aux loss
    and every gradient (a block's against the whole gradient's block), and
    the all-gathers each ran."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MoE
    out = {}
    for tag, m in (("dm", mesh), ("m8", P.make_mesh((8,), ("model",),
                                                     device=DEV))):
        tr = _trainer("granite-moe-1b-a400m", m, inputs, dtype=torch.float32)
        out.update({f"{tag}_{k}": v for k, v in _hist(tr.run(2)).items()})
        out.update({f"{tag}_p/{p}": v
                    for p, v in _full_flat(tr.params).items()})
        del tr
    cfg = get_config("granite-moe-1b-a400m").reduced()
    layer0 = {k: v[0].float() for k, v in _unflat(
        inputs, "init/granite-moe-1b-a400m")["blocks"]["moe"].items()}
    rng = np.random.default_rng(10 + mesh.coord("data"))
    x = torch.from_numpy(rng.standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))

    def run(p, ep, blocks):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xi = x.clone().requires_grad_(True)
        C.USED.clear()
        y, aux = MoE.moe_apply(leaves, cfg, xi, mesh=mesh, ep=ep,
                               batch_axes=(), blocks=blocks)
        ((y * r).sum() + aux).backward()
        gathers = sum(v for (op, _, _), v in C.USED.items()
                      if op == "all_gather")
        return y, aux, {k: v.grad for k, v in leaves.items()}, xi.grad, \
            gathers
    for tag, ep in (("tp", False), ("ep", True)):
        specs = MoE.expert_specs(cfg, mesh, ep, None, x.shape[0] * x.shape[1],
                                 ())
        yw, aw, gw, xw, nw = run(layer0, ep, False)
        blk = {k: PL.local_block(v, specs[k], mesh) if k in specs else v
               for k, v in layer0.items()}
        yb, ab, gb, xb, nb = run(blk, ep, True)
        gap = max(float((a - b).abs().max() / b.abs().max()) for a, b in (
            [(yb, yw), (ab, aw), (xb, xw)]
            + [(gb[k], PL.local_block(gw[k], specs[k], mesh)
                if k in specs else gw[k]) for k in gw]))
        out.update({f"{tag}_gap": gap, f"{tag}_gathers": [nw, nb],
                    f"{tag}_specs": json.dumps({k: repr(v) for k, v in
                                                specs.items()})})
    _save(workdir, "moe_steps", rank, **out)


def _forward_case(arch, mesh, inputs, *, plan=None, lm_kw=None):
    """(this rank's logits gathered whole over the vocab, its batch rows,
    the placed params) of a float32 forward on ``mesh``."""
    from repro_torch.configs import get_config
    from repro_torch.core.replication import merged_rules
    from repro_torch.core.tiles import default_plan
    from repro_torch.models.layers import AttnOptions, group_axes
    from repro_torch.models.params import (place_params, shardings_for,
                                           tree_map)
    from repro_torch.models.transformer import LM
    cfg = get_config(arch).reduced()
    lm = LM(cfg, opts=AttnOptions(backend="naive"), remat=False,
            **(lm_kw or {}))
    rules = merged_rules(plan or default_plan(cfg), mesh)
    sh = shardings_for(lm.param_specs(), rules, mesh)
    full = tree_map(lambda a: a.float(), _unflat(inputs, f"init/{arch}"),
                    torch.is_tensor)
    params = place_params(full, sh)
    toks = torch.from_numpy(inputs["tokens"])
    bax = lm.rows_axes(mesh)
    n, i = C.axis_size(bax, mesh), C.axis_index(bax, mesh)
    rows = slice(i * toks.shape[0] // n, (i + 1) * toks.shape[0] // n)
    with torch.no_grad():
        logits, _ = lm.forward(params, tokens=toks[rows])
    # the logits are the replica group's rows
    gax = group_axes(mesh)
    n, i = C.axis_size(gax, mesh), C.axis_index(gax, mesh)
    rows = slice(i * toks.shape[0] // n, (i + 1) * toks.shape[0] // n)
    return lm, cfg, rules, params, logits, rows, toks


def _vocab_whole(lm, logits, mesh):
    from repro_torch.launch.mesh import set_mesh
    with set_mesh(mesh):
        vax = lm._vocab_axes(logits.shape[0], logits.shape[1])
        g = C.all_gather(logits, vax, mesh) if vax else logits[None]
    return g.permute(1, 2, 0, 3).reshape(logits.shape[0], logits.shape[1],
                                         -1)


def case_forwards(rank, inputs, workdir, mesh):
    """Float32 forwards under (data 2, model 4): plain specs, block_pspecs,
    mamba2 and granite-moe; onehot / gather losses."""
    from repro_torch.configs import get_config
    from repro_torch.core.tiles import default_plan
    from repro_torch.core.replication import merged_rules
    from repro_torch.launch.mesh import PartitionSpec
    from repro_torch.models.params import pspecs_for, tree_map
    from repro_torch.models.transformer import LM
    out = {}
    for tag, arch, kw in (("dense", "granite-8b", {}),
                          ("ssm", "mamba2-370m", {}),
                          ("moe", "granite-moe-1b-a400m", {}),
                          ("blocks", "granite-8b", "block_pspecs"),
                          ("ssm_blocks", "mamba2-370m", "block_pspecs")):
        lm_kw = {}
        if kw == "block_pspecs":
            cfg = get_config(arch).reduced()
            specs = LM(cfg).param_specs()
            stacked = pspecs_for(specs, merged_rules(default_plan(cfg), mesh),
                                 mesh)["blocks"]
            lm_kw["block_pspecs"] = tree_map(
                lambda sp: PartitionSpec(*tuple(sp)[1:]), stacked,
                lambda x: isinstance(x, PartitionSpec))
        lm, cfg, _, params, logits, rows, toks = _forward_case(
            arch, mesh, inputs, lm_kw=lm_kw)
        out[f"{tag}_logits"] = _np(_vocab_whole(lm, logits, mesh))
        out[f"{tag}_rows"] = np.arange(toks.shape[0])[rows]
    # the loss with the logits split over the vocab: iota compare, gather
    for onehot in (True, False):
        lm, cfg, _, params, _, rows, toks = _forward_case(
            "granite-8b", mesh, inputs, lm_kw={"onehot_loss": onehot})
        labels = torch.from_numpy(inputs["labels"])[rows]
        C.USED.clear()
        with torch.no_grad():
            loss, parts = lm.loss_fn(params, {"tokens": toks[rows],
                                              "labels": labels})
        gathers = sum(v for (op, _, _), v in C.USED.items()
                      if op == "all_gather")
        out[f"loss_onehot{int(onehot)}"] = _np(loss)
        out[f"loss_gathers{int(onehot)}"] = gathers
    _save(workdir, "forwards", rank, **out)


def _first_grads(tr, steps):
    """``tr.run(steps)``'s history and step 1's gradients (as AdamW
    receives them: reduced, this rank's blocks), each gathered whole."""
    import repro_torch.runtime.train as RTM
    from repro_torch.checkpoint.store import _flatten_with_paths
    update, first = RTM.adamw.update, []

    def keep(cfg_, grads, state, params):
        if not first:
            first.append(grads)
        return update(cfg_, grads, state, params)
    RTM.adamw.update = keep
    try:
        h = _hist(tr.run(steps))
    finally:
        RTM.adamw.update = update
    paths = [p for p, _ in _flatten_with_paths(tr.params)]
    return h, {p: _np(PL.full_tensor(g)) for p, g in zip(paths, first[0])}


# the MRA suite's plans: the tile kind replicated twice on (data 2,
# replica 2, shard 2)
MRA_PLANS = ("ffn", "attn")
MRA_EMBEDS_ARCH = "musicgen-large"      # a batch of embeds, not tokens


def _mra_plan(cfg, kinds):
    from repro_torch.core.tiles import default_plan
    plan = default_plan(cfg)
    for t in plan.tiles:
        if t.kind in kinds:
            plan = plan.with_replication(t.name, 2)
    return plan


def case_mra(rank, inputs, workdir):
    """(data 2, replica 2, shard 2), granite-8b reduced with the ffn tile
    replicated twice, then the attention tile: the rules and a float32
    forward (the ffn plan), 3 training steps in float32 (the losses, the
    norms, step 1's gradients whole, and the token rows each tile ran on)
    and in bf16; musicgen-large (embeds in place of tokens) 2 float32
    steps under each plan; danube's placed prefill and 4 teacher-forced decode steps
    with the attention tile replicated, then the ffn tile; granite-moe's attention and MoE
    tiles replicated, expert-parallel over ``shard`` (ample capacity), the
    MoE layer on the rank's own rows: its output and its gradients."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.replication import merged_rules, split_kinds
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import AttnOptions
    from repro_torch.models.params import (place_params, shardings_for,
                                           tree_map)
    from repro_torch.models.transformer import LM
    mesh = P.make_mesh((2, 2, 2), ("data", "replica", "shard"), device=DEV)
    cfg = get_config("granite-8b").reduced()
    plan = _mra_plan(cfg, ("ffn",))
    lm, _, rules, params, logits, rows, toks = _forward_case(
        "granite-8b", mesh, inputs, plan=plan,
        lm_kw={"mra_split": split_kinds(plan, mesh)})
    out = {"logits": _np(_vocab_whole(lm, logits, mesh)),
           "rows": np.arange(toks.shape[0])[rows],
           "rules": json.dumps({k: rules[k] for k in ("ff", "qkv")}),
           "wq_spec": repr(PL.spec_of(params["blocks"]["attn"]["wq"]))}
    for kind in MRA_PLANS:
        plan = _mra_plan(cfg, (kind,))
        for tag, dtype in (("f32", torch.float32), ("bf16", None)):
            tr = _trainer("granite-8b", mesh, inputs, dtype=dtype, plan=plan)
            with T.recording_rows() as ran:
                h, g = _first_grads(tr, 3)
            out.update({f"{kind}/{tag}_{k}": v for k, v in h.items()})
            if dtype is not None:
                out.update({f"{kind}/g/{p}": v for p, v in g.items()})
                out[f"{kind}/split"] = json.dumps(tr.lm.mra_split)
                out.update({f"{kind}/rows/{k}": _np(v)
                            for k, v in ran.items()})
    # a modality arch, whose batches carry embeds in place of tokens: 2
    # float32 steps under each plan, the losses and step 1's gradients
    acfg = get_config(MRA_EMBEDS_ARCH).reduced()
    for kind in MRA_PLANS:
        tr = _trainer(MRA_EMBEDS_ARCH, mesh, inputs, dtype=torch.float32,
                      plan=_mra_plan(acfg, (kind,)))
        with T.recording_rows() as ran:
            h, g = _first_grads(tr, 2)
        out.update({f"embeds/{kind}/{k}": v for k, v in h.items()})
        out.update({f"embeds/{kind}/g/{p}": v for p, v in g.items()})
        out[f"embeds/{kind}/recorded"] = json.dumps(sorted(ran))
    # serving: danube with the attention tile replicated twice, and with
    # the ffn tile (the attention then K = 1: its ring's window over
    # (replica, shard), its kv heads over replica)
    dcfg = get_config("h2o-danube-1.8b").reduced()
    full = tree_map(lambda a: a.float(),
                    _unflat(inputs, "init/h2o-danube-1.8b"), torch.is_tensor)
    stoks = torch.from_numpy(inputs["serve_tokens/dense"])
    for kind in MRA_PLANS:
        plan = _mra_plan(dcfg, (kind,))
        slm = LM(dcfg, opts=AttnOptions(backend="naive"),
                 mra_split=split_kinds(plan, mesh))
        sp = place_params(full, shardings_for(
            slm.param_specs(), merged_rules(plan, mesh), mesh))
        ax = slm.rows_axes(mesh)
        n, i = C.axis_size(ax, mesh), C.axis_index(ax, mesh)
        srows = slice(i * 4 // n, (i + 1) * 4 // n)
        tag = f"serve_{kind}"
        with torch.no_grad():
            with T.recording_rows() as ran:
                lg, cache = slm.prefill(sp, stoks[srows, :12], cache_len=16)
            out[f"{tag}/logits0"] = _np(lg)
            out[f"{tag}/attn_rows"] = _np(ran["attn"])
            for j in range(4):
                lg, cache = slm.decode_step(sp, cache,
                                            stoks[srows, 12 + j:13 + j])
                out[f"{tag}/logits{j + 1}"] = _np(lg)
        out[f"{tag}/rows"] = np.arange(4)[srows]
        out[f"{tag}/cache_spec"] = repr(PL.spec_of(cache["blocks"][0]))
    # mra2-ep: the MoE tile on the rank's own rows, its experts over shard
    mcfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                               capacity_factor=8.0)
    moe = {k: v.float() for k, v in
           _unflat(inputs, "init/granite-moe-1b-a400m")["blocks"][
               "moe"].items() if k != "shared"}
    moe = {k: v[0] for k, v in moe.items()}              # layer 0
    x = torch.from_numpy(inputs["mra_moe_x"])
    cot = torch.from_numpy(inputs["mra_moe_cot"])
    own = slice(C.axis_index(("data", "replica"), mesh) * 2,
                C.axis_index(("data", "replica"), mesh) * 2 + 2)
    pg = {k: v.clone().requires_grad_(True) for k, v in moe.items()}
    xg = x[own].clone().requires_grad_(True)
    with set_mesh(mesh):
        y, _ = MoE.moe_apply(pg, mcfg, xg, ep=True, batch_axes=(),
                             experts="loop")
        specs = MoE.expert_specs(mcfg, mesh, True, None, xg.shape[0] *
                                 xg.shape[1], ())
    (y * cot[own]).sum().backward()
    out["ep/out"], out["ep/rows"] = _np(y), np.arange(x.shape[0])[own]
    out["ep/x_grad"] = _np(xg.grad)
    for k, v in pg.items():        # the rank's rows' share, summed here
        out[f"ep/g/{k}"] = _np(C.psum(v.grad, ("data", "replica"), mesh))
    out["ep/specs"] = json.dumps({k: repr(v) for k, v in specs.items()})
    _save(workdir, "mra", rank, **out)


def case_placement(rank, inputs, workdir, mesh):
    """Each rank's block of each placed leaf, and the specs refused."""
    from repro_torch.checkpoint.store import _flatten_with_paths
    lm, cfg, rules, params, _, _, _ = _forward_case("granite-8b", mesh,
                                                    inputs)
    from repro_torch.launch.mesh import PartitionSpec
    blocks = {p: _np(PL.local(t)) for p, t in _flatten_with_paths(params)}
    specs = {p: repr(PL.spec_of(t)) for p, t in _flatten_with_paths(params)}
    coords = {a: mesh.coord(a) for a in mesh.axis_names}
    refused = []
    for bad in (PartitionSpec(("model", "data")), PartitionSpec("nope"),
                PartitionSpec("data", "data")):
        try:
            PL.place(torch.zeros(8, 8), bad, mesh)
            refused.append("")
        except ValueError as e:
            refused.append(str(e))
    # shard_activation on a placed activation: redistributed to the site's
    # spec (batch over data, the last dim over model)
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models.params import shard_activation
    act = torch.arange(8 * 4 * 16, dtype=torch.float32).reshape(8, 4, 16)
    placed = PL.place(act, PartitionSpec("data"), mesh)
    with set_mesh(mesh):
        moved = shard_activation(placed, ("pod", "data"), None, "model")
    act_spec = repr(PL.spec_of(moved))
    act_ok = bool(torch.equal(PL.local(moved), PL.local_block(
        act, PL.spec_of(moved), mesh)))
    # launch/specs.py on the ProcessMesh and on a LogicalMesh of its shape
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.models.params import tree_leaves
    logical = LogicalMesh(mesh.axis_shapes, mesh.axis_names)
    abs_p = lm.abstract()
    batch = SP.abstract_batch(cfg, ShapeConfig("t", 32, 4, "train"))
    from repro_torch.core.tiles import default_plan
    ctrs = SP.abstract_counters(default_plan(cfg))

    def sheets(m):
        psh = SP.param_shardings(lm, m)
        trees = (psh, SP.opt_shardings(psh, m), SP.batch_shardings(batch, m),
                 SP.counter_shardings(ctrs, m))
        specs = [[repr(x.spec) for x in tree_leaves(
            t, lambda y: hasattr(y, "spec"))] for t in trees]
        return specs, SP.per_device_bytes(abs_p, psh)
    _save(workdir, "placement", rank, **{f"b/{p}": v for p, v in
                                         blocks.items()},
          specs=json.dumps(specs), coords=json.dumps(coords),
          refused=json.dumps(refused),
          act_spec=act_spec, act_ok=act_ok,
          specs_process=json.dumps(sheets(mesh)),
          specs_logical=json.dumps(sheets(logical)))


def case_elastic(rank, inputs, workdir, mesh):
    """An (8, 8) arange placed P(data, model) on (2, 4), saved, restored on
    (4, 2) as P(model, data) and whole on rank 0; a trainer on (2, 4)
    saving at step 2 and one on (4, 2) resuming for step 3."""
    import torch.distributed as dist
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.launch.mesh import PartitionSpec, Sharding
    root = os.path.join(workdir, "ckpt_tree")
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    tree = {"x": PL.place(x, PartitionSpec("data", "model"), mesh),
            "y": PL.place(x.to(torch.bfloat16) / 7, PartitionSpec(None,
                                                                  "model"),
                          mesh)}
    store = CheckpointStore(root)
    store.save(1, tree)
    mesh42 = P.make_mesh((4, 2), ("data", "model"), device=DEV)
    like = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}
    sh = {"x": Sharding(mesh42, PartitionSpec("model", "data")),
          "y": Sharding(mesh42, PartitionSpec("data"))}
    back = store.restore(like, step=1, device=DEV, shardings=sh)
    res = {"x42": _np(PL.local(back["x"])), "y42": _np(PL.local(back["y"])),
           "x42_spec": repr(PL.spec_of(back["x"])),
           "y42_spec": repr(PL.spec_of(back["y"])),
           "coords42": json.dumps({a: mesh42.coord(a)
                                   for a in mesh42.axis_names})}
    if rank == 0:
        whole = store.restore(like, step=1, device=DEV)
        res["x1"], res["y1"] = _np(whole["x"]), _np(whole["y"])
        res["y1_bits"] = whole["y"].view(torch.int16).numpy()
    res["y42_bits"] = PL.local(back["y"]).view(torch.int16).numpy()
    dist.barrier()

    # the trainer: (2, 4) saves at step 2; (4, 2) restores, takes step 3
    ck = os.path.join(workdir, "ckpt_trainer")
    a = _trainer("granite-8b", mesh, inputs, dtype=torch.float32,
                 ckpt_dir=ck)
    ha = _hist(a.run(2))
    a.save(async_=False)
    b = _trainer("granite-8b", mesh42, inputs, dtype=torch.float32,
                 ckpt_dir=ck)
    b.restore()
    hb = _hist(b.run(1))
    res.update({f"a_{k}": v for k, v in ha.items()})
    res.update({f"b_{k}": v for k, v in hb.items()})
    res["b_step"] = b.step
    _save(workdir, "elastic", rank, **res)


# ------------------------------------------- the families suite, (2, 2)
FAMILY_STEPS = ("zamba2-7b", "deepseek-v2-lite-16b")
# (tag, arch, prompt length, cache_len): each family served from placed
# parameters; "empty" leaves model rank 1's half of the ring unwritten
# through every decode step, "wrap" rolls a longer prompt into the ring
SERVE_CASES = (("dense", "h2o-danube-1.8b", 12, 16),
               ("wrap", "h2o-danube-1.8b", 40, 24),
               ("empty", "h2o-danube-1.8b", 3, 16),
               ("moe", "granite-moe-1b-a400m", 12, 16),
               ("ssm", "mamba2-370m", 12, 16),
               ("hybrid", "zamba2-7b", 12, 16),
               ("mla", "deepseek-v2-lite-16b", 12, 16),
               ("mla_empty", "deepseek-v2-lite-16b", 3, 16))
DECODE_STEPS = 4


def case_family_steps(rank, inputs, workdir, mesh):
    """2 steps of zamba2 and deepseek-v2-lite reduced on (data 2, model 2):
    bf16 (the reference's dtypes) and float32, the float32 zamba2 run also
    with remat (the shared tile inside each block's checkpoint); deepseek
    in float32 on (data 1, model 4) too, where its load-balance loss is
    the whole batch's as on one device.  The float32 runs' parameters after
    the steps, gathered whole."""
    out = {}
    m14 = P.make_mesh((1, 4), ("data", "model"), device=DEV)
    own = {"zamba2-7b": "f32remat", "deepseek-v2-lite-16b": "f32m4"}
    for arch in FAMILY_STEPS:
        for tag, dtype, remat, m in (
                ("bf16", None, False, mesh),
                ("f32", torch.float32, False, mesh),
                ("f32remat", torch.float32, True, mesh),
                ("f32m4", torch.float32, False, m14)):
            if tag in ("f32remat", "f32m4") and tag != own[arch]:
                continue
            tr = _trainer(arch, m, inputs, dtype=dtype, remat=remat)
            out.update({f"{arch}/{tag}_{k}": v
                        for k, v in _hist(tr.run(2)).items()})
            if dtype is not None:
                out.update({f"{arch}/{tag}_p/{p}": v
                            for p, v in _full_flat(tr.params).items()})
    _save(workdir, "family_steps", rank, **out)


def case_family_serve(rank, inputs, workdir, mesh):
    """Each SERVE_CASES model (float32, naive attention) placed by the MRA
    rules: ``prefill`` of this rank's rows of the 4 prompts, then
    ``DECODE_STEPS`` ``decode_step``s on the placed cache, teacher-forced
    by the inputs' next tokens; the logits of every call, each cache leaf's
    spec and its block after the prefill and after the last step."""
    from repro_torch.checkpoint.store import _flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.core.replication import merged_rules
    from repro_torch.core.tiles import default_plan
    from repro_torch.launch.mesh import PartitionSpec
    from repro_torch.launch.specs import cache_specs
    from repro_torch.models.layers import AttnOptions, batch_axes
    from repro_torch.models.params import place_params, shardings_for, \
        tree_map
    from repro_torch.models.transformer import LM
    bax = batch_axes(mesh)
    n, i = C.axis_size(bax, mesh), C.axis_index(bax, mesh)
    out = {}
    for tag, arch, S, W in SERVE_CASES:
        cfg = get_config(arch).reduced()
        lm = LM(cfg, opts=AttnOptions(backend="naive"))
        sh = shardings_for(lm.param_specs(),
                           merged_rules(default_plan(cfg), mesh), mesh)
        full = tree_map(lambda a: a.float(), _unflat(inputs, f"init/{arch}"),
                        torch.is_tensor)
        params = place_params(full, sh)
        toks = torch.from_numpy(inputs[f"serve_tokens/{tag}"])
        B = toks.shape[0]
        rows = slice(i * B // n, (i + 1) * B // n)
        with torch.no_grad():
            before = dict(C.USED)
            logits, cache = lm.prefill(params, toks[rows, :S], cache_len=W)
            out[f"{tag}/prefill_used"] = json.dumps(
                {k[0]: v - before.get(k, 0) for k, v in C.USED.items()
                 if v != before.get(k, 0)})
            out[f"{tag}/logits0"] = _np(logits)
            ndim = {p: t.dim() for p, t in _flatten_with_paths(cache)}

            def dims(p, sp):        # each dim's axes, whatever the spelling
                return [list(PL.entry_axes(e)) for e in
                        tuple(sp) + (None,) * (ndim[p] - len(sp))]
            got = {p: dims(p, PL.spec_of(t))
                   for p, t in _flatten_with_paths(cache)}
            want = {p: dims(p, sp) for p, sp in _flatten_with_paths(
                cache_specs(lm, B, W, mesh),
                is_leaf=lambda x: isinstance(x, PartitionSpec))}
            out[f"{tag}/specs"] = json.dumps([got, want])
            out.update({f"{tag}/c0/{p}": _np(PL.local(t)).copy()
                        for p, t in _flatten_with_paths(cache)})
            for j in range(DECODE_STEPS):
                logits, cache = lm.decode_step(params, cache,
                                               toks[rows, S + j:S + j + 1])
                out[f"{tag}/logits{j + 1}"] = _np(logits)
            out.update({f"{tag}/c1/{p}": _np(PL.local(t))
                        for p, t in _flatten_with_paths(cache)})
        out[f"{tag}/rows"] = np.arange(B)[rows]
    # LM.init_cache's cache, this rank's block of each leaf placed by
    # place_cache: decode from position 0, model rank 1's half of the ring
    # never written
    from repro_torch.launch.specs import place_cache
    from repro_torch.models.params import tree_leaves, tree_unflatten
    cfg = get_config("h2o-danube-1.8b").reduced()
    lm = LM(cfg, opts=AttnOptions(backend="naive"))
    params = place_params(tree_map(
        lambda a: a.float(), _unflat(inputs, "init/h2o-danube-1.8b"),
        torch.is_tensor), shardings_for(lm.param_specs(), merged_rules(
            default_plan(cfg), mesh), mesh))
    toks = torch.from_numpy(inputs["serve_tokens/dense"])
    whole = lm.init_cache(toks.shape[0], 16, dtype=torch.float32)
    specs = tree_leaves(cache_specs(lm, toks.shape[0], 16, mesh),
                        lambda x: isinstance(x, PartitionSpec))
    cache = place_cache(lm, tree_unflatten(whole, [
        PL.local_block(t, sp, mesh) for t, sp in zip(
            tree_leaves(whole, torch.is_tensor), specs)]), mesh, 16)
    with torch.no_grad():
        for j in range(DECODE_STEPS):
            logits, cache = lm.decode_step(params, cache,
                                           toks[rows, j:j + 1])
            out[f"init/logits{j}"] = _np(logits)
    out["coords"] = json.dumps({a: mesh.coord(a) for a in mesh.axis_names})
    _save(workdir, "family_serve", rank, **out)


# the dry run's reduced cells whose collectives the families suite counts
# on its 4 ranks: (tag, arch, kind, strategy, mesh shape, axis names); the
# test counts the same steps on a fake process group of the same shape
DRY_CELLS = (("tp_train", "granite-moe-1b-a400m", "train", "tp", (2, 2),
              ("data", "model")),
             ("ep_train", "granite-moe-1b-a400m", "train", "tp-ep", (2, 2),
              ("data", "model")),
             ("tp_decode", "h2o-danube-1.8b", "decode", "tp", (2, 2),
              ("data", "model")),
             ("mra_train", "h2o-danube-1.8b", "train", "mra2-attn",
              (1, 2, 2), ("data", "replica", "shard")),
             ("mra_prefill", "zamba2-7b", "prefill", "mra2", (1, 2, 2),
              ("data", "replica", "shard")),
             ("mra_decode", "deepseek-v2-lite-16b", "decode", "mra2",
              (1, 2, 2), ("data", "replica", "shard")))
DRY_SEQ, DRY_BATCH = 32, 4


def case_dry_count(rank, inputs, workdir, mesh):
    """``launch.costing.collective_stats`` of each ``DRY_CELLS`` step (the
    dry run's model, plan and rules for the strategy; zeros placed as the
    dry run places them) on these gloo ranks."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.costing import (collective_stats, placed_inputs,
                                            placed_step)
    from repro_torch.runtime.train import TrainConfig
    out = {}
    for tag, arch, kind, strategy, shape, names in DRY_CELLS:
        m = mesh if tuple(shape) == mesh.axis_shapes else P.make_mesh(
            shape, names, device=DEV)
        cfg = get_config(arch).reduced()
        co = D.CellOptions(strategy=strategy, q_block=16)
        plan = D.cell_plan(cfg, co)
        lm = D.build_lm(cfg, co, mesh=m, plan=plan)
        args = placed_inputs(lm, kind, DRY_BATCH, DRY_SEQ, m, plan,
                             D.rules_override(co, m))
        out[tag] = json.dumps(collective_stats(
            placed_step(lm, kind, plan, m, TrainConfig()), *args))
    _save(workdir, "dry_count", rank, **out)


SUITES = {"main": ((2, 4), ("placement", "forwards", "mra", "steps",
                            "ssm_steps", "moe_steps", "elastic")),
          "families": ((2, 2), ("family_serve", "family_steps",
                                "dry_count"))}


def main():
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    suite = sys.argv[4] if len(sys.argv) > 4 else "main"
    torch.manual_seed(0)
    torch.set_num_threads(1)
    backend = C.init_process_group(
        rank, world, "file://" + os.path.join(workdir, "store"), device=DEV)
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    shape, cases = SUITES[suite]
    mesh = P.make_mesh(shape, ("data", "model"), device=DEV)
    times = {}
    for case in cases:
        fn = globals()[f"case_{case}"]
        t0 = time.perf_counter()
        fn(rank, inputs, workdir, *(() if case == "mra" else (mesh,)))
        times[fn.__name__] = time.perf_counter() - t0
    import torch.distributed as dist
    dist.barrier()
    used = {"/".join(k): v for k, v in sorted(C.USED.items())}
    print("RESULT " + json.dumps({"rank": rank, "backend": backend,
                                  "used": used, "seconds": times}),
          flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
