"""Training runtime of the port: the train step and the ``Trainer`` loop,
mirroring ``repro/runtime/train.py`` on one device.

* The step takes the gradients of ``LM.loss_fn`` with
  ``torch.autograd.grad`` over the parameter leaves (the trainer's
  parameters are plain tensors; the step hands the model detached leaves
  that require grad, so a ``ServeEngine`` given the same tensors launches
  its kernels as it always does).
* Microbatch accumulation (``accum``) adds each microbatch's gradients into
  float32 buffers and divides by ``accum`` at the end, as the reference's
  scan does; gradients are never summed in the parameters' dtype.
* The C3 monitor counters are charged on the device inside the step (the
  reference's ``charge_counters``), and nothing in a step reads a value
  back to the host: ``run`` turns the metrics into floats only every
  ``log_every`` steps.
* The Vespa runtime loop rides along between steps: monitor reads, the DFS
  actuator's hitless commit, async checkpoints; ``runtime.fault``'s
  ``FaultSupervisor`` restarts from the latest checkpoint.

**On a mesh** (``Trainer(mesh=)``, a
:class:`~repro_torch.launch.mesh.ProcessMesh`, one rank per position): the
parameters are drawn from the seed unsharded, then placed by the MRA rules
(``core.replication.merged_rules``, ``models.params.shardings_for`` /
``place_params``: DTensor leaves, each rank its block); the AdamW moments
are placed alike; each rank's batch is its share over the batch axes
(``data.pipeline.device_put_batch``).  A step's gradients are born as the
parameters' blocks (the model's explicit tensor parallelism), so the
reduce over the batch axes moves each rank's blocks only (the reference's
reduce-scatter to the shards): an in-place all-reduce a leaf, divided by
the batch axes' size, after the cast to bf16 under
``grad_reduce_dtype="bf16"``.  ``grad_norm`` and the clip scale are the
whole tree's (``adamw.global_norm``); the loss and its parts are averaged
over the batch axes.  ``save`` gathers each leaf to rank 0, which writes
the one file; ``restore`` lays the state out on the trainer's own mesh,
whichever mesh saved it (elastic restore).  The batch axes must not split
a weight (the FSDP layout is the dry run's alone).
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import monitor as mon
from repro_torch.core.dfs import DFSActuator
from repro_torch.core.islands import IslandConfig, default_islands
from repro_torch.core.noc import collective_bytes_ring_allreduce
from repro_torch.core.tiles import TilePlan, default_plan
from repro_torch.core.replication import (STREAM_TILES, merged_rules,
                                          split_kinds)
from repro_torch.data.pipeline import device_put_batch, for_arch, to_device
from repro_torch.device import DeviceSpec, resolve
from repro_torch.launch.mesh import ProcessMesh, Sharding, PartitionSpec
from repro_torch.models.layers import group_axes
from repro_torch.models.params import (place_params, shardings_for,
                                       tree_leaves, tree_map, tree_unflatten)
from repro_torch.models.transformer import LM
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as C
from repro_torch.parallel import placement as PL



@dataclass
class TrainConfig:
    accum: int = 1                     # microbatch accumulation factor
    log_every: int = 10
    ckpt_every: int = 0                # 0 = disabled
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "vespa_ckpt_torch"))
    monitor_every: int = 10
    grad_reduce_dtype: str = ""        # "bf16": cast grads before the
                                       # cross-device reduce (2x wire bytes)
    opt: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)

    def __post_init__(self):
        if self.grad_reduce_dtype not in ("", "bf16"):
            raise ValueError(f"grad_reduce_dtype={self.grad_reduce_dtype!r}"
                             "; '' or 'bf16'")


def step_grads(lm: LM, params, batch: Dict[str, torch.Tensor],
               accum: int = 1):
    """``(loss, parts, grads)`` of one batch: the gradients of
    ``lm.loss_fn`` with respect to every parameter leaf (in
    ``tree_leaves`` order), taken with ``torch.autograd.grad`` over detached
    leaves that require grad.  With ``accum > 1`` the batch is split into
    ``accum`` microbatches along its first dim; their gradients are added
    into float32 buffers and divided by ``accum``, and the loss and parts
    are the microbatches' means (the reference's scan).  Otherwise the
    gradients are in the parameters' dtypes.  Placed parameters: the
    gradients are this rank's blocks (plain tensors), its share of the
    batch's, and the loss its batch's."""
    leaves = tree_leaves(params, torch.is_tensor)

    def one(micro):
        req = [p.detach().requires_grad_(True) for p in leaves]
        loss, parts = lm.loss_fn(tree_unflatten(params, req), micro)
        grads = torch.autograd.grad(loss, req, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
            [PL.local(g) for g in grads]

    if accum <= 1:
        return one(batch)
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch of {b} rows does not split into {accum} "
                         f"microbatches")
    mb = b // accum
    grads = [torch.zeros(PL.local(p).shape, dtype=torch.float32,
                         device=p.device) for p in leaves]
    losses: List[torch.Tensor] = []
    parts_all: List[Dict[str, torch.Tensor]] = []
    for j in range(accum):
        l, p, g = one({k: v[j * mb:(j + 1) * mb] for k, v in batch.items()})
        for acc, gi in zip(grads, g):
            acc.add_(gi)                            # float32 += gi (upcast)
        del g
        losses.append(l)
        parts_all.append(p)
    for acc in grads:
        acc.div_(accum)
    loss = torch.stack(losses).mean()
    parts = {k: torch.stack([p[k] for p in parts_all]).mean()
             for k in parts_all[0]}
    return loss, parts, grads


def grad_axes(lm: LM, mesh) -> List[Tuple[str, ...]]:
    """The axes each gradient leaf (``tree_leaves`` order) is summed over on
    a ``ProcessMesh``: the batch axes less ``replica`` (the replica groups'
    rows), and ``replica`` too for a leaf read on the rank's own rows of a
    split stream (``LM.split_leaves``: a K > 1 tile's, replicated over
    ``replica`` and computed on different rows there).  A K = 1 tile's
    leaves are not summed over ``replica``: their blocks differ there, and
    each rank's is the whole group's already."""
    group = group_axes(mesh)
    return [group + ("replica",) if split else group
            for split in tree_leaves(lm.split_leaves(mesh),
                                     lambda x: isinstance(x, bool))]


def make_train_step(lm: LM, plan: TilePlan, mesh: Any,
                    tc: TrainConfig, grad_pspecs=None) -> Callable:
    """The train step ``(params, opt_state, batch, counters) -> (params,
    opt_state, counters, metrics)``; metrics are float32 scalars on the
    device (``loss``, ``nll``, ``aux``, ``lr``, ``grad_norm``).

    ``mesh``: ``None``, a ``LogicalMesh`` (counted only: its size enters
    the counters) or the ``ProcessMesh`` the parameters are placed on (the
    gradients reduced over its batch axes).  ``grad_pspecs``: the specs the
    gradients end in (the reference's reduce-scatter to the shards); the
    port's gradients are born as their parameters' blocks, so they must be
    the parameters' own specs (checked on the first step)."""
    cfg = lm.cfg
    n_params = cfg.n_params()
    placed = isinstance(mesh, ProcessMesh)
    gax = group_axes(mesh) if placed else ()
    n_group = C.axis_size(gax, mesh) if gax else 1
    n_batch = C.axis_size(lm.rows_axes(mesh), mesh) if placed else 1
    axes = grad_axes(lm, mesh) if placed else []
    dp_sz = 1
    if mesh is not None:
        for a in ("pod", "data"):
            if a in mesh.axis_names:
                dp_sz *= mesh.shape[a]

    def treat_grads(grads, leaves):
        """The reference's ``_treat_grads``: the cast to bf16 (on one
        device too) where it applies, then the reduce over the batch axes
        (:func:`grad_axes`; the mean over the replica groups: each rank's
        loss is its group's mean)."""
        if tc.grad_reduce_dtype == "bf16" and tc.accum <= 1:
            grads = [g.to(torch.bfloat16) for g in grads]
        if not placed:
            return grads
        if grad_pspecs is not None:
            for p, sp in zip(leaves, tree_leaves(
                    grad_pspecs, lambda x: isinstance(x, PartitionSpec))):
                if not PL.same_spec(PL.spec_of(p), sp, p.dim()):
                    raise ValueError(
                        f"grad_pspecs {sp!r} for a parameter placed "
                        f"{PL.spec_of(p)!r}: the gradients are born as "
                        "their parameters' blocks")
        out = []
        for g, p, ax in zip(grads, leaves, axes):
            g = g.contiguous()
            if ax:
                C.sum_into(g, ax, mesh)
            if n_group > 1:
                g.div_(n_group)
            out.append(PL.like_placed(g, p))
        return out

    def charge_counters(counters, batch, gnorm):
        # static per-step NoC / memory traffic, charged to the C3 counters;
        # Python numbers are filled on the device (no copy that waits)
        toks = batch["labels"].numel() * n_batch
        grad_bytes = collective_bytes_ring_allreduce(2.0 * n_params, dp_sz)
        counters = mon.charge(counters, "noc",
                              pkts_in=grad_bytes / mon.PKT_BYTES,
                              pkts_out=grad_bytes / mon.PKT_BYTES)
        # the optimizer reads params+m+v and writes them (f32 m/v, bf16 p)
        opt_bytes = n_params * (2 + 4 + 4) * 2
        counters = mon.charge(counters, "mem",
                              pkts_in=opt_bytes / 2 / mon.PKT_BYTES,
                              pkts_out=opt_bytes / 2 / mon.PKT_BYTES)
        counters = mon.charge(counters, "io", exec_time=float(toks))
        for t in plan.tiles:
            if t.kind in STREAM_TILES:
                counters = mon.charge(counters, t.name,
                                      exec_time=gnorm * 0 + 1.0)
        return counters

    def train_step(params, opt_state, batch, counters):
        leaves = tree_leaves(params, torch.is_tensor)
        loss, parts, grads = step_grads(lm, params, batch, tc.accum)
        grads = treat_grads(list(grads), leaves)
        new_params, new_opt, om = adamw.update(tc.opt, grads, opt_state,
                                               params)
        counters = charge_counters(counters, batch, om["grad_norm"])
        if gax:                # the loss and its parts: the batch's means
            keys = sorted(parts)
            vals = torch.stack([loss] + [parts[k] for k in keys]).float()
            vals = C.sum_into(vals, gax, mesh) / n_group
            loss, parts = vals[0], {k: vals[i + 1]
                                    for i, k in enumerate(keys)}
        metrics = {"loss": loss, **parts, **om}
        return new_params, new_opt, counters, metrics

    return train_step


class Trainer:
    """End-to-end training loop (``examples/torch_train_100m.py`` and
    ``launch/train.py`` use it).  ``device=None`` is the CUDA card (raises
    without one); the weights are drawn from
    ``torch.Generator(device).manual_seed(seed)``.  ``mesh``: a
    ``ProcessMesh`` to train on (its device is the rank's; the module's
    notes)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, *,
                 mesh: Any = None, tc: Optional[TrainConfig] = None,
                 plan: Optional[TilePlan] = None,
                 islands: Optional[IslandConfig] = None,
                 lm_kwargs: Optional[Dict] = None, seed: int = 0,
                 device: DeviceSpec = None):
        if mesh is not None and not isinstance(mesh, ProcessMesh):
            raise TypeError(f"Trainer(mesh={mesh!r}): a ProcessMesh "
                            "(launch.mesh.make_mesh / make_host_mesh)")
        self.device = mesh.device if mesh is not None else resolve(device)
        self.cfg = cfg
        self.shape = shape
        self.mesh = mesh
        self.tc = tc or TrainConfig()
        self.plan = plan or default_plan(cfg)
        self.islands = islands or default_islands(self.plan)
        self.actuator = DFSActuator(self.islands)
        self.monitor = mon.MonitorClient()
        kw = dict(lm_kwargs or {})
        if mesh is not None:
            kw.setdefault("mra_split", split_kinds(self.plan, mesh))
        self.lm = LM(cfg, **kw)
        self.data = for_arch(cfg, shape, seed=seed)
        self.step = 0
        self._store = None

        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.lm.init(gen)
        self.param_sh = None
        self._bax: Tuple[str, ...] = ()
        if mesh is not None:
            self._bax = self.lm.rows_axes(mesh)
            # a rule naming an axis the mesh lacks (a 1-D data mesh has no
            # "model") replicates that dim
            rules = {k: (v if all(a in mesh.axis_names
                                  for a in PL.entry_axes(v)) else None)
                     for k, v in merged_rules(self.plan, mesh).items()}
            self.param_sh = shardings_for(self.lm.param_specs(), rules, mesh)
            for sh in tree_leaves(self.param_sh,
                                  lambda x: isinstance(x, Sharding)):
                hit = set(group_axes(mesh)) & {a for e in sh.spec
                                               for a in PL.entry_axes(e)}
                if hit:
                    raise ValueError(f"the rules split a weight over the "
                                     f"batch axes {sorted(hit)}")
            self.params = place_params(self.params, self.param_sh)
        self.opt_state = adamw.init(self.params)
        self.counters = mon.init_counters(self.plan, self.device)
        self._remember_template()
        self._step = make_train_step(self.lm, self.plan, mesh, self.tc)

    # ------------------------------------------------------------------ ckpt
    def store(self):
        from repro_torch.checkpoint.store import CheckpointStore
        if self._store is None:
            self._store = CheckpointStore(self.tc.ckpt_dir)
        return self._store

    def state_tree(self):
        return {"params": self.params, "opt": self.opt_state,
                "step": torch.full((), self.step, dtype=torch.int32,
                                   device=self.device)}

    def _remember_template(self):
        """The state's shapes and dtypes (``meta`` tensors, no memory), kept
        so that a restore works even after the state is lost; taken at init
        and at every save (a caller may have replaced the parameters by
        others of other dtypes since)."""
        self._template = tree_map(
            lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta"),
            self.state_tree(), torch.is_tensor)

    def save(self, async_: bool = True):
        t = self.state_tree()
        self._remember_template()
        (self.store().save_async if async_ else self.store().save)(
            self.step, t)

    def restore(self, step: Optional[int] = None):
        """Restore the parameters, the optimizer state and the step counter
        from a checkpoint (the latest by default) onto this device, in the
        dtypes of the live state (of the last save's, once it is lost).  On
        a mesh the state is laid out on this trainer's mesh, whichever mesh
        saved it (elastic restore)."""
        if self.params is not None and self.opt_state is not None:
            self._remember_template()
        shardings = None
        if self.param_sh is not None:
            shardings = {"params": self.param_sh,
                         "opt": adamw.AdamWState(step=None, mu=self.param_sh,
                                                 nu=self.param_sh),
                         "step": None}
            self.store().wait()
        t = self.store().restore(self._template, step=step,
                                 device=self.device, shardings=shardings)
        self.params, self.opt_state = t["params"], t["opt"]
        self.step = int(t["step"])

    # ------------------------------------------------------------------ loop
    def place_batch(self, np_batch) -> Dict[str, torch.Tensor]:
        """The batch on the device; on a mesh, this rank's share over the
        batch axes."""
        if self.mesh is None:
            return to_device(np_batch, self.device)
        return device_put_batch(np_batch, self.mesh, self._bax)

    def run(self, steps: int, on_metrics: Optional[Callable] = None
            ) -> List[Tuple[int, Dict[str, float]]]:
        history = []
        for _ in range(steps):
            nb = self.data.batch_at(self.step)
            batch = self.place_batch(nb)
            self.params, self.opt_state, self.counters, m = self._step(
                self.params, self.opt_state, batch, self.counters)
            self.step += 1
            if self.tc.monitor_every and \
                    self.step % self.tc.monitor_every == 0:
                self.monitor.read(self.counters, self.step)
            if self.tc.ckpt_every and self.step % self.tc.ckpt_every == 0:
                self.save()
            # DFS hitless commit point: between steps, never mid-step
            self.islands = self.actuator.commit()
            if self.tc.log_every and self.step % self.tc.log_every == 0:
                mm = {k: float(v) for k, v in m.items()}
                history.append((self.step, mm))
                if on_metrics:
                    on_metrics(self.step, mm)
        if self._store is not None:
            self._store.wait()
        return history
