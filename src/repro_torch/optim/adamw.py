"""AdamW with decoupled weight decay, schedules and global-norm clipping,
mirroring ``repro/optim/adamw.py``.

The moments are float32 whatever the parameters' dtype (bf16-safe
training).  Everything a step computes stays on the parameters' device in
float32 tensors: the schedule (``lr_at``'s cosine), the bias corrections
``b ** step`` and the clip scale ``max_norm / max(norm, 1e-9)`` are tensor
arithmetic, not Python doubles, so a step reads nothing back to the host.
Leaves are taken in the reference's order (``tree_leaves``: dict keys
sorted), which fixes the order of ``global_norm``'s sum.  ``update``
returns new parameter tensors and writes the moments in place (``mul_``,
``add_``): the same values as the reference's, with less memory.

Placed leaves (DTensors on a ``ProcessMesh``): the moments are placed like
their parameters, the update runs on each rank's blocks, and
``global_norm`` is the whole tree's: each rank adds its blocks' sums of
squares, a leaf counted once however many ranks hold it alike (weighted by
its shard count over the world size), in one all-reduce over the world.
The gradients must be the same on the ranks that hold a block alike (the
trainer reduces them over the batch axes first).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.parallel import collectives as C
from repro_torch.parallel.placement import (is_placed, like_placed, local,
                                            mesh_of)


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar on the device
    mu: Any                  # float32 tree like params
    nu: Any                  # float32 tree like params


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # cosine | linear | constant
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32 on its device."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * (1 - frac)
    else:
        decay = torch.ones_like(s)
    return cfg.lr * warm * decay


def init(params) -> AdamWState:
    """Zero float32 moments beside each parameter, step 0 (int32) on the
    parameters' device."""
    leaves = tree_leaves(params, torch.is_tensor)
    dev = leaves[0].device if leaves else None

    def f32(p):
        z = torch.zeros(local(p).shape, dtype=torch.float32, device=p.device)
        return like_placed(z, p)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(f32, params, torch.is_tensor),
                      nu=tree_map(f32, params, torch.is_tensor))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's order) of each
    leaf's float32 sum of squares; no float32 copy of a leaf is made.
    Placed leaves: the whole tree's norm on every rank (module notes)."""
    total, mesh = None, None
    for leaf in tree_leaves(tree, torch.is_tensor):
        w = 1.0
        if is_placed(leaf):
            mesh = mesh_of(leaf)
            w = leaf.numel() / local(leaf).numel() / mesh.size
            leaf = local(leaf)
        sq = torch.linalg.vector_norm(leaf, dtype=torch.float32).square()
        sq = sq * w if w != 1.0 else sq
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    if mesh is not None:
        total = C.sum_into(total.contiguous(), mesh.axis_names, mesh)
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """(grads scaled by ``min(1, max_norm / max(norm, 1e-9))``, each in its
    own dtype, and the norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads,
                    torch.is_tensor), norm


def update(cfg: AdamWConfig, grads, state: AdamWState, params
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics {"lr",
    "grad_norm"}).  The clipped gradient of a leaf is made one leaf at a
    time (in the gradient's dtype, as the reference's), never as a whole
    tree; ``state``'s moments are updated in place and returned in the new
    state."""
    flat_p = tree_leaves(params, torch.is_tensor)
    flat_g = tree_leaves(grads, torch.is_tensor)
    flat_m = [local(m) for m in tree_leaves(state.mu, torch.is_tensor)]
    flat_v = [local(v) for v in tree_leaves(state.nu, torch.is_tensor)]
    gnorm = global_norm(flat_g)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    s = step.float()
    bc1 = 1 - torch.pow(b1, s)
    bc2 = 1 - torch.pow(b2, s)
    new_p = []
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        p, g, placed = local(p), local(g), p
        g32 = (g.float() * scale).to(g.dtype).float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        del g32
        upd = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        p32 = p.float()
        upd.add_(cfg.weight_decay * p32)
        new_p.append(like_placed((p32 - lr * upd).to(p.dtype), placed))
    return (tree_unflatten(params, new_p),
            AdamWState(step=step, mu=state.mu, nu=state.nu),
            {"lr": lr, "grad_norm": gnorm})
