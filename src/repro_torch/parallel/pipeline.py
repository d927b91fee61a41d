"""Pipeline parallelism: the GPipe microbatch schedule over a ``stage`` mesh
axis, the counterpart of ``repro/parallel/pipeline.py`` (``shard_map`` +
``lax.ppermute`` there; ranks of a :class:`~repro_torch.launch.mesh.
ProcessMesh` and :func:`~repro_torch.parallel.collectives.ppermute` here).

Schedule: fill-drain.  With M microbatches and S stages it takes
T = M + S - 1 steps, and the bubble fraction is (S - 1) / (M + S - 1)
(:func:`bubble_fraction`).  At step ``t`` stage ``s`` works on microbatch
``t - s`` when ``0 <= t - s < M`` (``valid``); stage 0 reads the
microbatch, the others what the stage before sent round the ring at the end
of the step before; the last stage banks its output; a masked ``psum``
replicates the banked outputs on every stage.  Every stage runs
``stage_fn`` on every step, bubbles included, so every rank builds the same
graph and calls the same collectives in the same order; a bubble's output
is masked to zero and contributes no gradient.

The backward is autograd's: ``ppermute``'s sends the cotangent back round
the ring, and the final ``psum`` passes each rank's cotangent through (the
loss is taken from the replicated output on every rank, as the reference
takes it outside its ``shard_map``; an all-reduce there would multiply the
gradient by S).  Each rank's gradient lands in its own stage's slice of the
stacked parameters (the shard it holds, split over the axis as in the
reference); ``x``, which every stage holds alike and stage 0 alone reads,
gets its whole gradient on every stage (``replicated``).

Usage (on every rank of a mesh with a ``"stage"`` axis)::

    y = pipeline_apply(stage_fn, stage_params, x, mesh=mesh,
                       axis="stage", n_micro=8)

* ``stage_params``: a tree whose leaves have a leading ``n_stages`` dim
  (stage ``s`` uses ``leaf[s]``), as :func:`stack_layer_groups` makes;
* ``stage_fn(params_slice, x_mb) -> y_mb`` keeps the microbatch's shape;
* ``x``: (batch, ...), the same on every rank, split into ``n_micro``
  microbatches on axis 0.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils._pytree import tree_map

from repro_torch.parallel.collectives import (axis_index, ppermute, psum,
                                              replicated)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe's idle share, (S - 1) / (M + S - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   *, mesh, axis: str = "stage", n_micro: int = 4
                   ) -> torch.Tensor:
    """Run ``x`` through ``n_stages`` sequential stages, pipelined."""
    S = mesh.shape[axis]
    B = x.shape[0]
    assert B % n_micro == 0, (B, n_micro)
    M = n_micro
    xm = replicated(x, axis, mesh).reshape((M, B // M) + tuple(x.shape[1:]))
    s = axis_index(axis, mesh)
    params = tree_map(lambda a: a[s], stage_params)
    ring = [(i, (i + 1) % S) for i in range(S)]   # the wrapped send is
    #                                               masked out by ``valid``
    dev = x.device

    def flag(b: bool) -> torch.Tensor:
        return torch.tensor(bool(b), device=dev)

    # masks, not branches: every rank's graph is the same, so the backward
    # runs the same ppermutes in the same order on every rank
    first, last = flag(s == 0), flag(s == S - 1)
    buf = torch.zeros(xm.shape[1:], dtype=torch.float32, device=dev)
    banked = [torch.zeros(xm.shape[1:], dtype=torch.float32, device=dev)
              for _ in range(M)]
    for t in range(M + S - 1):
        mb = min(max(t - s, 0), M - 1)
        valid = flag(0 <= t - s < M)
        inp = torch.where(first, xm[mb].to(buf.dtype), buf)
        out = torch.where(valid, stage_fn(params, inp), 0.0)
        banked[mb] = torch.where(valid & last, out.to(torch.float32),
                                 banked[mb])
        buf = ppermute(out, axis, ring, mesh)
    outs = psum(torch.where(last, torch.stack(banked), 0.0), axis, mesh)
    return outs.reshape((B,) + tuple(outs.shape[2:])).to(x.dtype)


def stack_layer_groups(stacked_params: Any, n_stages: int) -> Any:
    """(L, ...) stacked layer params -> (S, L/S, ...) stage-stacked."""
    def one(a):
        L = a.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))
    return tree_map(one, stacked_params)
