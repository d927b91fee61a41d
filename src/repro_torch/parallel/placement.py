"""Tensors placed on a :class:`~repro_torch.launch.mesh.ProcessMesh` by a
``PartitionSpec``: the port's counterpart of the reference's
``NamedSharding`` placement under ``jax.jit``.

A placed tensor is a ``torch.distributed.tensor.DTensor`` whose local
tensor is this rank's block: dim ``d`` split over the mesh axes of the
spec's entry ``d``, row-major over a tuple of axes (the first axis the
major one, as JAX orders ``P(("replica", "shard"))``).  DTensor orders the
``Shard(d)`` placements of one dim by mesh dimension, so a tuple entry must
follow the mesh's axis order; one that does not raises ``ValueError``
naming it, and is never reordered.

Nothing here moves data with DTensor's own collectives: a block is cut from
the full tensor every rank holds (:func:`place`, bit for bit), and the
gathers (:func:`full_tensor`, :func:`relayout`) run on the explicit
collectives of :mod:`repro_torch.parallel.collectives` (gloo or NCCL by the
tensors), so every byte they move is in ``collectives.USED`` and in
``launch.costing.collective_stats``.

:func:`relayout` moves a rank's block from one spec to another with
autograd: a gather's backward keeps this rank's block of the gradient (the
gradient of a tensor every rank of the gathered axes uses alike is the same
on each of them), a slice's backward gathers the ranks' blocks.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch import compat
from repro_torch.launch.mesh import (PartitionSpec, ProcessMesh, _entry,
                                     check_spec, entry_axes,  # noqa: F401
                                     placements_for)
from repro_torch.parallel import collectives as C


def spec_of(t: torch.Tensor) -> PartitionSpec:
    """The spec of a placed tensor, one entry a dim (``PartitionSpec()``
    for a plain one)."""
    T = compat.dtensor()
    DTensor, Replicate, Shard = T.DTensor, T.Replicate, T.Shard
    if not isinstance(t, DTensor):
        return PartitionSpec()
    names = t.device_mesh.mesh_dim_names
    ents: List[List[str]] = [[] for _ in range(t.ndim)]
    for name, pl in zip(names, t.placements):
        if isinstance(pl, Shard):
            ents[pl.dim].append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl!r} of a placed tensor: only "
                             "Shard and Replicate are laid out by a spec")
    return PartitionSpec(*(_entry(e) for e in ents))


def is_placed(t) -> bool:
    return isinstance(t, compat.dtensor().DTensor)


# the ProcessMesh of each device mesh seen, the oldest dropped past the
# bound (a dropped entry is made again on its next use)
_MESHES: dict = {}
_MESHES_MAX = 16


def mesh_of(t) -> ProcessMesh:
    """The :class:`ProcessMesh` of a placed tensor's device mesh."""
    dm = t.device_mesh
    m = _MESHES.get(id(dm))
    if m is None or m.device_mesh is not dm:
        while len(_MESHES) >= _MESHES_MAX:
            _MESHES.pop(next(iter(_MESHES)))
        m = _MESHES[id(dm)] = ProcessMesh(dm, t.device)  # repro: noqa[TPR002] a placed tensor lies on its mesh's device type at this rank's index: dm decides t.device
    return m


def block(n: int, i: int, size: int, what: str = "") -> Tuple[int, int]:
    """(start, length) of block ``i`` of ``n`` of a dim of ``size``."""
    if size % n:
        raise ValueError(f"{what}dim of {size} does not split {n} ways")
    step = size // n
    return i * step, step


def local_block(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view)."""
    check_spec(spec, mesh, full.dim())
    out = full
    for d, ent in enumerate(spec):
        axes = entry_axes(ent)
        if axes:
            start, n = block(C.axis_size(axes, mesh),
                             C.axis_index(axes, mesh), full.shape[d],
                             f"{tuple(full.shape)} at {spec!r}: ")
            out = out.narrow(d, start, n)
    return out


def place(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``full`` (the same on every rank) placed by ``spec``: a DTensor
    holding a contiguous copy of this rank's block, equal to the slice of
    ``full`` bit for bit."""
    loc = local_block(full, spec, mesh).clone(
        memory_format=torch.contiguous_format)
    return from_block(loc, spec, mesh, tuple(full.shape))


def from_block(loc: torch.Tensor, spec, mesh, shape) -> torch.Tensor:
    """A DTensor of global ``shape`` whose block here is ``loc``."""
    return compat.dtensor().DTensor.from_local(loc, mesh.device_mesh,
                              placements_for(spec, mesh, len(shape)),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def like_placed(loc: torch.Tensor, t) -> torch.Tensor:
    """``loc`` as the block of a tensor placed as ``t`` (``loc`` itself when
    ``t`` is plain)."""
    if not is_placed(t):
        return loc
    return from_block(loc, spec_of(t), mesh_of(t), tuple(t.shape))


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's block (autograd flows back to the placed tensor); a
    plain tensor as it is."""
    return t.to_local() if is_placed(t) else t


def _gather_dim(x: torch.Tensor, d: int, axes, mesh) -> torch.Tensor:
    """The blocks of ``axes`` joined along dim ``d`` (minor axis first, so
    the pieces land in row-major order)."""
    for a in reversed(entry_axes(axes)):
        n = mesh.shape[a]
        if n == 1:
            continue
        parts = C._all_gather(x, mesh.group(a), n)
        x = torch.cat(list(parts.unbind(0)), dim=d)
    return x


def _slice_dim(x: torch.Tensor, d: int, axes, mesh) -> torch.Tensor:
    axes = entry_axes(axes)
    start, n = block(C.axis_size(axes, mesh), C.axis_index(axes, mesh),
                     x.shape[d], f"{tuple(x.shape)} over {axes}: ")
    return x.narrow(d, start, n)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor on every rank (explicit all-gathers over the axes
    that split it); a plain tensor as it is.  No gradient."""
    if not is_placed(t):
        return t
    mesh, spec = mesh_of(t), spec_of(t)
    x = t.to_local().detach()
    for d, ent in enumerate(spec):
        x = _gather_dim(x, d, ent, mesh)
    return x


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d, axes, mesh):
        ctx.args = (d, axes, mesh)
        return _gather_dim(x, d, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        d, axes, mesh = ctx.args
        return _slice_dim(g, d, axes, mesh).contiguous(), None, None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d, axes, mesh):
        ctx.args = (d, axes, mesh)
        return _slice_dim(x, d, axes, mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        d, axes, mesh = ctx.args
        return _gather_dim(g.contiguous(), d, axes, mesh), None, None, None


def relayout(x: torch.Tensor, src, dst, mesh) -> torch.Tensor:
    """This rank's block under spec ``dst`` from its block ``x`` under
    ``src`` (the identity where the two agree): each dim whose entry
    differs is gathered whole over ``src``'s axes, then, every gather done,
    cut by ``dst``'s (a dim cut first over an axis another dim is gathered
    over would gather the peers' other cuts).  With autograd (see the
    module's notes)."""
    nd = x.dim()
    src = tuple(src) + (None,) * (nd - len(src))
    dst = tuple(dst) + (None,) * (nd - len(dst))
    moved = [d for d in range(nd)
             if entry_axes(src[d]) != entry_axes(dst[d])]
    for d in moved:
        if entry_axes(src[d]):
            x = _Gather.apply(x, d, entry_axes(src[d]), mesh)
    for d in moved:
        if entry_axes(dst[d]):
            x = _Slice.apply(x, d, entry_axes(dst[d]), mesh)
    return x


def swap_split(x: torch.Tensor, src: int, dst: int, axis: str,
               mesh) -> torch.Tensor:
    """This rank's block of a tensor split on dim ``src`` over the mesh
    axis ``axis`` (whole on ``dst``) as its block split on dim ``dst`` over
    it instead (whole on ``src``), in one all-to-all: each rank sends each
    peer the peer's block of ``dst`` cut from its own block of ``src``.
    :func:`relayout` would gather the whole tensor first.  With autograd."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    block(n, 0, x.shape[dst], f"{tuple(x.shape)} over {axis!r}: ")
    got = C.all_to_all(torch.stack(x.chunk(n, dst)), axis, mesh)
    return torch.cat(got.unbind(0), src)


def same_spec(a, b, ndim: int) -> bool:
    pa = tuple(entry_axes(e) for e in tuple(a) + (None,) * (ndim - len(a)))
    pb = tuple(entry_axes(e) for e in tuple(b) + (None,) * (ndim - len(b)))
    return pa == pb
