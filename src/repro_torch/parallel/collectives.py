"""The explicit collectives of the reference's ``shard_map`` bodies, on
``torch.distributed`` over a :class:`~repro_torch.launch.mesh.ProcessMesh`.

Each rank is one position of the mesh and runs the body once, as one device
runs a ``shard_map`` body; a collective over a mesh axis runs over the
process group of this rank's line along it.  The ``jax.lax`` names map one
for one:

====================  ====================================================
``axis_index``        this rank's coordinate along the axis
``axis_size``         the axis's size
``psum`` / ``pmean``  ``all_reduce`` (sum), divided by the size for pmean
``all_gather``        the ranks' tensors stacked on a new leading axis in
                      coordinate order (``all_gather``)
``all_to_all``        slice ``j`` of the leading axis goes to coordinate
                      ``j``; what coordinate ``j`` sent lands in slice ``j``
                      (``all_to_all_single``), ``tiled=False`` semantics
``ppermute``          the ``(source, destination)`` pairs of coordinates,
                      built from ``all_to_all_single`` (a rank nobody sends
                      to gets zeros)
====================  ====================================================

An axis may be a tuple of names: the collective then runs over each axis in
turn (``all_gather`` the last axis first, so the stacked order is row-major
over the tuple).

**Gradients.**  Each collective is an autograd Function, under the
convention of a loss that every rank computes from the replicated output (the
reference's ``jax.grad`` of a loss taken outside the ``shard_map``):

* ``psum`` / ``pmean``: the output is replicated, so each rank's cotangent
  is already the one value's and passes through (divided by the size for
  ``pmean``) — an all-reduce in the backward would multiply the gradient by
  the axis size;
* ``all_gather``: each rank takes its own slice of the cotangent;
* ``all_to_all``: the cotangent goes back by the same exchange;
* ``ppermute``: the cotangent goes back by the inverse permutation, round
  the ring the other way;
* ``replicated``: the identity on a tensor that every rank of the axes holds
  alike and reads its own part of (a token slice, an F slice, the router
  for its own tokens); its backward sums the ranks' partial gradients, as
  the transpose of a ``shard_map`` input sums its cotangent over the axes
  the input is not split on.  A body's global inputs pass through it at
  entry, so every rank ends with the whole gradient of each;
* ``gather_stream`` / ``split_stream`` (the MRA bridge, paper C1): the rows
  of the ranks of an axis concatenated on dim 0 before a tile that takes
  the stream whole, and this rank's rows of it after: the gather's backward
  takes the rank's rows of the (replicated) cotangent, once; the split's
  gathers the ranks' row cotangents, so every rank holds the whole
  cotangent of the replicated stream (``all_gather`` and ``replicated``
  above, on rows).

Every rank must call the same collectives in the same order, forward and
backward; the callers keep their graphs identical on every rank (masks, not
branches on the coordinate).

**Backend.**  It follows the tensors (:func:`backend_for`): ``gloo`` for CPU
tensors and where several ranks share one card (NCCL refuses two ranks on
one GPU), ``nccl`` where every rank has a card of its own.  A collective
never moves its tensors to another device; :data:`USED` counts, per
``(op, backend, device type)``, what each call ran on.
"""
from __future__ import annotations

import collections
from datetime import timedelta
from typing import Dict, Iterable, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import get_mesh

Axis = Union[str, Tuple[str, ...]]

# (op, backend, device type) -> calls, for the record of what ran where
USED: Dict[Tuple[str, str, str], int] = collections.Counter()


def backend_for(device, world_size: int) -> str:
    """``"gloo"`` for the CPU or for more ranks than cards, else
    ``"nccl"``."""
    dev = torch.device(device)
    if dev.type != "cuda" or world_size > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def init_process_group(rank: int, world_size: int, init_method: str, *,
                       device="cpu", timeout_s: float = 60.0) -> str:
    """Join the default process group with the backend the tensors of
    ``device`` need (:func:`backend_for`); returns the backend."""
    backend = backend_for(device, world_size)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    return backend


def _mesh(mesh):
    m = mesh if mesh is not None else get_mesh()
    if m is None:
        raise RuntimeError("a collective needs a mesh: pass mesh= or set "
                           "one with repro_torch.launch.mesh.set_mesh")
    return m


def _axes(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _record(op: str, group, t: torch.Tensor) -> None:
    USED[(op, str(dist.get_backend(group)), t.device.type)] += 1


def axis_index(axis: Axis, mesh=None) -> int:
    """This rank's coordinate along ``axis`` (row-major over a tuple)."""
    m = _mesh(mesh)
    i = 0
    for a in _axes(axis):
        i = i * m.shape[a] + m.coord(a)
    return i


def axis_size(axis: Axis, mesh=None) -> int:
    m = _mesh(mesh)
    n = 1
    for a in _axes(axis):
        n *= m.shape[a]
    return n


# ---------------------------------------------------------------------------
# raw exchanges (no autograd)
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    y = x.detach().clone().contiguous()
    _record("all_reduce", group, y)
    dist.all_reduce(y, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return y


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    x = x.detach().contiguous()
    outs = [torch.empty_like(x) for _ in range(n)]
    _record("all_gather", group, x)
    dist.all_gather(outs, x, group=group)
    return torch.stack(outs)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    _record("all_to_all", group, x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _permute(x: torch.Tensor, group, n: int, me: int,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    send = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    for src, dst in perm:
        if src == me:
            send[dst] = x.detach()
    recv = _all_to_all(send, group)
    srcs = [src for src, dst in perm if dst == me]
    return recv[srcs[0]] if srcs else torch.zeros_like(x)


# ---------------------------------------------------------------------------
# autograd Functions over one axis
# ---------------------------------------------------------------------------


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        y = _all_reduce(x, group)
        return y * scale if scale != 1.0 else y

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me):
        ctx.me = me
        return _all_gather(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.me], None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me):
        ctx.args = (group, n, me, x.shape[0])
        return _all_gather(x, group, n).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        _, _, me, b = ctx.args
        return g[me * b:(me + 1) * b], None, None, None


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me):
        ctx.args = (group, n)
        b = x.shape[0] // n
        return x[me * b:(me + 1) * b]

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.args
        return _all_gather(g, group, n).flatten(0, 1), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, perm):
        ctx.args = (group, n, me, tuple((d, s) for s, d in perm))
        return _permute(x, group, n, me, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, *ctx.args), None, None, None, None


# ---------------------------------------------------------------------------
# the jax.lax names
# ---------------------------------------------------------------------------


def psum(x: torch.Tensor, axis: Axis, mesh=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``, on every one of them."""
    m = _mesh(mesh)
    for a in _axes(axis):
        x = _PSum.apply(x, m.group(a), 1.0)
    return x


def pmean(x: torch.Tensor, axis: Axis, mesh=None) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``axis``, on every one of them."""
    m = _mesh(mesh)
    for a in _axes(axis):
        x = _PSum.apply(x, m.group(a), 1.0 / m.shape[a])
    return x


def pmax(x: torch.Tensor, axis: Axis, mesh=None) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axis`` (no
    gradient: the callers use it as a shift, e.g. a logsumexp's max)."""
    m = _mesh(mesh)
    x = x.detach()
    for a in _axes(axis):
        x = _all_reduce(x, m.group(a), dist.ReduceOp.MAX)
    return x


def sum_into(x: torch.Tensor, axis: Axis, mesh=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``axis`` in place (no copy, no
    gradient: the trainer's gradient reduce); returns ``x``."""
    m = _mesh(mesh)
    if not x.is_contiguous():
        raise ValueError("sum_into needs a contiguous tensor")
    for a in _axes(axis):
        g = m.group(a)
        _record("all_reduce", g, x)
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x


def replicated(x: torch.Tensor, axis: Axis, mesh=None) -> torch.Tensor:
    """``x`` itself; in the backward, the ranks' gradients of ``x`` summed
    over ``axis`` (for an input every rank of ``axis`` holds alike)."""
    m = _mesh(mesh)
    for a in _axes(axis):
        x = _Replicated.apply(x, m.group(a))
    return x


def all_gather(x: torch.Tensor, axis: Axis, mesh=None) -> torch.Tensor:
    """The ranks' ``x`` stacked on a new leading axis of size
    ``axis_size(axis)``, in coordinate order (row-major over a tuple)."""
    m = _mesh(mesh)
    axes = _axes(axis)
    for a in reversed(axes):
        x = _AllGather.apply(x, m.group(a), m.shape[a], m.coord(a))
    if len(axes) > 1:
        x = x.reshape((axis_size(axes, m),) + tuple(x.shape[len(axes):]))
    return x


def gather_stream(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """The rows (dim 0) of the ranks of ``axis`` concatenated in coordinate
    order, on every one of them: the stream taken whole before a tile that
    runs on its group's rows (the module's notes for the gradient)."""
    m = _mesh(mesh)
    return _GatherRows.apply(x, m.group(axis), m.shape[axis], m.coord(axis))


def split_stream(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """This rank's rows of ``x`` (dim 0, the same on every rank of
    ``axis``), split evenly in coordinate order: the stream split after a
    tile that ran on its group's rows (the module's notes for the
    gradient)."""
    m = _mesh(mesh)
    n = m.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks "
                         f"of {axis!r}")
    return _SplitRows.apply(x, m.group(axis), n, m.coord(axis))


def all_to_all(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=False)``: ``x``'s leading
    axis (the axis's size) is split, slice ``j`` sent to coordinate ``j``,
    and slice ``j`` of the result is what coordinate ``j`` sent here."""
    m = _mesh(mesh)
    if x.shape[0] != m.shape[axis]:
        raise ValueError(f"all_to_all over {axis!r} (size "
                         f"{m.shape[axis]}) of a leading axis {x.shape[0]}")
    return _AllToAll.apply(x, m.group(axis))


def ppermute(x: torch.Tensor, axis: str,
             perm: Iterable[Tuple[int, int]], mesh=None) -> torch.Tensor:
    """``jax.lax.ppermute``: ``x`` of coordinate ``src`` lands on ``dst``
    for each pair; a coordinate no pair sends to gets zeros."""
    m = _mesh(mesh)
    perm = tuple((int(s), int(d)) for s, d in perm)
    return _PPermute.apply(x, m.group(axis), m.shape[axis], m.coord(axis),
                           perm)
