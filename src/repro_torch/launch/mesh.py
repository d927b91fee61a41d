"""Logical meshes: named axes and their sizes, with no devices behind them.

The counterpart of the reference's ``launch/mesh.py`` and of
``compat.abstract_mesh``.  The reference builds ``jax.make_mesh`` meshes
(and ``AbstractMesh`` ones in its tests); its spec code reads only
``mesh.shape`` (axis name -> size) and ``mesh.axis_names``.  A
:class:`LogicalMesh` is exactly that, so the sharding rules, the specs and
the dry run work out every cell's layout on a 256- or 512-chip mesh on one
host.

A :class:`ProcessMesh` (:func:`make_mesh`) is the same named-axis view over
the ranks of a ``torch.distributed`` process group, one rank per mesh
position, built with ``torch.distributed.device_mesh.init_device_mesh``; it
adds the process group of each axis and this rank's coordinates, which the
explicit collectives of :mod:`repro_torch.parallel` run over, and its
``DeviceMesh`` (``device_mesh``), which the placed tensors
(:mod:`repro_torch.parallel.placement`, DTensors) live on.
:func:`set_mesh` / :func:`get_mesh` hold the ambient mesh, as the
reference's ``compat.set_mesh`` / ``get_abstract_mesh`` do (the MoE layer,
``LM(moe_ep=)``, ``shard_activation`` and the layers under placed
parameters read it).  :func:`placements_for` turns a spec into DTensor
placements.

Production meshes (the reference's):
  single-pod: (data=16, model=16)           = 256 chips
  multi-pod : (pod=2, data=16, model=16)    = 512 chips

MRA-factored meshes (paper C1; the model axis split K ways) come from
``core.replication.make_mra_mesh``.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch import compat
from repro_torch.device import DeviceSpec, resolve

Axis = Optional[Union[str, Tuple[str, ...]]]


@dataclass(frozen=True)
class LogicalMesh:
    """Axis names and sizes (``jax.sharding.AbstractMesh`` to the spec
    code): ``shape`` maps each name to its size, in axis order."""
    axis_shapes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "axis_shapes", tuple(
            int(n) for n in self.axis_shapes))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.axis_shapes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_shapes)} sizes for axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(n < 1 for n in self.axis_shapes):
            raise ValueError(f"axis sizes {self.axis_shapes} must be >= 1")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_shapes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_shapes:
            n *= s
        return n


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), an axis name,
    or a tuple of names (sharded over their product) — what
    ``jax.sharding.PartitionSpec`` holds.  ``PartitionSpec()`` replicates
    every dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: LogicalMesh
    spec: PartitionSpec

    def shard_factor(self) -> int:
        """How many ways the tensor is split: the product of the mesh sizes
        of the axes its spec names."""
        n = 1
        for ent in self.spec:
            for a in ((ent,) if isinstance(ent, str) else (ent or ())):
                n *= self.mesh.shape[a]
        return n


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(shape, axes)


def make_host_mesh(device: DeviceSpec = None):
    """What exists right now, as a 1-D ``("data",)`` mesh (the reference's
    ``make_host_mesh``): the launched ranks as a :class:`ProcessMesh` once
    ``torch.distributed`` is initialised, else the devices present as a
    :class:`LogicalMesh` — every CUDA device (``device=None``, which raises
    without one, as every entry point of the port does), or one for
    ``device="cpu"``."""
    import torch.distributed as dist
    dev = resolve(device)
    if dist.is_available() and dist.is_initialized():
        return make_mesh((dist.get_world_size(),), ("data",), device=dev)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return LogicalMesh((n,), ("data",))


class ProcessMesh:
    """Named axes over the ranks of the default ``torch.distributed``
    process group (row-major: the last axis varies fastest over the ranks),
    with one process group per axis.  ``shape`` / ``axis_names`` /
    ``axis_shapes`` / ``size`` read as :class:`LogicalMesh`'s; ``device`` is
    this rank's device, ``backend`` the group's (``"gloo"`` or ``"nccl"``)
    and ``device_mesh`` the ``torch.distributed`` ``DeviceMesh``."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.axis_shapes = tuple(int(n) for n in device_mesh.mesh.shape)
        self.device = torch.device(device)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_shapes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_shapes:
            n *= s
        return n

    @property
    def backend(self) -> str:
        import torch.distributed as dist
        return str(dist.get_backend())

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (group rank
        = the coordinate along it)."""
        return self.device_mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return int(self.device_mesh.get_local_rank(axis))

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, device={self.device}, "
                f"backend={self.backend})")


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry: ``None`` -> ``()``, a name -> a
    1-tuple, a tuple as it is."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(axes: Sequence[str]):
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def check_spec(spec, mesh, ndim: int) -> None:
    """Raise ``ValueError`` unless ``spec`` fits a rank-``ndim`` tensor on
    ``mesh``: known axes, each used once, a tuple in the mesh's order."""
    names = tuple(mesh.axis_names)
    if len(spec) > ndim:
        raise ValueError(f"{spec!r} has {len(spec)} entries for a "
                         f"rank-{ndim} tensor")
    used: set = set()
    for ent in spec:
        axes = entry_axes(ent)
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec!r}: no axis {a!r} in mesh "
                                 f"{names}")
            if a in used:
                raise ValueError(f"{spec!r}: axis {a!r} shards two dims")
            used.add(a)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"the tuple {tuple(axes)!r} of {spec!r} does not follow the "
                f"mesh's axis order {names}: DTensor splits a dim over its "
                "axes in mesh order, so the block order would change")


def placements_for(spec, mesh, ndim: Optional[int] = None) -> list:
    """The DTensor placements of ``spec`` on ``mesh`` for a rank-``ndim``
    tensor (``len(spec)`` by default), one per mesh axis: ``Shard(d)`` on
    every axis entry ``d`` names, several in mesh order for a tuple (which
    must follow the mesh's axis order, else ``ValueError`` naming it),
    ``Replicate()`` elsewhere."""
    T = compat.dtensor()
    Replicate, Shard = T.Replicate, T.Shard
    check_spec(spec, mesh, len(spec) if ndim is None else ndim)
    out: list = [Replicate() for _ in mesh.axis_names]
    for d, ent in enumerate(spec):
        for a in entry_axes(ent):
            out[mesh.axis_names.index(a)] = Shard(d)
    return out


def rank_device(device: DeviceSpec = None) -> torch.device:
    """This rank's device: the CPU, a CUDA device given with its index, or
    CUDA device ``local rank % count`` (the ``LOCAL_RANK`` a launcher such
    as ``torchrun`` sets, else the rank; several ranks share a card when
    there are more ranks than cards)."""
    import os
    import torch.distributed as dist
    dev = resolve(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              device: DeviceSpec = None) -> ProcessMesh:
    """A :class:`ProcessMesh` of ``shape`` over the initialised default
    process group (its world size must be the product of ``shape``).
    ``device=None`` is the card, as for every entry point of the port."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(repro_torch.parallel.init_process_group)")
    shape, names = tuple(int(n) for n in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"{len(shape)} sizes for axes {names}")
    LogicalMesh(shape, names)                   # the same checks
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {dict(zip(names, shape))} has {n} places "
                         f"for {dist.get_world_size()} ranks")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=names)
    return ProcessMesh(dm, dev)


@contextlib.contextmanager
def counting_mesh(shape: Sequence[int], names: Sequence[str]):
    """A :class:`ProcessMesh` of ``shape`` over a *fake* process group of
    ``prod(shape)`` ranks, this process its rank 0: PyTorch's ``"fake"``
    backend (``torch.testing._internal.distributed.fake_pg``) returns every
    collective at once, moving nothing, so one rank's placed step runs on
    fake tensors and its collectives are counted (``launch.costing.
    placed_step_count``) for a mesh of any size on one host.  The default
    process group is set up inside and torn down after; a process holds one
    default group at a time, so this runs only in a process that has none
    (the dry run's, or a test's subprocess), never beside real ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, names = tuple(int(n) for n in shape), tuple(names)
    LogicalMesh(shape, names)                   # the same checks
    if dist.is_initialized():
        raise RuntimeError("counting_mesh needs a process with no process "
                           "group: it makes the default one fake")
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        dm = init_device_mesh("cpu", shape, mesh_dim_names=names)
        yield ProcessMesh(dm, torch.device("cpu"))
    finally:
        dist.destroy_process_group()


_AMBIENT: list = []


def get_mesh():
    """The ambient mesh (:func:`set_mesh`), or ``None``."""
    return _AMBIENT[-1] if _AMBIENT else None


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the block (the reference's
    ``compat.set_mesh``)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()
