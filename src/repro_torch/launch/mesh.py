"""Logical meshes: named axes and their sizes, with no devices behind them.

The counterpart of the reference's ``launch/mesh.py`` and of
``compat.abstract_mesh``.  The reference builds ``jax.make_mesh`` meshes
(and ``AbstractMesh`` ones in its tests); its spec code reads only
``mesh.shape`` (axis name -> size) and ``mesh.axis_names``.  A
:class:`LogicalMesh` is exactly that, so the sharding rules, the specs and
the dry run work out every cell's layout on a 256- or 512-chip mesh on one
host.  Placing tensors on real devices over such a mesh waits for ROADMAP
queue A item 12.

Production meshes (the reference's):
  single-pod: (data=16, model=16)           = 256 chips
  multi-pod : (pod=2, data=16, model=16)    = 512 chips

MRA-factored meshes (paper C1; the model axis split K ways) come from
``core.replication.make_mra_mesh``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

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


def make_host_mesh(device: DeviceSpec = None) -> LogicalMesh:
    """The devices present, as a 1-D ``("data",)`` mesh: every CUDA device
    (``device=None``, which raises without one, as every entry point of the
    port does), or one for ``device="cpu"``."""
    dev = resolve(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return LogicalMesh((n,), ("data",))
