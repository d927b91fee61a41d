"""Parameter-spec machinery of the port.

A model is described once as a nested dict of :class:`ParamSpec` (shape,
dtype, logical axis names, initializer), as in the reference
(``repro/models/params.py``).  From that single tree come:

* ``init_params``     — weights drawn from an explicit ``torch.Generator`` on
                        the target device (normal x scale; ``"small"`` divides
                        the scale by sqrt of the fan-in as the reference does),
* ``abstract_params`` — shapes and dtypes only (``meta`` tensors, no memory),
* ``count_params``,
* ``pspecs_for`` / ``shardings_for`` — each leaf's ``PartitionSpec`` (a
  ``Sharding`` record with its mesh) after applying the logical -> mesh
  rules (``BASE_RULES``; the MRA rules of ``core.replication`` remap a
  tile's axes onto ``(replica, shard)``), on a
  :class:`~repro_torch.launch.mesh.LogicalMesh` or a
  :class:`~repro_torch.launch.mesh.ProcessMesh`,
* ``place_params`` — the tree placed on a ``ProcessMesh``: DTensor leaves,
  each rank holding its block (:mod:`repro_torch.parallel.placement`).

``shard_activation`` is the reference's: the identity without an ambient
``ProcessMesh``; under one, a placed (DTensor) activation is redistributed
to the spec :func:`activation_spec` computes with the reference's rules.
The port's layers run on each rank's local blocks (explicit collectives,
:mod:`repro_torch.models.layers`): at the reference's sites they lay their
blocks out as :func:`activation_spec` says, and a plain tensor passes
through ``shard_activation`` unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import (Axis, LogicalMesh, PartitionSpec,
                                     ProcessMesh, Sharding, get_mesh)
from repro_torch.parallel import placement as PL


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis name per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                     # normal | zeros | ones | small
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def spec(shape, axes, dtype=torch.bfloat16, init="normal",
         scale=0.02) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), dtype, init, scale)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree: Any, is_leaf: Callable = is_spec):
    """Map ``fn`` over the leaves of a nested dict / list / tuple /
    NamedTuple (dict keys in sorted order, the order the reference's
    pytrees flatten in; a NamedTuple's fields in their order)."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_leaves(tree: Any, is_leaf: Callable = is_spec) -> list:
    """The leaves in the reference's flattening order (``jax.tree_util.
    tree_leaves``: dict keys sorted, whatever order the dict was built
    in)."""
    out: list = []
    tree_map(out.append, tree, is_leaf)
    return out


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order) at its tensor leaves."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like, torch.is_tensor)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def abstract_params(tree):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), tree)


def _init_one(s: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=dev)
    scale = s.scale
    if s.init == "small":
        scale = s.scale / max(1, int(np.sqrt(np.prod(s.shape[:-1]) or 1)))
    x = torch.randn(s.shape, generator=gen, dtype=torch.float32, device=dev)
    return x.mul_(scale).to(s.dtype)      # in place: one float32 copy


def init_params(tree, generator: torch.Generator):
    """Materialise every spec on ``generator.device``, drawing from
    ``generator`` leaf by leaf in flattening order."""
    return tree_map(lambda s: _init_one(s, generator), tree)


def count_params(tree) -> int:
    return int(sum(int(np.prod(s.shape)) if len(s.shape) else 1
                   for s in tree_leaves(tree)))


# ---------------------------------------------------------------------------
# Logical -> mesh rules
# ---------------------------------------------------------------------------

# Baseline rule set for the ("data", "model") production mesh.  Tuples mean
# "sharded over multiple mesh axes".  ``None`` = replicated.
BASE_RULES: Dict[str, Axis] = {
    "layers": None,
    "vocab": "model",
    "embed": None,
    "qkv": "model",          # flattened n_heads*head_dim projection dim
    "kv": "model",           # flattened n_kv_heads*head_dim projection dim
    "heads": "model",
    "ff": "model",
    "ff_in": None,
    "experts": None,         # baseline: expert-TP (shard expert_ff), EP is a variant
    "expert_ff": "model",
    "kv_lora": None,
    "d_inner": "model",      # mamba inner channels
    "ssm_state": None,
    "ssm_heads": "model",
    "conv_ch": "model",
    "norm": None,
}


def rules_with(overrides: Dict[str, Axis]) -> Dict[str, Axis]:
    r = dict(BASE_RULES)
    r.update(overrides)
    return r


def mesh_axis_size(mesh: LogicalMesh, axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def partition_spec_for(axes: Tuple[Optional[str], ...],
                       shape: Tuple[int, ...],
                       rules: Dict[str, Axis],
                       mesh: LogicalMesh) -> PartitionSpec:
    """Map logical axes to a PartitionSpec, replicating when not divisible."""
    entries = []
    used: set = set()
    for name, dim in zip(axes, shape):
        ax = rules.get(name) if name is not None else None
        if ax is None:
            entries.append(None)
            continue
        axt = ax if isinstance(ax, tuple) else (ax,)
        if any(a in used for a in axt):
            entries.append(None)        # an axis can shard only one dim
            continue
        if dim % mesh_axis_size(mesh, ax) != 0:
            entries.append(None)        # replicate non-divisible dims
            continue
        used.update(axt)
        entries.append(ax)
    return PartitionSpec(*entries)


def pspecs_for(tree, rules: Dict[str, Axis], mesh: LogicalMesh):
    return tree_map(lambda s: partition_spec_for(s.axes, s.shape, rules,
                                                 mesh), tree)


# Batch ("stream") axes are swappable at lowering time: the baseline maps
# batch dims to ("pod", "data"); the FSDP strategy adds "model"; an MRA mesh
# adds "replica" (the AXI bridge splits the stream across tile replicas).
_DEFAULT_BATCH_AXES: Tuple[str, ...] = ("pod", "data")
_BATCH_AXES: Tuple[str, ...] = _DEFAULT_BATCH_AXES


def set_batch_axes(axes: Tuple[str, ...]) -> None:
    global _BATCH_AXES
    _BATCH_AXES = tuple(axes)


def get_batch_axes() -> Tuple[str, ...]:
    return _BATCH_AXES


def shardings_for(tree, rules: Dict[str, Axis], mesh):
    """Each leaf's :class:`~repro_torch.launch.mesh.Sharding` (its spec on
    ``mesh``), the reference's ``NamedSharding`` tree."""
    return tree_map(lambda s: Sharding(mesh, partition_spec_for(
        s.axes, s.shape, rules, mesh)), tree)


def place_params(tree, shardings):
    """The tensors of ``tree`` (the same full values on every rank) placed
    by ``shardings`` (a tree of ``Sharding`` records on a ``ProcessMesh``):
    DTensor leaves whose blocks equal the full tensors' slices bit for
    bit.  Leaves of other types pass through."""
    flat_s = tree_leaves(shardings, lambda x: hasattr(x, "spec")
                         and hasattr(x, "mesh"))
    flat_t = tree_leaves(tree, torch.is_tensor)
    if len(flat_s) != len(flat_t):
        raise ValueError(f"{len(flat_s)} shardings for {len(flat_t)} "
                         "tensors")
    return tree_unflatten(tree, [PL.place(t, s.spec, s.mesh)
                                 for t, s in zip(flat_t, flat_s)])


# ---------------------------------------------------------------------------
# Activation sharding (the reference's shard_activation)
# ---------------------------------------------------------------------------


def _mesh_size(mesh, names) -> int:
    n = 1
    for a in names:
        n *= mesh.shape[a]
    return n


def activation_spec(shape: Tuple[int, ...], *axes: Axis,
                    mesh=None, batch_axes: Optional[Tuple[str, ...]] = None
                    ) -> Optional[PartitionSpec]:
    """The spec the reference's ``shard_activation(x, *axes)`` constrains a
    tensor of global ``shape`` to on ``mesh`` (the ambient mesh by default;
    ``None`` without one): the default batch axes replaced by the current
    ones (``batch_axes``, else :func:`get_batch_axes`'s); on an MRA-factored
    mesh (``shard`` and no ``model``) ``"model"``
    becomes ``"shard"`` and ``"__model_full__"`` ``("replica", "shard")``,
    with ``"replica"`` leaving the other entries of that tensor; axes not in
    the mesh dropped; then, dim by dim, axes an earlier dim took dropped
    (the first dim wins) and trailing axes dropped until the dim divides."""
    if mesh is None:
        mesh = get_mesh()
    if mesh is None or not getattr(mesh, "axis_names", ()):
        return None
    cur = _BATCH_AXES if batch_axes is None else tuple(batch_axes)
    axes = tuple(cur if a == _DEFAULT_BATCH_AXES else a for a in axes)
    names = set(mesh.axis_names)
    if "model" not in names and "shard" in names:
        if "__model_full__" in axes:
            axes = tuple(
                tuple(n for n in a if n != "replica") if isinstance(a, tuple)
                else a for a in axes)
        axes = tuple("shard" if a == "model" else a for a in axes)
        axes = tuple(("replica", "shard") if a == "__model_full__" else a
                     for a in axes)
    else:
        axes = tuple("model" if a == "__model_full__" else a for a in axes)
    ents = []
    for a in axes[:len(shape)]:
        if a is None:
            ents.append(None)
        elif isinstance(a, tuple):
            present = tuple(n for n in a if n in names)
            ents.append(present if present else None)
        else:
            ents.append(a if a in names else None)
    ents += [None] * (len(shape) - len(ents))
    fixed: list = []
    used: set = set()
    for dim, a in zip(shape, ents):
        if a is None:
            fixed.append(None)
            continue
        names_a = [n for n in (list(a) if isinstance(a, tuple) else [a])
                   if n not in used]
        while names_a and dim % _mesh_size(mesh, names_a):
            names_a.pop()
        if names_a:
            fixed.append(tuple(names_a) if len(names_a) > 1 else names_a[0])
            used.update(names_a)
        else:
            fixed.append(None)
    return PartitionSpec(*fixed)


def shard_activation(x: torch.Tensor, *axes: Axis) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` helper: the identity
    without an ambient :class:`~repro_torch.launch.mesh.ProcessMesh` (or
    under a logical one); under one, a placed (DTensor) ``x`` is
    redistributed to :func:`activation_spec`'s spec (explicit collectives,
    :func:`~repro_torch.parallel.placement.relayout`), and a plain ``x`` —
    a rank's block in a layer that lays its blocks out by that spec itself
    — is returned as it is."""
    mesh = get_mesh()
    if not isinstance(mesh, ProcessMesh) or not PL.is_placed(x):
        return x
    spec = activation_spec(tuple(x.shape), *axes, mesh=mesh)
    src = PL.spec_of(x)
    if PL.same_spec(src, spec, x.dim()):
        return x
    loc = PL.relayout(x.to_local(), src, spec, mesh)
    return PL.from_block(loc, spec, mesh, tuple(x.shape))
