"""Abstract inputs and state, and their shardings, for every dry-run cell.

The counterpart of the reference's ``launch/specs.py``.  The abstract trees
are ``meta`` tensors (shape and dtype, no memory): the parameters
(``models.params.abstract_params``), the optimizer state, the batch or the
decode cache (through the port's own ``LM.init_cache`` on the meta
device) and the C3 counters.  The shardings are
:class:`~repro_torch.launch.mesh.Sharding` records on a
:class:`~repro_torch.launch.mesh.LogicalMesh` or a
:class:`~repro_torch.launch.mesh.ProcessMesh` (the rules read only its
``shape`` and ``axis_names``), worked out by the reference's rules;
:func:`per_device_bytes` reads what one device would hold, and
``models.params.place_params`` places a tree by them on a ``ProcessMesh``
(:func:`place_cache` a decode cache, by :func:`cache_specs`).

All cells feed discrete tokens: the [vlm]/[audio] archs (chameleon,
musicgen) are early-fusion models over VQ/EnCodec *tokens*, so the modality
frontend stub is exactly "tokens arrive from an external tokenizer".

The port's decode cache differs from the reference's in two leaves, and
the shardings follow the port's: ``pos`` is one position per row ``(B,)``
(replicated, as the reference's scalar), and the moe family's cache is one
stack over all layers, the prelude's first (the reference keeps the
prelude's apart, as a list).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.replication import merged_rules
from repro_torch.core.tiles import TilePlan, default_plan
from repro_torch.launch.mesh import LogicalMesh, PartitionSpec as P, \
    Sharding
from repro_torch.models.params import (get_batch_axes, pspecs_for,
                                       tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.models.transformer import LM
from repro_torch.optim import adamw

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Abstract trees
# ---------------------------------------------------------------------------


def abstract_opt_state(params_abs):
    def f32(p):
        return _sds(p.shape, torch.float32)
    return adamw.AdamWState(step=_sds((), torch.int32),
                            mu=tree_map(f32, params_abs, torch.is_tensor),
                            nu=tree_map(f32, params_abs, torch.is_tensor))


def abstract_batch(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _sds((B, S), torch.int32),
            "labels": _sds((B, S), torch.int32)}


def abstract_decode_inputs(lm: LM, shape: ShapeConfig):
    """(cache, tokens) for one decode step against a seq_len context."""
    B, S = shape.global_batch, shape.seq_len
    cache = lm.init_cache(B, S, device=META)
    return cache, _sds((B, 1), torch.int32)


def abstract_prefill_tokens(shape: ShapeConfig):
    return _sds((shape.global_batch, shape.seq_len), torch.int32)


def abstract_counters(plan: TilePlan):
    from repro_torch.core.monitor import init_counters
    return init_counters(plan, device=META)


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------


def _dp(mesh: LogicalMesh, extra: Tuple[str, ...] = ()) -> Tuple[str, ...]:
    """Batch axes: (pod, data) [+ replica on an MRA mesh: the AXI bridge
    splits the stream across tile replicas] [+ any strategy extras]."""
    base = ("pod", "data", "replica") + tuple(extra)
    return tuple(a for a in base if a in mesh.axis_names)


def _model_axis(mesh: LogicalMesh):
    """Axis for model-dim sharding of activations/caches.  On an MRA mesh
    'replica' carries the batch stream (AXI bridge), so only 'shard' is
    available for the model dims."""
    names = mesh.axis_names
    if "model" in names:
        return "model"
    if "shard" in names:           # MRA-factored mesh
        return "shard"
    return None


def _axsize(mesh: LogicalMesh, ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= mesh.shape[a]
        return n
    return mesh.shape[ax]


def batch_shardings(batch_abs, mesh: LogicalMesh,
                    extra: Tuple[str, ...] = ()):
    dp = _dp(mesh, extra)

    def one(v):
        if v.dim() < 1:
            return Sharding(mesh, P())
        # drop trailing axes until the batch dim divides (e.g. multi-pod
        # FSDP with global_batch < chips falls back to DP(pod,data) + TP)
        axes = list(dp)
        while axes:
            if v.shape[0] % _axsize(mesh, tuple(axes)) == 0:
                return Sharding(mesh, P(tuple(axes)))
            axes.pop()
        return Sharding(mesh, P())
    return tree_map(one, batch_abs, torch.is_tensor)


def _tile_axes(lm: LM, mesh, kind: str):
    """(batch axes, model axis) of the cache of tile ``kind``: the
    reference's on a production mesh; on an MRA mesh the tile's own — the
    batch over (pod, data, replica) and the model dims over ``shard`` where
    its stream is split (K > 1, the reference's layout), the batch over
    (pod, data) and the model dims over ``(replica, shard)`` where it takes
    the stream whole (K = 1); a replicated tile whose rows are not split
    (``LM.mra_rows``) its group's rows, its model dims over ``shard``.  Of
    (pod, data) only the current batch axes (``params.get_batch_axes``):
    the axes the placed model splits its rows over."""
    rows = get_batch_axes() + ("replica",)
    dp = tuple(a for a in _dp(mesh) if a in rows)
    if "replica" not in mesh.axis_names:
        return dp, _model_axis(mesh)
    if not lm._rows_split(kind, mesh):
        dp = tuple(a for a in dp if a != "replica")
    return dp, ("shard" if lm._is_split(kind, mesh) else ("replica", "shard"))


def cache_shardings(lm: LM, cache_abs, mesh: LogicalMesh):
    """Explicit shardings mirroring ``LM.init_cache``'s structure.

    Policy: batch over (pod,data) when divisible; the KV window (sequence)
    axis over model (sequence-parallel decode attention — flash-decoding's
    layout); SSM state heads over model.  On an MRA mesh each entry
    follows its tile (:func:`_tile_axes`).
    """
    cfg = lm.cfg

    def axes_of(kind):
        dp, mdl = _tile_axes(lm, mesh, kind)
        return dp, (_axsize(mesh, dp) if dp else 1), mdl, _axsize(mesh, mdl)

    def attn_cache_spec(a, stacked_axes: int, kind: str = "attn"):
        # (*stack, B, W, *tail)
        dp, dp_sz, mdl, m_sz = axes_of(kind)
        b_ax, w_ax = stacked_axes, stacked_axes + 1
        ent = [None] * a.dim()
        if dp and a.shape[b_ax] % dp_sz == 0 and a.shape[b_ax] > 1:
            ent[b_ax] = dp
        if mdl and a.shape[w_ax] % m_sz == 0:
            ent[w_ax] = mdl
        return Sharding(mesh, P(*ent))

    def ssm_cache_spec(a, key: str):
        # conv_*: (L,B,c-1,ch)   state: (L,B,nh,st,hd)
        dp, dp_sz, mdl, m_sz = axes_of("ssm")
        ent = [None] * a.dim()
        if dp and a.shape[1] % dp_sz == 0 and a.shape[1] > 1:
            ent[1] = dp
        if key == "state":
            if mdl and a.shape[2] % m_sz == 0:
                ent[2] = mdl
        else:
            if mdl and a.shape[-1] % m_sz == 0:
                ent[-1] = mdl
        return Sharding(mesh, P(*ent))

    out: Dict[str, Any] = {}
    for k, v in cache_abs.items():
        if k == "pos":
            out[k] = Sharding(mesh, P())
        elif k == "shared_attn":
            out[k] = tuple(attn_cache_spec(a, 1, "shared_attn") for a in v)
        elif k == "blocks":
            if cfg.family in ("ssm", "hybrid"):
                out[k] = {kk: ssm_cache_spec(a, kk) for kk, a in v.items()}
            else:
                out[k] = tuple(attn_cache_spec(a, 1) for a in v)
        else:                                            # pragma: no cover
            out[k] = tree_map(lambda a: Sharding(mesh, P()), v,
                              torch.is_tensor)
    return out


def cache_specs(lm: LM, batch: int, window: int, mesh):
    """Each leaf's ``PartitionSpec`` in ``lm``'s decode cache for ``batch``
    rows and a ``window``-slot ring on ``mesh`` (a ``ProcessMesh`` or a
    ``LogicalMesh``): :func:`cache_shardings`' policy, in the tree of
    ``LM.init_cache``."""
    sh = cache_shardings(lm, lm.init_cache(batch, window, device=META), mesh)
    return tree_map(lambda x: x.spec, sh, lambda x: isinstance(x, Sharding))


def place_cache(lm: LM, blocks, mesh, window: int):
    """The decode cache of a ``window``-slot ring on the ``ProcessMesh``,
    placed by :func:`cache_specs`: DTensor leaves over ``blocks``, the tree
    of ``LM.init_cache`` holding this rank's block of each leaf under its
    spec (``pos`` whole).  ``LM.prefill`` from placed parameters builds its
    cache so, a layer at a time; ``LM.decode_step`` from placed parameters
    takes it.  No collective."""
    from repro_torch.parallel import placement as PL
    B = blocks["pos"].shape[0]
    whole = lm.init_cache(B, window, device=META)
    specs = tree_leaves(cache_specs(lm, B, window, mesh),
                        lambda x: isinstance(x, P))
    got = []
    for t, sp, w in zip(tree_leaves(blocks, torch.is_tensor), specs,
                        tree_leaves(whole, torch.is_tensor)):
        want = PL.local_block(w, sp, mesh).shape
        if t.shape != want:
            raise ValueError(f"a cache block {tuple(t.shape)}, not "
                             f"{tuple(want)}: {tuple(w.shape)} placed {sp!r}")
        got.append(PL.from_block(t.contiguous(), sp, mesh, tuple(w.shape)))
    return tree_unflatten(blocks, got)


def param_shardings(lm: LM, mesh: LogicalMesh,
                    plan: Optional[TilePlan] = None,
                    rules_override: Optional[Dict] = None):
    plan = plan or default_plan(lm.cfg)
    rules = merged_rules(plan, mesh)
    if rules_override:
        rules.update(rules_override)
    pspecs = pspecs_for(lm.param_specs(), rules, mesh)
    return tree_map(lambda ps: Sharding(mesh, ps), pspecs,
                    lambda x: isinstance(x, P))


def opt_shardings(param_sh, mesh: LogicalMesh):
    return adamw.AdamWState(step=Sharding(mesh, P()), mu=param_sh,
                            nu=param_sh)


def counter_shardings(counters_abs, mesh: LogicalMesh):
    return tree_map(lambda a: Sharding(mesh, P()), counters_abs,
                    torch.is_tensor)


def per_device_bytes(tree, shardings) -> int:
    """What one device holds of ``tree`` under ``shardings`` (a tree of the
    same structure): each leaf's bytes over the product of the mesh sizes
    of its sharded dimensions."""
    leaves = tree_leaves(tree, torch.is_tensor)
    shs = tree_leaves(shardings, lambda x: isinstance(x, Sharding))
    if len(leaves) != len(shs):
        raise ValueError(f"{len(leaves)} leaves and {len(shs)} shardings")
    total = 0
    for t, sh in zip(leaves, shs):
        total += t.numel() * t.element_size() // sh.shard_factor()
    return int(total)
