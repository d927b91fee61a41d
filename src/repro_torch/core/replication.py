"""Multi-replica accelerator tiles (paper contribution C1) on a mesh.

The paper instantiates K replicas of an accelerator behind one NoC node,
with an AXI bridge multiplexing the tile's stream interfaces across
replicas.  Key invariants preserved here:

* the NoC (global device mesh topology) does not change,
* the accelerator (module definition) does not change,
* K is a per-tile design-time parameter,
* throughput scales ~K for stream-bound tiles at ~K area (weight bytes).

On a mesh the tile's fabric is the ``model`` axis.  MRA-K factors it into
``(replica=K, shard=model/K)``: the module's weights are sharded over
``shard`` and *replicated* over ``replica`` (per-device weight bytes x K,
the paper's area cost), and the tile's input token stream is *split* over
``replica``.  The rules read only a mesh's ``shape`` and ``axis_names``, so
they work alike on a :class:`~repro_torch.launch.mesh.LogicalMesh` (the dry
run's) and on a :class:`~repro_torch.launch.mesh.ProcessMesh` (the
trainer's, whose ranks hold the placed tensors).

On a ``ProcessMesh`` the stream is split as the bridge splits it
(:func:`stream_split`, ``LM(mra_split=)``): the batch is placed over
:func:`data_axes` (``replica`` among them once a tile has K > 1); a K > 1
tile runs on the rank's own rows, tensor-parallel over ``shard``; a K = 1
tile (the embedding and the vocab / loss tile always) takes its replica
group's rows whole, gathered over ``replica``, tensor-parallel over
``(replica, shard)``, and hands each rank its rows back after
(``parallel.collectives.gather_stream`` / ``split_stream``).  A K > 1
tile's gradients are the rank's rows' share and are summed over
``replica`` too (``runtime.train.grad_axes``).  The two closed forms at the
end are what the design-space sweep charges for the knob.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.tiles import TilePlan
from repro_torch.launch.mesh import LogicalMesh
from repro_torch.models.params import Axis, BASE_RULES, rules_with

# Logical weight axes owned by each tile kind; these are the axes whose
# mesh assignment the MRA bridge rewrites when K > 1.
TILE_LOGICAL_AXES: Dict[str, Tuple[str, ...]] = {
    "embed": ("vocab",),
    "attn": ("qkv", "kv", "heads"),
    "ffn": ("ff",),
    "moe": ("expert_ff", "experts"),
    "ssm": ("d_inner", "ssm_heads", "conv_ch"),
    "shared_attn": ("qkv", "kv", "heads", "ff"),
}


def make_mra_mesh(k: int, *, multi_pod: bool = False,
                  model: int = 16, data: int = 16) -> LogicalMesh:
    """The production mesh with the model axis K-factored: the same chips,
    only the axis naming changes, mirroring how the paper's MRA changes
    tile internals but not the NoC.  ``k`` must divide ``model``."""
    assert model % k == 0, (model, k)
    if multi_pod:
        return LogicalMesh((2, data, k, model // k),
                           ("pod", "data", "replica", "shard"))
    return LogicalMesh((data, k, model // k), ("data", "replica", "shard"))


def mra_rules(plan: TilePlan, mesh: LogicalMesh
              ) -> Dict[str, Dict[str, Axis]]:
    """Per-tile logical->mesh rules implementing each tile's K.

    Returns {tile_name: rules_dict}.  On the baseline mesh (axis "model",
    K=1 everywhere) this reduces to BASE_RULES for every tile.  On an MRA
    mesh (axes replica/shard) a tile with replication K shards its weight
    axes over "shard" only (replicated over "replica"); a K=1 tile shards
    over both (pure TP).
    """
    names = set(mesh.axis_names)
    has_mra = "replica" in names and "shard" in names
    out: Dict[str, Dict[str, Axis]] = {}
    for t in plan.tiles:
        axes = TILE_LOGICAL_AXES.get(t.kind, ())
        if not has_mra:
            out[t.name] = dict(BASE_RULES)
            continue
        full_model: Axis = ("replica", "shard")
        overrides: Dict[str, Axis] = {}
        for logical, base in BASE_RULES.items():
            if base == "model":
                overrides[logical] = full_model
        for ax in axes:
            if BASE_RULES.get(ax) == "model":
                # t.replication > 1: weights replicated over "replica"
                overrides[ax] = "shard" if t.replication > 1 else full_model
        out[t.name] = rules_with(overrides)
    return out


def merged_rules(plan: TilePlan, mesh: LogicalMesh) -> Dict[str, Axis]:
    """Single rule dict for the whole model (tile rules merged).

    Each logical axis is owned by exactly one tile kind, so the merge is
    conflict-free; shared axes (embed/norm/etc.) stay at their base value.
    """
    per_tile = mra_rules(plan, mesh)
    merged: Dict[str, Axis] = {}
    for t in plan.tiles:
        for k, v in per_tile[t.name].items():
            owner_axes = TILE_LOGICAL_AXES.get(t.kind, ())
            if k in owner_axes or k not in merged:
                merged[k] = v
    return merged


def data_axes(mesh, plan: Optional[TilePlan] = None) -> Tuple[str, ...]:
    """Axes carrying the batch dimension (a ``LogicalMesh`` or a
    ``ProcessMesh``).  Replica sub-axes of MRA tiles carry batch too (the
    AXI bridge splits the stream K ways)."""
    names = mesh.axis_names
    out = tuple(a for a in ("pod", "data") if a in names)
    if "replica" in names and plan is not None and any(
            t.replication > 1 for t in plan.tiles):
        out = out + ("replica",)
    return out


# the tiles whose stream the bridge can split (the embedding / vocab tile,
# the NoC, MEM and IO never: K = 1)
STREAM_TILES = ("attn", "ffn", "moe", "ssm", "shared_attn")


def is_mra_mesh(mesh) -> bool:
    names = set(mesh.axis_names)
    return "replica" in names and "shard" in names


def stream_split(plan: TilePlan, mesh) -> Dict[str, bool]:
    """For each tile of ``plan`` (by name) on ``mesh``: whether its stream
    is split over ``replica`` (K > 1 on an MRA mesh: each replica on its
    own rows, its weights over ``shard``) or taken whole over ``(replica,
    shard)`` (K = 1; every tile off an MRA mesh, and the embedding / vocab
    tile always)."""
    mra = is_mra_mesh(mesh)
    return {t.name: mra and t.replication > 1 and t.kind in STREAM_TILES
            for t in plan.tiles}


def split_kinds(plan: TilePlan, mesh) -> Tuple[str, ...]:
    """The kinds of the tiles :func:`stream_split` splits (what
    ``LM(mra_split=)`` takes)."""
    split = stream_split(plan, mesh)
    return tuple(sorted({t.kind for t in plan.tiles if split[t.name]}))


def replication_area_model(weight_bytes: int, act_bytes: int, k: int,
                           model: int = 16) -> Dict[str, float]:
    """Analytic per-device 'area' for an MRA tile (Table-I analogue).

    Weights: sharded over model/K devices, replicated K ways ->
    per-device weight bytes x K.  Activations/KV: split over replicas ->
    per-device unchanged.  Mirrors the paper: DSP (weights/compute) scale
    ~K, LUT/FF/BRAM (shared stream logic) scale sub-K.
    """
    return {
        "weight_bytes_per_dev": weight_bytes * k / model,
        "act_bytes_per_dev": act_bytes / model,
        "total_bytes_per_dev": (weight_bytes * k + act_bytes) / model,
    }


def replication_throughput_model(k: int, *, stream_fraction: float = 0.96
                                 ) -> float:
    """Analytic throughput gain of MRA-K for a stream-bound tile.

    Amdahl form: a fraction ``stream_fraction`` of the tile's service time
    is the serialized stream interface (collective latency / DMA round
    trips), which K replicas overlap K-ways; the rest is per-replica
    compute, unchanged.  gain(K) = 1 / ((1-c) + c/K).

    Calibration: the paper's Table I averages are 1.92x @ K=2 and
    3.58x @ K=4.  Solving gain(2)=1.92 gives c = 0.958; that same c
    predicts gain(4) = 3.55 — within 1% of the measured 3.58x, i.e. the
    paper's accelerators are ~96% stream-bound, which matches its own
    observation that dfadd/dfmul are memory-bound.
    """
    c = stream_fraction
    return 1.0 / ((1.0 - c) + c / k)
