"""Decoder LM of the port, for the ``dense`` family (pre-norm GQA/MQA or MLA
attention + gated MLP), the ``moe`` family (the same attention and a
mixture-of-experts FFN, optionally after ``n_dense_layers`` dense prelude
blocks), the ``ssm`` family (pre-norm Mamba-2 blocks, attention-free) and
the ``hybrid`` family (a Mamba-2 backbone and one *shared* attention + MLP
tile applied before every ``shared_attn_every``-th block, Zamba-2),
mirroring ``repro/models/transformer.py``.

Parameters are the reference's nested dict: ``embed``, ``final_norm``,
``lm_head`` (absent with tied embeddings), ``blocks``, whose leaves carry
a leading stacked-layers dim, for ``moe`` the list ``prelude`` of unstacked
dense blocks (absent without dense layers), and for ``hybrid`` the
unstacked dense block ``shared_attn``.  The reference scans over the layer
dim; here it is a Python loop (``kernels._common.repeat``, which a FLOP
counter may run once and multiply).  Entry points: ``prefill`` (-> cache) and
``decode_step`` (cache -> cache).  Each batch row has its own position
``cache["pos"]`` (B,) int32, so rows admitted at different times decode
side by side.  The dense and moe caches' ``blocks`` is ``(k, v)`` of shape
``(L, B, W, KV, hd)`` over all ``n_layers`` attention layers, the prelude's
first (the reference keeps the prelude's apart, as a list); with MLA
(``attn_type="mla"``, deepseek-v2-lite) it is the latent cache ``(ckv,
k_rope)`` of shape ``(L, B, W, r)`` / ``(L, B, W, rope)``, int8 under
``kv_cache_dtype=torch.int8`` (``prefill`` then returns it quantised with
``quant_kv``, so the engine copies integers); the ssm and
hybrid caches' is a dict of the reference's leaves with the stacked layer
dim and no sequence axis: ``conv_x`` (L, B, c-1, d_inner), ``conv_B`` /
``conv_C`` (L, B, c-1, st) and ``state`` (L, B, nh, st, hd) float32.  The
hybrid cache adds ``shared_attn``: ``(k, v)`` of shape
``(n_apps, B, W, KV, hd)``, one KV history per application site of the
shared tile (``n_apps = ceil(L / shared_attn_every)``).

Under ``AttnOptions(backend="fused")`` attention runs the ``flash_attention``
/ ``flash_decode`` kernels, each dense block's ``mlp_norm`` + gate/up
projections run the ``fused_rmsnorm_mlp`` kernel (the down projection stays
a ``torch.matmul``) and each MoE block's expert products run
``moe.grouped_matmul``; the other backends run the per-expert loop.  Under
``ssm_backend="fused"`` each Mamba-2 block's prefill scan runs the
``ssd_scan`` kernel (``"torch"``, the default, runs the chunked scan in
plain PyTorch); the hybrid family's shared tile takes the attention
options and the MLP kernel like a dense block.  MLA prefill reaches
``flash_attention`` through ``attention_core`` (hd_qk 192, hd_v 128 at
full width); MLA decode is float32 einsums over the latent cache, as in
the reference.

Training: ``forward`` (-> float32 logits and the MoE load-balance loss) and
``loss_fn``; ``onehot_loss=True`` takes the gold logit by the reference's
iota compare instead of a gather.  The kernels run through
``repro_torch.kernels.ops``, whose autograd Functions launch them in the
forward and differentiate the reference's oracles in the backward.  The stacked layer params are
``unbind``-ed once per forward (one ``stack`` in the backward, not one
full-size gradient per layer) and, with ``remat`` (the reference's
``jax.checkpoint`` of its scan body), each block's body (the hybrid tile's
application before it included) is recomputed in the backward by
``torch.utils.checkpoint``.  Training takes the no-cache branch of every
layer: nothing autograd saved is written in place.

**Placed parameters** (DTensor leaves on a ``ProcessMesh``, from
``params.place_params``; every family): ``forward`` and ``loss_fn`` run on
each rank's blocks, the batch split over the batch axes
(``layers.batch_axes``), with the layers' explicit tensor parallelism
(``layers.gqa_apply`` / ``mla_apply``, ``_mlp``, ``mamba2.ssm_apply``; the
MoE runs ``moe_apply``'s mesh path on the rank's tokens and its blocks of
the expert weights, ``moe.expert_specs``, its shared experts whole).  The
hybrid family's shared tile is one placed leaf set read at every site:
autograd sums its gradient over the sites.
The embedding looks up the rank's vocab rows and sums over the table's
vocab axes; the logits are the rank's block of the reference's ``(DATA,
None, MODEL_FULL)`` site.  The loss over vocab-split logits: with
``onehot_loss`` the max, the sum of exponentials and the gold logit are
reduced across the vocab shards (the logits stay split); without it the
logits are all-gathered first, as the reference's gather forces under
GSPMD.  ``block_pspecs`` (the per-layer specs, no layer dim) relays each
block's leaves out inside the remat body.  Each rank's loss is its own
batch's; the trainer averages the gradients over the batch axes.

``prefill`` and ``decode_step`` from placed parameters take this rank's
rows of the batch (its share over the batch axes) and return those rows'
logits whole over the vocab.  The cache is placed (DTensor leaves) as
``launch.specs.cache_shardings`` says: the batch over the batch axes, each
attention ring's window over the model axis (flash-decoding's layout: a
rank holds every kv head of its slots), the SSM state's heads and the
conv buffers' channels over it; ``pos`` whole.  ``prefill`` moves each
layer's cache to its block as the layer makes it (a GQA layer's K/V from
the rank's kv heads to its window slice in one all-to-all,
``layers.cache_to_window``; MLA's latent and the SSM cache cut where they
are made) and never holds a whole one.  ``decode_step`` writes the
cache's blocks in place, as on one device (``layers.gqa_decode`` /
``mla_decode`` / ``mamba2.ssm_decode`` under ``ps``).

**The MRA stream split** (``mra_split``, the paper's C1): on a mesh with a
``replica`` axis each tile of those kinds (K > 1, ``core.replication.
split_kinds``) runs on the rank's own rows of the stream, its weights over
``shard``, and every other tile (K = 1: the embedding and the vocab / loss
tile always) on its replica group's rows, gathered over ``replica``, over
``(replica, shard)``; the stream moves only where two tiles in a row
differ (``gather_stream`` / ``split_stream``, :meth:`LM._move`).  The rows
given to the entry points are the rank's over :meth:`LM.rows_axes`; the
loss, the logits and ``forward``'s output are the replica group's rows;
``prefill`` and ``decode_step`` hand each rank its own rows' logits.  A
replicated MoE tile's load-balance losses are averaged over ``replica``.
Inside :func:`recording_rows` the token rows each tile ran on are recorded.
``mra_rows=False``
keeps the replicated tiles on their group's rows (a batch that does not
split over ``replica``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, not_ported
from repro_torch.kernels._common import repeat
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MoE
from repro_torch.launch.mesh import PartitionSpec, ProcessMesh, get_mesh, \
    set_mesh
from repro_torch.models.layers import (DATA, MODEL, MODEL_FULL, AttnOptions,
                                       site)
from repro_torch.models.params import (ParamSpec, abstract_params,
                                       init_params, spec, tree_leaves,
                                       tree_map, tree_unflatten)
from repro_torch.parallel import collectives as C
from repro_torch.parallel import placement as PL


# the open recording_rows(): (tile kind -> rows, split -> token rows)
_RECORDING: list = []


@contextlib.contextmanager
def recording_rows():
    """Inside, record the token rows each tile of a placed call runs on:
    yields a dict tile kind -> the token rows (rows, S) of its last placed
    call (a reference, no copy), the rank's own rows where the tile splits
    the stream, its replica group's where it takes it whole.  A call given
    ``embeds`` in place of tokens records nothing."""
    rows: Dict[str, torch.Tensor] = {}
    _RECORDING.append((rows, {}))
    try:
        yield rows
    finally:
        _RECORDING.pop()


def _stack_specs(tree, n: int):
    """Add a leading stacked-layers dim to every ParamSpec leaf."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        s.dtype, s.init, s.scale), tree)


def _attn_spec(cfg: ArchConfig):
    return L.mla_spec(cfg) if cfg.attn_type == "mla" else L.gqa_spec(cfg)


def _dense_block_spec(cfg: ArchConfig):
    return {
        "attn_norm": L.rms_norm_spec(cfg.d_model),
        "attn": _attn_spec(cfg),
        "mlp_norm": L.rms_norm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff),
    }


def _moe_block_spec(cfg: ArchConfig):
    return {
        "attn_norm": L.rms_norm_spec(cfg.d_model),
        "attn": _attn_spec(cfg),
        "mlp_norm": L.rms_norm_spec(cfg.d_model),
        "moe": MoE.moe_spec(cfg),
    }


def _ssm_block_spec(cfg: ArchConfig):
    return {"norm": L.rms_norm_spec(cfg.d_model), "ssm": M.ssm_spec(cfg)}


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda a: a[i], tree, is_leaf=torch.is_tensor)


def _is_pspec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _unplace(params):
    """``(mesh, local blocks, specs)`` of placed parameters (autograd flows
    from the blocks back to the placed leaves); ``(None, params, None)``
    when no leaf is placed."""
    first = next((t for t in tree_leaves(params, torch.is_tensor)
                  if PL.is_placed(t)), None)
    if first is None:
        return None, params, None
    return (PL.mesh_of(first), tree_map(PL.local, params, torch.is_tensor),
            tree_map(PL.spec_of, params, torch.is_tensor))


def _ambient(mesh):
    """``mesh`` as the ambient mesh, unless one over the same device mesh
    already is."""
    cur = get_mesh()
    if isinstance(cur, ProcessMesh) and cur.device_mesh is mesh.device_mesh:
        return contextlib.nullcontext()
    return set_mesh(mesh)


def _layer_spec(sp: PartitionSpec) -> PartitionSpec:
    """A stacked leaf's spec without its layers dim (never split)."""
    if sp and PL.entry_axes(sp[0]):
        raise ValueError(f"a stacked leaf placed {sp!r}: the layers dim "
                         "is not split")
    return PartitionSpec(*tuple(sp)[1:])


def _block_specs(ps):
    """The per-layer specs of placed stacked blocks (``None`` unplaced)."""
    return None if ps is None else tree_map(_layer_spec, ps["blocks"],
                                            _is_pspec)


def _whole(t, sp):
    """A leaf whole on every rank (``t`` itself when ``sp`` is ``None``,
    the unplaced case, or already replicates it)."""
    if sp is None:
        return t
    return PL.relayout(t, sp, (), get_mesh())


def _relayout_tree(tree, specs, want):
    """Each leaf of ``tree`` (blocks under ``specs``) as its block under
    ``want`` (the same structure, ``PartitionSpec`` leaves)."""
    mesh = get_mesh()
    got = [PL.relayout(t, s, w, mesh) for t, s, w in zip(
        tree_leaves(tree, torch.is_tensor), tree_leaves(specs, _is_pspec),
        tree_leaves(want, _is_pspec))]
    return tree_unflatten(tree, got)


@dataclass
class LM:
    cfg: ArchConfig
    opts: AttnOptions = dataclasses.field(default_factory=AttnOptions)
    kv_cache_dtype: Optional[torch.dtype] = None   # default bfloat16
    ssm_backend: str = "torch"   # torch | fused (reference: xla | pallas)
    remat: bool = True             # recompute each block in the backward
    onehot_loss: bool = False      # vocab-parallel gold extraction
    moe_ep: bool = False           # GShard expert-parallel MoE and explicit
    moe_axes: Any = None           # MoE shard axes, under an ambient mesh
    # per-layer PartitionSpec tree (block structure, no layer dim): under
    # placed parameters each block's leaves are relaid out to it inside the
    # remat body (the reference's use-site constraint); else the identity
    block_pspecs: Any = None
    # the tile kinds whose stream is split over an MRA mesh's ``replica``
    # axis (K > 1: ``core.replication.split_kinds``); under placed
    # parameters they run on the rank's own rows, the others on its replica
    # group's rows (the module's notes)
    mra_split: Tuple[str, ...] = ()
    # whether the replicated tiles split their rows over ``replica`` (False
    # for a batch that does not split that far: they then take their
    # group's rows whole on ``shard``, every replica alike)
    mra_rows: bool = True

    def __post_init__(self):
        why = not_ported(self.cfg)
        if why:
            raise NotImplementedError(why)
        if self.kv_cache_dtype == torch.int8 and self.cfg.attn_type != "mla":
            raise ValueError(
                "kv_cache_dtype=torch.int8 is the MLA latent cache's "
                f"(quant_kv); {self.cfg.name} has attn_type "
                f"{self.cfg.attn_type!r}")
        M.check_backend(self.ssm_backend)

    @property
    def _ssm(self) -> bool:
        """The blocks are Mamba-2 blocks (``ssm`` and ``hybrid``)."""
        return self.cfg.family in ("ssm", "hybrid")

    @property
    def _mla(self) -> bool:
        return self.cfg.attn_type == "mla"

    @property
    def _every(self) -> int:
        """The shared tile's period (0: no shared tile)."""
        return self.cfg.shared_attn_every if self.cfg.family == "hybrid" \
            else 0

    @property
    def n_apps(self) -> int:
        """Application sites of the shared tile: one before every block
        ``i`` with ``i % shared_attn_every == 0``."""
        every = self._every
        return -(-self.cfg.n_layers // every) if every else 0

    # ------------------------------------------------------ the MRA stream
    def tile_kinds(self) -> Tuple[str, ...]:
        """The compute tiles of the model (``core.tiles`` kinds)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return ("ssm",)
        if cfg.family == "hybrid":
            return ("ssm", "shared_attn")
        if cfg.family == "moe":
            return ("attn", "moe") + (("ffn",) if cfg.n_dense_layers else ())
        return ("attn", "ffn")

    def leaf_tiles(self):
        """The tile kind of every parameter leaf (the tree of
        :meth:`param_specs`): the tile whose stream the leaf is read on;
        ``"embed"`` for the embedding, the final norm and the head."""
        def kinds(block: Dict, shared: bool = False):
            if shared:
                return {k: tree_map(lambda _: "shared_attn", v)
                        for k, v in block.items()}
            out = {}
            for k, v in block.items():
                kind = ("ssm" if k in ("norm", "ssm") else
                        "attn" if k in ("attn_norm", "attn") else
                        "moe" if "moe" in block else "ffn")
                out[k] = tree_map(lambda _, kind=kind: kind, v)
            return out
        sp = self.param_specs()
        out = {k: tree_map(lambda _: "embed", v) for k, v in sp.items()
               if k not in ("blocks", "prelude", "shared_attn")}
        out["blocks"] = kinds(sp["blocks"])
        if "prelude" in sp:
            out["prelude"] = [kinds(b) for b in sp["prelude"]]
        if "shared_attn" in sp:
            out["shared_attn"] = kinds(sp["shared_attn"], shared=True)
        return out

    def split_leaves(self, mesh):
        """Per leaf: whether its gradient is a replica rank's share (the
        leaf read on the rank's own rows of a split stream) on ``mesh``."""
        return tree_map(lambda k: self._rows_split(k, mesh),
                        self.leaf_tiles(), lambda x: isinstance(x, str))

    def _is_split(self, kind: str, mesh=None) -> bool:
        """Whether tile ``kind`` runs on the rank's own rows (K > 1 on a
        mesh with a ``replica`` axis)."""
        mesh = mesh if mesh is not None else get_mesh()
        return (kind in self.mra_split and kind in self.tile_kinds()
                and mesh is not None and "replica" in mesh.axis_names)

    def _rows_split(self, kind: str, mesh=None) -> bool:
        """Whether tile ``kind`` runs on the rank's own rows of a split
        stream (``_is_split`` and ``mra_rows``)."""
        return self.mra_rows and self._is_split(kind, mesh)

    def _streams(self, kinds, ps):
        """``(replicated, own rows)`` of each tile kind of ``kinds`` (never
        either unplaced)."""
        return [(ps is not None and self._is_split(k),
                 ps is not None and self._rows_split(k)) for k in kinds]

    def _home_split(self, mesh) -> bool:
        """Whether a tile of the model splits its stream on ``mesh``."""
        return any(self._rows_split(k, mesh) for k in self.tile_kinds())

    def rows_axes(self, mesh) -> Tuple[str, ...]:
        """The axes the rows given to the placed entry points are split
        over: the batch axes, with ``replica`` where a tile of the model
        splits its stream (``data.pipeline.device_put_batch`` takes them)."""
        return L.stream_axes(mesh, self._home_split(mesh))

    def _move(self, x, own: bool, split: bool):
        """``x`` (the rank's own rows if ``own``, else its group's) as the
        rows of a tile that splits its stream or not: one
        ``gather_stream`` / ``split_stream`` over ``replica`` where the two
        differ."""
        if own == split:
            return x
        mesh = get_mesh()
        return (C.split_stream(x, "replica", mesh) if split
                else C.gather_stream(x, "replica", mesh))

    def _ran(self, kind: str, split: bool) -> None:
        """Record the token rows tile ``kind`` ran on (inside
        :func:`recording_rows`)."""
        if _RECORDING and _RECORDING[-1][1]:
            rows, tokens = _RECORDING[-1]
            rows[kind] = tokens[split]

    # ----------------------------------------------------------- param specs
    def param_specs(self):
        cfg = self.cfg
        out: Dict[str, Any] = {
            "embed": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
            "final_norm": L.rms_norm_spec(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            out["lm_head"] = spec((cfg.d_model, cfg.vocab_size),
                                  ("embed", "vocab"), init="small")
        if self._ssm:
            out["blocks"] = _stack_specs(_ssm_block_spec(cfg), cfg.n_layers)
        elif cfg.family == "moe":
            out["blocks"] = _stack_specs(_moe_block_spec(cfg),
                                         cfg.n_layers - cfg.n_dense_layers)
            if cfg.n_dense_layers:
                out["prelude"] = [_dense_block_spec(cfg)
                                  for _ in range(cfg.n_dense_layers)]
        else:
            out["blocks"] = _stack_specs(_dense_block_spec(cfg),
                                         cfg.n_layers)
        if cfg.family == "hybrid":
            out["shared_attn"] = _dense_block_spec(cfg)
        return out

    def init(self, generator: torch.Generator):
        """Random weights on ``generator.device``, drawn from ``generator``."""
        return init_params(self.param_specs(), generator)

    def abstract(self):
        return abstract_params(self.param_specs())

    # ------------------------------------------------------------- embedding
    def _embed(self, params, tokens=None, embeds=None, ps=None):
        """Token embeddings (B, S, d), or the given ``embeds`` as they are.
        The gather is an ``index_select``, whose backward adds rows on the
        device with no host read.  ``ps``: the specs of placed parameters
        (the table's vocab rows on each rank, summed over its axes); placed
        ``embeds``, like tokens, are the rank's rows, gathered over
        ``replica`` where the stream is split (the embedding a K = 1 tile)."""
        cfg = self.cfg
        if _RECORDING:
            _RECORDING[-1][1].clear()
        if ps is not None and embeds is None:
            return self._embed_placed(params, tokens, ps)
        if ps is not None:
            mesh = get_mesh()
            if self._home_split(mesh):
                embeds = C.gather_stream(embeds, "replica", mesh)
            site(tuple(embeds.shape), mesh, DATA, None, None)
            return embeds
        if embeds is None:
            table = params["embed"]
            embeds = table.index_select(0, tokens.reshape(-1)).reshape(
                tuple(tokens.shape) + (table.shape[1],))
            if cfg.tie_embeddings:   # gemma-style scaling for tied embeddings
                embeds = embeds * torch.tensor(math.sqrt(cfg.d_model),
                                               dtype=embeds.dtype)
        return embeds

    def _embed_placed(self, params, tokens, ps):
        """The embedding of the replica group's rows (a K = 1 tile: the
        rank's rows gathered over ``replica`` first where the stream is
        split), the table's vocab rows on each rank, summed over its
        axes."""
        cfg, mesh = self.cfg, get_mesh()
        rec = _RECORDING[-1][1] if _RECORDING else {}
        if self._home_split(mesh):
            rec[True] = tokens
            tokens = C.gather_stream(tokens, "replica", mesh)
        rec[False] = tokens
        self._ran("embed", False)
        site(tuple(tokens.shape) + (cfg.d_model,), mesh, DATA, None, None)
        vax = PL.entry_axes(ps["embed"][0]) if len(ps["embed"]) else ()
        table = PL.relayout(params["embed"], ps["embed"], (vax, None), mesh)
        n = table.shape[0]
        lo = C.axis_index(vax, mesh) * n if vax else 0
        ids = tokens.reshape(-1).long() - lo
        hit = (ids >= 0) & (ids < n)
        rows = table.index_select(0, torch.where(hit, ids, 0))
        rows = rows * hit[:, None].to(rows.dtype)
        embeds = C.psum(rows, vax, mesh).reshape(
            tuple(tokens.shape) + (table.shape[1],))
        if cfg.tie_embeddings:
            embeds = embeds * torch.tensor(math.sqrt(cfg.d_model),
                                           dtype=embeds.dtype)
        return embeds

    def _logits(self, params, x, ps=None):
        """float32 logits; under placed parameters this rank's block of
        the reference's ``(DATA, None, MODEL_FULL)`` site (the vocab split
        over its axes)."""
        cfg = self.cfg
        if ps is not None:
            return self._logits_placed(params, x, ps)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = x @ params["embed"].T
        else:
            logits = x @ params["lm_head"]
        return logits.float()

    def _vocab_axes(self, B: int, S: int):
        return site((B, S, self.cfg.vocab_size), get_mesh(), DATA, None,
                    MODEL_FULL)[2]

    def _logits_placed(self, params, x, ps):
        cfg, mesh = self.cfg, get_mesh()
        vax = self._vocab_axes(x.shape[0], x.shape[1])
        h = L.rms_norm(x, _whole(params["final_norm"], ps["final_norm"]),
                       cfg.norm_eps)
        h = C.replicated(h, vax, mesh)
        if cfg.tie_embeddings:
            w = PL.relayout(params["embed"], ps["embed"], (vax, None),
                            mesh).T
        else:
            w = PL.relayout(params["lm_head"], ps["lm_head"], (None, vax), mesh)
        return (h @ w).float()

    # ------------------------------------------------------------------ FFN
    def _ffn(self, bp, x, aux: bool = False, ps=None):
        """``(x + the block's FFN of rms_norm(x), aux)``: the MoE, or the
        gated MLP (``_mlp``).  Under ``fused`` the expert products run
        ``grouped_matmul``, else the per-expert loop.  ``aux`` asks for the
        MoE's load-balance loss (training); serving asks for none, and a
        dense block has none (``None``).  Under placed parameters
        ``moe_apply``'s mesh path runs on this rank's tokens and its blocks
        of the expert weights (``moe.expert_specs``: the experts or their
        columns of F the path reads; a tile of K = 1 on an MRA mesh over
        its whole fabric ``(replica, shard)`` unless ``moe_axes`` says
        otherwise); the router, the norm and any shared experts whole."""
        if "moe" not in bp:
            return self._mlp(bp, x, ps), None
        moe, extra = bp["moe"], {}
        norm = bp["mlp_norm"]
        axes = self.moe_axes
        if ps is not None:
            mesh = get_mesh()
            if axes is None and not L.tile_split() and \
                    "replica" in mesh.axis_names:
                axes = ("replica", "shard")     # K = 1: the whole fabric
            want = {**tree_map(lambda _: PartitionSpec(), ps["moe"],
                               _is_pspec),
                    **MoE.expert_specs(self.cfg, mesh, self.moe_ep, axes,
                                       x.shape[0] * x.shape[1], ())}
            moe = _relayout_tree(moe, ps["moe"], want)
            norm = _whole(norm, ps["mlp_norm"])
            extra = {"batch_axes": (), "blocks": True}
        h = L.rms_norm(x, norm, self.cfg.norm_eps)
        experts = "grouped" if self.opts.backend == "fused" else "loop"
        out, loss = MoE.moe_apply(moe, self.cfg, h, ep=self.moe_ep,
                                  model_axes=axes, experts=experts,
                                  aux=aux, **extra)
        return x + out, loss

    def _mlp(self, bp, x, ps=None):
        """``x + mlp(rms_norm(x))``; under ``fused`` the norm and the gate/up
        products are one ``fused_rmsnorm_mlp`` launch.  Under placed
        parameters the hidden's site ``(DATA, None, MODEL)`` names the axes
        ``tp``: the gate / up products on this rank's columns (the kernel on
        its blocks of ``Wg`` / ``Wu``, ``x`` and the norm's scale replicated
        over ``tp``), ``wo`` row-parallel, the output summed over ``tp``."""
        cfg = self.cfg
        if ps is not None:
            return self._mlp_placed(bp, x, ps)
        if self.opts.backend == "fused":
            from repro_torch.kernels.ops import fused_rmsnorm_mlp
            mp = bp["mlp"]
            B, S, d = x.shape
            h = fused_rmsnorm_mlp(x.reshape(B * S, d), bp["mlp_norm"],
                                  mp["wi_gate"], mp["wi_up"], cfg.act,
                                  cfg.norm_eps)
            return x + (h @ mp["wo"]).reshape(B, S, d)
        h = L.rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
        return x + L.mlp_apply(bp["mlp"], h, cfg.act)

    def _mlp_placed(self, bp, x, ps):
        cfg, mesh = self.cfg, get_mesh()
        B, S, d = x.shape
        tp = site((B, S, cfg.d_ff), mesh, DATA, None, MODEL)[2]
        w = L.blocks_as(bp["mlp"], ps["mlp"], {
            "wi_gate": (None, tp), "wi_up": (None, tp), "wo": (tp, None)},
            mesh)
        scale = _whole(bp["mlp_norm"], ps["mlp_norm"])
        if self.opts.backend == "fused":
            from repro_torch.kernels.ops import fused_rmsnorm_mlp
            h = fused_rmsnorm_mlp(C.replicated(x.reshape(B * S, d), tp, mesh),
                                  C.replicated(scale, tp, mesh),
                                  w["wi_gate"], w["wi_up"], cfg.act,
                                  cfg.norm_eps)
            out = (h @ w["wo"]).reshape(B, S, d)
        else:
            h = C.replicated(L.rms_norm(x, scale, cfg.norm_eps), tp, mesh)
            out = L.mlp_apply(w, h, cfg.act)
        return x + C.psum(out, tp, mesh)

    # ------------------------------------------------------- full-seq blocks
    def _block_tiles(self, bp, shared: bool = False) -> Tuple[str, ...]:
        """The tile kinds a block runs, in order."""
        if shared:
            return ("shared_attn", "shared_attn")
        if "ssm" in bp:
            return ("ssm",)
        return ("attn", "moe" if "moe" in bp else "ffn")

    def _exit_own(self, bp, ps, shared: bool = False) -> bool:
        """Whether a block's output holds the rank's own rows (its last
        tile splits the stream); never unplaced."""
        return ps is not None and self._rows_split(
            self._block_tiles(bp, shared)[-1])

    def _block_fwd(self, bp, x, positions, want_cache: bool,
                   aux: bool = False, ps=None, cs=None, own: bool = False,
                   shared: bool = False):
        """One block forward (a Mamba-2 block, or an attention block with a
        dense or MoE FFN: the hybrid family's shared tile, ``shared``, is a
        dense one); returns (x, cache_or_None, the MoE's aux loss or None).
        ``ps``: the specs of placed parameters (``bp`` then holds this
        rank's blocks; ``cs``: a Mamba-2 block's cache specs, its cache then
        their blocks); ``x`` holds the rank's own rows if ``own``, else its
        replica group's, and each tile takes the rows it runs on
        (:meth:`_move`); the output holds :meth:`_exit_own`'s, the cache
        its tile's."""
        cfg = self.cfg
        sub = (lambda k: ps[k]) if ps is not None else (lambda k: None)
        kinds = self._block_tiles(bp, shared)
        st = self._streams(kinds, ps)
        split = [r for _, r in st]
        x = self._move(x, own, split[0])
        self._ran(kinds[0], split[0])
        if "ssm" in bp:
            with L.tile_stream(*st[0]):
                h = L.rms_norm(x, _whole(bp["norm"], sub("norm")),
                               cfg.norm_eps)
                res = M.ssm_apply(bp["ssm"], cfg, h, backend=self.ssm_backend,
                                  return_cache=want_cache, ps=sub("ssm"),
                                  cs=cs)
            h, cache = res if want_cache else (res, None)
            return x + h, cache, None
        pos = positions[:x.shape[0]]
        with L.tile_stream(*st[0]):
            h = L.rms_norm(x, _whole(bp["attn_norm"], sub("attn_norm")),
                           cfg.norm_eps)
            apply = L.mla_apply if self._mla else L.gqa_apply
            res = apply(bp["attn"], cfg, h, pos, self.opts,
                        return_cache=want_cache, ps=sub("attn"))
        h, cache = res if want_cache else (res, None)
        x = self._move(x + h, split[0], split[1])
        self._ran(kinds[1], split[1])
        with L.tile_stream(*st[1]):
            x, loss = self._ffn(bp, x, aux, ps)
        if loss is not None and split[1]:
            # the replicas' load-balance losses: their mean, on each
            loss = C.pmean(loss, "replica", get_mesh())
        return x, cache, loss

    def _attn_layers(self, params, ps=None):
        """``(cache index, block params, their specs)`` of the attention
        blocks in cache order (dense and moe families): the prelude's dense
        blocks, then the stacked blocks one by one (a ``repeat`` loop: the
        reference's scan, which a FLOP counter may fold).  ``ps``: the specs
        of placed parameters (else the specs are ``None``)."""
        pre = list(params.get("prelude", []))
        for j, bp in enumerate(pre):
            yield j, bp, ps["prelude"][j] if ps else None
        bps = _block_specs(ps)
        for i in repeat(self.cfg.n_layers - len(pre)):
            yield len(pre) + i, _layer(params["blocks"], i), bps

    def _layers(self, n: int):
        """The loop over ``n`` stacked layers (a ``repeat`` loop); with the
        hybrid family's shared tile its iterations fall into two classes,
        with and without the tile before them."""
        every = self._every
        return repeat(n, (lambda i: i % every == 0) if every else None)

    def _train_block(self, bp, shared, x, positions, bps=None, sps=None,
                     own: bool = False):
        """The reference's scan body: the shared tile first where it applies
        (``shared`` not None), then the block; returns (x, aux or None), x
        holding the rows :meth:`_exit_own` says (``own``: the input's).
        Under ``remat`` it runs inside ``torch.utils.checkpoint`` (no RNG
        state to keep: the model draws no random numbers).  ``bps`` /
        ``sps``: the specs of placed block / shared-tile parameters; with
        ``block_pspecs`` the block's leaves are relaid out to them first,
        inside the body, which holds the ambient mesh itself (the remat
        recompute runs it again in the backward)."""
        mesh = get_mesh() if bps is not None else None

        def body(x):
            with (_ambient(mesh) if mesh is not None
                  else contextlib.nullcontext()):
                b, bs, o = bp, bps, own
                if bs is not None and self.block_pspecs is not None:
                    b = _relayout_tree(b, bs, self.block_pspecs)
                    bs = self.block_pspecs
                if shared is not None:
                    x, _, _ = self._block_fwd(shared, x, positions, False,
                                              ps=sps, own=o, shared=True)
                    o = self._exit_own(shared, sps, True)
                x, _, a = self._block_fwd(b, x, positions, False, aux=True,
                                          ps=bs, own=o)
                return x, a
        if self.remat:
            return checkpoint(body, x, use_reentrant=False,
                              preserve_rng_state=False)
        return body(x)

    def forward(self, params, tokens=None, embeds=None):
        """Training / scoring forward over the whole sequence.  tokens
        (B, S) (or ``embeds`` (B, S, d)).  Returns (logits (B, S, V)
        float32, aux loss () float32: the MoE blocks' load-balance losses
        summed and divided by ``max(n_layers - n_dense_layers, 1)``, as the
        reference's).  Under placed parameters the tokens are this rank's
        share of the batch (its rows over :meth:`rows_axes`) and the logits
        this rank's vocab block of its replica group's rows (the module's
        notes)."""
        mesh, params, ps = _unplace(params)
        if mesh is None:
            return self._forward(params, tokens, embeds, None)
        with _ambient(mesh):
            return self._forward(params, tokens, embeds, ps)

    def _forward(self, params, tokens, embeds, ps):
        """The logits and aux of ``forward``; placed, the logits are the
        replica group's rows (a K = 1 tile), this rank's vocab block."""
        cfg = self.cfg
        x = self._embed(params, tokens, embeds, ps)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                  device=x.device).expand(B, S)
        own = False
        for j, bp in enumerate(params.get("prelude", [])):
            bs = ps["prelude"][j] if ps else None
            x, _, _ = self._block_fwd(bp, x, positions, False, ps=bs,
                                      own=own)
            own = self._exit_own(bp, bs)
        every, shared = self._every, params.get("shared_attn")
        sps = ps.get("shared_attn") if ps else None
        blocks = params["blocks"]
        bps = _block_specs(ps)
        layers = [a.unbind(0) for a in tree_leaves(blocks, torch.is_tensor)]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in self._layers(len(layers[0])):
            bp = tree_unflatten(blocks, [a[i] for a in layers])
            x, a = self._train_block(
                bp, shared if every and i % every == 0 else None, x,
                positions, bps, sps, own)
            own = self._exit_own(bp, bps)
            if a is not None:
                aux = aux + a
        n_scan = max(cfg.n_layers - cfg.n_dense_layers, 1)
        x = self._move(x, own, False)
        return self._logits(params, x, ps), aux / n_scan

    def loss_fn(self, params, batch):
        """Mean next-token NLL plus ``0.01 * aux``.  ``batch``: ``tokens``
        (or ``embeds``) and ``labels`` (B, S).  Returns (loss, {"nll",
        "aux"}), float32 scalars on the device.  ``onehot_loss`` takes the
        gold logit by the reference's iota compare (``labels == iota``,
        summed), else by a gather.  Under placed parameters the loss is
        this rank's batch's (the module's notes)."""
        mesh, params, ps = _unplace(params)
        with (_ambient(mesh) if mesh is not None
              else contextlib.nullcontext()):
            logits, aux = self._forward(params, batch.get("tokens"),
                                        batch.get("embeds"), ps)
            labels = batch["labels"]
            if ps is not None and self._home_split(mesh):
                labels = C.gather_stream(labels, "replica", mesh)
            nll = self._nll(logits, labels.long(), ps is not None)
        loss = nll + 0.01 * aux
        return loss, {"nll": nll, "aux": aux}

    def _nll(self, logits, labels, placed: bool):
        """Mean of ``logsumexp - gold`` over the (rank's) tokens; placed:
        the logits are this rank's vocab block."""
        B, S, n = logits.shape
        vax = self._vocab_axes(B, S) if placed else ()
        mesh = get_mesh()
        if vax and not self.onehot_loss:
            # the gather wants whole rows: every rank gathers the logits
            logits = self._whole_vocab(logits)
            vax, n = (), logits.shape[-1]
        if not vax:
            logz = torch.logsumexp(logits, dim=-1)
        else:
            m = C.pmax(logits.amax(-1, keepdim=True), vax, mesh)
            logz = torch.log(C.psum(torch.exp(logits - m).sum(-1), vax,
                                    mesh)) + m[..., 0]
        if self.onehot_loss:
            lo = C.axis_index(vax, mesh) * n if vax else 0
            iota = torch.arange(lo, lo + n, device=logits.device)
            hit = labels[..., None] == iota
            gold = torch.where(hit, logits, 0.0).sum(-1)
            if vax:
                gold = C.psum(gold, vax, mesh)
        else:
            gold = logits.gather(-1, labels[..., None])[..., 0]
        return torch.mean(logz - gold)

    def _whole_vocab(self, logits):
        """This rank's vocab block of placed logits (B, S, n) gathered
        whole over the vocab axes (B, S, V)."""
        B, S, _ = logits.shape
        vax = self._vocab_axes(B, S)
        if not vax:
            return logits
        g = C.all_gather(logits, vax, get_mesh())       # (m, B, S, n)
        return g.permute(1, 2, 0, 3).reshape(B, S, -1)

    # -------------------------------------------------------------- prefill
    def prefill(self, params, tokens, cache_len: int = 0):
        """Full-sequence forward that also builds the decode cache.

        tokens: (B, S).  Returns (last-token logits (B,V) float32, cache);
        ``cache_len`` sizes the KV cache to the serving window (default: the
        prompt length), capped at the sliding window.  The ssm cache has no
        sequence axis and ignores ``cache_len``; the hybrid tile's KV history
        of each site is fitted to the window on its own.  Under placed
        parameters ``tokens`` are this rank's rows and the cache is placed
        (the module's notes).
        """
        mesh, params, ps = _unplace(params)
        if mesh is None:
            return self._prefill(params, tokens, cache_len, None)
        with _ambient(mesh):
            logits, cache = self._prefill(params, tokens, cache_len, ps)
            logits = self._whole_vocab(logits[:, None])[:, 0]
            return self._move(logits, False, self._home_split(mesh)), cache

    def _prefill(self, params, tokens, cache_len, ps):
        """``prefill`` on one device, or on this rank's blocks (``ps``: the
        parameters' specs; the logits then the replica group's rows): each
        layer's cache is then moved to its block of the placed cache as the
        layer makes it (:meth:`_to_cache`)."""
        cfg = self.cfg
        x = self._embed(params, tokens, ps=ps)
        B, S, _ = x.shape
        W = self._window(cache_len or S)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        blocks = params["blocks"]
        put, cs = self._to_cache(B, W, ps)
        pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
        own = False
        if self._ssm:
            stacked: Dict[str, torch.Tensor] = {}
            every, shared = self._every, params.get("shared_attn")
            sps, bps = (ps or {}).get("shared_attn"), _block_specs(ps)
            scs = None if cs is None else {
                k: _layer_spec(sp) for k, sp in cs["blocks"].items()}
            sh = None
            for i in self._layers(cfg.n_layers):
                if every and i % every == 0:     # the tile, site i // every
                    x, kv, _ = self._block_fwd(shared, x, positions, True,
                                               ps=sps, own=own, shared=True)
                    own = self._exit_own(shared, sps, True)
                    kv = put(self._pad_attn_cache(kv, W, S), "shared_attn")
                    if sh is None:
                        sh = tuple(a.new_empty((self.n_apps,) + a.shape)
                                   for a in kv)
                    sh[0][i // every], sh[1][i // every] = kv
                bp = _layer(blocks, i)
                x, c, _ = self._block_fwd(bp, x, positions, True, ps=bps,
                                          cs=scs, own=own)
                own = self._exit_own(bp, bps)
                for k, a in c.items():
                    if k not in stacked:
                        stacked[k] = a.new_empty((cfg.n_layers,) + a.shape)
                    stacked[k][i] = a
            x = self._move(x, own, False)
            logits = self._logits(params, x[:, -1:, :], ps)[:, 0, :]
            cache = {"pos": pos, "blocks": stacked}
            if sh is not None:
                cache["shared_attn"] = sh
            return logits, (cache if cs is None
                            else self._placed_cache(cache, W))
        ck = cv = None
        for i, bp, bs in self._attn_layers(params, ps):
            x, kv, _ = self._block_fwd(bp, x, positions, True, ps=bs, own=own)
            own = self._exit_own(bp, bs)
            if self._mla and self.kv_cache_dtype == torch.int8:
                kv = tuple(L.quant_kv(a) for a in kv)
            k, v = put(self._pad_attn_cache(kv, W, S), "blocks")
            if ck is None:
                ck = k.new_empty((cfg.n_layers,) + k.shape)
                cv = v.new_empty((cfg.n_layers,) + v.shape)
            ck[i], cv[i] = k, v
        cache = {"pos": pos, "blocks": (ck, cv)}
        x = self._move(x, own, False)
        logits = self._logits(params, x[:, -1:, :], ps)[:, 0, :]
        return logits, (cache if cs is None
                        else self._placed_cache(cache, W))

    def _cache_tile(self, key: str) -> str:
        """The tile whose rows and fabric a cache entry follows."""
        if key == "shared_attn":
            return "shared_attn"
        return "ssm" if self._ssm else "attn"

    def _to_cache(self, B: int, W: int, ps):
        """(``put``, the placed cache's specs) for a prefill of ``B`` rows a
        replica group into a ``W``-slot ring: ``put(kv, key)`` moves a
        layer's ring pair, of its tile's rows and its kv heads (MLA: the
        latent, whole), to its block of ring ``key`` of the cache
        (``layers.cache_to_window``: one all-to-all from the heads to the
        window).  Unplaced: the identity and ``None``."""
        if ps is None:
            return (lambda kv, key: kv), None
        from repro_torch.launch.specs import cache_specs
        mesh = get_mesh()
        cs = cache_specs(self, B * C.axis_size(L.group_axes(mesh), mesh), W,
                         mesh)

        def put(kv, key):
            wax = PL.entry_axes(cs[key][0][2])
            tile = self._cache_tile(key)
            with L.tile_stream(self._is_split(tile), self._rows_split(tile)):
                heads = (L.kv_heads_axes(self.cfg, kv[0].shape[0], mesh)
                         if self.cfg.n_kv_heads and not self._mla else ())
            return tuple(L.cache_to_window(a, heads, wax, mesh) for a in kv)
        return put, cs

    def _placed_cache(self, cache, W: int):
        """The cache of this rank's blocks placed (``launch.specs.
        place_cache``); ``pos`` holds the replica group's rows."""
        from repro_torch.launch.specs import place_cache
        mesh = get_mesh()
        n = C.axis_size(L.group_axes(mesh), mesh)
        # pos is placed whole: every row of the batch is at the prompt's end
        return place_cache(self, dict(cache, pos=cache["pos"].repeat(n)),
                           mesh, W)

    # ---------------------------------------------------------- decode step
    def decode_step(self, params, cache, tokens):
        """One-token decode for every batch row.  tokens: (B, 1).

        Each row attends at its own position ``cache["pos"][b]`` and its new
        K/V is written into ``cache["blocks"]`` **in place** at ring slot
        ``pos[b] % W``.  Returns (logits (B,V) float32, cache) where the
        returned cache holds the same K/V tensors and ``pos + 1``.

        The ssm family also writes **in place**: each layer's new conv
        buffers and state (computed as new tensors by ``ssm_decode``) are
        copied into that layer's slice of the stacked cache tensors, so the
        returned cache holds the same tensors (no new state per step).  The
        hybrid family's shared tile, before block ``i``, attends over site
        ``i // shared_attn_every`` of ``cache["shared_attn"]`` and writes its
        new K/V there in place, as a dense block does.  Under placed
        parameters ``tokens`` are this rank's rows and ``cache`` the placed
        one ``prefill`` returns (the module's notes)."""
        mesh, params, ps = _unplace(params)
        if mesh is None:
            return self._decode(params, cache, tokens, None, None)
        _, local, cs = _unplace(cache)
        with _ambient(mesh):
            pos = local["pos"]
            B = tokens.shape[0]
            g = B * (mesh.shape["replica"] if self._home_split(mesh) else 1)
            r0 = C.axis_index(L.group_axes(mesh), mesh) * g
            logits, _ = self._decode(params, {**local, "pos": pos[r0:r0 + g]},
                                     tokens, ps, cs)
            out = dict(cache, pos=PL.from_block(pos + 1, cs["pos"], mesh,
                                                tuple(pos.shape)))
            logits = self._whole_vocab(logits[:, None])[:, 0]
            return self._move(logits, False, self._home_split(mesh)), out

    def _decode(self, params, cache, tokens, ps, cs):
        """``decode_step`` on one device, or on this rank's blocks (``ps``
        and ``cs``: the parameters' and the cache's specs; ``cache["pos"]``
        then the replica group's rows', the logits theirs)."""
        cfg = self.cfg
        x = self._embed(params, tokens, ps=ps)
        pos = cache["pos"]
        blocks = params["blocks"]
        own = False
        if self._ssm:
            sc = cache["blocks"]
            every, shared = self._every, params.get("shared_attn")
            sh = cache.get("shared_attn")
            bps = _block_specs(ps) or {}
            sps, scs, sax = (ps or {}).get("shared_attn"), None, ()
            if ps is not None:
                scs = {k: _layer_spec(s) for k, s in cs["blocks"].items()}
                if sh is not None:
                    sax = PL.entry_axes(cs["shared_attn"][0][2])
            (rep, split), = self._streams(("ssm",), ps)
            for i in self._layers(cfg.n_layers):
                if every and i % every == 0:
                    x, own = self._block_decode(
                        shared, x, sh[0][i // every], sh[1][i // every], pos,
                        sps, sax, own, shared=True)
                bp = _layer(blocks, i)
                x = self._move(x, own, split)
                own = split
                self._ran("ssm", split)
                with L.tile_stream(rep, split):
                    h = L.rms_norm(x, _whole(bp["norm"], bps.get("norm")),
                                   cfg.norm_eps)
                    h, c2 = M.ssm_decode(bp["ssm"], cfg, h,
                                         {k: a[i] for k, a in sc.items()},
                                         ps=bps.get("ssm"), cs=scs)
                x = x + h
                for k, a in c2.items():
                    sc[k][i].copy_(a)               # casts to the cache dtype
            x = self._move(x, own, False)
            logits = self._logits(params, x, ps)[:, 0, :]
            out = {"pos": pos + 1, "blocks": sc}
            if sh is not None:
                out["shared_attn"] = sh
            return logits, out
        ck, cv = cache["blocks"]
        wax = PL.entry_axes(cs["blocks"][0][2]) if ps is not None else ()
        for i, bp, bs in self._attn_layers(params, ps):
            x, own = self._block_decode(bp, x, ck[i], cv[i], pos, bs, wax,
                                        own)
        x = self._move(x, own, False)
        logits = self._logits(params, x, ps)[:, 0, :]
        return logits, {"pos": pos + 1, "blocks": (ck, cv)}

    def _block_decode(self, bp, x, cache_k, cache_v, pos, ps=None, wax=(),
                      own: bool = False, shared: bool = False):
        """One attention block's decode; returns (x, whether it holds the
        rank's own rows).  ``ps``: the block's specs (placed: ``cache_k`` /
        ``cache_v`` this rank's slice of the ring over ``wax``, of the
        attention tile's rows; ``pos`` the replica group's rows', ``x``
        the rank's own rows' if ``own``)."""
        cfg = self.cfg
        sub = (lambda k: ps[k]) if ps is not None else (lambda k: None)
        kinds = self._block_tiles(bp, shared)
        st = self._streams(kinds, ps)
        split = [r for _, r in st]
        x = self._move(x, own, split[0])
        self._ran(kinds[0], split[0])
        p = self._move(pos, False, split[0])
        with L.tile_stream(*st[0]):
            h = L.rms_norm(x, _whole(bp["attn_norm"], sub("attn_norm")),
                           cfg.norm_eps)
            decode = L.mla_decode if self._mla else L.gqa_decode
            h, _, _ = decode(bp["attn"], cfg, h, cache_k, cache_v, p,
                             self.opts, ps=sub("attn"), wax=wax)
        x = self._move(x + h, split[0], split[1])
        self._ran(kinds[1], split[1])
        with L.tile_stream(*st[1]):
            x = self._ffn(bp, x, ps=ps)[0]
        return x, split[1]

    # ------------------------------------------------------------ cache mgmt
    def _window(self, requested: int) -> int:
        """Serving KV window: SWA archs cap at the sliding window."""
        if self.cfg.sliding_window:
            return min(requested, self.cfg.sliding_window)
        return requested

    def _attn_cache_dims(self):
        cfg = self.cfg
        if self._mla:
            return (cfg.kv_lora_rank,), (cfg.qk_rope_dim,)
        return (cfg.n_kv_heads, cfg.head_dim), (cfg.n_kv_heads, cfg.head_dim)

    def _zero_attn_cache(self, n, batch, W, dtype, device):
        """Zero ``(k, v)`` of shape ``(n, batch, W, KV, hd)`` (MLA: ``(ckv,
        k_rope)``, ``(n, batch, W, r)`` / ``(n, batch, W, rope)``): ``n``
        stacked layers (dense, moe) or sites of the shared tile (hybrid)."""
        d0, d1 = self._attn_cache_dims()
        return (torch.zeros((n, batch, W) + d0, dtype=dtype, device=device),
                torch.zeros((n, batch, W) + d1, dtype=dtype, device=device))

    def _pad_attn_cache(self, c, W: int, S: int):
        """Fit prefill-produced caches (len S) into the serving window W."""
        if c is None:
            return None

        def fit(a):
            if a is None:
                return None
            # prefill caches come as (B,S,*tail) or stacked (L,B,S,*tail);
            # locate the sequence axis (first axis of size S after axis 0)
            ax = next((i for i in range(1, a.dim()) if a.shape[i] == S), None)
            assert ax is not None, (tuple(a.shape), S)
            if W == S:
                return a
            if W < S:
                # keep the last W positions AND rotate them so position p
                # lands in ring slot p % W (decode's slot = pos % W)
                kept = a.narrow(ax, S - W, W)
                return torch.roll(kept, shifts=(S - W) % W, dims=ax)
            pad = [0, 0] * (a.dim() - ax - 1) + [0, W - S]
            return torch.nn.functional.pad(a, pad)
        return tree_map(fit, c, is_leaf=torch.is_tensor)

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None):
        """Empty decode cache sized for ``max_len`` context."""
        cfg = self.cfg
        dtype = dtype or self.kv_cache_dtype or torch.bfloat16
        W = self._window(max_len)
        n = cfg.n_layers
        pos = torch.zeros((batch,), dtype=torch.int32, device=device)
        if self._ssm:       # conv buffers in the cache dtype, state float32
            one = M.ssm_cache_init(cfg, n * batch, dtype, device)
            cache = {"pos": pos,
                     "blocks": {k: a.reshape((n, batch) + a.shape[1:])
                                for k, a in one.items()}}
            if self.n_apps:       # the shared tile: one history per site
                cache["shared_attn"] = self._zero_attn_cache(
                    self.n_apps, batch, W, dtype, device)
            return cache
        return {"pos": pos,
                "blocks": self._zero_attn_cache(n, batch, W, dtype, device)}
