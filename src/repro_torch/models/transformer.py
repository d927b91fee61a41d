"""Decoder LM of the port, for the ``dense`` family (pre-norm GQA/MQA
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
dim; here it is a Python loop.  Entry points: ``prefill`` (-> cache) and
``decode_step`` (cache -> cache).  Each batch row has its own position
``cache["pos"]`` (B,) int32, so rows admitted at different times decode
side by side.  The dense and moe caches' ``blocks`` is ``(k, v)`` of shape
``(L, B, W, KV, hd)`` over all ``n_layers`` attention layers, the prelude's
first (the reference keeps the prelude's apart, as a list); the ssm and
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
options and the MLP kernel like a dense block.  ``attn_type="mla"`` and the
training entry points are not ported yet and raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, not_ported
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MoE
from repro_torch.models.layers import AttnOptions
from repro_torch.models.params import (ParamSpec, abstract_params,
                                       init_params, spec, tree_map)


def _stack_specs(tree, n: int):
    """Add a leading stacked-layers dim to every ParamSpec leaf."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        s.dtype, s.init, s.scale), tree)


def _dense_block_spec(cfg: ArchConfig):
    return {
        "attn_norm": L.rms_norm_spec(cfg.d_model),
        "attn": L.gqa_spec(cfg),
        "mlp_norm": L.rms_norm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff),
    }


def _moe_block_spec(cfg: ArchConfig):
    return {
        "attn_norm": L.rms_norm_spec(cfg.d_model),
        "attn": L.gqa_spec(cfg),
        "mlp_norm": L.rms_norm_spec(cfg.d_model),
        "moe": MoE.moe_spec(cfg),
    }


def _ssm_block_spec(cfg: ArchConfig):
    return {"norm": L.rms_norm_spec(cfg.d_model), "ssm": M.ssm_spec(cfg)}


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda a: a[i], tree, is_leaf=torch.is_tensor)


@dataclass
class LM:
    cfg: ArchConfig
    opts: AttnOptions = dataclasses.field(default_factory=AttnOptions)
    kv_cache_dtype: Optional[torch.dtype] = None   # default bfloat16
    ssm_backend: str = "torch"   # torch | fused (reference: xla | pallas)

    def __post_init__(self):
        why = not_ported(self.cfg)
        if why:
            raise NotImplementedError(why)
        M.check_backend(self.ssm_backend)

    @property
    def _ssm(self) -> bool:
        """The blocks are Mamba-2 blocks (``ssm`` and ``hybrid``)."""
        return self.cfg.family in ("ssm", "hybrid")

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
    def _embed(self, params, tokens):
        cfg = self.cfg
        embeds = params["embed"][tokens]
        if cfg.tie_embeddings:   # gemma-style scaling for tied embeddings
            embeds = embeds * torch.tensor(math.sqrt(cfg.d_model),
                                           dtype=embeds.dtype)
        return embeds

    def _logits(self, params, x):
        cfg = self.cfg
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = x @ params["embed"].T
        else:
            logits = x @ params["lm_head"]
        return logits.float()

    # ------------------------------------------------------------------ FFN
    def _ffn(self, bp, x):
        """``x`` + the block's FFN of ``rms_norm(x)``: the MoE, or the gated
        MLP (``_mlp``).  Under ``fused`` the expert products run
        ``grouped_matmul``, else the per-expert loop; serving asks for no
        aux loss."""
        if "moe" not in bp:
            return self._mlp(bp, x)
        h = L.rms_norm(x, bp["mlp_norm"], self.cfg.norm_eps)
        experts = "grouped" if self.opts.backend == "fused" else "loop"
        out, _ = MoE.moe_apply(bp["moe"], self.cfg, h, experts=experts,
                               aux=False)
        return x + out

    def _mlp(self, bp, x):
        """``x + mlp(rms_norm(x))``; under ``fused`` the norm and the gate/up
        products are one ``fused_rmsnorm_mlp`` launch."""
        cfg = self.cfg
        if self.opts.backend == "fused":
            from repro_torch.kernels.fused_mlp import fused_rmsnorm_mlp
            mp = bp["mlp"]
            B, S, d = x.shape
            h = fused_rmsnorm_mlp(x.reshape(B * S, d), bp["mlp_norm"],
                                  mp["wi_gate"], mp["wi_up"], cfg.act,
                                  cfg.norm_eps)
            return x + (h @ mp["wo"]).reshape(B, S, d)
        h = L.rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
        return x + L.mlp_apply(bp["mlp"], h, cfg.act)

    # ------------------------------------------------------- full-seq blocks
    def _block_fwd(self, bp, x, positions, want_cache: bool):
        """One block forward (a Mamba-2 block, or an attention block with a
        dense or MoE FFN: the hybrid family's shared tile is a dense one);
        returns (x, cache_or_None)."""
        cfg = self.cfg
        if "ssm" in bp:
            h = L.rms_norm(x, bp["norm"], cfg.norm_eps)
            res = M.ssm_apply(bp["ssm"], cfg, h, backend=self.ssm_backend,
                              return_cache=want_cache)
            h, cache = res if want_cache else (res, None)
            return x + h, cache
        h = L.rms_norm(x, bp["attn_norm"], cfg.norm_eps)
        res = L.gqa_apply(bp["attn"], cfg, h, positions, self.opts,
                          return_cache=want_cache)
        h, cache = res if want_cache else (res, None)
        return self._ffn(bp, x + h), cache

    def _attn_blocks(self, params):
        """The attention blocks in cache order (dense and moe families): the
        prelude's dense blocks, then the stacked blocks one by one."""
        pre = list(params.get("prelude", []))
        n = self.cfg.n_layers - len(pre)
        return pre + [_layer(params["blocks"], i) for i in range(n)]

    def forward(self, params, tokens=None, embeds=None):
        raise NotImplementedError(
            "LM.forward (training / scoring) is not ported yet: it comes "
            "with the training slice (ROADMAP queue A item 11)")

    def loss_fn(self, params, batch):
        raise NotImplementedError(
            "LM.loss_fn (training) is not ported yet: it comes with the "
            "training slice (ROADMAP queue A item 11)")

    # -------------------------------------------------------------- prefill
    def prefill(self, params, tokens, cache_len: int = 0):
        """Full-sequence forward that also builds the decode cache.

        tokens: (B, S).  Returns (last-token logits (B,V) float32, cache);
        ``cache_len`` sizes the KV cache to the serving window (default: the
        prompt length), capped at the sliding window.  The ssm cache has no
        sequence axis and ignores ``cache_len``; the hybrid tile's KV history
        of each site is fitted to the window on its own.
        """
        cfg = self.cfg
        x = self._embed(params, tokens)
        B, S, _ = x.shape
        W = self._window(cache_len or S)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        blocks = params["blocks"]
        pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
        if self._ssm:
            stacked: Dict[str, torch.Tensor] = {}
            every, shared = self._every, params.get("shared_attn")
            sh = None
            for i in range(cfg.n_layers):
                if every and i % every == 0:     # the tile, site i // every
                    x, kv = self._block_fwd(shared, x, positions, True)
                    kv = self._pad_attn_cache(kv, W, S)
                    if sh is None:
                        sh = tuple(a.new_empty((self.n_apps,) + a.shape)
                                   for a in kv)
                    sh[0][i // every], sh[1][i // every] = kv
                x, c = self._block_fwd(_layer(blocks, i), x, positions, True)
                for k, a in c.items():
                    if k not in stacked:
                        stacked[k] = a.new_empty((cfg.n_layers,) + a.shape)
                    stacked[k][i] = a
            logits = self._logits(params, x[:, -1:, :])[:, 0, :]
            cache = {"pos": pos, "blocks": stacked}
            if sh is not None:
                cache["shared_attn"] = sh
            return logits, cache
        ck = cv = None
        for i, bp in enumerate(self._attn_blocks(params)):
            x, (k, v) = self._block_fwd(bp, x, positions, True)
            if ck is None:
                ck = k.new_empty((cfg.n_layers, B, W) + k.shape[2:])
                cv = v.new_empty((cfg.n_layers, B, W) + v.shape[2:])
            k, v = self._pad_attn_cache((k, v), W, S)
            ck[i], cv[i] = k, v
        cache = {"pos": pos, "blocks": (ck, cv)}
        logits = self._logits(params, x[:, -1:, :])[:, 0, :]
        return logits, cache

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
        new K/V there in place, as a dense block does."""
        x = self._embed(params, tokens)
        pos = cache["pos"]
        blocks = params["blocks"]
        if self._ssm:
            sc = cache["blocks"]
            every, shared = self._every, params.get("shared_attn")
            sh = cache.get("shared_attn")
            for i in range(self.cfg.n_layers):
                if every and i % every == 0:
                    x = self._block_decode(shared, x, sh[0][i // every],
                                           sh[1][i // every], pos)
                bp = _layer(blocks, i)
                h = L.rms_norm(x, bp["norm"], self.cfg.norm_eps)
                h, c2 = M.ssm_decode(bp["ssm"], self.cfg, h,
                                     {k: a[i] for k, a in sc.items()})
                x = x + h
                for k, a in c2.items():
                    sc[k][i].copy_(a)               # casts to the cache dtype
            logits = self._logits(params, x)[:, 0, :]
            out = {"pos": pos + 1, "blocks": sc}
            if sh is not None:
                out["shared_attn"] = sh
            return logits, out
        ck, cv = cache["blocks"]
        for i, bp in enumerate(self._attn_blocks(params)):
            x = self._block_decode(bp, x, ck[i], cv[i], pos)
        logits = self._logits(params, x)[:, 0, :]
        return logits, {"pos": pos + 1, "blocks": (ck, cv)}

    def _block_decode(self, bp, x, cache_k, cache_v, pos):
        cfg = self.cfg
        h = L.rms_norm(x, bp["attn_norm"], cfg.norm_eps)
        h, _, _ = L.gqa_decode(bp["attn"], cfg, h, cache_k, cache_v, pos,
                               self.opts)
        return self._ffn(bp, x + h)

    # ------------------------------------------------------------ cache mgmt
    def _window(self, requested: int) -> int:
        """Serving KV window: SWA archs cap at the sliding window."""
        if self.cfg.sliding_window:
            return min(requested, self.cfg.sliding_window)
        return requested

    def _attn_cache_dims(self):
        cfg = self.cfg
        return (cfg.n_kv_heads, cfg.head_dim), (cfg.n_kv_heads, cfg.head_dim)

    def _zero_attn_cache(self, n, batch, W, dtype, device):
        """Zero ``(k, v)`` of shape ``(n, batch, W, KV, hd)``: ``n`` stacked
        layers (dense) or sites of the shared tile (hybrid)."""
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
