"""Transformer layers of the port: norms, RoPE, GQA/MQA attention, gated MLPs.

Plain functions on tensors; parameters are the nested dicts built from
:mod:`repro_torch.models.params` specs, in the reference's layout
(``repro/models/layers.py``).  Attention has three backends:

* ``naive``   — full score matrix (the oracle; what ``gqa_decode`` uses too),
* ``chunked`` — the online-softmax schedule over (q-block, kv-block) tiles,
                written as two Python loops (the reference's ``lax.scan``),
* ``fused``   — the hand-written CUDA kernels of :mod:`repro_torch.kernels`
                (the reference's ``"pallas"``): ``attention_core`` launches
                ``flash_attention`` and ``gqa_decode`` launches
                ``flash_decode``.  On CPU tensors their plain versions run.

MLA (``mla_*``, ``quant_kv``) is not ported yet (ROADMAP queue A item 10.3).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import spec

NEG_INF = -1e30
UNWRITTEN = 1_000_000_000     # key position of a ring slot not written yet

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def rms_norm_spec(d: int):
    return spec((d,), ("norm",), init="zeros")


# ---------------------------------------------------------------------------
# RoPE (split halves, angles in float32)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """``1 / theta ** (2i / head_dim)`` in float32.  ``theta`` enters as a
    Python scalar: a tensor made from it on a card would be a host-to-device
    copy, which waits for the card (two per layer and step)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (hd/2,)
    ang = positions[..., None].float() * freqs                  # (..., S, hd/2)
    sin = torch.sin(ang)[..., None, :]                          # over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_spec(d: int, d_ff: int):
    return {
        "wi_gate": spec((d, d_ff), ("embed", "ff")),
        "wi_up": spec((d, d_ff), ("embed", "ff")),
        "wo": spec((d_ff, d), ("ff", "embed"), init="small"),
    }


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp_apply(p: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    gate = _act(x @ p["wi_gate"], act)
    h = gate * (x @ p["wi_up"])
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# Attention options & masking
# ---------------------------------------------------------------------------

BACKENDS = ("naive", "chunked", "fused")


@dataclass(frozen=True)
class AttnOptions:
    backend: str = "chunked"     # naive | chunked | fused
    q_block: int = 512
    kv_block: int = 512
    folded: bool = False         # folded-triangle causal schedule

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"attention backend {self.backend!r}; the port "
                             f"has {BACKENDS} (its name for the reference's "
                             f"'pallas' is 'fused')")


def _window_mask(qpos: torch.Tensor, kpos: torch.Tensor,
                 window: int) -> torch.Tensor:
    """Causal (+ optional sliding window) mask: (..., Sq, Sk) boolean."""
    m = kpos[..., None, :] <= qpos[..., :, None]
    if window:
        m &= (qpos[..., :, None] - kpos[..., None, :]) < window
    return m


# ---------------------------------------------------------------------------
# Score computation (GQA-aware)
# ---------------------------------------------------------------------------


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,KV,G,hd), k: (B,Sk,KV,hd) -> (B,KV,G,Sq,Sk) float32."""
    return torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())


def _gqa_out(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w: (B,KV,G,Sq,Sk), v: (B,Sk,KV,hd) -> (B,Sq,KV,G,hd)."""
    return torch.einsum("bkgqs,bskh->bqkgh", w, v.float())


def attention_naive(q, k, v, qpos, kpos, window: int,
                    scale: float) -> torch.Tensor:
    """Oracle attention.  q:(B,Sq,KV,G,hd) k,v:(B,Sk,KV,hd).  A query row
    with no live key gets the mean of ``v`` (softmax of a constant row), as
    in the reference; the kernels and ``attention_chunked`` give 0 there."""
    s = _gqa_scores(q, k) * scale
    mask = _window_mask(qpos, kpos, window)                    # (B,Sq,Sk)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return _gqa_out(w, v).to(q.dtype)


def _online_block(carry, qb, kb, vb, mask, scale):
    """One online-softmax accumulation step.

    carry = (acc (B,KV,G,Tq,hd) f32, m (B,KV,G,Tq) f32, l (B,KV,G,Tq) f32)
    """
    acc, m, l = carry
    mb = mask[:, None, None]
    s = _gqa_scores(qb, kb) * scale                            # (B,KV,G,Tq,Tk)
    s = torch.where(mb, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # zero fully-masked entries explicitly: exp(-1e30 - (-1e30)) == 1 trap
    p = torch.where(mb, torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(torch.clamp(m - m_new, max=0.0))
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskh->bkgqh", p, vb.float())
    acc = acc * corr[..., None] + pv
    return acc, m_new, l


def attention_chunked(q, k, v, qpos, kpos, window: int, scale: float,
                      opts: AttnOptions) -> torch.Tensor:
    """Flash-style attention with online softmax over (q-block, kv-block)
    tiles; every rectangle is computed and masked (the reference's baseline
    schedule).  The folded-triangle schedule is not ported."""
    if opts.folded:
        raise NotImplementedError(
            "folded-triangle attention schedule is not ported yet (ROADMAP "
            "queue A item 10.4)")
    B, Sq, KV, G, _ = q.shape
    hd = v.shape[-1]
    Sk = k.shape[1]
    QB = min(opts.q_block, Sq)
    KB = min(opts.kv_block, Sk)
    assert Sq % QB == 0 and Sk % KB == 0, (Sq, QB, Sk, KB)
    outs = []
    for i in range(0, Sq, QB):
        qb, qp = q[:, i:i + QB], qpos[:, i:i + QB]
        carry = (q.new_zeros((B, KV, G, QB, hd), dtype=torch.float32),
                 q.new_full((B, KV, G, QB), NEG_INF, dtype=torch.float32),
                 q.new_zeros((B, KV, G, QB), dtype=torch.float32))
        for j in range(0, Sk, KB):
            mask = _window_mask(qp, kpos[:, j:j + KB], window)
            carry = _online_block(carry, qb, k[:, j:j + KB], v[:, j:j + KB],
                                  mask, scale)
        acc, _, l = carry
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.cat(outs, dim=3)                               # (B,KV,G,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def attention_core(q, k, v, qpos, kpos, window: int, opts: AttnOptions,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Dispatch over attention backends.  Shapes as in attention_naive."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if opts.backend == "fused":
        from repro_torch.kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, qpos, kpos, window, scale)
    if opts.backend == "chunked" and q.shape[1] > opts.q_block:
        return attention_chunked(q, k, v, qpos, kpos, window, scale, opts)
    return attention_naive(q, k, v, qpos, kpos, window, scale)


# ---------------------------------------------------------------------------
# GQA attention block (projections + rope + cache)
# ---------------------------------------------------------------------------


def gqa_spec(cfg: ArchConfig):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": spec((d, H * hd), ("embed", "qkv")),
        "wk": spec((d, KV * hd), ("embed", "kv")),
        "wv": spec((d, KV * hd), ("embed", "kv")),
        "wo": spec((H * hd, d), ("qkv", "embed"), init="small"),
    }


def gqa_project(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """x: (B,S,d) -> rotated q (B,S,KV,G,hd), rotated k and v (B,S,KV,hd)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    q = apply_rope(q, positions, cfg.rope_theta).reshape(B, S, KV, H // KV, hd)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_apply(p: Dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, opts: AttnOptions,
              return_cache: bool = False):
    """Full-sequence (prefill) GQA attention."""
    B, S, _ = x.shape
    q, k, v = gqa_project(p, cfg, x, positions)
    out = attention_core(q, k, v, positions, positions, cfg.sliding_window,
                         opts)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    if return_cache:
        return out, (k, v)
    return out


def ring_kpos(pos: torch.Tensor, W: int) -> torch.Tensor:
    """(B,) current positions -> (B, W) absolute position held in each ring
    slot after the write at ``pos % W``; unwritten slots get a future
    position (``UNWRITTEN``) so the causal mask rejects them."""
    slot = (pos % W)[:, None]
    wraps = (pos // W)[:, None]
    idx = torch.arange(W, dtype=pos.dtype, device=pos.device)[None, :]
    kpos = torch.where(idx <= slot, wraps * W + idx, (wraps - 1) * W + idx)
    return torch.where(kpos >= 0, kpos, UNWRITTEN)


def gqa_decode(p: Dict, cfg: ArchConfig, x: torch.Tensor,
               cache_k: torch.Tensor, cache_v: torch.Tensor,
               pos: torch.Tensor, opts: AttnOptions
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode with a (ring-buffered when SWA) KV cache.

    x: (B,1,d); cache_k/v: (B,W,KV,hd); pos: (B,) int32, each row's current
    position (a scalar is broadcast).  Row b's new K/V is written at ring
    slot ``pos[b] % W`` **in place** (``cache_k``/``cache_v`` are modified
    and returned).  Returns (out (B,1,d), cache_k, cache_v).
    """
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    W = cache_k.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=x.device).expand(B).contiguous()
    positions = pos[:, None]
    q, k, v = gqa_project(p, cfg, x, positions)
    rows = torch.arange(B, device=x.device)
    slot = (pos % W).long()
    cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
    kpos = ring_kpos(pos, W)
    window = cfg.sliding_window if cfg.sliding_window else 0
    scale = 1.0 / math.sqrt(hd)
    if opts.backend == "fused":
        from repro_torch.kernels.flash_decode import flash_decode
        out = flash_decode(q[:, 0], cache_k, cache_v, pos, kpos, window,
                           scale, opts.kv_block)
    else:
        out = attention_naive(q, cache_k, cache_v, positions, kpos, window,
                              scale)
    out = out.reshape(B, 1, H * hd) @ p["wo"]
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention) — not ported yet
# ---------------------------------------------------------------------------


def _mla_waits(*args, **kwargs):
    raise NotImplementedError(
        "MLA attention (mla_spec / mla_apply / mla_decode / quant_kv) is not "
        "ported yet (ROADMAP queue A item 10.3)")


mla_spec = mla_apply = mla_decode = quant_kv = dequant_kv = _mla_waits
