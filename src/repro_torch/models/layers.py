"""Transformer layers of the port: norms, RoPE, GQA/MQA/MLA attention, gated
MLPs.

Plain functions on tensors; parameters are the nested dicts built from
:mod:`repro_torch.models.params` specs, in the reference's layout
(``repro/models/layers.py``).  Attention has three backends:

* ``naive``   — full score matrix (the oracle; what ``gqa_decode`` uses too),
* ``chunked`` — the online-softmax schedule over (q-block, kv-block) tiles,
                written as Python loops (the reference's ``lax.scan``): every
                rectangle, or with ``AttnOptions.folded`` the folded-triangle
                schedule that pairs q-block ``i`` with ``nq - 1 - i``,
* ``fused``   — the hand-written CUDA kernels of :mod:`repro_torch.kernels`
                (the reference's ``"pallas"``): ``attention_core`` launches
                ``flash_attention`` through ``kernels.ops`` (a backward for
                training) and ``gqa_decode`` launches ``flash_decode``.  On
                CPU tensors their plain versions run.

Placed parameters (a ``ProcessMesh``; ``ps``: each leaf's ``PartitionSpec``
beside its local block): ``gqa_apply`` and the transformer's MLP run
tensor-parallel on each rank's blocks with explicit collectives.  At the
reference's ``shard_activation`` sites (q, k, v and the MLP hidden over
``(DATA, None, MODEL)``) :func:`site` computes the reference's spec, and the
layer holds exactly that block: the kv heads (with their q groups) or the
hidden columns over the spec's axes, the batch over the batch axes.  A
weight whose spec differs from the block it feeds is relaid out to it
(:func:`~repro_torch.parallel.placement.relayout`, counted collectives).
The input, replicated over those axes, enters through
``collectives.replicated`` (its gradient summed over them) and the
row-parallel output leaves through ``psum``.  On an MRA mesh the sites
are the current tile's (:func:`tile_stream`): a tile replicated over
``replica`` holds the rank's own rows and reads ``MODEL`` as ``shard``; a
tile of K = 1 holds its replica group's rows and reads ``MODEL`` as
``(replica, shard)``, its whole fabric (the model moves the stream
between them).

Placed serving: ``gqa_apply`` with ``return_cache`` gives this rank's
rows' k / v on its own kv heads, ``mla_apply`` its rows' latent cache
whole; the model moves each layer's to its block of the decode cache
(``launch.specs.cache_shardings``) as the layer makes it
(:func:`cache_to_window`: one all-to-all from the heads to the window).
``gqa_decode`` / ``mla_decode`` under ``ps`` take this rank's block of a
*window-split* cache (flash-decoding's layout: the ring's slots split over
the ``wax`` axes, every kv head on every rank): q of every head is
gathered (one token), each rank attends over its own slots and returns its
partial output with its log-sum-exp, :func:`combine_by_lse` merges the
ranks' partials, and ``wo`` runs on the rank's own heads; the new token's
K/V (MLA: its latent) is written only by the rank that holds ring slot
``pos % W`` (:func:`ring_write`).

MLA (DeepSeek-V2): ``mla_apply`` expands K and V from the latent and runs
plain MHA through ``attention_core`` (hd_qk ``nope + rope``, hd_v
``v_head_dim``); ``mla_decode`` runs the absorbed products over the latent
cache in float32, as the reference does (no kernel), optionally int8
(``quant_kv`` / ``dequant_kv``).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._common import repeat, unfolded
from repro_torch.launch.mesh import get_mesh
from repro_torch.models.params import activation_spec, get_batch_axes, spec
from repro_torch.parallel import collectives as C
from repro_torch.parallel.placement import entry_axes, relayout, swap_split

DATA = ("pod", "data")     # batch sharding axes (filtered to the live mesh)
MODEL = "model"            # intra-tile model fabric ("shard" on MRA meshes)
MODEL_FULL = "__model_full__"   # full model fabric (K=1 tiles, e.g. vocab)

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
# Placed parameters: the sites and the weights' blocks
# ---------------------------------------------------------------------------


def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the activations' batch dim is split over: the current
    batch axes (``params.get_batch_axes``) present in ``mesh``."""
    return tuple(a for a in get_batch_axes() if a in mesh.axis_names)


def group_axes(mesh) -> Tuple[str, ...]:
    """The batch axes of ``mesh`` less ``replica``: the rows a replica
    group of an MRA mesh shares (its tiles of K = 1 run on them whole)."""
    return tuple(a for a in batch_axes(mesh) if a != "replica")


def stream_axes(mesh, split: bool) -> Tuple[str, ...]:
    """The axes a tile's rows are split over: :func:`group_axes`, and
    ``replica`` too where the tile's stream is split over its replicas (K >
    1 on an MRA mesh; the paper's AXI bridge)."""
    g = group_axes(mesh)
    return g + ("replica",) if split and "replica" in mesh.axis_names else g


_SPLIT: list = [(False, False)]


@contextlib.contextmanager
def tile_stream(split: bool, rows: Optional[bool] = None):
    """Inside, the placed layers run as a tile replicated over ``replica``
    (``split``: K > 1, its fabric ``shard``), each rank on its own rows of
    the stream (``rows``, by default ``split``) or on its replica group's
    (a batch too small to split: the replicas compute alike), or as a tile
    that takes the stream whole (K = 1: the group's rows, its fabric
    ``(replica, shard)``); on a mesh with no ``replica`` axis they are all
    the same."""
    _SPLIT.append((bool(split), bool(split if rows is None else rows)))
    try:
        yield
    finally:
        _SPLIT.pop()


def tile_split() -> bool:
    """Whether the current tile is replicated, its fabric ``shard``
    (:func:`tile_stream`)."""
    return _SPLIT[-1][0]


def tile_rows() -> bool:
    """Whether the current tile runs on the rank's own rows of a split
    stream (:func:`tile_stream`)."""
    return _SPLIT[-1][1]


def site(local_shape: Tuple[int, ...], mesh, *axes) -> tuple:
    """The reference's ``shard_activation(x, *axes)`` spec at a site of the
    current tile (:func:`tile_stream`), for a tensor whose local block has
    ``local_shape`` (the batch dim this rank's share of the tile's rows,
    :func:`stream_axes`); each entry as a tuple of axes.  A tile that takes
    the stream whole reads ``MODEL`` as ``MODEL_FULL``, its whole fabric.
    The port's layers keep the batch on the tile's rows: a spec that moves
    it raises."""
    if not tile_split():
        axes = tuple(MODEL_FULL if a == MODEL else a for a in axes)
    rows = stream_axes(mesh, tile_rows())
    n = 1
    for a in rows:
        n *= mesh.shape[a]
    shape = (local_shape[0] * n,) + tuple(local_shape[1:])
    spec = activation_spec(shape, *axes, mesh=mesh, batch_axes=rows)
    ents = tuple(entry_axes(e) for e in spec)
    if ents[0] != rows:
        raise ValueError(f"the site {axes} puts the batch of {shape} on "
                         f"{ents[0]}; the tile keeps it on {rows}")
    return ents


def blocks_as(p: Dict, ps: Dict, want: Dict, mesh) -> Dict:
    """``p``'s leaves named in ``want`` as the blocks of the specs there
    (relaid out where their own spec ``ps`` differs)."""
    return {k: relayout(p[k], ps[k], want[k], mesh) for k in want}


def merge_by_lse(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Normalised partial outputs ``outs`` (n, ..., D) over n slices of
    the keys merged by their log-sum-exps ``lses`` (n, ...) into the output
    over all the keys, float32: the maximum of the lse over the slices,
    then the sum of the outputs rescaled by ``exp(lse - max)`` over the sum
    of those weights.  A slice with no live key (``lse`` -inf, output 0)
    weighs exactly 0: the maximum is taken with a finite floor, so
    ``exp(lse - m)`` is ``exp(-inf) = 0`` there and never ``nan``."""
    w = torch.exp(lses - torch.clamp(lses, min=NEG_INF).amax(0))
    return (outs.float() * w[..., None]).sum(0) / torch.clamp(
        w.sum(0), min=1e-30)[..., None]


def combine_by_lse(out: torch.Tensor, lse: torch.Tensor, axes,
                   mesh) -> torch.Tensor:
    """The ranks of ``axes`` each attended over their own slice of the
    keys: their partial outputs ``out`` (..., D) and log-sum-exps ``lse``
    (...) brought to every rank in one all-gather and merged there
    (:func:`merge_by_lse`), float32."""
    if not axes:
        return out.float()
    both = C.all_gather(torch.cat([out.float(), lse[..., None]], -1), axes,
                        mesh)                             # (n, ..., D + 1)
    return merge_by_lse(both[..., :-1], both[..., -1])


def gather_last(parts, axes, mesh):
    """Tensors split on their last dim over ``axes`` (this rank's blocks,
    one leading shape), each gathered whole with one all-gather for all."""
    if not axes:
        return list(parts)
    sizes = [t.shape[-1] for t in parts]
    g = C.all_gather(torch.cat(parts, -1), axes, mesh)   # (n, ..., sum)
    g = g.movedim(0, -2)                                 # (..., n, sum)
    out, at = [], 0
    for k in sizes:
        out.append(g[..., at:at + k].reshape(g.shape[:-2] + (-1,)))
        at += k
    return out


def ring_write(cache: torch.Tensor, new: torch.Tensor,
               local: torch.Tensor) -> None:
    """Row ``b`` of ``new`` (B, ...) into this rank's slice ``cache`` (B,
    W_l, ...) of a ring at local slot ``local[b]``, **in place**, for the
    rows whose slot lies in the slice (``0 <= local < W_l``); the others
    keep what they hold (another rank holds their slot).  No host read."""
    W_l = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = torch.clamp(local, 0, W_l - 1).long()
    mine = ((local >= 0) & (local < W_l)).reshape(
        (-1,) + (1,) * (new.dim() - 1))
    cache[rows, at] = torch.where(mine, new.to(cache.dtype), cache[rows, at])


def window_slice(pos: torch.Tensor, W_l: int, wax, mesh):
    """(this rank's first ring slot, the ring's length W, the slots' key
    positions (B, W_l)) for a ring of ``W_l`` slots a rank split over
    ``wax``."""
    lo = C.axis_index(wax, mesh) * W_l if wax else 0
    W = W_l * (C.axis_size(wax, mesh) if wax else 1)
    return lo, W, ring_kpos(pos, W)[:, lo:lo + W_l]


def cache_to_window(a: torch.Tensor, heads, wax, mesh) -> torch.Tensor:
    """A prefill's ring (B, W, H, ...) of this rank's rows, dim 2 split
    over ``heads`` (a placed layer's kv heads; ``()``: whole), as the
    decode cache's block: this rank's slice of the window over ``wax``,
    every head.  One all-to-all where both are the same one axis (each
    rank sends each peer the peer's slots of its own heads), else by
    ``relayout`` (no collective where the heads are whole)."""
    heads, wax = tuple(heads), tuple(wax)
    if heads and heads == wax and len(heads) == 1:
        return swap_split(a, 2, 1, heads[0], mesh)
    return relayout(a, (None, None, heads), (None, wax), mesh)


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
    tiles.  Baseline schedule: every rectangle is computed and masked.
    Folded schedule (``opts.folded``): q-blocks ``i`` and ``nq - 1 - i`` are
    paired, and the pair's ``nq + 1`` kv steps serve the low block with kv
    blocks ``0..i`` and then the high block with ``0..nq-1-i``: only the
    blocks on or below the causal diagonal, about half the work.  It needs
    the reference's block grid (``nq == nk``, ``nq`` even) and queries and
    keys on one causal grid of positions (the blocks above the diagonal are
    skipped, not masked)."""
    B, Sq, KV, G, _ = q.shape
    hd = v.shape[-1]                    # accumulator dim (MLA: v != qk)
    Sk = k.shape[1]
    QB = min(opts.q_block, Sq)
    KB = min(opts.kv_block, Sk)
    nq, nk = Sq // QB, Sk // KB
    assert Sq % QB == 0 and Sk % KB == 0, (Sq, QB, Sk, KB)

    def init_carry():
        return (q.new_zeros((B, KV, G, QB, hd), dtype=torch.float32),
                q.new_full((B, KV, G, QB), NEG_INF, dtype=torch.float32),
                q.new_zeros((B, KV, G, QB), dtype=torch.float32))

    def step(carry, i, j):                  # q-block i, kv-block j
        qs, ks = slice(i * QB, (i + 1) * QB), slice(j * KB, (j + 1) * KB)
        mask = _window_mask(qpos[:, qs], kpos[:, ks], window)
        return _online_block(carry, q[:, qs], k[:, ks], v[:, ks], mask,
                             scale)

    def finish(carry):
        acc, _, l = carry
        return acc / torch.clamp(l[..., None], min=1e-30)

    outs = [None] * nq
    if not opts.folded:
        for i in repeat(nq):
            carry = init_carry()
            for j in repeat(nk):
                carry = step(carry, i, j)
            outs[i] = finish(carry)
    else:
        assert nq == nk and nq % 2 == 0, \
            "folded schedule needs even block grid"
        for i in repeat(nq // 2):
            hi = nq - 1 - i
            carries = {i: init_carry(), hi: init_carry()}
            for j in repeat(nq + 1):
                qi, kj = (i, j) if j <= i else (hi, j - (i + 1))
                carries[qi] = step(carries[qi], qi, kj)
            outs[i], outs[hi] = finish(carries[i]), finish(carries[hi])
    out = torch.cat(unfolded(outs), dim=3)                     # (B,KV,G,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def attention_core(q, k, v, qpos, kpos, window: int, opts: AttnOptions,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Dispatch over attention backends.  Shapes as in attention_naive."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if opts.backend == "fused":
        from repro_torch.kernels.ops import flash_attention
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
              return_cache: bool = False, ps: Optional[Dict] = None):
    """Full-sequence (prefill) GQA attention.  ``ps``: the specs of placed
    parameters (``p`` then holds this rank's blocks; the cache is then
    this rank's rows' on its kv heads)."""
    if ps is not None:
        return _gqa_apply_placed(p, cfg, x, positions, opts, ps,
                                 return_cache)
    B, S, _ = x.shape
    q, k, v = gqa_project(p, cfg, x, positions)
    out = attention_core(q, k, v, positions, positions, cfg.sliding_window,
                         opts)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    if return_cache:
        return out, (k, v)
    return out


def kv_heads_axes(cfg: ArchConfig, B: int, mesh) -> Tuple[str, ...]:
    """The axes placed GQA splits the kv heads over, for ``B`` rows a
    rank: the reference's q / k / v site ``(DATA, None, MODEL)`` on the
    kv-heads dim names them (none when they do not divide the kv heads)."""
    KV = cfg.n_kv_heads
    return site((B, 1, KV, cfg.n_heads // KV, cfg.head_dim), mesh, DATA,
                None, MODEL)[2]


def _gqa_heads(p: Dict, cfg: ArchConfig, x: torch.Tensor, ps: Dict):
    """(the axes ``tp`` the kv heads are split over
    (:func:`kv_heads_axes`), this rank's kv heads, ``wq`` / ``wk`` / ``wv``
    as their column blocks over ``tp`` and ``wo`` as its row block)."""
    mesh = get_mesh()
    KV = cfg.n_kv_heads
    tp = kv_heads_axes(cfg, x.shape[0], mesh)
    w = blocks_as(p, ps, {"wq": (None, tp), "wk": (None, tp),
                          "wv": (None, tp), "wo": (tp, None)}, mesh)
    return tp, KV // C.axis_size(tp, mesh), w


def _gqa_apply_placed(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                      positions: torch.Tensor, opts: AttnOptions,
                      ps: Dict, return_cache: bool = False):
    """GQA attention on this rank's kv heads (:func:`_gqa_heads`); the
    kernel (or plain version) on the local heads; the output summed over
    ``tp``.  The cache: this rank's k / v, its kv heads."""
    mesh = get_mesh()
    B, S, _ = x.shape
    G, hd = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    tp, kvl, w = _gqa_heads(p, cfg, x, ps)
    h = C.replicated(x, tp, mesh)
    q = (h @ w["wq"]).reshape(B, S, kvl * G, hd)
    k = (h @ w["wk"]).reshape(B, S, kvl, hd)
    v = (h @ w["wv"]).reshape(B, S, kvl, hd)
    q = apply_rope(q, positions, cfg.rope_theta).reshape(B, S, kvl, G, hd)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attention_core(q, k, v, positions, positions, cfg.sliding_window,
                         opts)
    out = C.psum(out.reshape(B, S, kvl * G * hd) @ w["wo"], tp, mesh)
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
               pos: torch.Tensor, opts: AttnOptions,
               ps: Optional[Dict] = None, wax=()
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode with a (ring-buffered when SWA) KV cache.

    x: (B,1,d); cache_k/v: (B,W,KV,hd); pos: (B,) int32, each row's current
    position (a scalar is broadcast).  Row b's new K/V is written at ring
    slot ``pos[b] % W`` **in place** (``cache_k``/``cache_v`` are modified
    and returned).  Returns (out (B,1,d), cache_k, cache_v).  ``ps``: the
    specs of placed parameters; the cache is then this rank's slice of the
    ring over ``wax`` (the module's notes).
    """
    if ps is not None:
        return _gqa_decode_placed(p, cfg, x, cache_k, cache_v, pos, opts, ps,
                                  wax)
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


def _decode_attn(opts: AttnOptions):
    """The window slice's attention with its log-sum-exp: the kernel under
    ``fused`` (its plain version on CPU tensors), else the plain version."""
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    return flash_decode if opts.backend == "fused" else flash_decode_plain


def _gqa_decode_placed(p, cfg, x, cache_k, cache_v, pos, opts, ps, wax):
    mesh = get_mesh()
    B = x.shape[0]
    G, hd = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    tp, kvl, w = _gqa_heads(p, cfg, x, ps)
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=x.device).expand(B).contiguous()
    q = (x @ w["wq"]).reshape(B, 1, kvl * G, hd)
    k = (x @ w["wk"]).reshape(B, 1, kvl, hd)
    q = apply_rope(q, pos[:, None], cfg.rope_theta).reshape(B, kvl, G, hd)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)[:, 0]
    v = (x @ w["wv"]).reshape(B, kvl, hd)
    # every head's q, k and v on every rank (one token each), gathered at
    # once: (B, kv heads, G + 2, hd) split on the kv heads
    heads = (None, tp)
    qkv = relayout(torch.cat([q, k[:, :, None], v[:, :, None]], 2), heads,
                   (), mesh)
    q, k, v = qkv[:, :, :G].contiguous(), qkv[:, :, G], qkv[:, :, G + 1]
    lo, W, kpos = window_slice(pos, cache_k.shape[1], wax, mesh)
    local = pos % W - lo
    ring_write(cache_k, k, local)
    ring_write(cache_v, v, local)
    out, lse = _decode_attn(opts)(q, cache_k, cache_v, pos, kpos,
                                  cfg.sliding_window or 0,
                                  1.0 / math.sqrt(hd), opts.kv_block,
                                  return_lse=True)
    out = relayout(combine_by_lse(out, lse, wax, mesh).to(x.dtype), (), heads,
                   mesh)
    out = out.reshape(B, 1, kvl * G * hd) @ w["wo"]
    return C.psum(out, tp, mesh), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_spec(cfg: ArchConfig):
    d, H = cfg.d_model, cfg.n_heads
    r, rope, nope, vh = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                         cfg.v_head_dim)
    return {
        "wq": spec((d, H * (nope + rope)), ("embed", "qkv")),
        "w_dkv": spec((d, r + rope), ("embed", "kv_lora")),
        "w_uk": spec((r, H * nope), ("kv_lora", "qkv")),
        "w_uv": spec((r, H * vh), ("kv_lora", "qkv")),
        "wo": spec((H * vh, d), ("qkv", "embed"), init="small"),
        "kv_norm": rms_norm_spec(r),
    }


def _mla_qc(p: Dict, cfg: ArchConfig, x: torch.Tensor,
            positions: torch.Tensor, xq: Optional[torch.Tensor] = None):
    """Queries and the compressed KV stream: q_nope (B,S,H,nope), rotated
    q_rope (B,S,H,rope), the normed latent ckv (B,S,r) and the rotated
    shared key k_rope (B,S,rope).  ``xq``: the queries' input where it is
    not ``x`` (placed: ``x`` entering this rank's heads), H then the heads
    of ``p["wq"]``'s block."""
    B, S, _ = x.shape
    rope, nope, r = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.kv_lora_rank
    q = ((x if xq is None else xq) @ p["wq"]).reshape(B, S, -1, nope + rope)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    dkv = x @ p["w_dkv"]                                   # (B,S,r+rope)
    ckv = rms_norm(dkv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., None, r:], positions,
                        cfg.rope_theta)[..., 0, :]
    return q_nope, q_rope, ckv, k_rope


def mla_apply(p: Dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, opts: AttnOptions,
              return_cache: bool = False, ps: Optional[Dict] = None):
    """Full-sequence (prefill) MLA, not absorbed: K and V are expanded from
    the latent and attention runs as MHA (KV = H, G = 1) at hd_qk
    ``nope + rope`` and hd_v ``v_head_dim``, scale ``1/sqrt(nope + rope)``.
    ``return_cache`` adds the compressed cache ``(ckv (B,S,r), k_rope
    (B,S,rope))``.  ``ps``: the specs of placed parameters
    (:func:`_mla_apply_placed`)."""
    if ps is not None:
        return _mla_apply_placed(p, cfg, x, positions, opts, ps, return_cache)
    B, S, _ = x.shape
    H = cfg.n_heads
    rope, nope, vh = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    q_nope, q_rope, ckv, k_rope = _mla_qc(p, cfg, x, positions)
    k_nope = (ckv @ p["w_uk"]).reshape(B, S, H, nope)
    v = (ckv @ p["w_uv"]).reshape(B, S, H, vh)
    q = torch.cat([q_nope, q_rope], dim=-1).reshape(B, S, H, 1, nope + rope)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope)],
                  dim=-1)
    out = attention_core(q, k, v, positions, positions, 0, opts,
                         scale=1.0 / math.sqrt(nope + rope))
    out = out.reshape(B, S, H * vh) @ p["wo"]
    if return_cache:
        return out, (ckv, k_rope)
    return out


def _mla_heads(p: Dict, cfg: ArchConfig, x: torch.Tensor, ps: Dict):
    """(the axes ``tp`` the heads are split over, this rank's heads, the
    weights as their blocks): the reference's q site ``(DATA, None, MODEL)``
    on the heads dim (MHA: G 1) names ``tp``; ``wq`` / ``w_uk`` / ``w_uv``
    as their column blocks over ``tp``, ``wo`` as its row block, the latent
    down-projection ``w_dkv`` and ``kv_norm`` whole (every rank reads the
    latent whole: the rules put ``kv_lora`` on no axis)."""
    mesh = get_mesh()
    B, S, _ = x.shape
    H = cfg.n_heads
    tp = site((B, S, H, 1, cfg.qk_nope_dim + cfg.qk_rope_dim), mesh, DATA,
              None, MODEL)[2]
    col = (None, tp)
    w = blocks_as(p, ps, {"wq": col, "w_uk": col, "w_uv": col,
                          "wo": (tp, None), "w_dkv": (), "kv_norm": ()},
                  mesh)
    return tp, H // C.axis_size(tp, mesh), w


def _mla_apply_placed(p, cfg, x, positions, opts, ps, return_cache):
    """MLA prefill on this rank's heads.  The queries' input enters the
    rank's heads through ``replicated``; the latent and the rope key, which
    every rank computes whole from ``x`` and each rank's heads read, enter
    them through ``replicated`` once, after the down-projection: their
    gradients are the ranks' partial ones summed, and the gradient they
    send back to ``x`` and ``w_dkv`` is then whole on every rank (counted
    once).  The cache: the latent and the rope key, whole."""
    mesh = get_mesh()
    B, S, _ = x.shape
    rope, nope, vh = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    tp, hl, w = _mla_heads(p, cfg, x, ps)
    q_nope, q_rope, ckv, k_rope = _mla_qc(w, cfg, x, positions,
                                          xq=C.replicated(x, tp, mesh))
    ckv_h, krope_h = C.replicated(ckv, tp, mesh), C.replicated(k_rope, tp,
                                                               mesh)
    k_nope = (ckv_h @ w["w_uk"]).reshape(B, S, hl, nope)
    v = (ckv_h @ w["w_uv"]).reshape(B, S, hl, vh)
    q = torch.cat([q_nope, q_rope], dim=-1).reshape(B, S, hl, 1, nope + rope)
    k = torch.cat([k_nope, krope_h[:, :, None, :].expand(B, S, hl, rope)],
                  dim=-1)
    out = attention_core(q, k, v, positions, positions, 0, opts,
                         scale=1.0 / math.sqrt(nope + rope))
    out = C.psum(out.reshape(B, S, hl * vh) @ w["wo"], tp, mesh)
    if return_cache:
        return out, (ckv, k_rope)
    return out


# int8 latent cache (symmetric, static scale), as the reference: the latent
# is RMS-normed, so a static range of +-KV_QUANT_RANGE holds it.
KV_QUANT_RANGE = 8.0


def quant_kv(x: torch.Tensor) -> torch.Tensor:
    """float -> int8 at 127 / KV_QUANT_RANGE per unit; ``torch.round``
    rounds half to even, as ``jnp.round``; clipped to +-127."""
    s = 127.0 / KV_QUANT_RANGE
    return torch.clamp(torch.round(x.float() * s), -127, 127).to(torch.int8)


def dequant_kv(q: torch.Tensor) -> torch.Tensor:
    return q.float() * (KV_QUANT_RANGE / 127.0)


def mla_decode(p: Dict, cfg: ArchConfig, x: torch.Tensor,
               cache_ckv: torch.Tensor, cache_krope: torch.Tensor,
               pos: torch.Tensor, opts: AttnOptions,
               ps: Optional[Dict] = None, wax=()
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token MLA decode over the compressed cache, absorbed: W_uk
    goes into the query and W_uv after the weights, so attention reads
    ``r + rope`` values per position (576 for deepseek-v2-lite) instead of
    ``H (nope + vh)``.  float32 einsums, as the reference's (no kernel).

    x: (B,1,d); cache_ckv (B,W,r), cache_krope (B,W,rope), bfloat16 /
    float32, or int8 (``quant_kv`` on write, ``dequant_kv`` on read); pos:
    (B,) int32, each row's position (a scalar is broadcast).  Row b's latent
    is written at ring slot ``pos[b] % W`` **in place**.  Two departures
    from the reference, both on purpose: per-row positions, and the mask
    ``ring_kpos(pos, W) <= pos``, which sees a wrapped ring whole (the
    reference's ``idx <= slot`` assumes W covers every position; below W
    the two are equal).  Returns (out (B,1,d), cache_ckv, cache_krope).
    ``ps``: the specs of placed parameters; the cache is then this rank's
    slice of the ring over ``wax`` (:func:`_mla_decode_placed`)."""
    if ps is not None:
        return _mla_decode_placed(p, cfg, x, cache_ckv, cache_krope, pos, ps,
                                  wax)
    B = x.shape[0]
    H = cfg.n_heads
    rope, nope, vh, r = (cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim,
                         cfg.kv_lora_rank)
    W = cache_ckv.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=x.device).expand(B).contiguous()
    q_nope, q_rope, ckv, k_rope = _mla_qc(p, cfg, x, pos[:, None])
    rows = torch.arange(B, device=x.device)
    slot = (pos % W).long()
    quantized = cache_ckv.dtype == torch.int8
    if quantized:
        cache_ckv[rows, slot] = quant_kv(ckv[:, 0])
        cache_krope[rows, slot] = quant_kv(k_rope[:, 0])
        ckv_read, krope_read = dequant_kv(cache_ckv), dequant_kv(cache_krope)
    else:
        cache_ckv[rows, slot] = ckv[:, 0].to(cache_ckv.dtype)
        cache_krope[rows, slot] = k_rope[:, 0].to(cache_krope.dtype)
        ckv_read, krope_read = cache_ckv.float(), cache_krope.float()
    w_uk = p["w_uk"].reshape(r, H, nope).float()
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk)
    scores = torch.einsum("bqhr,bsr->bhqs", q_lat, ckv_read)
    scores = scores + torch.einsum("bqhe,bse->bhqs", q_rope.float(),
                                   krope_read)
    scores = scores * (1.0 / math.sqrt(nope + rope))
    valid = ring_kpos(pos, W) <= pos[:, None]                 # (B, W)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    lat = torch.einsum("bhqs,bsr->bqhr", w, ckv_read)
    w_uv = p["w_uv"].reshape(r, H, vh).float()
    out = torch.einsum("bqhr,rhv->bqhv", lat, w_uv)
    out = out.reshape(B, 1, H * vh).to(x.dtype) @ p["wo"]
    return out, cache_ckv, cache_krope


def _mla_decode_placed(p, cfg, x, cache_ckv, cache_krope, pos, ps, wax):
    """Absorbed MLA decode over this rank's slice of the latent ring, in
    float32 as :func:`mla_decode`: each rank absorbs ``w_uk`` into the q of
    its own heads, gathers every head's (one token), scores its slots for
    all heads and returns its partial latent read with its log-sum-exp;
    :func:`combine_by_lse` merges them; ``w_uv`` and ``wo`` run on the
    rank's heads, the output summed over them.  The new latent, which every
    rank computes whole, is written by the rank holding its slot."""
    mesh = get_mesh()
    B = x.shape[0]
    rope, nope, vh, r = (cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim,
                         cfg.kv_lora_rank)
    tp, hl, w = _mla_heads(p, cfg, x, ps)
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=x.device).expand(B).contiguous()
    q_nope, q_rope, ckv, k_rope = _mla_qc(w, cfg, x, pos[:, None])
    lo, W, kpos = window_slice(pos, cache_ckv.shape[1], wax, mesh)
    local = pos % W - lo
    quantized = cache_ckv.dtype == torch.int8
    enc = quant_kv if quantized else (lambda a: a)
    ring_write(cache_ckv, enc(ckv[:, 0]), local)
    ring_write(cache_krope, enc(k_rope[:, 0]), local)
    dec = dequant_kv if quantized else (lambda a: a.float())
    ckv_read, krope_read = dec(cache_ckv), dec(cache_krope)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.float(),
                         w["w_uk"].reshape(r, hl, nope).float())
    qq = relayout(torch.cat([q_lat, q_rope.float()], -1), (None, None, tp),
                  (), mesh)                               # (B,1,H,r+rope)
    scores = (torch.einsum("bqhr,bsr->bhqs", qq[..., :r], ckv_read)
              + torch.einsum("bqhe,bse->bhqs", qq[..., r:], krope_read))
    scores = scores * (1.0 / math.sqrt(nope + rope))
    valid = (kpos <= pos[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, -torch.inf)
    lse = torch.logsumexp(scores, dim=-1)                  # (B,H,1)
    wts = torch.where(valid, torch.exp(scores - torch.clamp(
        lse, min=NEG_INF)[..., None]), 0.0)
    lat = torch.einsum("bhqs,bsr->bhqr", wts, ckv_read)
    lat = relayout(combine_by_lse(lat, lse, wax, mesh), (), (None, tp), mesh)
    out = torch.einsum("bhqr,rhv->bqhv", lat,
                       w["w_uv"].reshape(r, hl, vh).float())
    out = out.reshape(B, 1, hl * vh).to(x.dtype) @ w["wo"]
    return C.psum(out, tp, mesh), cache_ckv, cache_krope
