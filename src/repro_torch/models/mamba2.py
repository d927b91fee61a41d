"""Mamba-2 (SSD, state-space duality) mixer of the port — chunked scan +
decode step, mirroring ``repro/models/mamba2.py``.

The SSD chunked algorithm (Dao & Gu, arXiv:2405.21060) splits the sequence
into chunks of Q tokens: a quadratic *intra-chunk* term and a linear
*inter-chunk* state recurrence.  ``ssm_apply(backend="torch")`` runs it in
plain PyTorch (:func:`ssd_scan_ref`, the reference's ``"xla"``);
``backend="fused"`` runs the ``ssd_scan`` kernel (the reference's
``"pallas"``).  Decode carries (conv, state) caches and is O(1) per token.

Projections are split (w_z/w_x/w_B/w_C/w_dt + per-stream depthwise convs) as
in the reference.  Dtype order as there: ``dt`` goes to float32 before the
softplus; ``xs``/``Bm``/``Cm`` go to float32 only for the scan; ``y`` comes
back to the activation dtype before the gated ``rms_norm``.

Placed parameters (``ps``, on a ``ProcessMesh``): the mixer runs on
this rank's SSM heads.  The reference's sites (``xs`` and the gated ``y``
over ``(DATA, None, MODEL)`` on the ``d_inner`` dim) name the axes ``tp``
(none unless they divide the heads); ``w_z`` / ``w_x`` / ``conv_x`` /
``w_dt`` / ``dt_bias`` / ``A_log`` / ``D`` and the gated norm's scale are
taken as their blocks over ``tp``, ``out_proj`` as its row block; ``w_B`` /
``w_C`` and their convs whole (the state dim is not split), their outputs
entering the local scan through ``collectives.replicated``; the gated
norm's mean square summed over ``tp``; the output summed over ``tp``.
On an MRA mesh ``tp`` is the SSM tile's fabric and its rows the tile's
(``layers.tile_stream``), as for every placed layer.
Serving: the cache is placed by ``launch.specs.cache_shardings`` (``cs``:
a layer's specs: the state's heads and each conv buffer's channels over
the model axis).  ``ssm_apply(return_cache=True, cs=)`` gives this rank's
blocks of its rows' cache: ``conv_x`` and the state from the mixer's heads
(no collective where the heads split as the cache's channels), B's and
C's buffers cut to the rank's channels.  ``ssm_decode`` under ``ps`` takes
those blocks: ``conv_x`` and the state as the mixer's heads read them; B
and C, which the mixer reads whole, step their convs on the rank's
channels and are gathered after.

One difference, on purpose: the conv cache of a prompt shorter than
``ssm_conv - 1`` tokens.  The reference keeps ``xs[:, L-(c-1):]``, which for
such a prompt is fewer than ``c - 1`` rows (ROADMAP queue C); the port keeps
the last ``c - 1`` pre-conv inputs left-padded with zeros, which is what the
causal conv of the full sequence saw.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.launch.mesh import get_mesh
from repro_torch.models.layers import (DATA, MODEL, blocks_as,
                                       gather_last, rms_norm, rms_norm_spec,
                                       site)
from repro_torch.models.params import spec
from repro_torch.parallel import collectives as C
from repro_torch.parallel.placement import entry_axes, relayout

SSM_BACKENDS = ("torch", "fused")


def check_backend(backend: str) -> None:
    if backend not in SSM_BACKENDS:
        raise ValueError(f"ssm backend {backend!r}; the port has "
                         f"{SSM_BACKENDS} (its names for the reference's "
                         f"'xla' and 'pallas' are 'torch' and 'fused')")


def ssm_spec(cfg: ArchConfig):
    d, di, st, nh, c = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                        cfg.n_ssm_heads, cfg.ssm_conv)
    g = cfg.ssm_ngroups
    f32 = torch.float32
    return {
        "w_z": spec((d, di), ("embed", "d_inner")),
        "w_x": spec((d, di), ("embed", "d_inner")),
        "w_B": spec((d, g * st), ("embed", "ssm_state")),
        "w_C": spec((d, g * st), ("embed", "ssm_state")),
        "w_dt": spec((d, nh), ("embed", "ssm_heads")),
        "conv_x": spec((c, di), (None, "d_inner"), init="normal", scale=0.5),
        "conv_B": spec((c, g * st), (None, "ssm_state"), init="normal",
                       scale=0.5),
        "conv_C": spec((c, g * st), (None, "ssm_state"), init="normal",
                       scale=0.5),
        "dt_bias": spec((nh,), ("ssm_heads",), dtype=f32, init="zeros"),
        "A_log": spec((nh,), ("ssm_heads",), dtype=f32, init="zeros"),
        "D": spec((nh,), ("ssm_heads",), dtype=f32, init="ones"),
        "norm": rms_norm_spec(di),
        "out_proj": spec((di, d), ("d_inner", "embed"), init="small"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds.  x: (B,L,C), w: (c,C)."""
    c = w.shape[0]
    out = x * w[-1]
    for i in range(1, c):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i, :]
        out = out + shifted * w[-1 - i]
    return out


def _conv_step(x_t: torch.Tensor, buf: torch.Tensor, w: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token depthwise conv.  x_t: (B,C); buf: (B,c-1,C) past inputs.
    Returns (out (B,C), the new buffer (B,c-1,C) in ``buf``'s dtype); the
    sums run in the promoted dtype of the three, as in the reference."""
    dtype = torch.promote_types(torch.promote_types(buf.dtype, x_t.dtype),
                                w.dtype)
    hist = torch.cat([buf, x_t[:, None, :]], dim=1).to(dtype)   # (B,c,C)
    out = torch.einsum("btc,tc->bc", hist, w.to(dtype))
    return out, hist[:, 1:, :].to(buf.dtype)


def _conv_tail(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` rows of x (B,L,C), left-padded with zeros when L < n
    (the inputs the causal conv saw before position 0 are zeros)."""
    L = x.shape[1]
    if L >= n:
        return x[:, L - n:, :]
    return F.pad(x, (0, 0, n - L, 0))


def _ssd_inputs(p: Dict, x: torch.Tensor):
    """Shared projections for scan/decode.  x: (B,L,d)."""
    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    Bm = x @ p["w_B"]
    Cm = x @ p["w_C"]
    dt = (x @ p["w_dt"]).float()
    return z, xs, Bm, Cm, dt


# The chunked SSD in plain PyTorch, the reference's ``ssd_scan_ref``, is the
# ``ssd_scan`` kernel's plain version.
ssd_scan_ref = ssd_scan_plain


def ssm_apply(p: Dict, cfg: ArchConfig, x: torch.Tensor,
              backend: str = "torch", return_cache: bool = False,
              ps: Optional[Dict] = None, cs: Optional[Dict] = None):
    """Full-sequence Mamba-2 block.  x: (B,L,d) -> (B,L,d) [, cache].
    ``ps``: the specs of placed parameters; the cache is then this rank's
    blocks of its rows' under the cache's specs ``cs``."""
    check_backend(backend)
    if ps is not None:
        return _ssm_apply_placed(p, cfg, x, backend, ps, return_cache, cs)
    c = cfg.ssm_conv
    z, xs, Bm, Cm, dt = _ssd_inputs(p, x)
    xs_raw, Bm_raw, Cm_raw = xs, Bm, Cm          # pre-conv (cache tails)
    xs = F.silu(_causal_conv(xs, p["conv_x"]))
    Bm = F.silu(_causal_conv(Bm, p["conv_B"]))
    Cm = F.silu(_causal_conv(Cm, p["conv_C"]))

    dt = F.softplus(dt + p["dt_bias"])                     # (B,L,nh) f32
    A = -torch.exp(p["A_log"])                             # (nh,)
    y, h_final = _scan(cfg, xs, Bm, Cm, dt, A, p["D"], backend)
    y = y.to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if not return_cache:
        return out
    cache = dict(conv_x=_conv_tail(xs_raw, c - 1),
                 conv_B=_conv_tail(Bm_raw, c - 1),
                 conv_C=_conv_tail(Cm_raw, c - 1),
                 state=h_final)
    return out, cache


def _scan(cfg: ArchConfig, xs, Bm, Cm, dt, A, D, backend: str):
    """The chunked scan over (B, L, nh * hd) inputs; returns y (B, L,
    nh * hd) float32 and the final state.  The inputs are padded to a chunk
    multiple; padded positions get dt = 0, so they neither emit output nor
    perturb the carried state (a = exp(0 A) = 1, update 0)."""
    Bb, L, _ = xs.shape
    hd = cfg.ssm_headdim
    nh = xs.shape[-1] // hd
    Q = min(cfg.ssm_chunk, max(L, 1))
    Lp = -(-L // Q) * Q
    if Lp != L:
        pad = (0, 0, 0, Lp - L)
        xs, Bm, Cm, dt = (F.pad(t, pad) for t in (xs, Bm, Cm, dt))
    xsh = xs.reshape(Bb, Lp, nh, hd).float().contiguous()
    Bf, Cf = Bm.float().contiguous(), Cm.float().contiguous()
    if backend == "fused":
        from repro_torch.kernels.ops import ssd_scan
        y, h = ssd_scan(xsh, dt.contiguous(), A, Bf, Cf, D,
                        chunk=cfg.ssm_chunk)
    else:
        y, h = ssd_scan_ref(xsh, dt, A, Bf, Cf, D, chunk=cfg.ssm_chunk)
    return y.reshape(Bb, Lp, nh * hd)[:, :L, :], h


def _ssm_blocks(p: Dict, cfg: ArchConfig, x: torch.Tensor, ps: Dict):
    """(the axes ``tp`` the heads are split over, the weights as the
    mixer's blocks): the site of ``xs`` over ``(DATA, None, MODEL)`` on
    ``d_inner``, none unless they split whole heads."""
    mesh = get_mesh()
    Bb, L, _ = x.shape
    tp = site((Bb, L, cfg.d_inner), mesh, DATA, None, MODEL)[2]
    if cfg.n_ssm_heads % C.axis_size(tp, mesh):
        tp = ()                    # a split inside a head: whole heads
    col, row, vec = (None, tp), (tp, None), (tp,)
    w = blocks_as(p, ps, {"w_z": col, "w_x": col, "w_dt": col,
                          "conv_x": col, "dt_bias": vec, "A_log": vec,
                          "D": vec, "norm": vec, "out_proj": row,
                          "w_B": (), "w_C": (), "conv_B": (), "conv_C": ()},
                  mesh)
    return tp, w


def _gated_norm_out(w: Dict, cfg: ArchConfig, y: torch.Tensor, tp, mesh,
                    dtype) -> torch.Tensor:
    """The gated rms_norm over all ``d_inner`` channels (the mean square
    summed over ``tp``, used by each rank's channels alone), then
    ``out_proj``'s row block, summed over ``tp``."""
    yf = y.float()
    ms = C.replicated(C.psum(yf.square().sum(-1, keepdim=True), tp, mesh),
                      tp, mesh) / cfg.d_inner
    y = (yf * torch.rsqrt(ms + cfg.norm_eps)
         * (1.0 + w["norm"].float())).to(dtype)
    return C.psum(y @ w["out_proj"], tp, mesh)


def _mixer_specs(cs: Dict, tp) -> Dict:
    """The specs of the cache's leaves as the mixer holds them: ``conv_x``
    and the state on its heads (over ``tp``), B's and C's buffers whole;
    the batch as the cache's (``cs``)."""
    bax = cs["state"][0] if len(cs["state"]) else None
    return {"conv_x": (bax, None, tp), "state": (bax, tp), "conv_B": (bax,),
            "conv_C": (bax,)}


def _ssm_apply_placed(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                      backend: str, ps: Dict, return_cache: bool = False,
                      cs: Optional[Dict] = None):
    mesh = get_mesh()
    tp, w = _ssm_blocks(p, cfg, x, ps)
    h = C.replicated(x, tp, mesh)           # feeds this rank's heads only
    z, xs = h @ w["w_z"], h @ w["w_x"]
    dt = (h @ w["w_dt"]).float()
    xs_raw = xs
    xs = F.silu(_causal_conv(xs, w["conv_x"]))
    # B and C are whole on every rank (from x itself: the same on each);
    # each rank's heads read them, so their gradients sum over tp
    Bm_raw, Cm_raw = x @ w["w_B"], x @ w["w_C"]
    Bm = C.replicated(F.silu(_causal_conv(Bm_raw, w["conv_B"])), tp, mesh)
    Cm = C.replicated(F.silu(_causal_conv(Cm_raw, w["conv_C"])), tp, mesh)
    dt = F.softplus(dt + w["dt_bias"])
    A = -torch.exp(w["A_log"])
    y, h_final = _scan(cfg, xs, Bm, Cm, dt, A, w["D"], backend)
    out = _gated_norm_out(w, cfg, y.to(x.dtype) * F.silu(z), tp, mesh,
                          x.dtype)
    if not return_cache:
        return out
    c = cfg.ssm_conv
    got = dict(conv_x=_conv_tail(xs_raw, c - 1),
               conv_B=_conv_tail(Bm_raw, c - 1),
               conv_C=_conv_tail(Cm_raw, c - 1), state=h_final)
    want = _mixer_specs(cs, tp)
    return out, {k: relayout(a, want[k], cs[k], mesh) for k, a in got.items()}


def ssm_decode(p: Dict, cfg: ArchConfig, x: torch.Tensor, cache: Dict,
               ps: Optional[Dict] = None, cs: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode.  x: (B,1,d); cache keys: conv_x/conv_B/conv_C
    (B,c-1,·) and state (B,nh,st,hd) f32.  O(1) in context length.
    Returns (out (B,1,d), a new cache dict: new tensors, the given cache is
    not written).  ``ps``: the specs of placed parameters; ``cache`` then
    holds this rank's blocks under the specs ``cs``, and so does the new
    one."""
    if ps is not None:
        return _ssm_decode_placed(p, cfg, x, cache, ps, cs)
    Bb = x.shape[0]
    nh, hd = cfg.n_ssm_heads, cfg.ssm_headdim
    z, xs, Bm, Cm, dt = _ssd_inputs(p, x[:, 0:1, :])
    z, xs, Bm, Cm, dt = z[:, 0], xs[:, 0], Bm[:, 0], Cm[:, 0], dt[:, 0]

    xs, conv_x = _conv_step(xs, cache["conv_x"], p["conv_x"])
    Bm, conv_B = _conv_step(Bm, cache["conv_B"], p["conv_B"])
    Cm, conv_C = _conv_step(Cm, cache["conv_C"], p["conv_C"])
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)

    dt = F.softplus(dt + p["dt_bias"])                     # (B,nh)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                                  # (B,nh)
    xh = xs.reshape(Bb, nh, hd).float()
    # state update: h = a h + dt * B (outer) x
    upd = torch.einsum("bn,bs,bnh->bnsh", dt, Bm.float(), xh)
    h = cache["state"] * a[:, :, None, None] + upd
    y = torch.einsum("bs,bnsh->bnh", Cm.float(), h)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(Bb, nh * hd).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None, :]
    new_cache = dict(conv_x=conv_x, conv_B=conv_B, conv_C=conv_C, state=h)
    return out, new_cache


def _ssm_decode_placed(p, cfg, x, cache, ps, cs):
    """The mixer's step on this rank's heads.  ``conv_x`` and the state
    are relaid out to the mixer's heads where their cache specs differ
    (the identity when the heads and the channels split alike).  B and C
    step their depthwise convs on the rank's channels of their buffers
    (the cache's split), and their outputs are gathered whole in one
    all-gather: the buffers never leave the rank."""
    mesh = get_mesh()
    Bb, hd = x.shape[0], cfg.ssm_headdim
    tp, w = _ssm_blocks(p, cfg, x, ps)
    cax = entry_axes(cs["conv_B"][-1])
    want = _mixer_specs(cs, tp)
    c = {k: relayout(cache[k], cs[k], want[k], mesh)
         for k in ("conv_x", "state")}
    h = x[:, 0]
    z, xs, dt = h @ w["w_z"], h @ w["w_x"], (h @ w["w_dt"]).float()
    xs, conv_x = _conv_step(xs, c["conv_x"], w["conv_x"])
    chans = {k: relayout(w[k], (), (None, cax), mesh)
             for k in ("w_B", "w_C", "conv_B", "conv_C")}
    Bm, conv_B = _conv_step(h @ chans["w_B"], cache["conv_B"],
                            chans["conv_B"])
    Cm, conv_C = _conv_step(h @ chans["w_C"], cache["conv_C"],
                            chans["conv_C"])
    Bm, Cm = gather_last((Bm, Cm), cax, mesh)
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)
    dt = F.softplus(dt + w["dt_bias"])                     # (B,nh_l)
    a = torch.exp(dt * -torch.exp(w["A_log"]))
    xh = xs.reshape(Bb, -1, hd).float()
    upd = torch.einsum("bn,bs,bnh->bnsh", dt, Bm.float(), xh)
    state = c["state"] * a[:, :, None, None] + upd
    y = torch.einsum("bs,bnsh->bnh", Cm.float(), state)
    y = (y + xh * w["D"][None, :, None]).reshape(Bb, -1).to(x.dtype)
    out = _gated_norm_out(w, cfg, y * F.silu(z), tp, mesh, x.dtype)
    new = dict(conv_x=relayout(conv_x, want["conv_x"], cs["conv_x"], mesh),
               conv_B=conv_B, conv_C=conv_C,
               state=relayout(state, want["state"], cs["state"], mesh))
    return out[:, None, :], new


def ssm_cache_init(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                   device=None) -> Dict:
    c = cfg.ssm_conv
    g = cfg.ssm_ngroups
    return dict(
        conv_x=torch.zeros((batch, c - 1, cfg.d_inner), dtype=dtype,
                           device=device),
        conv_B=torch.zeros((batch, c - 1, g * cfg.ssm_state), dtype=dtype,
                           device=device),
        conv_C=torch.zeros((batch, c - 1, g * cfg.ssm_state), dtype=dtype,
                           device=device),
        state=torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_state,
                           cfg.ssm_headdim), dtype=torch.float32,
                          device=device),
    )
