"""Causal + sliding-window GQA flash attention (prefill): wrapper, plain
version, launch count.

``flash_attention`` replaces the Pallas kernel of the reference,
``repro/kernels/flash_attention.py`` (``_flash_kernel`` /
``flash_attention_pallas``).  On CUDA tensors it launches one of the
hand-written kernels of ``csrc/flash_attention.cu`` (see its source note
for the designs), chosen by :func:`_variant` from dtype and shape alone, or
raises (also when an input requires grad with grad mode on: the output
would carry no gradient, so training goes through
``kernels.ops.flash_attention``); on CPU tensors it runs
:func:`flash_attention_plain`.
``flash_attention.launches`` counts kernel launches and
``flash_attention.last_variant`` names the kernel of the latest one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._common import aligned16, check, on_card, \
    positions, refuse_counting, refuse_grad, stream_of
from repro_torch.models.layers import NEG_INF, _gqa_out, _gqa_scores, \
    _window_mask

MAX_HEAD_DIM = 256
# The device kernels, by the code csrc/flash_attention.cu takes.
VARIANTS = {"cuda_cores": 0, "wmma": 1, "wgmma_tma": 2}
WGMMA_HEAD_DIMS = (64, 80, 112, 128)


def _variant(dtype: torch.dtype, hd_qk: int, hd_v: int,
             aligned: bool) -> str:
    """The device kernel for these operands: ``wgmma_tma`` (TMA ring +
    wgmma, Hopper) for bfloat16 with ``hd_qk == hd_v`` in
    ``WGMMA_HEAD_DIMS`` and 16-byte aligned q, k, v; ``wmma`` for any other
    bfloat16 shape; ``cuda_cores`` for float32."""
    if dtype == torch.float32:
        return "cuda_cores"
    if hd_qk == hd_v and hd_qk in WGMMA_HEAD_DIMS and aligned:
        return "wgmma_tma"
    return "wmma"


def flash_attention_plain(q, k, v, qpos, kpos, window: int = 0,
                          scale: float = 1.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: masked softmax attention over
    the whole key axis in the kernel's form, ``p = where(mask, exp(s - m),
    0)`` and ``out = p @ v / max(l, 1e-30)``.  It equals the reference's
    oracle (``attention_naive``) on every query row with a live key; a row
    with none gives 0, as the Pallas kernel does (the oracle gives the mean
    of ``v`` there).

    q: (B,Sq,KV,G,hd_qk); k: (B,Sk,KV,hd_qk); v: (B,Sk,KV,hd_v); qpos (B,Sq),
    kpos (B,Sk) int.  Returns (B,Sq,KV,G,hd_v) in q's dtype."""
    s = _gqa_scores(q, k) * scale                           # (B,KV,G,Sq,Sk)
    mask = _window_mask(qpos, kpos, window)[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return _gqa_out(p / torch.clamp(l, min=1e-30), v).to(q.dtype)


_FN = None


def _launch(q, k, v, qpos, kpos, window, scale, variant=None):
    """One launch.  ``variant`` defaults to :func:`_variant`; it is given
    only to time an older kernel on the same inputs, and the kernel refuses
    one whose conditions do not hold."""
    global _FN
    code = check("q", q, 5)
    for name, t in (("k", k), ("v", v)):
        check(name, t, 4, (q.dtype,))
    B, Sq, KV, G, hd_qk = q.shape
    Sk, hd_v = k.shape[1], v.shape[-1]
    if k.shape != (B, Sk, KV, hd_qk) or v.shape[:3] != (B, Sk, KV):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not (0 < hd_qk <= MAX_HEAD_DIM and 0 < hd_v <= MAX_HEAD_DIM):
        raise ValueError(f"head dims {hd_qk}/{hd_v} outside 1..{MAX_HEAD_DIM}")
    qp, kp = positions(qpos, (B, Sq)), positions(kpos, (B, Sk))
    out = torch.empty((B, Sq, KV, G, hd_v), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if _FN is None:
        from repro_torch.kernels import build
        P, I = ctypes.c_void_p, ctypes.c_int
        _FN = build.function("flash_attention", "flash_attention_launch",
                             [P] * 6 + [I] * 8 + [ctypes.c_float, I, I, P])
    if variant is None:
        variant = _variant(q.dtype, hd_qk, hd_v, aligned16(q, k, v))
    with torch.cuda.device(q.device):
        rc = _FN(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                 kp.data_ptr(), out.data_ptr(), B, Sq, Sk, KV, G, hd_qk,
                 hd_v, int(window), float(scale), code, VARIANTS[variant],
                 stream_of(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (CUDA "
                           f"error {rc}, {variant}) for q {tuple(q.shape)}, "
                           f"Sk={Sk}")
    flash_attention.launches += 1
    flash_attention.last_variant = variant
    return out


def flash_attention(q, k, v, qpos, kpos, window: int = 0,
                    scale: float = 1.0) -> torch.Tensor:
    """Same contract as the reference's ``ops.flash_attention``: q
    (B,Sq,KV,G,hd_qk), k (B,Sk,KV,hd_qk), v (B,Sk,KV,hd_v), qpos (B,Sq), kpos
    (B,Sk) -> (B,Sq,KV,G,hd_v); key ``j`` is live for query ``i`` when
    ``kpos[j] <= qpos[i]`` and, with a window, ``qpos[i] - kpos[j] <
    window``.  float32 or bfloat16, accumulation in float32."""
    if on_card(q, k, v):
        refuse_grad("flash_attention", q, k, v)
        refuse_counting("flash_attention")
        return _launch(q, k, v, qpos, kpos, window, scale)
    return flash_attention_plain(q, k, v, qpos, kpos, window, scale)


flash_attention.launches = 0
flash_attention.last_variant = None
